import numpy as np
import pytest

from spaln_tpu import constants as K
from spaln_tpu.config import Config, resolve, CvsG, PvsG
from spaln_tpu.score.simmtx import (dna_matrix, mdm_matrix, text_matrix,
                                    tron_matrix, Simmtx)
from spaln_tpu.score.pssm import load_pssm, load_pssm_stack, scan_pssm
from spaln_tpu.score.intron import IntronPenalty, frechet_quantile
from spaln_tpu.score.splice import build_splice_signals, Sig53Tables
from spaln_tpu.seq.codec import encode_dna


def test_dna_matrix_match_mismatch():
    m = dna_matrix()
    assert m[K.A, K.A] == 20          # +2 x10
    assert m[K.C, K.C] == 20
    assert m[K.A, K.C] == -60         # mismatch -6 x10
    assert m[K.A, K.G] == -60
    # ambiguity: A vs M(A|C) -> level 2 -> 0
    assert m[K.A, K.M] == 0
    # R(A|G) vs R: level(5,5) = 4 - ((9*2)//2//2//2) = 2 -> 0
    assert m[K.R, K.R] == 0
    assert m[K.A, K.N] == 0 or m[K.A, K.N] <= 10
    # gap column
    assert m[K.GAP, K.A] == -30
    assert m[K.NIL, K.A] == 0


def test_mdm_pam100(table_dir):
    m = mdm_matrix(100, table_dir.root)
    # values verified directly against the mdm_mtx binary (level 10)
    assert m[K.ALA, K.ALA] == 37
    assert (m == m.T).all()
    assert m[K.TRP, K.TRP] == 98
    assert m[K.TRP, K.CYS] == -5
    assert m[K.CYS, K.CYS] == 84
    assert m[K.AA_NIL, K.ALA] == 0
    assert m[K.AA_UNP, K.ALA] == -40  # -scale*u (u=4 slot 0)


def test_text_matrix_blosum62(table_dir):
    m = text_matrix(table_dir.path("blosum62"))
    assert m[K.ALA, K.ALA] == 40      # blosum62 A/A = 4 -> x10
    assert m[K.TRP, K.TRP] == 110
    assert m[K.ALA, K.ARG] == -10
    assert (m[3:23, 3:23] == m[3:23, 3:23].T).all()


def test_tron_matrix(table_dir):
    p = mdm_matrix(100, table_dir.root)
    t = tron_matrix(p)
    assert t[K.SER2, K.ALA] == t[K.SER, K.ALA]
    assert t[K.TRM, K.ALA] == -300    # premature stop -30 x10
    assert t[K.AA_NIL, K.SER] == 0


def test_pssm_load_and_order(table_dir):
    from spaln_tpu.score.tables import TableDir
    dicty = TableDir(table_dir.root, species="Dictyost")
    p5 = load_pssm(dicty.path("Splice5"))
    assert p5.cols == 8 and p5.rows == 84
    assert p5.morder == 2 and p5.nalpha == 4
    assert p5.offset == 1
    p3 = load_pssm(dicty.path("Splice3"))
    assert p3.cols == 18 and p3.offset == 18
    # generic root-level Splice5 also loads (order-2, 24-wide window)
    p5g = load_pssm(table_dir.path("Splice5"))
    assert p5g.morder == 2 and p5g.tonic == -5.0


def test_pssm_scan_gt_peak(table_dir):
    """A GT-containing window should outscore random on Splice5."""
    p5 = load_pssm(table_dir.path("Splice5"))
    rng = np.random.default_rng(0)
    base = rng.choice(list("ACGT"), 200)
    seq = "".join(base)
    # plant a strong donor-ish context: xxx|GTAAGT
    pos = 100
    seq = seq[:pos] + "GTAAGT" + seq[pos + 6:]
    scores = scan_pssm(p5, encode_dna(seq))
    assert scores[pos] > np.median(scores) + 1.0


def test_intron53_tables(table_dir):
    tabs = Sig53Tables.load(table_dir, fs=28.0)
    # GT should be by far the strongest donor dinucleotide
    GT = 2 * 4 + 3
    AG = 0 * 4 + 2
    assert tabs.tab5[GT] == max(tabs.tab5)
    assert tabs.tab3[AG] == max(tabs.tab3)
    assert tabs.tab5[GT] == int(28.0 * 1.29319)


def test_intron_penalty_shape():
    cfg = resolve(Config(), CvsG)
    ip = IntronPenalty(cfg, CvsG)
    pen = ip.penalty(np.arange(0, 2000))
    # below llmt impossible
    assert (pen[:20] == -32768).all()
    # unimodal-ish: rises to mode then decays
    assert ip.mode > cfg.intron.llmt
    assert pen[ip.mode] == max(pen[20:])
    # monotone decreasing tail
    assert pen[1500] > pen[1900]
    # tail continuity at rlmt
    assert abs(int(pen[ip.rlmt - 1]) - int(pen[ip.rlmt])) < 60


def test_intron_penalty_expected_center():
    cfg = resolve(Config(), CvsG)
    ip = IntronPenalty(cfg, CvsG)
    # by construction, E[penalty + signal] ~= -f*ip = -120
    assert -400 < ip.penalty(ip.mode) + ip.avr_sig < 0


def test_splice_signals_canonical(table_dir):
    cfg = resolve(Config(), CvsG)
    #           0123456789
    seq = "CCCCGTAAGTCCCCCCCCCCCCAGCCCC"
    sig = build_splice_signals(encode_dna(seq), cfg, table_dir)
    assert sig.is_donor[4]            # GT at 4,5
    assert not sig.is_donor[5]
    assert sig.is_accpt[24]           # AG at 22,23 -> acceptor resumes at 24
    assert not sig.is_accpt[23]
    assert sig.phs5[4] == 0
    # composite junction score for the canonical pair is strong
    s = sig.sig53_ie53(4, 24)
    assert s > 0


def test_splice_joint_table_consistency(table_dir):
    cfg = resolve(Config(), CvsG)
    seq = "CCCCGTAAGTCCCCCCCCCCCCAGCCCC"
    sig = build_splice_signals(encode_dna(seq), cfg, table_dir)
    n5, n3 = 4, 24
    expect = (sig.sig3[n3] - sig.tabs.tab3[sig.dinc3[n3]]
              + sig.acc_joint[n3, sig.dinc5[n5]])
    assert sig.sig53_ie53(n5, n3) == expect


def test_species_alnparam_applies(table_dir):
    """-T species re-feeds the AlnParam file as -y args (readargs role):
    the Dictyostelium ILD replaces the generic Frechet mixture."""
    from spaln_tpu.align.driver import AlignerContext
    from spaln_tpu.score.tables import TableDir
    import numpy as np
    generic = AlignerContext.create(table_dir)
    dicty = AlignerContext.create(TableDir(table_dir.root,
                                           species="Dictyost"))
    assert dicty.cfg.intron.llmt == 15
    assert dicty.cfg.intron.rlmt == 131
    pen_g = generic.ipen.penalty(np.array([100, 500]))
    pen_d = dicty.ipen.penalty(np.array([100, 500]))
    assert (pen_g != pen_d).any()


def test_y_args_override(table_dir):
    from spaln_tpu.align.driver import AlignerContext
    ctx = AlignerContext.create(table_dir, y_args=["-yw150", "-yv12"])
    assert ctx.cfg.aln.sh == 150
    assert ctx.prm.gop == -120


def test_intron_penalty_kernel_chain_exact():
    """The DP kernels' compare/select chain (_pack_ipen runs) reproduces
    IntronPenalty.penalty EXACTLY for every length — the bucketed
    quantization is gone."""
    import numpy as np
    from spaln_tpu.config import Config, resolve, CvsG
    from spaln_tpu.ops.params import DpParams
    from spaln_tpu.ops.dp_spliced_scan import _pack_ipen
    from spaln_tpu.score.intron import IntronPenalty
    from spaln_tpu.score.simmtx import Simmtx

    cfg = resolve(Config(), CvsG)
    ip = IntronPenalty(cfg, CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG, ipen=ip)
    n = 50_000                      # past rlmt, deep into the log tail
    tab = prm.intron_table(n)
    key = _pack_ipen(tab)
    assert len(key) < 600, f"chain too long for the kernels: {len(key)}"
    # evaluate the chain exactly as _make_step does
    lens = np.arange(n, dtype=np.int64)
    pen = np.full(n, -(2**31 // 16 * 7) // 2, dtype=np.int64)
    for b, v in key:
        pen[lens >= b] = v
    ref = ip.penalty(lens).astype(np.int64)
    ref = np.where(ref <= -32768, -(2**31 // 16 * 7) // 2, ref)
    np.testing.assert_array_equal(pen, ref)


def test_branch_point_bonus(table_dir):
    """-yB branch-point signal (Exinon::intron53_p, codepot.cc:588-597):
    a Branch-PSSM hit above tonicB adds fB*signal to sig3 of following
    positions while the hit is <= bp_maxb3d behind; verified against a
    literal scalar re-run of the reference's carry loop."""
    from dataclasses import replace as _rep
    from spaln_tpu.config import Config, resolve, PvsG
    from spaln_tpu.score.codepot import build_tron_signals
    from spaln_tpu.score.pssm import load_pssm, scan_pssm
    from spaln_tpu.score.splice import _c_short
    from spaln_tpu.seq.codec import encode_dna

    rng = np.random.default_rng(3)
    g = "".join(rng.choice(list("ACGT"), 600))
    codes = encode_dna(g)
    cfg0 = resolve(Config(), PvsG)
    maxd = 40
    cfg = _rep(cfg0, aln2=_rep(cfg0.aln2, bp_factor=1.0, bp_maxb3d=maxd))
    sig0 = build_tron_signals(codes, cfg0, table_dir)
    sig1 = build_tron_signals(codes, cfg, table_dir)
    pb = load_pssm(table_dir.path("Branch"))
    brs = scan_pssm(pb, codes).astype(np.float64)
    assert (brs > pb.tonic).any(), "no branch hits in the test window"
    # scalar oracle: the reference's running-carry loop
    fB = 1.0 * cfg.aln.scale
    sigB, posB = 0.0, None
    expect = np.zeros(len(codes), dtype=np.int64)
    for p in range(len(codes)):
        expect[p] = _c_short(np.float64(sigB))
        if brs[p] > pb.tonic:
            sigB, posB = fB * brs[p], p
        if posB is not None and p - posB > maxd:
            sigB, posB = 0.0, None
    got = sig1.sig3.astype(np.int64) - sig0.sig3.astype(np.int64)
    np.testing.assert_array_equal(got, expect)


def test_intron_potential_yZ(table_dir, rng):
    """-yZ wires ExinPot's intron oligomer potential into the junction
    score as the cumulative difference sigI[b3-rm]-sigI[b5+lm]
    (codepot.cc:401-435, utilseq.cc:1463-1470)."""
    from dataclasses import replace as _rep
    from spaln_tpu.config import Config, resolve, CvsG
    from spaln_tpu.score.codepot import ExinPot
    from spaln_tpu.score.splice import build_splice_signals, _c_short
    from spaln_tpu.score.tables import TableDir
    from spaln_tpu.seq.codec import encode_dna
    td = TableDir(table_dir.root, species="Dictyost")
    ipt = ExinPot.load(td, "IntronPotTab")
    assert ipt is not None
    g = ("A" * 50 + "GTAAGT" + "".join(rng.choice(list("ACGT"), 300))
         + "TTACAG" + "C" * 50)
    codes = encode_dna(g)
    cfg0 = resolve(Config(), CvsG)
    cfg = _rep(cfg0, aln2=_rep(cfg0.aln2, Z=2.0))
    s0 = build_splice_signals(codes, cfg0, td)
    s1 = build_splice_signals(codes, cfg, td)
    n5, n3 = 50, 362
    d0 = int(s0.sig53_ie53(n5, n3)) + int(s0.sig5[n5])
    d1 = int(s1.sig53_ie53(n5, n3)) + int(s1.sig5[n5])
    cum = np.concatenate([[0.], np.cumsum(
        ipt.scan(codes).astype(np.float64))])
    fI = 2.0 * cfg.aln.scale
    expect = (int(_c_short(np.float64(fI * cum[n3 - ipt.rm])))
              - int(_c_short(np.float64(fI * cum[n5 + ipt.lm]))))
    assert d1 - d0 == expect
    assert expect != 0


def test_y_matrix_overrides(table_dir):
    """-ym/-yn/-yp plumb into the substitution model."""
    from spaln_tpu.config import Config, apply_y_args, resolve, CvsG
    from spaln_tpu.score.simmtx import Simmtx
    from spaln_tpu.seq.codec import encode_dna
    cfg = apply_y_args(Config(), ["-ym3", "-yn-8", "-yp250"])
    assert cfg.aln.smn_match == 3 and cfg.aln.smn_mismatch == -8
    assert cfg.aln.pam1 == 250
    sm = Simmtx.dna(match=cfg.aln.smn_match,
                    mismatch=cfg.aln.smn_mismatch)
    a, c = encode_dna("AC")
    assert sm.mtx[a, a] == 30 and sm.mtx[a, c] == -80
    smp = Simmtx.protein(table_dir.root, pam=250)
    smp0 = Simmtx.protein(table_dir.root)
    assert (smp.mtx != smp0.mtx).any()
