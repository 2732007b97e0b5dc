"""Tests of the protein x translated-genome (tron) spliced DP oracle."""
import numpy as np
import pytest

from spaln_tpu import constants as K
from spaln_tpu.config import Config, resolve, PvsG
from spaln_tpu.ops.dp_tron_ref import (TronDpParams, forward_tron_ref,
                                       traceback_tron_ref)
from spaln_tpu.ops.params import DpFlags
from spaln_tpu.score.codepot import build_tron_signals, spj_tron_tables
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.seq.codec import encode_dna, encode_protein, nuc2tron

# one codon per amino acid for back-translation
_CODON = {}
for _i in range(64):
    _aa = int(K.GENCODE[_i])
    _bases = "ACGT"[(_i >> 4) & 3] + "ACGT"[(_i >> 2) & 3] + "ACGT"[_i & 3]
    _CODON.setdefault(_aa, _bases)

AA_CODES = [c for c in range(3, 23)]


@pytest.fixture(scope="module")
def cfg():
    return resolve(Config(), PvsG)


@pytest.fixture(scope="module")
def tron_prm(cfg, table_dir):
    sm = Simmtx.protein(table_dir.root, slot=0).tron()
    return TronDpParams.build(cfg, sm.mtx)


@pytest.fixture(scope="module")
def ipen_tab(cfg):
    ip = IntronPenalty(cfg, PvsG)
    return ip.penalty(np.arange(20000))


def _backtranslate(aa_codes):
    return "".join(_CODON[int(a)] for a in aa_codes)


def _coding_gene(rng, n_aa=(40, 50), ilen=150):
    aa1 = rng.choice(AA_CODES, n_aa[0])
    aa2 = rng.choice(AA_CODES, n_aa[1])
    e1 = _backtranslate(aa1)
    e2 = _backtranslate(aa2)
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), ilen - 13)) \
        + "TTTCTAG"
    genome = e1 + intron + e2
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    return prot, genome, (len(e1), len(e1) + ilen)


def test_spj_tron_tables():
    t1, t2 = spj_tron_tables()
    # w = ACGT -> codon1 ACG = THR, codon2 CGT = ARG
    w = (0 << 6) | (1 << 4) | (2 << 2) | 3
    assert t1[w] == K.THR
    assert t2[w] == K.ARG
    # AGC: Ser of the AGY class -> SER2
    w2 = (0 << 6) | (2 << 4) | (1 << 2) | 0
    assert t1[w2] == K.SER2


def test_tron_signals(cfg, table_dir, rng):
    g = "ATGGCT" + "".join(rng.choice(list("ACGT"), 100)) + "TAA"
    sig = build_tron_signals(encode_dna(g), cfg, table_dir)
    assert sig.btron[1] == K.MET or g[:3] != "ATG"
    assert len(sig.sigE) == len(g)
    assert sig.spj_tron1 is not None


def test_tron_exact_match_no_intron(cfg, tron_prm, ipen_tab, table_dir,
                                    rng):
    aa = rng.choice(AA_CODES, 50).astype(np.int8)
    g = _backtranslate(aa)
    gc = encode_dna(g)
    sig = build_tron_signals(gc, cfg, table_dir)
    score, em, en, tb = forward_tron_ref(aa, gc, sig, tron_prm, ipen_tab,
                                         spj=False)
    assert em == 50 and en == 150
    ops = traceback_tron_ref(tb, em, en)
    assert sum(1 for o in ops if o[0] == 'D') == 50
    # diagonal matches + coding potential is a lower bound (the free top
    # row may add translation-start / coding-run credit on top)
    bt = sig.btron
    expect = sum(int(tron_prm.qprof_mtx[aa[i], bt[3 * i + 1]])
                 + int(sig.sigE[3 * i + 1]) for i in range(50))
    assert score >= expect
    assert not [o for o in ops if o[0] in ('E', 'F', 'I')]


def test_tron_planted_intron_phase0(cfg, tron_prm, ipen_tab, table_dir,
                                    rng):
    prot, genome, (n5, n3) = _coding_gene(rng)
    gc = encode_dna(genome)
    sig = build_tron_signals(gc, cfg, table_dir)
    assert sig.phs5[n5] == 0 and sig.phs3[n3] == 0
    score, em, en, tb = forward_tron_ref(prot, gc, sig, tron_prm, ipen_tab)
    ops = traceback_tron_ref(tb, em, en)
    introns = [o for o in ops if o[0] == 'I']
    assert len(introns) == 1
    assert introns[0][2] == n5 and introns[0][3] == n3
    assert introns[0][4] == 0
    assert sum(1 for o in ops if o[0] == 'D') == len(prot)


@pytest.mark.parametrize("split,phase", [(1, -1), (2, 1)])
def test_tron_planted_intron_split_codon(cfg, tron_prm, ipen_tab,
                                         table_dir, rng, split, phase):
    """Intron interrupting a codon after `split` bases: the reference
    convention is phase -1 for a 1+2 split and +1 for 2+1 (spjseq
    cs[0]/cs[1] usage, fwd2h1.cc:484-489)."""
    aa1 = rng.choice(AA_CODES, 40)
    aa2 = rng.choice(AA_CODES, 45)
    e1 = _backtranslate(aa1)
    e2 = _backtranslate(aa2)
    mid = _CODON[int(K.ALA)]
    ilen = 200
    intron = "GTGAGT" + "".join(rng.choice(list("ACGT"), ilen - 13)) \
        + "TTTACAG"
    genome = e1 + mid[:split] + intron + mid[split:] + e2
    prot = np.concatenate([aa1, [K.ALA], aa2]).astype(np.int8)
    gc = encode_dna(genome)
    sig = build_tron_signals(gc, cfg, table_dir)
    n5 = len(e1) + split
    n3 = n5 + ilen
    score, em, en, tb = forward_tron_ref(prot, gc, sig, tron_prm, ipen_tab)
    ops = traceback_tron_ref(tb, em, en)
    introns = [o for o in ops if o[0] == 'I']
    assert len(introns) == 1
    assert (introns[0][2], introns[0][3]) == (n5, n3)
    assert introns[0][4] == phase
    assert sum(1 for o in ops if o[0] == 'D') == len(prot)


def test_tron_frameshift_deletion(cfg, tron_prm, ipen_tab, table_dir, rng):
    """Genome missing 1 nt inside the coding region -> SLA2 frameshift."""
    aa = rng.choice(AA_CODES, 60).astype(np.int8)
    g = _backtranslate(aa)
    g_mut = g[:90] + g[91:]                  # delete 1 nt
    gc = encode_dna(g_mut)
    sig = build_tron_signals(gc, cfg, table_dir)
    score, em, en, tb = forward_tron_ref(aa, gc, sig, tron_prm, ipen_tab,
                                         spj=False)
    ops = traceback_tron_ref(tb, em, en)
    kinds = [o[0] for o in ops]
    assert 'F' in kinds or 'E' in kinds      # a frameshift op was used
    assert sum(1 for o in ops if o[0] == 'D') >= 55


# ---------------------------------------------------------------- dagp
# Double-affine (Noll=3, -yl3) long-gap states E2/F2 in the tron engine
# (fwd2h1.cc:413-425, 439-448; costs from PwdB ctor aln2.cc:99-127:
# LongGEP = -u1*Vab, LongGOP = BasicGOP - (LongGEP-BasicGEP)*k1).

@pytest.fixture(scope="module")
def tron_prm_dagp(cfg, table_dir):
    from dataclasses import replace
    sm = Simmtx.protein(table_dir.root, slot=0).tron()
    base = TronDpParams.build(cfg, sm.mtx)
    lgep = -int(0.6 * cfg.aln.scale)
    lgop = base.gop - (lgep - base.gep) * 7
    return replace(base, dagp=True, lgop=lgop, lgep=lgep)


def test_tron_dagp_long_deletion(cfg, tron_prm, tron_prm_dagp, ipen_tab,
                                 table_dir, rng):
    """A 20-codon genomic deletion: F2 (VERL) must carry it, improving
    the score by exactly (lgop+d*lgep) - (gop+d*gep)."""
    d = 20
    aa = rng.choice(AA_CODES, 70).astype(np.int8)
    g = _backtranslate(aa)
    g_mut = g[:90] + g[90 + 3 * d:]           # drop 20 codons
    gc = encode_dna(g_mut)
    sig = build_tron_signals(gc, cfg, table_dir)
    s1, em1, en1, tb1 = forward_tron_ref(aa, gc, sig, tron_prm, ipen_tab,
                                         spj=False)
    s2, em2, en2, tb2 = forward_tron_ref(aa, gc, sig, tron_prm_dagp,
                                         ipen_tab, spj=False)
    p = tron_prm_dagp
    gain = (p.lgop + d * p.lgep) - (p.gop + d * p.gep)
    assert gain > 0
    assert s2 == s1 + gain
    ops = traceback_tron_ref(tb2, em2, en2)
    fops = [o for o in ops if o[0] == 'F']
    assert len(fops) == d and all(o[3] == 0 for o in fops)


def test_tron_dagp_long_insertion(cfg, tron_prm, tron_prm_dagp, ipen_tab,
                                  table_dir, rng):
    """A 20-codon genomic insertion with no splice signals (A/C-only
    interior: no GT donor, no AG acceptor) -> E2 (HORL) carries it."""
    d = 20
    aa = rng.choice(AA_CODES, 70).astype(np.int8)
    g = _backtranslate(aa)
    ins = "".join(rng.choice(list("AC"), 3 * d))
    g_mut = g[:120] + ins + g[120:]
    gc = encode_dna(g_mut)
    sig = build_tron_signals(gc, cfg, table_dir)
    s1, *_ = forward_tron_ref(aa, gc, sig, tron_prm, ipen_tab, spj=False)
    s2, em2, en2, tb2 = forward_tron_ref(aa, gc, sig, tron_prm_dagp,
                                         ipen_tab, spj=False)
    p = tron_prm_dagp
    gain = (p.lgop + d * p.lgep) - (p.gop + d * p.gep)
    assert s2 == s1 + gain
    ops = traceback_tron_ref(tb2, em2, en2)
    eops = [o for o in ops if o[0] == 'E']
    assert len(eops) == d and all(o[3] == 3 for o in eops)


def test_tron_dagp_short_gap_unchanged(cfg, tron_prm, tron_prm_dagp,
                                       ipen_tab, table_dir, rng):
    """Short (3-codon) deletion: single-affine wins below the k1 flex
    point, so dagp must not change the score."""
    aa = rng.choice(AA_CODES, 60).astype(np.int8)
    g = _backtranslate(aa)
    g_mut = g[:90] + g[99:]                   # drop 3 codons
    gc = encode_dna(g_mut)
    sig = build_tron_signals(gc, cfg, table_dir)
    s1, *_ = forward_tron_ref(aa, gc, sig, tron_prm, ipen_tab, spj=False)
    s2, *_ = forward_tron_ref(aa, gc, sig, tron_prm_dagp, ipen_tab,
                              spj=False)
    assert s2 == s1


def test_tron_dagp_intron_still_wins(cfg, tron_prm_dagp, ipen_tab,
                                     table_dir, rng):
    """With dagp on, a real intron must still be spliced (F2/E2 must not
    absorb it) and the structure must match the single-affine result."""
    prot, genome, (n5, n3) = _coding_gene(rng)
    gc = encode_dna(genome)
    sig = build_tron_signals(gc, cfg, table_dir)
    score, em, en, tb = forward_tron_ref(prot, gc, sig, tron_prm_dagp,
                                         ipen_tab)
    ops = traceback_tron_ref(tb, em, en)
    introns = [o for o in ops if o[0] == 'I']
    assert len(introns) == 1
    assert introns[0][2] == n5 and introns[0][3] == n3


@pytest.mark.parametrize("local", [False, True])
def test_tron_fused_batch_device_walk_matches_host_and_oracle(
        cfg, tron_prm, ipen_tab, table_dir, local):
    """The protein mapping path's engine calls at a tiny size: one batch
    through the fused all-slab program, walked on device, against the
    host plane walk and the scalar oracle — per-problem bands, one of
    them starting right of the origin (lw > 0) as mapping windows do."""
    from spaln_tpu.ops.dp_tron_scan import (collect_tron_results,
                                            prepare_tron_batch,
                                            run_tron_batch,
                                            traceback_tron_device,
                                            traceback_tron_scan)
    rng = np.random.default_rng(77)
    flags = DpFlags(local=local)
    qs, gs, sigs, lws = [], [], [], []
    W = 480
    for flank in (0, 30, 90):
        prot, genome, _ = _coding_gene(rng, n_aa=(14, 12), ilen=90)
        gc = encode_dna(_backtranslate(rng.choice(AA_CODES, flank // 3))
                        + genome)
        qs.append(prot)
        gs.append(gc)
        sigs.append(build_tron_signals(gc, cfg, table_dir))
        lws.append(flank - 12 if flank else -3 * len(prot))
    assert max(lws) > 0
    bp = prepare_tron_batch(qs, gs, sigs, tron_prm, ipen_tab, lws=lws,
                            W=W, L=8, flags=flags)
    row_np, rc_np, planes = run_tron_batch(bp, tron_prm, score_only=False,
                                           keep_device=True)
    res = collect_tron_results(bp, row_np, rc_np, planes, True)
    dev_ops = traceback_tron_device(bp, planes, [(r[1], r[2]) for r in res])
    row_h, rc_h, traces = run_tron_batch(bp, tron_prm, score_only=False)
    res_h = collect_tron_results(bp, row_h, rc_h, traces, False)
    for i in range(bp.B):
        s, em, en, tr = res_h[i]
        assert res[i][:3] == (s, em, en)
        assert dev_ops[i] == traceback_tron_scan(tr, em, en), f"problem {i}"
        s_r, em_r, en_r, tb_r = forward_tron_ref(
            qs[i], gs[i], sigs[i], tron_prm, ipen_tab, lw=lws[i],
            up=lws[i] + W - 2, flags=flags)
        assert (s, em, en) == (s_r, em_r, en_r), f"problem {i}"
        assert dev_ops[i] == traceback_tron_ref(tb_r, em_r, en_r)
