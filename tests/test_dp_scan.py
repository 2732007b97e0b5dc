"""Differential tests: JAX wavefront engine vs the scalar oracle."""
import numpy as np
import pytest

from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops.params import DpParams, DpFlags
from spaln_tpu.ops.dp_spliced_ref import (forward_spliced_ref,
                                          traceback_spliced_ref, Window)
from spaln_tpu.ops.dp_spliced_scan import (forward_spliced_scan,
                                           traceback_spliced_scan)
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.score.splice import build_splice_signals
from spaln_tpu.seq.codec import encode_dna


@pytest.fixture(scope="module")
def cfg():
    return resolve(Config(), CvsG)


@pytest.fixture(scope="module")
def prm(cfg):
    return DpParams.build(cfg, Simmtx.dna(), CvsG,
                          ipen=IntronPenalty(cfg, CvsG))


def _mutate(rng, seq, sub=0.03, indel=0.01):
    bases = "ACGT"
    out = []
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue                          # deletion
        if r < indel:
            out.append(rng.choice(list(bases)))  # insertion
        if rng.random() < sub:
            c = rng.choice(list(bases))
        out.append(c)
    return "".join(out)


def _gene(rng, exon_lens, intron_lens, flank=(20, 20), mut=0.0):
    bases = np.array(list("ACGT"))
    exons = ["".join(rng.choice(bases, L)) for L in exon_lens]
    introns = []
    for L in intron_lens:
        introns.append("GTAAGT" + "".join(rng.choice(bases, L - 13))
                       + "TTTTTAG")
    g = "".join(rng.choice(bases, flank[0]))
    for i, e in enumerate(exons):
        g += e
        if i < len(introns):
            g += introns[i]
    g += "".join(rng.choice(bases, flank[1]))
    q = "".join(exons)
    if mut:
        q = _mutate(rng, q, sub=mut, indel=mut / 3)
    return q, g


CASES = [
    dict(exons=(60, 80), introns=(150,), mut=0.0),
    dict(exons=(40, 50, 45), introns=(90, 120), mut=0.0),
    dict(exons=(60, 80), introns=(200,), mut=0.05),
    dict(exons=(30, 120, 50), introns=(80, 300), mut=0.03),
]


@pytest.mark.parametrize("case", CASES)
def test_scan_matches_oracle_score_and_path(cfg, prm, table_dir, case):
    rng = np.random.default_rng(hash(str(case)) % 2**31)
    q, g = _gene(rng, case["exons"], case["introns"], mut=case["mut"])
    qc, gc = encode_dna(q), encode_dna(g)
    sig = build_splice_signals(gc, cfg, table_dir)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc, gc, prm, sig=sig)
    s_jx, em_j, en_j, tr = forward_spliced_scan(qc, gc, prm, sig=sig, L=32)
    assert s_jx == s_ref
    assert (em_j, en_j) == (em_r, en_r)
    ops_r = traceback_spliced_ref(tb_r, em_r, en_r)
    ops_j = traceback_spliced_scan(tr, em_j, en_j)
    assert ops_j == ops_r


def test_scan_matches_oracle_banded(cfg, prm, table_dir):
    rng = np.random.default_rng(99)
    q, g = _gene(rng, (80, 90), (140,), mut=0.02)
    qc, gc = encode_dna(q), encode_dna(g)
    sig = build_splice_signals(gc, cfg, table_dir)
    wdw = Window.stripe(len(qc), len(gc), sh=100)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc, gc, prm, sig=sig,
                                                  wdw=wdw)
    s_jx, em_j, en_j, tr = forward_spliced_scan(
        qc, gc, prm, sig=sig, lw=wdw.lw, up=wdw.up, L=32)
    assert s_jx == s_ref and (em_j, en_j) == (em_r, en_r)
    assert (traceback_spliced_scan(tr, em_j, en_j)
            == traceback_spliced_ref(tb_r, em_r, en_r))


def test_scan_multislab(cfg, prm, table_dir):
    """Query longer than one slab of lanes (exercises slab boundary)."""
    rng = np.random.default_rng(7)
    q, g = _gene(rng, (90, 100), (120,), mut=0.02)
    qc, gc = encode_dna(q), encode_dna(g)
    sig = build_splice_signals(gc, cfg, table_dir)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc, gc, prm, sig=sig)
    # L=16 -> 12 slabs for a 190nt query
    s_jx, em_j, en_j, tr = forward_spliced_scan(qc, gc, prm, sig=sig, L=16)
    assert s_jx == s_ref and (em_j, en_j) == (em_r, en_r)
    assert (traceback_spliced_scan(tr, em_j, en_j)
            == traceback_spliced_ref(tb_r, em_r, en_r))


def test_scan_no_splice_plain_affine(cfg, prm):
    rng = np.random.default_rng(3)
    bases = np.array(list("ACGT"))
    g = "".join(rng.choice(bases, 300))
    q = _mutate(rng, g[40:260], sub=0.05, indel=0.02)
    qc, gc = encode_dna(q), encode_dna(g)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc, gc, prm)
    s_jx, em_j, en_j, tr = forward_spliced_scan(qc, gc, prm, L=32)
    assert s_jx == s_ref and (em_j, en_j) == (em_r, en_r)


def test_scan_double_affine(cfg, table_dir):
    """dagp (-yl3): E2/F2 long-gap states, scan vs oracle bit-exact."""
    import dataclasses
    from spaln_tpu.config import AlnPrm
    cfg3 = dataclasses.replace(cfg, aln=dataclasses.replace(cfg.aln, ls=3))
    prm3 = DpParams.build(cfg3, Simmtx.dna(), CvsG,
                          ipen=IntronPenalty(cfg3, CvsG))
    assert prm3.dagp and prm3.lgep > prm3.gep  # long gaps cheaper to extend
    rng = np.random.default_rng(11)
    bases = np.array(list("ACGT"))
    # a long interior deletion (60nt) makes the double-affine long-gap
    # state the winner over both the basic gap and an intron
    left = "".join(rng.choice(bases, 70))
    right = "".join(rng.choice(bases, 70))
    mid = "".join(rng.choice(bases, 60))
    g = left + mid + right
    q = left + right
    qc, gc = encode_dna(q), encode_dna(g)
    sig = build_splice_signals(gc, cfg3, table_dir)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc, gc, prm3, sig=sig)
    s_jx, em_j, en_j, tr = forward_spliced_scan(qc, gc, prm3, sig=sig,
                                                L=16)
    assert s_jx == s_ref and (em_j, en_j) == (em_r, en_r)
    assert (traceback_spliced_scan(tr, em_j, en_j)
            == traceback_spliced_ref(tb_r, em_r, en_r))
    # with splicing on, a second case with a real intron + long gap mix
    q2, g2 = _gene(rng, (60, 70), (90,), mut=0.02)
    q2 = q2[:40] + q2[75:]                 # 35nt deletion inside exon span
    qc2, gc2 = encode_dna(q2), encode_dna(g2)
    sig2 = build_splice_signals(gc2, cfg3, table_dir)
    s_ref, em_r, en_r, tb_r = forward_spliced_ref(qc2, gc2, prm3,
                                                  sig=sig2)
    s_jx, em_j, en_j, tr = forward_spliced_scan(qc2, gc2, prm3, sig=sig2,
                                                L=16)
    assert s_jx == s_ref and (em_j, en_j) == (em_r, en_r)
    assert (traceback_spliced_scan(tr, em_j, en_j)
            == traceback_spliced_ref(tb_r, em_r, en_r))


def test_cip_bonus_applied(cfg, prm, table_dir, rng):
    """-yJ conserved-intron-position bonus (Cip_score, gsinfo.h:128;
    applied at acceptor closes, fwd2s1.cc:254/338): a flat per-row
    bonus K raises a one-intron gene's score by exactly K and leaves
    an intronless alignment untouched."""
    from spaln_tpu.ops.dp_spliced_scan import (prepare_spliced_batch,
                                               run_spliced_batch,
                                               collect_batch_results)
    bases = np.array(list("ACGT"))
    e1 = "".join(rng.choice(bases, 60))
    e2 = "".join(rng.choice(bases, 70))
    genome = e1 + "GTAAGT" + "".join(rng.choice(bases, 200)) \
        + "TTACAG" + e2
    q = encode_dna(e1 + e2)
    g = encode_dna(genome)
    sig = build_splice_signals(g, cfg, table_dir)
    K = 50

    def run(cips):
        bp = prepare_spliced_batch([q], [g], prm, sigs=[sig],
                                   L=32, cips=cips)
        row_h, rc_h, tr = run_spliced_batch(bp, prm, score_only=True)
        s, e, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                        prm=prm)
        return int(s[0])

    s0 = run(None)
    s1 = run([{m: K for m in range(1, len(q) + 1)}])
    assert s1 == s0 + K
    # intronless control: no acceptor close on the best path
    g2 = encode_dna(e1 + e2)
    sig2 = build_splice_signals(g2, cfg, table_dir)

    def run2(cips):
        bp = prepare_spliced_batch([q], [g2], prm, sigs=[sig2],
                                   L=32, cips=cips)
        row_h, rc_h, tr = run_spliced_batch(bp, prm, score_only=True)
        s, e, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                        prm=prm)
        return int(s[0])

    assert run2([{m: K for m in range(1, len(q) + 1)}]) == run2(None)


def test_traceback_device_matches_host(cfg, prm, table_dir):
    """Device-side traceback walk == host walk over a mixed batch
    (geometry spread: per-problem lws, lengths)."""
    from spaln_tpu.ops.dp_spliced_scan import (
        prepare_spliced_batch, run_spliced_batch, collect_batch_results,
        traceback_spliced_scan, traceback_device_batch)
    from spaln_tpu.score.splice import build_splice_signals
    from spaln_tpu.score.tables import TableDir
    from spaln_tpu.seq.codec import encode_dna
    tables = table_dir
    # private generator: the shared session rng fixture's stream is
    # order-coupled across tests
    rng = np.random.default_rng(1234)
    bases = np.array(list("ACGT"))
    qs, gs, sigs, lws = [], [], [], []
    for i in range(4):
        e1 = "".join(rng.choice(bases, 50 + 10 * i))
        e2 = "".join(rng.choice(bases, 60))
        gtxt = (e1 + "GTAAGT" + "".join(rng.choice(bases, 120 + 30 * i))
                + "TTACAG" + e2)
        q, g = encode_dna(e1 + e2), encode_dna(gtxt)
        qs.append(q)
        gs.append(g)
        sigs.append(build_splice_signals(g, cfg, tables))
        lws.append(-len(q) + 2 * i)
    W = max(len(g) - lw for g, lw in zip(gs, lws)) + 1
    bp = prepare_spliced_batch(qs, gs, prm, sigs=sigs, lws=lws, W=W, L=32)
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=False)
    scores, ends, btr = collect_batch_results(bp, row_h, rc_h, traces,
                                              False, prm=prm)
    dev_ops = traceback_device_batch(bp, traces, ends)
    for b in range(bp.B):
        host_ops = traceback_spliced_scan(btr[b], int(ends[b][0]),
                                          int(ends[b][1]))
        assert host_ops == dev_ops[b]


@pytest.mark.parametrize("dagp", [False, True])
def test_scan_batch_matches_oracle_per_problem_bands(cfg, table_dir, dagp):
    """The mapping path's engine calls — one batch with per-problem band
    placements (lws) at one common W, device traceback — against the
    oracle, problem by problem.  Bands that hold the origin and bands
    that start right of it (lw > 0, as every mapping window with a
    margin does) must both be bit-identical; with dagp a long deletion
    rides the E2/F2 states."""
    import dataclasses
    from spaln_tpu.ops.dp_spliced_scan import (
        collect_batch_results, prepare_spliced_batch, run_spliced_batch,
        traceback_device_batch)
    if dagp:
        cfg = dataclasses.replace(cfg, aln=dataclasses.replace(cfg.aln,
                                                               ls=3))
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    assert prm.dagp == dagp
    rng = np.random.default_rng(2024)
    qs, gs, sigs, lws = [], [], [], []
    W = 384
    for flank, lw_rel in ((0, None), (150, -30), (300, -60)):
        q, g = _gene(rng, (60, 70), (120,), flank=(flank, 30), mut=0.02)
        if dagp:
            q = q[:20] + q[55:]               # 35-nt deletion in exon 1
        qc, gc = encode_dna(q), encode_dna(g)
        qs.append(qc)
        gs.append(gc)
        sigs.append(build_splice_signals(gc, cfg, table_dir))
        lws.append(-len(qc) if lw_rel is None else flank + lw_rel)
    assert max(lws) > 0
    bp = prepare_spliced_batch(qs, gs, prm, sigs=sigs, lws=lws, W=W, L=32)
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=False)
    scores, ends, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                            prm=prm)
    dev_ops = traceback_device_batch(bp, traces, ends)
    for i in range(bp.B):
        wdw = Window(lws[i], lws[i] + W - 1)
        s_r, em_r, en_r, tb_r = forward_spliced_ref(qs[i], gs[i], prm,
                                                    sig=sigs[i], wdw=wdw)
        assert (int(scores[i]), int(ends[i][0]), int(ends[i][1])) == \
            (s_r, em_r, en_r), f"problem {i}"
        assert dev_ops[i] == traceback_spliced_ref(tb_r, em_r, en_r), \
            f"problem {i}"
        assert any(op[0] == 'I' for op in dev_ops[i])
