"""Multi-intermediate Hirschberg (UDH) vs full-plane traceback.

The contract (fwd2s1.cc:1801-1897 semantics): the linear-space path must
produce bit-identical scores, ends, and op streams to the direct
full-plane traceback, at O(n_slabs*T) instead of O(n_slabs*T*L) trace
memory.
"""
import numpy as np
import pytest

from spaln_tpu.config import Config, resolve, CvsG
from spaln_tpu.ops.params import DpParams, DpFlags
from spaln_tpu.ops.dp_spliced_scan import (collect_batch_results,
                                           forward_spliced_scan,
                                           prepare_spliced_batch,
                                           run_spliced_batch,
                                           traceback_spliced_scan)
from spaln_tpu.ops.dp_spliced_udh import (forward_spliced_udh,
                                          run_spliced_batch_udh)
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
            continue
        if r < indel:
            out.append(rng.choice(list(bases)))
        if rng.random() < sub:
            c = rng.choice(list(bases))
        out.append(c)
    return "".join(out)


def _gene(rng, exon_lens, intron_lens, flank=(20, 20), mut=0.0):
    bases = np.array(list("ACGT"))
    exons = ["".join(rng.choice(bases, L)) for L in exon_lens]
    introns = ["GTAAGT" + "".join(rng.choice(bases, L - 13)) + "TTTTTAG"
               for L in intron_lens]
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


# multi-slab at L=32: queries of 100-200 nt span 4-7 slabs
CASES = [
    dict(exons=(60, 80), introns=(150,), mut=0.0),
    dict(exons=(40, 50, 45), introns=(90, 120), mut=0.0),
    dict(exons=(60, 80), introns=(200,), mut=0.06),   # indels cross slabs
    dict(exons=(30, 120, 50), introns=(80, 300), mut=0.04),
]


def _full(qc, gc, prm, cfg, table_dir, L=32, **kw):
    sig = build_splice_signals(gc, cfg, table_dir)
    s, em, en, tr = forward_spliced_scan(qc, gc, prm, sig=sig, L=L, **kw)
    return s, em, en, traceback_spliced_scan(tr, em, en), sig


@pytest.mark.parametrize("case", CASES)
def test_udh_matches_full_plane(cfg, prm, table_dir, case):
    rng = np.random.default_rng(hash(str(case)) % 2**31)
    q, g = _gene(rng, case["exons"], case["introns"], mut=case["mut"])
    qc, gc = encode_dna(q), encode_dna(g)
    s1, em1, en1, ops1, sig = _full(qc, gc, prm, cfg, table_dir)
    s2, em2, en2, ops2 = forward_spliced_udh(qc, gc, prm, sig=sig, L=32)
    assert s2 == s1
    assert (em2, en2) == (em1, en1)
    assert ops2 == ops1


def test_udh_batched_mixed_geometry(cfg, prm, table_dir):
    """One batch, different M/N and band placements (lws)."""
    rng = np.random.default_rng(77)
    specs = [((60, 80), (150,)), ((40, 90, 40), (100, 90)),
             ((120, 50), (250,))]
    qs, gs, sigs = [], [], []
    for exons, introns in specs:
        q, g = _gene(rng, exons, introns, mut=0.03)
        qs.append(encode_dna(q))
        gs.append(encode_dna(g))
        sigs.append(build_splice_signals(gs[-1], cfg, table_dir))
    W = 512
    lws = [-8, -16, -4]
    bp = prepare_spliced_batch(qs, gs, prm, sigs=sigs, lws=lws, W=W, L=32)
    # full-plane reference
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=False)
    s1, e1, btr = collect_batch_results(bp, row_h, rc_h, traces, False,
                                        prm=prm)
    scores, ends, ops_list = run_spliced_batch_udh(bp, prm)
    for i in range(bp.B):
        ops_full = traceback_spliced_scan(btr[i], int(e1[i][0]),
                                          int(e1[i][1]))
        assert int(scores[i]) == int(s1[i])
        assert tuple(ends[i]) == tuple(e1[i])
        assert ops_list[i] == ops_full, f"problem {i}"


def test_udh_double_affine(cfg, table_dir):
    """dagp (E2/F2) states: long deletions cross slab boundaries in F2."""
    import dataclasses
    cfg3 = dataclasses.replace(cfg, aln=dataclasses.replace(cfg.aln,
                                                            ls=3))
    prm3 = DpParams.build(cfg3, Simmtx.dna(), CvsG,
                          ipen=IntronPenalty(cfg3, CvsG))
    assert prm3.dagp
    rng = np.random.default_rng(11)
    q, g = _gene(rng, (70, 90), (140,), mut=0.0)
    # plant a 40-nt deletion in the query mid-exon (no splice signals)
    q = q[:30] + q[70:]
    qc, gc = encode_dna(q), encode_dna(g)
    s1, em1, en1, ops1, sig = _full(qc, gc, prm3, cfg3, table_dir)
    s2, em2, en2, ops2 = forward_spliced_udh(qc, gc, prm3, sig=sig, L=32)
    assert (s2, em2, en2) == (s1, em1, en1)
    assert ops2 == ops1


def test_udh_right_column_end(cfg, prm, table_dir):
    """End on the right column (genome exhausted, query tail free):
    exercise the rclk link stream."""
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    core = "".join(rng.choice(bases, 100))
    q = core + "".join(rng.choice(bases, 60))   # 60-nt unaligned tail
    g = core
    qc, gc = encode_dna(q), encode_dna(g)
    s1, em1, en1, ops1, sig = _full(qc, gc, prm, cfg, table_dir)
    s2, em2, en2, ops2 = forward_spliced_udh(qc, gc, prm, sig=sig, L=32)
    assert (s2, em2, en2) == (s1, em1, en1)
    assert ops2 == ops1
    assert en1 == len(g)                         # really the right column


def test_udh_through_execute_jobs(cfg, table_dir, monkeypatch):
    """The driver's bucket logic must route big-plane buckets through
    the UDH path with the SAME gene structures as the full-plane path
    (and keep the whole batch in one launch)."""
    from spaln_tpu.align import driver as drv
    from spaln_tpu.align.driver import (AlignerContext, execute_jobs,
                                        prepare_job)
    from spaln_tpu.score.tables import find_table_dir, TableDir
    ctx = AlignerContext.create(TableDir(find_table_dir()))
    rng = np.random.default_rng(21)
    jobs = []
    for _ in range(3):
        q, g = _gene(rng, (60, 80), (150,), mut=0.02)
        jobs.append(prepare_job(encode_dna(q), encode_dna(g), ctx, None))
    res_full = execute_jobs(jobs, ctx, lanes=32)
    monkeypatch.setattr(drv, "PLANE_BYTES_BUDGET", 1)  # force UDH
    res_udh = execute_jobs(jobs, ctx, lanes=32)
    for a, b in zip(res_full, res_udh):
        assert not isinstance(a, BaseException)
        assert not isinstance(b, BaseException)
        assert a.score == b.score
        assert [(e.g_start, e.g_end) for e in a.exons] == \
               [(e.g_start, e.g_end) for e in b.exons]


def test_udh_memory_shape(cfg, prm, table_dir):
    """The links pass must not materialize full planes: its per-slab
    artifacts are 5 (B, T) link streams + 3 (B, T+2) snapshots."""
    rng = np.random.default_rng(9)
    q, g = _gene(rng, (60, 80), (150,))
    qc, gc = encode_dna(q), encode_dna(g)
    sig = build_splice_signals(gc, cfg, table_dir)
    bp = prepare_spliced_batch([qc], [gc], prm, sigs=[sig],
                               lws=[-len(qc)], W=len(gc) + len(qc) + 1,
                               L=32)
    _, _, traces = run_spliced_batch(bp, prm, score_only=True,
                                     emit_links=True)
    assert len(traces) == bp.n_slabs
    links, snap = traces[0]
    assert len(links) == 5
    for st in links:
        assert np.asarray(st).shape == (1, bp.T)
    assert len(snap) == 3
    for sn in snap:
        assert np.asarray(sn).shape == (1, bp.T + 2)


def test_execute_jobs_names_the_engine_of_every_bucket(cfg, table_dir,
                                                       monkeypatch):
    """Each bucket is counted under the engine that ran it: the scan
    engine with full planes and a device walk, or UDH past the plane
    budget or under -A 3 (driver.FORCE_UDH).  No other engine exists."""
    from spaln_tpu.align import driver as drv
    from spaln_tpu.align.driver import (AlignerContext, execute_jobs,
                                        prepare_job)
    from spaln_tpu.utils.metrics import metrics
    ctx = AlignerContext.create(table_dir)
    rng = np.random.default_rng(31)
    jobs = []
    for _ in range(2):
        q, g = _gene(rng, (50, 60), (120,), mut=0.02)
        jobs.append(prepare_job(encode_dna(q), encode_dna(g), ctx, None))
    engines = {"scan_buckets", "scan_jobs", "udh_buckets", "udh_jobs"}
    runs = {}
    for force in (False, True):
        monkeypatch.setattr(drv, "FORCE_UDH", force)
        metrics.reset()
        res = execute_jobs(jobs, ctx, lanes=32)
        c = dict(metrics.counters)
        assert set(c) <= engines | {"jobs", "dp_cells", "dp_cells_real"}
        runs[force] = (c, res, [j.dp for j in jobs])
    (c0, r0, dp0), (c1, r1, dp1) = runs[False], runs[True]
    assert c0["scan_buckets"] == 1 and c0["scan_jobs"] == 2
    assert "udh_buckets" not in c0
    assert c1["udh_buckets"] == 1 and c1["udh_jobs"] == 2
    assert "scan_buckets" not in c1
    assert dp0 == dp1 and all(d is not None for d in dp0)
    for a, b in zip(r0, r1):
        assert a.score == b.score
        assert [(e.g_start, e.g_end) for e in a.exons] == \
            [(e.g_start, e.g_end) for e in b.exons]


@pytest.mark.parametrize("engine", [1, 2, 3])
def test_cli_engine_option(engine, monkeypatch):
    """-A 1 keeps the automatic choice, -A 3 forces UDH, and -A 2 (an
    engine that no longer exists) is refused with a message."""
    from spaln_tpu import cli
    from spaln_tpu.align import driver as drv
    monkeypatch.setattr(drv, "FORCE_UDH", False)
    args = cli.build_parser().parse_args(
        ["map", "q.fa", "-d", "db", "-A", str(engine)])
    if engine == 2:
        with pytest.raises(SystemExit, match="not an engine"):
            cli._apply_engine_opts(args)
        return
    cli._apply_engine_opts(args)
    assert drv.FORCE_UDH == (engine == 3)
