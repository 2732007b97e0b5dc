"""Seeded alignment driver: query x genomic window -> gene structures.

The role of Aln2s1's driver hierarchy (globalS_ng/seededS_ng, fwd2s1.cc:
2587-2778) re-shaped for an accelerator pipeline: host-side seeding and
geometry (Wilber-Lipman chains -> strand -> window -> band), device
wavefront DP and traceback walk, host gene-structure extraction.  Control
flow stays on host (SURVEY.md section 7 stance).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import Config, resolve, CvsG
from ..ops.params import DpParams, DpFlags
from ..ops.dp_spliced_scan import forward_spliced_scan, traceback_spliced_scan
from ..score.intron import IntronPenalty
from ..score.simmtx import Simmtx
from ..score.splice import build_splice_signals, SpliceSignals
from ..score.tables import TableDir
from ..seed.wilip import wilip, Chain
from ..seq.codec import comrev
from .gene import GeneStructure, build_gene_structure


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class AlignerContext:
    """Per-run immutable context (tables + resolved params)."""
    cfg: Config
    tables: TableDir
    prm: DpParams
    ipen: IntronPenalty
    flags: "DpFlags" = None        # end-gap mode (-L; default lcl 15)

    @classmethod
    def create(cls, tables: TableDir, cfg: Config | None = None,
               dvsp: int = CvsG, local: bool = False,
               y_args: list | None = None) -> "AlignerContext":
        from ..config import apply_y_args
        from ..ops.params import DpFlags
        cfg = cfg or Config()
        # species AlnParam file re-fed as -y args (readargs role)
        cfg = apply_y_args(cfg, tables.alnparam_args())
        if y_args:
            cfg = apply_y_args(cfg, y_args)
        cfg = resolve(cfg, dvsp)
        ipen = IntronPenalty(cfg, dvsp)
        sm = Simmtx.dna(match=cfg.aln.smn_match,
                        mismatch=cfg.aln.smn_mismatch)
        prm = DpParams.build(cfg, sm, dvsp, ipen=ipen)
        return cls(cfg=cfg, tables=tables, prm=prm, ipen=ipen,
                   flags=DpFlags(local=local))


def align_cdna(query: np.ndarray, genome: np.ndarray, ctx: AlignerContext,
               strand: str = "auto", level: int = 1, sh: int = 100,
               margin: int = 2000, lanes: int = 128, q_name: str = "",
               g_name: str = "", g_off: int = 0) -> list[GeneStructure]:
    """Map and align one cDNA query onto one genomic window.

    Returns gene structures (usually one), genome coordinates relative to
    the given window plus ``g_off``.  ``strand='auto'`` tries both
    orientations and keeps the better chain (geneorient, wln.cc:1024).
    """
    results: list[GeneStructure] = []
    # minus-strand genes are aligned in TRANSCRIPT orientation: the
    # original query against the reverse-complemented genomic window, so
    # the splice-signal model (GT..AG donors/acceptors, PSSMs) applies
    # exactly as on the plus strand (the reference evaluates reverse
    # genes the same way and converts coordinates at output, sqpr
    # SiteNo); results are re-expressed in forward-genome coordinates by
    # _to_minus_view.
    cands: list[tuple[int, str, np.ndarray, Chain | None]] = []
    fwd_chains = wilip(query, genome, level=level, ipen=ctx.ipen,
                       prm=ctx.prm, spaced=ctx.cfg.alg.crs > 0)
    if strand in ("auto", "+") and fwd_chains:
        cands.append((fwd_chains[0].score, "+", genome, fwd_chains[0]))
    rc_g = None
    if strand in ("auto", "-"):
        rc_g = comrev(genome)
        rev_chains = wilip(query, rc_g, level=level, ipen=ctx.ipen,
                            prm=ctx.prm, spaced=ctx.cfg.alg.crs > 0)
        if rev_chains:
            cands.append((rev_chains[0].score, "-", rc_g, rev_chains[0]))
    if not cands and strand in ("auto", "+"):
        cands.append((0, "+", genome, None))
    if not cands:
        if strand != "-":
            return []
        cands.append((0, "-", rc_g if rc_g is not None
                      else comrev(genome), None))
    cands.sort(key=lambda c: -c[0])
    score0, st, g_use, chain = cands[0]
    gs = None
    if chain is not None and _max_gap(chain) > BIG_GAP:
        gs = _align_long(query, g_use, ctx, chain, sh=sh, margin=margin,
                         lanes=lanes, q_name=q_name, g_name=g_name,
                         strand=st)
    if gs is None:
        gs = _align_window(query, g_use, ctx, chain, sh=sh, margin=margin,
                           lanes=lanes, q_name=q_name, g_name=g_name,
                           g_off=g_off, strand=st)
    if gs is not None:
        results.append(gs)
    return results


# genomic diagonal jump above which the DP splits around the intron and
# the junction is resolved in closed form instead of inside the band
# (the role of interpolateS choosing indelfreespjS for large gaps,
# fwd2s1.cc:2003-2162, and of the cutrng shortcut fwd2s1.cc:423-430)
BIG_GAP = 16384

# device-memory budget for full traceback planes in one batched launch;
# buckets that exceed it at the requested batch switch to the linear-
# space Hirschberg path instead of shrinking the batch (MaxVmfSpace
# role, vmf.h:26-28 — the decision lspS_ng makes per problem,
# fwd2s1.cc:1841-1854, made here per bucket)
PLANE_BYTES_BUDGET = 3 << 29

# every multi-slab bucket takes the linear-space path (cli -A 3)
FORCE_UDH = False


def _max_gap(chain: Chain) -> int:
    return max((b.diag - a.diag for a, b in zip(chain.hsps,
                                                chain.hsps[1:])),
               default=0)


def _split_chain(chain: Chain) -> list[Chain]:
    groups: list[list] = [[chain.hsps[0]]]
    for a, b in zip(chain.hsps, chain.hsps[1:]):
        if b.diag - a.diag > BIG_GAP:
            groups.append([b])
        else:
            groups[-1].append(b)
    return [Chain(hsps=g, score=0) for g in groups]


def _splice_join(q, g, sig, prm, d1: int, d2: int, m_lo: int, m_hi: int):
    """Best splice junction connecting two fixed diagonals: maximize
    prefix(m) + spj(m + d1, m + d2) + suffix(m) over junction query
    position m in [m_lo, m_hi] (indelfreespjS, fwd2s1.cc:2003-2093).

    Returns (m, gain, n5, n3) or None when no eligible site exists.
    1-based m: exon left ends after query residue m; donor boundary
    n5 = m + d1, acceptor boundary n3 = m + d2 (0-based positions)."""
    ms = np.arange(m_lo, m_hi + 1)
    n5 = ms + d1
    n3 = ms + d2
    N = len(g)
    ok = (n5 >= 0) & (n3 + 1 <= N) & (n5 <= n3)
    ok &= sig.is_donor[np.clip(n5, 0, N - 1)] != 0
    ok &= sig.is_accpt[np.clip(n3, 0, N - 1)] != 0
    if not ok.any():
        return None
    # per-m diagonal substitution scores, cumulative: residue m (1-based)
    # pairs with g[m-1+d] on diagonal d
    qi = np.asarray(q, dtype=np.int64)[ms - 1]
    sub1 = prm.qprof_mtx[qi, np.asarray(
        g, dtype=np.int64)[np.clip(ms - 1 + d1, 0, N - 1)]]
    sub2 = prm.qprof_mtx[qi, np.asarray(
        g, dtype=np.int64)[np.clip(ms - 1 + d2, 0, N - 1)]]
    # prefix: residues m_lo+1..m on d1 (residue m_lo itself belongs to
    # the left anchor); suffix: residues m+1..m_hi on d2
    pre = np.concatenate([[0], np.cumsum(sub1[1:])])
    suf = np.concatenate([np.cumsum(sub2[1:][::-1])[::-1], [0]])
    ilen = d2 - d1
    ipen = int(prm.intron_table(ilen + 2)[ilen])
    accb = sig.sig3.astype(np.int64) - sig.tabs.tab3[sig.dinc3]
    joint = sig.acc_joint[np.clip(n3, 0, N - 1),
                          np.clip(sig.dinc5[np.clip(n5, 0, N - 1)], 0, 15)]
    spj = (sig.sig5[np.clip(n5, 0, N - 1)].astype(np.int64)
           + accb[np.clip(n3, 0, N - 1)] + joint + ipen)
    tot = np.where(ok, pre + spj + suf, np.int64(-2**62))
    k = int(np.argmax(tot))
    if tot[k] <= -2**61:
        return None
    m = int(ms[k])
    return m, int(tot[k]), int(n5[k]), int(n3[k])


def _micro_exon_join(q, g, sig, prm, d1: int, d2: int,
                     m_lo: int, m_hi: int):
    """Join via a micro exon: snap to the nearest eligible donor after
    the left anchor and acceptor before the right anchor (nearest5ss/
    3ss, fwd2s1.cc:2094-2162), then place the interior query piece with
    micro_exon_scan.  Returns (ma, mb, l, r, p, total) where total is
    score-comparable with _splice_join's gain over [m_lo, m_hi]."""
    from .refine import micro_exon_scan
    N = len(g)
    don = np.nonzero(sig.is_donor[
        np.clip(m_lo + d1, 0, N):np.clip(m_hi + d1 + 1, 0, N)])[0]
    acc = np.nonzero(sig.is_accpt[
        np.clip(m_lo + d2, 0, N):np.clip(m_hi + d2 + 1, 0, N)])[0]
    if not len(don) or not len(acc):
        return None
    qi = np.asarray(q, dtype=np.int64)
    gi = np.asarray(g, dtype=np.int64)
    best = None
    # a chance GT/AG near the anchors can shadow the true sites, so
    # every eligible site pair in the (short) anchor windows is scored
    for dof in don:
        for aof in acc:
            l = int(dof) + max(m_lo + d1, 0)
            r = int(aof) + max(m_lo + d2, 0)
            ma, mb = l - d1, r - d2
            if not (m_lo <= ma <= m_hi and m_lo <= mb <= m_hi) \
                    or ma > mb:
                continue
            res = micro_exon_scan(q, g, sig, prm, ma, mb, l, r, w=1.0)
            if res is None:
                continue
            pre = int(prm.qprof_mtx[
                qi[m_lo:ma],
                gi[np.clip(np.arange(m_lo, ma) + d1, 0, N - 1)]].sum())
            suf = int(prm.qprof_mtx[
                qi[mb:m_hi],
                gi[np.clip(np.arange(mb, m_hi) + d2, 0, N - 1)]].sum())
            tot = pre + res[0] + suf
            if best is None or tot > best[5]:
                best = (ma, mb, l, r, res[1], tot)
    return best


def _align_long(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                chain: Chain, sh: int, margin: int, lanes: int,
                q_name: str, g_name: str,
                strand: str) -> GeneStructure | None:
    """Long-intron path: per-segment banded DP + closed-form junction
    joins, so band width (and traceback memory) stays bounded by exon
    cluster geometry, not intron length."""
    from ..ops.dp_spliced_scan import (forward_spliced_scan,
                                       traceback_spliced_scan)
    segs = _split_chain(chain)
    JN = 24
    M = len(q)
    sig_full = build_splice_signals(np.asarray(g), ctx.cfg, ctx.tables)
    all_ops: list = []
    prev = None                    # (d_right, q_end) of previous segment
    for si, seg in enumerate(segs):
        qa = 0 if si == 0 else min(seg.hsps[0].jx + JN, M - 1)
        if si == len(segs) - 1:
            qb = M
        else:
            qb = min(segs[si + 1].hsps[0].jx, seg.hsps[-1].rx)
        qb = max(qb, qa + 1)
        if si > 0:
            # join previous segment to this one across the big gap.
            # The left anchor may have crept a few chance-matching
            # bases past the true junction; give the join creepback
            # slack and strip those trailing ops (creepback,
            # fwd2s1.cc:1960-2001)
            d1, _ = prev
            d2 = seg.hsps[0].diag
            CB = 12
            m_lo = max(min(prev[1], seg.hsps[0].jx + JN) - CB, 1)
            while (all_ops and all_ops[-1][0] != 'I'
                   and all_ops[-1][1] > m_lo):
                all_ops.pop()
            m_hi = min(seg.hsps[0].jx + JN, M - 1)
            jn = _splice_join(q, g, sig_full, ctx.prm, d1, d2,
                              m_lo, m_hi)
            # micro-exon alternative between the nearest eligible sites
            # (micro_exon, fwd2s1.cc:2163-2234); interpolateS picks the
            # better-scoring option
            me = _micro_exon_join(q, g, sig_full, ctx.prm, d1, d2,
                                  m_lo, m_hi)
            if me is not None and me[4] >= 0 and (
                    jn is None or me[5] > jn[1]):
                ma, mb, l, r, p, _tot = me
                for m in range(m_lo + 1, ma + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', ma, l, p))
                for i2, m in enumerate(range(ma + 1, mb + 1)):
                    all_ops.append(('D', m, p + i2 + 1))
                all_ops.append(('I', mb, p + (mb - ma), r))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            elif jn is not None:
                mb, _, n5, n3 = jn
                for m in range(m_lo + 1, mb + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', mb, n5, n3))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            elif me is not None and me[4] < 0:
                # skipped-exon single junction; any interior query
                # residues (ma < mb) stay unpaired
                ma, mb, l, r, p, _tot = me
                for m in range(m_lo + 1, ma + 1):
                    all_ops.append(('D', m, m + d1))
                all_ops.append(('I', ma, l, r))
                for m in range(ma + 1, mb + 1):
                    all_ops.append(('F', m, r))
                for m in range(mb + 1, qa + 1):
                    all_ops.append(('D', m, m + d2))
            else:
                return None        # caller may fall back to wide band
        # banded DP over this segment's query slice
        q_sub = np.asarray(q[qa:qb])
        lo = max(0, seg.hsps[0].jy - (seg.hsps[0].jx - qa) - margin)
        hi = min(len(g), seg.hsps[-1].ry + (qb - seg.hsps[-1].rx)
                 + margin)
        gw = np.asarray(g[lo:hi])
        sig = build_splice_signals(gw, ctx.cfg, ctx.tables)
        # full coords: n = m + d; sub coords m' = m - qa, n' = n - lo
        # => d' = d - lo + qa
        diags = [h.diag - lo + qa for h in seg.hsps]
        Ms = len(q_sub)
        lw = max(min(diags) - sh, -Ms)
        up = min(max(diags) + sh, len(gw))
        if si == 0 and qa == 0 and seg.hsps[0].jx > 15:
            lw = max(lw - seg.hsps[0].jx - margin, -Ms)
        if si == len(segs) - 1 and qb == M and M - seg.hsps[-1].rx > 15:
            up = min(up + (M - seg.hsps[-1].rx) + margin, len(gw))
        W = up - lw + 1
        Wb = _round_up(W, 256)
        lw = max(lw - (Wb - W) // 2, -Ms)
        up = min(lw + Wb - 1, len(gw))
        lw = max(up - Wb + 1, -Ms)
        score, em, en, tr = forward_spliced_scan(q_sub, gw, ctx.prm,
                                                 sig=sig, lw=lw, up=up,
                                                 L=lanes)
        ops = traceback_spliced_scan(tr, em, en)
        # shift sub-problem coords into full coords
        for op in ops:
            if op[0] == 'I':
                all_ops.append(('I', op[1] + qa, op[2] + lo, op[3] + lo))
            else:
                all_ops.append((op[0], op[1] + qa, op[2] + lo))
        prev = (seg.hsps[-1].diag, min(qb, em + qa))
    total = 0                       # rescore from the op stream
    gs = build_gene_structure(all_ops, q, np.asarray(g), total,
                              sig=sig_full, q_name=q_name, g_name=g_name,
                              strand=strand, prm=ctx.prm)
    if gs is None:
        return None
    gs.score = _score_ops(all_ops, q, g, sig_full, ctx.prm)
    from .refine import refine_ends
    refine_ends(gs, q, g, sig_full, ctx.prm)
    if strand == "-":
        _to_minus_view(gs, len(q), len(g))
    return gs


def _score_ops(ops: list, q, g, sig, prm) -> int:
    """Score an op stream under the engine's model (for joined paths)."""
    tot = 0
    ipen_cache: dict[int, int] = {}
    accb = None
    state = None
    for op in ops:
        if op[0] == 'D':
            _, m, n = op
            tot += int(prm.qprof_mtx[q[m - 1], g[n - 1]])
            state = None
        elif op[0] in ('E', 'F'):
            tot += prm.gep + (prm.gop if state != op[0] else 0)
            state = op[0]
        elif op[0] == 'I':
            _, m, n5, n3 = op
            ilen = n3 - n5
            if ilen not in ipen_cache:
                ipen_cache[ilen] = int(prm.intron_table(ilen + 2)[ilen])
            if accb is None:
                accb = sig.sig3.astype(np.int64) - sig.tabs.tab3[sig.dinc3]
            joint = sig.acc_joint[n3, np.clip(sig.dinc5[n5], 0, 15)]
            tot += (int(sig.sig5[n5]) + int(accb[n3]) + int(joint)
                    + ipen_cache[ilen])
            state = None
    return int(tot)


@dataclass
class AlignJob:
    """One query x genomic-window DP problem, band resolved, ready for
    the batched engine (the unit the reference's ThQueue dispatches,
    spaln.cc:1220-1296 — here jobs bucket by geometry and run as one
    device launch)."""
    q: np.ndarray
    gw: np.ndarray
    sig: object
    lw: int
    up: int
    strand: str
    lo: int                      # gw offset within the caller's window
    g_total: int = 0             # caller-window length (minus-view flip)
    q_name: str = ""
    g_name: str = ""
    cip: dict | None = None      # -yJ query junction bonus {m: value}
    # raw DP result (score, end_m, end_n, ops) once execute_jobs ran it:
    # what the scalar oracle reproduces for the same band
    dp: tuple | None = None


def prepare_job(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                chain: Chain | None, sh: int = 100, margin: int = 2000,
                q_name: str = "", g_name: str = "",
                strand: str = "+", cip: dict | None = None
                ) -> AlignJob | None:
    """Window restriction + band geometry for one problem (stripe role,
    aln2.cc:156-199)."""
    M = len(q)
    if chain is not None:
        g0, g1 = chain.g_span
        q0, q1 = chain.q_span
        # uncovered query ends may be short first/last exons across an
        # unseen intron: keep enough upstream/downstream genome in the
        # window for the end-refinement scan (first_exon/last_exon,
        # fwd2s1.cc:2274-2404)
        end_margin = 20_000
        lo = max(0, g0 - q0 - (margin if q0 <= 8 else end_margin))
        hi = min(len(g), g1 + (M - q1)
                 + (margin if M - q1 <= 8 else end_margin))
    else:
        lo, hi = 0, len(g)
    gw = np.asarray(g[lo:hi])
    N = len(gw)
    if N == 0 or M == 0:
        return None
    sig = build_splice_signals(gw, ctx.cfg, ctx.tables)
    if chain is not None:
        diags = [h.diag - lo for h in chain.hsps]
        lw = max(min(diags) - sh, -M)
        up = min(max(diags) + sh, N)
        # query ends not covered by the chain may sit across an unseen
        # intron (the reference re-searches ends recursively,
        # first_exon/last_exon fwd2s1.cc:2274-2404); widen the band there
        q0, q1 = chain.q_span
        if q0 > 15:
            lw = max(lw - q0 - margin, -M)
        if M - q1 > 15:
            up = min(up + (M - q1) + margin, N)
    else:
        lw, up = -M, N
    # bucket the band width GEOMETRICALLY to limit recompilation: every
    # distinct W is a fresh XLA compile (~24 s for a cDNA slab program
    # on the H100, PERF.md), and linear 256-step buckets produce 100+ of
    # them across a mapping run with end-margin-widened windows; 1.5x
    # steps cap the bucket count at ~12 for W up to 100k at <=50%
    # masked-cell overhead
    W = up - lw + 1
    Wb = 512
    while Wb < W:
        Wb = _round_up(Wb * 3 // 2, 256)
    extra = Wb - W
    lw = max(lw - extra // 2, -M)
    up = min(lw + Wb - 1, N)
    lw = max(up - Wb + 1, -M)
    return AlignJob(q=q, gw=gw, sig=sig, lw=lw, up=up, strand=strand,
                    lo=lo, g_total=len(g), q_name=q_name, g_name=g_name,
                    cip=cip)


def _to_minus_view(gs: GeneStructure, M: int, N: int) -> GeneStructure:
    """Re-express a minus-strand result computed in transcript
    orientation (original query x length-N reverse-complemented window)
    in the output convention: rc-query coordinates with ascending
    forward-genome coordinates (the reference's SiteNo conversion,
    sqpr.cc)."""
    for e in gs.exons:
        e.q_start, e.q_end = M - e.q_end, M - e.q_start
        e.g_start, e.g_end = N - e.g_end, N - e.g_start
    gs.exons.reverse()
    for i in gs.introns:
        i.g_start, i.g_end = N - i.g_end, N - i.g_start
        i.q_pos = M - i.q_pos
    gs.introns.reverse()
    return gs


def _finish_job(job: AlignJob, score: int, ops: list,
                prm=None) -> GeneStructure | None:
    gs = build_gene_structure(ops, job.q, job.gw, score, sig=job.sig,
                              q_name=job.q_name, g_name=job.g_name,
                              strand=job.strand, prm=prm)
    if gs is None:
        return None
    if prm is not None and job.sig is not None:
        # first/last-exon end refinement (fwd2s1.cc:2274-2404) in
        # window/transcript coordinates, before offset + strand flips
        from .refine import refine_ends
        refine_ends(gs, job.q, job.gw, job.sig, prm)
    for e in gs.exons:
        e.g_start += job.lo
        e.g_end += job.lo
    for i in gs.introns:
        i.g_start += job.lo
        i.g_end += job.lo
    if job.strand == "-":
        _to_minus_view(gs, len(job.q), job.g_total)
    return gs


def execute_jobs(jobs: list[AlignJob], ctx: AlignerContext,
                 lanes: int = 128, max_batch: int = 32,
                 mesh=None) -> list[GeneStructure | None]:
    """Run many jobs through the batched wavefront engine, bucketed by
    padded geometry (the data-parallel replacement of the reference's
    worker pool; one launch per (W, Mpad) bucket)."""
    from ..ops.dp_spliced_scan import (_geom_bucket,
                                       collect_batch_results,
                                       prepare_spliced_batch,
                                       run_spliced_batch,
                                       traceback_device_batch)
    from ..ops.dp_spliced_udh import run_spliced_batch_udh
    from ..utils.metrics import metrics, stage
    results: list[GeneStructure | None] = [None] * len(jobs)
    buckets: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        if job is None:
            continue
        W = job.up - job.lw + 1
        Mpad = _round_up(len(job.q), lanes)
        key = (W, Mpad)
        buckets.setdefault(key, []).append(i)
    # bucket coalescing: every bucket is one more launch sequence and
    # every distinct geometry one more compile — promote under-filled W
    # classes of the same Mpad into the widest W of the group (the band
    # is a search-space restriction; widening only adds freedom).
    # SPALN_BUCKET_MERGE=0 disables.
    if os.environ.get("SPALN_BUCKET_MERGE", "1") == "1":
        by_m: dict[int, list[tuple]] = {}
        for (W, Mpad), idxs in buckets.items():
            by_m.setdefault(Mpad, []).append((W, idxs))
        merged: dict[tuple, list[int]] = {}
        for Mpad, entries in by_m.items():
            entries.sort()                      # ascending W
            Wmax = entries[-1][0]
            small, kept = [], []
            for W, idxs in entries:
                if W < Wmax and len(idxs) < max_batch:
                    small.extend(idxs)
                else:
                    kept.append((W, idxs))
            if small:
                if kept and kept[-1][0] == Wmax:
                    kept[-1] = (Wmax, kept[-1][1] + small)
                else:
                    kept.append((Wmax, small))
                for i in small:
                    jobs[i].up = jobs[i].lw + Wmax - 1
            for W, idxs in kept:
                merged[(W, Mpad)] = idxs
        buckets = merged
    for (W, Mpad), idxs in buckets.items():
        # traceback planes cost ~(W + 2L) * L * 13B per slab per problem.
        # Small geometries run the single-pass full-plane path within
        # PLANE_BYTES_BUDGET; past it, the multi-intermediate Hirschberg
        # (UDH) path keeps the full batch: O(T) links per slab + one
        # slab of planes at a time, so batch size no longer collapses
        # with band width or query length (lspS_ng space policy,
        # fwd2s1.cc:1801-1897).
        T = W + 2 * lanes - 2
        n_slabs = max(Mpad // lanes, 1)
        per = T * lanes * 13 * n_slabs
        mb_full = max(1, PLANE_BYTES_BUDGET // max(per, 1))
        use_udh = n_slabs > 1 and (
            FORCE_UDH or mb_full < min(max_batch, len(idxs)))
        mb = (min(max_batch, len(idxs)) if use_udh
              else min(max_batch, mb_full))
        metrics.bump("udh_buckets" if use_udh else "scan_buckets")
        for c0 in range(0, len(idxs), mb):
            part = idxs[c0:c0 + mb]
            js = [jobs[i] for i in part]
            # pad the batch size onto the geometric ladder (and, when
            # sharded, to a device-count multiple): every distinct B is
            # a fresh trace/compile, and mapping runs produce ragged
            # remainder batches (B=1,2,3,...).  Padded problems re-run
            # the last job; their results are discarded.
            if mesh is not None:
                # device-multiple padding only: multiples of ndev are
                # already coarse compile buckets, and stacking the
                # geometric ladder on top over-pads small buckets
                ndev = mesh.devices.size
                bpad = -(-len(js) // ndev) * ndev
            else:
                bpad = _geom_bucket(len(js))
            while len(js) < bpad:
                js.append(js[-1])
            with stage("prep"):
                cips = ([j.cip for j in js]
                        if any(j.cip for j in js) else None)
                bp = prepare_spliced_batch(
                    [j.q for j in js], [j.gw for j in js], ctx.prm,
                    sigs=[j.sig for j in js], lws=[j.lw for j in js],
                    W=W, L=lanes, cips=cips, flags=ctx.flags)
                if mesh is not None:
                    bp = _shard_batch(bp, mesh)
            with stage("device_dp"):
                if use_udh:
                    scores, ends, ops_all = run_spliced_batch_udh(
                        bp, ctx.prm)
                else:
                    row_h, rc_h, traces = run_spliced_batch(
                        bp, ctx.prm, score_only=False)
            metrics.bump("udh_jobs" if use_udh else "scan_jobs", len(part))
            metrics.bump("dp_cells", bp.B * bp.n_slabs * bp.L * bp.W)
            metrics.bump("dp_cells_real",
                         len(part) * bp.n_slabs * bp.L * bp.W)
            with stage("traceback"):
                if not use_udh:
                    scores, ends, _ = collect_batch_results(
                        bp, row_h, rc_h, None, True, prm=ctx.prm)
                    ops_all = traceback_device_batch(bp, traces, ends)
                for bi, ji in enumerate(part):
                    # per-job isolation: an extraction failure surfaces
                    # as an exception result, not an abort
                    jobs[ji].dp = (int(scores[bi]), int(ends[bi][0]),
                                   int(ends[bi][1]), ops_all[bi])
                    try:
                        results[ji] = _finish_job(
                            jobs[ji], int(scores[bi]), ops_all[bi],
                            prm=ctx.prm)
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as exc:
                        results[ji] = exc
            metrics.bump("jobs", len(part))
    return results


def _shard_batch(bp, mesh):
    """Place batch operands data-parallel over a device mesh: XLA
    partitions the natively batched scan along the batch axis (query-
    parallel across devices — no collectives needed until the locus
    merge)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import dataclasses
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    from ..utils.metrics import metrics
    if bp.B % ndev != 0:
        # unreachable in execute_jobs (batches are padded to a device
        # multiple); counted so tests can assert nothing degraded
        metrics.bump("unsharded_batches")
        return bp
    metrics.bump("sharded_batches")
    return dataclasses.replace(
        bp,
        ops={k: put(v, P(axis)) for k, v in bp.ops.items()},
        ops_s={k: put(v, P()) for k, v in bp.ops_s.items()},
        qprof_all=put(bp.qprof_all, P(axis)),
        bnd_h0=put(bp.bnd_h0, P(axis)), bnd_f0=put(bp.bnd_f0, P(axis)),
        bnd_f20=put(bp.bnd_f20, P(axis)),
        Ms_j=put(bp.Ms_j, P(axis)), Ns_j=put(bp.Ns_j, P(axis)),
        deltas_j=put(bp.deltas_j, P(axis)))


def _align_window(q: np.ndarray, g: np.ndarray, ctx: AlignerContext,
                  chain: Chain | None, sh: int, margin: int, lanes: int,
                  q_name: str, g_name: str, g_off: int,
                  strand: str) -> GeneStructure | None:
    job = prepare_job(q, g, ctx, chain, sh=sh, margin=margin,
                      q_name=q_name, g_name=g_name, strand=strand)
    if job is None:
        return None
    W = job.up - job.lw + 1
    T = W + 2 * lanes - 2
    n_slabs = -(-len(job.q) // lanes)
    if n_slabs > 1 and T * lanes * 13 * n_slabs > (96 << 20):
        # full planes would exceed ~96 MB: linear-space Hirschberg
        from ..ops.dp_spliced_udh import forward_spliced_udh
        score, em, en, ops = forward_spliced_udh(
            job.q, job.gw, ctx.prm, sig=job.sig, lw=job.lw, up=job.up,
            L=lanes)
        return _finish_job(job, score, ops, prm=ctx.prm)
    score, em, en, tr = forward_spliced_scan(job.q, job.gw, ctx.prm,
                                             sig=job.sig, lw=job.lw,
                                             up=job.up, L=lanes)
    ops = traceback_spliced_scan(tr, em, en)
    return _finish_job(job, score, ops, prm=ctx.prm)
