"""Protein vs protein-DB (semi-)global search — the spaln -a mode.

The role of Aln2b1's seeded driver + CalcServer fan-out (fwd2b1.cc:1405,
calcserv.h): score one query against many DB entries and align the best
hits.  Batched shape: all DB entries are one batched wavefront launch
(score-only), then the top hits get a traceback pass — no per-entry
threading, just batch axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import Config, resolve, PvsP
from ..ops.params import DpParams, DpFlags
from ..ops.dp_spliced_scan import (forward_spliced_batch,
                                   traceback_spliced_scan,
                                   prepare_spliced_batch,
                                   run_spliced_batch,
                                   collect_local_ends, pick_colonies,
                                   SliceTrace)
from ..score.simmtx import Simmtx
from .gene import GeneStructure, build_gene_structure


@dataclass
class ProteinHit:
    name: str
    score: int
    q_span: tuple
    s_span: tuple
    identity: float
    structure: GeneStructure | None = None


def search_protein_db(query: np.ndarray, db: list, ctx_tables=None,
                      matrix: str | None = None, table_dir: str = "",
                      max_hits: int = 10, align_top: int = 1,
                      lanes: int = 64, batch: int = 64,
                      cfg: Config | None = None,
                      prefilter: bool | None = None,
                      db_index=None) -> list[ProteinHit]:
    """Rank DB entries by semi-global alignment score; align the best.

    db: list of (name, codes) tuples.  For large DBs a k-mer prefilter
    (SrchBlk::finds role, blksrc.cc:3271+) selects candidate entries so
    the DP runs on a calibrated subset; pass prefilter=False to force
    full DP on every entry, or a prebuilt ProteinDbIndex via db_index.
    """
    cfg = resolve(cfg or Config(), PvsP)
    if matrix:
        from ..score.simmtx import text_matrix
        sm = Simmtx(text_matrix(matrix), u=4., v=10.)
    else:
        sm = Simmtx.protein(table_dir, slot=0)
    prm = DpParams.build(cfg, sm, PvsP)
    flags = DpFlags()                      # semi-global
    if prefilter is None:
        prefilter = len(db) > 256
    cand_ids = np.arange(len(db))
    if prefilter and len(db):
        from ..seed.dbindex import ProteinDbIndex
        if db_index is None:
            db_index = ProteinDbIndex.build(db)
        cand_ids = db_index.candidates(query,
                                       max_cand=max(4 * max_hits, 64),
                                       min_hits=max_hits)
    scores = np.full(len(db), -(1 << 60), dtype=np.int64)
    for b0 in range(0, len(cand_ids), batch):
        ids = cand_ids[b0:b0 + batch]
        qs = [query] * len(ids)
        gs = [db[i][1] for i in ids]
        s, e, _ = forward_spliced_batch(qs, gs, prm, sigs=None,
                                        flags=flags, L=lanes,
                                        score_only=True)
        scores[ids] = s
    order = np.argsort(scores)[::-1][:max_hits]
    order = order[scores[order] > -(1 << 60)]
    hits: list[ProteinHit] = []
    for rank, i in enumerate(order):
        name, codes = db[i]
        hit = ProteinHit(name=name, score=int(scores[i]),
                         q_span=(0, len(query)), s_span=(0, len(codes)),
                         identity=0.0)
        if rank < align_top:
            s, e, tr = forward_spliced_batch(
                [query], [codes], prm, sigs=None, flags=flags, L=lanes,
                score_only=False)
            ops = traceback_spliced_scan(tr[0], int(e[0][0]), int(e[0][1]))
            gsr = build_gene_structure(ops, query, codes, int(s[0]),
                                       q_name="query", g_name=name,
                                       aa_pair=True)
            if gsr is not None:
                hit.structure = gsr
                hit.identity = gsr.identity
                hit.q_span = gsr.q_span
                hit.s_span = gsr.g_span
        hits.append(hit)
    return hits


def search_protein_local(query: np.ndarray, db: list,
                         matrix: str | None = None, table_dir: str = "",
                         max_out: int = 4, vthr: int | None = None,
                         lanes: int = 64, batch: int = 64,
                         cfg: Config | None = None) -> list[ProteinHit]:
    """SWG multi-local search (fwdswgB_ng + Colonies, fwd2b1.cc:734):
    every local-alignment island scoring >= vthr is reported, up to
    max_out per DB entry.  Batched shape: one zero-floor local forward per
    batch with per-step max emissions; colony ends are extracted on
    host (Colonies::detectoverlap role) and each traced back in the
    recorded planes."""
    cfg = resolve(cfg or Config(), PvsP)
    if matrix:
        from ..score.simmtx import text_matrix
        sm = Simmtx(text_matrix(matrix), u=4., v=10.)
    else:
        sm = Simmtx.protein(table_dir, slot=0)
    prm = DpParams.build(cfg, sm, PvsP)
    if vthr is None:
        vthr = int(cfg.aln.thr * cfg.aln.scale)   # pwd->Vthr
    flags = DpFlags(local=True)
    hits: list[ProteinHit] = []
    for b0 in range(0, len(db), batch):
        chunk = db[b0:b0 + batch]
        qs = [query] * len(chunk)
        gs = [codes for _, codes in chunk]
        bp = prepare_spliced_batch(qs, gs, prm, sigs=None, flags=flags,
                                   L=lanes)
        row_h, rc_h, traces = run_spliced_batch(bp, prm,
                                                score_only=False)
        ends = collect_local_ends(bp, traces, vthr)
        for i, cands in enumerate(ends):
            name = chunk[i][0]
            tr = SliceTrace(flags=[np.asarray(ys[0])[:, i]
                                   for ys in traces],
                            spj=[np.asarray(ys[1])[:, i]
                                 for ys in traces],
                            L=bp.L, lw=bp.lws[i], W=bp.W)

            def _trace(m, n, _tr=tr, _i=i):
                ops = traceback_spliced_scan(_tr, m, n)
                if not ops:
                    return None
                return (ops[0][1], ops[0][2], ops)

            for val, m, n, (m0, n0, ops) in pick_colonies(
                    cands, _trace, max_out=max_out, gep=prm.gep,
                    vthr=vthr):
                gsr = build_gene_structure(ops, query, chunk[i][1], val,
                                           q_name="query", g_name=name,
                                           aa_pair=True)
                if gsr is None:
                    continue
                hits.append(ProteinHit(name=name, score=val,
                                       q_span=gsr.q_span,
                                       s_span=gsr.g_span,
                                       identity=gsr.identity,
                                       structure=gsr))
    hits.sort(key=lambda h: -h.score)
    return hits
