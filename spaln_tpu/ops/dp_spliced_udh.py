"""Multi-intermediate unidirectional Hirschberg traceback — linear space.

The reference's flagship v3.0 space mechanism (lspS_ng multi-intermediate
path, fwd2s1.cc:1801-1897; crossing records udh_intermediate.h:29-92):
one forward pass records, at n_imd intermediate rows, where every live
path crossed; the optimal path's crossings are then recovered and only
the thin strips between intermediates are re-aligned with full traceback
state.  Memory drops from O(M*W) to O(n_imd*W) while the op stream stays
bit-identical.

Wavefront redesign: the intermediate rows ARE the wavefront engine's slab
boundaries (every L-th query row).  Three phases:

1. links forward (dp_spliced_scan emit_links): every DP value carries a
   packed (column, state) link to where its path crossed the previous
   slab boundary; the boundary / final-row / right-column emissions
   include those links.  Cost over score-only: a handful of selects per
   state.  Storage per slab: 5 link streams of T ints + a 3x(T+2)
   entry-boundary snapshot — ~40x below the full trace planes (T*L*13B).
2. host backwalk (_backwalk): O(n_slabs) link lookups walk the end
   cell's crossing chain down to slab 0 — the role of cpos[] extraction
   after hirschbergS_ng.
3. strip retrace (_retrace): each slab is re-run ALONE in full-trace
   mode (its entry boundary restored from the snapshot — slabs start
   with fresh carry, so the re-run is bit-identical to the links pass),
   batched across problems, one slab of plane memory live at a time;
   host strip walks between consecutive crossings stitch the final op
   stream (mimd_postwork role, fwd2s1.cc:1714-1756).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .params import DpParams, DpFlags, NEVSEL
from .dp_spliced_scan import (BatchProblem, SliceTrace, _pads, _scan_slab,
                              collect_batch_results, prepare_spliced_batch,
                              run_spliced_batch, snap_pos,
                              traceback_spliced_strip, unpack_link)

NEV = np.int32(NEVSEL)

# link-stream indices within a slab's emission tuple (dp_spliced_scan
# step, emit_links ys[5:]): crossing-state -> boundary stream
_BND_STREAM = {0: 0, 2: 1, 4: 4}    # H, F, F2
_ROW_STREAM = 2                      # final-row (lane of row M)
_RC_STREAM = 3                       # right column (n == N)


def run_spliced_batch_udh(bp: BatchProblem, prm: DpParams):
    """Full UDH pipeline over a prepared batch.

    Returns (scores, ends, ops_list) — op streams identical to the
    full-plane ``traceback_spliced_scan`` path."""
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=True,
                                            emit_links=True)
    scores, ends, _ = collect_batch_results(bp, row_h, rc_h, None, True,
                                            prm=prm)
    links = [[np.asarray(st) for st in t[0]] for t in traces]
    snaps = [t[1] for t in traces]
    crossings = _backwalk(bp, links, ends)
    ops_list = _retrace(bp, prm, snaps, crossings, ends)
    return scores, ends, ops_list


def _end_link_t(bp: BatchProblem, i: int, bm: int, bn: int):
    """(slab, stream, t) of the end cell's link emission, or None when
    the end is not a computed DP cell (stale band-edge / column-0 corner
    candidates from lastS extraction — those trace to an empty op
    stream, matching the full-plane walk's inactive-cell break)."""
    L, W, T = bp.L, bp.W, bp.T
    M, N = bp.Ms[i], bp.Ns[i]
    d = bp.deltas[i]
    sf = (bm - 1) // L
    m0 = sf * L + 1
    if bm == M:
        li = M - m0                      # lane of the final row
        cr0 = m0 + bp.lw + 1 - L
        t = bn - cr0 - d - (L - li)
        lane = li
        stream = _ROW_STREAM
    else:                                # right column: bn == N
        cc0 = 2 * m0 + bp.lw + 1 - bp.Nmax
        t = bm - cc0 - d - (bp.Nmax - N)
        lane = m0 + bp.lw + 1 + d + t - N
        stream = _RC_STREAM
    if not (0 <= t < T and 0 <= lane < L and 0 <= t - 2 * lane < W):
        return None
    return sf, stream, t


def _backwalk(bp: BatchProblem, links: list, ends) -> list:
    """Per problem: {slab s: (col, state)} crossing at row s*L for every
    slab boundary the optimal path spans, or None for a no-op end."""
    L = bp.L
    out = []
    for i in range(bp.B):
        bm, bn = int(ends[i][0]), int(ends[i][1])
        if bm < 1 or bn < 1:
            out.append(None)
            continue
        sf = (bm - 1) // L
        cr: dict[int, tuple[int, int]] = {}
        if sf > 0:
            loc = _end_link_t(bp, i, bm, bn)
            if loc is None:
                out.append(None)
                continue
            s_, stream, t = loc
            col, st = unpack_link(int(links[s_][stream][i, t]))
            for s in range(sf, 0, -1):
                cr[s] = (col, st)
                if col == 0 or s == 1:
                    for s2 in range(s - 1, 0, -1):
                        cr[s2] = (0, 0)   # path rides column 0 below
                    break
                # the crossing cell sits on slab s-1's last row; its own
                # link is in slab s-1's boundary stream for its state
                m0p = (s - 1) * L + 1
                cb0 = m0p + bp.lw + 2 - L
                tb = col - cb0 - bp.deltas[i]
                assert 0 <= tb < bp.T, (i, s, col, tb)
                col, st = unpack_link(
                    int(links[s - 1][_BND_STREAM[st]][i, tb]))
        out.append(cr)
    return out


def _retrace(bp: BatchProblem, prm: DpParams, snaps: list,
             crossings: list, ends) -> list:
    """Re-run each needed slab in full-trace mode (entry boundary
    restored from the snapshot) and walk every problem's strip through
    it.  Plane memory live at any moment: ONE slab."""
    B, L, W, T = bp.B, bp.L, bp.W, bp.T
    PB, TOTn, PBm, TOTm = _pads(L, T, bp.Nmax, bp.Mpad)
    scan = _scan_slab(B, L, W, prm.gop, prm.gep, prm.intron_llmt, T,
                      bp.pad2, bp.Nmax, bp.Mpad, bp.ncls, bp.ipen_key,
                      lgop=prm.lgop, lgep=prm.lgep, dagp=prm.dagp,
                      emit_trace=True)
    lw0 = jnp.asarray(bp.lw)
    strips: list[dict[int, list]] = [dict() for _ in range(B)]
    for s in range(bp.n_slabs):
        want = []
        for i in range(B):
            cri = crossings[i]
            if cri is None:
                continue
            bm, bn = int(ends[i][0]), int(ends[i][1])
            if bm < 1 or bn < 1:
                continue
            sf = (bm - 1) // L
            if s > sf:
                continue
            if s == sf:
                start = (bm, bn, 0)
            else:
                col, st = cri[s + 1]
                if col == 0:
                    strips[i][s] = []
                    continue
                start = ((s + 1) * L, col, st)
            want.append((i, start))
        if not want:
            continue
        m0 = s * L + 1
        p0 = snap_pos(bp, s)
        full = []
        for snap in snaps[s]:
            arr = jnp.full((B, TOTn), NEV, jnp.int32)
            full.append(jax.lax.dynamic_update_slice(
                arr, snap.astype(jnp.int32), (0, p0)))
        bnd_h, bnd_f, bnd_f2 = full
        row_h = jnp.full((B, TOTn), NEV, jnp.int32)
        rc_h = jnp.full((B, TOTm), NEV, jnp.int32)
        qprof_slab = jax.lax.dynamic_slice_in_dim(bp.qprof_all, m0 - 1,
                                                  L, axis=1)
        _, ys = scan(qprof_slab, bp.ops, bp.ops_s, bnd_h, bnd_f, bnd_f2,
                     row_h, rc_h, m0, lw0, bp.deltas_j, bp.Ms_j,
                     bp.Ns_j, bp.flags.a_exgr)
        fl_all = np.asarray(ys[0])      # (T, B, L) uint8
        sp_all = np.asarray(ys[1])      # (T, B, L, n_states)
        for i, (m_s, n_s, st_s) in want:
            fl = [None] * bp.n_slabs
            sp = [None] * bp.n_slabs
            fl[s] = fl_all[:, i]
            sp[s] = sp_all[:, i]
            tr = SliceTrace(flags=fl, spj=sp, L=L, lw=bp.lws[i], W=W)
            ops, xm, xn, xst = traceback_spliced_strip(
                tr, m_s, n_s, st_s, m_stop=s * L)
            strips[i][s] = ops
    out = []
    for i in range(B):
        if crossings[i] is None:
            out.append([])
            continue
        allops: list = []
        for s in sorted(strips[i]):
            allops.extend(strips[i][s])
        out.append(allops)
    return out


def forward_spliced_udh(a: np.ndarray, b: np.ndarray, prm: DpParams,
                        sig=None, lw: int | None = None,
                        up: int | None = None,
                        flags: DpFlags | None = None, L: int = 128):
    """Single-problem UDH driver: (score, end_m, end_n, ops) with
    O(n_slabs*T) trace memory — the linear-space twin of
    forward_spliced_scan + traceback_spliced_scan."""
    flags = flags or DpFlags()
    M, N = len(a), len(b)
    if lw is None:
        lw, up = -M, N
    bp = prepare_spliced_batch([np.asarray(a)], [np.asarray(b)], prm,
                               sigs=[sig] if sig is not None else None,
                               lws=[lw], W=up - lw + 1, flags=flags, L=L)
    scores, ends, ops_list = run_spliced_batch_udh(bp, prm)
    return int(scores[0]), int(ends[0][0]), int(ends[0][1]), ops_list[0]
