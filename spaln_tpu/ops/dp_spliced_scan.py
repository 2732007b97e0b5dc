"""Banded spliced DP as a JAX wavefront scan — the device compute path.

Re-designs the reference's SIMD slab engine (fwd2s1_simd.cc:309-457) for
XLA: a rhomboidal wavefront where vector lane i owns query row
m = m0 + i and at scan step t computes the single cell

    n_i(t) = (m0 + lw + 1 + t) - i          (band offset r = lw + 1 + t - 2i)

so every dependency is a lane-shift of the previous one or two steps'
outputs: left (E/H) = same lane @ t-1, up (F/H) = lane i-1 @ t-1,
diag = lane i-1 @ t-2.  All genome-indexed operands (residues, splice
signals, acceptor tables) are read as contiguous slices of pre-reversed
arrays, so each step is elementwise vector work with no gathers; the
intron-length penalty is a compare/select chain over compile-time
constants (see _pack_ipen).

The step is authored NATIVELY BATCHED over B problems — (B, L) lanes,
(B, L, NCAND) candidates — never vmapped: vmap turns the batch-shared
penalty lookup into a batch-dims gather.  Per-problem band placement is
pre-baked into the operand layout (build_operands shift) so every
in-scan dynamic-slice start is batch-invariant (a batch-varying start
lowers to a gather).

Splice state per lane: the NCAND=4 donor-candidate list (value, junction,
state, donor dinucleotide) kept sorted by value with masked insertion —
the vectorized equivalent of fwd2s1.cc:380-406 — plus the psp orphan-exon
bitmask.  Tie-breaking and comparison directions follow the scalar oracle
(SURVEY.md A.4) exactly; tests assert bit-identical scores and paths.

Query rows beyond one slab of L lanes run as consecutive slabs; slab i+1
reads its top boundary (H/F of the previous slab's last row, per n) from
buffers the previous slab writes as post-scan windows.

Scores are x10 fixed-point int32 (no re-basing needed, unlike the
reference's int16 lanes, fwd2s1_simd.cc:458-465).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .params import DpParams, DpFlags, NEVSEL
from ..score.splice import SpliceSignals

NCAND = 4
I32 = jnp.int32
NEV = np.int32(NEVSEL)


@dataclass
class SplicedOperands:
    """Device-ready per-problem operands (host-built, padded)."""
    qprof: np.ndarray       # (Mpad, 17) int32: substitution row per query pos
    rb_code: np.ndarray     # (Npad+PAD,) int8 reversed genome codes
    rb_isdon: np.ndarray    # reversed donor mask (int32 0/1)
    rb_isacc: np.ndarray
    rb_sig5: np.ndarray     # reversed donor signal
    rb_accb: np.ndarray     # reversed acceptor base sig3 - tab3[dinc3]
    rb_d5cls: np.ndarray    # reversed donor dinucleotide class ids
    rb_joint4: np.ndarray   # (Npad+PAD, ncls) reversed joint acceptor term
    ipen: np.ndarray        # (Npad+1,) intron penalty by length
    colinit: np.ndarray     # (Mpad+L+2,) H[m][0] init column (padded)
    ncls: int
    M: int
    N: int


def build_operands(a: np.ndarray, b: np.ndarray, prm: DpParams,
                   sig: SpliceSignals | None, Mpad: int, Npad: int,
                   flags: DpFlags, pad_extra: int,
                   L: int = 128, shift: int = 0) -> SplicedOperands:
    """``shift`` pre-bakes this problem's band placement (lw - lw0) into
    the array layout so the per-step slice offsets inside the scan are
    batch-invariant (a batch-varying dynamic-slice start lowers to a
    gather)."""
    M, N = len(a), len(b)
    qprof = np.zeros((Mpad, prm.qprof_mtx.shape[1]), dtype=np.int32)
    qprof[:M] = prm.qprof_mtx[np.asarray(a, dtype=np.int64)]

    def rev(x, fill=0, width=None):
        # right-aligned at pad2 + Npad (+ per-problem band shift) so the
        # shared index pad2 + Npad - n addresses b[n-1] uniformly for any
        # N <= Npad (geometry bucketing)
        out = np.full(Npad + pad_extra, fill, dtype=np.int32) if width is None \
            else np.full((Npad + pad_extra, width), fill, dtype=np.int32)
        o = pad_extra // 2 + Npad - N + shift
        out[o:o + N] = x[::-1]
        return out

    NCLS = 4                      # donor dinucleotide classes (GT/GC/AT..)
    if sig is not None:
        accb = sig.sig3.astype(np.int32) - sig.tabs.tab3[sig.dinc3]
        # compress the 16-wide joint acceptor table to the dinucleotide
        # classes that can actually sit in a candidate (donor-eligible
        # positions only) — turns the close-time gather into a 4-term
        # one-hot sum
        don_dincs = np.unique(sig.dinc5[sig.is_donor != 0])
        if len(don_dincs) > NCLS:
            raise ValueError("more than 4 eligible donor dinucleotide "
                             "classes; rebuild with a wider class table")
        cls_of = np.zeros(16, dtype=np.int32)
        for ci, dv in enumerate(don_dincs):
            cls_of[dv] = ci
        joint4 = np.zeros((N, NCLS), dtype=np.int32)
        for ci, dv in enumerate(don_dincs):
            joint4[:, ci] = sig.acc_joint[:, dv]
        rb_isdon = rev(sig.is_donor.astype(np.int32))
        rb_isacc = rev(sig.is_accpt.astype(np.int32))
        rb_sig5 = rev(sig.sig5.astype(np.int32))
        rb_accb = rev(accb)
        rb_d5cls = rev(cls_of[sig.dinc5.astype(np.int64)])
        rb_joint4 = rev(joint4, width=NCLS)
        ipen = prm.intron_table(Npad + 1)
    else:
        z = np.zeros(N, dtype=np.int32)
        rb_isdon = rev(z)
        rb_isacc = rev(z)
        rb_sig5 = rev(z)
        rb_accb = rev(z)
        rb_d5cls = rev(z)
        rb_joint4 = rev(np.zeros((N, NCLS), np.int32), width=NCLS)
        ipen = np.full(Npad + 1, NEVSEL // 2, dtype=np.int32)

    rb_code = rev(np.asarray(b, dtype=np.int32))
    colinit = np.zeros(Mpad + L + 2, dtype=np.int64)
    if not flags.b_exgl:
        ms = np.arange(1, Mpad + L + 2)
        colinit[1:] = prm.gop + prm.gep * ms
    return SplicedOperands(qprof=qprof, rb_code=rb_code, rb_isdon=rb_isdon,
                           rb_isacc=rb_isacc, rb_sig5=rb_sig5,
                           rb_accb=rb_accb, rb_d5cls=rb_d5cls,
                           rb_joint4=rb_joint4, ipen=ipen,
                           colinit=colinit.astype(np.int32), ncls=NCLS,
                           M=M, N=N)


def _pack_ipen(tab: np.ndarray) -> tuple:
    """Reduce the dense EXACT penalty table (DpParams.intron_table) to
    its constant-value runs as (start_length, value) pairs — a hashable
    tuple so it enters the compiled slab as compile-time constants (part
    of the _scan_slab cache key).  The kernel evaluates the runs as a
    compare/select chain, reproducing the table bit-exactly: the smooth
    penalty has only ~200 distinct int values over a 13k range, so the
    exact chain is as cheap as any quantized one.  Whether a plain table
    gather is cheaper on the GPU is an open measurement (PERF.md)."""
    tab = np.asarray(tab, dtype=np.int32)
    keep = np.ones(len(tab), dtype=bool)
    keep[1:] = tab[1:] != tab[:-1]
    bases = np.flatnonzero(keep)
    return tuple((int(b), int(tab[b])) for b in bases)


def _insert_candidate(cv, x, do_push, *fields):
    """Masked insertion of x (+ companion fields, given as (arr, new)
    pairs) into the sorted candidate list (B, L, NCAND), evicting the
    worst.  Ties keep existing entries first (reference scans from the
    tail with strict >, fwd2s1.cc:393-398)."""
    pos = jnp.sum(cv >= x[..., None], axis=-1)           # insertion slot
    slot = jnp.arange(NCAND)[None, None, :]
    ins_here = (slot == pos[..., None]) & do_push[..., None]
    shift = (slot > pos[..., None]) & do_push[..., None]

    def place(arr, new):
        shifted = jnp.concatenate(
            [arr[..., :1], arr[..., :-1]], axis=-1)      # arr[j-1]
        return jnp.where(ins_here, new[..., None],
                         jnp.where(shift, shifted, arr))

    return (place(cv, x),) + tuple(place(a, nw) for a, nw in fields)


def _geom_bucket(x: int) -> int:
    """Smallest member of the 1/2/3-scaled power-of-2 ladder
    (1,2,3,4,6,8,12,16,...) >= x: <=33% padding, O(log) distinct
    geometries instead of O(range)."""
    x = max(int(x), 1)
    b = 1
    while True:
        for m in (b, b + b // 2 if b > 1 else None):
            if m is not None and m >= x:
                return m
        b *= 2


def _pads(L, T, Npad, Mpad):
    """Left pad / total sizes for the n-indexed (boundary, final-row) and
    m-indexed (right-column) write-back arrays.  Windows are written at
    BATCH-SHARED cursors; per-problem placement is applied by the host
    readers (collect).  Storage conventions (delta = lw_i - lw0):
      bnd:   p = PBn + n - delta
      row_h: p = PBn + n - delta + li - L     (li = lane of final row M)
      rc_h:  p = PBm + m - delta - (Npad - N)
    so the left pads must absorb the largest negative offsets."""
    PBn = Mpad + Npad + 2 * L + 16
    TOTn = PBn + Mpad + Npad + T + 2 * L + 16
    PBm = Mpad + 2 * Npad + L + 16
    TOTm = PBm + 2 * Mpad + Npad + T + L + 16
    return PBn, TOTn, PBm, TOTm


PSP_BIT = (4, 1, 8, 2, 16)        # psp bits per state (aln.h:56-59)


def pack_link(col, state):
    """Hirschberg crossing record: column * 8 + state (SURVEY A.7 ulk
    role — the position/state where this cell's path crossed the last
    intermediate row, i.e. the previous slab boundary)."""
    return col * 8 + state


def unpack_link(lk):
    return lk // 8, lk % 8


def _make_step(L, W, gop, gep, llmt, pad2, Npad, Mpad, PB, ncls, ipen_key,
               lgop=0, lgep=0, dagp=False, emit_trace=True,
               emit_links=False, local=False, cip=False):
    """Build the scan step — natively batched over B (closures over
    static geometry; lw0, delta, m0, M, N traced).  No per-step
    scatters (boundary/result values are emitted as scan outputs and
    written back as contiguous windows after the scan), every
    dynamic-slice start batch-invariant, no vmap anywhere, and the
    penalty lookup evaluated as a compare/select chain over the
    (base, value) constants in ipen_key.

    dagp adds the double-affine states E2/F2 (LongGOP/GEP, -yl3;
    dp_spliced_ref states 3/4) to the recurrence, candidate list and
    traceback planes.

    emit_links is the multi-intermediate unidirectional Hirschberg
    forward (fwd2s1.cc:1801-1897, udh_intermediate.h): every value
    additionally carries the (column, state) where its path crossed the
    previous slab boundary (the intermediate row); boundary emissions
    include those links, so a host backwalk recovers the path's crossing
    at every L-th row from O(n_slabs * T) link storage instead of
    O(T * L) traceback planes.  Mutually exclusive with emit_trace."""
    n_states = 5 if dagp else 3

    def step(carry, t, *, B, qprof_slab, ops_b, ops_s, bnd_h, bnd_f,
             bnd_f2, col_m, col_m1, e_const, li, m0, lw0, delta, M, N,
             a_exgr, cip_slab=None):
        lks = None
        if emit_links:
            carry, lks = carry[:-1], carry[-1]
            if dagp:
                (lkh1, lkh2, lkf, lke, lkc, lkf2, lke2) = lks
            else:
                (lkh1, lkh2, lkf, lke, lkc) = lks
        if dagp:
            (h1, h2, f1, e1, psp, cv, cj, cd, c5, f2_1, e2) = carry
        else:
            (h1, h2, f1, e1, psp, cv, cj, cd, c5) = carry
        a_exgr = jnp.asarray(a_exgr, bool)
        lanes = jnp.arange(L)                             # (L,)
        dl = delta[:, None]                               # (B, 1)
        m = m0 + lanes                                    # (L,)
        n = (m0 + lw0 + 1 + t) + dl - lanes[None, :]      # (B, L) real
        r_off = t - 2 * lanes                             # r - (lw+1)
        started = (r_off >= 0)[None, :]
        in_band = (r_off < W)[None, :]
        active = (started & in_band & (n >= 1) & (n <= N[:, None])
                  & (m >= 1)[None, :] & (m <= M[:, None]))
        first = (r_off == 0)[None, :]                     # lane (re)activates

        # ---- reversed-array slices: value at (base + i) = orig[n_i - 1];
        # splice signals index the boundary position n itself (base - 1).
        # base uses lw0 (batch-shared) — the per-problem lw shift is baked
        # into the array placement (build_operands shift)
        base = pad2 + Npad - (m0 + lw0 + 1 + t)           # lane-0 index
        sl = lambda arr, o=0: jax.lax.dynamic_slice(arr, (0, base + o),
                                                    (B, L))
        b_code = sl(ops_b["rb_code"])
        isdon = sl(ops_b["rb_isdon"], -1) != 0
        isacc = sl(ops_b["rb_isacc"], -1) != 0
        sig5 = sl(ops_b["rb_sig5"], -1)
        accb = sl(ops_b["rb_accb"], -1)
        d5cls = sl(ops_b["rb_d5cls"], -1)
        joint4 = jax.lax.dynamic_slice(ops_b["rb_joint4"],
                                       (0, base - 1, 0), (B, L, ncls))

        # substitution score s(a[m-1], b[n-1]) by one-hot accumulation
        # (the per-class qprof slices are scan-invariant and hoisted)
        alpha = qprof_slab.shape[-1]
        score = jnp.zeros((B, L), jnp.int32)
        for k in range(alpha):
            score = score + jnp.where(b_code == k, qprof_slab[:, :, k], 0)

        # ---- neighbor values (lane shifts)
        negcol = jnp.full((B, 1), NEV)
        up_h = jnp.concatenate([negcol, h1[:, :-1]], axis=1)
        up_f = jnp.concatenate([negcol, f1[:, :-1]], axis=1)
        diag_h = jnp.concatenate([negcol, h2[:, :-1]], axis=1)
        # lane 0 reads the previous slab / init row boundary, stored at
        # PB + n - delta and read at the shared (shifted) cursor
        n0s = m0 + lw0 + 1 + t                            # shifted cursor
        n0 = n0s + delta                                  # (B,) real col
        bh = jax.lax.dynamic_slice(bnd_h, (0, n0s - 1 + PB), (B, 2))
        bf = jax.lax.dynamic_slice(bnd_f, (0, n0s - 1 + PB), (B, 2))
        lane0 = (lanes == 0)[None, :]
        up_h = jnp.where(lane0, jnp.where(n0 <= N + 1, bh[:, 1],
                                          NEV)[:, None], up_h)
        up_f = jnp.where(lane0, jnp.where(n0 <= N + 1, bf[:, 1],
                                          NEV)[:, None], up_f)
        diag_h = jnp.where(lane0, jnp.where(n0 - 1 <= N, bh[:, 0],
                                            NEV)[:, None], diag_h)
        if dagp:
            up_f2 = jnp.concatenate([negcol, f2_1[:, :-1]], axis=1)
            bf2 = jax.lax.dynamic_slice(bnd_f2, (0, n0s - 1 + PB),
                                        (B, 2))
            up_f2 = jnp.where(lane0, jnp.where(n0 <= N + 1, bf2[:, 1],
                                               NEV)[:, None], up_f2)
        left_h = h1
        # column-0 overrides (col_m/col_m1 precomputed per slab, shared);
        # band-edge cells (first computed diagonal r = lw + 1) read the
        # band's lw slot as LEFT — the stale column value H(-lw, 0),
        # constant across rows (dp_spliced_ref init, mirroring fwd2s1's
        # band-edge convention); the diagonal is the previous row's edge
        # cell, which the lane shift already provides
        edge = first & (n != 1)
        left_h = jnp.where(n == 1, col_m[None, :],
                           jnp.where(edge, e_const[:, None],
                                     jnp.where(first, NEV, left_h)))
        diag_h = jnp.where(n == 1, col_m1[None, :], diag_h)
        # band-right edge: vertical sources invalid
        at_top = (r_off >= W - 1)[None, :]
        up_h = jnp.where(at_top, NEV, up_h)
        up_f = jnp.where(at_top, NEV, up_f)
        e1 = jnp.where(first, NEV, e1)
        psp = jnp.where(first, 0, psp)
        cv = jnp.where(first[..., None], NEV, cv)
        cj = jnp.where(first[..., None], 0, cj)
        cd = jnp.where(first[..., None], 0, cd)
        c5 = jnp.where(first[..., None], 0, c5)
        if dagp:
            up_f2 = jnp.where(at_top, NEV, up_f2)
            e2 = jnp.where(first, NEV, e2)

        if emit_links:
            # crossing links: lane 0 sources sit ON the intermediate row
            # (m0-1), so their link is their own (column, state); the
            # column-0 / band-edge init cells descend from column 0
            zl = jnp.zeros((B, 1), jnp.int32)
            lk_up_h = jnp.concatenate([zl, lkh1[:, :-1]], axis=1)
            lk_up_f = jnp.concatenate([zl, lkf[:, :-1]], axis=1)
            lk_diag = jnp.concatenate([zl, lkh2[:, :-1]], axis=1)
            lk_up_h = jnp.where(lane0, pack_link(n0, 0)[:, None],
                                lk_up_h)
            lk_up_f = jnp.where(lane0, pack_link(n0, 2)[:, None],
                                lk_up_f)
            lk_diag = jnp.where(lane0, pack_link(n0 - 1, 0)[:, None],
                                lk_diag)
            col0 = pack_link(jnp.zeros((B, L), jnp.int32), 0)
            lk_left = jnp.where((n == 1) | edge, col0, lkh1)
            lk_diag = jnp.where(n == 1, col0, lk_diag)
            if dagp:
                lk_up_f2 = jnp.concatenate([zl, lkf2[:, :-1]], axis=1)
                lk_up_f2 = jnp.where(lane0, pack_link(n0, 4)[:, None],
                                     lk_up_f2)

        # ================= recurrence (order = fwd2s1.cc:276-431) =========
        h_val = diag_h + score                            # Diagonal
        mx_val, mx_k = h_val, jnp.zeros((B, L), jnp.int32)
        if emit_links:
            lk_mx = lk_diag
        # Vertical (F): new-gap >= extend
        xo = up_h + gop
        f_open = xo >= up_f
        f_val = jnp.where(f_open, xo, up_f) + gep
        gt = f_val > mx_val
        mx_val = jnp.where(gt, f_val, mx_val)
        mx_k = jnp.where(gt, 2, mx_k)
        if emit_links:
            lkf = jnp.where(f_open, lk_up_h, lk_up_f)
            lk_mx = jnp.where(gt, lkf, lk_mx)
        # Vertical2 (F2, long gap): strict > into the max
        f2_open = f2_val = None
        if dagp:
            xo = up_h + lgop
            f2_open = xo >= up_f2
            f2_val = jnp.where(f2_open, xo, up_f2) + lgep
            gt = f2_val > mx_val
            mx_val = jnp.where(gt, f2_val, mx_val)
            mx_k = jnp.where(gt, 4, mx_k)
            if emit_links:
                lkf2 = jnp.where(f2_open, lk_up_h, lk_up_f2)
                lk_mx = jnp.where(gt, lkf2, lk_mx)
        # Horizontal (E1); prev_psp (pre-E1) feeds the E2 psp rule
        prev_psp = psp
        xo = left_h + gop
        e_open = xo >= e1
        e_val = jnp.where(e_open, xo, e1) + gep
        psp = jnp.where(e_open, jnp.where(prev_psp != 0, 1, 0),
                        prev_psp & 1)
        ge = e_val >= mx_val
        mx_val = jnp.where(ge, e_val, mx_val)
        mx_k = jnp.where(ge, 1, mx_k)
        if emit_links:
            lke = jnp.where(e_open, lk_left, lke)
            lk_mx = jnp.where(ge, lke, lk_mx)
        # Horizontal2 (E2, long gap)
        e2_open = e2_val = None
        if dagp:
            xo = left_h + lgop
            e2_open = xo >= e2
            e2_val = jnp.where(e2_open, xo, e2) + lgep
            psp = jnp.where(e2_open,
                            jnp.where(prev_psp != 0, psp | 2, psp),
                            psp | (prev_psp & 2))
            ge = e2_val >= mx_val
            mx_val = jnp.where(ge, e2_val, mx_val)
            mx_k = jnp.where(ge, 3, mx_k)
            if emit_links:
                lke2 = jnp.where(e2_open, lk_left, lke2)
                lk_mx = jnp.where(ge, lke2, lk_mx)

        # ---- acceptor close (fwd2s1.cc:333-354)
        internal = (~a_exgr) | (m[None, :] < M[:, None])
        acc_ok = isacc & internal & active & (n < N[:, None])
        ilen = n[..., None] - cj                          # (B, L, NCAND)
        # penalty via a compare/select chain over the bucket constants
        # (ascending bases, last write wins; see _pack_ipen)
        pen = jnp.full_like(ilen, NEVSEL // 2)
        for b_, v_ in ipen_key:
            if b_ > Npad:
                break
            pen = jnp.where(ilen >= b_, v_, pen)
        j16 = jnp.zeros((B, L, NCAND), jnp.int32)
        for c in range(ncls):
            j16 = j16 + jnp.where(c5 == c, joint4[..., c][..., None], 0)
        xc = cv + pen + accb[..., None] + j16
        if cip:
            # conserved intron-position bonus (-yJ): Cip_score(m) added
            # at every acceptor close (fwd2s1.cc:254, 338)
            xc = xc + cip_slab[..., None]
        cand_ok = (acc_ok[..., None] & (ilen >= llmt) & (cv > NEV // 2))
        xc = jnp.where(cand_ok, xc, NEV)
        state_vals = [h_val, e_val, f_val, e2_val, f2_val][:n_states]
        if emit_links:
            lk_states = [lk_diag, lke, lkf, lke2 if dagp else None,
                         lkf2 if dagp else None][:n_states]
        spj = []
        for k in range(n_states):
            cur = state_vals[k]
            jnc_k = jnp.zeros((B, L), jnp.int32)
            for l in range(NCAND):                        # best-first order
                take = ((cd[..., l] == k) & (xc[..., l] >= cur)
                        & cand_ok[..., l])
                cur = jnp.where(take, xc[..., l], cur)
                jnc_k = jnp.where(take, cj[..., l] + 1, jnc_k)
                if emit_links:
                    lk_states[k] = jnp.where(take, lkc[..., l],
                                             lk_states[k])
            state_vals[k] = cur
            spj.append(jnc_k)
            closed = jnc_k > 0
            psp = jnp.where(closed, psp | PSP_BIT[k], psp)
            ge = closed & (cur >= mx_val)
            mx_val = jnp.where(ge, cur, mx_val)
            mx_k = jnp.where(ge, k, mx_k)
            if emit_links:
                lk_mx = jnp.where(ge, lk_states[k], lk_mx)

        # ---- winner into H
        h_out = mx_val
        hdir = mx_k
        loc_reset = None
        if local:
            # SWG zero floor (LocalL reset, fwd2b1.cc:163 forwardB_ng /
            # fwd2s1.cc:356-378): non-positive cells restart a local
            # alignment; traceback stops at the reset flag
            loc_reset = active & (h_out <= 0)
            h_out = jnp.where(loc_reset, 0, h_out)

        # ---- donor push (fwd2s1.cc:380-406)
        don_ok = isdon & internal & active & (n < N[:, None])
        GOPk = (0, gop, lgop)                             # GOP[k//2]
        for k in range(n_states):
            fv = state_vals[k]
            # k = 0 only pushed when diag won
            elig = don_ok & ((mx_k == 0) if k == 0 else True)
            elig &= (psp & PSP_BIT[k]) == 0
            z = mx_val + jnp.where((mx_k == 0) | (((k - mx_k) % 2) != 0),
                                   GOPk[k // 2], 0)
            prune = (k != mx_k) & (fv <= z)
            elig &= ~prune
            x = fv + sig5
            kdir = jnp.full((B, L), k, jnp.int32)
            if emit_links:
                cv, cj, cd, c5, lkc = _insert_candidate(
                    cv, x, elig, (cj, n), (cd, kdir), (c5, d5cls),
                    (lkc, lk_states[k]))
            else:
                cv, cj, cd, c5 = _insert_candidate(
                    cv, x, elig, (cj, n), (cd, kdir), (c5, d5cls))

        # ---- masked commit
        h_out = jnp.where(active, h_out, NEV)
        f_out = jnp.where(active, state_vals[2], NEV)
        e1 = jnp.where(active, state_vals[1], e1)

        if dagp:
            f2_out = jnp.where(active, state_vals[4], NEV)
            e2 = jnp.where(active, state_vals[3], e2)
            carry = (h_out, h1, f_out, e1, psp, cv, cj, cd, c5,
                     f2_out, e2)
        else:
            carry = (h_out, h1, f_out, e1, psp, cv, cj, cd, c5)
        # ---- emissions (written back as contiguous windows post-scan):
        # boundary at the last lane, final-row / right-column cells
        row_v = jnp.sum(jnp.where(lanes[None, :] == li[:, None],
                                  h_out, 0), axis=1)
        rcl = n0 - N                                      # lane with n == N
        rc_v = jnp.sum(jnp.where(lanes[None, :] == rcl[:, None],
                                 h_out, 0), axis=1)
        bf2_v = (carry[9][:, L - 1] if dagp
                 else jnp.zeros(B, jnp.int32) + NEV)
        ys = (h_out[:, L - 1], f_out[:, L - 1], row_v, rc_v, bf2_v)
        if local:
            # best local cell this step (per problem): value + lane; the
            # host colony pass reconstructs (m, n) from (t, lane)
            loc_v = jnp.max(h_out, axis=1)
            loc_i = jnp.argmax(h_out, axis=1).astype(jnp.int32)
            loc_ys = (loc_v, loc_i)
        if emit_links:
            lkh_c = jnp.where(active, lk_mx, 0)
            lkf_c = lk_states[2]
            lke_c = lk_states[1]
            if dagp:
                lks_new = (lkh_c, lkh1, lkf_c, lke_c, lkc,
                           lk_states[4], lk_states[3])
            else:
                lks_new = (lkh_c, lkh1, lkf_c, lke_c, lkc)
            carry = carry + (lks_new,)
            rowlk = jnp.sum(jnp.where(lanes[None, :] == li[:, None],
                                      lkh_c, 0), axis=1)
            rclk = jnp.sum(jnp.where(lanes[None, :] == rcl[:, None],
                                     lkh_c, 0), axis=1)
            bf2lk = (lk_states[4][:, L - 1] if dagp
                     else jnp.zeros(B, jnp.int32))
            ys = ys + (lkh_c[:, L - 1], lkf_c[:, L - 1], rowlk, rclk,
                       bf2lk)
            return carry, ys
        if not emit_trace:
            if local:
                ys = ys + loc_ys
            return carry, ys
        # flag layout: bits 0-2 winner state, 3 eopen, 4 fopen,
        # 5 e2open, 6 f2open (7 = local reset); 255 = inactive cell
        flags8 = (hdir.astype(jnp.uint8)
                  | (e_open.astype(jnp.uint8) << 3)
                  | (f_open.astype(jnp.uint8) << 4))
        if dagp:
            flags8 = (flags8 | (e2_open.astype(jnp.uint8) << 5)
                      | (f2_open.astype(jnp.uint8) << 6))
        if local:
            flags8 = flags8 | (loc_reset.astype(jnp.uint8) << 7)
        flags8 = jnp.where(active, flags8, jnp.uint8(255))
        spj_out = jnp.stack(spj, axis=-1).astype(jnp.int32)
        out = ys + (flags8, spj_out)
        if local:
            out = out + loc_ys
        return carry, out

    return step


def _win_update(dst, vals, mask, start, PB):
    """Masked window write-back at a batch-shared cursor: dst[:, start +
    PB + t] <- vals[:, t] where mask.  _pads sizes the arrays so the
    window is always in bounds; per-problem placement is applied by the
    host readers (collect), keeping every device index batch-invariant
    (a batch-varying update start would lower to a scatter)."""
    B, T = vals.shape
    s = jnp.clip(start + PB, 0, dst.shape[1] - T)
    old = jax.lax.dynamic_slice(dst, (0, s), (B, T))
    return jax.lax.dynamic_update_slice(dst, jnp.where(mask, vals, old),
                                        (0, s))


# lax.scan unroll of the slab wavefront, chosen here and nowhere else.
# Four steps per loop iteration run the bench cell 1.68x faster on the
# H100 (PERF.md); XLA's CPU compiler takes many minutes over the
# unrolled body, so every other platform keeps one.  Unrolling does not
# change a single value the scan computes.
SCAN_UNROLL = {"gpu": 4}


def scan_unroll() -> int:
    return SCAN_UNROLL.get(jax.default_backend(), 1)


@functools.lru_cache(maxsize=128)
def _scan_slab(B, L, W, gop, gep, llmt, T, pad2, Npad, Mpad, ncls,
               ipen_key, lgop=0, lgep=0, dagp=False,
               emit_trace=True, emit_links=False,
               local=False, cip=False):
    """Compile one slab runner per static geometry (cached).  Band
    placement (lw0 + per-problem deltas) and true lengths (M, N) are
    traced arguments, so only the padded geometry (B, L, W/T, Npad,
    Mpad) and the penalty-table constant force a new compilation."""
    PBn, _, PBm, _ = _pads(L, T, Npad, Mpad)
    step = _make_step(L, W, gop, gep, llmt, pad2, Npad, Mpad, PBn, ncls,
                      ipen_key, lgop=lgop, lgep=lgep, dagp=dagp,
                      emit_trace=emit_trace, emit_links=emit_links,
                      local=local, cip=cip)

    def run1(qprof_slab, ops_b, ops_s, bnd_h, bnd_f, bnd_f2, row_h,
             rc_h, m0, lw0, delta, M, N, a_exgr, *extra):
        B = qprof_slab.shape[0]
        lw = lw0 + delta                  # (B,) real band placement
        col_m = jax.lax.dynamic_slice_in_dim(
            ops_s["colinit"], jnp.clip(m0, 0, Mpad), L)
        col_m1 = jax.lax.dynamic_slice_in_dim(
            ops_s["colinit"], jnp.clip(m0 - 1, 0, Mpad), L)
        e_const = jnp.where(
            lw >= -M,
            jnp.take(ops_s["colinit"],
                     jnp.clip(-lw, 0, Mpad + L + 1)), NEV)
        li = jnp.clip(M - m0, 0, L - 1)   # (B,) lane of final row
        f = functools.partial(step, B=B, qprof_slab=qprof_slab,
                              ops_b=ops_b, ops_s=ops_s, bnd_h=bnd_h,
                              bnd_f=bnd_f, bnd_f2=bnd_f2, col_m=col_m,
                              col_m1=col_m1,
                              e_const=e_const, li=li, m0=m0, lw0=lw0,
                              delta=delta, M=M, N=N, a_exgr=a_exgr,
                              cip_slab=extra[0] if cip else None)
        carry0 = (
            jnp.full((B, L), NEV), jnp.full((B, L), NEV),
            jnp.full((B, L), NEV), jnp.full((B, L), NEV),
            jnp.zeros((B, L), jnp.int32),
            jnp.full((B, L, NCAND), NEV),
            jnp.zeros((B, L, NCAND), jnp.int32),
            jnp.zeros((B, L, NCAND), jnp.int32),
            jnp.zeros((B, L, NCAND), jnp.int32))
        if dagp:
            carry0 = carry0 + (jnp.full((B, L), NEV),
                               jnp.full((B, L), NEV))
        if emit_links:
            z2 = jnp.zeros((B, L), jnp.int32)
            zc = jnp.zeros((B, L, NCAND), jnp.int32)
            lks0 = (z2, z2, z2, z2, zc) + ((z2, z2) if dagp else ())
            carry0 = carry0 + (lks0,)
        carry, ys = jax.lax.scan(f, carry0, jnp.arange(T),
                                unroll=scan_unroll())
        bh_v, bf_v, row_v, rc_v, bf2_v = [y.T for y in ys[:5]]  # (B, T)
        ts = jnp.arange(T)[None, :]
        dl = delta[:, None]
        # write-back cursors are lw0-based (batch-shared); masks use the
        # real per-problem coordinates; host readers apply the offsets
        # (storage conventions in _pads)
        # last-lane boundary: column nl(t) = m0 + lw + 2 - L + t
        m_last = m0 + L - 1
        cb0 = m0 + lw0 + 2 - L
        nl = cb0 + dl + ts
        wl = (((ts - 2 * (L - 1) >= 0) & (ts - 2 * (L - 1) < W))
              & (nl >= 1) & (nl <= N[:, None])
              & (m_last >= 1) & (m_last <= M[:, None]))
        bnd_h = _win_update(bnd_h, bh_v, wl, cb0, PBn)
        bnd_f = _win_update(bnd_f, bf_v, wl, cb0, PBn)
        if dagp:
            bnd_f2 = _win_update(bnd_f2, bf2_v, wl, cb0, PBn)
        # final-row cells: lane li, column nr(t) = m0 + lw + 1 - li + t
        li = jnp.clip(M - m0, 0, L - 1)[:, None]
        in_slab = ((M - m0 >= 0) & (M - m0 < L))[:, None]
        cr0 = m0 + lw0 + 1 - L
        nr = cr0 + dl + (L - li) + ts
        wr = (in_slab & (ts - 2 * li >= 0) & (ts - 2 * li < W)
              & (nr >= 1) & (nr <= N[:, None]))
        row_h = _win_update(row_h, row_v, wr, cr0, PBn)
        # right-column cells: lane rcl(t) = n0 - N, row mc(t) = cc + t
        cc0 = 2 * m0 + lw0 + 1 - Npad
        mc = cc0 + dl + (Npad - N[:, None]) + ts
        rcl = m0 + lw0 + 1 + dl + ts - N[:, None]
        wc = ((rcl >= 0) & (rcl < L) & (ts - 2 * rcl >= 0)
              & (ts - 2 * rcl < W) & (mc >= 1) & (mc <= M[:, None]))
        rc_h = _win_update(rc_h, rc_v, wc, cc0, PBm)
        if emit_links:
            # link streams transposed to (B, T); host backwalk indexes
            # them by the same cursor math as the window write-backs
            return ((bnd_h, bnd_f, bnd_f2, row_h, rc_h),
                    tuple(y.T for y in ys[5:]))
        return (bnd_h, bnd_f, bnd_f2, row_h, rc_h), ys[5:]

    return jax.jit(run1)


def snap_pos(bp: "BatchProblem", s: int) -> int:
    """Storage position of slab s's entry-boundary read window: lane-0
    reads in slab s hit positions [PB + m0 + lw, PB + m0 + lw + T]."""
    return bp.PB + (s * bp.L + 1) + bp.lw


def _row_pos(PB, L, n, delta, li):
    """Host-side storage position of the final-row cell for column n
    (see _pads conventions)."""
    return PB + n - delta + li - L


def _rc_pos(PBm, Npad, m, delta, N):
    """Host-side storage position of the right-column cell for row m."""
    return PBm + m - delta - (Npad - N)


def forward_spliced_scan(a: np.ndarray, b: np.ndarray, prm: DpParams,
                         sig: SpliceSignals | None = None,
                         lw: int | None = None, up: int | None = None,
                         flags: DpFlags | None = None, L: int = 128):
    """Run the wavefront engine for one problem (a batch of one).
    Returns (score, end_m, end_n, SliceTrace) with host traceback
    planes."""
    flags = flags or DpFlags()
    M, N = len(a), len(b)
    if lw is None:
        lw, up = -M, N
    bp = prepare_spliced_batch([np.asarray(a)], [np.asarray(b)], prm,
                               sigs=[sig] if sig is not None else None,
                               lws=[lw], W=up - lw + 1, flags=flags, L=L)
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=False)
    scores, ends, btr = collect_batch_results(bp, row_h, rc_h, traces,
                                              False, prm=prm)
    return int(scores[0]), int(ends[0][0]), int(ends[0][1]), btr[0]


@dataclass
class BatchProblem:
    """Device-resident batched operands (host prep separated from the DP
    execute so benchmarks measure pure device throughput).  ops holds the
    per-problem (batched) operands; ops_s the batch-shared tables; the
    penalty enters the kernel as a compile-time constant (ipen_key).
    Band placements are pre-baked into the operand layout as deltas =
    lws - lw (see build_operands shift)."""
    ops: dict
    ops_s: dict
    ipen_key: tuple
    qprof_all: object          # jnp (B, Mpad, alpha)
    bnd_h0: object
    bnd_f0: object
    bnd_f20: object            # F2 slab boundary (double affine)
    Ms: list
    Ns: list
    lws: list
    deltas: list
    Ms_j: object
    Ns_j: object
    deltas_j: object
    B: int
    L: int
    W: int
    lw: int
    up: int
    Mpad: int
    Nmax: int
    T: int
    pad2: int
    PB: int
    ncls: int
    n_slabs: int
    flags: DpFlags
    cip_all: object = None     # jnp (B, Mpad) -yJ bonus per query row


def prepare_spliced_batch(queries: list, genomes: list, prm: DpParams,
                          sigs: list | None = None,
                          lw: int = None, up: int = None,
                          flags: DpFlags | None = None,
                          L: int = 128,
                          lws: list | None = None,
                          W: int | None = None,
                          cips: list | None = None) -> BatchProblem:
    """Host stage: pad B problems to a common geometry and ship operands.

    Either one (lw, up) band for the whole batch, or per-problem band
    placements ``lws`` with a common width ``W``."""
    flags = flags or DpFlags()
    B = len(queries)
    Ms = [len(q) for q in queries]
    Ns = [len(g) for g in genomes]
    Mmax, Nmax = max(Ms), max(Ns)
    if lws is None:
        if lw is None:
            lw, up = -Mmax, Nmax
        W = up - lw + 1
        lws = [lw] * B
    else:
        assert W is not None
        lw, up = min(lws), max(lws) + W - 1
    deltas = [l - lw for l in lws]      # per-problem band shift >= 0
    dmax = max(deltas)
    dpad = (_geom_bucket(-(-dmax // 256)) * 256 if dmax
            else 0)                       # geometric bucket
    # geometric geometry buckets: every distinct traced shape is a fresh
    # XLA compile and a mapping run sweeps a wide spread of window
    # lengths / query lengths — linear 256-step buckets produce dozens
    # of compiles, which dominate a cold run (PERF.md)
    n_slabs = _geom_bucket((Mmax + L - 1) // L)
    Mpad = n_slabs * L
    Nmax = _geom_bucket(-(-Nmax // 256)) * 256
    pad_extra = 2 * (L + W + 4 + dpad)
    T = W + 2 * (L - 1)
    PB, TOTn, PBm, TOTm = _pads(L, T, Nmax, Mpad)

    keys = ("rb_code", "rb_isdon", "rb_isacc", "rb_sig5", "rb_accb",
            "rb_d5cls", "rb_joint4")
    stacked = {k: [] for k in keys}
    qprofs = []
    ncls = 4
    colinit = None
    any_sig = sigs is not None and any(s is not None for s in sigs)
    for i in range(B):
        sig = sigs[i] if sigs is not None else None
        od = build_operands(np.asarray(queries[i]), np.asarray(genomes[i]),
                            prm, sig, Mpad, Nmax, flags, pad_extra, L=L,
                            shift=deltas[i])
        ncls = od.ncls
        for k in keys:
            stacked[k].append(getattr(od, k))
        qprofs.append(od.qprof)
        colinit = od.colinit            # prm/flags-derived: batch-shared
    ops = {k: jnp.asarray(np.stack(v)) for k, v in stacked.items()}
    qprof_all = jnp.asarray(np.stack(qprofs))          # (B, Mpad, 17)
    # intron penalty table is batch-shared (one prm per batch); a no-sig
    # problem never pushes donor candidates, so the table is inert there
    ipen = (prm.intron_table(Nmax + 1) if any_sig
            else np.full(Nmax + 1, NEVSEL // 2, dtype=np.int32))
    ipen_key = _pack_ipen(ipen)
    ops_s = {"colinit": jnp.asarray(colinit)}

    bnd_h = np.full((B, TOTn), NEVSEL, dtype=np.int32)
    for i in range(B):
        o = PB - deltas[i]              # storage: PB + n - delta
        if flags.a_exgl:
            bnd_h[i, o:o + Ns[i] + 1] = 0
        else:
            ns = np.arange(Ns[i] + 1)
            bnd_h[i, o:o + Ns[i] + 1] = (prm.gop
                                         + prm.gep * ns).astype(np.int32)
            bnd_h[i, o] = 0
    bnd_f = np.full((B, TOTn), NEVSEL, dtype=np.int32)
    cip_all = None
    if cips is not None and any(c is not None and len(c) for c in cips):
        # -yJ: per-query-row conserved-intron-position bonus; cips[i]
        # maps query position m (1-based) -> bonus (Cip_score, gsinfo.h)
        ca = np.zeros((B, Mpad + L), dtype=np.int32)
        for i, c in enumerate(cips):
            if not c:
                continue
            for mpos, bonus in (c.items() if hasattr(c, "items")
                                else enumerate(c)):
                if 1 <= mpos <= Mpad:
                    ca[i, mpos - 1] = bonus
        cip_all = jnp.asarray(ca)
    return BatchProblem(ops=ops, ops_s=ops_s, ipen_key=ipen_key,
                        qprof_all=qprof_all,
                        bnd_h0=jnp.asarray(bnd_h), bnd_f0=jnp.asarray(bnd_f),
                        bnd_f20=jnp.asarray(bnd_f),
                        Ms=Ms, Ns=Ns, lws=lws, deltas=deltas,
                        Ms_j=jnp.asarray(Ms), Ns_j=jnp.asarray(Ns),
                        deltas_j=jnp.asarray(deltas),
                        B=B, L=L, W=W, lw=lw, up=up,
                        Mpad=Mpad, Nmax=Nmax, T=T, pad2=pad_extra // 2,
                        PB=PB, ncls=ncls, n_slabs=n_slabs, flags=flags,
                        cip_all=cip_all)


def run_spliced_batch(bp: BatchProblem, prm: DpParams,
                      score_only: bool = True, block: bool = True,
                      emit_links: bool = False):
    """Device stage: run all slabs; returns (row_h, rc_h, traces_raw).

    emit_links = the Hirschberg forward: score-only values plus, per
    slab, ((5 link streams: boundary-H, boundary-F, final-row,
    right-column, boundary-F2), (entry-boundary snapshots of
    bnd_h/f/f2 over the slab's read window)) — everything the UDH
    backwalk + strip retrace (dp_spliced_udh) needs, O(T) ints per slab
    instead of O(T*L) planes."""
    B, L = bp.B, bp.L
    _, TOTn, _, TOTm = _pads(L, bp.T, bp.Nmax, bp.Mpad)
    local = bool(bp.flags.local)
    cip = bp.cip_all is not None
    scan = _scan_slab(B, L, bp.W, prm.gop, prm.gep,
                      prm.intron_llmt, bp.T, bp.pad2, bp.Nmax, bp.Mpad,
                      bp.ncls, bp.ipen_key,
                      lgop=prm.lgop, lgep=prm.lgep, dagp=prm.dagp,
                      emit_trace=not score_only and not emit_links,
                      emit_links=emit_links, local=local, cip=cip)
    bnd_h, bnd_f, bnd_f2 = bp.bnd_h0, bp.bnd_f0, bp.bnd_f20
    row_h = jnp.full((B, TOTn), NEV)
    rc_h = jnp.full((B, TOTm), NEV)
    traces = []
    lw0 = jnp.asarray(bp.lw)            # batch-shared band base (traced)
    for s in range(bp.n_slabs):
        m0 = s * L + 1
        if emit_links:
            # entry-boundary snapshot over this slab's read window
            # [PB + m0 + lw, + T + 2) — lets the UDH retrace re-run this
            # slab alone with full planes (dp_spliced_udh)
            p0 = snap_pos(bp, s)
            snap = tuple(x[:, p0:p0 + bp.T + 2]
                         for x in (bnd_h, bnd_f, bnd_f2))
        qprof_slab = jax.lax.dynamic_slice_in_dim(bp.qprof_all, m0 - 1, L,
                                                  axis=1)
        extra = ()
        if cip:
            extra = (jax.lax.dynamic_slice_in_dim(bp.cip_all, m0 - 1, L,
                                                  axis=1),)
        (bnd_h, bnd_f, bnd_f2, row_h, rc_h), ys = scan(
            qprof_slab, bp.ops, bp.ops_s, bnd_h, bnd_f, bnd_f2, row_h,
            rc_h, m0, lw0, bp.deltas_j, bp.Ms_j, bp.Ns_j,
            bp.flags.a_exgr, *extra)
        if emit_links:
            traces.append((ys, snap))
        elif not score_only or local:
            traces.append(ys)
    if block:
        jax.block_until_ready(row_h)
    return row_h, rc_h, traces


def collect_batch_results(bp: BatchProblem, row_h, rc_h, traces,
                          score_only: bool, prm: DpParams | None = None):
    """Host stage: final score/end extraction (lastS_ng semantics).

    Applies the per-problem storage offsets the device deliberately
    defers (see _pads conventions)."""
    PB, _, PBm, _ = _pads(bp.L, bp.T, bp.Nmax, bp.Mpad)
    prm_gop = prm.gop if prm is not None else 0
    prm_gep = prm.gep if prm is not None else 0
    row_full = np.asarray(row_h)
    rc_full = np.asarray(rc_h)
    flags = bp.flags
    scores = np.empty(bp.B, dtype=np.int64)
    ends = np.empty((bp.B, 2), dtype=np.int64)
    for i in range(bp.B):
        M, N = bp.Ms[i], bp.Ns[i]
        lw, up = bp.lws[i], bp.lws[i] + bp.W - 1
        d = bp.deltas[i]
        li = (M - 1) % bp.L             # lane of row M in its slab
        ro = _row_pos(PB, bp.L, 0, d, li)       # row_h base offset
        co = _rc_pos(PBm, bp.Nmax, 0, d, N)     # rc_h base offset
        row_np_i = row_full[i, ro:ro + bp.Nmax + 2]
        rc_np_i = rc_full[i, co:co + bp.Mpad + 2]
        bv, bm, bn = int(row_np_i[N]), M, N

        def _col(mm):
            return 0 if flags.b_exgl else prm_gop + prm_gep * mm
        if flags.a_exgr:
            n_first = max(M + lw, 0)
            # stale band-edge / column-0 corner candidates come first in
            # the oracle's strict-> scan order
            if lw >= -M:
                v = _col(-lw)
                if v > bv:
                    bv, bm, bn = v, M, n_first
            elif n_first == 0:
                v = _col(M)
                if v > bv:
                    bv, bm, bn = v, M, 0
            n_lo = max(n_first, 1)
            seg = row_np_i[n_lo:N]
            if len(seg) and seg.max() > bv:
                k = int(np.argmax(seg))
                bv, bm, bn = int(seg[k]), M, n_lo + k
        if flags.b_exgr:
            if max(N - up, 0) == 0:
                v = 0 if flags.a_exgl else prm_gop + prm_gep * N
                if v > bv:
                    bv, bm, bn = v, 0, N
            m_lo = max(N - up, 1)
            seg = rc_np_i[m_lo:M]
            if len(seg) and seg.max() > bv:
                k = int(np.argmax(seg))
                bv, bm, bn = int(seg[k]), m_lo + k, N
        scores[i] = bv
        ends[i] = (bm, bn)
    if score_only:
        return scores, ends, None
    # one transfer per plane (hoisted out of the per-problem loop)
    fl_np = [np.asarray(ys[0]) for ys in traces]
    sp_np = [np.asarray(ys[1]) for ys in traces]
    btraces = []
    for i in range(bp.B):
        btraces.append(SliceTrace(flags=[f[:, i] for f in fl_np],
                                  spj=[s[:, i] for s in sp_np],
                                  L=bp.L, lw=bp.lws[i], W=bp.W))
    return scores, ends, btraces


def collect_local_ends(bp: BatchProblem, traces, vthr: int,
                       max_out: int = 16) -> list:
    """SWG colony extraction (fwdswgB_ng / Colonies, fwd2b1.cc:734,
    aln.h:167-228, redesigned): the local forward emits each step's best
    (value, lane) per problem; colonies are the locally-maximal ends
    above vthr, greedily accepted best-first with band-overlap pruning
    (Colonies::detectoverlap role).  Returns per problem a list of
    (val, m, n) candidate local-alignment ends, best first.

    traces: trace-mode ys tuples whose tail carries (loc_v, loc_i)."""
    out = []
    for i in range(bp.B):
        cands = []
        for s, ys in enumerate(traces):
            m0 = s * bp.L + 1
            lv = np.asarray(ys[-2])[:, i]           # (T,)
            li_ = np.asarray(ys[-1])[:, i]
            ts = np.nonzero(lv >= vthr)[0]
            for t in ts:
                lane = int(li_[t])
                m = m0 + lane
                n = (m0 + bp.lw + 1 + int(t)) + bp.deltas[i] - lane
                if 1 <= m <= bp.Ms[i] and 1 <= n <= bp.Ns[i]:
                    cands.append((int(lv[t]), m, n))
        cands.sort(key=lambda c: -c[0])
        out.append(cands)
    return out


def pick_colonies(cands: list, trace_fn, max_out: int = 16,
                  gep: int = -20, vthr: int = 350) -> list:
    """Greedy colony selection (Colonies::detectoverlap role): take the
    best remaining end, trace it with trace_fn(m, n) -> (m0, n0, ops)
    (or None).  A candidate whose trace STARTS inside an accepted
    colony's footprint is a decaying ridge tail of that colony (its
    path re-enters the island) and is suppressed — exact, unlike any
    end-window heuristic.  Cheap in-box ends are pre-skipped without
    tracing."""
    picked = []
    remaining = list(cands)
    while remaining and len(picked) < max_out:
        v, m, n = remaining.pop(0)
        if any(pm0 - 1 <= m <= pm and pn0 - 1 <= n <= pn
               for _, pm, pn, (pm0, pn0, *_x) in picked):
            continue                        # inside a colony: skip
        traced = trace_fn(m, n)
        if traced is None:
            continue
        m0, n0 = traced[0], traced[1]
        if any(pm0 - 1 <= m0 <= pm and pn0 - 1 <= n0 <= pn
               for _, pm, pn, (pm0, pn0, *_x) in picked):
            continue                        # ridge tail of a colony
        picked.append((v, m, n, traced))
    return picked


def forward_spliced_batch(queries: list, genomes: list, prm: DpParams,
                          sigs: list | None = None,
                          lw: int = None, up: int = None,
                          flags: DpFlags | None = None, L: int = 128,
                          score_only: bool = True):
    """Batched wavefront engine: B problems padded to common geometry —
    the throughput path for genome mapping (replaces the reference's
    ThQueue worker pool, spaln.cc:1220-1468)."""
    bp = prepare_spliced_batch(queries, genomes, prm, sigs=sigs, lw=lw,
                               up=up, flags=flags, L=L)
    row_h, rc_h, traces = run_spliced_batch(bp, prm, score_only=score_only)
    return collect_batch_results(bp, row_h, rc_h, traces, score_only,
                                 prm=prm)


@dataclass
class SliceTrace:
    """Traceback planes per slab: flags (T, L) uint8, spj (T, L, 3)."""
    flags: list
    spj: list
    L: int
    lw: int
    W: int

    def cell(self, m: int, n: int):
        s = (m - 1) // self.L
        i = (m - 1) % self.L
        m0 = s * self.L + 1
        t = (n - m) - self.lw - 1 + 2 * i
        return s, t, i

    def hdir(self, m, n):
        s, t, i = self.cell(m, n)
        return int(self.flags[s][t, i]) & 7

    def gopen(self, state, m, n):
        """Did gap state (1=E1, 2=F, 3=E2, 4=F2) open at this cell?"""
        s, t, i = self.cell(m, n)
        bit = (0, 8, 16, 32, 64)[state]
        return bool(self.flags[s][t, i] & bit)

    def eopen(self, m, n):
        return self.gopen(1, m, n)

    def fopen(self, m, n):
        return self.gopen(2, m, n)

    def spj_at(self, k, m, n):
        s, t, i = self.cell(m, n)
        return int(self.spj[s][t, i, k])

    @property
    def n_spj(self):
        # strip retraces hold planes for one slab only (others None)
        return next(x for x in self.spj if x is not None).shape[-1]


def traceback_spliced_scan(tr: SliceTrace, end_m: int, end_n: int,
                           guard: int = 10_000_000):
    """Same op stream as traceback_spliced_ref, from wavefront planes."""
    return traceback_spliced_strip(tr, end_m, end_n)[0]


@functools.lru_cache(maxsize=64)
def _tb_walker(S, T, B, L, NSPJ, IT):
    """Device-side traceback: walk all B problems' paths through the
    stacked trace planes in one jitted scan (the Vmf::traceback role,
    vmf.h:26-59, but in device memory).  The planes never leave the
    device; the walker returns only (IT, B, 4) op records."""

    def walk(FL, SPJ, m0v, n0v, lwv):
        barr = jnp.arange(B)
        bits = jnp.asarray([0, 8, 16, 32, 64], jnp.int32)

        def step(carry, _):
            m, n, st, done = carry
            s = (m - 1) // L
            i = (m - 1) % L
            t = (n - m) - lwv - 1 + 2 * i
            ok = ((~done) & (m >= 1) & (n >= 1) & (t >= 0) & (t < T)
                  & (s >= 0) & (s < S))
            sc = jnp.clip(s, 0, S - 1)
            tc = jnp.clip(t, 0, T - 1)
            ic = jnp.clip(i, 0, L - 1)
            flat = ((sc * T + tc) * B + barr) * L + ic
            fl = jnp.where(ok, jnp.take(FL, flat), 255)
            stc = jnp.clip(st, 0, NSPJ - 1)
            # SPJ is stacked STATE-MAJOR (S, NSPJ, T, B, L)
            spj_at = ((((sc * NSPJ + stc) * T + tc) * B + barr) * L
                      + ic)
            spj_0 = (((sc * NSPJ * T + tc) * B + barr) * L + ic)
            jnc_s = jnp.where(ok, jnp.take(SPJ, spj_at), 0)
            jnc_0 = jnp.where(ok, jnp.take(SPJ, spj_0), 0)
            hd = fl & 7
            is0 = st == 0
            # state-0 stops: inactive cell / SWG local restart origin
            dead = is0 & ((fl == 255) | ((fl & 0x80) != 0) | (hd > 4))
            i_close0 = is0 & ~dead & (hd == 0) & (jnc_0 > 0)
            diag = is0 & ~dead & (hd == 0) & (jnc_0 == 0)
            trans = is0 & ~dead & (hd > 0) & (hd <= 4)
            gsel = ~is0
            i_close_g = gsel & (jnc_s > 0)
            horiz = gsel & (jnc_s == 0) & ((st == 1) | (st == 3))
            vert = gsel & (jnc_s == 0) & ((st == 2) | (st == 4))
            opened = (fl & jnp.take(bits, jnp.clip(st, 0, 4))) != 0
            i_close = i_close0 | i_close_g
            jncv = jnp.where(is0, jnc_0, jnc_s)
            kind = jnp.where(~ok | dead | trans, 0,
                             jnp.where(i_close, 4,
                                       jnp.where(diag, 1,
                                                 jnp.where(horiz, 2,
                                                           3))))
            rec = (kind, m, n, jncv - 1)
            n2 = jnp.where(i_close, jncv - 1,
                           jnp.where(diag | horiz, n - 1, n))
            m2 = jnp.where(diag | vert, m - 1, m)
            st2 = jnp.where(trans, hd,
                            jnp.where((horiz | vert) & opened, 0, st))
            done2 = done | dead | (~ok) | (m2 < 1) | (n2 < 1)
            return (m2, n2, st2, done2), rec

        carry0 = (m0v, n0v, jnp.zeros(B, jnp.int32),
                  (m0v < 1) | (n0v < 1))
        _, recs = jax.lax.scan(step, carry0, None, length=IT)
        return recs

    raw = walk
    walk = jax.jit(walk)
    walk.raw = raw
    return walk


def traceback_device_batch(bp: BatchProblem, traces, ends) -> list:
    """Walk every problem's traceback on device from its (end_m, end_n)
    and return per-problem ascending op streams (the contract of
    traceback_spliced_scan).  ``traces``[s] = (fl (T,B,L), spj
    (T,B,L,NSPJ)) device arrays from either engine's trace mode."""
    S = len(traces)
    NSPJ = traces[0][1].shape[-1]
    FL = jnp.reshape(jnp.stack([jnp.asarray(t[0], jnp.int32)
                                for t in traces]), (-1,))
    # restack state-major (see _tb_walker layout note)
    SPJ = jnp.reshape(jnp.stack(
        [jnp.moveaxis(jnp.asarray(t[1], jnp.int32), -1, 0)
         for t in traces]), (-1,))
    IT = 2 * (bp.Mpad + bp.W) + 64
    walk = _tb_walker(S, bp.T, bp.B, bp.L, NSPJ, IT)
    m0v = jnp.asarray([int(e[0]) for e in ends], jnp.int32)
    n0v = jnp.asarray([int(e[1]) for e in ends], jnp.int32)
    recs = walk(FL, SPJ, m0v, n0v, jnp.asarray(bp.lws, jnp.int32))
    k_np, m_np, n_np, x_np = (np.asarray(r) for r in recs)
    out = []
    for b in range(bp.B):
        sel = np.flatnonzero(k_np[:, b])
        ops = []
        for j in sel:
            k = k_np[j, b]
            if k == 4:
                ops.append(('I', int(m_np[j, b]), int(x_np[j, b]),
                            int(n_np[j, b])))
            else:
                ops.append((('D', 'E', 'F')[k - 1], int(m_np[j, b]),
                            int(n_np[j, b])))
        ops.reverse()
        out.append(ops)
    return out


def traceback_spliced_strip(tr: SliceTrace, m: int, n: int,
                            state: int = 0, m_stop: int = 0,
                            guard: int = 10_000_000):
    """Walk traceback planes from (m, n, state) down to row ``m_stop``
    (exclusive) — the strip unit of the multi-intermediate Hirschberg
    postwork (mimd_postwork, fwd2s1.cc:1714-1756; strips here are slab
    bands, m_stop a slab boundary).  Returns (ops ascending, m, n,
    state); the exit state at an intermediate row is always 0/2/4
    (H/F/F2) — only vertical moves cross row boundaries."""
    ops = []
    steps = 0
    while steps < guard and m > m_stop and n >= 1:
        steps += 1
        if state == 0:
            hd = tr.hdir(m, n)
            fl = tr.flags[tr.cell(m, n)[0]][tr.cell(m, n)[1],
                                            tr.cell(m, n)[2]]
            if fl == 255:
                break
            if fl & 0x80:                 # SWG local-restart origin
                break
            if hd == 0:
                jnc = tr.spj_at(0, m, n)
                if jnc:
                    ops.append(('I', m, jnc - 1, n))
                    n = jnc - 1
                    continue
                ops.append(('D', m, n))
                m, n = m - 1, n - 1
                continue
            if hd > 4:
                break
            state = hd
            continue
        jnc = tr.spj_at(state, m, n) if state < tr.n_spj else 0
        if jnc:
            ops.append(('I', m, jnc - 1, n))
            n = jnc - 1
            continue
        opened = tr.gopen(state, m, n)
        if state in (1, 3):               # horizontal: consume b[n-1]
            ops.append(('E', m, n))
            n -= 1
        else:                             # vertical: consume a[m-1]
            ops.append(('F', m, n))
            m -= 1
        if opened:
            state = 0
    ops.reverse()
    return ops, m, n, state
