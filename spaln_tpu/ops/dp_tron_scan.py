"""Protein x translated-genome spliced DP as a JAX wavefront scan.

Re-design of the reference's SimdAln2h1 slab engine (fwd2h1_simd.h):
vector lane i owns aa row m = m0 + i; at step t it computes the cell

    n_i(t) = (3*m0 + lw - 1) + t - 3i        (r = n - 3m in [lw-1, up])

so every dependency is a lane-shift of a short history ring:
  left   (m, n-1..n-3)   same lane @ t-1..t-3   (E queue / E opens)
  codon  (m-1, n-3)      lane i-1  @ t-6        (diagonal)
  slide  (m-1, n-2/n-1)  lane i-1  @ t-5 / t-4  (1/2-nt frameshifts)
  vert   (m-1, n)        lane i-1  @ t-3        (aa deletion)

Genome operands stream as contiguous slices of pre-reversed arrays.  The
three splice phases keep separate NCAND=4 donor-candidate lists per lane;
phase +-1 closes re-score the junction codon through the 256-entry
junction tron tables.  Matches the scalar oracle (dp_tron_ref) exactly —
differential tests assert identical scores and paths.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .params import DpFlags, NEVSEL
from .dp_tron_ref import (TronDpParams, DEAD, RSRV, DIAG, NEWD, VERT, SLA1, SLA2,
                          VERL, HORI, HOR1, HOR2, HORL, SPIN, _IS_VERT,
                          DIR2NOD)
from ..score.codepot import TronSignals

NCAND = 4
I32 = jnp.int32
NEV = np.int32(NEVSEL)
_VERT_MASK = np.zeros(64, dtype=np.int32)
for _d in (VERT, SLA1, SLA2, VERL):
    _VERT_MASK[_d] = 1
    _VERT_MASK[_d | SPIN] = 1
_NOD_OF = np.full(64, -1, dtype=np.int32)
for _d, _k in DIR2NOD.items():
    _NOD_OF[_d] = _k
    _NOD_OF[_d | SPIN] = _k


def _insert_cand(cv, cj, cd, c3d, x, jnc, kdir, d3v, push):
    """Masked insertion into (..., NCAND) sorted lists; ties displace
    existing entries (H-engine `x >=` insertion, fwd2h1.cc:553-558)."""
    pos = jnp.sum(cv > x[..., None], axis=-1)
    slot = jnp.arange(NCAND)
    here = (slot == pos[..., None]) & push[..., None]
    shift = (slot > pos[..., None]) & push[..., None]

    def place(arr, new):
        shifted = jnp.concatenate([arr[..., :1], arr[..., :-1]], axis=-1)
        return jnp.where(here, new[..., None],
                         jnp.where(shift, shifted, arr))

    return (place(cv, x), place(cj, jnc), place(cd, kdir), place(c3d, d3v))


def build_tron_operands(a, bn, sig: TronSignals, prm: TronDpParams,
                        ipen_tab, Mpad, pad_extra, flags: DpFlags,
                        Npad: int | None = None, shift: int = 0):
    """Host stage: phase-split reversed operand arrays + query profiles.

    Lane n-values step by 3 per lane, so operands are stored reshaped as
    B3[k, p] = arr_padded[(Lp3-1-k)*3 + p]: the kernel reads value_i =
    arr[S - 3i] as the contiguous rows B3[k0 + i, p] with p = S' mod 3.
    ``shift`` (= delta, this problem's band shift vs the batch-shared
    band base) pre-bakes per-problem placement into the layout so every
    kernel read uses a batch-invariant cursor.
    """
    M, N = len(a), len(bn)
    alpha = prm.qprof_mtx.shape[1]
    qprof = np.zeros((Mpad + 1, alpha), dtype=np.int32)
    qprof[:M] = prm.qprof_mtx[np.asarray(a, dtype=np.int64)]
    qprof[M:] = prm.qprof_mtx[np.asarray(a[-1:], dtype=np.int64)]

    pad = (pad_extra // 2 // 3) * 3
    assert shift <= pad - 8, "band shift exceeds operand pad"
    Nsz = Npad if Npad is not None else N
    Ltot = -(-(pad + Nsz + pad) // 3) * 3
    Lp3 = Ltot // 3

    def b3(x, fill=0, width=None):
        shape = (Ltot,) if width is None else (Ltot, width)
        out = np.full(shape, fill, dtype=np.int32)
        lo = pad - shift
        out[lo:lo + N] = x
        if width is None:
            return out.reshape(Lp3, 3)[::-1].copy()
        return out.reshape(Lp3, 3, width)[::-1].copy()

    accb = sig.sig3.astype(np.int32) - sig.tabs.tab3[sig.dinc3]
    ops = {
        "rb_bt": b3(sig.btron.astype(np.int32), fill=2),
        "rb_sigE": b3(sig.sigE),
        "rb_sig5": b3(sig.sig5.astype(np.int32)),
        "rb_accb": b3(accb),
        "rb_d5": b3(sig.dinc5.astype(np.int32)),
        "rb_d3": b3(sig.dinc3.astype(np.int32)),
        "rb_phs5": b3(sig.phs5.astype(np.int32), fill=-2),
        "rb_phs3": b3(sig.phs3.astype(np.int32), fill=-2),
        "t53": sig.tabs.tab53.astype(np.int32).reshape(-1),
        "ipen": ipen_tab.astype(np.int32),
        "t1": sig.spj_tron1.astype(np.int32),
        "t2": sig.spj_tron2.astype(np.int32),
    }
    return ops, qprof, pad, Lp3


def _tron_scan_batch(B, L, W, gop, gep, ge1, ge2, gw1, gw2, gw3, minl,
                     T, pad2, Lp3, PBn, TOTn, emit_trace, dagp=False,
                     lgop=0, lgep=0, gw3l=0, local_l=False,
                     local_r=False):
    """Natively-batched tron wavefront slab (no vmap: every operand
    read stays a batch-shared slice or one flat gather per stream).

    All device indices are batch-invariant: per-problem band placement
    (delta = lw_i - lw0) is pre-baked into the operand layout by
    build_tron_operands(shift=) and into the boundary-array placement
    (PBn - delta) by prepare_tron_batch; boundary writes stream out as
    per-step emissions and are written back as contiguous windows at
    batch-shared cursors after the scan (the dp_spliced_scan scheme).
    m0, lw0 are traced; only the padded geometry recompiles."""
    n_nod = 5 if dagp else 3

    def step(carry, xin, *, qp0, qp1, ops, bnd, m0, lw0, deltas, Ms, Ns,
             a_exgr, loc_lo, loc_hi):
        t, strm = xin
        (hh, hd, ff, ee, ed, ff2, fd2, ee2, ed2, cv, cj, cd, c3d) = carry
        # hh: (6, B, L) H history (hh[0] = t-1 ... hh[5] = t-6); hd dirs
        # ff: (3, B, L) F history; ee: (3, B, L) E queue vals; ed dirs
        # ff2/fd2: F2 val+dir history, ee2/ed2: E2 queue (dagp)
        # cv/cj/cd/c3d: 3-tuples (one per splice phase) of (B, L, NCAND)
        a_exgr = jnp.asarray(a_exgr, bool)
        lanes = jnp.arange(L)
        m = m0 + lanes                              # (L,) shared
        c0 = 3 * m0 + lw0 - 1                       # shared cursor base
        n_s = (c0 + t) - 3 * lanes                  # (L,) shared col
        n = n_s[None, :] + deltas[:, None]          # (B, L) real col
        # lane i's band offset: r = (lw-1) + t - 6i (the n-stagger is 3i,
        # and r = n - 3m drops another 3i); band-relative, so shared
        r_off = t - 6 * lanes
        started = r_off >= 0
        in_band = r_off < W
        active = ((started & in_band & (m >= 1))[None, :]
                  & (n >= 0) & (n <= Ns[:, None])
                  & (m[None, :] <= Ms[:, None]))
        first = r_off == 0
        q = t % 3

        negrow = jnp.full((B, 1), NEV)

        def shift(v):                     # lane i <- lane i-1
            return jnp.concatenate([negrow, v[:, :-1]], axis=1)

        def shifti(v, fill=0):
            f = jnp.full((B, 1), fill, v.dtype)
            return jnp.concatenate([f, v[:, :-1]], axis=1)

        # ---- neighbor values from history (lane-shifted)
        up_h3 = shift(hh[2])              # (m-1, n)    H
        up_d3 = shifti(hd[2])
        up_h4 = shift(hh[3])              # (m-1, n-1)
        up_d4 = shifti(hd[3])
        up_h5 = shift(hh[4])              # (m-1, n-2)
        up_d5 = shifti(hd[4])
        hq_v = shift(hh[5])               # (m-1, n-3)  diagonal source
        hq_d = shifti(hd[5])
        up_f3 = shift(ff[2])              # (m-1, n)    F
        up_f23 = shift(ff2[2])            # (m-1, n)    F2 (dagp)
        up_fd23 = shifti(fd2[2])
        left1, left2, left3 = hh[0], hh[1], hh[2]
        ld1, ld3 = hd[0], hd[2]

        # lane 0 boundary from previous slab / init row: values at
        # (m0-1, n0), (m0-1, n0-1), (m0-1, n0-2), (m0-1, n0-3); read at
        # the batch-shared (shifted) cursor
        n0s = c0 + t
        n0 = n0s + deltas                           # (B,) real col
        bl = jnp.clip(n0s - 3 + PBn, 0, TOTn - 4)
        bh4 = jax.lax.dynamic_slice(bnd["h"], (0, bl), (B, 4))
        bd4 = jax.lax.dynamic_slice(bnd["hd"], (0, bl), (B, 4))
        bf4 = jax.lax.dynamic_slice(bnd["f"], (0, bl), (B, 4))
        okb = (n0 >= 3) & (n0 <= Ns)                # (B,)
        lane0 = (lanes == 0)[None, :]

        def l0(arr, val, fill):
            return jnp.where(lane0, jnp.where(okb, val, fill)[:, None],
                             arr)

        up_h3 = l0(up_h3, bh4[:, 3], NEV)
        up_d3 = l0(up_d3, bd4[:, 3], DEAD)
        up_h4 = l0(up_h4, bh4[:, 2], NEV)
        up_d4 = l0(up_d4, bd4[:, 2], DEAD)
        up_h5 = l0(up_h5, bh4[:, 1], NEV)
        up_d5 = l0(up_d5, bd4[:, 1], DEAD)
        hq_v = l0(hq_v, bh4[:, 0], NEV)
        hq_d = l0(hq_d, bd4[:, 0], DEAD)
        up_f3 = l0(up_f3, bf4[:, 3], NEV)
        if dagp:
            bf24 = jax.lax.dynamic_slice(bnd["f2"], (0, bl), (B, 4))
            bfd24 = jax.lax.dynamic_slice(bnd["f2d"], (0, bl), (B, 4))
            up_f23 = l0(up_f23, bf24[:, 3], NEV)
            up_fd23 = l0(up_fd23, bfd24[:, 3], DEAD)

        # band-right edge: vertical sources invalid (r+1..r+3 > up)
        at_top = (r_off >= W - 1)[None, :]
        at_top2 = (r_off >= W - 2)[None, :]
        at_top3 = (r_off >= W - 3)[None, :]
        up_h3 = jnp.where(at_top3, NEV, up_h3)
        up_f3 = jnp.where(at_top3, NEV, up_f3)
        up_f23 = jnp.where(at_top3, NEV, up_f23)
        up_h4 = jnp.where(at_top2, NEV, up_h4)
        up_h5 = jnp.where(at_top, NEV, up_h5)

        # lane (re)activation resets
        f1 = first[None, None, :]
        eq = jnp.where(f1, NEV, ee)
        edq = jnp.where(f1, 0, ed)
        eq2 = jnp.where(f1, NEV, ee2)
        edq2 = jnp.where(f1, 0, ed2)
        fc = first[None, :, None]
        cv = tuple(jnp.where(fc, NEV, x) for x in cv)
        cj = tuple(jnp.where(fc, 0, x) for x in cj)
        cd = tuple(jnp.where(fc, 0, x) for x in cd)
        c3d = tuple(jnp.where(fc, 0, x) for x in c3d)

        # ---- phase-split reversed slices: value_i = arr[n_i + o] read as
        # rows B3[k0 + i, p] with S' = pad + c0 + t + o, p = S' mod 3
        # (per-problem delta is baked into the layout, so S is shared)
        # per-step operand values arrive as scan xs streams built once
        # pre-scan (dp_spliced_scan fix A: in-step dynamic slices from
        # the (B, Lp3, 3) phase-split layouts were 62% of device time —
        # minor-dim-3 tiles pad to 128 lanes and every step paid the
        # relayout)
        (bt_n2, bt_n1p, sigE_n2, sigE_n1p, phs5_n, phs3_n,
         sig5_n, sig5_n1, sig5_np1, accb_n, accb_n1, accb_np1,
         d5_n, d5_n1, d5_np1, d3_n, d3_n1, d3_np1) = (
            v.astype(I32) for v in strm)
        # acceptor joint values come from the 256-entry constant table:
        # acc_joint[n, d5] = tab53[16*d5 + dinc3[n]] (splice.py:233),
        # so the (B, Lp3, 3, 16) operand is unnecessary
        t53 = ops["t53"]
        joint_n = joint_n1 = joint_np1 = None

        # ================= recurrence (fwd2h1.cc:361-575) ================
        score = jnp.take_along_axis(qp0, bt_n2[..., None], axis=2)[..., 0]
        h_ok = n >= 3
        h_val = jnp.where(h_ok, hq_v + score + sigE_n2, NEV)
        h_dir = jnp.where(h_ok,
                          jnp.where((hq_d == DIAG) | (hq_d == NEWD)
                                    | (hq_d == (DIAG | SPIN)),
                                    DIAG, NEWD),
                          DEAD)
        mx_val, mx_k, mx_dir = h_val, jnp.zeros((B, L), I32), h_dir

        def isvert(d):
            # _IS_VERT = {VERT..VERL} = dirs 4..7 (dp_tron_ref.py:30-34)
            dm = d & 15
            return (dm >= VERT) & (dm <= VERL)

        # ---- vertical
        y = up_f3 + gep
        x = up_h5 + jnp.where(isvert(up_d5), ge1, gw1)
        f_val = jnp.where(x > y, x, y)
        f_dir = jnp.where(x > y, SLA2, VERT)
        f_open = x > y
        x = up_h4 + jnp.where(isvert(up_d4), ge2, gw2)
        t2_ = x > f_val
        f_val = jnp.where(t2_, x, f_val)
        f_dir = jnp.where(t2_, SLA1, f_dir)
        f_open = f_open | t2_
        x = up_h3 + gw3
        t3_ = x >= f_val
        f_val = jnp.where(t3_, x, f_val)
        f_dir = jnp.where(t3_, VERT, f_dir)
        f_open = jnp.where(t3_, True, f_open)
        t4_ = (~t3_) & (y >= f_val)
        f_val = jnp.where(t4_, y, f_val)
        f_dir = jnp.where(t4_, VERT, f_dir)
        f_open = jnp.where(t4_, False, f_open)
        gt = f_val > mx_val
        mx_val = jnp.where(gt, f_val, mx_val)
        mx_k = jnp.where(gt, 2, mx_k)
        mx_dir = jnp.where(gt, f_dir, mx_dir)

        # ---- long deletion F2 (dagp, fwd2h1.cc:413-425); extension
        # copies the prior dir (*f2 = f2[3]) so SPIN propagates
        f2_val = jnp.full((B, L), NEV)
        f2_dir = jnp.zeros((B, L), I32)
        f2_open = jnp.zeros((B, L), bool)
        if dagp:
            x = up_h3 + gw3l
            y = up_f23 + lgep
            f2_open = x >= y
            f2_val = jnp.where(f2_open, x, y)
            f2_dir = jnp.where(f2_open, VERL, up_fd23)
            gt = f2_val > mx_val
            mx_val = jnp.where(gt, f2_val, mx_val)
            mx_k = jnp.where(gt, 4, mx_k)
            mx_dir = jnp.where(gt, f2_dir, mx_dir)

        # ---- horizontal (rotating queue slot q)
        ev = eq[q]
        edir = edq[q]
        e_open = jnp.zeros((B, L), bool)
        ok3 = (r_off > 2)[None, :]
        x = jnp.where(ok3, left3 + gw3, NEV)
        ev3 = ev + gep
        opened3 = ok3 & (x > ev3)
        spin3 = jnp.where(opened3, ld3 & SPIN, edir & SPIN)
        ev = jnp.where(ok3, jnp.where(opened3, x, ev3)
                       + jnp.where(n >= 2, sigE_n2, 0), ev)
        edir = jnp.where(ok3, spin3 | HORI, edir)
        e_open = e_open | opened3
        # long insertion E2 (dagp, fwd2h1.cc:439-448), mx-checked here
        # (before the 2/1-nt E1 updates), matching the scalar order
        ev2 = eq2[q]
        edir2 = edq2[q]
        e2_open = jnp.zeros((B, L), bool)
        if dagp:
            x2 = jnp.where(ok3, left3 + gw3l, NEV)
            ev23 = ev2 + lgep
            opened23 = ok3 & (x2 > ev23)
            spin23 = jnp.where(opened23, ld3 & SPIN, edir2 & SPIN)
            ev2 = jnp.where(ok3, jnp.where(opened23, x2, ev23)
                            + jnp.where(n >= 2, sigE_n2, 0), ev2)
            edir2 = jnp.where(ok3, spin23 | HORL, edir2)
            e2_open = opened23
            ge2_ = ev2 > mx_val
            mx_val = jnp.where(ge2_, ev2, mx_val)
            mx_k = jnp.where(ge2_, 3, mx_k)
            mx_dir = jnp.where(ge2_, edir2, mx_dir)
        ok2 = (r_off > 1)[None, :]
        x = jnp.where(ok2, left2 + gw2, NEV)
        t2e = x > ev
        ev = jnp.where(t2e, x, ev)
        edir = jnp.where(t2e, (hd[1] & SPIN) | HOR2, edir)
        e_open = jnp.where(t2e, True, e_open)
        x = left1 + gw1
        t1e = x > ev
        ev = jnp.where(t1e, x, ev)
        edir = jnp.where(t1e, (ld1 & SPIN) | HOR1, edir)
        e_open = jnp.where(t1e, True, e_open)
        ge_ = ev > mx_val
        mx_val = jnp.where(ge_, ev, mx_val)
        mx_k = jnp.where(ge_, 1, mx_k)
        mx_dir = jnp.where(ge_, edir, mx_dir)

        internal = (~a_exgr) | (m[None, :] < Ms[:, None])
        state_v = [h_val, ev, f_val, ev2, f2_val][:n_nod]
        state_d = [h_dir, edir, f_dir, edir2, f2_dir][:n_nod]

        # ---- acceptor closes over phases {-1, 0, +1}
        spj_jnc = [jnp.zeros((B, L), I32) for _ in range(n_nod)]
        spj_phs = [jnp.zeros((B, L), I32) for _ in range(n_nod)]
        acc_any = internal & active & (n < Ns[:, None]) & (phs3_n != -2)
        for phs, accb_p, dinc3_p in ((-1, accb_np1, d3_np1),
                                     (0, accb_n, d3_n),
                                     (1, accb_n1, d3_n1)):
            pm = acc_any & (((phs3_n == 2) & (phs != 0))
                            | (phs3_n == phs))
            nb = n - phs
            pi = phs + 1
            ilen = nb[..., None] - cj[pi]
            pen = jnp.take(ops["ipen"],
                           jnp.clip(ilen, 0, ops["ipen"].shape[0] - 1))
            # candidate c3d packs (dinc3[nb5] << 4) | dinc5[nb5]
            cand_d5 = c3d[pi] & 15
            jsel = jnp.clip(16 * cand_d5 + dinc3_p[..., None], 0, 255)
            xc = (cv[pi] + pen + accb_p[..., None]
                  + jnp.take(t53, jsel))
            # phase +-1 junction codon rescoring for dir-0 candidates
            if phs != 0:
                w4 = jnp.clip(16 * ((c3d[pi] >> 4) & 15)
                              + (d5_np1 if phs == -1
                                 else d5_n1)[..., None], 0, 255)
                if phs == 1:
                    tr = jnp.take(ops["t1"], w4)
                    adj = jnp.take_along_axis(
                        qp0, jnp.clip(tr, 0, 25), axis=2)
                else:
                    tr = jnp.take(ops["t2"], w4)
                    adj = jnp.take_along_axis(
                        qp1, jnp.clip(tr, 0, 25), axis=2)
                    bt_adj = jnp.take_along_axis(
                        qp1, jnp.clip(bt_n1p[..., None], 0, 25), axis=2)
                    adj = jnp.where((n[..., None] + 1) < Ns[:, None, None],
                                    adj - bt_adj - sigE_n1p[..., None], 0)
                xc = xc + jnp.where(cd[pi] == 0, adj, 0)
            okc = (pm[..., None] & (ilen >= minl)
                   & (cv[pi] > NEV // 2))
            if phs == 1:
                okc = okc & (cd[pi] != 2)
            xc = jnp.where(okc, xc, NEV)
            for k in range(n_nod):
                cur = state_v[k]
                jnc_k = spj_jnc[k]
                php_k = spj_phs[k]
                for l in range(NCAND):
                    take = (cd[pi][..., l] == k) & (xc[..., l] > cur) \
                        & okc[..., l]
                    cur = jnp.where(take, xc[..., l], cur)
                    jnc_k = jnp.where(take, cj[pi][..., l] + 1, jnc_k)
                    php_k = jnp.where(take, phs, php_k)
                state_v[k] = cur
                spj_jnc[k] = jnc_k
                spj_phs[k] = php_k
                sd_new = (DIAG, HORI, VERT, HORL, VERL)[k] | SPIN
                state_d[k] = jnp.where(jnc_k > 0, sd_new, state_d[k])
                gt2 = (jnc_k > 0) & (cur > mx_val)
                mx_val = jnp.where(gt2, cur, mx_val)
                mx_k = jnp.where(gt2, k, mx_k)
                mx_dir = jnp.where(gt2, state_d[k], mx_dir)
        if dagp:
            h_val, ev, f_val, ev2, f2_val = state_v
            h_dir, edir, f_dir, edir2, f2_dir = state_d
        else:
            h_val, ev, f_val = state_v
            h_dir, edir, f_dir = state_d

        # ---- winner into H
        h_out = mx_val
        hd_out = mx_dir
        mx_k_tr = mx_k

        # ---- Local mode (fwd2h1.cc:514-526): LocalR tracks improving
        # diagonal wins as alignment-end candidates; LocalL clamps
        # non-positive cells to a fresh local start (val 0, dir DEAD)
        loc_val = loc_lane = None
        if local_r:
            y_gt = (mx_k == 0) & (h_out > hq_v)
            start_case = (hq_d == DEAD) & ((hd_out & SPIN) == 0)
            lmax_ok = (active & y_gt & (n >= loc_hi[:, None])
                       & (~start_case if local_l else jnp.bool_(True)))
            lv = jnp.where(lmax_ok, h_out, NEV)
            loc_val = jnp.max(lv, axis=1)
            loc_lane = jnp.argmax(lv, axis=1).astype(I32)
        if local_l:
            clamp = active & (h_out <= 0) & (n <= loc_lo[:, None])
            h_out = jnp.where(clamp, 0, h_out)
            hd_out = jnp.where(clamp, DEAD, hd_out).astype(I32)
            mx_k_tr = jnp.where(clamp, 0, mx_k)
            spj_jnc[0] = jnp.where(clamp, 0, spj_jnc[0])
            clamp0 = clamp & (mx_k == 0)
            mx_val = jnp.where(clamp0, 0, mx_val)
            mx_dir = jnp.where(clamp0, DEAD, mx_dir).astype(I32)

        # ---- donor pushes over phases
        don_any = internal & active & (n < Ns[:, None]) & (phs5_n != -2)
        dm_ = mx_dir & 15
        # DIR2NOD as a compare chain (dp_tron_ref.py:37-38): dirs 0..1
        # -> -1, 2..3 -> 0, 4..6 -> 2, 7 -> 4, 8..10 -> 1, 11 -> 3
        hd_nod = jnp.where(dm_ <= RSRV, -1,
                           jnp.where(dm_ <= NEWD, 0,
                                     jnp.where(dm_ <= SLA2, 2,
                                               jnp.where(dm_ == VERL, 4,
                                                         jnp.where(dm_ <= HOR2,
                                                                   1, 3)))))
        for phs, sig5_p in ((-1, sig5_np1), (0, sig5_n), (1, sig5_n1)):
            pm = don_any & (((phs5_n == 2) & (phs != 0))
                            | (phs5_n == phs))
            nb = n - phs
            pi = phs + 1
            d3_p = (d3_np1, d3_n, d3_n1)[pi]
            d5_p = (d5_np1, d5_n, d5_n1)[pi]
            cvp, cjp, cdp, c3p = cv[pi], cj[pi], cd[pi], c3d[pi]
            for k in range(n_nod):
                crossspj = (phs == 1 and k == 0)
                if crossspj:
                    fv, fdir = hq_v, hq_d
                else:
                    fv = (h_out, ev, f_val, ev2, f2_val)[k]
                    fdir = (hd_out, edir, f_dir, edir2, f2_dir)[k]
                elig = pm
                if k == 0 and not crossspj:
                    elig = elig & (hd_nod == 0)
                elig = elig & (fdir != DEAD) & ((fdir & SPIN) == 0)
                if not crossspj:
                    z = mx_val + jnp.where(
                        (hd_nod == 0) | (((k - hd_nod) % 2) != 0),
                        (0, 0, gop, gop, lgop)[k], 0)
                    prune = (k != hd_nod) & (hd_nod >= 0) & (fv <= z)
                    elig = elig & ~prune
                x = fv + sig5_p
                # candidate stores (dinc3[nb5] << 4) | dinc5[nb5]: exon
                # tail for junction re-coding, intron head for the joint
                code = ((d3_p & 15) << 4) | (d5_p & 15)
                cvp, cjp, cdp, c3p = _insert_cand(
                    cvp, cjp, cdp, c3p, x, nb,
                    jnp.full((B, L), k, I32), code, elig)
            cv = cv[:pi] + (cvp,) + cv[pi + 1:]
            cj = cj[:pi] + (cjp,) + cj[pi + 1:]
            cd = cd[:pi] + (cdp,) + cd[pi + 1:]
            c3d = c3d[:pi] + (c3p,) + c3d[pi + 1:]

        # ---- masked commit
        h_out = jnp.where(active, h_out, NEV)
        hd_c = jnp.where(active, hd_out, DEAD).astype(I32)
        f_out = jnp.where(active, f_val, NEV)
        eq = eq.at[q].set(jnp.where(active, ev, eq[q]))
        edq = edq.at[q].set(jnp.where(active, edir, edq[q]))
        f2_out = jnp.where(active, f2_val, NEV)
        f2d_c = jnp.where(active, f2_dir, DEAD).astype(I32)
        eq2 = eq2.at[q].set(jnp.where(active, ev2, eq2[q]))
        edq2 = edq2.at[q].set(jnp.where(active, edir2, edq2[q]))

        # ---- boundary / result emissions (window-written post-scan at
        # batch-shared cursors; row/rc assembled host-side).  NEV marks
        # not-written so host assembly keeps the per-problem semantics.
        li = L - 1
        wl = active[:, li]
        ys_b = (h_out[:, li], hd_c[:, li], f_out[:, li],
                f2_out[:, li], f2d_c[:, li], wl)
        # final-row stream: lane of row M (per problem) via masked sum
        mi = Ms - m0                                 # (B,) lane of row M
        row_mask = (lanes[None, :] == mi[:, None]) & active
        row_v = jnp.sum(jnp.where(row_mask, h_out - NEV, 0), axis=1) + NEV
        # right-column stream: lane with n == N (per problem)
        rc_mask = (n == Ns[:, None]) & active
        rc_v = jnp.sum(jnp.where(rc_mask, h_out - NEV, 0), axis=1) + NEV
        ys = ys_b + (row_v, rc_v)
        if local_r:
            ys = ys + (loc_val, loc_lane)

        hh_n = jnp.concatenate([h_out[None], hh[:5]])
        hd_n = jnp.concatenate([hd_c[None], hd[:5]])
        ff_n = jnp.concatenate([f_out[None], ff[:2]])
        ff2_n = jnp.concatenate([f2_out[None], ff2[:2]])
        fd2_n = jnp.concatenate([f2d_c[None], fd2[:2]])
        carry = (hh_n, hd_n, ff_n, eq, edq, ff2_n, fd2_n, eq2, edq2,
                 cv, cj, cd, c3d)
        if not emit_trace:
            return carry, ys
        # dirs fit 5 bits (<= HORL|SPIN = 27); winner node in bits 5-7
        fl_h = (jnp.clip(hd_out, 0, 31).astype(jnp.uint8)
                | (mx_k_tr.astype(jnp.uint8) << 5))
        fl_h = jnp.where(active, fl_h, jnp.uint8(255))
        fl_e = (edir & 31).astype(jnp.uint8) | jnp.where(
            e_open, jnp.uint8(0x80), jnp.uint8(0))
        fl_f = (f_dir & 31).astype(jnp.uint8) | jnp.where(
            f_open, jnp.uint8(0x80), jnp.uint8(0))
        fl_e2 = (edir2 & 31).astype(jnp.uint8) | jnp.where(
            e2_open, jnp.uint8(0x80), jnp.uint8(0))
        fl_f2 = (f2_dir & 31).astype(jnp.uint8) | jnp.where(
            f2_open, jnp.uint8(0x80), jnp.uint8(0))
        # state-major (NSPJ, B, L): the device walker indexes it flat
        spj_out = jnp.stack(spj_jnc, axis=0)
        php_out = jnp.stack(spj_phs, axis=0).astype(jnp.int8)
        return carry, ys + (fl_h, fl_e, fl_f, spj_out, php_out,
                            fl_e2, fl_f2)

    def run(qp0, qp1, ops, bnd_h, bnd_hd, bnd_f, bnd_f2, bnd_f2d,
            m0, lw0, deltas, Ms, Ns, a_exgr, loc_lo, loc_hi):
        from .dp_spliced_scan import _win_update
        bnd = {"h": bnd_h, "hd": bnd_hd, "f": bnd_f,
               "f2": bnd_f2, "f2d": bnd_f2d}
        carry0 = (
            jnp.full((6, B, L), NEV), jnp.zeros((6, B, L), I32),
            jnp.full((3, B, L), NEV),
            jnp.full((3, B, L), NEV), jnp.zeros((3, B, L), I32),
            jnp.full((3, B, L), NEV), jnp.zeros((3, B, L), I32),
            jnp.full((3, B, L), NEV), jnp.zeros((3, B, L), I32),
            (jnp.full((B, L, NCAND), NEV),) * 3,
            (jnp.zeros((B, L, NCAND), I32),) * 3,
            (jnp.zeros((B, L, NCAND), I32),) * 3,
            (jnp.zeros((B, L, NCAND), I32),) * 3)
        f = functools.partial(step, qp0=qp0, qp1=qp1, ops=ops, bnd=bnd,
                              m0=m0, lw0=lw0, deltas=deltas, Ms=Ms,
                              Ns=Ns, a_exgr=a_exgr, loc_lo=loc_lo,
                              loc_hi=loc_hi)
        # pre-scan operand streams: value_i(t) = B3[k0(t)+i, p(t)] for
        # each (operand, offset) pair the step reads, built with ONE
        # flat gather per stream (leading-axis scan slicing is free;
        # the in-step dynamic slices they replace were 62% of device
        # wall, see step docstring)
        c0s = 3 * m0 + lw0 - 1
        ts_all = jnp.arange(T)
        lane_i = jnp.arange(L)

        def stream(key, o):
            S = pad2 + c0s + ts_all + o              # (T,)
            k0 = Lp3 - 1 - S // 3
            p = S % 3
            idx = 3 * (k0[:, None] + lane_i[None, :]) + p[:, None]
            idx = jnp.clip(idx.reshape(-1), 0, Lp3 * 3 - 1)
            flat = ops[key].reshape(B, Lp3 * 3)
            g = jnp.take(flat, idx, axis=1)
            return g.reshape(B, T, L).transpose(1, 0, 2)

        strm = tuple(stream(k, o) for k, o in (
            ("rb_bt", -2), ("rb_bt", 1), ("rb_sigE", -2), ("rb_sigE", 1),
            ("rb_phs5", 0), ("rb_phs3", 0),
            ("rb_sig5", 0), ("rb_sig5", -1), ("rb_sig5", 1),
            ("rb_accb", 0), ("rb_accb", -1), ("rb_accb", 1),
            ("rb_d5", 0), ("rb_d5", -1), ("rb_d5", 1),
            ("rb_d3", 0), ("rb_d3", -1), ("rb_d3", 1)))
        _, ys = jax.lax.scan(f, carry0, (ts_all, strm))
        (bh, bhd, bf, bf2, bf2d, wl, row_v, rc_v) = ys[:8]
        n_extra = 8
        loc = ()
        if local_r:
            loc = ys[8:10]
            n_extra = 10
        # write the last lane's boundary stream back as one contiguous
        # window: position at step t is n_s[L-1] = c0 + t - 3(L-1)
        c0 = 3 * m0 + lw0 - 1
        ws = c0 - 3 * (L - 1)
        wlT = wl.T
        bnd_h = _win_update(bnd_h, bh.T, wlT, ws, PBn)
        bnd_hd = _win_update(bnd_hd, bhd.T, wlT, ws, PBn)
        bnd_f = _win_update(bnd_f, bf.T, wlT, ws, PBn)
        if dagp:
            bnd_f2 = _win_update(bnd_f2, bf2.T, wlT, ws, PBn)
            bnd_f2d = _win_update(bnd_f2d, bf2d.T, wlT, ws, PBn)
        return ((bnd_h, bnd_hd, bnd_f, bnd_f2, bnd_f2d),
                (row_v, rc_v) + loc, ys[n_extra:])
    return run


def tron_init_row(sig: TronSignals, prm: TronDpParams, N: int,
                  a_exgl: bool = True, sigs_until: int | None = None):
    """Top-row H values/dirs over n = 0..N+1 (initH_ng semantics for the
    default free-end mode: reseed at translation starts, carry coding
    potential, 1/2-nt shifts).

    sigs_until: the TransInit restart bonus applies only at n <= this
    bound (the seed-anchor start).  The reference runs its free-init
    top row only over the 5'-terminal segment — interior segments are
    anchored (seededH_ng inex.exgl=0, fwd2h1.cc:3218-3241) — so a
    strong ATG signal INSIDE the anchored span must not out-bid the
    anchored diagonal (observed: the DP deleting perfectly matching
    lead codons to restart at a downstream in-exon ATG)."""
    h = np.zeros(N + 2, dtype=np.int64)
    hd = np.full(N + 2, DEAD, dtype=np.int32)
    if not a_exgl:
        return h.astype(np.int32), hd
    sigS = sig.sigS.copy()
    if sigs_until is not None and sigs_until + 4 < len(sigS):
        sigS[sigs_until + 4:] = 0
    sigE = sig.sigE

    def s_at(n):
        return int(sigS[n]) if 0 <= n < N else 0

    h[0] = max(s_at(1), 0)
    for i, n in enumerate(range(1, N + 2), start=1):
        if i < 3:
            h[n] = max(s_at(n + 1), 0)
            hd[n] = DEAD
        else:
            h[n] = h[n - 3] + prm.gep
            hd[n] = HORI
            if 0 <= n - 3 < N:
                h[n] += int(sigE[n - 3])
            x = h[n - 1] + prm.gap_w1
            if x > h[n]:
                h[n], hd[n] = x, HOR1
            x = h[n - 2] + prm.gap_w2
            if x > h[n]:
                h[n], hd[n] = x, HOR2
        x = max(s_at(n + 1), 0)
        if h[n] < x:
            h[n], hd[n] = x, DEAD
    return h.astype(np.int32), hd


@dataclass
class TronTraceScan:
    fl_h: list
    fl_e: list
    fl_f: list
    spj: list
    php: list
    L: int
    lw: int
    W: int
    fl_e2: list | None = None       # dagp long-gap planes
    fl_f2: list | None = None

    def cell(self, m, n):
        s = (m - 1) // self.L
        i = (m - 1) % self.L
        m0 = 3 * (s * self.L + 1)
        t = n - m0 - self.lw + 1 + 3 * i
        return s, t, i


@dataclass
class TronBatchProblem:
    """Batched tron operands (host prep separated from device execute).
    Band placement deltas = lws - lw0 are pre-baked into the operand
    layout and the boundary-array placement, so every device index is
    batch-invariant (the dp_spliced_scan BatchProblem scheme)."""
    ops: dict                  # (B, Lp3, 3[, 16]) stacked + shared tabs
    qprof_all: object          # jnp (B, Mpad+1, alpha)
    bnd0: tuple                # initial (B, TOTn) x5 (h, hd, f, f2, f2d)
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
    Mpad: int
    Ngeom: int
    T: int
    pad2: int
    Lp3: int
    PBn: int
    TOTn: int
    n_slabs: int
    flags: DpFlags
    sigs: list                 # host refs (sigT for end extraction)
    loc_lo_j: object = None    # (B,) Local-region bounds (anchor span)
    loc_hi_j: object = None


def prepare_tron_batch(queries: list, genomes: list, sigs: list,
                       prm: TronDpParams, ipen_tab: np.ndarray,
                       lws: list | None = None, W: int | None = None,
                       flags: DpFlags | None = None,
                       L: int = 64,
                       loc_bounds: list | None = None
                       ) -> TronBatchProblem:
    """Host stage: pad B tron problems to a common geometry.

    loc_bounds: per-problem (lo, hi) genome positions restricting
    Local-mode behavior to outside the chain anchors (see
    forward_tron_ref)."""
    flags = flags or DpFlags()
    B = len(queries)
    Ms = [len(q) for q in queries]
    Ns = [len(g) for g in genomes]
    if lws is None:
        lws = [-3 * m for m in Ms]
        W = max(n - l for n, l in zip(Ns, lws)) + 2
    assert W is not None
    lw0 = min(lws)
    deltas = [l - lw0 for l in lws]
    dmax = max(deltas)
    from .dp_spliced_scan import _geom_bucket
    dpad = _geom_bucket(-(-dmax // 384)) * 384 if dmax else 0
    n_slabs = _geom_bucket((max(Ms) + L - 1) // L)
    Mpad = n_slabs * L
    Ngeom = _geom_bucket(-(-max(Ns) // 384)) * 384   # geometric buckets
    pad_extra = 2 * (L + W + 16 + dpad)
    T = W + 6 * (L - 1)
    PBn = 3 * Mpad + 3 * L + dpad + 16
    TOTn = PBn + 3 * Mpad + Ngeom + T + 3 * L + 16

    stacked: dict = {}
    qprofs = []
    pad = Lp3 = 0
    for i in range(B):
        od, qprof, pad, Lp3 = build_tron_operands(
            np.asarray(queries[i]), np.asarray(genomes[i]), sigs[i], prm,
            ipen_tab, Mpad, pad_extra, flags, Npad=Ngeom,
            shift=deltas[i])
        for k in ("rb_bt", "rb_sigE", "rb_sig5", "rb_accb", "rb_d5",
                  "rb_d3", "rb_phs5", "rb_phs3"):
            stacked.setdefault(k, []).append(od[k])
        qprofs.append(qprof)
        shared = od                     # ipen/t1/t2/t53 are batch-shared
    ops = {k: jnp.asarray(np.stack(v)) for k, v in stacked.items()}
    # bucket the intron-penalty table length (values past the true
    # length are never read: intron length <= N)
    ipad = -(-len(shared["ipen"]) // 512) * 512
    ops["ipen"] = jnp.asarray(np.pad(
        shared["ipen"], (0, ipad - len(shared["ipen"])), mode="edge"))
    ops["t1"] = jnp.asarray(shared["t1"])
    ops["t2"] = jnp.asarray(shared["t2"])
    ops["t53"] = jnp.asarray(shared["t53"])
    qprof_all = jnp.asarray(np.stack(qprofs))

    if loc_bounds is None:
        loc_bounds = [(1 << 30, -(1 << 30))] * B
    bnd_h = np.full((B, TOTn), NEVSEL, dtype=np.int32)
    bnd_hd = np.full((B, TOTn), DEAD, dtype=np.int32)
    for i in range(B):
        bh0, bd0 = tron_init_row(sigs[i], prm, Ns[i], flags.a_exgl,
                                 sigs_until=(loc_bounds[i][0]
                                             if loc_bounds[i][0] < (1 << 29)
                                             else None))
        o = PBn - deltas[i]             # storage: PBn + n - delta
        bnd_h[i, o:o + Ns[i] + 2] = bh0
        bnd_hd[i, o:o + Ns[i] + 2] = bd0
    bnd_f = np.full((B, TOTn), NEVSEL, dtype=np.int32)
    bnd0 = (jnp.asarray(bnd_h), jnp.asarray(bnd_hd), jnp.asarray(bnd_f),
            jnp.asarray(bnd_f), jnp.zeros((B, TOTn), I32))
    return TronBatchProblem(ops=ops, qprof_all=qprof_all, bnd0=bnd0,
                            Ms=Ms, Ns=Ns, lws=lws, deltas=deltas,
                            Ms_j=jnp.asarray(Ms), Ns_j=jnp.asarray(Ns),
                            deltas_j=jnp.asarray(deltas),
                            B=B, L=L, W=W, lw=lw0, Mpad=Mpad,
                            Ngeom=Ngeom, T=T, pad2=pad, Lp3=Lp3,
                            PBn=PBn, TOTn=TOTn, n_slabs=n_slabs,
                            flags=flags, sigs=sigs,
                            loc_lo_j=jnp.asarray(
                                [b[0] for b in loc_bounds], jnp.int32),
                            loc_hi_j=jnp.asarray(
                                [b[1] for b in loc_bounds], jnp.int32))


@functools.lru_cache(maxsize=32)
def _tron_fused(n_slabs, L, *statics, **kw):
    """All tron slabs in ONE jitted program: a lax.scan over slabs whose
    carry is the slab boundary, so one dispatch runs the whole batch and
    the compiled body does not grow with the slab count.  Emissions and
    planes come back stacked with a leading slab axis."""
    body = _tron_scan_batch(*statics, **kw)

    @jax.jit
    def go(qp_all, ops, bnds, lw0, deltas, Ms, Ns, a_exgr, loc_lo,
           loc_hi):
        def slab(bnds, si):
            m0 = si * L + 1
            qp0 = jax.lax.dynamic_slice_in_dim(qp_all, m0 - 1, L, axis=1)
            qp1 = jax.lax.dynamic_slice_in_dim(qp_all, m0, L, axis=1)
            bnds, emis, tr = body(qp0, qp1, ops, *bnds, m0, lw0, deltas,
                                  Ms, Ns, a_exgr, loc_lo, loc_hi)
            return bnds, (emis, tr)

        _, (emis, tr) = jax.lax.scan(slab, bnds,
                                     jnp.arange(n_slabs, dtype=I32))
        return emis, tr
    return go


def run_tron_batch(bp: TronBatchProblem, prm: TronDpParams,
                   score_only: bool = False, keep_device: bool = False):
    """Device stage: all slabs for the whole batch in one dispatch;
    host-side assembly of the final-row / right-column result vectors.

    Returns (row_np (B, Ngeom+2), rc_np (B, Mpad+2), traces).  traces
    is a list with one host plane tuple ((T, B, L) arrays) per slab, or
    with keep_device the device plane tuple stacked over slabs
    ((S, T, B, L) arrays) for traceback_tron_device."""
    B, L, T = bp.B, bp.L, bp.T
    flags = bp.flags
    local_l = flags.local and flags.a_exgl and flags.b_exgl
    local_r = flags.local and flags.a_exgr and flags.b_exgr
    lw0 = jnp.asarray(bp.lw)
    row_np = np.full((B, bp.Ngeom + 2), int(NEV), dtype=np.int64)
    rc_np = np.full((B, bp.Mpad + 2), int(NEV), dtype=np.int64)
    # best local end per problem: (val, m, n), first-encountered max in
    # (m asc, n asc) order (the scalar maxh scan order)
    bp.loc_best = [(int(NEV), 0, 0)] * B
    go = _tron_fused(bp.n_slabs, L, B, L, bp.W, prm.gop, prm.gep,
                     prm.gap_e1, prm.gap_e2, prm.gap_w1, prm.gap_w2,
                     prm.gap_w3, prm.intron_minl, T, bp.pad2, bp.Lp3,
                     bp.PBn, bp.TOTn, not score_only, dagp=prm.dagp,
                     lgop=prm.lgop, lgep=prm.lgep, gw3l=prm.gap_w3l,
                     local_l=local_l, local_r=local_r)
    emis_all, tr_all = go(bp.qprof_all, bp.ops, bp.bnd0, lw0,
                          bp.deltas_j, bp.Ms_j, bp.Ns_j, bp.flags.a_exgr,
                          bp.loc_lo_j, bp.loc_hi_j)
    emis_np = [np.asarray(e) for e in emis_all]      # (S, T, B) each
    if score_only:
        traces = []
    elif keep_device:
        traces = tr_all
    else:
        tr_np = [np.asarray(y) for y in tr_all]
        traces = [tuple(y[s] for y in tr_np) for s in range(bp.n_slabs)]
    for s in range(bp.n_slabs):
        m0 = s * L + 1
        row_s = emis_np[0][s]                        # (T, B)
        rc_s = emis_np[1][s]
        if local_r:
            lv_s = emis_np[2][s]                     # (T, B)
            ll_s = emis_np[3][s]
            c0s = 3 * m0 + bp.lw - 1
            for b in range(B):
                cand_t = np.nonzero(lv_s[:, b] > int(NEV))[0]
                if not len(cand_t):
                    continue
                best = bp.loc_best[b]
                vals = lv_s[cand_t, b]
                lanes_b = ll_s[cand_t, b]
                ms = m0 + lanes_b
                ns = c0s + cand_t - 3 * lanes_b + bp.deltas[b]
                order = np.lexsort((ns, ms, -vals))
                v0, m_, n_ = (int(vals[order[0]]), int(ms[order[0]]),
                              int(ns[order[0]]))
                if v0 > best[0]:
                    bp.loc_best[b] = (v0, m_, n_)
        c0 = 3 * m0 + bp.lw - 1
        for b in range(B):
            M, N, d = bp.Ms[b], bp.Ns[b], bp.deltas[b]
            li = M - m0
            if 0 <= li < L:
                # n at lane li, step t: c0 + t - 3*li + delta
                nt0 = c0 - 3 * li + d
                lo_t = max(0, -nt0)
                hi_t = min(T, N + 1 - nt0)
                if hi_t > lo_t:
                    seg = row_s[lo_t:hi_t, b]
                    w = seg != int(NEV)
                    dst = row_np[b, nt0 + lo_t:nt0 + hi_t]
                    dst[w] = seg[w]
            iarr = np.arange(L)
            tarr = (N - d - c0) + 3 * iarr
            sel = (tarr >= 0) & (tarr < T) & (m0 + iarr <= M)
            if sel.any():
                vals = rc_s[tarr[sel], b]
                w = vals != int(NEV)
                rc_np[b, (m0 + iarr[sel])[w]] = vals[w]
    return row_np, rc_np, traces


def collect_tron_results(bp: TronBatchProblem, row_np, rc_np, traces,
                         score_only: bool):
    """Host stage: per-problem end extraction (lastH_ng semantics) and
    per-problem TronTraceScan views of the batched planes."""
    flags = bp.flags
    local_r = flags.local and flags.a_exgr and flags.b_exgr
    out = []
    for b in range(bp.B):
        M, N, lw = bp.Ms[b], bp.Ns[b], bp.lws[b]
        up = lw + bp.W - 2
        row_b = row_np[b]
        rc_b = rc_np[b]
        sigT = bp.sigs[b].sigT
        if local_r:
            # LocalR: mid-matrix best end wins unless on the last row
            # (fwd2h1.cc:608-613)
            lv, lm, ln = getattr(bp, "loc_best", [(int(NEV), 0, 0)] * bp.B)[b]
            if lv > int(NEV) and lm != M:
                tr = None
                if not score_only:
                    tr = TronTraceScan(
                        fl_h=[t[0][:, b] for t in traces],
                        fl_e=[t[1][:, b] for t in traces],
                        fl_f=[t[2][:, b] for t in traces],
                        spj=[t[3][:, :, b] for t in traces],
                        php=[t[4][:, :, b] for t in traces],
                        L=bp.L, lw=lw, W=bp.W,
                        fl_e2=[t[5][:, b] for t in traces],
                        fl_f2=[t[6][:, b] for t in traces])
                    tr.row_h = row_b
                    tr.rc_h = rc_b
                out.append((lv, lm, ln, tr))
                continue
        best_val, best_m, best_n = row_b[N], M, N
        if flags.a_exgr:
            for n in range(max(3 * M + lw - 1, 3), N + 1):
                v = row_b[n]
                if n - 3 >= 0 and 0 <= n - 2 < N and sigT[n - 2] > 0:
                    vt = row_b[n - 3] + int(sigT[n - 2])
                    if vt > v:
                        v = vt
                if v > best_val:
                    best_val, best_m, best_n = v, M, n
        if flags.b_exgr:
            for r in range(N - 3 * M + 1, min(up, N) + 1):
                if (N - r) % 3 == 0:
                    mm = (N - r) // 3
                    if 1 <= mm < M and rc_b[mm] > best_val:
                        best_val, best_m, best_n = rc_b[mm], mm, N
        tr = None
        if not score_only:
            tr = TronTraceScan(
                fl_h=[t[0][:, b] for t in traces],
                fl_e=[t[1][:, b] for t in traces],
                fl_f=[t[2][:, b] for t in traces],
                spj=[t[3][:, :, b] for t in traces],
                php=[t[4][:, :, b] for t in traces],
                L=bp.L, lw=lw, W=bp.W,
                fl_e2=[t[5][:, b] for t in traces],
                fl_f2=[t[6][:, b] for t in traces])
            tr.row_h = row_b            # debug visibility
            tr.rc_h = rc_b
        out.append((int(best_val), int(best_m), int(best_n), tr))
    return out


def forward_tron_scan(a: np.ndarray, bn: np.ndarray, sig: TronSignals,
                      prm: TronDpParams, ipen_tab: np.ndarray,
                      lw: int | None = None, up: int | None = None,
                      flags: DpFlags | None = None, L: int = 64,
                      score_only: bool = False,
                      loc_bounds: tuple | None = None):
    """Run the tron wavefront for one problem (batch-of-1 wrapper, so
    the single-problem and batched paths cannot drift)."""
    flags = flags or DpFlags()
    M, N = len(a), len(bn)
    if lw is None:
        lw, up = -3 * M, N
    W = up - lw + 2
    bp = prepare_tron_batch([np.asarray(a)], [np.asarray(bn)], [sig],
                            prm, ipen_tab, lws=[lw], W=W, flags=flags,
                            L=L,
                            loc_bounds=([loc_bounds] if loc_bounds
                                        is not None else None))
    row_np, rc_np, traces = run_tron_batch(bp, prm,
                                           score_only=score_only)
    res = collect_tron_results(bp, row_np, rc_np, traces, score_only)
    return res[0]


def traceback_tron_scan(tr: TronTraceScan, end_m: int, end_n: int,
                        guard: int = 10_000_000):
    """Same op stream as traceback_tron_ref, from wavefront planes."""
    ops = []
    m, n = end_m, end_n
    state = 0
    steps = 0
    while steps < guard and m > 0 and n > 0:
        steps += 1
        s, t, i = tr.cell(m, n)
        if t < 0 or t >= tr.fl_h[s].shape[0]:
            break
        if state == 0:
            hd = int(tr.fl_h[s][t, i])
            if hd == 255:
                break
            winner = (hd >> 5) & 7
            if winner != 0:
                state = winner
                continue
            jnc = int(tr.spj[s][t, 0, i])
            if jnc:
                phs = int(tr.php[s][t, 0, i])
                nb5, nb3 = jnc - 1, n - phs
                ops.append(('I', m, nb5, nb3, phs))
                if phs == 0:
                    n = nb5
                elif phs == 1:
                    ops.append(('D', m, n))
                    m, n = m - 1, nb5 + 1 - 3
                else:
                    n = nb5 - 1
                continue
            if (hd & 15) == DEAD:
                break
            ops.append(('D', m, n))
            m, n = m - 1, n - 3
            continue
        if state in (1, 3):
            jnc = int(tr.spj[s][t, state, i])
            if jnc:
                phs = int(tr.php[s][t, state, i])
                ops.append(('I', m, jnc - 1, n - phs, phs))
                n = jnc - 1 + phs
                continue
            ed = int((tr.fl_e if state == 1 else tr.fl_e2)[s][t, i])
            base = ed & 15
            opened = bool(ed & 0x80)
            w = {HORI: 3, HOR2: 2, HOR1: 1, HORL: 3}.get(base, 3)
            ops.append(('E', m, n, w))
            n -= w
            if opened:
                state = 0
            continue
        jnc = int(tr.spj[s][t, state, i])
        if jnc:
            phs = int(tr.php[s][t, state, i])
            ops.append(('I', m, jnc - 1, n - phs, phs))
            n = jnc - 1 + phs
            continue
        fd = int((tr.fl_f if state == 2 else tr.fl_f2)[s][t, i])
        base = fd & 15
        opened = bool(fd & 0x80)
        step_n = {VERT: 0, SLA2: 2, SLA1: 1, VERL: 0}.get(base, 0)
        ops.append(('F', m, n, step_n))
        m -= 1
        n -= step_n
        if opened:
            state = 0
    ops.reverse()
    return ops


@functools.lru_cache(maxsize=32)
def _tron_tb_walker(S, T, B, L, NSPJ, IT):
    """Device-side tron traceback: walk all B problems through the
    stacked trace planes in one jitted scan (traceback_tron_scan
    semantics — 5 states, per-phase junction closes, crossspj split
    codons).  The planes never leave the device; the walker returns
    only (IT, B, 5) op records."""

    def walk(FLH, FLE, FLF, FLE2, FLF2, SPJ, PHP, m0v, n0v, lwv):
        barr = jnp.arange(B)

        def step(carry, _):
            m, n, st, done = carry
            s = (m - 1) // L
            i = (m - 1) % L
            m0 = 3 * (s * L + 1)
            t = n - m0 - lwv + 1 + 3 * i
            ok = ((~done) & (m >= 1) & (n >= 1) & (t >= 0) & (t < T)
                  & (s >= 0) & (s < S))
            sc = jnp.clip(s, 0, S - 1)
            tc = jnp.clip(t, 0, T - 1)
            ic = jnp.clip(i, 0, L - 1)
            flat = ((sc * T + tc) * B + barr) * L + ic
            stc = jnp.clip(st, 0, NSPJ - 1)
            # SPJ/PHP are stacked STATE-MAJOR (S, T, NSPJ, B, L)
            spj_at = ((((sc * T + tc) * NSPJ + stc) * B + barr) * L
                      + ic)
            jnc = jnp.where(ok, jnp.take(SPJ, spj_at), 0)
            phs = jnp.where(ok, jnp.take(PHP, spj_at), 0)
            flh = jnp.where(ok, jnp.take(FLH, flat), 255)
            is0 = st == 0
            winner = (flh >> 5) & 7
            dead0 = is0 & ((flh == 255)
                           | ((winner == 0) & (jnc == 0)
                              & ((flh & 15) == DEAD)))
            trans = is0 & ~dead0 & (winner != 0)
            close0 = is0 & ~dead0 & (winner == 0) & (jnc > 0)
            diag = is0 & ~dead0 & (winner == 0) & (jnc == 0)
            # gap states
            is_e = (st == 1) | (st == 3)
            is_f = (st == 2) | (st == 4)
            close_g = (is_e | is_f) & (jnc > 0)
            fe = jnp.where(st == 1, jnp.take(FLE, flat),
                           jnp.take(FLE2, flat))
            ff = jnp.where(st == 2, jnp.take(FLF, flat),
                           jnp.take(FLF2, flat))
            e_base = fe & 15
            f_base = ff & 15
            ew = jnp.where(e_base == HOR2, 2,
                           jnp.where(e_base == HOR1, 1, 3))
            fstep = jnp.where(f_base == SLA2, 2,
                              jnp.where(f_base == SLA1, 1, 0))
            e_mv = is_e & ~close_g
            f_mv = is_f & ~close_g
            nb5 = jnc - 1
            cross = close0 & (phs == 1)
            kind = jnp.where(~ok | dead0 | trans, 0,
                             jnp.where(cross, 5,
                                       jnp.where(close0, 4,
                                                 jnp.where(close_g, 4,
                                                           jnp.where(diag, 1,
                                                                     jnp.where(e_mv, 2, 3))))))
            # aux fields: I records carry (nb5, phs); E carries w; F step
            a1 = jnp.where((kind == 4) | (kind == 5), nb5,
                           jnp.where(kind == 2, ew, fstep))
            a2 = jnp.where((kind == 4) | (kind == 5), phs, 0)
            rec = (kind, m, n, a1, a2)
            # ---- moves
            n2 = jnp.where(diag, n - 3,
                 jnp.where(cross, nb5 - 2,
                 jnp.where(close0 & (phs == 0), nb5,
                 jnp.where(close0, nb5 - 1,          # phs == -1
                 jnp.where(close_g, nb5 + phs,
                 jnp.where(e_mv, n - ew,
                 jnp.where(f_mv, n - fstep, n)))))))
            m2 = jnp.where(diag | cross | f_mv, m - 1, m)
            e_open = e_mv & ((fe & 0x80) != 0)
            f_open = f_mv & ((ff & 0x80) != 0)
            st2 = jnp.where(trans, winner,
                  jnp.where(close0, 0,
                  jnp.where(e_open | f_open, 0, st)))
            done2 = done | dead0 | (~ok) | (m2 < 1) | (n2 < 1)
            return (m2, n2, st2, done2), rec

        carry0 = (m0v, n0v, jnp.zeros(B, jnp.int32),
                  (m0v < 1) | (n0v < 1))
        _, recs = jax.lax.scan(step, carry0, None, length=IT)
        return recs

    raw = walk
    walk = jax.jit(walk)
    walk.raw = raw
    return walk


def traceback_tron_device(bp: TronBatchProblem, traces, ends) -> list:
    """Walk every problem's tron traceback on device and return
    per-problem ascending op streams (the traceback_tron_scan
    contract).  ``traces`` is run_tron_batch's keep_device plane tuple,
    stacked over slabs."""
    S = traces[0].shape[0]
    NSPJ = traces[3].shape[2]

    def flat(ix):
        return jnp.reshape(traces[ix].astype(I32), (-1,))

    FLH, FLE, FLF = flat(0), flat(1), flat(2)
    SPJ = flat(3)
    PHP = flat(4)
    FLE2, FLF2 = flat(5), flat(6)
    IT = 2 * (3 * bp.Mpad + bp.W) + 64
    walk = _tron_tb_walker(S, bp.T, bp.B, bp.L, NSPJ, IT)
    m0v = jnp.asarray([int(e[0]) for e in ends], jnp.int32)
    n0v = jnp.asarray([int(e[1]) for e in ends], jnp.int32)
    recs = walk(FLH, FLE, FLF, FLE2, FLF2, SPJ, PHP, m0v, n0v,
                jnp.asarray(bp.lws, jnp.int32))
    k_np, m_np, n_np, a1_np, a2_np = (np.asarray(r) for r in recs)
    out = []
    for b in range(bp.B):
        sel = np.flatnonzero(k_np[:, b])
        ops = []
        for j in sel:
            k = int(k_np[j, b])
            m, n = int(m_np[j, b]), int(n_np[j, b])
            if k == 1:
                ops.append(('D', m, n))
            elif k == 2:
                ops.append(('E', m, n, int(a1_np[j, b])))
            elif k == 3:
                ops.append(('F', m, n, int(a1_np[j, b])))
            else:
                phs = int(a2_np[j, b])
                nb5 = int(a1_np[j, b])
                ops.append(('I', m, nb5, n - phs, phs))
                if k == 5:
                    ops.append(('D', m, n))
        ops.reverse()
        out.append(ops)
    return out
