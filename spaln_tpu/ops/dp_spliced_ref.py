"""Scalar reference engine for spliced cDNA x genome DP — the SPEC.

A faithful re-derivation of the reference's scalar recurrence
(Aln2s1::forwardS_ng, fwd2s1.cc:217-444) including every comparison
direction and tie-break (SURVEY.md A.4), used as the differential oracle
for the device engines.  Pure Python/numpy, intended for small test cases.

Coordinates: cells (m, n), m in 1..M over query a, n in 1..N over genome b,
cell (m, n) consumes a[m-1], b[n-1].  Band r = n - m in [lw+1, up+1].
Intron = genome positions [n5, n3) (0-based), donor signal at index n5,
acceptor at n3, both equal to their DP boundary coordinates.

States: 0=H (diag), 1=E1 (hori/genome gap), 2=F (vert/query gap),
3=E2, 4=F2 (double affine).  Per-row candidate list of <=4 open donors
closed at acceptor sites (NCAND insertion sort with eviction,
fwd2s1.cc:380-406).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .params import DpParams, DpFlags, NEVSEL
from ..score.splice import SpliceSignals

NCAND = 4
# psp bits per state [H, E1, F, E2, F2] (aln.h:56-59)
PSP_BIT = (4, 1, 8, 2, 16)
E1_PSP, E2_PSP = 1, 2


@dataclass
class Window:
    lw: int
    up: int

    @classmethod
    def full(cls, M: int, N: int) -> "Window":
        return cls(lw=-M, up=N)

    @classmethod
    def stripe(cls, M: int, N: int, sh: int = 100,
               cmode: int = 0) -> "Window":
        """aln2.cc:156-176 band setup for (semi)global alignment."""
        up = N - M
        lw = 0
        if cmode == 1:
            lw = up
        elif cmode == 2:
            up = lw
        elif up < lw:
            up, lw = lw, up
        up += sh
        lw -= sh
        up = min(up, N)
        lw = max(lw, -M)
        return cls(lw=lw, up=up)


@dataclass
class TraceMats:
    """Per-cell traceback planes, indexed [m][r - lw + 1]."""
    hdir: np.ndarray             # uint8 winner state (5 = unset)
    eopen: np.ndarray            # bool: E1 opened here
    fopen: np.ndarray
    e2open: np.ndarray | None
    f2open: np.ndarray | None
    spj: np.ndarray              # int32 (5, M+1, W): donor n5+1 or 0
    lw: int

    def ri(self, m: int, n: int) -> int:
        return n - m - self.lw + 1


def forward_spliced_ref(a: np.ndarray, b: np.ndarray, prm: DpParams,
                        sig: SpliceSignals | None = None,
                        wdw: Window | None = None,
                        flags: DpFlags | None = None,
                        sig_b_bonus: int = 0):
    """Returns (score, end_m, end_n, TraceMats)."""
    flags = flags or DpFlags()
    M, N = len(a), len(b)
    if wdw is None:
        wdw = Window.full(M, N)
    lw, up = wdw.lw, wdw.up
    W = up - lw + 4                      # r in [lw-1, up+2]
    off = -lw + 1

    spj_on = sig is not None
    dagp = prm.dagp
    n_states = 5 if dagp else 3
    GOPk = (0, prm.gop, prm.lgop)        # pwd->GOP

    ipen_tab = prm.intron_table(N + 1) if spj_on else None
    is_don = sig.is_donor if spj_on else None
    is_acc = sig.is_accpt if spj_on else None

    H = np.full(W, NEVSEL, dtype=np.int64)
    F = np.full(W, NEVSEL, dtype=np.int64)
    F2 = np.full(W, NEVSEL, dtype=np.int64)

    tb = TraceMats(
        hdir=np.full((M + 1, W), 5, dtype=np.uint8),
        eopen=np.zeros((M + 1, W), dtype=bool),
        fopen=np.zeros((M + 1, W), dtype=bool),
        e2open=np.zeros((M + 1, W), dtype=bool) if dagp else None,
        f2open=np.zeros((M + 1, W), dtype=bool) if dagp else None,
        spj=np.zeros((n_states, M + 1, W), dtype=np.int32),
        lw=lw)

    # ---------------------------------------------------------------- init
    # the band need not hold the origin: a mapping window starts a margin
    # left of the gene (lw > 0), and only band slots r >= lw - 1 exist
    r0 = 0                                # origin r = b.left - a.left
    if lw - 1 <= r0:
        H[r0 + off] = 0
        tb.hdir[0, r0 + off] = 6          # origin marker
    if flags.a_exgl:                      # free genome prefix: top row = 0
        rr = min(up, N)
        for r in range(max(r0 + 1, lw - 1), rr + 1):
            H[r + off] = 0
            tb.hdir[0, r + off] = 1
    # left column (r < 0): free query prefix if b_exgl else gap costs
    rr = max(lw, -M)
    val = 0
    for i, r in enumerate(range(r0 - 1, rr - 1, -1), start=1):
        if flags.b_exgl:
            H[r + off] = 0
        else:
            val = (prm.gap_penalty(1) if i == 1 else val + prm.gep)
            H[r + off] = val
        tb.hdir[-r, r + off] = 2 if not flags.b_exgl else 7

    # ------------------------------------------------------------- row loop
    m0 = 1 if flags.a_exgl else 0
    best = (NEVSEL, 0, 0)
    for m in range(m0, M + 1):
        qprof = prm.qprof_mtx[a[m - 1]] if m > 0 else None
        n_lo = max(m + lw, 0)
        n_hi = min(m + up + 1, N)
        e1 = np.int64(NEVSEL)
        e2 = np.int64(NEVSEL)
        psp = 0
        cand = []                         # list of [val, jnc, dir]
        for n in range(n_lo + 1, n_hi + 1):
            r = n - m + off
            hdir = 5
            diag = H[r]
            # Diagonal
            skip_diag = (m == 0)
            if not skip_diag:
                H[r] = diag + int(qprof[b[n - 1]])
                hdir = 0
                mx_val, mx_k = H[r], 0
                # Vertical
                x = H[r + 1] + prm.gop
                if x >= F[r + 1]:
                    F[r] = x
                    tb.fopen[m, r] = True
                else:
                    F[r] = F[r + 1]
                F[r] += prm.gep
                if F[r] > mx_val:
                    mx_val, mx_k = F[r], 2
                # Vertical2
                if dagp:
                    x = H[r + 1] + prm.lgop
                    if x >= F2[r + 1]:
                        F2[r] = x
                        tb.f2open[m, r] = True
                    else:
                        F2[r] = F2[r + 1]
                    F2[r] += prm.lgep
                    if F2[r] > mx_val:
                        mx_val, mx_k = F2[r], 4
            else:
                mx_val, mx_k = H[r], 0
            # Horizontal
            x = H[r - 1] + prm.gop
            prev_psp = psp
            if x >= e1:
                e1 = x
                tb.eopen[m, r] = True
                psp = E1_PSP if psp else 0
            else:
                psp &= E1_PSP
            e1 += prm.gep
            if e1 >= mx_val:
                mx_val, mx_k = e1, 1
            # Horizontal2
            if dagp:
                x = H[r - 1] + prm.lgop
                if x >= e2:
                    e2 = x
                    tb.e2open[m, r] = True
                    if prev_psp:
                        psp |= E2_PSP
                else:
                    psp |= (prev_psp & E2_PSP)
                e2 += prm.lgep
                if e2 >= mx_val:
                    mx_val, mx_k = e2, 3

            state_vals = [H, None, F, None, F2]

            # Acceptor close (before winner selection, fwd2s1.cc:333-354)
            internal = spj_on and (not flags.a_exgr or m < M)
            if internal and n < N and is_acc[n]:
                closed = {}
                for cval, jnc, cdir in cand:
                    if n - jnc < prm.intron_llmt:
                        continue
                    x = (cval + sig_b_bonus + int(ipen_tab[n - jnc])
                         + int(sig.sig53_ie53(jnc, n)))
                    cur = (e1 if cdir == 1 else e2 if cdir == 3
                           else state_vals[cdir][r])
                    if x >= cur:
                        if cdir == 1:
                            e1 = np.int64(x)
                        elif cdir == 3:
                            e2 = np.int64(x)
                        else:
                            state_vals[cdir][r] = x
                        closed[cdir] = jnc
                for cdir, jnc in closed.items():
                    psp |= PSP_BIT[cdir]
                    tb.spj[cdir, m, r] = jnc + 1
                    v = (e1 if cdir == 1 else e2 if cdir == 3
                         else state_vals[cdir][r])
                    if v >= mx_val:
                        mx_val, mx_k = v, cdir

            # winner into H
            if mx_k != 0:
                H[r] = mx_val
                tb.hdir[m, r] = mx_k
            else:
                tb.hdir[m, r] = 0 if not skip_diag else 1

            # Donor push (fwd2s1.cc:380-406)
            if internal and n < N and is_don[n]:
                sigJ = int(sig.sig5[n])
                k_start = 0 if mx_k == 0 else 1
                for k in range(k_start, n_states):
                    if psp & PSP_BIT[k]:
                        continue
                    fv = (e1 if k == 1 else e2 if k == 3
                          else state_vals[k][r])
                    if k != mx_k:
                        z = mx_val
                        if mx_k == 0 or (k - mx_k) % 2:
                            z += GOPk[k // 2]
                        if fv <= z:
                            continue
                    x = int(fv) + sigJ
                    # NCAND insertion with eviction
                    if len(cand) < NCAND:
                        cand.append([x, n, k])
                        cand.sort(key=lambda c: -c[0])
                    elif x > cand[-1][0]:
                        cand[-1] = [x, n, k]
                        cand.sort(key=lambda c: -c[0])

        # row done; track best end for semi-global termination
        del e1, e2

    # ------------------------------------------------------------ last cell
    # Final H band: index r <= r9 holds row-M cells (M, M+r); index r > r9
    # holds right-column cells (N-r, N) — the last write to each slot
    # (lastS_ng, fwd2s1.cc:188-215).
    # The corner (M, N) may lie outside the band (then NEVSEL).
    r9 = N - M
    best_val = H[r9 + off] if lw - 1 <= r9 <= up + 2 else NEVSEL
    best_m, best_n = M, N
    if flags.a_exgr:                      # free genome suffix: max over row M
        for r in range(max(lw, -M), min(r9, up + 3)):
            if H[r + off] > best_val:
                best_val, best_m, best_n = H[r + off], M, M + r
    if flags.b_exgr:                      # free query suffix: right column
        for r in range(max(r9 + 1, lw - 1), min(up, N) + 1):
            if H[r + off] > best_val:
                best_val, best_m, best_n = H[r + off], N - r, N
    return int(best_val), best_m, best_n, tb


def traceback_spliced_ref(tb: TraceMats, end_m: int, end_n: int,
                          start_guard: int = 10_000_000):
    """Walk the traceback planes from (end_m, end_n).

    Returns a list of ops, reversed to forward order:
      ('D', m, n)        diagonal match cell (consumed a[m-1], b[n-1])
      ('E', m, n)        genome base b[n-1] in a gap (deletion in query)
      ('F', m, n)        query base a[m-1] unmatched (insertion)
      ('I', m, n5, n3)   intron [n5, n3)
    """
    ops = []
    m, n = end_m, end_n
    state = 0
    steps = 0
    while steps < start_guard:
        steps += 1
        if m <= 0:
            break                          # free/origin top row reached
        r = tb.ri(m, n)
        jnc = int(tb.spj[state, m, r]) if state < tb.spj.shape[0] else 0
        if state == 0:
            hd = int(tb.hdir[m, r])
            if hd in (5, 6, 7):
                break                      # origin / free boundary
            if hd == 1 and m == 0:
                break
            if hd == 0:
                if jnc:
                    ops.append(('I', m, jnc - 1, n))
                    n = jnc - 1
                    continue
                ops.append(('D', m, n))
                m, n = m - 1, n - 1
                continue
            state = hd                     # winner was a gap state
            continue
        if jnc:                            # intron within gap state
            ops.append(('I', m, jnc - 1, n))
            n = jnc - 1
            continue
        if state in (1, 3):                # horizontal: consume b[n-1]
            opened = bool((tb.eopen if state == 1 else tb.e2open)[m, r])
            ops.append(('E', m, n))
            n -= 1
            if opened:
                state = 0
            continue
        # vertical: consume a[m-1]
        opened = bool((tb.fopen if state == 2 else tb.f2open)[m, r])
        ops.append(('F', m, n))
        m -= 1
        if opened:
            state = 0
    ops.reverse()
    return ops
