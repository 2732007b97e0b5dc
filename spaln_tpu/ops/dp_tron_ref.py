"""Scalar reference engine for protein x translated-genome spliced DP.

Faithful re-derivation of Aln2h1::forwardH_ng (fwd2h1.cc:294-617) +
initH_ng/lastH_ng (141-293).  States:
  0 = H (diag, consumes 1 aa x 3 nt), 1 = E (genome insertion, rotating
  3-frame queue), 2 = F (aa deletion), with 1/2-nt frameshift moves into
  both gap states (GapE1/E2 extend, GapW1/W2 open); with double affine
  (-yl3, prm.dagp) also 3 = E2 (HORL) / 4 = F2 (VERL) long-gap states
  under LongGOP/GEP (fwd2h1.cc:413-448).

Coordinates: m in aa (1..M), n in nt (1..N), band r = n - 3m in
[lw-1, up].  The genome is given both as nt codes (splice signals) and
tron codes btron[p] = translation of the codon centered at p; the diagonal
move at (m, n) scores mtx[a[m-1], btron[n-2]] + sigE[n-2].

Splice phases: acceptors/donors fire at phs in {-1, 0, +1} with separate
NCAND candidate lists per phase; phase +-1 junction codons are re-scored
through the 256-entry junction tron tables.  SPIN flags block orphan
exons.  Used as the differential oracle for the device tron engine.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import DpParams, DpFlags, NEVSEL
from ..score.codepot import TronSignals

NCAND = 4
# dir codes (aln.h:30-36)
DEAD, RSRV, DIAG, NEWD, VERT, SLA1, SLA2, VERL = 0, 1, 2, 3, 4, 5, 6, 7
HORI, HOR1, HOR2, HORL = 8, 9, 10, 11
SPIN = 16
_IS_DIAG = {DIAG, NEWD}
_IS_VERT = {VERT, SLA1, SLA2, VERL}
_IS_HORI = {HORI, HOR1, HOR2, HORL}
# node order = hf[] in fwd2h1.cc:298 [H, E1, F, E2, F2] (aln.h dir2nod)
DIR2NOD = {DEAD: -1, RSRV: -1, DIAG: 0, NEWD: 0, VERT: 2, SLA1: 2,
           SLA2: 2, VERL: 4, HORI: 1, HOR1: 1, HOR2: 1, HORL: 3}
NOD2DIR = {0: DIAG, 1: HORI, 2: VERT, 3: HORL, 4: VERL}


@dataclass
class TronDpParams:
    """Protein-path gap costs (PwdB ctor, aln2.cc:99-127)."""
    qprof_mtx: np.ndarray          # tron matrix (26, 26) int32
    gop: int                       # BasicGOP
    gep: int                       # BasicGEP
    extra_gop: int                 # -x * Vab (frameshift)
    intron_minl: int = 20
    scale: int = 10
    # double affine (Noll == 3, -yl3): long-gap costs per codon step;
    # LongGEP = -u1*Vab, LongGOP = BasicGOP - (LongGEP - BasicGEP)*k1
    dagp: bool = False
    lgop: int = 0                  # LongGOP
    lgep: int = 0                  # LongGEP
    codonk1: int = 1 << 30         # long-gap switch (aln2.cc:114)
    vthr: int = 350                # Vthr = alprm.thr * Vab (aln2.cc:105)

    @property
    def gap_e1(self) -> int:
        return self.gep + self.extra_gop

    @property
    def gap_e2(self) -> int:
        return self.gap_e1 + self.gep

    @property
    def gap_w1(self) -> int:
        return self.gap_e1 + self.gop

    @property
    def gap_w2(self) -> int:
        return self.gap_e2 + self.gop

    @property
    def gap_w3(self) -> int:
        return self.gop + self.gep

    @property
    def gap_w3l(self) -> int:
        return self.lgop + self.lgep

    @classmethod
    def build(cls, cfg, tron_mtx: np.ndarray, u: float = 2., v: float = 9.):
        vab = cfg.aln.scale
        gop, gep = -int(v * vab), -int(u * vab)
        lgep = -int(cfg.aln.u1 * vab)
        lgop = gop - (lgep - gep) * int(cfg.aln.k1)
        return cls(qprof_mtx=tron_mtx, gop=gop, gep=gep,
                   extra_gop=-int(cfg.aln2.x * vab),
                   intron_minl=cfg.intron.minl, scale=cfg.aln.scale,
                   dagp=cfg.aln.ls >= 3, lgop=lgop, lgep=lgep,
                   codonk1=(3 * int(cfg.aln.k1) if cfg.aln.ls >= 3
                            else 1 << 30),
                   vthr=int(cfg.aln.thr * vab))

    def gap_penalty3(self, i: int) -> int:
        """PwdB::GapPenalty3 (aln2.cc:41-52): affine gap cost over i nt
        with frameshift end costs and the long-gap regime past codonk1."""
        if i <= 0:
            return 0
        x = (self.gap_e1, self.gap_e2)[i % 3 - 1] if i % 3 else 0
        if i > self.codonk1:
            return x + self.lgop + (i // 3) * self.lgep
        return x + self.gop + (i // 3) * self.gep


@dataclass
class TronTrace:
    hdir: np.ndarray             # uint8 per (m, rband): final H dir code
    edir: np.ndarray             # uint8: E-state source (HORI/HOR1/HOR2 +
    fdir: np.ndarray             # uint8: F-state source  open flag bit 0x80)
    spj: np.ndarray              # int32 (5, M+1, W): acceptor-close records
    spj_phs: np.ndarray          # int8 (5, M+1, W): phase of the close
    lw: int
    e2dir: np.ndarray | None = None   # uint8 (dagp): HORL + open bit
    f2dir: np.ndarray | None = None   # uint8 (dagp): VERL + open bit

    def ri(self, m: int, n: int) -> int:
        return n - 3 * m - self.lw + 2


def forward_tron_ref(a: np.ndarray, bn: np.ndarray, sig: TronSignals,
                     prm: TronDpParams, ipen_tab: np.ndarray,
                     lw: int | None = None, up: int | None = None,
                     flags: DpFlags | None = None, spj: bool = True,
                     loc_bounds: tuple | None = None):
    """Returns (score, end_m, end_n, TronTrace).

    a: aa codes (M,), bn: genome nt codes (N,); sig holds btron/signals.
    ipen_tab: dense intron penalty by length (int32, len >= N+1).
    loc_bounds: (lo, hi) genome positions restricting Local-mode
    behavior to the regions OUTSIDE the seed-chain anchors — the
    reference applies Local only to terminal segments (seededH_ng sets
    inex.exgl/exgr = 0 on interior segments, fwd2h1.cc:3218-3241):
    LocalL restarts fire at n <= lo only, LocalR end candidates are
    tracked at n >= hi only.  None = local applies everywhere.
    """
    flags = flags or DpFlags()
    M, N = len(a), len(bn)
    bt = sig.btron
    if lw is None:
        lw, up = -3 * M, N
    W = up - lw + 6
    off = -lw + 2
    # Smith-Waterman local mode (-LS, algmode.lcl & 16; fwd2h1.cc:62,
    # 306-307): LocalL restarts at non-positive cells, LocalR tracks the
    # best mid-matrix diagonal improvement as the alignment end.
    local_l = flags.local and flags.a_exgl and flags.b_exgl
    local_r = flags.local and flags.a_exgr and flags.b_exgr
    loc_best = (NEVSEL, M, N)            # maxh (fwd2h1.cc:305)
    loc_lo, loc_hi = loc_bounds if loc_bounds is not None \
        else (1 << 30, -(1 << 30))

    dagp = prm.dagp
    n_nod = 5 if dagp else 3
    H = np.full(W, NEVSEL, dtype=np.int64)
    Hd = np.zeros(W, dtype=np.int32)
    Hp = np.zeros(W, dtype=np.int64)        # jnc bookkeeping not per-cell
    F = np.full(W, NEVSEL, dtype=np.int64)
    Fd = np.zeros(W, dtype=np.int32)
    F2 = np.full(W, NEVSEL, dtype=np.int64)
    F2d = np.zeros(W, dtype=np.int32)

    tb = TronTrace(hdir=np.full((M + 1, W), 255, np.uint8),
                   edir=np.zeros((M + 1, W), np.uint8),
                   fdir=np.zeros((M + 1, W), np.uint8),
                   spj=np.zeros((n_nod, M + 1, W), np.int32),
                   spj_phs=np.zeros((n_nod, M + 1, W), np.int8),
                   lw=lw,
                   e2dir=np.zeros((M + 1, W), np.uint8) if dagp else None,
                   f2dir=np.zeros((M + 1, W), np.uint8) if dagp else None)

    sigS = np.asarray(sig.sigS, dtype=np.int64)
    sigT = np.asarray(sig.sigT, dtype=np.int64)
    sigE = np.asarray(sig.sigE, dtype=np.int64)
    sig5 = np.asarray(sig.sig5, dtype=np.int64)
    phs5 = sig.phs5
    phs3 = sig.phs3
    t1, t2 = sig.spj_tron1, sig.spj_tron2
    d16 = sig.dinc5.astype(np.int64)
    d3 = sig.dinc3.astype(np.int64)

    def sigS_at(n):
        return int(sigS[n]) if 0 <= n < N else 0

    # ------------------------------------------------------ init row (m=0)
    # TransInit restarts only up to the anchor start (see tron_init_row)
    def s_bonus(n):
        return sigS_at(n) if n <= loc_lo + 4 else 0

    # the band need not hold the origin (a mapping window starts a margin
    # left of the gene, lw > 0): the top row is a recurrence along n from
    # the origin, so it is built on arrays widened to r >= -2 and the
    # band's slots r >= lw - 2 are copied out
    band = (H, Hd, off)
    if lw > 0:
        off = 2
        H = np.full(up + 6, NEVSEL, dtype=np.int64)
        Hd = np.zeros(up + 6, dtype=np.int32)
    hdir0 = {}
    r0 = 0
    H[r0 + off] = max(s_bonus(1), 0) if flags.a_exgl else 0
    Hd[r0 + off] = DEAD if flags.a_exgl else DIAG
    hdir0[r0] = Hd[r0 + off]
    if flags.a_exgl:
        jnc = [0, 0, 0]
        rr = min(up, N)
        for i, r in enumerate(range(r0 + 1, rr + 1), start=1):
            n = r
            if i < 3:
                H[r + off] = max(s_bonus(n + 1), 0)
                Hd[r + off] = DEAD
                jnc[i % 3] = n
            else:
                H[r + off] = H[r - 3 + off] + prm.gep
                Hd[r + off] = HORI
                if 0 <= n - 3 < N:
                    H[r + off] += int(sigE[n - 3])
                x = H[r - 1 + off] + prm.gap_w1
                if x > H[r + off]:
                    H[r + off] = x
                    Hd[r + off] = HOR1
                x = H[r - 2 + off] + prm.gap_w2
                if x > H[r + off]:
                    H[r + off] = x
                    Hd[r + off] = HOR2
            x = max(s_bonus(n + 1), 0)
            if H[r + off] < x:
                H[r + off] = x
                Hd[r + off] = DEAD
                jnc[i % 3] = n
            hdir0[r] = Hd[r + off]
    if lw > 0:
        (Hw, Hdw, offw), (H, Hd, off) = (H, Hd, off), band
        H[:] = Hw[lw - 2 + offw:up + 4 + offw]
        Hd[:] = Hdw[lw - 2 + offw:up + 4 + offw]
    for r, d in hdir0.items():
        if lw - 2 <= r <= up + 3:
            tb.hdir[0, r + off] = d
    # left column (r < 0): free query prefix (b_exgl default)
    rr = max(lw, -3 * M)
    for i, r in enumerate(range(r0 - 1, rr - 1, -1), start=1):
        if flags.b_exgl:
            H[r + off] = 0
            Hd[r + off] = DEAD
        else:
            H[r + off] = H[r + (3 if i > 3 else i) + off] + (
                prm.gep + (prm.gop if i <= 3 else 0)
                + (prm.extra_gop if i < 3 else 0) if i <= 3 else prm.gep)
            Hd[r + off] = VERT

    best = (NEVSEL, M, N)
    m0 = 1
    for m in range(m0, M + 1):
        qp0 = prm.qprof_mtx[a[m - 1]]
        qp1 = (prm.qprof_mtx[a[m]] if m < M else
               prm.qprof_mtx[a[m - 1]])
        n0 = max(3 * m + lw - 1, 0)
        n9 = min(3 * m + up, N)
        e_val = [np.int64(NEVSEL)] * 3          # rotating 3-frame E queue
        e_dir = [0] * 3
        e2_val = [np.int64(NEVSEL)] * 3         # long-insertion queue (dagp)
        e2_dir = [0] * 3
        cand = {-1: [], 0: [], 1: []}           # per-phase donor lists
        q = 0
        for n in range(n0, n9 + 1):
            r = n - 3 * m + off
            hq_val, hq_dir = H[r], Hd[r]        # (m-1, n-3) state
            # ---------------- diagonal
            if n < 3:
                H[r] = NEVSEL
                Hd[r] = DEAD
            else:
                H[r] = hq_val + int(qp0[bt[n - 2]]) + int(sigE[n - 2])
                Hd[r] = DIAG if hq_dir in _IS_DIAG else NEWD
            mx_val, mx_k = H[r], 0
            mx_dir = Hd[r]
            # ---------------- vertical states (source dir = the H cell's
            # winner dir decides frameshift open-vs-extend, fwd2h1.cc:383)
            y = F[r + 3] + prm.gep
            x = H[r + 1] + (prm.gap_e1 if (Hd[r + 1] & 15) in _IS_VERT
                            else prm.gap_w1)
            fdir_rec = 0
            if x > y:
                F[r] = x
                Fd[r] = SLA2
                fdir_rec = 0x80
            else:
                F[r] = y
                Fd[r] = VERT
            x = H[r + 2] + (prm.gap_e2 if (Hd[r + 2] & 15) in _IS_VERT
                            else prm.gap_w2)
            if x > F[r]:
                F[r] = x
                Fd[r] = SLA1
                fdir_rec = 0x80
            x = H[r + 3] + prm.gap_w3
            if x >= F[r]:
                F[r] = x
                Fd[r] = VERT
                fdir_rec = 0x80                  # opened from H
            elif y >= F[r]:
                F[r] = y
                Fd[r] = VERT
                fdir_rec = 0
            tb.fdir[m, r] = Fd[r] | fdir_rec
            if F[r] > mx_val:
                mx_val, mx_k, mx_dir = F[r], 2, Fd[r]
            # ---------------- long deletion F2 (dagp, fwd2h1.cc:413-425)
            if dagp:
                x = H[r + 3] + prm.gap_w3l
                y = F2[r + 3] + prm.lgep
                if x >= y:
                    F2[r] = x
                    F2d[r] = VERL
                    tb.f2dir[m, r] = VERL | 0x80
                else:
                    F2[r] = y
                    F2d[r] = F2d[r + 3]         # *f2 = f2[3]: keeps SPIN
                    tb.f2dir[m, r] = VERL
                if F2[r] > mx_val:
                    mx_val, mx_k, mx_dir = F2[r], 4, F2d[r]
            # ---------------- horizontal states (rotating 3-frame queue;
            # SPIN propagates from the source state, fwd2h1.cc:430-468)
            edir_rec = 0
            if n > n0 + 2:
                x = H[r - 3] + prm.gap_w3
                e_val[q] += prm.gep
                spin = e_dir[q] & SPIN
                if x > e_val[q]:
                    e_val[q] = x
                    spin = Hd[r - 3] & SPIN
                    edir_rec = 0x80
                e_val[q] += int(sigE[n - 2]) if n >= 2 else 0
                e_dir[q] = spin | HORI
                # long insertion E2 (dagp, fwd2h1.cc:439-448)
                if dagp:
                    x2 = H[r - 3] + prm.gap_w3l
                    e2_val[q] += prm.lgep
                    spin2 = e2_dir[q] & SPIN
                    e2rec = 0
                    if x2 > e2_val[q]:
                        e2_val[q] = x2
                        spin2 = Hd[r - 3] & SPIN
                        e2rec = 0x80
                    e2_val[q] += int(sigE[n - 2]) if n >= 2 else 0
                    e2_dir[q] = spin2 | HORL
                    tb.e2dir[m, r] = e2_dir[q] | e2rec
                    if e2_val[q] > mx_val:
                        mx_val, mx_k, mx_dir = e2_val[q], 3, e2_dir[q]
            if n > n0 + 1:
                x = H[r - 2] + prm.gap_w2
                if x > e_val[q]:
                    e_val[q] = x
                    e_dir[q] = (Hd[r - 2] & SPIN) | HOR2
                    edir_rec = 0x80
            x = H[r - 1] + prm.gap_w1
            if x > e_val[q]:
                e_val[q] = x
                e_dir[q] = (Hd[r - 1] & SPIN) | HOR1
                edir_rec = 0x80
            tb.edir[m, r] = e_dir[q] | edir_rec
            if e_val[q] > mx_val:
                mx_val, mx_k, mx_dir = e_val[q], 1, e_dir[q]
            qq = q
            q = (q + 1) % 3

            internal = spj and (not flags.a_exgr or m < M)
            # ---------------- acceptor closes
            if internal and 0 <= n < N and phs3[n] != -2:
                phases = [(-1 if phs3[n] == 2 else int(phs3[n]))]
                if phs3[n] == 2:
                    phases.append(1)
                for phs in phases:
                    nb = n - phs
                    closed = {}
                    for (cval, cjnc, cdir) in cand[phs]:
                        if phs == 1 and cdir == 2:
                            continue
                        if nb - cjnc < prm.intron_minl:
                            continue
                        x = (cval + int(ipen_tab[nb - cjnc])
                             + int(sig.sig53_ie53(cjnc, nb)))
                        if cdir == 0 and phs != 0:
                            w4 = int(16 * d3[cjnc] + d16[nb])
                            if phs == 1:
                                x += int(qp0[t1[w4]])
                            else:
                                x += (int(qp1[t2[w4]])
                                      - int(qp1[bt[n + 1]])
                                      - int(sigE[n + 1])) \
                                    if n + 1 < N else 0
                        cur = (H[r] if cdir == 0 else
                               e_val[qq] if cdir == 1 else
                               F[r] if cdir == 2 else
                               e2_val[qq] if cdir == 3 else F2[r])
                        if x > cur:
                            if cdir == 0:
                                H[r] = x
                            elif cdir == 1:
                                e_val[qq] = np.int64(x)
                            elif cdir == 2:
                                F[r] = x
                            elif cdir == 3:
                                e2_val[qq] = np.int64(x)
                            else:
                                F2[r] = x
                            closed[cdir] = (cjnc, phs)
                    for cdir, (cjnc, cphs) in closed.items():
                        if cdir == 0:
                            Hd[r] = DIAG | SPIN
                        elif cdir == 1:
                            e_dir[qq] = HORI | SPIN
                        elif cdir == 2:
                            Fd[r] = VERT | SPIN
                        elif cdir == 3:
                            e2_dir[qq] = HORL | SPIN
                        else:
                            F2d[r] = VERL | SPIN
                        tb.spj[cdir, m, r] = cjnc + 1
                        tb.spj_phs[cdir, m, r] = cphs
                        v = (H[r] if cdir == 0 else
                             e_val[qq] if cdir == 1 else
                             F[r] if cdir == 2 else
                             e2_val[qq] if cdir == 3 else F2[r])
                        if v > mx_val:
                            mx_val, mx_k = v, cdir
                            mx_dir = (Hd[r] if cdir == 0 else
                                      e_dir[qq] if cdir == 1 else
                                      Fd[r] if cdir == 2 else
                                      e2_dir[qq] if cdir == 3 else F2d[r])

            # ---------------- winner into H
            if mx_k != 0:
                H[r] = mx_val
                Hd[r] = mx_dir
            # dirs fit 5 bits (<= HORL | SPIN = 27); winner node in 5-7
            tb.hdir[m, r] = (Hd[r] & 0x1F) | (mx_k << 5)
            # Local mode (fwd2h1.cc:514-526): track maxh on improving
            # diagonal wins; clamp non-positive cells to a fresh start
            if flags.local:
                if mx_k == 0 and H[r] > hq_val:
                    start_case = (local_l and hq_dir == DEAD
                                  and not (Hd[r] & SPIN))
                    if (not start_case and local_r and n >= loc_hi
                            and H[r] > loc_best[0]):
                        loc_best = (int(H[r]), m, n)
                if local_l and n <= loc_lo and H[r] <= 0:
                    H[r] = 0
                    Hd[r] = DEAD
                    tb.hdir[m, r] = 0
                    tb.spj[0, m, r] = 0      # stale close would mislead
                    if mx_k == 0:
                        mx_val, mx_dir = 0, DEAD

            # ---------------- donor pushes
            if internal and 0 <= n < N and phs5[n] != -2:
                phases = [(-1 if phs5[n] == 2 else int(phs5[n]))]
                if phs5[n] == 2:
                    phases.append(1)
                for phs in phases:
                    nb = n - phs
                    if not (0 <= nb < N):
                        continue
                    sigJ = int(sig5[nb])
                    hd = DIR2NOD.get(mx_dir & 15, -1)
                    k_start = 0 if (hd == 0 or phs == 1) else 1
                    for k in range(k_start, (5 if dagp else 3)):
                        crossspj = (phs == 1 and k == 0)
                        if crossspj:
                            fv, fdir = hq_val, hq_dir
                        else:
                            fv = (H[r] if k == 0 else
                                  e_val[qq] if k == 1 else
                                  F[r] if k == 2 else
                                  e2_val[qq] if k == 3 else F2[r])
                            fdir = (Hd[r] if k == 0 else
                                    e_dir[qq] if k == 1 else
                                    Fd[r] if k == 2 else
                                    e2_dir[qq] if k == 3 else F2d[r])
                        if fdir == DEAD or (fdir & SPIN):
                            continue
                        if not crossspj and k != hd and hd >= 0:
                            z = mx_val
                            if hd == 0 or (k - hd) % 2:
                                z += (0, prm.gop, prm.lgop)[k // 2]
                            if fv <= z:
                                continue
                        x = int(fv) + sigJ
                        lst = cand[phs]
                        if len(lst) < NCAND:
                            lst.append((x, nb, k))
                            lst.sort(key=lambda c: -c[0])
                        elif x >= lst[-1][0]:
                            lst[-1] = (x, nb, k)
                            lst.sort(key=lambda c: -c[0])

        # track best end on this row for semi-global
        del e_val

    # ------------------------------------------------------------- last row
    # LocalR: a mid-matrix best end wins unless it sits on the last row
    # (fwd2h1.cc:608-613)
    if local_r and loc_best[0] > NEVSEL and loc_best[1] != M:
        return int(loc_best[0]), loc_best[1], loc_best[2], tb
    # The corner (M, N) may lie outside the band (then NEVSEL).
    r9 = N - 3 * M
    best_val = H[r9 + off] if lw - 2 <= r9 <= up + 3 else NEVSEL
    best_m, best_n = M, N
    if flags.a_exgr:
        # simplified lastH: max over last-row cells and sigT-terminated ends
        glen = 0
        for r in range(max(lw, -3 * M), min(up, N - 3 * 1) + 1):
            n = r + 3 * M
            if n < 0 or n > N:
                continue
            v = H[r + off]
            if 0 <= n - 2 < N and r - 3 >= lw:
                vt = H[r - 3 + off] + int(sigT[n - 2])
                if sigT[n - 2] > 0 and vt > v:
                    v = vt
            if v > best_val:
                best_val, best_m, best_n = v, M, n
    if flags.b_exgr:
        for r in range(max(r9 + 1, lw - 2), min(up, N) + 1):
            mm = (N - r) // 3
            if (N - r) % 3 == 0 and 1 <= mm < M:
                if H[r + off] > best_val:
                    best_val, best_m, best_n = H[r + off], mm, N
    return int(best_val), best_m, best_n, tb


def traceback_tron_ref(tb: TronTrace, end_m: int, end_n: int,
                       guard: int = 10_000_000):
    """Walk the tron traceback.  Ops:
      ('D', m, n)        codon match (a[m-1] x codon ending at n)
      ('E', m, n, w)     genome insertion of w nt (3/2/1)
      ('F', m, n, w)     aa deletion vs w nt (0/1/2 consumed)
      ('I', m, n5, n3, phs) intron
    """
    ops = []
    m, n = end_m, end_n
    state = 0
    steps = 0
    while steps < guard and m > 0 and n > 0:
        steps += 1
        r = tb.ri(m, n)
        if state == 0:
            hd = tb.hdir[m, r]
            if hd == 255:
                break
            winner = (hd >> 5) & 7
            if winner != 0:
                state = winner
                continue
            jnc = int(tb.spj[0, m, r])
            if jnc:
                # donor boundary nb5 = jnc-1, acceptor nb3 = n - phs
                phs = int(tb.spj_phs[0, m, r])
                nb5, nb3 = jnc - 1, n - phs
                ops.append(('I', m, nb5, nb3, phs))
                if phs == 0:
                    n = nb5                      # continue (m, donor cell)
                elif phs == 1:
                    # crossspj: junction codon consumed across the intron
                    ops.append(('D', m, n))
                    m, n = m - 1, nb5 + 1 - 3
                else:                            # phs == -1
                    n = nb5 - 1                  # donor cell = nb5 + phs
                continue
            if (hd & 15) == DEAD:
                break
            ops.append(('D', m, n))
            m, n = m - 1, n - 3
            continue
        if state in (1, 3):
            jnc = int(tb.spj[state, m, r])
            if jnc:
                phs = int(tb.spj_phs[state, m, r])
                ops.append(('I', m, jnc - 1, n - phs, phs))
                n = jnc - 1 + phs
                continue
            ed = (tb.edir if state == 1 else tb.e2dir)[m, r]
            base = ed & 15
            opened = bool(ed & 0x80)
            w = {HORI: 3, HOR2: 2, HOR1: 1, HORL: 3}.get(base, 3)
            ops.append(('E', m, n, w))
            n -= w
            if opened:
                state = 0
            continue
        jnc = int(tb.spj[state, m, r])
        if jnc:
            phs = int(tb.spj_phs[state, m, r])
            ops.append(('I', m, jnc - 1, n - phs, phs))
            n = jnc - 1 + phs
            continue
        fd = (tb.fdir if state == 2 else tb.f2dir)[m, r]
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
