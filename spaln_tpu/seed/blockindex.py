"""Genome block index: build + query (MakeBlk / SrchBlk re-design).

The reference's phase-A mapper (blksrc.cc) cuts the genome into blocks of
``blklen`` and stores, per k-mer, the sorted list of blocks containing it
(CSR).  Queries vote for blocks with per-word information scores; paired
left/right votes become candidate gene ranges.

Array-first re-design: the index is two flat int arrays (CSR offsets +
block ids) plus an int16 word-score table — mmap-able, shardable by k-mer
range across hosts, and gatherable on device.  Auto-sizing follows the
reference's formulas (blksrc.cc:678-737): blklen ~ sqrt(genome), capped
64k; k = 0.59 ln(genome), capped 16 (practical cap 13 here so the LUT
stays  < 1GB); MaxGene = 38 sqrt(genome), min 16k.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np

from ..constants import AA_REDUCE20, NT_REDUCE4
from ..seq.codec import comrev, translate
from ..seq.genome import GenomeStore
from ..utils.metrics import metrics
from .wilip import _kmer_words


def _aa_reduce(nalpha: int) -> np.ndarray:
    """aa-code -> reduced-class table (ReducWord; 20 = identity map)."""
    if nalpha == 20:
        return AA_REDUCE20
    from .reduc import reduc_table
    tab, _ = reduc_table(nalpha)
    return tab.astype(np.int64)


def auto_params(glen: int) -> dict:
    # blklen = sqrt(genome) rounded UP to a 1024 multiple
    # (blksrc.cc:692-695) — the rounding matters: block boundaries set
    # the phase-A candidate-range edges, which bound the terminal-exon
    # search windows (measured against the reference's windows)
    blklen = min((int(math.sqrt(glen)) // 1024 + 1) * 1024, 65536)
    k = min(int(0.59 * math.log(max(glen, 100))), 13)
    k = max(k, 4)
    maxgene = max(int(38 * math.sqrt(glen) / 1024 + 1) * 1024, 16384)
    # protein index k-mer (aa words): 0.36 ln(gnmsz) capped 6
    # (blksrc.cc:678-737)
    kp = max(min(int(0.36 * math.log(max(glen, 100))), 6), 3)
    return {"blklen": blklen, "k": k, "kp": kp, "maxgene": maxgene}


@dataclass
class BlockIndex:
    k: int
    blklen: int
    maxgene: int
    offsets: np.ndarray      # (4^k + 1,) int64 CSR offsets
    blocks: np.ndarray       # (nnz,) int32 block ids per word
    wscr: np.ndarray         # (4^k,) int16 word scores
    n_blocks: int
    glen: int
    cbounds: np.ndarray | None = None   # contig starts + glen sentinel
    nalpha: int = 20         # protein reduced-alphabet size (ReducWord)

    def _contig_clamp(self, g0: int, g1: int, peak: int
                      ) -> tuple[int, int]:
        """Clamp a candidate range to the contig containing the vote
        peak — a BPAIR never crosses chromosome bounds (zl/zr,
        blksrc.cc:2637-2638)."""
        if self.cbounds is None or len(self.cbounds) <= 2:
            return g0, g1
        ci = int(np.searchsorted(self.cbounds, peak, side="right")) - 1
        ci = min(max(ci, 0), len(self.cbounds) - 2)
        return (max(g0, int(self.cbounds[ci])),
                min(g1, int(self.cbounds[ci + 1])))

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, store: GenomeStore, k: int | None = None,
              blklen: int | None = None,
              max_word_freq: float = 1e-3) -> "BlockIndex":
        glen = len(store.codes)
        p = auto_params(store.total_len or glen)
        k = k or p["k"]
        blklen = blklen or p["blklen"]
        red = NT_REDUCE4[np.asarray(store.codes, dtype=np.int64)]
        nwords = 4 ** k
        n_blocks = glen // blklen + 1
        native = None
        try:                        # parallel C++ two-pass CSR builder
            from ..native import kmer_csr_native
            native = kmer_csr_native(red, k, blklen)
        except Exception:
            native = None
        words, ok = _kmer_words(red, k)
        pos = np.nonzero(ok)[0]
        w = words[pos]
        metrics.bump("index_builds_native" if native is not None
                     else "index_builds_numpy")
        if native is not None:
            offsets, ub = native
        else:
            blk = (pos // blklen).astype(np.int32)
            # unique (word, block) pairs -> CSR by word
            key = w * np.int64(n_blocks) + blk
            key = np.unique(key)
            uw = (key // n_blocks).astype(np.int64)
            ub = (key % n_blocks).astype(np.int32)
            counts = np.bincount(uw, minlength=nwords)
            offsets = np.zeros(nwords + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
        # word scores (blkscrtab, blksrc.cc:944-998): information
        # content wscr = TFACTOR*(ln(segn) - ln(tcount)); the abundance
        # floor MinScr = -TFACTOR*ln(afact*blklen/m) clamps low-info
        # words to MinScr AND drops their block lists from the search
        # (the toomany model).  SPALN_WSCR=legacy restores the round-4
        # -log2-frequency model for comparison.
        import os
        total_hits = np.bincount(w % nwords, minlength=nwords)
        gsize = max(len(pos), 1)
        if os.environ.get("SPALN_WSCR", "") == "legacy":
            pw = np.maximum(total_hits / gsize, 1e-12)
            wscr = np.minimum(-np.log2(pw) * 4, 120).astype(np.int16)
            wscr[total_hits > max_word_freq * gsize] = 0
        else:
            TFACTOR, AFACT = 100.0, 10.0       # blksrc.cc:29, wcp afact
            present = total_hits > 0
            mwords = int(present.sum())
            wscr_f = np.zeros(nwords)
            wscr_f[present] = TFACTOR * (np.log(gsize)
                                         - np.log(total_hits[present]))
            minscr = max(0.0, -TFACTOR * np.log(
                AFACT * blklen / max(mwords, 1)))
            dropped = present & (wscr_f <= minscr)
            wscr = np.where(present, np.maximum(wscr_f, minscr),
                            -1).astype(np.int16)
            if dropped.any():
                # excise dropped words' postings from the CSR (span
                # delete via +1/-1 boundary marks — no per-entry
                # word-id expansion over ~1e8 postings)
                di = np.nonzero(dropped)[0]
                marks = np.zeros(len(ub) + 1, np.int64)
                np.add.at(marks, offsets[di], 1)
                np.add.at(marks, offsets[di + 1], -1)
                keep = np.cumsum(marks[:-1]) == 0
                ub = ub[keep]
                counts = np.diff(offsets)
                counts[di] = 0
                offsets = np.zeros(nwords + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
        cbounds = np.append(store.offsets, glen).astype(np.int64)
        return cls(k=k, blklen=blklen, maxgene=p["maxgene"],
                   offsets=offsets, blocks=ub, wscr=wscr,
                   n_blocks=n_blocks, glen=glen, cbounds=cbounds)

    # ----------------------------------------------------------- persistence
    def save(self, prefix: str) -> None:
        np.savez(prefix + ".bkn.npz", offsets=self.offsets,
                 blocks=self.blocks, wscr=self.wscr,
                 cbounds=(self.cbounds if self.cbounds is not None
                          else np.array([0, self.glen], dtype=np.int64)),
                 meta=np.array([self.k, self.blklen, self.maxgene,
                                self.n_blocks, self.glen], dtype=np.int64))

    @classmethod
    def load(cls, prefix: str) -> "BlockIndex":
        z = np.load(prefix + ".bkn.npz")
        k, blklen, maxgene, n_blocks, glen = z["meta"].tolist()
        return cls(k=int(k), blklen=int(blklen), maxgene=int(maxgene),
                   offsets=z["offsets"], blocks=z["blocks"],
                   wscr=z["wscr"], n_blocks=int(n_blocks), glen=int(glen),
                   cbounds=z["cbounds"] if "cbounds" in z else None)

    # --------------------------------------------------------------- search
    def _query_words(self, query: np.ndarray) -> np.ndarray:
        red = NT_REDUCE4[np.asarray(query, dtype=np.int64)]
        words, ok = _kmer_words(red, self.k)
        return words[ok]

    def _query_words_pos(self, query: np.ndarray):
        red = NT_REDUCE4[np.asarray(query, dtype=np.int64)]
        words, ok = _kmer_words(red, self.k)
        pos = np.nonzero(ok)[0]
        return words[pos], pos

    def _qspan_blocks(self, query: np.ndarray) -> int:
        return max(self._q_nt_len(query) // self.blklen, 1)

    def _q_nt_len(self, query: np.ndarray) -> int:
        return len(query)

    # Randbs random-match score model (blksrc.h:388-390, ctor
    # blksrc.cc:2047-2062): expected best random consecutive-hit chain
    # after mmc failed scan cycles ~ RbsFact*avr*ln(mmc+1) + RbsBase*avr
    # for a genome DB; a block pair must additionally clear Phase1T =
    # RbsBias*avr (TestOutput, blksrc.cc:2680-2683).  avr is the index's
    # mean informative word score, so the thresholds are calibrated to
    # whatever scoring the index was built with.
    RBS_FACT = 0.4               # RbsFactLog
    RBS_BASE = 3.0               # RbsBase
    RBS_BIAS = 3.0               # RbsBias

    @property
    def avr_wscr(self) -> float:
        # cached: rescanning the 4^k-entry score table per query was a
        # measured hot spot of candidate_ranges
        cached = getattr(self, "_avr_wscr", None)
        if cached is None:
            pos = self.wscr[self.wscr > 0]
            cached = float(pos.mean()) if len(pos) else 1.0
            object.__setattr__(self, "_avr_wscr", cached)
        return cached

    def randbs(self, mmc: int) -> float:
        return (self.RBS_FACT * math.log(mmc + 1)
                + self.RBS_BASE) * self.avr_wscr

    @staticmethod
    def _ragged_arange(lo: np.ndarray, cnt: np.ndarray) -> np.ndarray:
        """Vectorized concatenate([arange(l, l+c) ...]) — no Python loop
        over query words (the loop was the measured votes/s bottleneck)."""
        total = int(cnt.sum())
        ends = np.cumsum(cnt)
        # cumsum of per-element deltas: +1 within a segment, and at each
        # segment boundary a jump from (lo[i-1]+cnt[i-1]-1) to lo[i]
        delta = np.ones(total, dtype=np.int64)
        delta[ends[:-1]] = lo[1:] - (lo[:-1] + cnt[:-1]) + 1
        delta[0] = lo[0]
        return np.cumsum(delta)

    def _hit_stream(self, query: np.ndarray):
        """All (word position, block, word score) hits of the query
        plus the position count — the vectorized equivalent of the
        4-direction scanning loop's raw lookups (Qwords::querywords +
        next_mrglist, blksrc.cc:2890-2969)."""
        w, pos = self._query_words_pos(query)
        if not len(w):
            return None
        lo = self.offsets[w]
        hi = self.offsets[w + 1]
        cnt = (hi - lo).astype(np.int64)
        has = cnt > 0
        if not has.any():
            return None
        idx = self._ragged_arange(lo[has].astype(np.int64), cnt[has])
        blk = self.blocks[idx].astype(np.int64)
        cyc = np.repeat(pos[has], cnt[has]).astype(np.int64)
        ws = np.repeat(self.wscr[w[has]].astype(np.int64), cnt[has])
        return cyc, blk, ws, int(pos[-1]) + 1 if len(pos) else 0

    def vote(self, query: np.ndarray) -> np.ndarray:
        """Per-block vote score for one query (findblock's bscr tallies,
        blksrc.cc:2971-3087, collapsed to a single whole-query tally —
        the left/right pairing is handled by candidate_ranges)."""
        w = self._query_words(query)
        if not len(w):
            return np.zeros(self.n_blocks, dtype=np.int64)
        lo = self.offsets[w]
        hi = self.offsets[w + 1]
        cnt = (hi - lo).astype(np.int64)
        has = cnt > 0
        if not has.any():
            return np.zeros(self.n_blocks, dtype=np.int64)
        scores = self.wscr[w[has]].astype(np.int64)
        idx = self._ragged_arange(lo[has].astype(np.int64), cnt[has])
        rep_score = np.repeat(scores, cnt[has])
        return np.bincount(self.blocks[idx], weights=rep_score,
                           minlength=self.n_blocks).astype(np.int64)

    def candidate_ranges(self, query: np.ndarray, ncand: int = 10
                         ) -> list[tuple[int, int, float]]:
        """Calibrated two-end block voting -> candidate gene ranges
        [(g0, g1, score)].

        The findblock/TestOutput machinery (blksrc.cc:2971-3087,
        2605-2703) vectorized: hits are run-gated (a hit counts when the
        same block, or a neighbor, was also hit at an adjacent query
        word — the consecutive-hit rule of the 4-tally scan), tallied
        separately for the query's left and right halves (the two-end
        inward scan's meet-in-the-middle limit), thresholded with the
        Randbs random-match model per side, paired left-block/right-
        block into BPAIRs within MaxGene on one contig, extended across
        vote-positive neighbor blocks, and accepted when the pair's
        summed votes clear randbs(mmcL + mmcR) + Phase1T.  Falls back to
        the best unpaired candidate when nothing is significant
        (TestOutput force semantics)."""
        hs = self._hit_stream(query)
        if hs is None:
            return []
        cyc, blk, ws, ncyc = hs
        NB = self.n_blocks
        half = ncyc // 2
        W64 = (NB + 2 + 63) >> 6
        if ncyc * W64 * 8 <= (1 << 26):
            # bit-packed presence gate: one uint64 word covers 64
            # blocks, so the (positions x blocks) presence matrix and
            # its +-1-block / +-1-position dilation are 64x less memory
            # traffic than the boolean matrix it replaces (the bool
            # version streamed ~80 MB/query at genome scale and capped
            # the index bench below 200 votes/s).  Neighbor blocks are
            # bit shifts with cross-word carry; neighbor positions are
            # row gathers at cyc and cyc+2.  The buffer is cached on
            # the index and cleared sparsely (touched words only)
            buf = getattr(self, "_gate_buf", None)
            if buf is None or buf[0].shape[0] < ncyc + 2 \
                    or buf[0].shape[1] != W64:
                rows = max(ncyc + 2, 1024)
                buf = (np.zeros((rows, W64), dtype=np.uint64),
                       np.empty((rows, W64), dtype=np.uint64),
                       np.empty((rows, W64), dtype=np.uint64))
                object.__setattr__(self, "_gate_buf", buf)
            H = buf[0][:ncyc + 2]
            sd = buf[1][:ncyc + 2]                       # scratch: no
            su = buf[2][:ncyc + 2]                       # per-query alloc
            col = blk + 1
            wi = col >> 6
            bit = (np.uint64(1) << (col & 63).astype(np.uint64))
            np.bitwise_or.at(H, (cyc + 1, wi), bit)
            np.right_shift(H, np.uint64(1), out=sd)      # col+1 -> bit p
            sd[:, :-1] |= H[:, 1:] << np.uint64(63)
            np.left_shift(H, np.uint64(1), out=su)       # col-1 -> bit p
            su[:, 1:] |= H[:, :-1] >> np.uint64(63)
            sd |= su                                     # +-1 block
            sd |= H
            gate = sd[:-2] | sd[2:]                      # +-1 position
            run = (gate[cyc, wi] & bit) != 0
            H[cyc + 1, wi] = 0                           # sparse clear
            rn = np.flatnonzero(run)
            blkr = blk[rn]
            # one fused bincount: right-half hits keyed at blk + NB
            key = blkr + np.where(cyc[rn] < half, 0, NB)
            both = np.bincount(key, weights=ws[rn], minlength=2 * NB)
            bl, br = both[:NB], both[NB:]
            run_cyc = np.zeros(ncyc + 1, dtype=bool)
            run_cyc[cyc[rn]] = True
        else:
            # sorted-probe fallback for huge query x block products
            key = np.sort(cyc * NB + blk)
            run = np.zeros(len(blk), dtype=bool)
            for dc in (-1, 1):
                for db in (-1, 0, 1):
                    probe = (cyc + dc) * NB + blk + db
                    j = np.searchsorted(key, probe)
                    j = np.clip(j, 0, len(key) - 1)
                    run |= key[j] == probe
            left = cyc < half
            bl = np.bincount(blk[run & left], weights=ws[run & left],
                             minlength=NB)
            br = np.bincount(blk[run & ~left], weights=ws[run & ~left],
                             minlength=NB)
            run_cyc = np.zeros(ncyc + 1, dtype=bool)
            run_cyc[cyc[run]] = True
        # mmc: failed scan cycles per side, on the reference's
        # Nshift(=k)-step grid (nmmc role)
        step = max(self.k, 1)
        hitc = np.zeros(ncyc + 1, dtype=bool)
        hitc[:len(run_cyc)] = run_cyc
        grid = np.arange(0, ncyc, step)
        gh = hitc[grid]
        mmc_l = int((~gh[grid < half]).sum())
        mmc_r = int((~gh[grid >= half]).sum())
        thr_l, thr_r = self.randbs(mmc_l), self.randbs(mmc_r)
        sig_l = np.nonzero(bl >= thr_l)[0]
        sig_r = np.nonzero(br >= thr_r)[0]
        ncap = max(ncand, 10) + 2      # Ncand = MaxOut + NCAND2PHS role
        if len(sig_l) > ncap:
            sig_l = np.sort(sig_l[np.argsort(bl[sig_l])[::-1][:ncap]])
        if len(sig_r) > ncap:
            sig_r = np.sort(sig_r[np.argsort(br[sig_r])[::-1][:ncap]])
        pair_thr = self.randbs(mmc_l + mmc_r) + self.RBS_BIAS * \
            self.avr_wscr
        bsum = bl + br
        max_blocks = max(self.maxgene // self.blklen, 1) + 1
        qspan = self._qspan_blocks(query)
        ext = min(max_blocks,
                  max(2 * qspan + 2,
                      2 * self._q_nt_len(query) // self.blklen + 2))
        # pair left-significant with the nearest right-significant block
        # downstream on the same contig (extract_to_work/BPAIR); each
        # side's singletons are kept as degenerate pairs.  A pair is
        # scored lscr + rscr of its two END blocks (TestOutput bpr->scr,
        # blksrc.cc:2680) — NOT the sum over the spanned window, which
        # would reward wide spurious pairs over the true narrow locus
        cand: list[tuple[int, int]] = []
        for p in sig_l:
            qs = sig_r[(sig_r >= p)
                       & (sig_r <= p + max_blocks)]
            cand.append((int(p), int(qs[0]) if len(qs) else int(p)))
        for q_ in sig_r:
            if not any(a <= q_ <= b for a, b in cand):
                cand.append((int(q_), int(q_)))
        # extend bounds (not the score) across vote-positive neighbors
        # (ExtBlock widening, blksrc.cc:2645-2661): nearest zero-vote
        # block on each side, precomputed once by running extrema
        idx = np.arange(NB)
        zb = bsum <= 0
        prev_zero = np.maximum.accumulate(np.where(zb, idx, -1))
        next_zero = np.minimum.accumulate(np.where(zb, idx, NB)[::-1])[::-1]
        scored: list[tuple[float, int, int]] = []
        for lb0, rb0 in cand:
            sc = float(bl[lb0] + br[rb0]) if lb0 != rb0 \
                else float(bsum[lb0])
            lb = max(int(prev_zero[lb0 - 1]) + 1, lb0 - ext, 0) \
                if lb0 > 0 else 0
            rb = min(int(next_zero[rb0 + 1]) - 1, rb0 + ext, NB - 1) \
                if rb0 < NB - 1 else rb0
            scored.append((sc, min(lb, lb0), max(rb, rb0)))
        scored.sort(key=lambda c: -c[0])
        passing = [c for c in scored if c[0] >= pair_thr]
        if not passing and scored:
            passing = scored[:1]           # force path (TestOutput(1))
        out: list[tuple[int, int, float]] = []
        for sc, lb, rb in passing:
            if len(out) >= ncand:
                break
            b0 = max(lb - ext, 0)
            b1 = min(rb + ext + 1, NB)
            g0 = max(b0 * self.blklen - self.blklen, 0)
            g1 = min(b1 * self.blklen + self.blklen, self.glen)
            peak = min(((lb + rb) // 2) * self.blklen
                       + self.blklen // 2, self.glen - 1)
            g0, g1 = self._contig_clamp(g0, g1, peak)
            if any(not (g1 <= o0 or g0 >= o1) for o0, o1, _ in out):
                continue                   # overlap dedup
            out.append((g0, g1, sc))
        return out


class ProteinBlockIndex(BlockIndex):
    """Protein-query genome index (-KP): 6-frame translated reduced-aa
    k-mers -> genomic block lists (MakeBlk aa/tron path, blksrc.cc:
    466-531 c2w6 over 6 frames; ORF filter omitted — repetitive-word
    capping plays its role here).

    Blocks are nt-coordinate blocks of the forward strand, so candidate
    ranges work for genes on either strand (reverse-frame k-mer positions
    map back to forward coordinates before block assignment).
    """
    NALPHA = 20

    @classmethod
    def build(cls, store: GenomeStore, k: int | None = None,
              blklen: int | None = None,
              max_word_freq: float = 2e-3,
              nalpha: int = 20, min_orf: int = 30
              ) -> "ProteinBlockIndex":
        # nalpha selects the reduced alphabet (ReducWord/DefConvPat,
        # bitpat.cc:25-90): 20 = one class per aa (default .bka),
        # 6 = SEB6 for higher seed sensitivity on diverged proteins
        glen = len(store.codes)
        p = auto_params(store.total_len or glen)
        if k is None and nalpha <= 8:
            k = min(p["kp"] + 2, 8)      # smaller alphabet, longer tuple
        k = k or p["kp"]
        blklen = blklen or p["blklen"]
        na = nalpha
        codes = np.asarray(store.codes)
        pairs = []
        for strand in range(2):
            seq = codes if strand == 0 else comrev(codes)
            for frame in range(3):
                aa = translate(seq, frame)
                red = _aa_reduce(nalpha)[aa.astype(np.int64)]
                valid = (red >= 0) & (red < na)
                if min_orf > 0:
                    # ORF filter (MinOrf, blksrc.cc:70,483-510): words
                    # must lie in a stop-free frame segment of at least
                    # min_orf nt — 6-frame junk between stops never
                    # enters the index
                    from ..constants import TRM, TRM2
                    stop = (aa == TRM) | (aa == TRM2)
                    seg = np.cumsum(stop)
                    seglen = np.bincount(seg, minlength=seg[-1] + 1
                                         if len(seg) else 1)
                    valid &= seglen[seg] >= max(min_orf // 3, 1)
                L = len(red)
                if L < k:
                    continue
                w = np.zeros(L - k + 1, dtype=np.int64)
                ok = np.ones(L - k + 1, dtype=bool)
                for i in range(k):
                    w = w * na + np.clip(red[i:L - k + 1 + i], 0, na - 1)
                    ok &= valid[i:L - k + 1 + i]
                pos_aa = np.nonzero(ok)[0]
                nt = 3 * pos_aa + frame               # frame-local nt pos
                if strand == 1:
                    nt = glen - nt - 3 * k            # map to fwd coords
                blk = np.clip(nt // blklen, 0, glen // blklen)
                pairs.append((w[pos_aa], blk.astype(np.int32)))
        n_blocks = glen // blklen + 1
        if pairs:
            w_all = np.concatenate([p_[0] for p_ in pairs])
            b_all = np.concatenate([p_[1] for p_ in pairs])
        else:
            w_all = np.zeros(0, np.int64)
            b_all = np.zeros(0, np.int32)
        key = np.unique(w_all * np.int64(n_blocks) + b_all)
        uw = (key // n_blocks).astype(np.int64)
        ub = (key % n_blocks).astype(np.int32)
        nwords = na ** k
        counts = np.bincount(uw, minlength=nwords)
        offsets = np.zeros(nwords + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total_hits = np.bincount(w_all, minlength=nwords)
        gsize = max(len(w_all), 1)
        pw = np.maximum(total_hits / gsize, 1e-12)
        wscr = np.minimum(-np.log2(pw) * 4, 120).astype(np.int16)
        wscr[total_hits > max_word_freq * gsize] = 0
        cbounds = np.append(store.offsets, glen).astype(np.int64)
        return cls(k=k, blklen=blklen, maxgene=p["maxgene"],
                   offsets=offsets, blocks=ub, wscr=wscr,
                   n_blocks=n_blocks, glen=glen, cbounds=cbounds,
                   nalpha=nalpha)

    def save(self, prefix: str) -> None:
        np.savez(prefix + ".bkp.npz", offsets=self.offsets,
                 blocks=self.blocks, wscr=self.wscr,
                 cbounds=(self.cbounds if self.cbounds is not None
                          else np.array([0, self.glen], dtype=np.int64)),
                 meta=np.array([self.k, self.blklen, self.maxgene,
                                self.n_blocks, self.glen, self.nalpha],
                               dtype=np.int64))

    @classmethod
    def load(cls, prefix: str) -> "ProteinBlockIndex":
        z = np.load(prefix + ".bkp.npz")
        meta = z["meta"].tolist()
        k, blklen, maxgene, n_blocks, glen = meta[:5]
        nalpha = meta[5] if len(meta) > 5 else 20
        return cls(k=int(k), blklen=int(blklen), maxgene=int(maxgene),
                   offsets=z["offsets"], blocks=z["blocks"],
                   wscr=z["wscr"], n_blocks=int(n_blocks), glen=int(glen),
                   cbounds=z["cbounds"] if "cbounds" in z else None,
                   nalpha=int(nalpha))

    def _query_words(self, query: np.ndarray) -> np.ndarray:
        return self._query_words_pos(query)[0]

    def _query_words_pos(self, query: np.ndarray):
        red = _aa_reduce(self.nalpha)[np.asarray(query, dtype=np.int64)]
        na, k = self.nalpha, self.k
        valid = (red >= 0) & (red < na)
        L = len(red)
        if L < k:
            z = np.zeros(0, np.int64)
            return z, z
        w = np.zeros(L - k + 1, dtype=np.int64)
        ok = np.ones(L - k + 1, dtype=bool)
        for i in range(k):
            w = w * na + np.clip(red[i:L - k + 1 + i], 0, na - 1)
            ok &= valid[i:L - k + 1 + i]
        pos = np.nonzero(ok)[0]
        return w[pos], pos

    def _q_nt_len(self, query: np.ndarray) -> int:
        return 3 * len(query)
