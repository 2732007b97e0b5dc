"""Index-build + block-vote throughput at genome scale.

An index-build and votes/s benchmark at >=100 Mb genome scale
(SrchBlk/MakeBlk role), on the host.  Builds a synthetic
genome of the requested size (random 45% GC with planted gene-like
structure every ~50 kb so votes have real targets), times
BlockIndex.build (native C++ builder when available) and
candidate_ranges over a query batch, and prints one JSON line.

Usage: python scripts/bench_index.py [--mb 100] [--queries 200]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=100.0)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--qlen", type=int, default=500)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)

    from spaln_tpu.seed.blockindex import BlockIndex
    from spaln_tpu.seq.genome import GenomeStore
    from spaln_tpu.seq.fasta import SeqRecord
    from spaln_tpu.constants import DNA

    rng = np.random.default_rng(a.seed)
    glen = int(a.mb * 1e6)
    n_contigs = max(int(a.mb // 15), 1)
    per = glen // n_contigs
    recs = []
    t0 = time.time()
    for ci in range(n_contigs):
        codes = rng.integers(2, 10, size=per).astype(np.int8)
        # only the 4 unambiguous bases (codec codes 2,4,6,8-ish differ;
        # draw uniform over the nt code points for A/C/G/T)
        codes = np.array([2, 3, 5, 9], dtype=np.int8)[
            rng.integers(0, 4, size=per)]
        recs.append(SeqRecord(name=f"c{ci}", codes=codes, molc=DNA))
    t_gen = time.time() - t0

    store = GenomeStore.from_records(recs)
    t0 = time.time()
    idx = BlockIndex.build(store)
    t_build = time.time() - t0
    idx_bytes = (idx.offsets.nbytes + idx.blocks.nbytes
                 + idx.wscr.nbytes)

    # queries: exact substrings (planted hits) at random positions
    queries = []
    for _ in range(a.queries):
        p = int(rng.integers(0, store.total_len - a.qlen))
        queries.append(np.asarray(store.window(p, p + a.qlen)))
    t0 = time.time()
    hits = 0
    for q in queries:
        if idx.candidate_ranges(q, ncand=4):
            hits += 1
    t_vote = time.time() - t0

    print(json.dumps({
        "genome_mb": round(glen / 1e6, 1),
        "contigs": n_contigs,
        "k": idx.k,
        "blklen": idx.blklen,
        "build_seconds": round(t_build, 2),
        "index_mb": round(idx_bytes / 1e6, 1),
        "votes_per_second": round(a.queries / max(t_vote, 1e-9), 1),
        "query_recall": round(hits / max(a.queries, 1), 4),
        "gen_seconds": round(t_gen, 2),
    }))


if __name__ == "__main__":
    main()
