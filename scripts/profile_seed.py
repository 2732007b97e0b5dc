"""Profile the host seed stage (wilip/find_hsps) at corpus-like geometry.

Seed is one of the two largest host stages of `map` (PERF.md).  This
harness reproduces the per-query cost in isolation on Dicty-like AT-rich
sequence so the hot lines can be attributed before optimizing.
"""
from __future__ import annotations

import cProfile
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from spaln_tpu.seed.wilip import wilip  # noqa: E402

rng = np.random.default_rng(7)


def at_rich(n):
    return rng.choice(np.array([0, 0, 3, 3, 1, 2], np.int8), size=n)


def planted(qlen=1500, wlen=60000, nex=6):
    g = at_rich(wlen)
    q = np.zeros(0, np.int8)
    pos = 2000
    for _ in range(nex):
        elen = qlen // nex
        ex = at_rich(elen)
        g[pos:pos + elen] = ex
        q = np.concatenate([q, ex])
        pos += elen + int(rng.integers(80, 800))
    return q.astype(np.int8), g


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    pairs = [planted() for _ in range(reps)]
    # warm numpy
    wilip(pairs[0][0], pairs[0][1])
    t0 = time.perf_counter()
    for q, g in pairs:
        wilip(q, g)
    dt = time.perf_counter() - t0
    print(f"wilip: {dt / reps * 1e3:.1f} ms/call "
          f"(qlen=1500, wlen=60000)")
    pr = cProfile.Profile()
    pr.enable()
    for q, g in pairs:
        wilip(q, g)
    pr.disable()
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(18)


if __name__ == "__main__":
    main()
