#!/usr/bin/env python3
"""Benchmark: spliced-DP wavefront throughput on one GPU.

Workload: a batch of synthetic cDNA x genomic-window spliced alignments at
mapping-realistic geometry (512 nt queries, 4096-wide bands with two
introns each), score-only mode — the inner loop of genome mapping.
GCUPS counts computed band cells: B x Mpad x W / time, the median of
several timed runs that each end in block_until_ready.

    python bench.py [--unroll U] [--trace DIR]

Prints one JSON line naming the platform, device kind, device count and
the card's name and power limit.  Refuses to run on anything but a GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--unroll", type=int, default=None,
                    help="lax.scan unroll of the slab wavefront "
                         "(default: ops.dp_spliced_scan.SCAN_UNROLL)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--qlen", type=int, default=512)
    ap.add_argument("--band", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--trace", default=None,
                    help="also write a profiler trace of one more run "
                         "to this directory")
    args = ap.parse_args(argv)

    from spaln_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: platform is {dev.platform!r}, not 'gpu'")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()

    from spaln_tpu.config import Config, resolve, CvsG
    from spaln_tpu.ops import dp_spliced_scan as dsc
    from spaln_tpu.ops.params import DpParams
    from spaln_tpu.score.intron import IntronPenalty
    from spaln_tpu.score.simmtx import Simmtx
    from spaln_tpu.score.splice import build_splice_signals
    from spaln_tpu.score.tables import TableDir, find_table_dir
    from spaln_tpu.seq.codec import encode_dna

    if args.unroll is not None:
        dsc.SCAN_UNROLL[dev.platform] = args.unroll
    cfg = resolve(Config(), CvsG)
    prm = DpParams.build(cfg, Simmtx.dna(), CvsG,
                         ipen=IntronPenalty(cfg, CvsG))
    tables = TableDir(find_table_dir())
    B, M, W, L = args.batch, args.qlen, args.band, 128

    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    queries, genomes, sigs = [], [], []
    for _ in range(B):
        e = ["".join(rng.choice(bases, M // 3)) for _ in range(3)]
        i1 = "GTAAGT" + "".join(rng.choice(bases, 300)) + "TTTTTAG"
        i2 = "GTGAGT" + "".join(rng.choice(bases, 500)) + "TTTCTAG"
        gc = encode_dna(e[0] + i1 + e[1] + i2 + e[2])
        queries.append(encode_dna("".join(e)))
        genomes.append(gc)
        sigs.append(build_splice_signals(gc, cfg, tables))
    lw = -(W // 2)
    bp = dsc.prepare_spliced_batch(queries, genomes, prm, sigs=sigs,
                                   lw=lw, up=lw + W - 1, L=L)
    t0 = time.perf_counter()
    dsc.run_spliced_batch(bp, prm, score_only=True)     # compile + warm
    setup = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        row_h, rc_h, _ = dsc.run_spliced_batch(bp, prm, score_only=True)
        times.append(time.perf_counter() - t0)
    times.sort()
    if args.trace:
        with jax.profiler.trace(args.trace):
            dsc.run_spliced_batch(bp, prm, score_only=True)
    scores, _, _ = dsc.collect_batch_results(bp, row_h, rc_h, None, True,
                                             prm=prm)
    assert (scores > 0).all(), "benchmark alignments must score positive"
    cells = B * bp.n_slabs * L * bp.W
    print(json.dumps({
        "metric": "spliced_dp_gcups",
        "value": cells / times[len(times) // 2] / 1e9,
        "unit": "GCUPS",
        "spread_gcups": [cells / times[-1] / 1e9, cells / times[0] / 1e9],
        "repeats": args.iters,
        "first_call_s": setup,
        "geometry": {"B": B, "M": M, "W": bp.W, "L": L,
                     "n_slabs": bp.n_slabs},
        "unroll": dsc.scan_unroll(),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()), "gpu": gpu,
    }))


if __name__ == "__main__":
    main()
