#!/usr/bin/env python3
"""Bring-up smoke: run `map` end to end on one GPU at the size users run.

    python3 chip_smoke.py            one GPU, every phase below
    python3 chip_smoke.py --four     four GPUs: the sharded cDNA map and the
                                     one-GPU map it must equal, nothing else
    python3 chip_smoke.py --tiny     the same phases at toy size on any
                                     platform (CPU tests, rehearsal)

Phases, all in this one process (one process per card):
  1. device: JAX version, devices, the card's name and power limit;
     anything but a GPU is refused unless --tiny.
  2. data: a 34 Mb genome shaped like Dictyostelium discoideum with ~150
     planted multi-exon genes on both strands (scripts/synth_genes.py),
     64 cDNA queries (1% substitutions) and 16 protein translations.
  3. `spaln_tpu index` then `spaln_tpu map` through the CLI entry point,
     map run twice (cold, warm): wall time, queries/s, buckets, counters,
     host stage spans, peak device memory.
  4. truth: no skipped query, >= 95% of cDNAs with every planted intron
     exactly, every protein on its planted locus and strand.
  5. oracle: DP problems taken from the map's own buckets, at their real
     band and length, rerun through the numpy oracles
     (ops/dp_spliced_ref.py, ops/dp_tron_ref.py): scores, end cells and
     op streams must be bit-identical.

The last stdout line is one JSON object {"ok": true, "device": {...}};
a failed phase prints FAIL lines and exits 1 with no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# DP problems rerun through the numpy oracle, and the most band cells
# (query length x band width) one of them may have: the oracle runs a
# few microseconds per cell, one host process per problem, in parallel
ORACLE_NT, ORACLE_AA = 8, 4
ORACLE_MAX_CELLS = {"full": 32_000_000, "tiny": 3_000_000}
# traceback-plane budget (-V) for the map passes: keeps full planes to a
# few tens of MB per launch, so the long-query buckets take the
# linear-space UDH path as they do at production batch sizes
PLANE_BUDGET = {"full": "16M", "tiny": "2M"}
# queries mapped (cDNA, protein): the full stream is cut from the
# generated 64 + 16 so that a cold run, compiles included, stays near
# ten minutes on one H100 (every distinct bucket geometry is a compile)
QUERIES = {"full": (16, 8), "tiny": (6, 3)}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> list[str]:
    """Card name and power limit, read by a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi unavailable ({type(exc).__name__})"]
    return [l for l in out.stdout.splitlines() if l.strip()] or \
        [f"nvidia-smi gave no card (rc {out.returncode})"]


class Phases:
    def __init__(self):
        self.failed: list[str] = []

    def check(self, ok: bool, what: str) -> bool:
        log(("ok    " if ok else "FAIL  ") + what)
        if not ok:
            self.failed.append(what)
        return ok


def peak_bytes(dev) -> str:
    st = dev.memory_stats() or {}
    v = st.get("peak_bytes_in_use")
    return "not reported by this platform" if v is None else str(v)


def read_map_output(path: str) -> dict:
    """-O 4,5 output -> {query: {"exons": [...], "introns": [...]}}.
    Exon rows have 14 columns, intron rows 10; coordinates come back
    0-based half-open on the forward strand."""
    res: dict = {}
    with open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) == 14:
                r = res.setdefault(t[0], {"exons": [], "introns": []})
                r["exons"].append((t[1], t[2], int(t[5]) - 1, int(t[6])))
            elif len(t) == 10:
                r = res.setdefault(t[0], {"exons": [], "introns": []})
                r["introns"].append((t[1], t[2], int(t[3]) - 1, int(t[4])))
    return res


class JobRecorder:
    """Keeps the DP jobs each map pass ran, with their raw results and
    the engine that ran each, for the oracle phase (wraps the two bucket
    executors the mappers call, and the cDNA engines they pick from)."""

    def __init__(self):
        from spaln_tpu.align import driver, mapper, protein_driver
        from spaln_tpu.ops import dp_spliced_scan, dp_spliced_udh
        self.nt, self.aa = [], []
        self.engine_of: dict[int, str] = {}
        self.engine = None
        run_nt, run_aa = mapper.execute_jobs, protein_driver.execute_tron_jobs
        scan = dp_spliced_scan.run_spliced_batch
        udh = dp_spliced_udh.run_spliced_batch_udh
        finish = driver._finish_job

        def engine(run, name):
            def call(*a, **kw):
                out = run(*a, **kw)
                self.engine = name
                return out
            return call

        def finish_job(job, *a, **kw):
            # a bucket's jobs finish right after its engine ran
            self.engine_of[id(job)] = self.engine
            return finish(job, *a, **kw)
        dp_spliced_scan.run_spliced_batch = engine(scan, "scan")
        dp_spliced_udh.run_spliced_batch_udh = engine(udh, "udh")
        driver._finish_job = finish_job

        def wrap(run, kind, keep, lanes):
            def call(jobs, ctx, **kw):
                t0 = time.perf_counter()
                out = run(jobs, ctx, **kw)
                log(f"  {kind} DP call: {len(jobs)} jobs, "
                    f"{time.perf_counter() - t0:.2f} s, programs "
                    f"{compiled_programs()}")
                keep.append((jobs, ctx, kw.get("lanes", lanes)))
                return out
            return call
        nt = wrap(run_nt, "cDNA", self.nt, 128)
        aa = wrap(run_aa, "protein", self.aa, 64)
        mapper.execute_jobs = nt
        protein_driver.execute_tron_jobs = aa

    def clear(self):
        self.nt.clear()
        self.aa.clear()
        self.engine_of.clear()

    def candidates(self) -> list:
        """(engine, band cells, bucket, job, ctx) of every job run."""
        out = []
        for batches, width, kind in ((self.nt, 1, None),
                                     (self.aa, 2, "tron")):
            for js, ctx, lanes in batches:
                for j in js:
                    if j is not None and j.dp is not None:
                        W = j.up - j.lw + width
                        out.append((kind or self.engine_of[id(j)],
                                    len(j.q) * W,
                                    (W, -(-len(j.q) // lanes)), j, ctx))
        return out


def pick_jobs(cands, quotas, max_cells: int) -> list:
    """For each (engines, n) of quotas in turn, n more jobs run by one of
    engines, of at most max_cells band cells each: the cheapest job of
    each bucket first, then the next cheapest.  Returns (engine, job,
    ctx)."""
    cands = sorted((c for c in cands if c[1] <= max_cells),
                   key=lambda c: c[1])
    picked, seen = [], set()
    for engines, n in quotas:
        n += sum(p[0] in engines for p in picked)
        for rnd in (0, 1):
            for eng, _, key, j, ctx in cands:
                if sum(p[0] in engines for p in picked) >= n:
                    break
                if eng not in engines or (rnd == 0 and key in seen) \
                        or any(j is p[1] for p in picked):
                    continue
                seen.add(key)
                picked.append((eng, j, ctx))
    return picked


def oracle_task(eng: str, j, ctx) -> tuple:
    """The numpy operands of one DP problem: what an oracle process
    needs, with no job or context object (nothing that holds a device
    array crosses to it)."""
    if eng != "tron":
        return ("cDNA", j.q, j.gw, j.sig, j.lw, j.up, ctx.prm, ctx.flags)
    return ("tron", j.q, j.gw, j.sig, j.lw, j.up, ctx.prm, ctx.flags,
            ctx.ipen_tab, j.loc_bounds)


def run_oracle(task):
    """One DP problem through the numpy oracle: (score, end_m, end_n,
    ops), the tuple the device path left in job.dp."""
    kind, q, gw, sig, lw, up, prm, flags = task[:8]
    if kind == "cDNA":
        from spaln_tpu.ops.dp_spliced_ref import (
            Window, forward_spliced_ref, traceback_spliced_ref)
        s, em, en, tb = forward_spliced_ref(
            q, gw, prm, sig=sig, wdw=Window(lw, up), flags=flags)
        return int(s), int(em), int(en), traceback_spliced_ref(tb, em, en)
    from spaln_tpu.ops.dp_tron_ref import forward_tron_ref, \
        traceback_tron_ref
    ipen_tab, loc_bounds = task[8:]
    s, em, en, tb = forward_tron_ref(
        q, gw, sig, prm, ipen_tab, lw=lw, up=up, flags=flags,
        loc_bounds=loc_bounds)
    return int(s), int(em), int(en), traceback_tron_ref(tb, em, en)


def oracle_phase(ph: Phases, rec: JobRecorder, size: str) -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    log("== oracle: tolerance 0 (x10 fixed-point int32 DP: no float, no "
        "matrix product, so TF32 and reduction order cannot apply)")
    t0 = time.perf_counter()
    # one cDNA problem of each engine (full-plane scan, UDH), then
    # more of either, and the protein (tron) problems
    picked = pick_jobs(
        rec.candidates(),
        [(("scan",), 1), (("udh",), 1), (("scan", "udh"), ORACLE_NT - 2),
         (("tron",), ORACLE_AA)], ORACLE_MAX_CELLS[size])
    # host processes that never touch the card (spawned: the parent
    # holds the device): they take numpy operands and import only the
    # numpy oracles
    with ProcessPoolExecutor(
            max_workers=max(1, min(len(picked), os.cpu_count() or 1)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        refs = list(ex.map(run_oracle,
                           [oracle_task(*p) for p in picked]))
    same = 0
    for (eng, j, _), ref in zip(picked, refs):
        ok = ref == tuple(j.dp)
        same += ok
        W = j.up - j.lw + (2 if eng == "tron" else 1)
        log(f"  {eng:4s} M={len(j.q):5d} W={W:6d} lw={j.lw} "
            f"score {j.dp[0]} vs oracle {ref[0]}, end "
            f"({j.dp[1]}, {j.dp[2]}) vs ({ref[1]}, {ref[2]}), "
            f"{len(j.dp[3])} ops: {'identical' if ok else 'DIFFERENT'}")
    n = {e: sum(p[0] == e for p in picked)
         for e in ("scan", "udh", "tron")}
    log(f"  oracle wall {time.perf_counter() - t0:.1f} s on "
        f"{os.cpu_count()} host cores")
    n_nt = n["scan"] + n["udh"]
    need = (1, 1) if size == "tiny" else (ORACLE_NT, ORACLE_AA)
    ph.check(n_nt >= need[0] and n["tron"] >= need[1]
             and min(n.values()) >= 1,
             f"oracle sample: {n_nt} cDNA (scan {n['scan']}, UDH "
             f"{n['udh']}) + {n['tron']} tron problems")
    ph.check(same == len(picked),
             f"oracle bit-identical: {same}/{len(picked)}")


def truth_phase(ph: Phases, truth: dict, out: dict, passes: dict):
    genes = {g["name"]: g for g in truth["genes"]}
    for label, c in passes.items():
        ph.check(c.get("skipped_queries", 0) == 0,
                 f"skipped queries ({label}): "
                 f"{c.get('skipped_queries', 0)}")
    exact = 0
    nq = truth["queries"]["cdna"]
    for q in nq:
        g = genes[q["gene"]]
        want = {(g["chrom"], g["strand"], a, b) for a, b in g["introns"]}
        got = set(out.get(q["name"], {}).get("introns", []))
        exact += got == want
    ph.check(exact >= 0.95 * len(nq),
             f"cDNA with every planted intron exactly: {exact}/{len(nq)}")
    placed = exact_aa = 0
    aq = truth["queries"]["protein"]
    for q in aq:
        g = genes[q["gene"]]
        ex = out.get(q["name"], {}).get("exons", [])
        placed += bool(ex) and all(
            c == g["chrom"] and st == g["strand"]
            and a < g["end"] and b > g["start"] for c, st, a, b in ex)
        want = {(g["chrom"], g["strand"], a, b) for a, b in g["introns"]}
        exact_aa += set(out.get(q["name"], {}).get("introns", [])) == want
    ph.check(placed == len(aq),
             f"proteins on their planted locus and strand: "
             f"{placed}/{len(aq)}")
    log(f"  proteins with every planted intron exactly: "
        f"{exact_aa}/{len(aq)}")


def compiled_programs() -> str:
    """Distinct DP programs built so far in this process (each is one
    compile, or one persistent-cache load)."""
    from spaln_tpu.ops import dp_spliced_scan as dsc, dp_tron_scan as dts
    n = {"slab scans": dsc._scan_slab.cache_info().currsize,
         "cDNA walkers": dsc._tb_walker.cache_info().currsize,
         "tron batches": dts._tron_fused.cache_info().currsize,
         "tron walkers": dts._tron_tb_walker.cache_info().currsize}
    return json.dumps(n)


def map_pass(label: str, argv: list, nq: int, dev) -> dict:
    from spaln_tpu import cli
    from spaln_tpu.utils.metrics import metrics
    metrics.reset()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    c = dict(metrics.counters)
    buckets = sum(c.get(k, 0) for k in
                  ("scan_buckets", "udh_buckets", "tron_buckets"))
    log(f"== map {label}: rc {rc}, wall {dt:.2f} s, "
        f"{nq / dt:.3f} queries/s, {buckets} buckets "
        f"(scan {c.get('scan_buckets', 0)}, udh {c.get('udh_buckets', 0)}"
        f", tron {c.get('tron_buckets', 0)})")
    log(f"  counters {json.dumps(c, sort_keys=True)}")
    spans = {k: round(v, 3) for k, v in sorted(metrics.timings.items())}
    log(f"  host wall-clock stage spans (s) {json.dumps(spans)}")
    log(f"  device peak_bytes_in_use {peak_bytes(dev)}")
    log(f"  compiled programs so far: {compiled_programs()}")
    return {"rc": rc, "wall": dt, "counters": c}


def run_single(args, ph: Phases, dev) -> None:
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import synth_genes
    size = "tiny" if args.tiny else "full"
    work = os.path.join(args.workdir, size)
    log(f"== data: seed {args.seed}, {size} size, in {work}")
    t0 = time.perf_counter()
    truth = synth_genes.make_dataset(
        work, args.seed, synth_genes.TINY if args.tiny
        else synth_genes.FULL)
    glen = sum(n for _, n in truth["chroms"])
    # the stream the map passes take: the first QUERIES of the generated
    # ones (FASTA records are two lines each)
    qfa = os.path.join(work, "queries.fa")
    with open(qfa, "w") as f:
        for kind, fa, n in zip(("cdna", "protein"),
                               ("cdna.fa", "protein.fa"), QUERIES[size]):
            truth["queries"][kind] = truth["queries"][kind][:n]
            with open(os.path.join(work, fa)) as g:
                f.writelines(g.readlines()[:2 * n])
    nq_nt, nq_aa = len(truth["queries"]["cdna"]), len(
        truth["queries"]["protein"])
    log(f"  genome {glen} bp in {len(truth['chroms'])} chromosomes, "
        f"{len(truth['genes'])} planted genes; mapping {nq_nt} cDNA + "
        f"{nq_aa} protein queries ({time.perf_counter() - t0:.1f} s)")

    from spaln_tpu import cli
    from spaln_tpu.utils.metrics import metrics
    prefix = os.path.join(work, "genome")
    metrics.reset()
    t0 = time.perf_counter()
    rc = cli.main(["index", os.path.join(work, "genome.fa"), "-K", "DP",
                   "-p", prefix])
    c = dict(metrics.counters)
    log(f"== index: rc {rc}, {time.perf_counter() - t0:.1f} s, built by "
        f"{'the native builder' if c.get('index_builds_native') else 'numpy'}"
        f" ({json.dumps(c, sort_keys=True)})")
    ph.check(rc == 0, "index built")

    rec = JobRecorder()
    out = os.path.join(work, "map.tsv")
    argv = ["map", qfa, "-d", prefix, "-T", "Dictyost", "-O", "4,5",
            "-V", PLANE_BUDGET[size], "-o", out]
    nq = nq_nt + nq_aa
    cold = map_pass("cold", argv, nq, dev)
    rec.clear()
    warm = map_pass("warm", argv, nq, dev)
    ph.check(cold["rc"] == 0 and warm["rc"] == 0, "map passes returned 0")
    ph.check(warm["counters"].get("udh_buckets", 0) >= 1,
             f"UDH buckets: {warm['counters'].get('udh_buckets', 0)}")
    ph.check(warm["counters"].get("scan_buckets", 0) >= 1
             and warm["counters"].get("tron_buckets", 0) >= 1,
             "full-plane scan and tron buckets ran")
    log("== truth")
    truth_phase(ph, truth, read_map_output(out),
                {"cold": cold["counters"], "warm": warm["counters"]})
    oracle_phase(ph, rec, size)


def run_four(args, ph: Phases) -> None:
    """Sharded cDNA map on a 4-device mesh vs the same map on one."""
    import jax
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import synth_genes
    from spaln_tpu import cli, parallel
    from spaln_tpu.align import driver
    from spaln_tpu.align.driver import AlignerContext
    from spaln_tpu.align.mapper import GenomeMapper
    from spaln_tpu.score.tables import TableDir, find_table_dir
    from spaln_tpu.seed.blockindex import BlockIndex
    from spaln_tpu.seq.fasta import read_fasta
    from spaln_tpu.seq.genome import GenomeStore
    devs = jax.devices()
    if not ph.check(len(devs) >= 4, f"four devices: have {len(devs)}"):
        return
    size = "tiny" if args.tiny else "full"
    work = os.path.join(args.workdir, size)
    truth = synth_genes.make_dataset(
        work, args.seed, synth_genes.TINY if args.tiny
        else synth_genes.FULL)
    prefix = os.path.join(work, "genome")
    cli.main(["index", os.path.join(work, "genome.fa"), "-K", "D",
              "-p", prefix])
    store = GenomeStore.load(prefix)
    mapper = GenomeMapper(store, BlockIndex.load(prefix),
                          AlignerContext.create(
                              TableDir(find_table_dir(), "Dictyost")))
    recs = read_fasta(os.path.join(work, "cdna.fa"))[:QUERIES[size][0]]
    qs, names = [r.codes for r in recs], [r.name for r in recs]
    placement = []
    shard = driver._shard_batch

    def checked_shard(bp, mesh):
        out = shard(bp, mesh)
        for x in (out.qprof_all, out.ops["rb_code"], out.bnd_h0):
            sh = x.addressable_shards
            placement.append(
                len({s.device for s in sh}) == 4
                and all(s.data.shape[0] == bp.B // 4 for s in sh)
                and all(s.data.devices() == {s.device} for s in sh))
        return out
    driver._shard_batch = checked_shard
    mesh = parallel.make_mesh(4)
    log(f"== four: mesh {mesh.shape} over "
        f"{[d.id for d in mesh.devices.ravel()]}")
    t0 = time.perf_counter()
    one = mapper.map_queries(qs, q_names=names)
    t1 = time.perf_counter()
    four = parallel.map_queries_sharded(mapper, qs, q_names=names,
                                        mesh=mesh)
    t2 = time.perf_counter()
    log(f"  cDNA map wall, compiles included: one device {t1 - t0:.2f} s,"
        f" four devices {t2 - t1:.2f} s ({len(qs)} queries)")
    for d in devs[:4]:
        log(f"  device {d.id} peak_bytes_in_use {peak_bytes(d)}")

    def key(rs):
        return [[(g.g_name, g.strand, g.score,
                  [(e.g_start, e.g_end) for e in g.exons]) for g in r]
                for r in rs]
    ph.check(bool(placement) and all(placement),
             f"sharded operands one slice per device: "
             f"{sum(placement)}/{len(placement)}")
    ph.check(key(one) == key(four),
             f"gene structures identical on four devices and one "
             f"({len(qs)} queries, {len(truth['genes'])} planted genes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded map on four devices")
    ap.add_argument("--tiny", action="store_true",
                    help="toy size, any platform")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(HERE, ".smoke"))
    args = ap.parse_args(argv)
    try:
        import spaln_tpu  # noqa: F401
        from spaln_tpu.utils.jaxcache import enable_compile_cache
    except ImportError as exc:
        print(f"chip_smoke: the spaln_tpu package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    import jax
    log(f"== device: jax {jax.__version__}, compile cache {cache}")
    devs = jax.devices()
    log(f"  devices {devs}")
    log("  nvidia-smi name, power.limit:")
    for line in nvidia_smi():
        log(line)
    dev = devs[0]
    if dev.platform != "gpu" and not args.tiny:
        print(f"chip_smoke: platform is {dev.platform!r}, not 'gpu'; "
              "refusing to run (pass --tiny to rehearse on any platform)",
              file=sys.stderr)
        return 1
    ph = Phases()
    t0 = time.perf_counter()
    if args.four:
        run_four(args, ph)
    else:
        run_single(args, ph, dev)
    log(f"== total {time.perf_counter() - t0:.1f} s")
    if ph.failed:
        log(f"FAILED phases: {ph.failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
