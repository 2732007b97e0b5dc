"""Runtime metrics / tracing (the aux subsystem the reference lacks,
SURVEY.md section 5: only TESTRAN stats and an index summary line exist
there; a batched accelerator pipeline needs per-stage visibility).

Usage:
    from spaln_tpu.utils.metrics import metrics, stage
    with stage("seed"):
        ...
    metrics.bump("queries")
    print(metrics.report())

`jax_profile(path)` wraps a block in the JAX profiler (TensorBoard trace)
for kernel-level inspection on the device.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timings: dict = field(default_factory=lambda: defaultdict(float))
    calls: dict = field(default_factory=lambda: defaultdict(int))

    def bump(self, name: str, k: int = 1) -> None:
        self.counters[name] += k

    def add_time(self, name: str, dt: float) -> None:
        self.timings[name] += dt
        self.calls[name] += 1

    def reset(self) -> None:
        self.counters.clear()
        self.timings.clear()
        self.calls.clear()

    def report(self) -> str:
        """One JSON line: counters + per-stage seconds and call counts."""
        return json.dumps({
            "counters": dict(self.counters),
            "seconds": {k: round(v, 4) for k, v in self.timings.items()},
            "calls": dict(self.calls),
        }, sort_keys=True)


metrics = Metrics()


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.add_time(name, time.perf_counter() - t0)


@contextlib.contextmanager
def jax_profile(logdir: str):
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
