import os

# Run tests on a virtual 8-device CPU mesh so sharding paths are exercised
# without an accelerator (chip_smoke.py runs the same paths on the GPU).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: re-runs reuse executables across
# processes (keyed by HLO hash — any change to the traced computation
# recompiles automatically).
from spaln_tpu.utils.jaxcache import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest

from spaln_tpu.score.tables import find_table_dir, TableDir


@pytest.fixture(scope="session")
def table_dir() -> TableDir:
    return TableDir(find_table_dir())


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(42)


# ---- test tiers: `pytest -m fast` must stay under ~5 minutes.  Modules
# that compile large scan geometries or run whole mapping pipelines are
# marked slow; everything else fast.
SLOW_MODULES = {
    "test_pipeline", "test_batched_mapping",
    "test_long_intron", "test_segment", "test_protein_driver",
    "test_dp_tron_scan",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)
