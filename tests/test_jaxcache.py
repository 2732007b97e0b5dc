"""The persistent compilation cache is configured in one helper that
honours JAX_COMPILATION_CACHE_DIR and otherwise uses <repo>/.jax_cache."""
import os
import subprocess
import sys

import pytest

from spaln_tpu.utils.jaxcache import ENV, REPO_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import jax, jax.numpy as jnp
from spaln_tpu.utils.jaxcache import enable_compile_cache
print(enable_compile_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.cumsum(x * 3 + 1))(jnp.arange(7)).block_until_ready()
"""


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    env = {k: v for k, v in os.environ.items() if k != ENV}
    want = str(tmp_path / "cache") if from_env else REPO_CACHE
    if from_env:
        env[ENV] = want
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path),
                         env=dict(env, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want) and os.listdir(want)
