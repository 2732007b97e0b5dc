"""chip_smoke.py: the tiny rehearsal end to end on the CPU, and the two
refusals (no GPU without --tiny; no package beside the script)."""
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, env_extra=None, timeout=900):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except ValueError:
        return None


def test_tiny_end_to_end_on_cpu(tmp_path):
    cache = tmp_path / "cache"
    out = _run([SMOKE, "--tiny", "--workdir", str(tmp_path / "work")],
               cwd=str(tmp_path),
               env_extra={"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = _last_json(out.stdout)
    assert last["ok"] is True
    assert last["device"]["platform"] == "cpu"
    assert "FAIL" not in out.stdout
    for what in ("UDH buckets", "oracle bit-identical",
                 "cDNA with every planted intron exactly",
                 "proteins on their planted locus and strand",
                 "skipped queries (cold): 0", "skipped queries (warm): 0"):
        assert what in out.stdout
    for engine in ("scan", "udh", "tron"):   # each engine checked
        assert re.search(rf"^  {engine} +M=.*: identical$", out.stdout,
                         re.M), engine
    assert os.listdir(cache)             # compile cache went where asked


def test_refuses_without_a_gpu(tmp_path):
    out = _run([SMOKE, "--workdir", str(tmp_path)], cwd=str(tmp_path),
               timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "not 'gpu'" in out.stderr


def test_refuses_without_the_package(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    out = _run([str(alone)], cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
