"""What stays of the measurement tooling: ``bench.py``'s timing and
output contract, ``chip_smoke.py``'s refusal to run without a GPU, and
the compile-cache helper both use."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


def test_times_warms_up_then_times_each_rep():
    calls = []
    ts = bench.times(lambda: calls.append(1), 3)
    assert len(calls) == 4 and len(ts) == 3
    assert all(t >= 0 for t in ts)
    calls.clear()
    assert len(bench.times(lambda: calls.append(1), 2, warm=False)) == 2
    assert len(calls) == 2


def test_emit_stamps_every_line_with_the_device(capsys):
    ident = {"platform": "gpu", "device_kind": "H", "count": 1,
             "nvidia_smi": "H, 700.00 W"}
    bench.emit(ident, input="z9m", median_s=0.5)
    line = json.loads(capsys.readouterr().out)
    assert line["input"] == "z9m" and line["median_s"] == 0.5
    for k, v in ident.items():
        assert line[k] == v


@pytest.mark.parametrize("script,args", [("bench.py", []),
                                         ("bench.py", ["--kernels"]),
                                         ("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--four"])])
def test_refuses_without_a_gpu(script, args):
    """No GPU: a non-zero exit and no result line — never a CPU
    number."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               PATH="/nonexistent")
    r = subprocess.run([sys.executable, str(REPO / script), *args],
                       capture_output=True, text=True, env=env,
                       timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "median_s" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo
    cannot pass: the package is missing."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, env=env,
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_compile_cache_follows_the_environment(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set in
    code; without it the cache sits in the caller's fallback, and with
    neither no cache is set."""
    import jax

    from lz4tpu import device

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.use_compile_cache("/fallback") == "/elsewhere/cache"
    assert all(k != "jax_compilation_cache_dir" for k, _v in updates)
    updates.clear()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = str(REPO / ".jax_cache")
    assert device.use_compile_cache(path) == path
    assert ("jax_compilation_cache_dir", path) in updates
    updates.clear()
    assert device.use_compile_cache() is None and not updates
