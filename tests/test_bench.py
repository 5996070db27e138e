"""bench.py and tools/kernel_timings.py: they measure on a GPU only; off
the card they exit non-zero and print no number."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _bench(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(ROOT / "bench.py"), *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)


def test_bench_refuses_without_gpu():
    out = _bench()
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no GPU" in out.stderr


def test_bench_rejects_unknown_arguments():
    out = _bench("--fast")
    assert out.returncode != 0
    assert "usage" in out.stderr


def _timings(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "kernel_timings.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


def test_kernel_timings_refuses_without_gpu():
    out = _timings()
    assert out.returncode != 0
    assert "GEOM_S" not in out.stdout
    assert "no GPU" in out.stderr


def test_kernel_timings_rejects_arguments():
    out = _timings("--fast")
    assert out.returncode != 0
    assert "usage" in out.stderr
