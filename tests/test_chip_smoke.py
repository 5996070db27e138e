"""chip_smoke.py off the card: it must refuse to run without a GPU (and
outside the repository), and its comparison helpers must measure what
they claim on tiny arrays."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_outside_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run([str(tmp_path / "chip_smoke.py")], tmp_path,
               {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_image_agreement():
    a = np.zeros((2, 2, 3))
    b = a.copy()
    b[0, 0, 1] = 0.4
    got = cs.image_agreement(a, b)
    assert got["mean_abs"] == pytest.approx(0.4 / 12)
    assert got["channel_mean"] == pytest.approx(0.1)
    with pytest.raises(AssertionError, match="shapes"):
        cs.image_agreement(a, np.zeros((2, 3, 3)))


def test_u8_agreement():
    golden = np.full((2, 2, 3), 100, np.uint8)
    got = golden.copy()
    got[1, 1, 2] = 90
    a = cs.u8_agreement(got, golden)
    assert a == {"frac_diff": pytest.approx(1 / 12),
                 "mean_abs": pytest.approx(10 / 12), "max_abs": 10}


def test_grad_agreement():
    j = np.array([1.0, -2.0, 0.5])
    a = cs.grad_agreement(j * 1.01, j)
    assert a["rel"] == pytest.approx(0.01)
    assert a["cos"] == pytest.approx(1.0)
    assert cs.grad_agreement(-j, j)["cos"] == pytest.approx(-1.0)
    with pytest.raises(AssertionError, match="zero"):
        cs.grad_agreement(j, np.zeros(3))


def test_check_limits(capsys):
    cs.check("x", 0.5, 1.0)
    cs.check("y", 0.95, 0.9, above=True)
    with pytest.raises(AssertionError):
        cs.check("z", 2.0, 1.0)
    with pytest.raises(AssertionError):
        cs.check("w", 0.5, 0.9, above=True)
    out = capsys.readouterr().out
    assert "x = 0.5 (limit <= 1) ok" in out and "FAIL" in out
