"""The port's examples (``examples/torch_*.py``, the counterparts of the
reference's ``examples/``) run on the CPU at a small size: quickstart's
maximum is numpy's, the Jacobi demo's three variants land within 1e-4 of
the known solution at n 256, the serving demo runs its smoke waves and the
training demo two smoke steps into a checkpoint directory."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, *args: str, cwd=None) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=cwd or ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart_finds_numpys_maximum():
    out = _run("torch_quickstart.py", "--device", "cpu")
    found = float(re.search(r"maximum found:\s*(\S+)", out).group(1))
    want = np.random.default_rng(0).standard_normal(1000).astype(
        np.float32).max()
    assert found == float(want)
    assert float(re.search(r"numpy says:\s*(\S+)", out).group(1)) == found
    assert "hybrid class:  strict" in out


def test_jacobi_demo_solves_the_system():
    out = _run("torch_jacobi_hybrid.py", "256", "--device", "cpu")
    errs = [float(e) for e in re.findall(r"err=(\S+)", out)]
    assert len(errs) == 3
    assert all(e <= 1e-4 for e in errs), out


def test_serve_demo_runs_its_smoke_waves():
    out = _run("torch_serve_lm.py", "--device", "cpu")
    assert "qwen2-1.5b-smoke" in out
    assert len(re.findall(r"^wave \d+:", out, re.M)) == 2, out


def test_train_demo_takes_two_smoke_steps(tmp_path):
    ckpt = tmp_path / "ckpt"
    _run("torch_train_lm.py", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "32", "--ckpt-dir", str(ckpt),
         "--ckpt-every", "1", cwd=tmp_path)
    assert any(ckpt.iterdir())
