"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, ``import repro_torch``
works with JAX unavailable, and the entry points run on the card unless
asked for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_nothing_of_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_import_with_jax_unavailable():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.weights, repro_torch.kernels.paged_attention, "
            "repro_torch.kernels.ssd_scan, repro_torch.models.ssm, "
            "repro_torch.core, repro_torch.apps.jacobi, "
            "repro_torch.kernels.jacobi_sweep; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_launcher_defaults_to_cuda():
    from repro_torch.launch.serve import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke"])


def test_runtime_and_jacobi_default_to_cuda():
    from repro_torch.apps.jacobi import make_system
    from repro_torch.core import VirtualCluster
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VirtualCluster()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_system(16)
