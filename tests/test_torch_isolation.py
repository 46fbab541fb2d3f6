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
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_soak_driver.py"]


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
            "repro_torch.kernels.jacobi_sweep, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.kernels.flash_attention, "
            "repro_torch.optim, repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.tuning, "
            "repro_torch.benchmarks.kernel_bench, repro_torch.core.store, "
            "repro_torch.core.procworker, repro_torch.core._procworker_child, "
            "repro_torch.apps.procdemo, repro_torch.train.procfns, "
            "repro_torch.serve.engine, repro_torch.serve.scheduler, "
            "repro_torch.models.transformer, repro_torch.models.moe, "
            "repro_torch.parallel, repro_torch.parallel.partition, "
            "repro_torch.serve.mesh, repro_torch.launch.mesh; "
            "from repro_torch.serve import Engine, DEFAULT_BUCKETS; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chaos_scheduler_imports_no_jax():
    """The serve chaos harness and the scheduler driving it, group
    failover and the watchdog included, run with JAX unavailable and pull
    in nothing of JAX or the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.core.fault import ServeChaosInjector\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.serve import PagedEngine, ServeScheduler\n"
        "from repro_torch.weights import init_params\n"
        "cfg = get_smoke_config('qwen2-1.5b')\n"
        "params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "eng = PagedEngine(cfg, params, batch=2, max_len=32, page_size=8,\n"
        "                  prefill_chunk=16, device='cpu')\n"
        "chaos = ServeChaosInjector(kill_group=(1, 2, 2), slow=(1, 1, 9.0))\n"
        "sched = ServeScheduler(eng, device_groups=2, chaos=chaos,\n"
        "                       watchdog_budget_s=5.0, max_restarts=3,\n"
        "                       probe_interval_steps=1)\n"
        "for n in (5, 9, 12):\n"
        "    sched.submit(np.arange(n) % 50, max_new=3)\n"
        "sched.run()\n"
        "while not all(g.healthy for g in sched.groups):\n"
        "    sched.step()\n"
        "assert chaos.n_kills == 1 and sched.watchdog_trips >= 1\n"
        "assert sched.n_group_rejoins == 1, sched.n_group_rejoins\n"
        "bad = sorted(m for m in sys.modules if m is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "print(len(sched.results), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3 []"


def test_mesh_engine_imports_no_jax():
    """The serving mesh — the rules, the grid, a TP=2 x DP=2 engine under
    the scheduler — runs with JAX unavailable and pulls in nothing of JAX
    or the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.parallel.partition import tree_specs\n"
        "from repro_torch.serve import PagedEngine, ServeScheduler\n"
        "from repro_torch.serve.mesh import (MeshSpec, build_serve_mesh,\n"
        "                                    serve_rules)\n"
        "from repro_torch.parallel import ShardingRules\n"
        "from repro_torch.weights import init_params\n"
        "cfg = get_smoke_config('qwen2-1.5b')\n"
        "params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "mesh = build_serve_mesh(MeshSpec(2, 2), device='cpu')\n"
        "specs = tree_specs(params, ShardingRules(mesh, serve_rules()))\n"
        "eng = PagedEngine(cfg, params, batch=2, max_len=32, page_size=8,\n"
        "                  prefill_chunk=16, mesh=mesh, device='cpu')\n"
        "sched = ServeScheduler(eng, device_groups=2)\n"
        "for n in (5, 9, 12):\n"
        "    sched.submit(np.arange(n) % 50, max_new=3)\n"
        "sched.run()\n"
        "bad = sorted(m for m in sys.modules if m is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "print(len(sched.results), specs['embed']['table'], bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3 ('model', 'data') []"


def test_train_mesh_imports_no_jax():
    """The training mesh — a 2 x 2 grid, the placed state, a step with
    grad_accum 2, the SPMD executor over the grid — runs with JAX
    unavailable and pulls in nothing of JAX or the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.core import FunctionRegistry, SpmdExecutor\n"
        "from repro_torch.data import DataConfig, SyntheticLMStream\n"
        "from repro_torch.launch.mesh import make_test_mesh\n"
        "from repro_torch.optim import OptimizerSpec\n"
        "from repro_torch.parallel.partition import position_bytes\n"
        "from repro_torch.train import TrainState, make_train_step\n"
        "cfg = get_smoke_config('qwen2-1.5b')\n"
        "mesh = make_test_mesh(2, 2)\n"
        "spec = OptimizerSpec()\n"
        "state = TrainState.create(cfg, spec, torch.Generator(), 'cpu',\n"
        "                          mesh=mesh)\n"
        "batch = {k: torch.as_tensor(v) for k, v in SyntheticLMStream(\n"
        "    cfg, DataConfig(global_batch=4, seq_len=16)).batch(0).items()}\n"
        "state, m = make_train_step(cfg, spec, grad_accum=2,\n"
        "                           mesh=mesh)(state, batch)\n"
        "SpmdExecutor(mesh, FunctionRegistry())\n"
        "bad = sorted(m for m in sys.modules if m is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "print(np.isfinite(float(m['loss'])), len(set(position_bytes(\n"
        "    state.params))), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True 1 []"


PROBE = """
import sys

import numpy as np


def probe(*chunk_lists):
    import repro_torch.apps.procdemo, repro_torch.train.procfns  # noqa: F401
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return np.array(len(bad))


FNS = {"probe": probe}
"""


def test_spawned_worker_imports_no_jax(tmp_path, monkeypatch):
    """A worker process, spawned as ``ProcessExecutor`` spawns it, imports
    neither JAX nor the JAX package — not for the runtime, the demo's or
    the trainer's function tables (this test's own process has both)."""
    from repro_torch.core import (ChunkedData, DataChunk, FunctionRegistry,
                                  Job, JobGraph, ProcessExecutor,
                                  VirtualCluster)

    (tmp_path / "iso_probe.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    reg = FunctionRegistry()
    reg.register("probe", lambda *cds: None, kind="whole")
    graph = JobGraph()
    graph.add_segment([Job("P", "probe", 1, ())])
    graph.bind_input("P", ChunkedData([DataChunk(torch.zeros(1))]))
    with ProcessExecutor(VirtualCluster([torch.device("cpu")],
                                        max_workers=1),
                         reg, "iso_probe:FNS",
                         store=tmp_path / "jobs.sqlite") as ex:
        results, _ = ex.run(graph)
    assert ex.n_executed == 1
    assert int(results["P"].arrays()[0]) == 0


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd", "ssd"])
def test_kernel_ab_fails_without_a_card(kernel):
    """The A/B script refuses to time anything without a CUDA device, and
    rejects a kernel it does not know."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks import kernel_ab
    assert kernel_ab.main([kernel, "--label", "t"]) == 1
    with pytest.raises(SystemExit):
        kernel_ab.main(["rmsnorm"])


def test_grad_gate_fails_without_a_card():
    """The gate check refuses to run anything without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks import grad_gate
    assert grad_gate.main() == 1


def test_launcher_defaults_to_cuda():
    from repro_torch.launch.serve import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke"])


def test_dense_engine_defaults_to_cuda():
    """``Engine`` runs on the card unless asked for the CPU: without a
    CUDA device the default raises, ``device="cpu"`` builds."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import Engine
    from repro_torch.weights import init_params
    cfg = get_smoke_config("qwen2-1.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert Engine(cfg, params, batch=1, max_len=16,
                  device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert Engine(cfg, params, batch=1, max_len=16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, batch=1, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, batch=1, max_len=16, device="cuda")


def test_train_launcher_defaults_to_cuda():
    from repro_torch.launch.train import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--steps", "1", "--engine", "hypar"])


def test_runtime_and_jacobi_default_to_cuda():
    from repro_torch.apps.jacobi import make_system
    from repro_torch.core import VirtualCluster
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VirtualCluster()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_system(16)
