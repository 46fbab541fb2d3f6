"""Training on the durable runtime: ``repro_torch.launch.train --engine proc``
(the HyPar job graph on spawned worker processes, ``train.procfns``, a
sqlite job store) against ``--engine hypar`` (thread workers), on the CPU
at the smoke config, and a ``--resume`` rerun served wholly from the
store."""
import numpy as np
import pytest
import torch

from repro_torch.launch.train import main as train_main
from repro_torch.train import HyParTrainer
from repro_torch.tree import tree_leaves, tree_unflatten

ARGV = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--seq", "32", "--grad-accum", "2"]
PARAM_TOL = 1e-6                 # relative to max|thread params|


@pytest.fixture
def trained(monkeypatch):
    """Runs the launcher and returns each run's final parameters."""
    runs = []
    run = HyParTrainer.run

    def recording(self, *args, **kw):
        out = run(self, *args, **kw)
        runs.append(tree_leaves(out[0]))
        return out

    monkeypatch.setattr(HyParTrainer, "run", recording)
    return runs


def _max_rel(got, want):
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


def test_proc_engine_matches_hypar_and_resumes(tmp_path, trained, capsys):
    store = tmp_path / "train.sqlite"
    train_main(ARGV + ["--engine", "hypar"])
    train_main(ARGV + ["--engine", "proc", "--proc-workers", "2",
                       "--store", str(store)])
    first = capsys.readouterr().out
    thread, proc = trained
    assert len(proc) == len(thread)
    assert all(p.dtype == t.dtype and p.shape == t.shape
               for p, t in zip(proc, thread))
    assert _max_rel(proc, thread) <= PARAM_TOL
    # 2 steps: 2 x (2 data + 2 grad + opt + 2 takes) + P0/S0
    assert "job store: 16 executed, 0 memoised" in first

    train_main(ARGV + ["--engine", "proc", "--proc-workers", "2",
                       "--store", str(store), "--resume",
                       "--store-gc-rows", "100"])
    second = capsys.readouterr().out
    assert "job store: 0 executed, 16 memoised" in second
    assert "store gc: pruned 0 done row(s)" in second
    resumed = trained[2]
    assert all(torch.equal(a, b) for a, b in zip(resumed, proc))


@pytest.mark.parametrize("argv", [
    ["--store", "x.sqlite"],                       # needs --engine proc
    ["--engine", "hypar", "--resume"],             # needs --engine proc
    ["--engine", "proc", "--resume"],              # needs --store
    ["--engine", "proc", "--store-gc", "5"],       # needs --store
])
def test_proc_argument_errors_match_jax(argv, capsys):
    from repro.launch.train import main as jax_main

    errors = []
    for main in (train_main, jax_main):
        with pytest.raises(SystemExit) as err:
            main(["--smoke", "--steps", "1", *argv])
        assert err.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split(":", 1)[1] == errors[1].split(":", 1)[1]


def test_procfns_structure_is_the_trainers(monkeypatch):
    """Each child rebuilds the parameter and optimizer structures on the
    ``meta`` device (no second model in memory), in the leaf order the
    master flattens in."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import OptimizerSpec, init_opt_state
    from repro_torch.train import procfns
    from repro_torch.weights import init_params

    cfg = get_smoke_config("qwen2-1.5b")
    spec = OptimizerSpec(kind="adamw", lr=1e-3)
    monkeypatch.setattr(procfns, "_CTX", None)
    monkeypatch.setenv(procfns.ENV_KEY, "")          # restored after
    with pytest.raises(RuntimeError, match="export_env"):
        procfns._ctx()
    procfns.export_env(cfg, spec, ["targets", "tokens"], device="cpu")
    ctx = procfns._ctx()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(spec, params)
    assert ctx.cfg == cfg and ctx.spec == spec
    assert ctx.device == torch.device("cpu")
    assert ctx.n_p == len(tree_leaves(params))
    for like, tree in ((ctx.params_like, params), (ctx.opt_like, opt)):
        leaves = tree_leaves(tree)
        rebuilt = tree_leaves(tree_unflatten(like, leaves))
        assert len(rebuilt) == len(leaves)
        assert all(a is b for a, b in zip(rebuilt, leaves))
    full = [np.full(1, i) for i in range(len(tree_leaves(params))
                                         + len(tree_leaves(opt)))]
    assert len(procfns.take_params(full)) == ctx.n_p
    assert len(procfns.take_opt(full)) == len(tree_leaves(opt))
