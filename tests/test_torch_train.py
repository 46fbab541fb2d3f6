"""Parity of the port's training path against the JAX package, on the CPU:
the full-sequence forward and loss and their gradients, the fused train
step with gradient accumulation, the HyPar trainer, and the launcher with
checkpoint and resume.

Both sides start from one state: the JAX package draws it, and it is
carried over through numpy (``repro_torch.weights``); batches come from the
same synthetic stream (numpy, bit for bit the same on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import VirtualCluster as JaxCluster
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.models.config import ModelConfig as JaxConfig
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.optim import OptimizerSpec as JaxSpec
from repro.train import HyParTrainer as JaxHyParTrainer
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import VirtualCluster
from repro_torch.data import DataConfig, SyntheticLMStream, to_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (check_trainable, forward,
                                            init_params, loss_fn)
from repro_torch.optim import OptimizerSpec
from repro_torch.train import HyParTrainer, TrainState, make_train_step
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_numpy, train_state_from_jax_numpy

# the JAX package's integration-test config (tests/test_train_integration.py)
CFG_KW = dict(name="ti", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, compute_dtype="float32")
JCFG, CFG = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
JSPEC, SPEC = JaxSpec(kind="adamw", lr=1e-3), OptimizerSpec(kind="adamw",
                                                            lr=1e-3)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(port_params, jax_params, cfg, atol, rtol=0.0):
    want = from_jax_numpy(_np(jax_params), cfg, CPU)
    for a, b in zip(tree_leaves(port_params), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                   rtol=rtol)


# ---------------------------------------------------------------------------
# forward and loss (qwen2 smoke config: QKV bias, padded vocabulary)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """qwen2's smoke config at fp32 compute with a vocabulary of 500 (so
    the padded rows up to 512 are masked), its JAX weights, one batch."""
    from repro.configs import get_smoke_config as jax_smoke
    jcfg = dataclasses.replace(jax_smoke("qwen2-1.5b"),
                               compute_dtype="float32", vocab_size=500)
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              compute_dtype="float32", vocab_size=500)
    params_j = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = JaxStream(jcfg, JaxDataConfig(global_batch=2, seq_len=48,
                                          pad_frac=0.1)).batch(0)
    return jcfg, cfg, params_j, batch


@pytest.mark.parametrize("impl", ["auto", "tiled"])
def test_forward_and_loss_match_jax(smoke, impl):
    jcfg, cfg, params_j, batch = smoke
    assert cfg.padded_vocab > cfg.vocab_size
    params = from_jax_numpy(_np(params_j), cfg, CPU)
    tb = to_device(batch, CPU)
    want, _ = jax_forward(jcfg, params_j, tokens=jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        got, aux = forward(cfg, params, tokens=tb["tokens"], impl=impl)
        total, metrics = loss_fn(cfg, params, tb, impl=impl)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy() / scale,
                               np.asarray(want) / scale, atol=1e-4)
    jtotal, jm = jax_loss_fn(jcfg, params_j, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-6)
    assert float(aux) == 0.0


def test_loss_gradients_match_jax(smoke):
    jcfg, cfg, params_j, batch = smoke
    params = from_jax_numpy(_np(params_j), cfg, CPU)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    total, _ = loss_fn(cfg, params, to_device(batch, CPU))
    grads = torch.autograd.grad(total, leaves)
    (_, _), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params_j)
    want = tree_leaves(from_jax_numpy(_np(jg), cfg, CPU))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_remat_full_and_none_give_the_same_gradients(smoke):
    import dataclasses
    _, cfg, params_j, batch = smoke
    out = []
    for remat in ("full", "none"):
        params = from_jax_numpy(_np(params_j), cfg, CPU)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        c = dataclasses.replace(cfg, remat=remat)
        total, _ = loss_fn(c, params, to_device(batch, CPU))
        out.append(torch.autograd.grad(total, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # save_dots (recompute all but the 2-D products) gives them too; a
    # policy the reference does not have is refused
    params = from_jax_numpy(_np(params_j), cfg, CPU)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    total, _ = loss_fn(dataclasses.replace(cfg, remat="save_dots"), params,
                       to_device(batch, CPU))
    for a, b in zip(torch.autograd.grad(total, leaves), out[0]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="save_everything"):
        loss_fn(dataclasses.replace(cfg, remat="save_everything"), params,
                to_device(batch, CPU))


def test_forward_refuses_other_families():
    """The forward and the loss run every family: the loss of mamba2 and
    whisper (its frames from ``batch["enc_embeds"]``) is finite, and a
    whisper batch without frames is refused as the forward refuses it.
    gemma3-4b (head dim 256) trains; only a head dim wider than the flash
    backward kernel's (264 here) is refused, before any parameter is
    read."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for arch in ("mamba2-370m", "whisper-base"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, gen, CPU)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.family == "encdec":
            with pytest.raises(ValueError, match="enc_embeds"):
                loss_fn(cfg, params, batch)
            batch["enc_embeds"] = torch.randn((1, 6, cfg.d_model),
                                              generator=gen)
        total, _ = loss_fn(cfg, params, batch)
        assert torch.isfinite(total)
    # gemma3's head dim 256 is the flash backward kernel's widest
    check_trainable(get_config("gemma3-4b"))
    with pytest.raises(NotImplementedError, match="head dim 264"):
        loss_fn(dataclasses.replace(get_config("gemma3-4b"), head_dim=264),
                {}, {"tokens": tokens, "labels": tokens})


# ---------------------------------------------------------------------------
# the fused step and the HyPar trainer against the JAX package
# ---------------------------------------------------------------------------


def _micro(batch, n):
    B = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * B:(i + 1) * B] for k, v in batch.items()}
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's fused step (3 steps, grad_accum 2) and its HyPar
    trainer (3 steps of 2 micro-batches) from one initial state."""
    stream = JaxStream(JCFG, JaxDataConfig(global_batch=4, seq_len=32))
    batches = [stream.batch(s) for s in range(3)]
    state = JaxTrainState.create(JCFG, JSPEC, jax.random.PRNGKey(0))
    init = _np({"params": state.params, "opt_state": state.opt_state,
                "step": state.step})
    step = jax.jit(jax_make_train_step(JCFG, JSPEC, grad_accum=2))
    losses = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss_total"]))
    trainer = JaxHyParTrainer(JCFG, JSPEC, n_micro=2,
                              cluster=JaxCluster(jax.devices()[:1],
                                                 n_schedulers=1))
    hp, _, _ = trainer.run(
        [[jax.tree.map(jnp.asarray, mb) for mb in _micro(b, 2)]
         for b in batches], key=jax.random.PRNGKey(0))
    return {"batches": batches, "init": init, "fused": state,
            "fused_losses": losses, "hypar": hp}


def test_fused_steps_match_jax_from_a_carried_state(jax_runs):
    """3 steps with grad_accum 2 from the reference's initial TrainState;
    2e-5, the reference's own HyPar-vs-fused tolerance."""
    state = train_state_from_jax_numpy(jax_runs["init"], CFG, CPU)
    step = make_train_step(CFG, SPEC, grad_accum=2)
    losses = []
    for b in jax_runs["batches"]:
        state, m = step(state, to_device(b, CPU))
        losses.append(float(m["loss_total"]))
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_runs["fused_losses"], rtol=1e-5)
    _assert_params_close(state.params, jax_runs["fused"].params, CFG, 2e-5)
    want_opt = train_state_from_jax_numpy(
        _np({"params": jax_runs["fused"].params,
             "opt_state": jax_runs["fused"].opt_state,
             "step": jax_runs["fused"].step}), CFG, CPU).opt_state
    assert int(state.opt_state["count"]) == int(want_opt["count"]) == 3
    for a, b in zip(tree_leaves(state.opt_state["m"]),
                    tree_leaves(want_opt["m"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_hypar_trainer_matches_fused_step_and_jax(jax_runs):
    """The port's HyPar trainer from the reference's initial parameters:
    the same parameters as the port's fused step (to the bit on the CPU)
    and as the reference's HyPar trainer (2e-5); gradients retained on the
    workers (no_send_back)."""
    init = train_state_from_jax_numpy(jax_runs["init"], CFG, CPU)
    before = [p.clone() for p in tree_leaves(init.params)]
    trainer = HyParTrainer(CFG, SPEC, n_micro=2,
                           cluster=VirtualCluster([CPU], n_schedulers=1))
    batches = [_micro(to_device(b, CPU), 2) for b in jax_runs["batches"]]
    hp, ho, report = trainer.run(batches, params=init.params)
    for a, b in zip(before, tree_leaves(init.params)):
        assert torch.equal(a, b)            # the input state is untouched
    assert int(ho["count"]) == 3
    grad_jobs = [j for s in report.segments for j in s.jobs
                 if j.startswith("G")]
    assert len(grad_jobs) == 6
    _assert_params_close(hp, jax_runs["hypar"], CFG, 2e-5)

    state = train_state_from_jax_numpy(jax_runs["init"], CFG, CPU)
    step = make_train_step(CFG, SPEC, grad_accum=2)
    for b in jax_runs["batches"]:
        state, _ = step(state, to_device(b, CPU))
    for a, b in zip(tree_leaves(hp), tree_leaves(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["pipelined", "dataflow"])
def test_hypar_trainer_dispatch_modes_agree(mode):
    stream = SyntheticLMStream(CFG, DataConfig(global_batch=4, seq_len=16))
    batches = [_micro(to_device(stream.batch(s), CPU), 2) for s in range(2)]
    runs = []
    for m in ("sync", mode):
        trainer = HyParTrainer(CFG, SPEC, n_micro=2, mode=m,
                               cluster=VirtualCluster([CPU], n_schedulers=1))
        gen = torch.Generator().manual_seed(7)
        runs.append(trainer.run(batches, generator=gen)[0])
    for a, b in zip(*(tree_leaves(r) for r in runs)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ports of the reference's integration tests (tests/test_train_integration.py)
# ---------------------------------------------------------------------------


def test_loss_decreases_over_training():
    stream = SyntheticLMStream(CFG, DataConfig(global_batch=8, seq_len=64,
                                               zipf_a=1.5))
    step = make_train_step(CFG, SPEC)
    state = TrainState.create(CFG, SPEC, torch.Generator().manual_seed(1),
                              CPU)
    losses = []
    for s in range(30):
        state, m = step(state, to_device(stream.batch(s % 4), CPU))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::6]


def test_grad_accum_invariance():
    """accum=1 on batch B equals accum=2 on the same batch (mean of
    grads)."""
    stream = SyntheticLMStream(CFG, DataConfig(global_batch=4, seq_len=16,
                                               pad_frac=0.0))
    b = to_device(stream.batch(0), CPU)
    out = []
    for accum in (1, 2):
        state = TrainState.create(CFG, SPEC,
                                  torch.Generator().manual_seed(2), CPU)
        state, _ = make_train_step(CFG, SPEC, grad_accum=accum)(state, b)
        out.append(tree_leaves(state.params))
    for a, c in zip(*out):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=3e-5,
                                   rtol=1e-4)


def _launch_argv(ckpt_dir, steps):
    return ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(ckpt_dir), "--ckpt-every", "3", "--log-every", "3"]


def test_train_launcher_end_to_end_and_resume_equals_uninterrupted(tmp_path):
    """``launch/train.py`` main(): 6 steps with checkpoints, a resume to 8,
    and the resumed run's final state equals an uninterrupted 8-step
    run's."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch.train import main
    loss1 = main(_launch_argv(tmp_path / "a", 6))
    assert np.isfinite(loss1) and latest_step(str(tmp_path / "a")) == 6
    loss2 = main(_launch_argv(tmp_path / "a", 8))
    assert np.isfinite(loss2) and latest_step(str(tmp_path / "a")) == 8
    loss3 = main(_launch_argv(tmp_path / "b", 8))
    assert loss3 == loss2
    cfg = get_smoke_config("qwen2-1.5b")
    like = TrainState.create(cfg, OptimizerSpec(kind=cfg.optimizer),
                             torch.Generator().manual_seed(9), CPU).tree()
    resumed, s1 = restore_checkpoint(str(tmp_path / "a"), like)
    straight, s2 = restore_checkpoint(str(tmp_path / "b"), like)
    assert s1 == s2 == 8 and int(resumed["step"]) == 8
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(a, b)


def test_train_launcher_hypar_engine():
    from repro_torch.launch.train import main
    dt = main(["--smoke", "--device", "cpu", "--engine", "hypar", "--steps",
               "2", "--batch", "4", "--seq", "16", "--grad-accum", "2"])
    assert dt > 0
