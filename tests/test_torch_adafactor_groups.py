"""Adafactor's update-RMS clip over the reference's stacked layers.

The JAX package stacks the layers of each position of its layer pattern
on a leading axis, so its Adafactor clip (``_update_adafactor``) takes one
RMS over the same tensor of all the layers of a group.  The port keeps a
dict per layer; ``models.transformer.clip_groups`` names the leaves that
form one stacked leaf there, and the optimizer clips them together.

The step test trains llama3-405b's smoke config (3 layers, one stacked
group) under Adafactor with fp32 parameters and compute for one fused step
from the JAX package's state, against the reference's ``make_train_step``
on the CPU: every parameter within 1e-6 of its leaf's scale and every
moment within 2e-6 (see ``MOMENT_TOL``).
At lr 1e-2 the factored leaves' per-layer update RMS straddle 1, so the
same step with each layer tensor clipped alone (no groups) misses that
bound: the test checks that too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.optim import OptimizerSpec as JaxSpec
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import to_device
from repro_torch.models.transformer import (clip_groups, init_params,
                                            layer_plan)
from repro_torch.optim import OptimizerSpec, init_opt_state, opt_update
from repro_torch.train import compute_grads, make_train_step
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.weights import train_state_from_jax_numpy

CPU = torch.device("cpu")
ARCH = "llama3-405b"
KW = dict(optimizer="adafactor", param_dtype="float32",
          compute_dtype="float32")
LR = 1e-2
TOL = 1e-6               # of each leaf's max|value|
# moments: step 1's is g² (β₂ = 0 at count 1), which doubles the
# gradients' own relative rounding difference between the frameworks (fp32
# sums in other orders: 6.4e-7 at the key projection's gradient)
MOMENT_TOL = 2e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the leaf's scale."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _worst(got_tree, want_tree) -> tuple[float, str]:
    """The largest :func:`_close` over the leaves, with its path."""
    return max((_close(a, b), path) for (path, a), b in zip(
        tree_paths(got_tree), tree_leaves(want_tree)))


@pytest.fixture(scope="module")
def reference():
    """The reference's state before and after one fused Adafactor step."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **KW)
    jspec = JaxSpec(kind="adafactor", lr=LR)
    state = JaxTrainState.create(jcfg, jspec, jax.random.PRNGKey(3))
    init = _np({"params": state.params, "opt_state": state.opt_state,
                "step": state.step})
    batch = JaxStream(jcfg, JaxDataConfig(global_batch=4,
                                          seq_len=32)).batch(0)
    step = jax.jit(jax_make_train_step(jcfg, jspec, grad_accum=1))
    after, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    after = _np({"params": after.params, "opt_state": after.opt_state,
                 "step": after.step})
    return {"init": init, "batch": batch, "after": after,
            "loss": float(metrics["loss_total"])}


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), **KW)


def test_clip_groups_pair_each_path_over_the_stacked_layers():
    """llama3 smoke: 3 dense layers in one stacked group, so each block
    path is one group of its 3 layer leaves; embed, norm_f and unembed
    stand alone."""
    cfg = _cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    groups = clip_groups(cfg, params)
    leaves = tree_leaves(params)
    per_layer = len(tree_leaves(params["layers"][0]))
    assert len(groups) == per_layer
    assert all(len(g) == 3 for g in groups)
    for g in groups:
        assert len({tuple(leaves[i].shape) for i in g}) == 1
    assert sum(map(len, groups)) == len(tree_leaves(params["layers"]))


def test_clip_groups_leave_out_the_tail_and_the_shared_block():
    """zamba2 smoke: the shared block and the tail layers stack with
    nothing; gemma3: local and global positions stack apart; whisper: the
    encoder's layers are one group a path.  A leaf is grouped exactly
    when the reference stacks it, with the others of its group size."""
    gen = torch.Generator().manual_seed(0)
    for arch in ("zamba2-1.2b", "gemma3-4b", "whisper-base"):
        cfg = get_smoke_config(arch)
        plan = layer_plan(cfg)
        params = init_params(cfg, gen, CPU)
        groups = clip_groups(cfg, params)
        assert {len(g) for g in groups} <= {plan.n_groups, plan.enc_groups}
        grouped = {i for g in groups for i in g}
        for i, (path, _) in enumerate(tree_paths(params)):
            top, *rest = path.split("/")
            stacked = top == "enc_layers" or (
                top == "layers"
                and int(rest[0]) < len(plan.pattern) * plan.n_groups)
            assert (i in grouped) == stacked, path


def test_adafactor_step_clips_over_the_stacked_groups(reference):
    """One fused step of llama3 smoke under Adafactor (fp32) against the
    reference's: loss and every parameter within 1e-6 of its leaf's scale,
    every factored or full moment within ``MOMENT_TOL``."""
    cfg = _cfg()
    spec = OptimizerSpec(kind="adafactor", lr=LR)
    state = train_state_from_jax_numpy(reference["init"], cfg, CPU)
    step = make_train_step(cfg, spec, grad_accum=1)
    state, metrics = step(state, to_device(reference["batch"], CPU))
    np.testing.assert_allclose(float(metrics["loss_total"]),
                               reference["loss"], rtol=1e-6)
    want = train_state_from_jax_numpy(reference["after"], cfg, CPU)
    worst = _worst(state.params, want.params)
    assert worst[0] <= TOL, worst
    worst = _worst(state.opt_state["f"], want.opt_state["f"])
    assert worst[0] <= MOMENT_TOL, worst


def test_per_tensor_clip_misses_the_reference(reference):
    """The same step with each layer tensor clipped alone (what the port
    did before its clip took the stacked groups) is outside the bound:
    the step test above tells the two apart."""
    cfg = _cfg()
    spec = OptimizerSpec(kind="adafactor", lr=LR)
    state = train_state_from_jax_numpy(reference["init"], cfg, CPU)
    grads, _, _ = compute_grads(cfg, state.params,
                                to_device(reference["batch"], CPU))
    new_p, _, _ = opt_update(spec, grads, state.opt_state, state.params)
    want = train_state_from_jax_numpy(reference["after"], cfg, CPU)
    worst = _worst(new_p, want.params)
    assert worst[0] > 100 * TOL, worst
    grouped, _, _ = opt_update(spec, grads, state.opt_state, state.params,
                               clip_groups=clip_groups(cfg, state.params))
    worst = _worst(grouped, want.params)
    assert worst[0] <= TOL, worst


def test_a_factored_stacked_vector_is_refused():
    """At factored_min 3 the reference factors llama3 smoke's stacked
    (3, 128) norm scales (one column moment for the 3 layers); the port's
    per-layer state cannot hold that, so the update raises, naming the
    leaf, and leaves the state as it was."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **KW)
    jstate = jax_init_opt_state(JaxSpec(kind="adafactor", factored_min=3),
                                JaxTrainState.create(
                                    jcfg, JaxSpec(kind="adafactor"),
                                    jax.random.PRNGKey(0)).params)
    assert set(jstate["f"]["groups"][0]["ln1"]["scale"]) == {"vr", "vc"}
    cfg = _cfg()
    spec = OptimizerSpec(kind="adafactor", factored_min=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    state = init_opt_state(spec, params)
    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    from repro_torch.tree import tree_unflatten
    before = [p.clone() for p in tree_leaves(params)]
    with pytest.raises(ValueError, match=r"layers/0/ln1/scale"):
        opt_update(spec, tree_unflatten(params, grads), state, params,
                   inplace=True, clip_groups=clip_groups(cfg, params))
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)
    # at the default factored_min (128) no group reaches it
    opt_update(OptimizerSpec(kind="adafactor"),
               tree_unflatten(params, grads),
               init_opt_state(OptimizerSpec(kind="adafactor"), params),
               params, clip_groups=clip_groups(cfg, params))
