"""The port's sharding rules (``repro_torch.parallel``) against the JAX
package's: ``ShardingRules.spec_for`` over a hypothesis search of logical
names, dims and meshes; the reference's properties (divisibility, no axis
reused, a missing axis dropped) held on the port; and the path-based axes
of every configuration's parameter, optimizer-state and cache trees, each
port leaf against its reference counterpart with the reference's stacked
group axis dropped.

Port leaves are matched to reference leaves by value: every reference leaf
is filled with its own index, and ``weights.from_jax_numpy`` /
``train_state_from_jax_numpy`` carry the values into the port's layout.
"""
import dataclasses

import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_paged_cache as jax_init_paged
from repro.models.transformer import init_params as jax_init
from repro.optim import OptimizerSpec as JaxOptimizerSpec
from repro.parallel.partition import tree_logical_axes as jax_axes
from repro.parallel.sharding import DEFAULT_RULES as JAX_RULES
from repro.parallel.sharding import ShardingRules as JaxRules
from repro.train.step import TrainState as JaxTrainState
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.transformer import (init_cache, init_paged_cache,
                                            init_params)
from repro_torch.parallel import DEFAULT_RULES, ShardingRules, logical_spec
from repro_torch.parallel.partition import (batch_logical_axes,
                                            tree_logical_axes, tree_specs)
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.weights import from_jax_numpy, train_state_from_jax_numpy

# configurations the port runs (it refuses no block kind of the repo's)
PORT_ARCHS = list(ARCHS)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def rules(meshshape):
    return ShardingRules(mesh=FakeMesh(meshshape), rules=dict(DEFAULT_RULES))


def test_default_rules_are_the_references():
    assert DEFAULT_RULES == JAX_RULES


NAMES = st.sampled_from(sorted(DEFAULT_RULES) + [None, "not_a_rule"])
MESHES = st.fixed_dictionaries({}, optional={
    "pod": st.sampled_from([1, 2]),
    "data": st.sampled_from([1, 2, 4]),
    "model": st.sampled_from([1, 2, 4, 8])})


@given(MESHES, st.lists(st.tuples(NAMES, st.integers(1, 64)), min_size=1,
                        max_size=5), st.booleans())
@settings(max_examples=200, deadline=None)
def test_spec_for_matches_reference(meshshape, named_dims, with_dims):
    """The port's spec tuple is the reference's ``PartitionSpec`` entries,
    trailing Nones stripped alike, with and without dims."""
    names = [n for n, _ in named_dims]
    dims = [d for _, d in named_dims] if with_dims else None
    mesh = FakeMesh(meshshape)
    want = JaxRules(mesh=mesh, rules=dict(JAX_RULES)).spec_for(names, dims)
    got = ShardingRules(mesh=mesh, rules=dict(DEFAULT_RULES)).spec_for(
        names, dims)
    assert got == tuple(want)
    for axis in ("data", ("pod", "data"), None):
        assert (ShardingRules(mesh=mesh, rules={}).axis_size(axis)
                == JaxRules(mesh=mesh, rules={}).axis_size(axis))


def test_spec_for_without_a_mesh_is_the_references():
    """With no mesh every axis has size 1: nothing is dropped for
    divisibility, as in the reference, and ``logical_spec`` without rules
    is the empty spec."""
    r = ShardingRules(mesh=None, rules=dict(DEFAULT_RULES))
    want = JaxRules(mesh=None, rules=dict(JAX_RULES)).spec_for(
        ("batch", "heads"), dims=(8, 7))
    assert r.spec_for(("batch", "heads"), dims=(8, 7)) == tuple(want)
    assert r.axis_size("model") == 1
    assert logical_spec(("batch",), (8,)) == ()
    assert logical_spec(("batch",), (8,), rules({"data": 2})) == ("data",)


@given(st.integers(1, 64), st.integers(1, 64), st.integers(0, 4))
@settings(max_examples=60, deadline=None)
def test_spec_never_violates_divisibility(d0, d1, pick):
    """For any tensor dims, every mesh axis in the resolved spec divides the
    corresponding dim."""
    r = rules({"pod": 2, "data": 4, "model": 8})
    names = [("batch", None), ("batch", "d_ff"), ("vocab", "embed_fsdp"),
             ("heads", None), ("experts", "d_ff")][pick]
    spec = r.spec_for(names, dims=(d0, d1))
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= r.mesh.shape[a]
        assert (d0, d1)[i] % size == 0


def test_no_axis_reused_across_dims():
    r = rules({"data": 4, "model": 4})
    spec = r.spec_for(("seq", "heads"), dims=(16, 16))  # both want "model"
    axes = [a for entry in spec if entry
            for a in (entry if isinstance(entry, tuple) else (entry,))]
    assert len(axes) == len(set(axes))


def test_missing_mesh_axis_is_dropped():
    r = rules({"data": 4, "model": 4})          # no "pod"
    assert r.spec_for(("batch", None), dims=(8, 8)) == ("data",)


# ---------------------------------------------------------------------------
# path-based axes, leaf by leaf against the reference
# ---------------------------------------------------------------------------


def _tagged(struct):
    """numpy arrays of ``struct``'s shapes (a pytree of ShapeDtypeStructs),
    leaf i filled with i."""
    leaves, treedef = jax.tree_util.tree_flatten(struct)
    return jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32)
                  for i, leaf in enumerate(leaves)])


def _ref_axes_by_tag(struct, kind):
    """The reference's axes of each tagged leaf, and whether the leaf sits
    under ``groups`` (stacked: its first axis is the group axis)."""
    axes = jax.tree.leaves(jax_axes(struct, kind=kind),
                           is_leaf=lambda x: isinstance(x, tuple))
    flat, _ = jax.tree_util.tree_flatten_with_path(struct)
    return [(ax, any(getattr(k, "key", None) in ("groups", "enc_groups")
                     for k in path))
            for ax, (path, _) in zip(axes, flat)]


def _axes_paths(axes_tree):
    """``tree_paths`` of an axes tree stops at the tuples' entries; rebuild
    ``{leaf path: axes tuple}``."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out[prefix] = t
    walk(axes_tree, "")
    return out


def _check(port_tree, port_axes, ref):
    axes = _axes_paths(port_axes)
    n = 0
    for path, leaf in tree_paths(port_tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        tag = int(leaf.reshape(-1)[0]) if leaf.numel() else None
        if tag is None:
            continue
        want, stacked = ref[tag]
        want = tuple(want[1:]) if stacked else tuple(want)
        assert axes[path] == want, (path, axes[path], want)
        assert len(axes[path]) == leaf.dim(), (path, tuple(leaf.shape))
        n += 1
    assert n > 0


def _models(arch):
    jc = jax_smoke(arch)
    tc = get_smoke_config(arch)
    return jc, tc


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_param_axes_match_reference(arch):
    """Every port parameter leaf of every configuration's smoke config has
    the axes the reference gives its counterpart, the stacked group axis
    dropped; none is left without axes."""
    jc, tc = _models(arch)
    struct = jax.eval_shape(lambda k: jax_init(jc, k), jax.random.PRNGKey(0))
    tagged = _tagged(struct)
    port = from_jax_numpy(tagged, tc, "cpu")
    _check(port, tree_logical_axes(port, kind="params"),
           _ref_axes_by_tag(struct, "params"))
    assert len(tree_leaves(port)) == len(
        _axes_paths(tree_logical_axes(port, kind="params")))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "whisper-base", "gemma3-4b"])
def test_state_axes_match_reference(arch, kind):
    """The optimizer state's axes (AdamW ``m``/``v``; Adafactor's factored
    ``vr``/``vc`` — factored from 32 so the smoke widths factor — and
    unfactored ``v``) and the step's, leaf by leaf."""
    jc, tc = _models(arch)
    spec = JaxOptimizerSpec(kind=kind, lr=1e-3, factored_min=32)
    struct = jax.eval_shape(lambda k: JaxTrainState.create(jc, spec, k),
                            jax.random.PRNGKey(0))
    tagged = _tagged(struct)
    state_np = {"params": tagged.params, "opt_state": tagged.opt_state,
                "step": tagged.step}
    port = train_state_from_jax_numpy(state_np, tc, "cpu")
    axes = tree_logical_axes(port, kind="state")
    assert axes["step"] == ()
    if kind == "adafactor":
        keys = {p.rsplit("/", 1)[-1] for p, _ in
                tree_paths(port.opt_state["f"])}
        assert {"vr", "vc"} <= keys, keys
    tree = {"params": port.params, "opt_state": port.opt_state}
    _check(tree, {"params": axes["params"], "opt_state": axes["opt_state"]},
           _ref_axes_by_tag(struct, "state"))


def _cache_by_key(ref_struct):
    """The reference cache's axes by the leaf's last key (k, v, conv,
    state, len), each as the port's layer-stacked leaf sees it."""
    axes = jax.tree.leaves(jax_axes(ref_struct, kind="cache"),
                           is_leaf=lambda x: isinstance(x, tuple))
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_struct)
    out: dict = {}
    for ax, (path, _) in zip(axes, flat):
        key = getattr(path[-1], "key", getattr(path[-1], "name", None))
        stacked = getattr(path[0], "key", None) == "groups"
        unstacked = tuple(ax[1:]) if stacked else tuple(ax)
        out.setdefault(key, set()).add(unstacked)
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "zamba2-1.2b", "mixtral-8x7b"])
def test_cache_axes_match_reference(arch, paged):
    """The dense and paged serving caches: each port leaf (stacked on a
    layer axis) has the reference's axes for that leaf, the stacking axis
    dropped on both sides."""
    jc, tc = _models(arch)
    if paged:
        struct = jax.eval_shape(lambda: jax_init_paged(
            jc, 2, num_pages=9, page_size=8))
        port = init_paged_cache(tc, 2, num_pages=9, page_size=8,
                                device="meta")
    else:
        struct = jax.eval_shape(lambda: jax_init_cache(jc, 2, 32))
        port = init_cache(tc, 2, 32, device="meta")
    want = _cache_by_key(struct)
    axes = tree_logical_axes(port, kind="cache")
    assert set(axes) == set(want)
    for key, ax in axes.items():
        got = ax if key == "len" else tuple(ax[1:])
        assert want[key] == {got}, (key, got, want[key])
        if key != "len":           # () for the paged (B,) lengths too
            assert len(ax) == port[key].dim()


def test_vocab_and_ff_sharded_on_model():
    """qwen2-1.5b at full width (reference ``test_sharding.py:77-87``):
    the embedding on vocab x embed_fsdp, the MLP's up projection on
    embed_fsdp x d_ff — no stacked layer axis in the port."""
    params = init_params(get_config("qwen2-1.5b"), torch.Generator(), "meta")
    axes = tree_logical_axes(params, kind="params")
    assert axes["embed"]["table"] == ("vocab", "embed_fsdp")
    assert axes["layers"][0]["mlp"]["up"]["w"] == ("embed_fsdp", "d_ff")
    ref = jax_axes(jax.eval_shape(lambda k: jax_init(jax_config("qwen2-1.5b"),
                                                     k),
                                  jax.random.PRNGKey(0)), kind="params")
    assert ref["groups"][0]["mlp"]["up"]["w"] == (None, "embed_fsdp", "d_ff")


def test_tree_specs_resolve_on_a_mesh():
    """``tree_specs`` is ``spec_for`` of every leaf's axes and shape: the
    reference's ``tree_shardings`` specs."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), n_layers=1)
    params = init_params(cfg, torch.Generator(), "meta")
    r = rules({"data": 2, "model": 2})
    specs = tree_specs(params, r, kind="params")
    assert specs["embed"]["table"] == ("model", "data")
    q = params["layers"][0]["attn"]["q"]["w"]
    assert specs["layers"][0]["attn"]["q"]["w"] == r.spec_for(
        ("embed_fsdp", "heads_flat"), q.shape) == ("data", "model")
    assert specs["norm_f"]["scale"] == ()
    assert batch_logical_axes({"tokens": torch.zeros(4, 8),
                               "mask": torch.zeros(4, 8, 2)}) == {
        "tokens": ("batch", None), "mask": ("batch", None, None)}
