"""Path-based logical axes for parameter / optimizer / cache trees, the JAX
package's ``parallel/partition.py`` without JAX.

One central mapping from tree paths to logical axis names (resolved by
``ShardingRules.spec_for``, which drops non-dividing axes).  This is the
framework's equivalent of the paper's automatic data distribution: the user
declares *what* a tensor is (by its place in the tree); the framework
derives placement.

The port's trees are nested dicts and lists (``repro_torch.tree``).  Its
parameters are unstacked (``layers/<i>/…``, one dict a layer; see
``weights.from_jax_numpy``), so a layer leaf has no leading group axis:
``pad`` gives it the axes the reference gives its stacked counterpart,
less the group axis.  The serving cache stacks its layers on a leading
axis, as the reference's groups are stacked.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .sharding import ShardingRules

__all__ = ["axes_for_path", "tree_logical_axes", "tree_specs",
           "batch_logical_axes"]


def _last(path: Sequence[str], *names: str) -> bool:
    return len(path) >= 1 and path[-1] in names


def _contains(path: Sequence[str], *names: str) -> bool:
    return any(p in names for p in path)


def axes_for_path(path: tuple[str, ...], ndim: int) -> tuple[Any, ...]:
    """Logical axes for a *parameter* leaf at ``path`` with rank ``ndim``.

    Stacked (scanned) leaves carry a leading group axis — detected by the
    caller passing the raw ndim; any extra leading dims map to None.
    """
    p = [str(x) for x in path]

    def pad(axes: tuple) -> tuple:
        extra = ndim - len(axes)
        return (None,) * extra + axes if extra > 0 else axes[-ndim:] if ndim else ()

    # --- embeddings ---------------------------------------------------------
    if _last(p, "table", "unembed"):
        return pad(("vocab", "embed_fsdp"))
    if _last(p, "enc_pos", "dec_pos"):
        return pad((None, "embed_fsdp"))

    # --- MoE ------------------------------------------------------------------
    if _contains(p, "moe"):
        if _last(p, "w") and _contains(p, "router"):
            return pad(("embed_fsdp", None))
        if _last(p, "gate", "up") and not _contains(p, "shared"):
            return pad(("experts", "embed_fsdp", "d_ff"))
        if _last(p, "down") and not _contains(p, "shared"):
            return pad(("experts", "d_ff", "embed_fsdp"))
        if _last(p, "shared_gate"):
            return pad((None, None))
        # shared expert falls through to MLP rules below

    # --- attention -------------------------------------------------------------
    if _contains(p, "attn", "cross"):
        if _last(p, "w"):
            if _contains(p, "q", "k", "v"):
                return pad(("embed_fsdp", "heads_flat"))
            if _contains(p, "o"):
                return pad(("heads_flat", "embed_fsdp"))
        if _last(p, "b"):
            return pad((None,))

    # --- SSM ----------------------------------------------------------------
    if _contains(p, "mixer"):
        if _contains(p, "in_proj") and _last(p, "w"):
            return pad(("embed_fsdp", "ssm_inner"))
        if _contains(p, "out_proj") and _last(p, "w"):
            return pad(("ssm_inner", "embed_fsdp"))
        if _last(p, "conv_w"):
            return pad((None, "ssm_inner"))
        return pad((None,) * ndim)

    # --- MLP -------------------------------------------------------------------
    if _contains(p, "mlp", "shared"):
        if _last(p, "w"):
            if _contains(p, "up", "gate"):
                return pad(("embed_fsdp", "d_ff"))
            if _contains(p, "down"):
                return pad(("d_ff", "embed_fsdp"))
        if _last(p, "b"):
            return pad((None,))

    # --- norms / scalars ---------------------------------------------------------
    return pad((None,) * max(ndim, 0))


# KV / SSM cache leaves -------------------------------------------------------


def _cache_axes(path: tuple[str, ...], ndim: int) -> tuple:
    p = [str(x) for x in path]
    if _last(p, "k", "v"):
        # cache layout (B, KV, T, D)
        axes = ("batch", "kv_heads", "kv_seq", None)
    elif _last(p, "state"):
        axes = ("batch", "ssm_heads", None, None)
    elif _last(p, "conv"):
        axes = ("batch", None, "ssm_inner")
    elif _last(p, "len"):
        return ()
    else:
        axes = (None,) * ndim
    extra = ndim - len(axes)
    return (None,) * extra + axes if extra > 0 else axes[-ndim:]


def _opt_transform(path: tuple[str, ...], axes: tuple, ndim: int) -> tuple:
    """Adafactor factored stats reshape the param axes."""
    p = [str(x) for x in path]
    if _last(p, "vr"):
        return axes[:-1]
    if _last(p, "vc"):
        return axes[:-2] + axes[-1:]
    return axes


def _leaf_axes(keys: tuple[str, ...], leaf, kind: str) -> tuple:
    ndim = len(getattr(leaf, "shape", ()))
    if kind == "cache":
        return _cache_axes(keys, ndim)
    # strip optimizer wrappers to find the parameter path
    core = tuple(k for k in keys
                 if k not in ("params", "opt_state", "m", "v", "f",
                              "step", "count", "vr", "vc"))
    if keys and keys[-1] in ("step", "count"):
        return ()
    if keys[-1] in ("vr", "vc"):
        base = axes_for_path(core, ndim + (1 if keys[-1] == "vr" else 1))
        return _opt_transform(keys, base, ndim)
    return axes_for_path(core, ndim)


def _walk(tree, keys: tuple[str, ...], leaf_fn):
    if isinstance(tree, dict):
        return {k: _walk(v, keys + (str(k),), leaf_fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, keys + (str(i),), leaf_fn)
                          for i, v in enumerate(tree))
    return leaf_fn(keys, tree)


def _as_tree(tree):
    """A ``TrainState`` (a dataclass) as its tree of fields."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return tree


def tree_logical_axes(tree, *, kind: str = "params"):
    """Tree of logical-axes tuples matching ``tree``'s structure.

    kind: params | state (TrainState incl. optimizer) | cache
    """
    return _walk(_as_tree(tree), (),
                 lambda keys, leaf: _leaf_axes(keys, leaf, kind))


def tree_specs(tree, rules: ShardingRules, *, kind: str = "params"):
    """The spec tuple of every leaf of ``tree`` (tensors or anything with a
    ``shape``): the reference's ``tree_shardings``, whose ``NamedSharding``
    a spec and its mesh stand for."""
    return _walk(_as_tree(tree), (), lambda keys, leaf: rules.spec_for(
        _leaf_axes(keys, leaf, kind), dims=getattr(leaf, "shape", ())))


def batch_logical_axes(batch) -> Any:
    return _walk(batch, (), lambda keys, leaf:
                 ("batch",) + (None,) * (len(leaf.shape) - 1))
