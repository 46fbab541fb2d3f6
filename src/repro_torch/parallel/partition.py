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

Placing a tree by its specs (the reference's ``jax.device_put`` with
``tree_shardings``, done here by hand): :func:`place_tree` splits each
leaf into one block a position of a
:class:`~repro_torch.launch.mesh.DeviceMesh`.  Each dim goes over the mesh
axes its spec names (``spec_for`` has already dropped every axis that does
not divide it); a dim its spec leaves ``None`` is held whole on every
position, as the reference replicates it, so a position holds exactly the
reference's ``shard_shape`` bytes.  Positions that share a region hold
equal copies of their own.  On a 1 x 1 grid a leaf is placed as itself.

A reference quirk kept line for line: ``_leaf_axes`` strips the optimizer
keys ``m``, ``v``, ``f``, ``vr``, ``vc`` from a leaf's path to find its
parameter, so it strips the attention's ``v`` projection's key too, and
the V projection's weight and bias (and their moments) are replicated
where Q, K and O split over ``heads_flat``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from .sharding import DEFAULT_RULES, ShardingRules

__all__ = ["axes_for_path", "model_axis_dim", "tree_logical_axes",
           "tree_specs", "batch_logical_axes", "Placed", "place_leaf", "place_tree",
           "place_state", "gather_tree", "position_bytes", "spec_bytes"]


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


@dataclasses.dataclass(frozen=True)
class _ModelRow:
    """The ``model`` axis of a row of ``n`` tensor-parallel positions, as
    a mesh ``spec_for`` reads: only its axis sizes matter."""
    n: int

    @property
    def shape(self) -> dict[str, int]:
        return {"model": self.n}


def model_axis_dim(path: Sequence[str], shape, n: int) -> int | None:
    """The dim of a parameter leaf at ``path`` (only its names matter:
    ``("moe", "gate")``, ``("mixer", "in_proj", "w")``, ``("embed",
    "table")`` …) with ``shape`` that ``DEFAULT_RULES`` put on ``model``
    in a row of ``n`` tensor-parallel positions; None where the leaf stays
    whole (``spec_for`` drops an axis ``n`` does not divide, and the
    ``data``/``pod`` axes never take ``model``'s place)."""
    if n <= 1:
        return None
    rules = ShardingRules(mesh=_ModelRow(n), rules=dict(DEFAULT_RULES))
    spec = rules.spec_for(axes_for_path(tuple(path), len(shape)),
                          dims=tuple(shape))
    for d, e in enumerate(spec):
        if e == "model" or isinstance(e, tuple) and "model" in e:
            return d
    return None


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


# ---------------------------------------------------------------------------
# Placing a tree on a device grid by its specs
# ---------------------------------------------------------------------------


def _spec_axes(spec: tuple, ndim: int) -> list[tuple[str, ...]]:
    """The mesh axes of each of ``ndim`` dims (``()`` for a whole dim)."""
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        out.append(() if e is None else tuple(e) if isinstance(e, tuple)
                   else (e,))
    return out


def regions(mesh, spec: tuple, shape) -> list[tuple[slice, ...]]:
    """Each position's region of a tensor of ``shape`` placed by ``spec``:
    a dim over axes ``(a, b)`` is cut into ``size(a)·size(b)`` equal
    blocks, and the position takes the block its coordinates on ``a`` and
    ``b`` index (row-major)."""
    sizes = mesh.shape
    axes = _spec_axes(spec, len(shape))
    out = []
    for c in mesh.coords():
        region = []
        for n, dim_axes in zip(shape, axes):
            parts, idx = 1, 0
            for a in dim_axes:
                idx = idx * sizes[a] + c[a]
                parts *= sizes[a]
            step = n // parts
            region.append(slice(idx * step, (idx + 1) * step))
        out.append(tuple(region))
    return out


@dataclasses.dataclass
class Placed:
    """A tensor placed on ``mesh`` by ``spec``: ``blocks[k]`` lives on the
    mesh's k-th position and holds its region (:func:`regions`); positions
    that share a region hold equal copies."""

    mesh: Any
    spec: tuple
    shape: torch.Size
    blocks: list

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def regions(self) -> list[tuple[slice, ...]]:
        return regions(self.mesh, self.spec, self.shape)

    def distinct(self) -> list[int]:
        """The first position of each region, in position order: each
        element of the tensor once."""
        seen, out = set(), []
        for k, r in enumerate(self.regions()):
            key = tuple((s.start, s.stop) for s in r)
            if key not in seen:
                seen.add(key)
                out.append(k)
        return out

    @torch.no_grad()
    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's lead by default)."""
        device = self.mesh.lead if device is None else device
        regs = self.regions()
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for k in self.distinct():
            out[regs[k]].copy_(self.blocks[k])
        return out

    @torch.no_grad()
    def scatter_(self, whole: torch.Tensor) -> None:
        """Write ``whole`` into every position's block."""
        for blk, reg in zip(self.blocks, self.regions()):
            blk.copy_(whole[reg])


@torch.no_grad()
def place_leaf(t: torch.Tensor, mesh, spec: tuple):
    """``t`` placed on ``mesh`` by ``spec``: a :class:`Placed` whose
    blocks are copies on their positions; ``t`` itself on a 1 x 1 grid."""
    if mesh.size == 1:
        return t
    blocks = []
    for dev, reg in zip(mesh.flat, regions(mesh, spec, t.shape)):
        blk = torch.empty(tuple(s.stop - s.start for s in reg),
                          dtype=t.dtype, device=dev)
        blocks.append(blk.copy_(t[reg]))
    return Placed(mesh=mesh, spec=spec, shape=t.shape, blocks=blocks)


def place_tree(tree, mesh, rules: ShardingRules, *, kind: str = "params"):
    """Every tensor leaf of ``tree`` placed by its ``tree_specs`` spec
    (other leaves, such as a step count held as an int, stay as they
    are); the tree itself on a 1 x 1 grid."""
    if mesh.size == 1:
        return tree
    def one(keys, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = rules.spec_for(_leaf_axes(keys, leaf, kind), dims=leaf.shape)
        return place_leaf(leaf, mesh, spec)
    return _walk(_as_tree(tree), (), one)


def place_state(tree, mesh):
    """A training state's tree (``{"params", "opt_state"[, "step"]}``)
    placed on ``mesh`` by its ``kind="state"`` specs under the default
    rules, as the reference's launcher places its ``TrainState``."""
    return place_tree(tree, mesh, ShardingRules(mesh=mesh,
                                                rules=dict(DEFAULT_RULES)),
                      kind="state")


def gather_tree(tree, device=None):
    """``tree`` with every :class:`Placed` leaf gathered whole on
    ``device`` (its mesh's lead by default)."""
    return _walk(_as_tree(tree), (), lambda keys, leaf: leaf.gather(device)
                 if isinstance(leaf, Placed) else leaf)


def position_bytes(tree) -> list[int]:
    """The bytes each grid position holds of the :class:`Placed` leaves of
    ``tree``."""
    out: list[int] = []

    def add(keys, leaf):
        if isinstance(leaf, Placed):
            out.extend([0] * (len(leaf.blocks) - len(out)))
            for k, b in enumerate(leaf.blocks):
                out[k] += b.numel() * b.element_size()
    _walk(_as_tree(tree), (), add)
    return out


def spec_bytes(tree, rules: ShardingRules, *, kind: str = "params") -> int:
    """The bytes one position of ``rules.mesh`` holds of ``tree``'s tensor
    leaves (tensors or :class:`Placed`) placed by their specs: each leaf's
    reference ``shard_shape`` times its item size, summed."""
    sizes = rules.mesh.shape
    total = 0

    def add(keys, leaf):
        nonlocal total
        if not isinstance(leaf, (torch.Tensor, Placed)):
            return
        spec = rules.spec_for(_leaf_axes(keys, leaf, kind), dims=leaf.shape)
        n = leaf.dtype.itemsize
        for dim, axes in zip(leaf.shape, _spec_axes(spec, len(leaf.shape))):
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n
    _walk(_as_tree(tree), (), add)
    return total
