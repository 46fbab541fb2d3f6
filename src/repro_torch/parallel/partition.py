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
:func:`place_cache` places a dense serving cache so, the reference's
decode cells' ``tree_shardings(kind="cache")``: its K/V split by slot,
KV head and sequence, the SSM state by slot and head and the conv tail
by slot and channel, ``len`` whole on the lead.

A training mesh's step does not gather a leaf whole: each position
gathers only the region it computes with (:meth:`Placed.gather_region`,
:meth:`Placed.take`), when it uses it, the reference's per-layer all-gather
of its ZeRO-3 storage.  Where the gather's leaf carries gradient sums
(:class:`RegionSums`, :meth:`Placed.for_row`), its backward adds the
region's gradient into fp32 sums at the blocks the region came from (the
reference's reduce-scatter), so no whole gradient is made either.

A reference quirk kept line for line: ``_leaf_axes`` strips the optimizer
keys ``m``, ``v``, ``f``, ``vr``, ``vc`` from a leaf's path to find its
parameter, so it strips the attention's ``v`` projection's key too, and
the V projection's weight and bias (and their moments) are replicated
where Q, K and O split over ``heads_flat``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import threading
from typing import Any, Sequence

import torch

from ..analysis import opcount
from .sharding import DEFAULT_RULES, ShardingRules

__all__ = ["axes_for_path", "model_axis_dim", "tree_logical_axes",
           "tree_specs", "batch_logical_axes", "Placed", "RegionSums",
           "place_leaf", "place_tree", "place_cache", "cache_spec",
           "place_state", "gather_tree", "position_bytes", "spec_bytes",
           "production_share", "region_spans", "take_region", "take_regions",
           "view_region"]


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


# ---------------------------------------------------------------------------
# Regions: what one position computes with
# ---------------------------------------------------------------------------
#
# A region is a tuple with one entry a leading dim (missing trailing dims are
# whole): a slice (step 1), or a list of slices whose spans are joined in
# order (a Mamba-2 head shard's columns of the fused ``in_proj``).


def _spans(entry, n: int) -> list[tuple[int, int]]:
    if isinstance(entry, slice):
        lo, hi, step = entry.indices(n)
        if step != 1:
            raise ValueError(f"a region's slice has step 1, not {step}")
        return [(lo, max(lo, hi))]
    return [span for e in entry for span in _spans(e, n)]


def region_spans(region: tuple, shape) -> list[list[tuple[int, int]]]:
    """Each dim's ``[(lo, hi), ...]`` of ``region`` in a tensor of
    ``shape``."""
    region = tuple(region) + (slice(None),) * (len(shape) - len(region))
    return [_spans(e, n) for e, n in zip(region, shape)]


def _is_whole(region: tuple) -> bool:
    return all(isinstance(e, slice) and e == slice(None) for e in region)


def view_region(t: torch.Tensor, region: tuple) -> torch.Tensor:
    """``region`` of ``t``: ``t`` itself for the whole tensor, a view for
    slices, a copy where a dim's spans are joined."""
    if _is_whole(region):
        return t
    if all(isinstance(e, slice) for e in region):
        return t[tuple(region)]
    out = t
    for d, e in enumerate(region):
        if isinstance(e, slice):
            out = out[(slice(None),) * d + (e,)]
        else:
            out = torch.cat([out.narrow(d, lo, hi - lo)
                             for lo, hi in _spans(e, out.shape[d])], d)
    return out


def _overlap(spans: list, block: tuple) -> list[tuple[tuple, tuple]]:
    """The pieces a block (its region, one slice a dim) holds of a region
    given by its ``spans``: ``(slices in the gathered region, slices in the
    block)`` each."""
    per_dim = []
    for dim_spans, b in zip(spans, block):
        parts, o = [], 0
        for lo, hi in dim_spans:
            a, z = max(lo, b.start), min(hi, b.stop)
            if a < z:
                parts.append((slice(o + a - lo, o + z - lo),
                              slice(a - b.start, z - b.start)))
            o += hi - lo
        if not parts:
            return []
        per_dim.append(parts)
    return [(tuple(d for d, _ in combo), tuple(s for _, s in combo))
            for combo in itertools.product(*per_dim)]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """A placement's regions (one a position), its distinct regions each
    with the positions that hold it (the first holds its gradient sum),
    every position's coordinate on ``model``, the mesh's data rows, and
    the plans of the gathers and gradient adds made of it."""
    shape: tuple
    regions: list
    groups: list
    model: list
    rows: list
    plans: dict = dataclasses.field(default_factory=dict)

    def gather_plan(self, region: tuple, k: int) -> tuple:
        """``(shape, [(source position, slices of the region, slices of
        the source block)], elements read from k's own block)`` of
        ``region`` gathered on position ``k``: each distinct region read
        from ``k`` where it holds it, else from a holder in its ``model``
        column, else from its first holder."""
        key = ("gather", _region_key(region), k)
        plan = self.plans.get(key)
        if plan is None:
            spans = region_spans(region, self.shape)
            shape = [sum(hi - lo for lo, hi in d) for d in spans]
            pieces, own = [], 0
            for block, holders in self.groups:
                parts = _overlap(spans, block)
                if not parts:
                    continue
                src = k if k in holders else next(
                    (h for h in holders if self.model[h] == self.model[k]),
                    holders[0])
                pieces += [(src, _or_whole(dst, shape),
                            _or_whole(part, _extent(block)))
                           for dst, part in parts]
                if src == k:
                    own += sum(math.prod(_extent(dst)) for dst, _ in parts)
            plan = self.plans[key] = (shape, pieces, own)
        return plan

    def add_plan(self, region: tuple) -> list:
        """``[(first holder, slices of the region, slices of its
        block)]``: where a gradient of ``region`` is added."""
        key = ("add", _region_key(region))
        plan = self.plans.get(key)
        if plan is None:
            spans = region_spans(region, self.shape)
            shape = [sum(hi - lo for lo, hi in d) for d in spans]
            plan = self.plans[key] = [
                (holders[0], _or_whole(dst, shape),
                 _or_whole(part, _extent(block)))
                for block, holders in self.groups
                for dst, part in _overlap(spans, block)]
        return plan


def _extent(block: tuple) -> list[int]:
    return [s.stop - s.start for s in block]


def _or_whole(part: tuple, shape) -> tuple | None:
    """``part`` (slices of a tensor of ``shape``), None where it is the
    whole tensor (no view to make)."""
    whole = all(s.start == 0 and s.stop == n for s, n in zip(part, shape))
    return None if whole else part


def _region_key(region: tuple) -> tuple:
    return tuple(e if isinstance(e, slice) else tuple(e) for e in region)


@functools.lru_cache(maxsize=8192)
def _layout(mesh, spec: tuple, shape: tuple) -> _Layout:
    regs = regions(mesh, spec, shape)
    groups: dict[tuple, tuple] = {}
    for k, r in enumerate(regs):
        key = tuple((s.start, s.stop) for s in r)
        groups.setdefault(key, (r, []))[1].append(k)
    return _Layout(shape, regs, list(groups.values()),
                   [c.get("model", 0) for c in mesh.coords()], mesh.rows())


@dataclasses.dataclass
class Placed:
    """A tensor placed on ``mesh`` by ``spec``: ``blocks[k]`` lives on the
    mesh's k-th position and holds its region (:func:`regions`); positions
    that share a region hold equal copies.

    ``row`` (the positions of the data row that gathers it, lead first;
    the mesh's first row by default) and ``sums`` (:class:`RegionSums`,
    which the gathers' backward fills) are set on the copy a training step
    reads through (:meth:`for_row`), which shares the blocks."""

    mesh: Any
    spec: tuple
    shape: torch.Size
    blocks: list
    row: tuple | None = dataclasses.field(default=None, repr=False)
    sums: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def _layout(self) -> _Layout:
        lay = self.__dict__.get("_lay")
        if lay is None:
            lay = self.__dict__["_lay"] = _layout(
                self.mesh, tuple(self.spec), tuple(self.shape))
        return lay

    def regions(self) -> list[tuple[slice, ...]]:
        return self._layout().regions

    def distinct(self) -> list[int]:
        """The first position of each region, in position order: each
        element of the tensor once."""
        return sorted(holders[0] for _, holders in self._layout().groups)

    def for_row(self, row: Sequence[int], sums=None) -> "Placed":
        """This leaf as data row ``row`` (its positions, lead first) reads
        it, its gathers' gradients added into ``sums``; the same
        blocks."""
        out = dataclasses.replace(self, row=tuple(row), sums=sums)
        out.__dict__["_lay"] = self._layout()
        return out

    def position(self, i: int) -> int:
        """The mesh position of the i-th position of the leaf's row."""
        return (self.row or self._layout().rows[0])[i]

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
    def gather_region(self, region: tuple, device=None, *,
                      position: int | None = None) -> torch.Tensor:
        """Only ``region`` of the tensor (:func:`region_spans`), as a new
        tensor on ``device`` (position ``position``'s device; the lead's
        by default), assembled from the blocks that overlap it: each part
        read from ``position``'s own block where it holds it, else from a
        position of its ``model`` column, else from the part's first
        holder."""
        k = 0 if position is None else position
        return _gather([(self, region, k)], device)[0]

    def take(self, region: tuple, i: int = 0) -> torch.Tensor:
        """``region`` gathered on the i-th position of the leaf's row (0:
        its lead), as that position computes with it
        (:func:`take_regions`)."""
        return take_regions([(self, region)], i)[0]

    @torch.no_grad()
    def read(self, region: tuple, k: int) -> torch.Tensor:
        """``region`` (:func:`region_spans`) of a placed cache leaf as a
        new tensor on mesh position ``k``'s device, each part read from
        ``k``'s own block where it holds it (:func:`_gather`, recorded at
        site ``cache_read``; not a parameter gather)."""
        return _gather([(self, region, k)], site="cache_read")[0]

    @torch.no_grad()
    def write_(self, region: tuple, value: torch.Tensor) -> None:
        """Write ``value`` (the shape of ``region``, whose dims are each
        one slice) into every block that holds a part of ``region``, each
        copy of a part included, in place."""
        spans = region_spans(region, self.shape)
        dsts, srcs = [], []
        for blk, reg in zip(self.blocks, self.regions()):
            for dst, part in _overlap(spans, reg):
                dsts.append(blk[part])
                piece = value[dst]
                srcs.append(piece if piece.device == blk.device
                            else piece.to(blk.device))
        if dsts:
            torch._foreach_copy_(dsts, srcs)


def _gather(reqs: list, device=None, *,
            site: str = "param_gather") -> list[torch.Tensor]:
    """Each ``(leaf, region, position)`` of ``reqs`` as a new tensor on
    the position's device (``device`` where given), its parts copied from
    the blocks by one ``_foreach_copy_``.  Under a counter each records its
    all-gather of the bytes that came from other positions (``site``;
    in a production trace also those a production position fetches from
    the other data rows) and, for a parameter region (site
    ``param_gather``), the gathered high-water mark
    (``opcount.gathered``)."""
    outs, owns, dsts, srcs = [], [], [], []
    for leaf, region, k in reqs:
        shape, pieces, own = leaf._layout().gather_plan(region, k)
        out = torch.empty(shape, dtype=leaf.dtype, device=leaf.mesh.flat[k]
                          if device is None else device)
        outs.append(out)
        owns.append(own)
        for src, dst, part in pieces:
            blk = leaf.blocks[src]
            dsts.append(out if dst is None else out[dst])
            srcs.append(blk if part is None else blk[part])
    torch._foreach_copy_(dsts, srcs)
    if opcount.tracking():
        for (leaf, _, k), out, own in zip(reqs, outs, owns):
            fetched = (out.numel() - own * opcount.share(leaf)) \
                * out.element_size()
            if fetched > 0:
                opcount.collective("all-gather", nbytes=int(round(fetched)),
                                   site=site,
                                   position=leaf._layout().model[k])
            if site == "param_gather":
                opcount.gathered(out, k)
    return outs


class _GatherRegions(torch.autograd.Function):
    """:func:`take_regions` as one differentiable gather: its forward
    assembles each ``(leaf, region, position)`` (:func:`_gather`; it saves
    nothing: a checkpointed block gathers again when it is recomputed),
    its backward adds each region's gradient into its leaf's
    :class:`RegionSums`, all by one ``_foreach_add_``.  ``handle`` is the
    step's tensor that requires grad, so that autograd records the
    gather."""

    @staticmethod
    def forward(ctx, handle, reqs):
        ctx.reqs = reqs
        ctx.set_materialize_grads(False)
        return tuple(_gather(reqs))

    @staticmethod
    def backward(ctx, *grads):
        with _ADD_LOCK:
            sums, parts = [], []
            for (leaf, region, k), grad in zip(ctx.reqs, grads):
                if grad is not None:
                    leaf.sums.pieces(region, grad, k, sums, parts)
            torch._foreach_add_(sums, parts)
        return None, None


#: keeps the devices' backward threads apart while they add into sums
_ADD_LOCK = threading.Lock()


def take_regions(requests: list, i: int) -> list[torch.Tensor]:
    """Each ``(Placed leaf, region)`` of ``requests`` gathered on the i-th
    position of its leaf's row (0: its lead), each a new tensor there
    (:func:`_gather`).  Under grad, where the leaves carry
    :class:`RegionSums` (one step's), the gathers are one differentiable
    call whose backward adds each region's gradient into its leaf's
    sums."""
    reqs = [(leaf, region, leaf.position(i)) for leaf, region in requests]
    sums = next((leaf.sums for leaf, _ in requests
                 if leaf.sums is not None), None)
    if sums is not None and torch.is_grad_enabled():
        return list(_GatherRegions.apply(sums.handle, reqs))
    return _gather(reqs)


class RegionSums:
    """The fp32 gradient sums of a :class:`Placed` leaf at its distinct
    blocks, each on the position that holds the block first: the backward
    of every gather of the leaf (:func:`take_regions`) adds its region's
    gradient into the blocks it overlaps, in the order the backward runs
    the gathers.  Under a counter each gradient records the reduce-scatter
    of the region (site ``grad_scatter``), and a sum is counted live at
    the leaf's production share (``opcount.share``).  ``handle``: the
    step's tensor that requires grad (:class:`_GatherRegions`)."""

    def __init__(self, leaf: Placed, handle: torch.Tensor):
        self.leaf, self.handle = leaf, handle
        self.acc: dict[int, torch.Tensor] = {}
        self.share = opcount.share(leaf)

    def _new(self, owner: int, make):
        with opcount.at_position(self.leaf._layout().model[owner]), \
                opcount.scaled_live(self.share):
            return make()

    def _zeros(self, owner: int) -> torch.Tensor:
        blk = self.leaf.blocks[owner]
        return self._new(owner, lambda: torch.zeros(
            blk.shape, dtype=torch.float32, device=blk.device))

    def pieces(self, region: tuple, grad: torch.Tensor, k: int,
               sums: list, parts: list) -> None:
        """Append where the gradient ``grad`` of ``region`` (gathered on
        position ``k``) adds into the sums: each sum's view to ``sums``,
        the gradient's piece (on the sum's device) to ``parts``.  A sum is
        made (zeros) at its first piece."""
        lay = self.leaf._layout()
        if opcount.tracking():
            opcount.collective("reduce-scatter", grad, site="grad_scatter",
                               position=lay.model[k])
        for owner, dst, part in lay.add_plan(region):
            acc = self.acc.get(owner)
            if acc is None:
                acc = self.acc[owner] = self._zeros(owner)
            piece = grad if dst is None else grad[dst]
            sums.append(acc if part is None else acc[part])
            parts.append(piece if piece.device == acc.device
                         else piece.to(acc.device))

    @torch.no_grad()
    def placed(self, accum: int, *, cast: bool) -> Placed:
        """The sums divided by ``accum`` (cast back to the leaf's dtype
        where ``cast``), placed as the leaf is: each holder of a block
        gets the sum (a copy on the holders after the first); a block no
        gather reached is zeros.  The sums are handed over."""
        leaf = self.leaf
        blocks: list = [None] * len(leaf.blocks)
        for _, holders in leaf._layout().groups:
            owner = holders[0]
            g = self.acc.pop(owner, None)
            if g is None:
                g = self._zeros(owner)
            g = g.div_(accum)
            if cast and leaf.dtype != torch.float32:
                g = self._new(owner, lambda: g.to(leaf.dtype))
            for k in holders:
                blocks[k] = g if k == owner else self._new(
                    k, lambda: g.to(leaf.blocks[k].device, copy=True))
        return Placed(mesh=leaf.mesh, spec=leaf.spec, shape=leaf.shape,
                      blocks=blocks)


def take_region(leaf, region: tuple, i: int, device) -> torch.Tensor:
    """``region`` of a parameter leaf on the i-th position of a data row
    (``device``): a :class:`Placed` leaf gathers it there
    (:meth:`Placed.take`), a tensor gives its view (:func:`view_region`)
    moved to ``device``."""
    if isinstance(leaf, Placed):
        return leaf.take(region, i)
    return view_region(leaf, region).to(device)


def production_share(leaf: Placed, mesh) -> float:
    """The fraction of ``leaf``'s block (placed on one data row of
    ``mesh``, whose other axes have extent 1) that a position of ``mesh``
    holds: each dim's axes resolved again at ``mesh``'s sizes, as
    ``spec_for`` resolves them (an axis that does not divide is
    dropped)."""
    row, sizes = leaf.mesh.shape, mesh.shape
    out = 1.0
    for n, axes in zip(leaf.shape, _spec_axes(leaf.spec, len(leaf.shape))):
        size = 1
        for a in axes:
            if n % (size * sizes.get(a, 1)) == 0:
                size *= sizes.get(a, 1)
        out *= math.prod(row.get(a, 1) for a in axes) / size
    return out


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


def place_cache(cache: dict, mesh, rules: ShardingRules) -> dict:
    """A dense serving cache (``models.transformer.init_cache``) placed on
    ``mesh`` as the reference's decode cells place it
    (``tree_shardings(cache, rules, kind="cache")``): the attention
    layers' ``"k"``/``"v"`` (n_attn, B, KV, T, D) by their ``("batch",
    "kv_heads", "kv_seq", None)`` specs, the SSM layers' ``"state"``
    (n_ssm, B, H, P, N) by ``("batch", "ssm_heads", None, None)`` and
    ``"conv"`` (n_ssm, B, W-1, C) by ``("batch", None, "ssm_inner")``,
    each split into one block a position (:func:`place_leaf`); ``len``
    whole on the mesh's lead.  ``decode_step`` runs over the result: the
    attention by distributed flash-decoding, the SSM layers reading their
    regions of ``conv`` and ``state`` (:meth:`Placed.read`) and writing
    them back (:meth:`Placed.write_`)."""
    return {key: leaf.to(mesh.lead) if key == "len"
            else place_leaf(leaf, mesh, cache_spec(key, leaf.shape, rules))
            for key, leaf in cache.items()}


def cache_spec(key: str, shape, rules: ShardingRules) -> tuple:
    """The spec of a serving cache's leaf ``key`` (``"k"``, ``"v"``,
    ``"conv"``, ``"state"``, ``"len"``) of ``shape`` under ``rules``: its
    ``_cache_axes`` resolved by ``spec_for``, as the reference's
    ``tree_shardings(kind="cache")`` resolves it."""
    return rules.spec_for(_cache_axes((key,), len(shape)), dims=tuple(shape))


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
