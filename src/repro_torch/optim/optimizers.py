"""Optimizers: AdamW and Adafactor (factored second moment), and SGD.

A port of the reference's ``repro/optim/optimizers.py`` over the port's
parameter trees (nested dicts and lists of tensors).  Optimizer state is
fp32 whatever the parameter dtype; parameters keep their dtype, the update
being computed in fp32.  ``opt_update`` is pure by default, as the
reference's is; with ``inplace=True`` it writes the new parameters and
state into the tensors it was given (and returns them), which the fused
train step uses to hold one copy of the model's state.

Adafactor's update-RMS clip runs over each leaf of the reference's
layout.  The reference stacks the layers of each position of its layer
pattern on a leading axis, so its clip takes one RMS over the same tensor
of every layer of a group; the port keeps a dict per layer, and
``clip_groups`` (``models.transformer.clip_groups``) names the leaves
that form one stacked leaf there, which then share one RMS.  Where the
reference would factor a stacked vector (a 2-D (L, d) leaf with L and d
both at least ``factored_min``: one column moment shared by the layers,
which the port's per-layer state cannot hold) the update raises.

A training mesh's state (``train/step.py``) holds
:class:`~repro_torch.parallel.partition.Placed` leaves, one block a grid
position: ``global_norm`` counts each element of such a leaf once, and
``opt_update_placed`` updates every block on its position, Adafactor's
too, as the reference's devices update their shards: its row and column
sums, the row mean and the update-RMS are partial sums over the blocks,
summed once and sent to every position that needs them (the reference's
all-reduces), and no position holds a whole leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..analysis import opcount
from ..parallel.partition import Placed
from ..tree import (tree_leaves, tree_leaves_like, tree_map, tree_paths,
                    tree_unflatten)

__all__ = ["OptimizerSpec", "init_opt_state", "opt_update",
           "opt_update_placed", "cosine_schedule", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    kind: str = "adamw"             # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999               # adafactor: decay exponent base
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    # adafactor
    factored_min: int = 128         # factor dims only when both >= this
    # declared, as in the reference, and read by nothing: gradients would be
    # cast to bf16 before a cross-replica reduction with an fp32
    # error-feedback residual
    compress_grads: bool = False


def cosine_schedule(step, *, base_lr: float, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1) -> float:
    """Linear warm-up then cosine decay to ``min_frac`` of ``base_lr``, in
    fp32 as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return float(base_lr * warm * cos)


def _spans(region) -> tuple:
    return tuple((s.start, s.stop) for s in region)


@contextlib.contextmanager
def _on_block(leaf: Placed, k: int, share: float):
    """Count what runs inside at mesh position ``k``'s place in the traced
    row, its storages at ``share`` (the leaf's production share,
    ``opcount.share``): one production position's block.  Nothing
    outside a counter."""
    with opcount.at_position(leaf._layout().model[k]), \
            opcount.scaled_live(share):
        yield


def _square_sum(x, device) -> torch.Tensor:
    """Σ x² in fp32; a :class:`Placed` leaf's each element once (one block
    a region, in position order, counted at its position), summed on
    ``device``."""
    if not isinstance(x, Placed):
        return x.float().square().sum()
    out = None
    share = opcount.share(x)
    for k in x.distinct():
        with _on_block(x, k, share):
            v = x.blocks[k].float().square().sum().to(device)
        out = v if out is None else out + v
    return out


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together; over :class:`Placed` leaves it
    is summed on their mesh's lead."""
    leaves = tree_leaves(tree)
    first = leaves[0]
    dev = first.mesh.lead if isinstance(first, Placed) else first.device
    sq = [_square_sum(x, dev) for x in leaves]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled so its global norm is at most max_norm, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _init_adamw(params):
    return {"m": tree_map(_zeros32, params), "v": tree_map(_zeros32, params),
            "count": _count(params)}


def _adamw_leaf(spec, bc1, bc2, lr):
    b1, b2 = spec.b1, spec.b2

    def upd(g, p, st):
        gf = g.float()
        m2 = b1 * st["m"] + (1 - b1) * gf
        v2 = b2 * st["v"] + (1 - b2) * gf.square()
        step = (m2 / bc1) / ((v2 / bc2).sqrt() + spec.eps)
        if spec.weight_decay:
            step = step + spec.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), {"m": m2, "v": v2}
    return upd


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


def _factored(shape, min_size) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def _init_adafactor(params, spec):
    def one(p):
        if _factored(p.shape, spec.factored_min):
            dev = p.device
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=dev)}
        return {"v": _zeros32(p)}
    return {"f": tree_map(one, params), "count": _count(params)}


@dataclasses.dataclass(frozen=True)
class _Adafactor:
    """One Adafactor step in three parts, so that leaves sharing one
    update-RMS can be clipped together: the new moments, the direction
    they give, and the clipped update of the parameter.  Each part holds
    one leaf-sized fp32 temporary at a time where it can (in-place ops
    that round as the reference's expressions do): at llama3-405b's width
    the embedding alone is 2.1 B elements."""
    spec: OptimizerSpec
    beta2: torch.Tensor
    lr: float

    def decay(self, st, means) -> dict:
        """The moments of ``st`` moved toward ``means`` (the new squared
        gradients' means, by key)."""
        b = self.beta2
        return {k: b * st[k] + (1 - b) * m for k, m in means.items()}

    def moments(self, g, st) -> dict:
        g2 = g.float().square().add_(1e-30)
        if "vr" in st:
            return self.decay(st, {"vr": g2.mean(dim=-1),
                                   "vc": g2.mean(dim=-2)})
        return self.decay(st, {"v": g2})

    @staticmethod
    def direction(g, st, row_mean=None) -> torch.Tensor:
        """The unclipped step; ``row_mean``: ``st["vr"]``'s mean over its
        last dim (kept), where ``st["vr"]`` holds only some of the rows."""
        gf = g.float()
        if "vr" in st:
            vr = st["vr"]
            if row_mean is None:
                row_mean = vr.mean(dim=-1, keepdim=True)
            rfac = torch.rsqrt(vr / row_mean + 1e-30)
            cfac = torch.rsqrt(st["vc"] + 1e-30)
            return (gf * rfac[..., None]).mul_(cfac[..., None, :])
        return gf * torch.rsqrt(st["v"] + 1e-30)

    def apply(self, p, step, rms) -> torch.Tensor:
        """``p - lr * step / max(rms, 1)`` in fp32, cast to p's dtype;
        overwrites ``step``."""
        # update clipping (Adafactor's d = 1.0 RMS clip)
        step = step.div_(torch.clamp(rms, min=1.0))
        if self.spec.weight_decay:
            step = step + self.spec.weight_decay * p.float()
        pf = p.to(torch.float32, copy=True)
        return pf.sub_(step.mul_(self.lr)).to(p.dtype)


def _rms_groups(spec, params, clip_groups) -> list[list[int]]:
    """Every leaf index of ``params`` in one group: ``clip_groups``'s, the
    rest alone.  Raises where the reference would factor the stacked leaf
    of a group (see the module docstring)."""
    leaves = tree_leaves(params)
    groups = [list(g) for g in (clip_groups or ()) if g]
    seen = {i for g in groups for i in g}
    if len(seen) != sum(map(len, groups)) or not seen <= set(
            range(len(leaves))):
        raise ValueError("clip_groups must name distinct leaf indices")
    fmin = spec.factored_min
    for g in groups:
        for i in g:
            shape = tuple(leaves[i].shape)
            if len(g) >= fmin and len(shape) == 1 and shape[0] >= fmin:
                path = list(tree_paths(params))[i][0]
                raise ValueError(
                    f"Adafactor: the reference factors the stacked "
                    f"({len(g)}, {shape[0]}) leaf of {path} and its layers "
                    f"share one column moment, which per-layer state "
                    f"cannot hold (factored_min {fmin})")
    return groups + [[i] for i in range(len(leaves)) if i not in seen]


def _adafactor_update(af: _Adafactor, groups, read, write_state,
                      write_param) -> None:
    """Adafactor over ``groups`` of leaf indices, each group's update-RMS
    taken over all its leaves.  ``read(i)`` gives leaf i's clipped
    gradient, parameter and state (the new state once ``write_state(i,
    st)`` has run); ``write_param(i, p)`` takes the new parameter.  A
    group of several leaves is walked twice (moments and the squared
    directions' sum, then the updates), so one direction is held at a
    time."""
    for grp in groups:
        if len(grp) == 1:
            g, p, st = read(grp[0])
            st2 = af.moments(g, st)
            step = af.direction(g, st2)
            write_state(grp[0], st2)
            write_param(grp[0], af.apply(
                p, step, torch.sqrt(step.square().mean() + 1e-30)))
            continue
        sq, n = None, 0
        for i in grp:
            g, _, st = read(i)
            st2 = af.moments(g, st)
            write_state(i, st2)
            part = af.direction(g, st2).square().sum()
            sq = part if sq is None else sq + part.to(sq.device)
            n += g.numel()
        rms = torch.sqrt(sq / n + 1e-30)
        for i in grp:
            g, p, st = read(i)
            write_param(i, af.apply(p, af.direction(g, st),
                                    rms.to(p.device)))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def init_opt_state(spec: OptimizerSpec, params):
    if spec.kind == "adamw":
        return _init_adamw(params)
    if spec.kind == "adafactor":
        return _init_adafactor(params, spec)
    if spec.kind == "sgd":
        return {"count": _count(params)}
    raise ValueError(f"unknown optimizer {spec.kind}")


def _leaf_states(spec, state, params) -> list[dict]:
    """Each parameter's optimizer state as a dict, in leaf order."""
    if spec.kind == "adamw":
        return [{"m": m, "v": v} for m, v in zip(tree_leaves(state["m"]),
                                                 tree_leaves(state["v"]))]
    if spec.kind == "adafactor":
        return tree_leaves_like(state["f"], params)
    return [{} for _ in tree_leaves(params)]


def _state_tree(spec, params, leaf_states: list[dict], count):
    """The inverse of :func:`_leaf_states`."""
    if spec.kind == "adamw":
        return {"m": tree_unflatten(params, [s["m"] for s in leaf_states]),
                "v": tree_unflatten(params, [s["v"] for s in leaf_states]),
                "count": count}
    if spec.kind == "adafactor":
        return {"f": tree_unflatten(params, leaf_states), "count": count}
    return {"count": count}


def _updater(spec: OptimizerSpec, count: torch.Tensor, lr):
    """The leaf update ``upd(g, p, st) -> (p, st)`` of ``spec.kind`` at
    step ``count`` (the count after this update); Adafactor's is an
    :class:`_Adafactor`."""
    if spec.kind == "adamw":
        cf = count.float()
        one = torch.ones((), dtype=torch.float32, device=cf.device)
        return _adamw_leaf(spec, 1 - (one * spec.b1) ** cf,
                           1 - (one * spec.b2) ** cf, lr)
    if spec.kind == "adafactor":
        return _Adafactor(spec, 1.0 - count.float() ** -0.8, lr)
    if spec.kind == "sgd":
        def upd(g, p, st):
            return (p.float() - lr * g.float()).to(p.dtype), st
        return upd
    raise ValueError(spec.kind)


def _clip_scale(spec: OptimizerSpec, gnorm: torch.Tensor):
    if not spec.clip_norm:
        return None
    return torch.clamp(spec.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


@torch.no_grad()
def opt_update(spec: OptimizerSpec, grads, state, params, lr=None, *,
               inplace: bool = False, clip_groups=None):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``.  The global
    norm is of the gradients before clipping.  ``inplace``: write the
    results into ``params`` and ``state`` leaf by leaf and return those,
    so that no second copy of the model's state is ever held; the
    global-norm clip then scales ``grads`` in place too (Adafactor reads
    a leaf's gradient twice).  ``clip_groups``: lists of leaf indices (in
    ``params``' leaf order) whose Adafactor update-RMS is taken together,
    the reference's stacked leaves (``models.transformer.clip_groups``);
    the other kinds ignore it.  Gradients may be in the parameters' dtype or fp32; the update is
    computed in fp32 and cast to the parameter's dtype."""
    lr = lr if lr is not None else spec.lr
    gnorm = global_norm(grads)
    scale = _clip_scale(spec, gnorm)
    count = state["count"] + 1
    upd = _updater(spec, count, lr)
    g_l, p_l = tree_leaves(grads), tree_leaves(params)
    st_l = _leaf_states(spec, state, params)
    new_p, new_st = [None] * len(p_l), [None] * len(p_l)
    groups = (_rms_groups(spec, params, clip_groups)
              if spec.kind == "adafactor" else None)

    if inplace and scale is not None:   # the step's own gradients,
        for g in g_l:                   # scaled once where they lie
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
        scale = None

    def clipped(g):
        return g if scale is None else (g.float() * scale).to(g.dtype)

    def write_state(i, st2):
        if inplace:
            for key, t in st2.items():
                st_l[i][key].copy_(t)
        else:
            new_st[i] = st2

    def write_param(i, p2):
        if inplace:
            p_l[i].copy_(p2)
        else:
            new_p[i] = p2

    if spec.kind == "adafactor":
        _adafactor_update(
            upd, groups,
            lambda i: (clipped(g_l[i]), p_l[i],
                       st_l[i] if new_st[i] is None else new_st[i]),
            write_state, write_param)
    else:
        for i, (g, p, st) in enumerate(zip(g_l, p_l, st_l)):
            p2, st2 = upd(clipped(g), p, st)
            write_param(i, p2)
            write_state(i, st2)
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr)}
    if inplace:
        state["count"].copy_(count)
        return params, state, metrics
    return (tree_unflatten(params, new_p),
            _state_tree(spec, params, new_st, count), metrics)


# ---------------------------------------------------------------------------
# A training mesh: every block updated on its position
# ---------------------------------------------------------------------------

#: the site of the placed Adafactor's cross-block sums under a counter
REDUCE_SITE = "adafactor_reduce"

#: the part of its parameter's block (one span a dim) that a block of a
#: state key covers on the same position
_COVERS = {"v": lambda r: r, "vr": lambda r: r[:-1],
           "vc": lambda r: r[:-2] + r[-1:]}


def _reduce(acc: dict, key, part: torch.Tensor, leaf: Placed, k: int,
            split: bool, share: float = 1.0) -> None:
    """Add position k's partial sum ``part`` into ``acc[key]`` (on the
    device of the key's first part).  Where ``split`` (the leaf's spec
    cuts the dim summed over), a counter records the all-reduce of a
    production position's part (``share`` of it)."""
    if split:
        opcount.collective(
            "all-reduce", nbytes=int(opcount.tensor_bytes(part) * share),
            site=REDUCE_SITE, position=leaf._layout().model[k])
    have = acc.get(key)
    acc[key] = part if have is None else have + part.to(have.device)


def _split(leaf: Placed, dim: int) -> bool:
    """Whether ``leaf``'s spec puts ``dim`` on a mesh axis."""
    d = dim % len(leaf.shape)
    return d < len(leaf.spec) and leaf.spec[d] is not None


def _check_placement(path: str, g, p, st: dict) -> None:
    """Raise unless, on every position, the gradient's block is the
    parameter's and each state block covers the parameter block's rows
    and columns (``_COVERS``): what a per-block update reads."""
    want = [_spans(r) for r in p.regions()]
    for key, t in (("gradient", g), *st.items()):
        cover = _COVERS.get(key, _COVERS["v"])
        if (not isinstance(t, Placed) or t.mesh != p.mesh
                or [_spans(r) for r in t.regions()]
                != [cover(r) for r in want]):
            raise ValueError(
                f"Adafactor: the {key} of {path} (spec "
                f"{getattr(t, 'spec', None)}) is not placed over its "
                f"parameter's blocks (spec {p.spec}), so its blocks cannot "
                f"be updated where they lie")


def _placed_moments(upds: dict, g, p, st: dict, clipped) -> dict | None:
    """Write a placed leaf's new moments into every block of ``st``;
    return a factored leaf's row means (``vr``'s mean over its last dim,
    kept) by the spans of their leading dims, None for an unfactored
    leaf."""
    share = opcount.share(p)
    regs = [_spans(r) for r in p.regions()]
    if "v" in st:
        v = st["v"]
        for k, dev in enumerate(p.mesh.flat):
            with _on_block(p, k, share):
                new = upds[dev].moments(clipped(g, k), {"v": v.blocks[k]})
                v.blocks[k].copy_(new["v"])
                del new
        return None
    vr, vc = st["vr"], st["vc"]
    rows, cols = {}, {}
    for k in p.distinct():
        with _on_block(p, k, share):
            g2 = clipped(g, k).float().square().add_(1e-30)
            part_r, part_c = g2.sum(dim=-1), g2.sum(dim=-2)
            del g2
        _reduce(rows, regs[k][:-1], part_r, p, k, _split(p, -1),
                opcount.share(vr))
        _reduce(cols, _COVERS["vc"](regs[k]), part_c, p, k, _split(p, -2),
                opcount.share(vc))
    n_rows, n_cols = p.shape[-2], p.shape[-1]
    for k, dev in enumerate(p.mesh.flat):
        with _on_block(p, k, share):
            new = upds[dev].decay(
                {"vr": vr.blocks[k], "vc": vc.blocks[k]},
                {"vr": rows[regs[k][:-1]].to(dev) / n_cols,
                 "vc": cols[_COVERS["vc"](regs[k])].to(dev) / n_rows})
            vr.blocks[k].copy_(new["vr"])
            vc.blocks[k].copy_(new["vc"])
            del new
    sums = {}
    for k in vr.distinct():
        with _on_block(p, k, share):
            part = vr.blocks[k].sum(dim=-1)
        _reduce(sums, regs[k][:-2], part, p, k, _split(p, -2))
    return {key: (s / n_rows).unsqueeze(-1) for key, s in sums.items()}


def _block_direction(g, st: dict, means: dict | None, k: int,
                     clipped) -> torch.Tensor:
    """Position k's unclipped step of a placed leaf whose moments are
    written; ``means``: :func:`_placed_moments`' row means."""
    row_mean = None
    if means is not None:
        row_mean = means[_spans(g.regions()[k])[:-2]].to(
            g.blocks[k].device)
    return _Adafactor.direction(
        clipped(g, k), {key: t.blocks[k] for key, t in st.items()},
        row_mean)


def _adafactor_placed(upds: dict, groups, leaves: list, clipped) -> None:
    """Adafactor over a training mesh's leaves in ``groups`` of leaf
    indices, each group's update-RMS taken over all its leaves (as
    :func:`_adafactor_update` takes them); ``leaves[i]`` is ``(path,
    gradient, parameter, state)``, all :class:`Placed` on one mesh, and
    ``clipped(g, k)`` the clipped gradient of position k's block.

    Every position updates its own blocks on its device, as the
    reference's devices update their shards.  A factored leaf's row
    (column) moment is the distinct blocks' partial sums over their
    columns (rows), added over the blocks that share its rows (columns)
    and divided by the leaf's whole last (second last) dim; its row mean
    is the distinct ``vr`` blocks' sums; the update-RMS the distinct
    blocks' sums of squared directions over the group's elements.  Each
    sum is added up once, in position order, and sent to every position
    that reads it: the reference's all-reduces over ``data`` and
    ``model`` (recorded at site ``adafactor_reduce`` under a counter).
    Every holder of a replicated region computes its own copy from equal
    inputs, as the reference's replicas do, so the copies are equal to
    the bit.  A group is walked twice (moments and the squared
    directions' sum, then the updates), so a position holds one block's
    fp32 temporaries at a time.  A leaf placed otherwise is refused
    before any block is written."""
    for leaf in leaves:
        _check_placement(*leaf)
    for grp in groups:
        sq, n, means = None, 0, {}
        for i in grp:
            path, g, p, st = leaves[i]
            means[i] = _placed_moments(upds, g, p, st, clipped)
            share = opcount.share(p)
            split = any(e is not None for e in p.spec)
            for k in p.distinct():
                with _on_block(p, k, share):
                    part = _block_direction(g, st, means[i], k,
                                            clipped).square_().sum()
                if split:
                    opcount.collective("all-reduce", part, site=REDUCE_SITE,
                                       position=p._layout().model[k])
                part = part.to(p.mesh.lead)
                sq = part if sq is None else sq + part
            n += math.prod(p.shape)
        rms = torch.sqrt(sq / n + 1e-30)
        for i in grp:
            path, g, p, st = leaves[i]
            share = opcount.share(p)
            for k, dev in enumerate(p.mesh.flat):
                with _on_block(p, k, share):
                    step = _block_direction(g, st, means[i], k, clipped)
                    p.blocks[k].copy_(upds[dev].apply(p.blocks[k], step,
                                                      rms.to(dev)))
                    del step


@torch.no_grad()
def opt_update_placed(spec: OptimizerSpec, grads, state, params, lr=None,
                      *, clip_groups=None) -> dict:
    """:func:`opt_update` with ``inplace=True`` over a training mesh's
    state, whose tensors are all :class:`Placed` on one mesh: writes the
    new parameters and state into their blocks and returns ``{"grad_norm",
    "lr"}``.  The norm is :func:`global_norm`'s (each element once, on the
    lead).  Every block is updated on its position, AdamW's and SGD's
    alone, Adafactor's with the sums across blocks its factored moments
    and update-RMS clip need (:func:`_adafactor_placed`; ``clip_groups``
    as for :func:`opt_update`); no leaf is gathered whole.  Copies of a
    replicated region get the same inputs and the same update, so they
    cannot drift.  Under a counter each block's work counts at its
    position, its storages at the leaf's production share."""
    lr = lr if lr is not None else spec.lr
    gnorm = global_norm(grads)
    scale = _clip_scale(spec, gnorm)
    mesh = state["count"].mesh
    count = state["count"].blocks[0] + 1
    upds = {dev: _updater(spec, count.to(dev), lr)
            for dev in mesh.unique_devices()}
    scales = None if scale is None else {
        dev: scale.to(dev) for dev in mesh.unique_devices()}

    def clipped(g, k):
        gb = g.blocks[k]
        if scales is None:
            return gb
        return gb.to(torch.float32, copy=True).mul_(
            scales[mesh.flat[k]]).to(gb.dtype)

    g_l, p_l = tree_leaves(grads), tree_leaves(params)
    st_l = _leaf_states(spec, state, params)
    if spec.kind == "adafactor":
        paths = [path for path, _ in tree_paths(params)]
        _adafactor_placed(upds, _rms_groups(spec, params, clip_groups),
                          list(zip(paths, g_l, p_l, st_l)), clipped)
    else:
        for g, p, st in zip(g_l, p_l, st_l):
            share = opcount.share(p)
            for k, dev in enumerate(mesh.flat):
                with _on_block(p, k, share):
                    p2, st2 = upds[dev](clipped(g, k), p.blocks[k], {
                        key: v.blocks[k] for key, v in st.items()})
                    p.blocks[k].copy_(p2)
                    for key, t in st2.items():
                        st[key].blocks[k].copy_(t)
                    del p2, st2
    for k, dev in enumerate(mesh.flat):
        state["count"].blocks[k].copy_(count.to(dev))
    return {"grad_norm": gnorm, "lr": torch.tensor(lr)}
