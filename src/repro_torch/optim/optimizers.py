"""Optimizers: AdamW and Adafactor (factored second moment), and SGD.

A port of the reference's ``repro/optim/optimizers.py`` over the port's
parameter trees (nested dicts and lists of tensors).  Optimizer state is
fp32 whatever the parameter dtype; parameters keep their dtype, the update
being computed in fp32.  ``opt_update`` is pure by default, as the
reference's is; with ``inplace=True`` it writes the new parameters and
state into the tensors it was given (and returns them), which the fused
train step uses to hold one copy of the model's state.

Adafactor's update-RMS clip runs per parameter tensor.  The reference
stacks layers on a leading axis, so there it runs over one tensor of all
the layers of a group; the two agree on every tensor that is not stacked.

A training mesh's state (``train/step.py``) holds
:class:`~repro_torch.parallel.partition.Placed` leaves, one block a grid
position: ``global_norm`` counts each element of such a leaf once, and
``opt_update_placed`` updates every block on its position.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..parallel.partition import Placed
from ..tree import tree_leaves, tree_leaves_like, tree_map, tree_unflatten

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


def _square_sum(x, device) -> torch.Tensor:
    """Σ x² in fp32; a :class:`Placed` leaf's each element once (one block
    a region, in position order), summed on ``device``."""
    if not isinstance(x, Placed):
        return x.float().square().sum()
    out = None
    for k in x.distinct():
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


def _adafactor_leaf(spec, beta2, lr):
    def upd(g, p, st):
        gf = g.float()
        g2 = gf.square() + 1e-30
        if "vr" in st:
            vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=-2)
            rfac = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True) + 1e-30)
            cfac = torch.rsqrt(vc + 1e-30)
            step = gf * rfac[..., None] * cfac[..., None, :]
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            step = gf * torch.rsqrt(v + 1e-30)
            new_st = {"v": v}
        # update clipping (Adafactor's d = 1.0 RMS clip)
        rms = torch.sqrt(step.square().mean() + 1e-30)
        step = step / torch.clamp(rms, min=1.0)
        if spec.weight_decay:
            step = step + spec.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), new_st
    return upd


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
    step ``count`` (the count after this update)."""
    if spec.kind == "adamw":
        cf = count.float()
        one = torch.ones((), dtype=torch.float32, device=cf.device)
        return _adamw_leaf(spec, 1 - (one * spec.b1) ** cf,
                           1 - (one * spec.b2) ** cf, lr)
    if spec.kind == "adafactor":
        return _adafactor_leaf(spec, 1.0 - count.float() ** -0.8, lr)
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
               inplace: bool = False):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``.  The global
    norm is of the gradients before clipping.  ``inplace``: write the
    results into ``params`` and ``state`` leaf by leaf and return those,
    so that no second copy of the model's state is ever held."""
    lr = lr if lr is not None else spec.lr
    gnorm = global_norm(grads)
    scale = _clip_scale(spec, gnorm)
    count = state["count"] + 1
    upd = _updater(spec, count, lr)
    new_p, new_st = [], []
    for g, p, st in zip(tree_leaves(grads), tree_leaves(params),
                        _leaf_states(spec, state, params)):
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        p2, st2 = upd(g, p, st)
        if inplace:
            p.copy_(p2)
            for key, t in st2.items():
                st[key].copy_(t)
        else:
            new_p.append(p2)
            new_st.append(st2)
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr)}
    if inplace:
        state["count"].copy_(count)
        return params, state, metrics
    return (tree_unflatten(params, new_p),
            _state_tree(spec, params, new_st, count), metrics)


@torch.no_grad()
def opt_update_placed(spec: OptimizerSpec, grads, state, params, lr=None
                      ) -> dict:
    """:func:`opt_update` with ``inplace=True`` over a training mesh's
    state, whose tensors are all :class:`Placed` on one mesh: writes the
    new parameters and state into their blocks and returns ``{"grad_norm",
    "lr"}``.  The norm is :func:`global_norm`'s (each element once, on the
    lead); AdamW and SGD update each block on its position; Adafactor's
    factored moments and update-RMS clip read whole rows, columns and
    tensors, so each of its leaves is updated whole on the lead and
    written back into every block.  Copies of a replicated region get the
    same inputs and the same update, so they cannot drift."""
    lr = lr if lr is not None else spec.lr
    gnorm = global_norm(grads)
    scale = _clip_scale(spec, gnorm)
    mesh = state["count"].mesh
    count = state["count"].blocks[0] + 1
    upds = {dev: _updater(spec, count.to(dev), lr)
            for dev in mesh.unique_devices()}
    for g, p, st in zip(tree_leaves(grads), tree_leaves(params),
                        _leaf_states(spec, state, params)):
        if spec.kind == "adafactor":
            gw = g.gather()
            if scale is not None:
                gw = (gw.float() * scale).to(gw.dtype)
            p2, st2 = upds[mesh.lead](gw, p.gather(),
                                      {k: v.gather() for k, v in st.items()})
            p.scatter_(p2)
            for key, t in st2.items():
                st[key].scatter_(t)
            continue
        for k, dev in enumerate(mesh.flat):
            gb = g.blocks[k]
            if scale is not None:
                gb = (gb.float() * scale.to(dev)).to(gb.dtype)
            p2, st2 = upds[dev](gb, p.blocks[k],
                                {key: v.blocks[k] for key, v in st.items()})
            p.blocks[k].copy_(p2)
            for key, t in st2.items():
                st[key].blocks[k].copy_(t)
    for k, dev in enumerate(mesh.flat):
        state["count"].blocks[k].copy_(count.to(dev))
    return {"grad_norm": gnorm, "lr": torch.tensor(lr)}
