"""Mixture-of-Experts: top-k routing with capacity-bounded gather dispatch.

The JAX package's semantics, row by row (each batch row routes, gathers
and combines on its own):

* the router runs in fp32: softmax over the experts, top-k, the k gates
  renormalised to sum to 1;
* capacity ``C = ceil(top_k * S / E * capacity_factor)`` per expert and
  row, ``C = S`` (dropless) when ``S <= 64``, and never above S.  A
  (token, choice) pair takes the next free slot of its expert in the
  flattened (token, choice) order; pairs past ``C`` are dropped (their
  combine weight is 0).  The length is the padded one: a bucketed chunk's
  padding tokens route, and take capacity, too;
* the experts are gated MLPs with weights (E, d, ff) / (E, ff, d), run in
  the compute dtype as one batched product over every expert's (rows x C)
  buffer — plain ``torch.bmm``, as the reference runs plain einsums;
* shared experts (qwen2-moe) are a dense gated MLP added under a sigmoid
  gate computed in fp32;
* the Switch load-balancing loss is taken from the first choice.

``apply_moe`` returns ``(out, aux)``; with ``sums=True`` its ``aux`` is
the sums the loss is made of (``transformer.loss_from_sums``), for a
batch split over the data rows of a training mesh.

Over a row's tensor-parallel positions (``tp=``, :func:`split_experts`)
the three expert products split where the expert tensors' spec puts
``model`` (:func:`expert_axis`): by ``experts`` (expert parallel: each
position runs its experts' slice of the (E, rows x C, d) buffer, and the
outputs are concatenated in expert order; experts never mix, so nothing
is summed), or, where the experts do not divide, by ``d_ff`` (each
position runs every expert's slice of ``d_ff``, and the partial ``down``
outputs are summed in shard order).  The router, the capacity, the
dispatch gathers, the shared experts and the sums stay on x's device.
The reference stores the experts by ``experts`` too but constrains the
hidden over ``d_ff`` and leaves the compute's placement to GSPMD; the
values are the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..analysis import opcount
from ..parallel.partition import model_axis_dim, view_region
from .config import ModelConfig
from .layers import (_act, apply_mlp, dtype_of, init_dense, init_mlp,
                     truncated_normal)

__all__ = ["init_moe", "apply_moe", "moe_capacity", "expert_axis",
           "split_experts", "EXPERT_KEYS"]

#: the expert tensors, (E, d, ff) / (E, d, ff) / (E, ff, d)
EXPERT_KEYS = ("gate", "up", "down")


def init_moe(generator, cfg: ModelConfig, device) -> dict:
    """The reference's parameters and init scales, drawn from
    ``generator`` (which must live on ``device``)."""
    d, E = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    pdt = dtype_of(cfg.param_dtype)
    p = {
        "router": init_dense(generator, d, E, cfg, device),
        "gate": truncated_normal(generator, (E, d, ff), 1.0 / math.sqrt(d),
                                 pdt, device),
        "up": truncated_normal(generator, (E, d, ff), 1.0 / math.sqrt(d),
                               pdt, device),
        "down": truncated_normal(generator, (E, ff, d), 1.0 / math.sqrt(ff),
                                 pdt, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, cfg, device,
                               d_ff=ff * cfg.n_shared_experts, gated=True)
        p["shared_gate"] = torch.zeros((d, 1), dtype=pdt, device=device)
    return p


def moe_capacity(cfg: ModelConfig, S: int,
                 capacity_factor: float | None = None) -> int:
    """Slots an expert has in a row of S tokens."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    C = max(1, int(math.ceil(cfg.top_k * S / cfg.n_experts * cf)))
    if S <= 64:
        C = S          # decode and short rows: serving must not drop tokens
    return min(C, S)


def expert_axis(p: dict, n: int) -> str | None:
    """How ``n`` tensor-parallel positions split a MoE block's experts
    (``p`` its ``moe`` params): ``"experts"`` where the expert tensors'
    spec puts ``model`` on the expert axis, ``"d_ff"`` where it falls to
    ``d_ff`` (the experts do not divide), None where neither divides."""
    dim = model_axis_dim(("moe", "gate"), p["gate"].shape, n)
    return {0: "experts", 2: "d_ff"}.get(dim)


def split_experts(p: dict, n: int, i: int, axis: str, *,
                  take=view_region) -> dict:
    """Shard ``i`` of ``n`` of a MoE block's expert tensors (views of
    ``p``; ``take`` reads each region, as for
    ``attention.split_attention``): experts ``[i·E/n, (i+1)·E/n)`` whole
    under ``axis="experts"``, or every expert's ``d_ff`` columns of
    ``gate``/``up`` and rows of ``down`` ``[i·ff/n, (i+1)·ff/n)`` under
    ``"d_ff"``."""
    E, _, ff = p["gate"].shape
    size = E if axis == "experts" else ff
    if axis not in ("experts", "d_ff") or size % n or not 0 <= i < n:
        raise ValueError(f"shard {i} of {n} does not split {axis} "
                         f"({E} experts, d_ff {ff})")
    cut = slice(i * size // n, (i + 1) * size // n)
    if axis == "experts":
        return {k: take(p[k], (cut,)) for k in EXPERT_KEYS}
    whole = slice(None)
    return {"gate": take(p["gate"], (whole, whole, cut)),
            "up": take(p["up"], (whole, whole, cut)),
            "down": take(p["down"], (whole, cut))}


def _experts(cfg: ModelConfig, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The gated expert MLPs over every expert's buffer: (E, rows, d) ->
    (E, rows, d) in the compute dtype."""
    cd = dtype_of(cfg.compute_dtype)
    h = _act(cfg.act, torch.bmm(buf, p["gate"].to(cd))) \
        * torch.bmm(buf, p["up"].to(cd))
    return torch.bmm(h, p["down"].to(cd))


def _experts_tp(cfg: ModelConfig, tp, buf: torch.Tensor) -> torch.Tensor:
    """:func:`_experts` over tensor-parallel shards: ``tp`` is ``(axis,
    [(expert tensors, device), ...])`` in shard order.  Under
    ``"experts"`` each shard runs its experts' rows of ``buf`` (moved to
    its device) and the outputs are concatenated in expert order on
    ``buf``'s device; under ``"d_ff"`` each runs the whole buffer and the
    partial outputs are summed in shard order there."""
    axis, shards = tp
    if axis == "experts":
        parts, lo = [], 0
        for p_s, dev in opcount.each_position(shards):
            hi = lo + p_s["gate"].shape[0]
            part = _experts(cfg, p_s, buf[lo:hi].to(dev))
            # each position ends with every expert's rows: buf's shape
            opcount.collective("all-gather",
                               nbytes=buf.numel() * part.element_size(),
                               site="experts_tp")
            parts.append(part.to(buf.device))
            lo = hi
        if lo != buf.shape[0]:
            raise ValueError(f"expert shards hold {lo} of {buf.shape[0]} "
                             f"experts")
        return torch.cat(parts)
    out = None
    for p_s, dev in opcount.each_position(shards):
        part = _experts(cfg, p_s, opcount.shard_input(
            buf, "experts_tp_grad").to(dev))
        opcount.collective("all-reduce", part, site="experts_tp")
        part = part.to(buf.device)
        out = part if out is None else out + part
    return out


def _route(cfg: ModelConfig, p: dict, x: torch.Tensor, C: int):
    """The router, per row: ``(probs (B, S, E) fp32, gates (B, S, K)
    renormalised, experts (B, S, K), slot (B, S·K), keep (B, S·K))`` —
    ``slot`` is the (token, choice) pair's row in the flattened (E·C)
    buffers, E·C (one past them) where the pair is dropped."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = x.float() @ p["router"]["w"].float()                 # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, K, dim=-1)                 # (B, S, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # slot of each (token, choice) in its expert's buffer, by a cumulative
    # count over the flattened (token, choice) order
    flat = experts.reshape(B, S * K)
    onehot = F.one_hot(flat, E)                                 # (B, SK, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C)
    return probs, gates, experts, slot, keep


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              capacity_factor: float | None = None, sums: bool = False,
              tp=None):
    """x: (B, S, d) -> ``(out (B, S, d) in the compute dtype, aux fp32
    scalar)``.  ``sums``: ``aux`` is instead ``(Σ router probabilities,
    Σ top-1 one-hots)`` over the B·S tokens, each (E,) fp32: the
    load-balancing loss of several row slices of one batch is ``E · Σ
    (Σ_rows probs / N) · (Σ_rows one-hots / N)``, N their tokens.
    ``tp``: ``(axis, [(expert tensors, device), ...])``, the expert
    products split over tensor-parallel shards (:func:`_experts_tp`); ``p``
    then needs no expert tensors of its own."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S, capacity_factor)
    probs, gates, experts, slot, _ = _route(cfg, p, x, C)

    # the token each buffer slot holds (S: a zero row for an empty slot);
    # dropped pairs all land in the extra column E*C, which is cut off
    token_id = (torch.arange(S * K, device=x.device) // K).expand(B, -1)
    table = torch.full((B, E * C + 1), S, dtype=torch.long, device=x.device)
    table.scatter_(1, slot, token_id)
    x_pad = torch.cat([x.to(cd), x.new_zeros((B, 1, d), dtype=cd)], dim=1)
    gathered = x_pad.gather(
        1, table[:, :E * C, None].expand(-1, -1, d))            # (B, EC, d)
    # every expert's buffer over the batch rows: (E, B*C, d)
    buf = gathered.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    out_e = (_experts(cfg, p, buf) if tp is None
             else _experts_tp(cfg, tp, buf))                    # (E, BC, d)
    flat_out = out_e.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    # each (token, choice) reads its slot; a dropped pair the zero row
    flat_out = torch.cat([flat_out, flat_out.new_zeros((B, 1, d))], dim=1)
    per_slot = flat_out.gather(
        1, slot[..., None].expand(-1, -1, d)).reshape(B, S, K, d)
    out = (per_slot * gates.to(cd)[..., None]).sum(dim=2)

    if "shared" in p:
        sh = apply_mlp(cfg, p["shared"], x)
        sgate = torch.sigmoid(x.float() @ p["shared_gate"].float())
        out = out + sh * sgate.to(cd)

    if sums:
        return out, (probs.sum(dim=(0, 1)),
                     F.one_hot(experts[..., 0], E).float().sum(dim=(0, 1)))
    me = probs.mean(dim=(0, 1))                                        # (E,)
    ce = F.one_hot(experts[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    return out, aux
