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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (_act, apply_mlp, dtype_of, init_dense, init_mlp,
                     truncated_normal)

__all__ = ["init_moe", "apply_moe", "moe_capacity"]


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
              capacity_factor: float | None = None, sums: bool = False):
    """x: (B, S, d) -> ``(out (B, S, d) in the compute dtype, aux fp32
    scalar)``.  ``sums``: ``aux`` is instead ``(Σ router probabilities,
    Σ top-1 one-hots)`` over the B·S tokens, each (E,) fp32: the
    load-balancing loss of several row slices of one batch is ``E · Σ
    (Σ_rows probs / N) · (Σ_rows one-hots / N)``, N their tokens."""
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
    h = _act(cfg.act, torch.bmm(buf, p["gate"].to(cd))) \
        * torch.bmm(buf, p["up"].to(cd))
    out_e = torch.bmm(h, p["down"].to(cd))                      # (E, BC, d)
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
