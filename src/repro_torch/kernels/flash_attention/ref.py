"""Plain PyTorch versions of the flash-attention kernels.

:func:`flash_attention_plain` computes what the CUDA forward emits: the
attention output in q's dtype and the fp32 per-row log-sum-exp, in the
model layout (q (B, S, H, D), k/v (B, T, KV, D)) with query position i and
key position j taken as ``arange(S)`` and ``arange(T)``, as the reference's
oracle (``repro/kernels/flash_attention/ref.py:attention_ref``) takes them.
On rows with at least one visible key it is that oracle; a row with none
(possible only when S > T) gives a zero output and an LSE of ``NEG_INF``,
where the reference's paths each give a different finite average.

It is the CPU path of :func:`..ops.flash_attention` and the oracle that
``chip_smoke.py`` and the card tests hold the kernel against; on the card
it runs only when asked for by name.

:func:`flash_attention_backward_plain` is the gradient of that function,
written in PyTorch ops from the saved LSE, the plain version of the CUDA
backward (the reference has no backward kernel: ``jax.grad`` cannot
differentiate its Pallas call, so it trains through XLA's autodiff of the
plain paths):

    P = exp(q·kᵀ·scale − LSE) (masked),  D_i = rowsum(dO ∘ O),
    dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − D_i),  dQ = dS·K·scale,
    dK = dSᵀ·Q·scale,

over query tiles of ``BWD_Q_TILE`` rows (transient memory is one tile's
scores, not S×T), each tile visiting only the keys its rows can see; GQA
gradients sum over each group.  It computes in fp32.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BWD_Q_TILE", "NEG_INF", "visible_mask", "flash_attention_plain",
           "flash_attention_backward_plain"]

NEG_INF = -2.3819763e38
#: query rows per tile of the plain backward
BWD_Q_TILE = 1024


def visible_mask(S: int, T: int, *, causal: bool, window: int | None,
                 device, q0: int = 0, k0: int = 0) -> torch.Tensor:
    """(S, T) bool: query ``q0 + i`` may attend to key ``k0 + j``."""
    qp = q0 + torch.arange(S, device=device)[:, None]
    kp = k0 + torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (qp >= kp)
    if window is not None:
        ok = ok & (qp - kp < window)
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None):
    """q: (B, S, H, D); k/v: (B, T, KV, D), H a multiple of KV (query head
    h reads KV head h // (H / KV)).  Returns ``(out (B, S, H, D) in q's
    dtype, lse (B, H, S) fp32)``; scores, softmax and P·V in fp32."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    ok = visible_mask(S, T, causal=causal, window=window, device=q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bkgst,btkd->bskgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(B, H, S)
    return out.reshape(B, S, H, D).to(q.dtype), lse


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal: bool,
                                   window: int | None,
                                   q_tile: int = BWD_Q_TILE):
    """Gradients ``(dq, dk, dv)`` of the flash-attention output, in the
    inputs' dtypes, from the forward's output and LSE (see the module
    docstring)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, KV, G, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, S, KV, G, D)
    di = (do * out.float().reshape(B, S, KV, G, D)).sum(-1)  # (B, S, KV, G)
    di = di.permute(0, 2, 3, 1)                              # (B, KV, G, S)
    lse = lse.reshape(B, KV, G, S)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i0 in range(0, S, q_tile):
        i1 = min(S, i0 + q_tile)
        hi = min(T, i1) if causal else T
        lo = max(0, i0 - window + 1) if window is not None else 0
        if hi <= lo:
            continue            # no row of the tile sees a key
        qi, doi = qf[:, i0:i1], do[:, i0:i1]
        kj, vj = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bskgd,btkd->bkgst", qi, kj) * scale
        ok = visible_mask(i1 - i0, hi - lo, causal=causal, window=window,
                          device=q.device, q0=i0, k0=lo)
        p = torch.where(ok, torch.exp(s - lse[..., i0:i1, None]), 0.0)
        del s
        dv[:, lo:hi] += torch.einsum("bkgst,bskgd->btkd", p, doi)
        dp = torch.einsum("bskgd,btkd->bkgst", doi, vj)
        ds = p * (dp - di[..., i0:i1, None])
        del p, dp
        dq[:, i0:i1] = torch.einsum("bkgst,btkd->bskgd", ds, kj) * scale
        dk[:, lo:hi] += torch.einsum("bkgst,bskgd->btkd", ds, qi) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
