"""Public wrapper: flash attention with its gradient.

``FlashAttentionFn`` is the ``torch.autograd.Function`` the training path
runs: its forward is the hand-written kernel on CUDA tensors (the plain
version on CPU tensors, or when asked for by name), and returns the output
and the fp32 per-row log-sum-exp.  The reference has no backward kernel
(``jax.grad`` cannot differentiate its Pallas call; it trains through
XLA's autodiff of the plain paths), so the backward here is the gradient
of the plain function, written in PyTorch ops from the saved LSE:

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

from ..runtime import resolve_impl
from .kernel import flash_attention_kernel
from .ref import flash_attention_plain, visible_mask

__all__ = ["BWD_Q_TILE", "FlashAttentionFn", "flash_attention",
           "flash_attention_backward"]

#: query rows per tile of the backward pass
BWD_Q_TILE = 1024


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool,
                             window: int | None, q_tile: int = BWD_Q_TILE):
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


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, impl) -> (out, lse)``; ``impl`` is
    ``kernel`` or ``ref`` (resolved already).  lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, impl):
        if impl == "kernel":
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, impl: str = "auto"):
    """q: (B, S, H, D); k/v: (B, T, KV, D) — the model layout; returns
    (B, S, H, D) in q's dtype, differentiable in q, k and v.  ``impl``:
    ``auto`` (the kernel on CUDA, the plain version on the CPU), ``kernel``
    or ``ref``; no fallback from one to the other."""
    impl = resolve_impl(impl, q.device)
    if impl == "kernel":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out, _ = FlashAttentionFn.apply(q, k, v, causal, window, impl)
    return out
