"""Public wrapper: flash attention with its gradient.

``FlashAttentionFn`` is the ``torch.autograd.Function`` the training path
runs.  With ``impl="kernel"`` (CUDA tensors) both halves are hand-written
kernels: the forward (output and the fp32 per-row log-sum-exp) and the
backward (dq, dk, dv from the saved output and LSE); with ``impl="ref"``
both are the plain versions of :mod:`.ref`.  There is no other route and
no fallback from one to the other.

The bf16 forward's launch shape ``(q_block, kv_block)`` comes from the
caller, else from the port's autotuner cache (CUDA tensors only; lookups
only: the wrapper never times anything), else the kernel's default, as
the paged wrapper does.  The plain version takes the same values and
ignores them; values outside :data:`.kernel.BLOCKS` are refused on either
path (and so are 128-key tiles at a head dim above ``WIDE_D``).
"""
from __future__ import annotations

import torch

from ..runtime import resolve_impl
from ..tuning import get_tuner
from .kernel import (check_blocks, default_blocks,
                     flash_attention_backward_kernel, flash_attention_kernel)
from .ref import flash_attention_backward_plain, flash_attention_plain

__all__ = ["FlashAttentionFn", "flash_attention", "launch_shape"]


def launch_shape(q: torch.Tensor, q_block: int | None = None,
                 kv_block: int | None = None) -> tuple[int, int]:
    """``(q_block, kv_block)`` for a forward on ``q``: the caller's values,
    else the tuned config for q's (bucket, dtype) on the card, else the
    kernel's defaults at q's head dim."""
    check_blocks(q_block, kv_block, q.shape[-1])
    if (q_block is None or kv_block is None) and q.is_cuda:
        cfg = get_tuner().lookup("flash_attention", q.shape, q.dtype,
                                 backend="cuda", impl="kernel") or {}
        q_block = q_block or cfg.get("q_block")
        kv_block = kv_block or cfg.get("kv_block")
    q_default, kv_default = default_blocks(q.shape[-1])
    return q_block or q_default, kv_block or kv_default


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, impl[, q_block, kv_block]) ->
    (out, lse)``; ``impl`` is ``kernel`` or ``ref`` (resolved already) and
    picks both the forward and the backward.  lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, impl, q_block=None,
                kv_block=None):
        if impl == "kernel":
            q_block, kv_block = launch_shape(q, q_block, kv_block)
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, q_block=q_block,
                                              kv_block=kv_block)
        else:
            check_blocks(q_block, kv_block, q.shape[-1])
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        backward = (flash_attention_backward_kernel if ctx.impl == "kernel"
                    else flash_attention_backward_plain)
        dq, dk, dv = backward(q, k, v, out, lse, dout, causal=ctx.causal,
                              window=ctx.window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, impl: str = "auto",
                    q_block: int | None = None, kv_block: int | None = None):
    """q: (B, S, H, D); k/v: (B, T, KV, D) — the model layout; returns
    (B, S, H, D) in q's dtype, differentiable in q, k and v.  ``impl``:
    ``auto`` (the kernels on CUDA, the plain versions on the CPU),
    ``kernel`` or ``ref``; no fallback from one to the other.
    ``q_block``/``kv_block`` pin the bf16 forward's launch shape."""
    impl = resolve_impl(impl, q.device)
    if impl == "kernel":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out, _ = FlashAttentionFn.apply(q, k, v, causal, window, impl, q_block,
                                    kv_block)
    return out
