"""Plain PyTorch version of the flash-attention kernel.

:func:`flash_attention_plain` computes what the CUDA kernel emits: the
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
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "visible_mask", "flash_attention_plain"]

NEG_INF = -2.3819763e38


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
