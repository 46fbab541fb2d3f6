"""Public wrapper: paged flash-decode attention over a shared page pool.

``paged_decode_attention`` takes what the serving engine holds (the pool,
the page table, per-slot lengths, the current token's K/V delta) and
returns the (B, 1, H, D) attention output without building a per-slot
view.  On a CUDA tensor it launches the hand-written kernel (the
unnormalised ``(acc, m, l)``) and LSE-merges the current token's self term
here, in torch, as the JAX package does outside its Pallas kernel; on a
CPU tensor it runs the gather oracle.  It never falls back from one to the
other.
"""
from __future__ import annotations

import math

import torch

from ..runtime import resolve_impl
from .kernel import paged_attention_kernel
from .ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention"]


def paged_decode_attention(q, k_pool, v_pool, pages, kv_len, kt, vt, *,
                           window: int | None = None,
                           impl: str = "auto") -> torch.Tensor:
    """One-token attention straight against a paged KV pool.

    q: (B, 1, H, D); k/v_pool: (P, KV, page_size, D) shared pools; pages:
    (B, n_pages) int32 page table (physical page 0 = trash, read as
    zeros); kv_len: scalar or (B,) OLD cache lengths; kt/vt: (B, KV, 1, D)
    current-token K/V.  Returns (B, 1, H, D), matching
    ``_decode_attn_plus_self`` over the gathered view.  ``impl``: ``auto``
    (by q's device), ``kernel`` or ``ref``."""
    impl = resolve_impl(impl, q.device)
    if impl == "ref":
        return paged_decode_attention_ref(q, k_pool, v_pool, pages, kv_len,
                                          kt, vt, window=window)
    B, _, H, D = q.shape
    KV = k_pool.shape[1]
    G = H // KV
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    kv_len = kv_len.expand(B).to(torch.int32).contiguous()
    scale = 1.0 / math.sqrt(D)
    qf = (q.reshape(B, KV, G, D) * scale).to(q.dtype).contiguous()
    acc, m, l = paged_attention_kernel(qf, k_pool, v_pool, pages, kv_len,
                                       window=window)

    # LSE merge of the current token's self term (delta-cache contract:
    # kt/vt are not in the pool yet) — mirrors _decode_attn_plus_self
    s_self = torch.einsum("bkgd,bktd->bkgt", qf.float(),
                          kt.to(q.dtype).float())[..., 0]
    m_tot = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_tot)
    beta = torch.exp(s_self - m_tot)
    l_tot = alpha * l + beta
    out = alpha[..., None] * acc + beta[..., None] * vt[:, :, 0, :].float()[
        :, :, None, :]
    out = out / l_tot[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
