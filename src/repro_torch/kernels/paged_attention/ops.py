"""Public wrapper: paged flash-decode attention over a shared page pool.

``paged_decode_attention`` takes what the serving engine holds (the pool,
the page table, per-slot lengths, the current token's K/V delta) and
returns the (B, 1, H, D) attention output without building a per-slot
view.  On a CUDA tensor it makes one kernel call, two launches: the split
pass (q's pre-scale inside) and the merge pass, which also LSE-merges the
current token's self term and normalises, as the JAX package does outside
its Pallas kernel; no eager op runs around them.  On a CPU tensor it runs
the gather oracle.  It never falls back from one to the other.

The kernel's launch shape (pages a split) comes from the caller, else
from the port's autotuner cache (lookups only: the wrapper never times
anything), else :func:`.kernel.default_pages_per_split`, as the RMSNorm
wrapper does.
"""
from __future__ import annotations

import math

import torch

from ..runtime import resolve_impl
from ..tuning import get_tuner
from .kernel import _KV_DTYPES, paged_decode_kernel
from ...dtypes import cast_kv
from .ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention"]


def _tuned_pages_per_split(shape, dtype, pages_per_split: int | None, *,
                           backend: str) -> int | None:
    """``pages_per_split`` if given, else the tuned config for this
    (bucket, dtype) on ``backend``'s kernel path, else None (the kernel's
    default)."""
    if pages_per_split is not None:
        return pages_per_split
    cfg = get_tuner().lookup("paged_attention", shape, dtype,
                             backend=backend, impl="kernel") or {}
    return cfg.get("pages_per_split")


def paged_decode_attention(q, k_pool, v_pool, pages, kv_len, kt, vt, *,
                           window: int | None = None, impl: str = "auto",
                           pages_per_split: int | None = None
                           ) -> torch.Tensor:
    """One-token attention straight against a paged KV pool.

    q: (B, 1, H, D); k/v_pool: (P, KV, page_size, D) shared pools; pages:
    (B, n_pages) int32 page table (physical page 0 = trash, read as
    zeros); kv_len: scalar or (B,) OLD cache lengths; kt/vt: (B, KV, 1, D)
    current-token K/V.  Returns (B, 1, H, D), matching
    ``_decode_attn_plus_self`` over the gathered view.  ``impl``: ``auto``
    (by q's device), ``kernel`` or ``ref``; ``pages_per_split`` pins the
    kernel's launch shape (the plain version takes and ignores it)."""
    impl = resolve_impl(impl, q.device)
    if impl == "ref":
        return paged_decode_attention_ref(q, k_pool, v_pool, pages, kv_len,
                                          kt, vt, window=window)
    pps = _tuned_pages_per_split(q.shape, q.dtype, pages_per_split,
                                 backend=q.device.type)
    B = q.shape[0]
    if not isinstance(kv_len, torch.Tensor) or kv_len.shape != (B,):
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(B)
    kv_len = kv_len.to(torch.int32).contiguous()
    # casts only where the caller's dtypes differ from the kernel's (the
    # decode path hands over kt and vt in the pools' dtype already)
    kt = cast_kv(kt, k_pool.dtype)
    if vt.dtype not in _KV_DTYPES:
        vt = vt.float()
    return paged_decode_kernel(q.contiguous(), k_pool, v_pool, pages, kv_len,
                               kt.contiguous(), vt.contiguous(),
                               scale=1.0 / math.sqrt(q.shape[-1]),
                               window=window, pages_per_split=pps)
