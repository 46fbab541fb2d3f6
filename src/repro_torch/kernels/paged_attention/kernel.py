"""ctypes binding of the hand-written CUDA paged flash-decode kernel.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/paged_attention/kernel.py:paged_attention_kernel``.  The
TPU's layout artefacts are gone: queries arrive as (B, KV, G, D) without
padding G to the sublane, and ``m``/``l`` come out as (B, KV, G) without a
128-lane broadcast.  The library is built at the first launch, never at
import (this module must import on machines with no CUDA toolkit).

``launches`` counts kernel launches made through :func:`paged_attention_kernel`
(the one place the kernel is launched), so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["paged_attention_kernel", "launches"]

#: number of launches of the CUDA kernel since import (or the last reset)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("paged_attention")))
        lib.paged_attention_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pages: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: int | None = None):
    """Launch the kernel on the current stream.

    q: (B, KV, G, D) pre-scaled grouped queries; k/v_pool: (P, KV, ps, D)
    of q's dtype (float32 or bfloat16); pages: (B, n_pages) int32 with ids
    in [0, P); kv_len: (B,) int32 OLD lengths.  All CUDA, one device,
    contiguous.  Returns fp32 ``acc`` (B, KV, G, D) and ``m``, ``l``
    (B, KV, G) — what :func:`.ref.paged_attention_plain` computes."""
    global launches
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "pages": pages,
               "kv_len": kv_len}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} differ "
                        f"from q's {q.dtype}")
    if pages.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("pages and kv_len must be int32")
    B, KV, G, D = q.shape
    ps = k_pool.shape[2]
    if (k_pool.dim() != 4 or k_pool.shape[1] != KV or k_pool.shape[3] != D
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as (P, KV, ps, D)")
    if pages.dim() != 2 or pages.shape[0] != B or kv_len.shape != (B,):
        raise ValueError(f"pages {tuple(pages.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    acc = torch.empty((B, KV, G, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pages.data_ptr(), kv_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, KV, G, D, ps, pages.shape[1],
            0 if window is None else int(window), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc} "
                           f"({lib.paged_attention_error_string(rc).decode()})")
    launches += 1
    return acc, m, l
