"""ctypes binding of the hand-written CUDA flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``.  It
reads q (B, S, H, D) and k/v (B, T, KV, D) in the model layout through
their strides (last dimension contiguous), so the TPU wrapper's transposes
are gone, masks ragged S and T itself, and also writes the fp32 per-row
log-sum-exp (B, H, S) that the backward pass needs.  bf16 runs on the
tensor cores (``mma.sync``), fp32 on plain FMA.  The library is built at
the first launch, never at import (this module must import on machines
with no CUDA toolkit).

``launches`` counts kernel launches made through
:func:`flash_attention_kernel` (the one place the kernel is launched), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["flash_attention_kernel", "launches"]

#: number of launches of the CUDA kernel since import (or the last reset)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("flash_attention")))
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int | None = None):
    """Launch the kernel on the current stream.

    q: (B, S, H, D); k/v: (B, T, KV, D) with H a multiple of KV; all CUDA
    on one device, one dtype (float32 or bfloat16), last dimension
    contiguous.  Returns ``(out (B, S, H, D) in q's dtype, lse (B, H, S)
    fp32)`` — what :func:`.ref.flash_attention_plain` computes."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or KV < 1
            or H % KV):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as (B, T, KV, D) with H "
                         f"a multiple of KV")
    if not (8 <= D <= 128 and D % 8 == 0):
        raise ValueError(f"head dim {D} not supported by the flash kernel "
                         f"(multiples of 8 up to 128)")
    if min(B, S, T) < 1 or B > 65535 or H > 65535:
        raise ValueError(f"unsupported sizes B={B} S={S} T={T} H={H}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
            v.stride(2), out.stride(0), out.stride(1), out.stride(2), B, S, T,
            H, KV, D, int(causal), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    launches += 1
    return out, lse
