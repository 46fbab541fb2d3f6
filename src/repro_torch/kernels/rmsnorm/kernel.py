"""ctypes binding of the hand-written CUDA RMSNorm kernel.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``repro/kernels/rmsnorm/kernel.py:rmsnorm_kernel`` in the same contract:
x2d (R, d) fp32 or bf16 and an fp32 gain (d,) in, ``x · rsqrt(mean(x²) +
eps) · g`` out in x's dtype, fp32 accumulation.  One warp normalises one
row and ``row_block`` rows make a block; ragged R is masked in the kernel.
The reference kernel has no gradient, so this path is forward only: it
refuses inputs that would need one.  The library is built at the first
launch, never at import (this module must import on machines with no CUDA
toolkit).

``launches`` counts kernel launches made through :func:`rmsnorm_kernel`
(the one place the kernel is launched), so a run can show that its main
path went through the kernel.  On meta tensors (the dry-run) it records
:func:`cost` with the operation counter and returns meta outputs,
launching nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis import opcount
from .. import build
from ..runtime import on_card

__all__ = ["MAX_ROW_BLOCK", "cost", "rmsnorm_kernel", "launches"]

#: number of launches of the CUDA kernel since import (or the last reset)
launches = 0
#: most rows (warps) a block can take: 1,024 threads
MAX_ROW_BLOCK = 32

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def cost(R: int, d: int, elt: int) -> dict:
    """RMSNorm's work on (R, d) of ``elt``-byte elements: x read once, the
    output written once and the fp32 gain read once; 4 operations an
    element (square-add, the mean's scale, two multiplies), fp32."""
    return {"flops": 4.0 * R * d, "bytes": 2 * R * d * elt + 4 * d}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("rmsnorm")))
        lib.rmsnorm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rmsnorm_kernel(x2d: torch.Tensor, gain: torch.Tensor, *, eps: float,
                   row_block: int) -> torch.Tensor:
    """Launch the kernel on the current stream: x2d (R, d) float32 or
    bfloat16, gain (d,) float32, both contiguous CUDA tensors on one
    device; ``row_block`` rows a block, 1 to ``MAX_ROW_BLOCK``.  Returns
    (R, d) in x2d's dtype — what :func:`.ref.rmsnorm_plain` computes."""
    global launches
    for name, t in (("x2d", x2d), ("gain", gain)):
        if not (t.is_cuda or t.is_meta) or t.device != x2d.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x2d.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"x2d dtype {x2d.dtype} not supported (float32, "
                        f"bfloat16)")
    if gain.dtype != torch.float32:
        raise TypeError(f"gain must be float32, got {gain.dtype}")
    if torch.is_grad_enabled() and (x2d.requires_grad or gain.requires_grad):
        raise RuntimeError("the RMSNorm kernel is forward only (the "
                           "reference kernel has no gradient): call it on "
                           "tensors that do not require grad, or under "
                           "torch.no_grad()")
    if x2d.dim() != 2 or gain.shape != (x2d.shape[1],) or x2d.shape[1] < 1:
        raise ValueError(f"x2d {tuple(x2d.shape)} and gain "
                         f"{tuple(gain.shape)} are not (R, d) and (d,)")
    R, d = x2d.shape
    if R >= 2**31 or R * d >= 2**62:
        raise ValueError(f"x2d {tuple(x2d.shape)} too large")
    if not 1 <= row_block <= MAX_ROW_BLOCK:
        raise ValueError(f"row_block {row_block} outside 1..{MAX_ROW_BLOCK}")
    out = torch.empty_like(x2d)
    if R == 0:
        return out
    if opcount.active():
        opcount.kernel("rmsnorm", cost(R, d, x2d.element_size()))
    if not on_card(x2d):
        return out
    lib = _load()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.rmsnorm_launch(x2d.data_ptr(), gain.data_ptr(),
                                out.data_ptr(), R, d, float(eps),
                                int(row_block),
                                int(x2d.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {rc} "
                           f"({lib.rmsnorm_error_string(rc).decode()})")
    launches += 1
    return out
