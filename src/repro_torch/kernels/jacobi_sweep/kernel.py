"""ctypes binding of the hand-written CUDA Jacobi sweep kernels.

The kernels (``csrc/jacobi_sweep.cu``, one source with a ``fused`` flag)
replace the Pallas TPU kernels ``repro/kernels/jacobi_sweep/kernel.py:
jacobi_sweep_kernel`` and ``jacobi_sweep_residual_kernel`` in the same
contract: A (N, N) and x, b, diag (N,), each fp32 or bf16, fp32
accumulation, x' in x's dtype; the fused kernel also returns fp32
per-row-block partials of ``Σ (b − A·x)²``.  Ragged N needs no padding.
The library is built at the first launch, never at import (this module
must import on machines with no CUDA toolkit).

``launches`` counts the launches of each kernel made through the two
functions below (the one place each is launched), so a run can show that
its main path went through the kernel.  On meta tensors (the dry-run) the
functions record :func:`cost` with the operation counter and return meta
outputs, launching nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis import opcount
from .. import build
from ..runtime import on_card

__all__ = ["ROWS_PER_BLOCK", "cost", "jacobi_sweep_kernel",
           "jacobi_sweep_residual_kernel", "launches", "n_blocks"]

#: kernel name -> launches since import (or the last reset)
launches = {"jacobi_sweep": 0, "jacobi_sweep_residual": 0}

_DTYPES = (torch.float32, torch.bfloat16)
#: rows a block (8 warps of 2 rows), as ``csrc/jacobi_sweep.cu`` has it
ROWS_PER_BLOCK = 16
_lib = None


def n_blocks(n: int) -> int:
    """Row blocks, and fused partials, for size n
    (``jacobi_sweep_n_blocks``)."""
    return -(-n // ROWS_PER_BLOCK)


def cost(inputs, outputs) -> dict:
    """One sweep's work on these tensors: the bytes of A, x, b and d read
    once and of x' (and the fused kernel's fp32 partials) written once,
    and its 2N² operations (fp32)."""
    n = inputs[0].shape[0]
    return {"flops": 2.0 * n * n,
            "bytes": sum(t.numel() * t.element_size()
                         for t in (*inputs, *outputs))}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("jacobi_sweep")))
        lib.jacobi_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.jacobi_sweep_launch.restype = ctypes.c_int
        lib.jacobi_sweep_n_blocks.argtypes = [ctypes.c_int]
        lib.jacobi_sweep_n_blocks.restype = ctypes.c_int
        lib.jacobi_sweep_error_string.argtypes = [ctypes.c_int]
        lib.jacobi_sweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(name: str, A, x, b, diag, *, fused: bool):
    tensors = {"A": A, "x": x, "b": b, "diag": diag}
    for key, t in tensors.items():
        if not (t.is_cuda or t.is_meta) or t.device != A.device:
            raise ValueError(f"{key} must be a CUDA tensor on {A.device}, "
                             f"got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{key} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    N = A.shape[0]
    if A.dim() != 2 or A.shape[1] != N or not 1 <= N < 2**31:
        raise ValueError(f"A must be (N, N) with N >= 1, got "
                         f"{tuple(A.shape)}")
    for key in ("x", "b", "diag"):
        if tensors[key].shape != (N,):
            raise ValueError(f"{key} must be ({N},), got "
                             f"{tuple(tensors[key].shape)}")
    out = torch.empty_like(x)
    partials = (torch.empty(n_blocks(N), dtype=torch.float32,
                            device=A.device) if fused else None)
    if opcount.active():
        opcount.kernel(name, cost((A, x, b, diag),
                                  (out,) + ((partials,) if fused else ())))
    if not on_card(A):
        return out, partials
    lib = _load()
    if fused and lib.jacobi_sweep_n_blocks(N) != partials.numel():
        raise RuntimeError("the library's row blocking differs from "
                           "ROWS_PER_BLOCK")
    is_bf16 = [int(t.dtype == torch.bfloat16) for t in (A, x, b, diag)]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.jacobi_sweep_launch(
            A.data_ptr(), x.data_ptr(), b.data_ptr(), diag.data_ptr(),
            out.data_ptr(), partials.data_ptr() if fused else None, N,
            *is_bf16, int(fused), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.jacobi_sweep_error_string(rc).decode()})")
    launches[name] += 1
    return out, partials


def jacobi_sweep_kernel(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                        diag: torch.Tensor) -> torch.Tensor:
    """Launch the plain sweep on the current stream: returns x' — what
    :func:`.ref.jacobi_sweep_plain` computes."""
    return _launch("jacobi_sweep", A, x, b, diag, fused=False)[0]


def jacobi_sweep_residual_kernel(A: torch.Tensor, x: torch.Tensor,
                                 b: torch.Tensor, diag: torch.Tensor):
    """Launch the fused sweep on the current stream: returns ``(x',
    partials)``, ``partials.sum()`` being ``‖b − A·x‖²`` of the incoming
    iterate — what :func:`.ref.jacobi_sweep_residual_plain` computes."""
    return _launch("jacobi_sweep_residual", A, x, b, diag, fused=True)
