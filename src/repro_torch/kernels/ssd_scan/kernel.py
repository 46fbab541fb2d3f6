"""ctypes binding of the hand-written CUDA SSD intra-chunk kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_intra_chunk_kernel`` in the same
contract: fp32 ``xh (BC, H, Q, P)``, ``dt``/``a (BC, H, Q, 1)``,
``Bm``/``Cm (BC, Q, N)`` in; fp32 ``y (BC, H, Q, P)`` and ``S
(BC, H, N, P)`` out.  The library is built at the first launch, never at
import (this module must import on machines with no CUDA toolkit).

``launches`` counts kernel launches made through
:func:`ssd_intra_chunk_kernel` (the one place the kernel is launched), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

__all__ = ["ssd_intra_chunk_kernel", "launches"]

#: number of launches of the CUDA kernel since import (or the last reset)
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("ssd_scan")))
        lib.ssd_intra_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.ssd_intra_chunk_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_intra_chunk_kernel(xh: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor):
    """Launch the kernel on the current stream.  All five inputs fp32,
    CUDA, one device, contiguous.  Returns ``(y, S)`` — what
    :func:`.ref.ssd_intra_chunk_plain` computes."""
    global launches
    tensors = {"xh": xh, "dt": dt, "a": a, "Bm": Bm, "Cm": Cm}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != xh.device:
            raise ValueError(f"{name} must be a CUDA tensor on {xh.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xh.dim() != 4:
        raise ValueError(f"xh must be (BC, H, Q, P), got {tuple(xh.shape)}")
    BC, H, Q, P = xh.shape
    N = Bm.shape[-1]
    if dt.shape != (BC, H, Q, 1) or a.shape != (BC, H, Q, 1):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} must "
                         f"be {(BC, H, Q, 1)}")
    if Bm.shape != (BC, Q, N) or Cm.shape != (BC, Q, N):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must "
                         f"be (BC, Q, N) = {(BC, Q, N)}")
    if min(BC, H, Q, P, N) < 1 or max(BC, H) > 65535:
        raise ValueError(f"shape (BC, H, Q, P, N) = {(BC, H, Q, P, N)} out "
                         f"of range (each >= 1, BC and H <= 65535)")
    y = torch.empty((BC, H, Q, P), dtype=torch.float32, device=xh.device)
    S = torch.empty((BC, H, N, P), dtype=torch.float32, device=xh.device)
    lib = _load()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = lib.ssd_intra_chunk_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), S.data_ptr(), BC, H, Q, P, N,
            stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed: CUDA error {rc} "
                           f"({lib.ssd_scan_error_string(rc).decode()})")
    launches += 1
    return y, S
