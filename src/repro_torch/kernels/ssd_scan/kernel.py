"""ctypes binding of the hand-written CUDA SSD intra-chunk kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_intra_chunk_kernel`` in the same
contract: fp32 ``xh (BC, H, Q, P)``, ``dt``/``a (BC, H, Q, 1)``,
``Bm``/``Cm (BC, Q, N)`` in; fp32 ``y (BC, H, Q, P)`` and ``S
(BC, H, N, P)`` out.  One call launches two device kernels: a pass that
forms C·Bᵀ once per chunk into a scratch, and, as its programmatic
dependent, the pass that forms y and S.  The inputs are read through their
strides (x, B and C need a unit stride along their last axis only), and
``y``/``S`` come back as views of (BC, Q, H, P) and (BC, H, P, N) memory,
the layouts the model's chunked scan reshapes them to.  The launch shape
is ``row_tile``, the rows of a tile of the second pass (:data:`ROW_TILES`).
The binding itself has no gradient: it refuses inputs that require
grad while grad mode is on, and :class:`.ops.SsdIntraChunkFn` (whose
forward runs with grad mode off) gives the kernel's outputs one.  The
library is built at the first launch, never at import (this module must
import on machines with no CUDA toolkit).

``launches`` counts calls of :func:`ssd_intra_chunk_kernel` (the one place
the kernels are launched): one a call, although a call launches two device
kernels, so a run can show that its main path went through the kernel.
On meta tensors (the dry-run) it records :func:`cost` with the operation
counter and returns meta outputs, launching nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis import opcount
from .. import build
from ..runtime import on_card

__all__ = ["ROW_TILES", "check_row_tile", "cost", "default_row_tile",
           "ssd_intra_chunk_kernel", "launches"]

#: number of calls of the entry point since import (or the last reset)
launches = 0

#: the launch shapes the kernel takes: rows of a tile of the y/S pass
ROW_TILES = (32, 64)
#: Hopper's SM count
_SMS = 132
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("ssd_scan")))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_chunk_launch.argtypes = (
            [vp] * 8 + [ctypes.POINTER(ctypes.c_int64)] + [i32] * 6 + [vp])
        lib.ssd_intra_chunk_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_row_tile(row_tile: int | None) -> None:
    """Raise ``ValueError`` unless ``row_tile`` is None or in
    :data:`ROW_TILES`."""
    if row_tile is not None and row_tile not in ROW_TILES:
        raise ValueError(f"row_tile {row_tile} not in the kernel's launch "
                         f"shapes {ROW_TILES}")


def default_row_tile(BC: int, H: int, Q: int, P: int, N: int) -> int:
    """64 where the y/S pass then has at most two blocks an SM (64-row
    tiles walk fewer steps and load each staged row for more outputs),
    else 32 (more, smaller blocks fill more waves); 32 where Q fits in
    one 32-row tile.  On an H100, mamba2-370m's prefill chunk (BC 1, H 32,
    Q 256, P 64, N 128: 128 blocks) and the kernel bench's (8, 8, 128, 64,
    64) get 64, eight chunks at once (1,024 blocks) and a 16-token bucket
    get 32: the faster of the two at each (``chip_smoke.py``'s
    ``ms_by_launch_shape``)."""
    if Q <= 32:
        return 32
    n_t = -(-Q // 64)
    blocks = BC * H * -(-P // 64) * ((n_t + 1) // 2 + -(-N // 64))
    return 64 if blocks <= 2 * _SMS else 32


def cost(BC: int, H: int, Q: int, P: int, N: int) -> dict:
    """The SSD function's work on these shapes (fp32).  Bytes: every input
    read once and y, S written once.  Operations (an exp counted as one):
    C Bᵀ once per chunk over the causal half, Q(Q+1)/2 * 2N; per head,
    the causal entries' weights and the product with x, Q(Q+1)/2 * (2P +
    3), and the state, Q * (2NP + N + 3) (weights, the product and the
    cumsum)."""
    causal = Q * (Q + 1) // 2
    return {"flops": BC * (causal * 2 * N
                           + H * (causal * (2 * P + 3)
                                  + Q * (2 * N * P + N + 3))),
            "bytes": 4 * BC * (2 * H * Q * P + 2 * H * Q + 2 * Q * N
                               + H * N * P)}


def _check_device(tensors: dict, dev: torch.device) -> None:
    for name, t in tensors.items():
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")


def ssd_intra_chunk_kernel(xh: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, *, row_tile: int | None = None):
    """Launch both passes on the current stream.  All five inputs fp32, on
    one CUDA device; xh, Bm and Cm with a unit stride along their last
    axis, any other strides.  ``row_tile`` (default
    :func:`default_row_tile`) is the launch shape.  Returns ``(y, S)`` —
    what :func:`.ref.ssd_intra_chunk_plain` computes."""
    global launches
    check_row_tile(row_tile)
    tensors = {"xh": xh, "dt": dt, "a": a, "Bm": Bm, "Cm": Cm}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError("the SSD kernel has no autograd of its own: call "
                           "it through ops.SsdIntraChunkFn (ssd_intra_chunk "
                           "does), or on tensors that do not require grad, "
                           "or under torch.no_grad()")
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
    _check_device(tensors, xh.device)
    for name in ("xh", "Bm", "Cm"):
        if tensors[name].stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride along its "
                             f"last axis, got {tensors[name].stride()}")
    R = row_tile or default_row_tile(BC, H, Q, P, N)
    Qp = -(-Q // R) * R
    dev = xh.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((BC, Q, H, P), **f32).transpose(1, 2)
    S = torch.empty((BC, H, P, N), **f32).transpose(2, 3)
    cb = torch.empty((BC, Qp, Qp), **f32)
    if opcount.active():
        opcount.kernel("ssd_intra_chunk", cost(BC, H, Q, P, N))
    if not on_card(xh):
        return y, S
    strides = (*xh.stride()[:3], *dt.stride()[:3], *a.stride()[:3],
               *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
               *S.stride())
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_intra_chunk_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), cb.data_ptr(), y.data_ptr(), S.data_ptr(),
            (ctypes.c_int64 * 20)(*strides), BC, H, Q, P, N, R, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed: CUDA error {rc} "
                           f"({lib.ssd_scan_error_string(rc).decode()})")
    launches += 1
    return y, S
