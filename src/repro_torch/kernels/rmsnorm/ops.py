"""Public wrapper: fused RMSNorm over the last axis.

``impl="auto"`` runs the hand-written kernel on CUDA tensors and the plain
PyTorch version on CPU tensors (resolved by x's device); it never falls
back from one to the other.  On the kernel path the row blocking comes
from the caller, else from the port's autotuner cache (lookups only: the
wrapper never times anything), else :data:`DEFAULT_ROW_BLOCK`, as the
reference's wrapper does (``repro/kernels/rmsnorm/ops.py``).  The kernel
masks ragged row counts itself, so the reference's pad to a multiple of 8
(the TPU sublane) has no counterpart here.
"""
from __future__ import annotations

import torch

from ..runtime import resolve_impl
from ..tuning import get_tuner
from .kernel import rmsnorm_kernel
from .ref import rmsnorm_plain

__all__ = ["DEFAULT_ROW_BLOCK", "rmsnorm"]

#: rows (warps) a block when neither the caller nor the tuner says
DEFAULT_ROW_BLOCK = 4


def _tuned_row_block(shape, dtype, row_block: int | None, *,
                     backend: str) -> int:
    """``row_block`` if given, else the tuned config for this (bucket,
    dtype) on ``backend``'s kernel path, else the default."""
    if row_block is not None:
        return row_block
    cfg = get_tuner().lookup("rmsnorm", shape, dtype, backend=backend,
                             impl="kernel") or {}
    return cfg.get("row_block", DEFAULT_ROW_BLOCK)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "auto", row_block: int | None = None) -> torch.Tensor:
    """x (..., d), gain (d,) -> x's shape and dtype.  ``impl``: ``auto``
    (by x's device), ``kernel`` or ``ref``; ``row_block`` pins the
    kernel's rows a block (the plain version has no blocking)."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    impl = resolve_impl(impl, x.device)
    if impl == "ref":
        out = rmsnorm_plain(x2d, gain, eps=eps)
    else:
        rb = _tuned_row_block(x2d.shape, x.dtype, row_block,
                              backend=x.device.type)
        out = rmsnorm_kernel(x2d.contiguous(),
                             gain.to(torch.float32).contiguous(), eps=eps,
                             row_block=rb)
    return out.reshape(shape)
