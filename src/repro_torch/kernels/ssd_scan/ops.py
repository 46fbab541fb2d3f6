"""Public wrapper: the SSD intra-chunk dual form.

``ssd_intra_chunk`` runs the hand-written kernel on CUDA tensors and the
plain PyTorch version on CPU tensors (``impl="auto"``); it never falls
back from one to the other.  Inputs are cast to fp32 here, as the
reference's ``ssd_chunked`` casts before its Pallas call; the kernel reads
them through their strides, so a view (the model's (B·nc, Q, H, P) memory
seen as (BC, H, Q, P)) goes in without a copy.

On the kernel path the call goes through :class:`SsdIntraChunkFn`: the
kernel computes the forward, and the backward is the derivative of the
plain version, rebuilt on the saved inputs (the reference has no SSD
backward kernel either: ``jax.grad`` differentiates its plain scan).  On
the CPU the plain version runs under plain autograd.

The kernel's launch shape (``row_tile``, rows of a tile) comes from the
caller, else from the port's autotuner cache (CUDA tensors only; lookups
only: the wrapper never times anything), else
:func:`.kernel.default_row_tile`, as the paged and RMSNorm wrappers do.
The plain version takes the same values and ignores them; values outside
:data:`.kernel.ROW_TILES` are refused on either path.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..runtime import resolve_impl
from ..tuning import get_tuner
from .kernel import check_row_tile, ssd_intra_chunk_kernel
from .ref import ssd_intra_chunk_plain

__all__ = ["BACKWARD_RANGE", "SsdIntraChunkFn", "ssd_intra_chunk"]

#: the profiler range around :class:`SsdIntraChunkFn`'s backward, so that a
#: trace can sum the plain backward's device time
BACKWARD_RANGE = "ssd_intra_chunk_backward"


def _tuned_row_tile(xh: torch.Tensor, N: int,
                    row_tile: int | None) -> int | None:
    """``row_tile`` if given, else the tuned config for the bucket of
    (BC, H, Q, P, N) (the kernel bench's key) on the card, else None (the
    kernel's default)."""
    if row_tile is not None or not xh.is_cuda:
        return row_tile
    cfg = get_tuner().lookup("ssd_scan", (*xh.shape, N), torch.float32,
                             backend="cuda", impl="kernel") or {}
    return cfg.get("row_tile")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """fp32, with a unit stride along the last axis (a copy only where the
    caller's last axis is strided)."""
    t = t.to(torch.float32)
    return t if t.stride(-1) == 1 else t.contiguous()


class SsdIntraChunkFn(torch.autograd.Function):
    """``apply(xh, dt, a, Bm, Cm, row_tile) -> (y, S)``: the kernel's
    forward (inputs fp32, unit stride along the last axis of xh, Bm and
    Cm), and as backward the gradient of :func:`.ref.ssd_intra_chunk_plain`
    on the saved inputs, taken by autograd."""

    @staticmethod
    def forward(ctx, xh, dt, a, Bm, Cm, row_tile=None):
        ctx.save_for_backward(xh, dt, a, Bm, Cm)
        return ssd_intra_chunk_kernel(xh, dt, a, Bm, Cm, row_tile=row_tile)

    @staticmethod
    def backward(ctx, dy, dS):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad(), record_function(BACKWARD_RANGE):
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y, S = ssd_intra_chunk_plain(*ins)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad((y, S), wrt, (dy, dS)))
        return (*(next(grads) if n else None for n in need), None)


def ssd_intra_chunk(xh, dt, a, Bm, Cm, *, impl: str = "auto",
                    row_tile: int | None = None):
    """xh (BC, H, Q, P); dt/a (BC, H, Q, 1); Bm/Cm (BC, Q, N) ->
    ``(y (BC, H, Q, P), S (BC, H, N, P))`` fp32, differentiable in the five
    inputs.  ``impl``: ``auto`` (by xh's device), ``kernel`` or ``ref``;
    ``row_tile`` pins the kernel's launch shape."""
    check_row_tile(row_tile)
    impl = resolve_impl(impl, xh.device)
    if impl == "ref":
        return ssd_intra_chunk_plain(xh, dt, a, Bm, Cm)
    return SsdIntraChunkFn.apply(
        _unit_last(xh), dt.to(torch.float32), a.to(torch.float32),
        _unit_last(Bm), _unit_last(Cm),
        _tuned_row_tile(xh, Bm.shape[-1], row_tile))
