"""Public wrapper: the SSD intra-chunk dual form.

``ssd_intra_chunk`` runs the hand-written kernel on CUDA tensors and the
plain PyTorch version on CPU tensors (``impl="auto"``); it never falls
back from one to the other.  Inputs are cast to fp32 here, as the
reference's ``ssd_chunked`` casts before its Pallas call; the kernel reads
them through their strides, so a view (the model's (B·nc, Q, H, P) memory
seen as (BC, H, Q, P)) goes in without a copy.

The kernel's launch shape (``row_tile``, rows of a tile) comes from the
caller, else from the port's autotuner cache (CUDA tensors only; lookups
only: the wrapper never times anything), else
:func:`.kernel.default_row_tile`, as the paged and RMSNorm wrappers do.
The plain version takes the same values and ignores them; values outside
:data:`.kernel.ROW_TILES` are refused on either path.
"""
from __future__ import annotations

import torch

from ..runtime import resolve_impl
from ..tuning import get_tuner
from .kernel import check_row_tile, ssd_intra_chunk_kernel
from .ref import ssd_intra_chunk_plain

__all__ = ["ssd_intra_chunk"]


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


def ssd_intra_chunk(xh, dt, a, Bm, Cm, *, impl: str = "auto",
                    row_tile: int | None = None):
    """xh (BC, H, Q, P); dt/a (BC, H, Q, 1); Bm/Cm (BC, Q, N) ->
    ``(y (BC, H, Q, P), S (BC, H, N, P))`` fp32.  ``impl``: ``auto`` (by
    xh's device), ``kernel`` or ``ref``; ``row_tile`` pins the kernel's
    launch shape."""
    check_row_tile(row_tile)
    impl = resolve_impl(impl, xh.device)
    if impl == "ref":
        return ssd_intra_chunk_plain(xh, dt, a, Bm, Cm)
    return ssd_intra_chunk_kernel(
        _unit_last(xh), dt.to(torch.float32), a.to(torch.float32),
        _unit_last(Bm), _unit_last(Cm),
        row_tile=_tuned_row_tile(xh, Bm.shape[-1], row_tile))
