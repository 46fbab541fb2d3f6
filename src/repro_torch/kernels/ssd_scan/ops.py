"""Public wrapper: the SSD intra-chunk dual form.

``ssd_intra_chunk`` runs the hand-written kernel on CUDA tensors and the
plain PyTorch version on CPU tensors (``impl="auto"``); it never falls
back from one to the other.  Inputs are cast to fp32 and made contiguous
here, as the reference's ``ssd_chunked`` casts before its Pallas call.
"""
from __future__ import annotations

import torch

from ..runtime import resolve_impl
from .kernel import ssd_intra_chunk_kernel
from .ref import ssd_intra_chunk_plain

__all__ = ["ssd_intra_chunk"]


def ssd_intra_chunk(xh, dt, a, Bm, Cm, *, impl: str = "auto"):
    """xh (BC, H, Q, P); dt/a (BC, H, Q, 1); Bm/Cm (BC, Q, N) ->
    ``(y (BC, H, Q, P), S (BC, H, N, P))`` fp32.  ``impl``: ``auto`` (by
    xh's device), ``kernel`` or ``ref``."""
    impl = resolve_impl(impl, xh.device)
    if impl == "ref":
        return ssd_intra_chunk_plain(xh, dt, a, Bm, Cm)
    args = (t.to(torch.float32).contiguous() for t in (xh, dt, a, Bm, Cm))
    return ssd_intra_chunk_kernel(*args)
