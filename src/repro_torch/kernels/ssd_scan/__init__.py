"""Mamba-2 SSD intra-chunk: the hand-written Hopper kernel beside its
plain PyTorch version; :mod:`..runtime` resolves which of the two a call
runs."""
from . import kernel, ops, ref
from .kernel import cost, ssd_intra_chunk_kernel
from .ops import ssd_intra_chunk
from .ref import ssd_intra_chunk_plain

__all__ = ["kernel", "ops", "ref", "cost", "ssd_intra_chunk_kernel",
           "ssd_intra_chunk", "ssd_intra_chunk_plain"]
