"""Impl resolution shared by the kernel wrappers.

Every ``ops.py`` wrapper takes ``impl`` in :data:`IMPLS` and resolves
``auto`` by the device of the tensor it was handed: a CUDA tensor runs the
hand-written Hopper kernel, a CPU tensor runs the plain PyTorch version.
There is no interpret mode and no fallback: ``kernel`` on a CPU tensor
raises, and ``ref`` on a CUDA tensor is only ever taken when a caller asks
for it by name (tests, and the kernel-vs-plain comparisons of
``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["IMPLS", "resolve_impl"]

IMPLS = ("auto", "kernel", "ref")


def resolve_impl(impl: str, device: torch.device | str) -> str:
    """Map ``impl`` to ``kernel`` or ``ref`` for a tensor on ``device``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; pick from {IMPLS}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        return "kernel" if on_cuda else "ref"
    if impl == "kernel" and not on_cuda:
        raise ValueError(f"impl='kernel' needs CUDA tensors, got a tensor "
                         f"on {device} (the CPU runs impl='ref')")
    return impl
