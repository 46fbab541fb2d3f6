"""Impl resolution shared by the kernel wrappers.

Every ``ops.py`` wrapper takes ``impl`` in :data:`IMPLS` and resolves
``auto`` by the device of the tensor it was handed: a CUDA tensor runs the
hand-written Hopper kernel, a CPU tensor runs the plain PyTorch version.
There is no interpret mode and no fallback: ``kernel`` on a CPU tensor
raises, and ``ref`` on a CUDA tensor is only ever taken when a caller asks
for it by name (tests, and the kernel-vs-plain comparisons of
``chip_smoke.py``).

A ``meta`` tensor (the dry-run, ``launch/dryrun.py``) resolves ``auto`` to
``kernel``, since the dry-run models the card's path: each kernel function
then records its ``cost()`` with the operation counter and returns meta
outputs of the kernel's shapes, its scratch included, building and
launching nothing (:func:`on_card`).  ``ref`` on a meta tensor traces the
plain version, when asked by name.
"""
from __future__ import annotations

import torch

__all__ = ["IMPLS", "on_card", "resolve_impl"]

IMPLS = ("auto", "kernel", "ref")


def resolve_impl(impl: str, device: torch.device | str) -> str:
    """Map ``impl`` to ``kernel`` or ``ref`` for a tensor on ``device``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; pick from {IMPLS}")
    kernel_device = torch.device(device).type in ("cuda", "meta")
    if impl == "auto":
        return "kernel" if kernel_device else "ref"
    if impl == "kernel" and not kernel_device:
        raise ValueError(f"impl='kernel' needs CUDA tensors, got a tensor "
                         f"on {device} (the CPU runs impl='ref')")
    return impl


def on_card(t: torch.Tensor) -> bool:
    """Whether a kernel function handed ``t`` launches: True on a CUDA
    tensor, False on a meta tensor (the dry-run: outputs allocated on
    meta, nothing built or launched).  Any other device raises, as the
    kernels' own device checks do."""
    if t.is_meta:
        return False
    if not t.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got a tensor on "
                         f"{t.device}")
    return True
