"""Public wrappers for the Jacobi sweep kernels.

``impl="auto"`` runs the hand-written kernel on CUDA tensors and the plain
PyTorch version on CPU tensors (resolved by A's device); it never falls
back from one to the other.  The kernel masks ragged N itself, so nothing
is padded or copied, and it has one fixed launch shape (no tuner yet).
"""
from __future__ import annotations

import torch

from ..runtime import resolve_impl
from .kernel import jacobi_sweep_kernel, jacobi_sweep_residual_kernel
from .ref import jacobi_sweep_plain, jacobi_sweep_residual_plain

__all__ = ["jacobi_sweep", "jacobi_sweep_residual"]


def jacobi_sweep(A, x, b, diag, *, impl: str = "auto"):
    """One Jacobi sweep: A (N, N); x, b, diag (N,) -> x' (N,)."""
    impl = resolve_impl(impl, A.device)
    if impl == "ref":
        return jacobi_sweep_plain(A, x, b, diag)
    return jacobi_sweep_kernel(*(t.contiguous() for t in (A, x, b, diag)))


def jacobi_sweep_residual(A, x, b, diag, *, impl: str = "auto"):
    """Fused sweep: returns ``(x', ‖b − A·x‖)`` with ONE A-matvec.

    The returned norm is the residual of the *incoming* iterate ``x``; a
    convergence loop tests it lagged by one iteration.  The kernel's
    per-block partials are summed here, outside the kernel, as the JAX
    wrapper sums the Pallas kernel's.
    """
    impl = resolve_impl(impl, A.device)
    if impl == "ref":
        x2, rsq = jacobi_sweep_residual_plain(A, x, b, diag)
    else:
        x2, partials = jacobi_sweep_residual_kernel(
            *(t.contiguous() for t in (A, x, b, diag)))
        rsq = partials.sum()
    return x2, torch.sqrt(rsq)
