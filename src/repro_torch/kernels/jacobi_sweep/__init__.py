"""Jacobi sweep, plain and fused-residual: the hand-written Hopper kernels
beside their plain PyTorch versions; :mod:`..runtime` resolves which of
the two a call runs."""
from . import kernel, ops, ref
from .kernel import jacobi_sweep_kernel, jacobi_sweep_residual_kernel
from .ops import jacobi_sweep, jacobi_sweep_residual
from .ref import jacobi_sweep_plain, jacobi_sweep_residual_plain

__all__ = ["kernel", "ops", "ref", "jacobi_sweep_kernel",
           "jacobi_sweep_residual_kernel", "jacobi_sweep",
           "jacobi_sweep_residual", "jacobi_sweep_plain",
           "jacobi_sweep_residual_plain"]
