"""Fused RMSNorm: the hand-written Hopper kernel beside its plain PyTorch
version; :mod:`..runtime` resolves which of the two a call runs, and the
port's autotuner (:mod:`..tuning`) supplies the kernel's row blocking."""
from . import kernel, ops, ref
from .kernel import cost, rmsnorm_kernel
from .ops import DEFAULT_ROW_BLOCK, rmsnorm
from .ref import rmsnorm_plain

__all__ = ["kernel", "ops", "ref", "cost", "rmsnorm_kernel",
           "DEFAULT_ROW_BLOCK", "rmsnorm", "rmsnorm_plain"]
