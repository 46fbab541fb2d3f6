"""Plain PyTorch versions of the Jacobi sweep kernels.

They mirror the JAX package's oracles (``repro/kernels/jacobi_sweep/
ref.py``) formula for formula, so the two update forms differ as there:

* :func:`jacobi_sweep_plain`: ``x' = (b − A·x + d·x) / d``;
* :func:`jacobi_sweep_residual_plain`: ``x' = x + r / d`` with
  ``r = b − A·x``, and ``Σ r²`` (the squared residual of the *incoming*
  iterate) from the same matvec.

Both accumulate in fp32 and return ``x'`` in ``x``'s dtype.  They are the
CPU path of :mod:`.ops`; on the card they run only when asked for by name
(tests, and the kernel-vs-plain comparisons of ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["jacobi_sweep_plain", "jacobi_sweep_residual_plain"]


def jacobi_sweep_plain(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       diag: torch.Tensor) -> torch.Tensor:
    """A (N, N); x, b, diag (N,) -> x' (N,) in x's dtype."""
    Af = A.float()
    xf = x.float()
    t = Af @ xf
    return ((b.float() - t + diag.float() * xf) / diag.float()).to(x.dtype)


def jacobi_sweep_residual_plain(A: torch.Tensor, x: torch.Tensor,
                                b: torch.Tensor, diag: torch.Tensor):
    """Fused form: ``(x', ‖b − A·x‖²)`` with a single matvec; ``x'`` in x's
    dtype, the squared norm a 0-d fp32 tensor."""
    Af = A.float()
    xf = x.float()
    df = diag.float()
    r = b.float() - Af @ xf
    x2 = (xf + r / df).to(x.dtype)
    return x2, torch.sum(r * r)
