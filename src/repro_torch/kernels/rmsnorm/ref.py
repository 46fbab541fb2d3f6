"""Plain PyTorch version of the RMSNorm kernel.

It mirrors the JAX package's oracle (``repro/kernels/rmsnorm/ref.py``)
formula for formula: fp32 accumulation, ``x · rsqrt(mean(x²) + eps) · g``
in that order, the result in x's dtype.  It is the CPU path of
:func:`.ops.rmsnorm`; on the card it runs only when asked for by name
(tests, and the kernel-vs-plain comparisons of ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_plain"]


def rmsnorm_plain(x2d: torch.Tensor, gain: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x2d (R, d), gain (d,) -> (R, d) in x2d's dtype."""
    xf = x2d.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gain.float()).to(x2d.dtype)
