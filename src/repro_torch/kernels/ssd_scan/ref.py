"""Plain PyTorch version of the SSD intra-chunk kernel.

:func:`ssd_intra_chunk_plain` computes, per (batch·chunk, head), the dual
quadratic form of Mamba-2's chunked SSD algorithm — what the CUDA kernel
(``csrc/ssd_scan.cu``) computes, in the same contract.  It is the CPU path
of :func:`..ops.ssd_intra_chunk`; on the card it runs only when asked for
by name (tests, and the kernel-vs-plain comparisons of ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["ssd_intra_chunk_plain"]


def ssd_intra_chunk_plain(xh: torch.Tensor, dt: torch.Tensor,
                          a: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor):
    """xh (BC, H, Q, P); dt/a (BC, H, Q, 1); Bm/Cm (BC, Q, N) ->
    ``(y (BC, H, Q, P), S (BC, H, N, P))``, both fp32::

        cum = cumsum(a)                        over Q
        L   = tril(exp(cum_t - cum_s))
        y   = ((C Bᵀ) ⊙ L) (dt ⊙ x)
        S   = (B ⊙ dt ⊙ exp(cum_end - cum))ᵀ x

    Above the diagonal the exponent is replaced by 0 with a select before
    ``exp`` and the result by 0 with a select after it, never a product:
    the reference selects after ``exp`` only, with the same values, but
    there ``exp`` overflows under strong decay and its gradient becomes
    ``0 · inf = NaN``; here it stays finite."""
    x = xh.float()
    dtf = dt[..., 0].float()                                # (BC, H, Q)
    af = a[..., 0].float()
    B = Bm.float()
    C = Cm.float()
    Q = x.shape[2]
    cum = torch.cumsum(af, dim=-1)                          # (BC, H, Q)
    seg = cum[..., :, None] - cum[..., None, :]             # (BC, H, Q, Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    zero = torch.zeros((), device=x.device)
    L = torch.where(tri, torch.exp(torch.where(tri, seg, zero)), zero)
    CB = torch.einsum("bqn,bsn->bqs", C, B)                 # (BC, Q, Q)
    M = CB[:, None] * L                                     # (BC, H, Q, Q)
    y = torch.einsum("bhqs,bhs,bhsp->bhqp", M, dtf, x)
    decay_end = torch.exp(cum[..., -1:] - cum)              # (BC, H, Q)
    S = torch.einsum("bhq,bqn,bhqp->bhnp", decay_end * dtf, B, x)
    return y, S
