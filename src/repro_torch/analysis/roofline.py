"""Three-term roofline of a traced step, on an H100 profile.

    compute_s    = flops / peak_flops
    memory_s     = traffic_bytes / hbm_bw
    collective_s = collective_bytes / link_bw

The counts are one grid position's (:mod:`.opcount`, the maximum over the
traced row's positions), so every term divides by ONE card's rates, as
the reference divides its per-device partitioned HLO by one chip's.

:data:`H100` holds the H100 SXM5 data sheet's figures (NVIDIA, dense
rates, at the full 700 W power limit): 989e12 bf16 FLOP/s on the tensor
cores, 3.35e12 B/s of HBM3, 80 GiB of device memory, and for the
collective term NVLink 4 at 450e9 B/s each way (900 GB/s all to all over
the host's cards, half of it in one direction).  No figure of the
reference's TPU profile is carried over.  Every term is a bound from
data-sheet peaks, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .opcount import OpAnalysis

__all__ = ["HW", "H100", "RooflineTerms", "roofline_from_counts"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per card, bf16
    hbm_bw: float              # B/s per card
    ici_bw: float              # B/s per link direction
    hbm_bytes: float           # capacity per card


#: H100 SXM5 data sheet: 989 TFLOP/s bf16 dense, HBM3 3.35 TB/s, 80 GiB,
#: NVLink 4 450 GB/s each way
H100 = HW(name="h100-sxm5", peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, hbm_bytes=80 * 2**30)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    traffic_bytes: float
    collective_bytes: float
    model_flops: float = 0.0
    n_chips: int = 1
    hw: HW = H100
    analysis: Any = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap lower bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_per_chip(self) -> float:
        return self.model_flops / max(self.n_chips, 1)

    @property
    def useful_flops_ratio(self) -> float:
        """The model's useful flops a card over the flops it runs."""
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful flops a card over the peak, at the bound step time: the
        MFU if the dominant term were the only limit."""
        if self.step_s <= 0:
            return 0.0
        return (self.model_flops_per_chip / self.step_s) / self.hw.peak_flops

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "traffic_bytes": self.traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
        }


def roofline_from_counts(analysis: OpAnalysis, *, hw: HW = H100,
                         n_chips: int, model_flops: float = 0.0
                         ) -> RooflineTerms:
    """The terms of one position's counts.  ``model_flops`` is the GLOBAL
    useful-flops figure (6·N·D and the like), divided by ``n_chips`` for
    the per-card ratios."""
    coll = analysis.collectives.total_bytes
    return RooflineTerms(
        compute_s=analysis.flops / hw.peak_flops,
        memory_s=analysis.traffic_bytes / hw.hbm_bw,
        collective_s=coll / hw.ici_bw,
        flops=analysis.flops, traffic_bytes=analysis.traffic_bytes,
        collective_bytes=coll, model_flops=model_flops, n_chips=n_chips,
        hw=hw, analysis=analysis)
