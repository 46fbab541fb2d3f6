"""Dry-run analysis: the operation counter (the counterpart of the JAX
package's HLO-text analyser) and the H100 roofline."""
from .opcount import OpAnalysis, OpCounter
from .roofline import H100, HW, RooflineTerms, roofline_from_counts

__all__ = ["OpAnalysis", "OpCounter", "H100", "HW", "RooflineTerms",
           "roofline_from_counts"]
