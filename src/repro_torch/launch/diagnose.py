"""Perf diagnosis for one (arch × cell × mesh): where do the flops, the
memory traffic and the collective bytes of the traced step come from?

The JAX package's ``launch/diagnose.py`` reads the partitioned HLO; here
the operation counter's tables are the profile (``analysis/opcount.py``):
the top ops by flops and by traffic (aten ops by name, each hand-written
kernel as ``kernel:<name>``) and the top collective sites (kind and the
mesh code's site), over the traced row.  Every figure is a count, not a
time.

Usage::

    python -m repro_torch.launch.diagnose --arch qwen2-1.5b --cell train_4k \\
        [--multi-pod] [--top 20]
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS
from ..models.config import SHAPE_CELLS
from .dryrun import trace_cell

__all__ = ["diagnose", "main"]


def diagnose(analysis, top: int = 20) -> dict:
    """Print the top collective sites, ops by flops and ops by traffic of
    an :class:`~repro_torch.analysis.opcount.OpAnalysis`; return them."""
    sites = sorted(analysis.by_site.items(), key=lambda kv: -kv[1]["bytes"])
    print(f"top {top} collective sites (bytes over the row's positions):")
    for (kind, site), d in sites[:top]:
        print(f"  {kind:19s} {site:18s} x{d['calls']:7.0f} = "
              f"{d['bytes'] / 2**30:10.3f}GiB")
    by_flops = sorted(analysis.by_op.items(), key=lambda kv: -kv[1]["flops"])
    print(f"\ntop {top} ops by flops:")
    for name, d in by_flops[:top]:
        if d["flops"]:
            print(f"  {name:34s} x{d['calls']:8.0f} flops={d['flops']:.3e} "
                  f"traffic={d['traffic']:.3e}")
    by_traffic = sorted(analysis.by_op.items(),
                        key=lambda kv: -kv[1]["traffic"])
    print(f"\ntop {top} ops by traffic:")
    for name, d in by_traffic[:top]:
        if d["traffic"]:
            print(f"  {name:34s} x{d['calls']:8.0f} "
                  f"traffic={d['traffic']:.3e} flops={d['flops']:.3e}")
    print("\nsummary (per device, the row's busiest position):",
          analysis.summary())
    return {"sites": sites[:top], "by_flops": by_flops[:top],
            "by_traffic": by_traffic[:top]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--cell", choices=list(SHAPE_CELLS), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    _, counter, seconds = trace_cell(args.arch, args.cell,
                                     multi_pod=args.multi_pod)
    print(f"traced {args.arch} × {args.cell} in {seconds:.1f}s\n")
    diagnose(counter.analysis(), top=args.top)


if __name__ == "__main__":
    main()
