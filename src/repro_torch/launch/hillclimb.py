"""Hill-climb runner: re-trace a cell after a code or config change and
diff its roofline terms against a recorded baseline (the JAX package's
``launch/hillclimb.py``).

The baseline is the last record of the same (arch, cell, mesh) in
``--baseline`` (a ``launch/dryrun.py --out`` file), superseded by the last
one in ``--log``, where every run appends its own record with ``--note``.
The terms are bounds from data-sheet peaks, not measurements.

Usage::

    python -m repro_torch.launch.hillclimb --arch qwen2-1.5b --cell train_4k \\
        --baseline dryrun.jsonl --log perf_iterations.jsonl --note "what changed"
"""
from __future__ import annotations

import argparse
import json
import time

from .dryrun import run_cell

__all__ = ["DELTA_KEYS", "delta", "last_record", "main"]

DELTA_KEYS = ("compute_s", "memory_s", "collective_s", "bytes_per_device",
              "roofline_fraction")


def last_record(path: str, arch: str, cell: str, mesh: str) -> dict | None:
    """The last record of (arch, cell, mesh) in the JSONL file at ``path``,
    or None (no file, or no such record)."""
    found = None
    try:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if (r["arch"], r["cell"], r["mesh"]) == (arch, cell, mesh):
                    found = r
    except FileNotFoundError:
        pass
    return found


def delta(base: dict, rec: dict) -> dict:
    """Each of :data:`DELTA_KEYS` as ``(before, after, percent change)``
    (None where the baseline is 0)."""
    out = {}
    for k in DELTA_KEYS:
        b, n = base[k], rec[k]
        out[k] = (b, n, (n / b - 1) * 100 if b else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--baseline", default="dryrun.jsonl")
    ap.add_argument("--log", default="perf_iterations.jsonl")
    ap.add_argument("--note", default="")
    args = ap.parse_args(argv)

    mesh = "2x16x16" if args.multi_pod else "16x16"
    # later iterations logged for the same cell become the comparison point
    base = (last_record(args.log, args.arch, args.cell, mesh)
            or last_record(args.baseline, args.arch, args.cell, mesh))

    rec = run_cell(args.arch, args.cell, multi_pod=args.multi_pod)
    rec["note"] = args.note
    rec["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")

    if base is not None:
        print("\n=== delta vs previous ===")
        for k, (b, n, pct) in delta(base, rec).items():
            unit = "GiB" if k == "bytes_per_device" else ""
            scale = 2**30 if unit else 1
            change = f"{pct:+.1f}%" if pct is not None else "n/a"
            print(f"  {k:20s} {b / scale:12.4f} -> {n / scale:12.4f} "
                  f"{unit:4s} ({change})")
        rec["baseline_dominant"] = base["dominant"]
        for k in ("compute_s", "memory_s", "collective_s"):
            rec[f"delta_{k}_pct"] = ((rec[k] / base[k] - 1) * 100
                                     if base[k] else None)

    with open(args.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"\nlogged to {args.log}")


if __name__ == "__main__":
    main()
