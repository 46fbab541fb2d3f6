"""Dry-run: trace every (arch × cell × production mesh) on the meta device
and bound it on an H100, or preview a job file's placement.

The JAX package's ``launch/dryrun.py`` compiles each cell for 512 forced
host devices and reads the partitioned HLO.  Here each cell's step runs
eagerly on meta tensors (shapes, no memory, no kernel) for ONE data row of
the production grid (``launch/specs.py``) under the operation counter
(``analysis/opcount.py``): every aten op, every hand-written kernel's
``cost()`` and every cross-position hand-off are counted a position.  Per
cell it prints the per-position memory fit against the H100's 80 GiB and
the three-term roofline (``analysis/roofline.py``), and appends a JSON
record to ``--out``.  Every figure is a bound from data-sheet peaks, not a
measurement.

The record keeps the reference's keys, renamed where the source differs:
``hlo_flops_per_dev`` → ``op_flops_per_dev``, ``hlo_traffic_per_dev`` →
``op_traffic_per_dev``, ``compile_s`` → ``trace_s``; ``xla_flops_per_dev``
has no counterpart.  Per-device figures are the maximum over the traced
row's positions: the row's lead runs the work the port does not split.
``bytes_per_device`` is a position's parameter, optimizer and cache bytes
(``arg_bytes``, by the production placement) plus the peak of the bytes
the step makes live there (``temp_bytes``).  ``gathered_bytes_per_device``
is the gathered high-water mark: the most bytes of gathered parameter
regions a position held alive at once (a part of ``temp_bytes``; on a
training or prefill row, about one block's shards, two at a block
boundary), and ``gathered_by_position`` each position's.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --cell train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--out out.jsonl]
    python -m repro_torch.launch.dryrun --jobfile jobs.txt --workers 4 \\
        --strategy cost --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from ..analysis.opcount import OpCounter
from ..analysis.roofline import H100, roofline_from_counts
from ..configs import ARCHS, cells_for, get_config
from ..models.config import SHAPE_CELLS
from .mesh import make_production_mesh
from .specs import build_cell, rules_for_cell

__all__ = ["SAMPLE_MICRO", "main", "plan_jobfile", "run_cell",
           "trace_cell"]

#: a training row's micro-batches that run in a trace; the last of them
#: counts for the rest (they are alike: ``opcount.micro_batches``)
SAMPLE_MICRO = 2


def trace_cell(arch: str, cell_name: str, *, multi_pod: bool = False,
               cfg=None, mesh=None):
    """Build and trace one cell: ``(spec, counter, seconds)``.  ``cfg``
    replaces the arch's config and ``mesh`` the production grid (a smoke
    config on a small meta grid in tests)."""
    cfg = cfg or get_config(arch)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rules = rules_for_cell(mesh, SHAPE_CELLS[cell_name], cfg)
    t0 = time.perf_counter()
    spec = build_cell(arch, cfg, cell_name, rules)
    with OpCounter(spec.row.size, sample_micro=SAMPLE_MICRO) as counter:
        spec.fn(*spec.args)
    return spec, counter, time.perf_counter() - t0


def run_cell(arch: str, cell_name: str, *, multi_pod: bool = False,
             verbose: bool = True, cfg=None, mesh=None) -> dict:
    spec, counter, t_trace = trace_cell(arch, cell_name,
                                        multi_pod=multi_pod, cfg=cfg,
                                        mesh=mesh)
    an = counter.analysis()
    n_chips = spec.mesh.size
    terms = roofline_from_counts(an, hw=H100, n_chips=n_chips,
                                 model_flops=spec.model_flops)
    per_pos = [s + p.peak_bytes
               for s, p in zip(spec.static_bytes, an.positions)]
    per_dev = max(per_pos)
    worst = per_pos.index(per_dev)
    arg_b, tmp_b = spec.static_bytes[worst], an.positions[worst].peak_bytes
    fits = per_dev <= H100.hbm_bytes
    rec = {
        "arch": arch, "cell": cell_name,
        "mesh": "x".join(map(str, spec.mesh.dims)),
        "n_chips": n_chips, "grad_accum": spec.grad_accum,
        "row_batch": spec.row_batch, "row_accum": spec.row_accum,
        "trace_s": round(t_trace, 1), "sample_micro": SAMPLE_MICRO,
        "bytes_per_device": per_dev, "fits_hbm": bool(fits),
        "arg_bytes": arg_b, "temp_bytes": tmp_b, "alias_bytes": 0,
        "bytes_by_position": per_pos,
        "gathered_bytes_per_device": max(an.gathered, default=0),
        "gathered_by_position": an.gathered[:spec.row.size],
        "op_flops_per_dev": terms.flops,
        "op_traffic_per_dev": terms.traffic_bytes,
        "collective_bytes_per_dev": terms.collective_bytes,
        "collective_counts": an.collectives.counts,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "model_flops": spec.model_flops,
        "useful_ratio": terms.useful_flops_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "while_trips": {},
        "notes": list(spec.notes),
    }
    if verbose:
        print(f"== {arch} × {cell_name} × {rec['mesh']} "
              f"(trace {t_trace:.0f}s, accum={spec.grad_accum}, "
              f"row batch {spec.row_batch} in {spec.row_accum})")
        print(f"   memory: args={arg_b / 2**30:.2f}GiB "
              f"temp={tmp_b / 2**30:.2f}GiB "
              f"per-dev={per_dev / 2**30:.2f}GiB (position {worst}) "
              f"fits80G={fits} gathered="
              f"{rec['gathered_bytes_per_device'] / 2**30:.2f}GiB")
        print(f"   roofline: compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"dominant={terms.dominant} "
              f"useful={rec['useful_ratio'] * 100:.1f}% "
              f"roofline_frac={rec['roofline_fraction'] * 100:.1f}%")
        print("   collectives: " + " ".join(
            f"{k}:{v}" for k, v in rec["collective_counts"].items() if v))
        for note in spec.notes:
            print(f"   note: {note}")
    return rec


def plan_jobfile(path: str, *, n_workers: int = 4, cores: int = 1,
                 strategy: str = "cost", devices=None,
                 verbose: bool = True) -> list:
    """Placement dry-run for a paper-format job file (§3.3 grammar).

    Parses the text, then runs the ``MasterScheduler`` segment by segment
    *without executing anything* — a static preview of worker assignment,
    co-scheduling, spawning, and (with ``strategy="cost"``) the cost-model
    estimates.  No results exist yet, so locality terms are zero; what the
    preview shows is the queue/co-schedule structure.  ``devices``: the
    cluster's devices, every CUDA device by default (``VirtualCluster``
    raises without one)."""
    from ..core import (MasterScheduler, ResultStore, VirtualCluster,
                        parse_job_file)

    graph = parse_job_file(path)
    cluster = VirtualCluster(devices, n_schedulers=1, cores_per_worker=cores,
                             max_workers=n_workers)
    master = MasterScheduler(graph, cluster, strategy=strategy)
    store = ResultStore(cluster)
    plans = []
    for i, seg in enumerate(graph.segments):
        placements = master.plan_segment(seg.jobs, store)
        plans.append(placements)
        if verbose:
            print(f"S{i}:")
            for p in placements:
                co = (f" co={','.join(p.co_scheduled_with)}"
                      if p.co_scheduled_with else "")
                est = (f" est={p.est_cost_s * 1e6:.1f}us"
                       if strategy == "cost" else "")
                print(f"  {p.job.name} -> worker {p.worker.wid} "
                      f"(seq={p.n_sequences}){co}{est}")
    return plans


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--cell", choices=list(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--jobfile", default="",
                    help="placement dry-run of a paper-format job file "
                         "instead of the arch x cell sweep")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--strategy", choices=["greedy", "cost"], default="cost")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the job-file cluster's devices: every CUDA device "
                         "(default) or the CPU")
    args = ap.parse_args(argv)

    if args.jobfile:
        devices = [torch.device("cpu")] if args.device == "cpu" else None
        plan_jobfile(args.jobfile, n_workers=args.workers,
                     strategy=args.strategy, devices=devices)
        return

    if args.all:
        cells = [(a, c) for a in ARCHS for c in cells_for(a)]
    elif args.arch and args.cell:
        cells = [(args.arch, args.cell)]
    elif args.arch:
        cells = [(args.arch, c) for c in cells_for(args.arch)]
    else:
        ap.error("need --arch [--cell], --all or --jobfile")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    out_f = open(args.out, "a") if args.out else None
    try:
        for arch, cell in cells:
            for mp in meshes:
                try:
                    rec = run_cell(arch, cell, multi_pod=mp)
                except Exception as e:  # one cell's fault ends no sweep
                    failures.append((arch, cell, mp, repr(e)))
                    traceback.print_exc()
                    continue
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    finally:
        if out_f:
            out_f.close()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"\nall {len(cells) * len(meshes)} cells traced OK")


if __name__ == "__main__":
    main()
