"""Training launcher.

Two schedulers: the *fused* step (the tailored implementation,
:func:`repro_torch.train.make_train_step`) and the *HyPar* job-graph loop
(the paper's framework, :class:`repro_torch.train.HyParTrainer`), on
thread workers (``--engine hypar``) or on spawned worker processes with a
durable sqlite job store (``--engine proc``,
:class:`repro_torch.core.ProcessExecutor`): every job result persists under
its content identity, so a killed run restarted with ``--resume`` over the
same ``--store`` serves the jobs already done from the store.  The fused
engine checkpoints asynchronously and, on restart with the same
``--ckpt-dir``, resumes from the newest complete checkpoint; the data
stream is a pure function of (seed, step), so a resumed run sees the
batches an uninterrupted one would.

Runs on the card by default (``--device cuda`` raises without a CUDA
device; the ``proc`` engine's workers compute there too); ``--device cpu``
runs the plain PyTorch path::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 2 --batch 4 --seq 32 --grad-accum 2 --engine proc \\
        --store /tmp/run.sqlite

The fused engine trains on a ``(data, model)`` mesh of ``--data-axis``
(0: every device on ``data``) by ``--model-axis`` positions, one process
driving them all (``train/step.py``): the state is placed by the
reference's specs, each data row runs its slice of the batch, its blocks
split over its positions.  ``--device cpu`` puts every position on the CPU;
a CUDA mesh needs a card a position.  The mesh is built before the engine
branch, as the reference builds it, and ``--engine hypar``/``proc``
ignore it::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --batch 4 --seq 32 --data-axis 2 --model-axis 2
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import time

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs import ARCHS, get_config, get_smoke_config
from ..data import DataConfig, Prefetcher, SyntheticLMStream, to_device
from ..models.config import ModelConfig
from .mesh import compat_make_mesh
from ..optim import OptimizerSpec, cosine_schedule
from ..serve.engine import resolve_device
from ..train import HyParTrainer, TrainState, make_train_step
from ..tree import tree_leaves

__all__ = ["main", "scale_config"]


def scale_config(cfg: ModelConfig, *, layers: int, d_model: int,
                 seq: int) -> ModelConfig:
    """Scale an assigned arch down to a trainable size."""
    repl = {"n_layers": layers, "d_model": d_model, "max_seq": max(seq * 2, 256)}
    if cfg.family in ("ssm", "hybrid"):
        repl["ssm_chunk"] = min(cfg.ssm_chunk, 64)
    if cfg.n_heads > 1:
        repl["n_heads"] = max(4, min(cfg.n_heads, d_model // 64))
        repl["n_kv_heads"] = max(1, min(cfg.n_kv_heads, repl["n_heads"]))
        while repl["n_heads"] % repl["n_kv_heads"]:
            repl["n_kv_heads"] -= 1
        repl["head_dim"] = d_model // repl["n_heads"]
    if cfg.d_ff:
        repl["d_ff"] = d_model * 4
    if cfg.is_moe:
        repl["n_experts"] = min(cfg.n_experts, 8)
        repl["top_k"] = min(cfg.top_k, 2)
        repl["moe_d_ff"] = d_model * 2
    if cfg.family == "encdec":
        repl["n_encoder_layers"] = layers
    return dataclasses.replace(cfg, **repl)


def main(argv=None):
    """Returns the final loss (fused engine) or the run's seconds (hypar
    and proc engines), as the reference's launcher does."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="0 = use all devices on the data axis")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config unchanged")
    ap.add_argument("--engine", choices=["fused", "hypar", "proc"],
                    default="fused",
                    help="fused = the tailored step; hypar = the paper's "
                         "job-graph runtime (LocalExecutor); proc = the same "
                         "job graph on worker processes with a durable job "
                         "store (ProcessExecutor)")
    ap.add_argument("--dispatch", choices=["sync", "pipelined", "dataflow"],
                    default="sync", help="LocalExecutor dispatch mode "
                                         "(hypar/proc engines)")
    ap.add_argument("--placement", choices=["greedy", "cost"],
                    default="greedy",
                    help="master-scheduler placement strategy (hypar engine)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where training runs (cuda raises without a CUDA "
                         "device)")
    ap.add_argument("--store", default="",
                    help="proc engine: sqlite job-store path — results "
                         "persist under content identity, so a killed run "
                         "restarted with --resume skips every job already "
                         "done (default: a fresh temporary store)")
    ap.add_argument("--resume", action="store_true",
                    help="proc engine: reuse an existing --store instead of "
                         "starting it fresh (memoised jobs are served from "
                         "the store, not re-executed)")
    ap.add_argument("--proc-workers", type=int, default=2,
                    help="proc engine: number of worker processes")
    ap.add_argument("--store-gc", type=float, default=None, metavar="SECS",
                    help="after the run, prune done job-store rows older "
                         "than this many seconds (and their spill files)")
    ap.add_argument("--store-gc-rows", type=int, default=None, metavar="N",
                    help="after the run, keep at most N most-recent done "
                         "job-store rows")
    args = ap.parse_args(argv)
    if (args.store or args.resume) and args.engine != "proc":
        ap.error("--store/--resume require --engine proc")
    if args.resume and not args.store:
        ap.error("--resume needs --store (a temporary store has no "
                 "previous run to resume from)")
    if (args.store_gc is not None or args.store_gc_rows is not None) \
            and not args.store:
        ap.error("--store-gc/--store-gc-rows need --store (a temporary "
                 "store is deleted whole when the run ends)")
    device = resolve_device(args.device)

    base = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = base if args.smoke else scale_config(
        base, layers=args.layers, d_model=args.d_model, seq=args.seq)
    spec = OptimizerSpec(kind=cfg.optimizer, lr=args.lr)
    dc = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    stream = SyntheticLMStream(cfg, dc)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    data_ax = args.data_axis or max(1, n_dev // args.model_axis)
    mesh = compat_make_mesh((data_ax, args.model_axis), ("data", "model"),
                            device=device)
    if args.engine in ("hypar", "proc"):
        return _run_hypar(cfg, spec, stream, args, device)

    step_fn = make_train_step(
        cfg, spec, grad_accum=args.grad_accum,
        schedule=lambda s: cosine_schedule(s, base_lr=args.lr, warmup=50,
                                           total=args.steps), mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(cfg, spec, gen, mesh.lead, mesh=mesh)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        like = {"params": state.params, "opt_state": state.opt_state,
                "step": torch.zeros((), dtype=torch.int32)}
        tree, start = restore_checkpoint(args.ckpt_dir, like, mesh=mesh)
        state = TrainState.from_tree(tree)
        print(f"resumed from checkpoint step {start}")

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    n_params = sum(math.prod(x.shape) for x in tree_leaves(state.params))
    print(f"device={device} arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"devices={n_dev} mesh=({data_ax},{args.model_axis}) "
          f"steps={args.steps}")
    it = Prefetcher((stream.batch(s) for s in range(start, args.steps)),
                    depth=2)
    t0 = time.time()
    tokens_done = 0
    metrics = None
    for s, host_batch in zip(range(start, args.steps), it):
        state, metrics = step_fn(state, to_device(host_batch, mesh.lead))
        tokens_done += args.batch * args.seq
        if (s + 1) % args.log_every == 0 or s + 1 == args.steps:
            dt = time.time() - t0
            print(f"step {s + 1:5d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"tok/s {tokens_done / dt:9.0f}")
        if ckpt and (s + 1) % args.ckpt_every == 0:
            ckpt.save(state.tree(), s + 1)
    if ckpt:
        ckpt.save(state.tree(), args.steps)
        ckpt.wait()
    if metrics is None:
        print(f"nothing to do: the checkpoint is at step {start}")
        return float("nan")
    final_loss = float(metrics["loss"])
    print(f"done: final loss {final_loss:.4f} "
          f"({tokens_done / (time.time() - t0):.0f} tok/s)")
    return final_loss


def _run_hypar(cfg, spec, stream, args, device) -> float:
    """Drive training through the paper's job-graph runtime: the dispatch
    mode and placement strategy are plain LocalExecutor knobs.
    ``--engine proc`` swaps the thread workers for the durable
    ProcessExecutor: the trainer's functions run in spawn children via
    :mod:`repro_torch.train.procfns` on ``device`` and every job result
    lands in the sqlite store, so a killed run restarted with ``--resume``
    replays the done prefix as store hits."""
    from ..core import ProcessExecutor, VirtualCluster

    n_micro = max(1, args.grad_accum)
    mb = max(1, args.batch // n_micro)
    batches = []
    for s in range(args.steps):
        b = to_device(stream.batch(s), device)
        batches.append([{k: v[m * mb:(m + 1) * mb] for k, v in b.items()}
                        for m in range(n_micro)])
    factory, made = None, []
    cluster = VirtualCluster([device], n_schedulers=1)
    if args.engine == "proc":
        from ..kernels import build
        from ..train import procfns

        store = args.store or None
        if store and not args.resume:
            for stale in (store, store + "-wal", store + "-shm"):
                if os.path.exists(stale):
                    os.remove(stale)
            shutil.rmtree(store + ".d", ignore_errors=True)   # spill files
        if device.type == "cuda":
            build.build_all()        # children load the libraries, never build
        procfns.export_env(cfg, spec, batch_keys=batches[0][0],
                           device=device)
        cluster = VirtualCluster([device], n_schedulers=1,
                                 max_workers=args.proc_workers)

        def factory(cluster, registry):
            ex = ProcessExecutor(
                cluster, registry, procfns.WORKER_FNS_SPEC, store=store,
                mode=("pipelined" if args.dispatch == "sync"
                      else args.dispatch),
                strategy=args.placement)
            made.append(ex)
            return ex

    trainer = HyParTrainer(cfg, spec, n_micro=n_micro, cluster=cluster,
                           mode=args.dispatch, strategy=args.placement,
                           executor_factory=factory)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    params, _, report = trainer.run(batches, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{args.engine} engine: {args.steps} steps x {n_micro} micro in "
          f"{dt:.1f}s ({args.steps * args.batch * args.seq / dt:.0f} tok/s) "
          f"params={n_params / 1e6:.1f}M | {report.summary()}")
    if made:
        ex = made[0]
        print(f"job store: {ex.n_executed} executed, "
              f"{ex.n_memoised} memoised"
              + (f" (durable at {args.store})" if args.store else ""))
    if args.store and (args.store_gc is not None
                       or args.store_gc_rows is not None):
        from ..core.store import JobStore
        gc_store = JobStore(args.store)
        try:
            pruned = gc_store.gc(max_age_s=args.store_gc,
                                 max_rows=args.store_gc_rows)
            print(f"store gc: pruned {pruned['rows']} done row(s), "
                  f"{pruned['spill_files']} spill file(s)")
        finally:
            gc_store.close()
    return dt


if __name__ == "__main__":
    main()
