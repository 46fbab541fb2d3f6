"""Serving driver of the port: a request trace through ``ServeScheduler``
over the paged engine, on the card.

Request-level continuous batching from an open-loop trace: Poisson
arrivals, mixed prompt lengths, admission by free pages of the shared KV
pool, chunked prefill interleaved with decode.  The engine runs on
``--device cuda`` (the default; it raises where no CUDA device exists) or,
asked for explicitly, on the CPU.  Weights are random, drawn from
``--seed`` with a ``torch.Generator``.

``--engine hypar`` routes every admission wave through the core job
machinery (:class:`~repro_torch.serve.HyParRequestTracker`: dynamic
control-spawned jobs, ``MasterScheduler`` placement by ``--strategy``,
``ResultStore`` retention); ``--store`` backs it with a durable sqlite job
store, so suspended requests survive a master restart (``--resume``
re-seeds them, under ``--reserve demand``), and ``--store-gc`` /
``--store-gc-rows`` prune the store after the run.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 8 --prefill-chunk 256 \\
        --prompt-lens 64 512 1500 --max-new 32 --n-requests 16 \\
        --engine hypar --strategy cost

The reference's ``--trace --paged`` mode is the launcher's only mode and
takes no flag; wave mode, the dense engine and ``--mesh`` are later work.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..serve import (HyParRequestTracker, PagedEngine, Request, RequestQueue,
                     SamplingParams, ServeScheduler)
from ..serve.engine import resolve_device
from ..tree import tree_leaves
from ..weights import init_params

__all__ = ["build_trace", "warmup_requests", "make_scheduler",
           "prepare_trace", "replay_trace", "run_trace", "trace_stats",
           "main"]


def build_trace(rng: np.random.Generator, cfg, *, n_requests: int,
                rate_per_s: float, prompt_lens: list[int],
                max_new, budget_new: int | None = None,
                shared_prefix_len: int = 0,
                ttft_deadline_s: float | None = None,
                total_deadline_s: float | None = None) -> list[Request]:
    """Open-loop request trace: Poisson arrivals (exponential gaps at
    ``rate_per_s``), prompt lengths drawn uniformly from ``prompt_lens``.

    ``max_new`` may be a single realised length or a mix to draw from per
    request; ``budget_new`` is the declared generation cap clients submit
    alongside.  ``shared_prefix_len`` > 0 makes every prompt open with the
    SAME token prefix (a system prompt).  ``ttft_deadline_s`` /
    ``total_deadline_s`` stamp the same SLO onto every request.  The draws
    match the reference's, so one seed gives both packages one trace."""
    t = 0.0
    mix = [int(m) for m in np.atleast_1d(max_new)]
    prefix = None
    if shared_prefix_len > 0:
        if min(prompt_lens) <= shared_prefix_len:
            raise ValueError(f"every prompt length {tuple(prompt_lens)} must "
                             f"exceed shared_prefix_len {shared_prefix_len} "
                             f"(each prompt = prefix + random remainder)")
        prefix = rng.integers(0, cfg.vocab_size - 1,
                              (shared_prefix_len,)).astype(np.int32)
    reqs = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / rate_per_s) if rate_per_s > 0 else 0.0
        S = int(rng.choice(prompt_lens))
        toks = rng.integers(0, cfg.vocab_size - 1, (S,)).astype(np.int32)
        if prefix is not None:
            toks = np.concatenate([prefix, toks[shared_prefix_len:]])
        reqs.append(Request(rid=rid, tokens=toks,
                            max_new=int(rng.choice(mix)),
                            budget_new=budget_new, arrival_s=t,
                            ttft_deadline_s=ttft_deadline_s,
                            total_deadline_s=total_deadline_s))
    return reqs


def warmup_requests(rng: np.random.Generator, cfg, *, prompt_lens,
                    ) -> list[Request]:
    """One request per distinct prompt length, all arriving at t=0."""
    reqs = []
    for rid, S in enumerate(sorted(set(int(l) for l in prompt_lens))):
        toks = rng.integers(0, cfg.vocab_size - 1, (S,)).astype(np.int32)
        reqs.append(Request(rid=rid, tokens=toks, max_new=2, arrival_s=0.0))
    return reqs


def make_scheduler(cfg, params, args, *, sp: SamplingParams,
                   max_len: int) -> ServeScheduler:
    eng = PagedEngine(cfg, params, batch=args.batch, max_len=max_len,
                      page_size=args.page_size, num_pages=args.num_pages,
                      prefill_chunk=args.prefill_chunk,
                      attn_impl=args.paged_attn_impl, device=args.device)
    generator = torch.Generator(device=eng.device).manual_seed(args.seed)
    tracker = None
    if args.engine == "hypar":
        jobstore = None
        if args.store:
            from ..core.store import JobStore
            jobstore = JobStore(args.store)
        n_params = sum(x.numel() for x in tree_leaves(params))
        tracker = HyParRequestTracker(args.batch, strategy=args.strategy,
                                      flops_per_token=2.0 * n_params,
                                      devices=[eng.device],
                                      jobstore=jobstore)
    return ServeScheduler(eng, sp=sp, generator=generator, tracker=tracker,
                          queue=RequestQueue(max_pending=args.max_pending),
                          reserve=args.reserve,
                          preempt_policy=args.preempt_policy,
                          admit_watermark=args.admit_watermark,
                          prefix_cache=args.prefix_cache,
                          prefix_admit=args.prefix_admit,
                          enforce_deadlines=args.enforce_deadlines)


def prepare_trace(cfg, params, args, *, sp: SamplingParams):
    """Build a warmed scheduler + the request trace for it.  The warmup
    (one request per prompt length, then a second pass) runs on the SAME
    scheduler: the first pass pays one-time costs — the kernel build, the
    CUDA libraries' initialisation — and the second brings the step and
    retire EWMAs that deadline shedding reads near steady state."""
    max_len = max(args.prompt_lens) + args.max_new + 8
    rng = np.random.default_rng(args.seed)
    sched = make_scheduler(cfg, params, args, sp=sp, max_len=max_len)
    # the trace is drawn BEFORE the warmup touches the rng, so compared
    # variants replay the IDENTICAL trace
    mix = args.max_new_mix
    reqs = build_trace(rng, cfg, n_requests=args.n_requests,
                       rate_per_s=args.rate, prompt_lens=list(args.prompt_lens),
                       max_new=(mix if mix else args.max_new),
                       budget_new=(args.max_new if mix else None),
                       shared_prefix_len=args.shared_prefix_len,
                       ttft_deadline_s=args.ttft_deadline,
                       total_deadline_s=args.total_deadline)
    warm_lens = list(args.prompt_lens)
    if sched.demand:
        # resume re-prefills land in arbitrary chunk buckets
        warm_lens += [b for b in sched.engine.chunk_buckets
                      if b + 2 <= sched.engine.max_len]
    sched.run(warmup_requests(rng, cfg, prompt_lens=warm_lens))
    sched.reset_metrics()
    sched.run(warmup_requests(rng, cfg, prompt_lens=list(args.prompt_lens)))
    sched.reset_metrics()
    if sched.prefix_cache_active:
        # measured replays start from a cold cache
        sched.flush_prefix_cache()
    return sched, reqs


def replay_trace(sched, reqs) -> dict:
    """One measured replay of ``reqs`` on a warmed scheduler.  Returns a
    snapshot of its results and counters and resets the scheduler's metrics
    for the next replay.  The wall clock stops after the last token came
    back to the host (each step's sampling reads the tokens back)."""
    replay = [dataclasses.replace(r) for r in reqs]
    eng = sched.engine
    steps0 = eng.n_decode_calls
    t0 = time.perf_counter()
    results = sched.run(replay)
    wall = time.perf_counter() - t0
    rate = sum(r.n_generated for r in results) / wall if wall > 0 else 0.0
    outcome_hist: dict[str, int] = {}
    for o in sched.outcomes.values():
        outcome_hist[o.outcome] = outcome_hist.get(o.outcome, 0) + 1
    snap = {
        "tok_per_s": rate, "results": results, "wall_s": wall,
        "occupancy": sched.occupancy, "n_rejected": sched.queue.n_rejected,
        "decode_steps": eng.n_decode_calls - steps0,
        "preempt_count": sched.n_preempted,
        "resume_tokens_recomputed": sched.resume_tokens_recomputed,
        "admit_deferred": sched.n_admit_deferred,
        "prefix_lookups": sched.n_prefix_lookups,
        "prefix_hits": sched.n_prefix_hits,
        "pages_shared": sched.pages_shared,
        "cow_copies": sched.n_cow_copies,
        "cache_insert_deferred": sched.n_cache_insert_deferred,
        "shed_queue_full": sched.queue.shed_queue_full,
        "shed_never_fits": sched.queue.shed_never_fits,
        "shed_deadline": sched.queue.shed_deadline,
        "outcomes": outcome_hist,
        "goodput_tokens": sched.goodput_tokens,
        "n_expired": sched.n_expired,
        "suspended_rids": sorted(sched._suspended),
    }
    sched.reset_metrics()
    return snap


def run_trace(cfg, params, args, *, sp: SamplingParams,
              repeats: int = 1) -> dict:
    """Warm up, replay the trace ``repeats`` times on the warmed scheduler
    and report the fastest replay."""
    sched, reqs = prepare_trace(cfg, params, args, sp=sp)
    if args.resume:
        # master restart: re-seed suspended-request records from the durable
        # store — resubmitted rids resume by recompute
        n = sched.restore_suspended()
        print(f"restored {n} suspended request(s) from {args.store}")
    snaps = [replay_trace(sched, reqs) for _ in range(max(1, repeats))]
    return trace_stats(args, sched, max(snaps, key=lambda s: s["tok_per_s"]))


def trace_stats(args, sched, snap) -> dict:
    """The stats dict of one replay snapshot.  Latencies are NaN when
    nothing completed, never a perfect-looking 0."""
    results = snap["results"]
    wall = snap["wall_s"]
    n_tok = sum(r.n_generated for r in results)
    ttfts = (np.array([r.ttft_s for r in results]) if results
             else np.array([np.nan]))
    lats = (np.array([l for r in results for l in r.step_latencies_s])
            if any(r.step_latencies_s for r in results)
            else np.array([np.nan]))
    eng = sched.engine
    stats = {k: v for k, v in snap.items() if k not in ("results",)}
    stats.update({
        "engine": args.engine,
        "device": (torch.cuda.get_device_name(eng.device)
                   if eng.device.type == "cuda" else "cpu"),
        "paged": True,
        "n_requests": len(results),
        "gen_tokens": n_tok,
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p95_s": float(np.percentile(ttfts, 95)),
        "lat_p50_s": float(np.percentile(lats, 50)),
        "lat_p95_s": float(np.percentile(lats, 95)),
        "reserve": sched.reserve,
        "prefix_cache": sched.prefix_cache_active,
        "prefix_hit_rate": (snap["prefix_hits"] / snap["prefix_lookups"]
                            if snap["prefix_lookups"] else 0.0),
        "goodput_tok_per_s": (snap["goodput_tokens"] / wall
                              if wall > 0 else 0.0),
        "enforce_deadlines": sched.enforce_deadlines,
        "total_pool_bytes": eng.total_pool_bytes(),
        "kv_budget_tokens": eng.num_pages * eng.page_size,
    })
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engine runs (cuda raises without a "
                         "CUDA device)")
    ap.add_argument("--engine", choices=["direct", "hypar"], default="direct",
                    help="direct slot filling vs HyPar dynamic-job "
                         "scheduling")
    ap.add_argument("--strategy", choices=["greedy", "cost"], default="greedy",
                    help="hypar engine: MasterScheduler placement strategy")
    ap.add_argument("--store", default="",
                    help="hypar engine: durable job-store path — suspended "
                         "requests' host-retained tokens persist, so "
                         "recovery survives a master restart")
    ap.add_argument("--resume", action="store_true",
                    help="hypar engine: re-seed suspended requests from "
                         "--store before replaying (requires --reserve "
                         "demand)")
    ap.add_argument("--store-gc", type=float, default=None, metavar="SECS",
                    help="after the run, prune done job-store rows older "
                         "than this many seconds (and their spill files)")
    ap.add_argument("--store-gc-rows", type=int, default=None, metavar="N",
                    help="after the run, keep at most N most-recent done "
                         "job-store rows")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, requests/s (0 = all at once)")
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=[8, 16, 24],
                    help="mixed prompt lengths")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission control: shed beyond this queue depth")
    ap.add_argument("--max-new-mix", type=int, nargs="+", default=None,
                    help="realised generation lengths drawn per request; "
                         "--max-new then acts as the declared cap")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size incl. the trash page (default: batch x "
                         "max_len tokens)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--paged-attn-impl", default="auto",
                    choices=["auto", "kernel", "ref"],
                    help="decode attention: auto runs the CUDA paged "
                         "flash-decode kernel on the card and the gather "
                         "path on the CPU")
    ap.add_argument("--reserve", choices=["lifetime", "demand"],
                    default="lifetime")
    ap.add_argument("--preempt-policy", choices=["fewest", "lifo"],
                    default="fewest")
    ap.add_argument("--admit-watermark", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-admit", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--stats-json", default="",
                    help="dump the stats dict to this path as JSON")
    ap.add_argument("--shared-prefix-len", type=int, default=0)
    ap.add_argument("--ttft-deadline", type=float, default=None,
                    metavar="SECS")
    ap.add_argument("--total-deadline", type=float, default=None,
                    metavar="SECS")
    ap.add_argument("--no-enforce-deadlines", dest="enforce_deadlines",
                    action="store_false")
    args = ap.parse_args(argv)
    if (args.store or args.resume) and args.engine != "hypar":
        ap.error("--store/--resume require --engine hypar (the tracker "
                 "owns the durable store)")
    if args.resume and not (args.store and args.reserve == "demand"):
        ap.error("--resume needs --store and --reserve demand (resume "
                 "recompute is the demand-mode recovery path)")
    if (args.store_gc is not None or args.store_gc_rows is not None) \
            and not args.store:
        ap.error("--store-gc/--store-gc-rows need --store (nothing to "
                 "prune otherwise)")
    if args.admit_watermark and args.reserve != "demand":
        ap.error("--admit-watermark requires --reserve demand")
    if args.prefix_admit < 1:
        ap.error("--prefix-admit must be >= 1")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    sp = SamplingParams(temperature=args.temperature)
    stats = run_trace(cfg, params, args, sp=sp, repeats=args.repeats)
    print(f"engine={stats['engine']} device={stats['device']} arch={cfg.name} "
          f"requests={stats['n_requests']} (+{stats['n_rejected']} shed) "
          f"tokens={stats['gen_tokens']} decode_steps={stats['decode_steps']}")
    print(f"reserve={stats['reserve']} preempts={stats['preempt_count']} "
          f"resume_tokens_recomputed={stats['resume_tokens_recomputed']} "
          f"admit_deferred={stats['admit_deferred']}")
    if stats["prefix_cache"]:
        print(f"prefix_cache: hit_rate={stats['prefix_hit_rate']*100:.0f}% "
              f"pages_shared={stats['pages_shared']} "
              f"cow_copies={stats['cow_copies']}")
    print(f"tok/s={stats['tok_per_s']:.1f} "
          f"ttft p50={stats['ttft_p50_s']*1e3:.1f}ms "
          f"p95={stats['ttft_p95_s']*1e3:.1f}ms "
          f"lat p50={stats['lat_p50_s']*1e3:.1f}ms "
          f"p95={stats['lat_p95_s']*1e3:.1f}ms "
          f"occupancy={stats['occupancy']*100:.0f}%")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1, default=float)
    _maybe_store_gc(args, live_rids=stats["suspended_rids"])
    return stats


def _maybe_store_gc(args, live_rids=()) -> None:
    """Post-run job-store hygiene (``--store-gc`` / ``--store-gc-rows``).

    ``live_rids`` — rids still suspended on THIS run's scheduler; their
    durable recovery rows are exempt from the age prune (they are live
    recovery state, not orphans of a dead master)."""
    if args.store_gc is None and args.store_gc_rows is None:
        return
    from ..core.store import JobStore
    store = JobStore(args.store)
    try:
        exempt = [f"{HyParRequestTracker.STORE_PREFIX}{rid}"
                  for rid in live_rids]
        pruned = store.gc(max_age_s=args.store_gc,
                          max_rows=args.store_gc_rows,
                          exempt_requests=exempt)
        print(f"store gc: pruned {pruned['rows']} done row(s), "
              f"{pruned['spill_files']} spill file(s), "
              f"{pruned['request_rows']} stale request row(s) from "
              f"{args.store}")
    finally:
        store.close()


if __name__ == "__main__":
    main()
