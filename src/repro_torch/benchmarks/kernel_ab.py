"""One kernel of the port on the card, for one source tree, so that two
versions of it can be compared on one card.

    python3 src/repro_torch/benchmarks/kernel_ab.py KERNEL [--src DIR] [--label NAME]

``KERNEL`` is ``flash_fwd``, ``flash_bwd``, ``ssd``, ``paged_decode`` or
``train_step``.  ``--src`` (default: this
checkout's ``src``) goes first on the import path, so ``repro_torch`` and
the kernel it builds (into that tree's ``build/``) are that tree's.  Run
it once a tree in one command, in the order parent, change, change,
parent: two calls of the tool may land on two cards.  It prints the
card's ``nvidia-smi`` line and one JSON line.  Kernel times are CUDA
events over back-to-back calls rotating over input copies larger than the
50 MB L2 (``tuning.device_seconds``).

* ``flash_fwd``: the bf16 forward at each shape of ``FLASH_SHAPES`` (the
  training shape B 2, S 4,096, H 12, KV 2, D 128, and the dense engine's
  batched prefills of qwen2-moe-a2.7b, B 8, S 1,024, H = KV 16, D 128,
  and zamba2-1.2b, H = KV 32, D 64; all causal) and each launch shape
  ``(q_block, kv_block)`` of ``FLASH_BLOCKS``: ms and the largest gap to
  the plain version.
* ``flash_bwd``: the bf16 backward at each shape of ``FLASH_BWD_SHAPES``
  (the training shape at D 128, and gemma3-4b's at D 256: B 2, S 4,096,
  H 8, KV 4, causal, and under its window of 1,024), on the kernel
  forward's output and LSE and one seeded dO: ms, the largest of dq's,
  dk's and dv's max|Δ| / max|plain| against the plain backward, and the
  device ms of each of its three device kernels (Dᵢ, the dK/dV pass, the
  dQ pass) from a profiled window of ``FLASH_REPS`` calls.
* ``ssd``: ``kernel_ms``, the SSD wrapper at one mamba2-370m prefill chunk
  (BC 1, H 32, Q 256, P 64, N 128); then a profiled window of ``--chunks``
  full-width 256-token prefill chunks (``chunk_prefill_step``, bf16,
  random weights from seed 0) through the kernel path: wall and
  device-busy ms a chunk, the SSD device kernels' ms a chunk by kernel
  name, and the device kernels a wrapper call.
* ``paged_decode``: the paged kernel on its main path, a ``PagedEngine``
  without a mesh at full width (qwen2-1.5b, bf16, random weights from
  seed 0; batch 8, page 16, every slot holding a prompt of 1,000-1,500
  tokens): ``--steps`` decode steps after 8 of warm-up, each step's wall
  ms (synchronized), their median and the decode tok/s, and the paged
  kernel's launches a step.  Only the engine's public calls are used, so
  it runs on any tree with ``PagedEngine``.
* ``train_step``: the flash kernels on their training path, the meshless
  fused step at full width (qwen2-1.5b, fp32 params, bf16 compute, AdamW
  at 3e-4, ``remat="full"``, seq 4,096, batch 4 in 2 micro-batches, random
  weights from seed 0): ``--steps`` timed steps after one of warm-up, each
  step's wall s (synchronized), their median, tokens/s and the flash
  launches a step.  Only ``TrainState.create`` and ``make_train_step``
  are used, so it runs on any tree of the port that trains.  ``--grid
  DATA,MODEL`` steps it on a training mesh instead, every position on the
  card (``make_test_mesh``; any tree with ``make_train_step(mesh=)``),
  and adds the step's peak memory.

It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

_SRC = Path(__file__).resolve().parents[2]

#: B, S, H, KV, D of the flash forward's shapes, all causal
FLASH_SHAPES = {"train_d128": (2, 4096, 12, 2, 128),
                "serve_d128": (8, 1024, 16, 16, 128),
                "serve_d64": (8, 1024, 32, 32, 64)}
FLASH_BLOCKS = ((64, 64), (64, 128), (128, 64), (128, 128))
FLASH_REPS = 20
#: B, S, H, KV, D, window of the flash backward's shapes, all causal
FLASH_BWD_SHAPES = {"train_d128": (2, 4096, 12, 2, 128, None),
                    "train_gemma3": (2, 4096, 8, 4, 256, None),
                    "train_gemma3_local": (2, 4096, 8, 4, 256, 1024)}


def _dev_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return float(getattr(ev, attr))
    return 0.0


def flash_fwd(args) -> dict:
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.tuning import device_seconds

    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {}
    for name, (B, S, H, KV, D) in FLASH_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((B, S, H, D), (B, S, KV, D),
                                          (B, S, KV, D)))
        want, _ = flash_attention_plain(q, k, v, causal=True)
        n = max(2, math.ceil(100e6 / (q.numel() + 2 * k.numel()) / 2))
        copies = [tuple(t.clone() for t in (q, k, v)) for _ in range(n)]
        row = {}
        for qb, kb in FLASH_BLOCKS:
            out, _ = flash_attention_kernel(q, k, v, causal=True,
                                            q_block=qb, kv_block=kb)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            ms = device_seconds(lambda i: flash_attention_kernel(
                *copies[i % n], causal=True, q_block=qb, kv_block=kb),
                FLASH_REPS) / FLASH_REPS * 1e3
            row[f"{qb}x{kb}"] = {"ms": ms, "max_abs_err": err}
        result[name] = row
        del copies, want
        torch.cuda.empty_cache()
    return {"flash_fwd": result}


def flash_bwd(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_kernel)
    from repro_torch.kernels.tuning import device_seconds

    gen = torch.Generator(device="cuda").manual_seed(5)
    result = {}
    for name, (B, S, H, KV, D, window) in FLASH_BWD_SHAPES.items():
        q, dout = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(2))
        k, v = (torch.randn((B, S, KV, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out, lse = flash_attention_kernel(q, k, v, causal=True,
                                          window=window)
        inputs = (q, k, v, out, lse, dout)
        got = flash_attention_backward_kernel(*inputs, causal=True,
                                              window=window)
        want = flash_attention_backward_plain(*inputs, causal=True,
                                              window=window)
        err = max(float((g.float() - w.float()).abs().max()
                        / w.float().abs().max()) for g, w in zip(got, want))
        del got, want
        n = max(2, math.ceil(100e6 / sum(t.numel() * t.element_size()
                                          for t in inputs)))
        copies = [tuple(t.clone() for t in inputs) for _ in range(n)]

        def call(i):
            return flash_attention_backward_kernel(*copies[i % n],
                                                   causal=True,
                                                   window=window)
        ms = device_seconds(call, FLASH_REPS) / FLASH_REPS * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(FLASH_REPS):
                call(i)
            torch.cuda.synchronize()
        kernels = {e.key[:60]: _dev_us(e) / 1e3 / FLASH_REPS
                   for e in prof.key_averages()
                   if "flash_bwd" in e.key and _dev_us(e) > 0}
        result[name] = {"shape": [B, S, H, KV, D, window], "ms": ms,
                        "max_rel_err": err, "device_ms_by_kernel": kernels}
        del copies, inputs
        torch.cuda.empty_cache()
    return {"flash_bwd": result}


def ssd(args) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk
    from repro_torch.kernels.tuning import device_seconds
    from repro_torch.models.transformer import chunk_prefill_step
    from repro_torch.serve import PagedEngine
    from repro_torch.weights import init_params

    dev = "cuda"
    # the kernel alone, at one prefill chunk
    gen = torch.Generator(device=dev).manual_seed(2)
    BC, H, Q, P, N = 1, 32, 256, 64, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(BC, H, Q, P)
    dt = torch.nn.functional.softplus(randn(BC, H, Q, 1))
    a = -3.0 * torch.rand((BC, H, Q, 1), generator=gen, device=dev)
    inputs = (x, dt, a, randn(BC, Q, N), randn(BC, Q, N))
    n_copies = max(2, math.ceil(100e6 / sum(t.numel() * 4 for t in inputs)))
    copies = [tuple(t.clone() for t in inputs) for _ in range(n_copies)]
    reps = 200
    kernel_ms = device_seconds(
        lambda i: ssd_intra_chunk(*copies[i % n_copies], impl="kernel"),
        reps) / reps * 1e3
    del copies

    # prefill chunks at full width
    cfg = get_config("mamba2-370m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=dev)
    del params
    eng.ensure_batch()
    C = eng.chunk_len
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size - 1, (2 * C,))
    row = torch.zeros((1, eng.max_pages), dtype=torch.int32, device=dev)
    chunks = [torch.tensor(prompt[None, i * C:(i + 1) * C].astype(np.int32),
                           device=dev) for i in range(2)]

    (mrow,) = eng.rows

    def run():
        for i, ck in enumerate(chunks):
            chunk_prefill_step(cfg, mrow.params, mrow.cache, ck, slot=0,
                               start=i * C, valid_len=C, pages_row=row,
                               page_size=eng.page_size, impl="kernel",
                               shards=mrow.shards)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    ssd_kernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.chunks // 2):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = ssd_kernel.launches
    n = args.chunks
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    mine = [e for e in events if "ssd_" in e.key]
    return {
        "kernel_shape": [BC, H, Q, P, N], "kernel_ms": kernel_ms,
        "chunks": n, "wrapper_calls": calls,
        "wall_ms_per_chunk": wall * 1e3 / n,
        "device_busy_ms_per_chunk": sum(map(_dev_us, events)) / 1e3 / n,
        "ssd_kernels_ms_per_chunk": sum(map(_dev_us, mine)) / 1e3 / n,
        "ssd_kernels_per_call": (sum(e.count for e in mine) / calls
                                 if calls else None),
        "ssd_kernels": [{"name": e.key[:80], "calls": e.count,
                         "ms_per_chunk": _dev_us(e) / 1e3 / n}
                        for e in mine]}


def paged_decode(args) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.serve import PagedEngine
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch, page, max_len = 8, 16, 2048
    eng = PagedEngine(cfg, params, batch=batch, max_len=max_len,
                      page_size=page, prefill_chunk=256, device="cuda")
    del params
    rng = np.random.default_rng(0)
    lens = np.linspace(1000, 1500, batch).astype(int)
    next_page = 1
    tok = np.zeros((batch, 1), np.int32)
    for slot, n in enumerate(lens):
        need = eng.pages_needed(int(n), args.steps + 16)
        ids = list(range(next_page, next_page + need))
        next_page += need
        lg = eng.insert(slot, rng.integers(1, cfg.vocab_size - 1, int(n)),
                        page_ids=ids, max_new=args.steps + 16)
        tok[slot, 0] = int(lg[0, -1].argmax())
    for _ in range(8):
        tok = eng.decode(tok)[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    launches0 = paged_kernel.launches
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        tok = eng.decode(tok)[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"model": "qwen2-1.5b bf16", "batch": batch,
            "contexts": [int(n) for n in lens], "steps": args.steps,
            "step_ms": step_ms, "median_step_ms": float(np.median(step_ms)),
            "tok_per_s": batch * args.steps / (sum(step_ms) / 1e3),
            "paged_launches_per_step":
                (paged_kernel.launches - launches0) / args.steps}


def train_step(args) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.optim import OptimizerSpec
    from repro_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-1.5b")
    spec = OptimizerSpec(kind="adamw", lr=3e-4)
    stream = SyntheticLMStream(cfg, DataConfig(seed=0, global_batch=4,
                                               seq_len=4096))
    batches = [to_device(stream.batch(s), "cuda")
               for s in range(args.steps + 1)]
    mesh = None
    if args.grid:
        from repro_torch.launch.mesh import make_test_mesh
        data, model = (int(n) for n in args.grid.split(","))
        mesh = make_test_mesh(data, model, device="cuda",
                              devices=[torch.device("cuda")] * (data * model))
    state = TrainState.create(
        cfg, spec, torch.Generator(device="cuda").manual_seed(0), "cuda",
        mesh=mesh)
    step = make_train_step(cfg, spec, grad_accum=2, mesh=mesh)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa_kernel.launches)
    secs = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    tokens = batches[0]["tokens"].numel()
    return {"model": "qwen2-1.5b", "seq": 4096, "global_batch": 4,
            "grad_accum": 2, "grid": args.grid or None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "steps": args.steps, "step_s": secs,
            "median_step_s": float(np.median(secs)),
            "tokens_per_s": tokens / float(np.median(secs)),
            "loss": float(m["loss_total"]),
            "flash_launches_per_step": {
                k: (fa_kernel.launches[k] - before[k]) / args.steps
                for k in before}}


KERNELS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd, "ssd": ssd,
           "paged_decode": paged_decode, "train_step": train_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--src", default=str(_SRC),
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="", help="a name for the output")
    ap.add_argument("--chunks", type=int, default=8,
                    help="ssd: prefill chunks in the profiled window (even)")
    ap.add_argument("--grid", default="",
                    help="train_step: DATA,MODEL of a training mesh "
                         "(default: no mesh)")
    ap.add_argument("--steps", type=int, default=64,
                    help="paged_decode: timed decode steps; train_step: "
                         "timed training steps")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    result = KERNELS[args.kernel](args)
    print(smi, flush=True)
    print(json.dumps({"label": args.label, "src": args.src, "device": smi,
                      "kernel": args.kernel, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
