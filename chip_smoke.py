#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``) and PyTorch — never JAX —
and prints one JSON line per phase:

1. ``device``  — the card's name and power limit (``nvidia-smi``);
2. ``build``   — builds every CUDA kernel of the port from ``src/repro_torch/
   csrc`` with ``nvcc`` (one process per source, all at once);
3. ``kernels`` — calls each kernel's wrapper on the card at the shapes the
   serving path gives it, holds the result against its plain PyTorch
   version (stated tolerance) and times kernel, plain version and one
   PyTorch library call computing the same attention, beside the least time
   the card could take (``bound_ms``); the wrapper the decode path calls
   (kernel plus self-term merge) is held against its gather oracle on the
   same inputs;
4. ``parity``  — full-width qwen2-1.5b (all 28 layers) at fp32 compute:
   prompts are prefilled, then teacher-forced decode steps run through the
   kernel path and through the plain gather path; logits must agree;
5. ``serve``   — full-width qwen2-1.5b in bf16 with random weights from a
   seeded ``torch.Generator``: ``ServeScheduler`` over ``PagedEngine``
   serves 16 requests (prompts 64-1500 tokens, 32 new tokens each, greedy);
   every request must finish with its token count, and the kernel's launch
   count must equal decode steps x layers;
6. ``decode_step_paths`` and ``profile`` — a full batch of long prompts:
   decode steps timed alternately through the kernel path and the plain
   gather path, then a few kernel-path steps under ``torch.profiler``:
   device time by kernel and the device's busy share;
7. ``kernels`` (``ssd_scan``) — the SSD intra-chunk kernel against its
   plain version at mamba2-370m's serving shapes (H 32, P 64, N 128;
   Q 256 and 16 at one chunk, Q 256 at eight), with strongly negative
   decays; timed beside its plain version and its bound;
8. ``parity_ssm`` — full-width mamba2-370m (all 48 layers) at fp32:
   prompts chunk-prefilled through the kernel path and the plain einsum
   path, then teacher-forced decode steps; logits must agree;
9. ``serve_ssm`` — full-width mamba2-370m in bf16, the same 16-request
   trace as phase 5; every request must finish with its token count, and
   the SSD kernel's launch count must equal chunk calls x 48 layers;
10. ``prefill_chunk_paths`` — 256-token prefill chunks timed alternately
   through the kernel path and the plain path, then a few kernel-path
   chunks under ``torch.profiler``;
11. ``kernels`` (``jacobi_sweep``) — both Jacobi kernels (plain sweep and
   fused-residual sweep) against their plain versions at the paper's sizes
   N 2709, 4209 and 7209 in fp32, one bf16-x and one bf16-A case and a
   ragged N 333; timed beside their plain versions, ``torch.addmv`` (the
   library call that gives r = b − A·x) and their bound;
12. ``jobmodel`` — the paper's §2.2 max example, its graph written in the
   §3.3 job-file text and parsed by the port's parser, run on the card by
   ``LocalExecutor`` in the sync, pipelined and dataflow modes with the
   greedy and cost strategies; the answer must equal numpy's maximum;
13. ``jacobi`` — the paper's Fig. 3: at n 2709, 4209 and 7209, 500
   iterations, tol 0, the tailored loop (plain and through the fused
   kernel), the HyPar job graph (4 chunks, three dispatch modes) and the
   SPMD-fused loop; every variant must do 500 iterations, agree with the
   plain tailored x within 1e-5 and reach a residual of at most 1e-4·‖b‖,
   and the fused kernel must launch once per iteration plus one warm-up.
   Seconds and overhead against the tailored loop, per size and as means;
   then 100 iterations of the tailored kernel loop and of a HyPar sync
   solve at n 7209 under ``torch.profiler`` (device time by kernel, busy
   share).

Then a ``{"kernels": [...]}`` summary line, the card's ``nvidia-smi`` line,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that last line; so does a machine
without a CUDA device, or a directory without the repository's sources.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
KERNEL_TOL = 1e-4                # kernel vs plain, attention output and m
# SSD kernel vs plain, max|Δ| / max|plain| of y and of S: the two take
# cumsum(a) in different orders, and exp(cum_t - cum_s) carries the
# difference as a relative error of about eps_fp32 * |cum| (|cum| reaches
# a few hundred at Q = 256 with the strong decays drawn here)
SSD_TOL = 1e-4
DEV = "cuda"
WRAPPER_TOL_F32 = 1e-5           # wrapper, kernel vs gather oracle, fp32
PARITY_TOL = 1e-3                # kernel vs plain path, logits / max|logit|
# Jacobi kernels vs plain, max|Δ| / max|plain| of x' (fp32 x) and relative
# error of ‖r‖: both sum N fp32 products in different orders
JACOBI_TOL = 1e-5
JACOBI_TOL_BF16 = 2.0 ** -7      # bf16 x': one bf16 spacing of max|x'|
JACOBI_SIZES = (2709, 4209, 7209)  # paper Fig. 3
JACOBI_ITERS = 500
JACOBI_X_TOL = 1e-5              # every variant's x vs the plain tailored x
JACOBI_RES_TOL = 1e-4            # exact residual / ‖b‖


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call.  The device first sleeps for 1.5x the
    host time the calls take to enqueue (measured on the warm-up call), so
    every launch is queued before the first one runs: the events then time
    the device's work, not the host's launch rate."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host_s * 2e9, 2e10)))
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def paged_inputs(gen, *, B, KV, G, D, ps, n_pages, kv_lens, dtype,
                 trash_tail=0):
    """Serve-layout inputs on the card: each slot's pages are distinct pool
    pages, the rest of its row is the trash page 0, whose contents are NaN
    (the kernel must read it as zeros)."""
    P = 1 + B * n_pages
    k_pool = torch.randn((P, KV, ps, D), generator=gen, device=DEV).to(dtype)
    v_pool = torch.randn((P, KV, ps, D), generator=gen, device=DEV).to(dtype)
    k_pool[0] = float("nan")
    v_pool[0] = float("nan")
    table = np.zeros((B, n_pages), np.int32)
    nxt = 1
    for b, L in enumerate(kv_lens):
        need = -(-int(L) // ps)
        table[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
        if trash_tail and need:
            table[b, max(need - trash_tail, 0):need] = 0
    q = torch.randn((B, KV, G, D), generator=gen, device=DEV)
    q = (q / math.sqrt(D)).to(dtype)
    return (q, k_pool, v_pool, torch.tensor(table, device=DEV),
            torch.tensor(kv_lens, dtype=torch.int32, device=DEV))


def bound_ms(pages, kv_len, *, B, KV, G, D, ps, window, elt):
    """Least time for the kernel's work on these inputs: the larger of its
    bytes over the card's memory rate and its fp32 operations over the
    fp32 rate.  Bytes: K and V rows of every page the kernel must read
    (pages that can hold a visible position, the trash page excluded — it
    reads as zeros), their table entries, q, kv_len, and the fp32 outputs.
    Operations: 4*G*D per position of a page read (q.k and p.v)."""
    tbl = pages.cpu().numpy()
    lens = kv_len.cpu().numpy()
    n_read = n_run = 0
    for b in range(B):
        for j in range(tbl.shape[1]):
            if j * ps >= lens[b]:
                break
            if window is not None and (j + 1) * ps - 1 < lens[b] + 1 - window:
                continue
            n_run += 1
            n_read += int(tbl[b, j] != 0)
    nbytes = (2 * n_read * KV * ps * D * elt + n_run * 4 + B * KV * G * D * elt
              + B * 4 + B * KV * G * (D + 2) * 4)
    flops = 4 * n_run * KV * G * ps * D
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wrapper_case(gen, q, k_pool, v_pool, pages, kv_len, window) -> dict:
    """The wrapper the decode path calls (q pre-scale and rounding, kernel,
    self-term LSE merge) against its gather oracle on the same inputs.

    bf16 tolerance, from the rounding points: the oracle rounds the
    probabilities to bf16 before P.V (the kernel keeps them fp32), which
    moves the output by at most 2^-9 max|v|; both sides round the output to
    bf16, at most one bf16 spacing (2^-8 |out|) apart.  The stated bound is
    2^-8 (max|v| + max|out|)."""
    from repro_torch.kernels.paged_attention import paged_decode_attention

    B, KV, G, D = q.shape
    dtype = q.dtype
    qw = torch.randn((B, 1, KV * G, D), generator=gen, device=DEV).to(dtype)
    kt = torch.randn((B, KV, 1, D), generator=gen, device=DEV).to(dtype)
    vt = torch.randn((B, KV, 1, D), generator=gen, device=DEV).to(dtype)
    out = paged_decode_attention(qw, k_pool, v_pool, pages, kv_len, kt, vt,
                                 window=window, impl="kernel")
    ref = paged_decode_attention(qw, k_pool, v_pool, pages, kv_len, kt, vt,
                                 window=window, impl="ref")
    if out.shape != (B, 1, KV * G, D) or not torch.isfinite(out).all():
        raise AssertionError(f"wrapper output {tuple(out.shape)} not finite "
                             f"or misshapen ({dtype}, window={window})")
    err = float((out.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        tol = WRAPPER_TOL_F32
    else:
        v_max = max(float(v_pool[1:].float().abs().max()),
                    float(vt.float().abs().max()))
        tol = 2.0 ** -8 * (v_max + float(ref.float().abs().max()))
    if err > tol:
        raise AssertionError(f"wrapper disagrees with its gather oracle: "
                             f"{err} > {tol} ({dtype}, window={window})")
    return {"wrapper_max_abs_err": err, "wrapper_tol": tol}


def kernel_phase(n_layers: int) -> dict:
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain)
    from repro_torch.kernels.paged_attention.ref import gather_pages_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the serving path's shapes: qwen2-1.5b decode at batch 8, page 16,
    # max_len 2048 (128 pages a slot); ragged lengths, one free slot
    B, KV, G, D, ps, n_pages = 8, 2, 6, 128, 16, 128
    kv_lens = [2048, 1999, 1500, 1024, 777, 300, 17, 0]
    gen = torch.Generator(device=DEV).manual_seed(0)
    max_err = 0.0
    main_case = None
    for dtype in (torch.float32, torch.bfloat16):
        for window, trash_tail in ((None, 0), (512, 1)):
            q, kp, vp, pages, kv_len = paged_inputs(
                gen, B=B, KV=KV, G=G, D=D, ps=ps, n_pages=n_pages,
                kv_lens=kv_lens, dtype=dtype, trash_tail=trash_tail)
            acc, m, l = paged_attention_kernel(q, kp, vp, pages, kv_len,
                                               window=window)
            torch.cuda.synchronize()
            acc_p, m_p, l_p = paged_attention_plain(q, kp, vp, pages, kv_len,
                                                    window=window)
            for name, t in (("acc", acc), ("m", m), ("l", l)):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"kernel {name} not finite "
                                         f"({dtype}, window={window})")
            out = acc / l.clamp_min(1e-30)[..., None]
            out_p = acc_p / l_p.clamp_min(1e-30)[..., None]
            err = float((out - out_p).abs().max())
            err_m = float(((m - m_p).abs() / (1 + m_p.abs())).max())
            err_l = float(((l - l_p).abs() / l_p.clamp_min(1.0)).max())
            case = {"dtype": str(dtype).replace("torch.", ""),
                    "window": window, "trash_tail": trash_tail,
                    "max_abs_err": err, "m_rel_err": err_m,
                    "l_rel_err": err_l, "tol": KERNEL_TOL}
            if max(err, err_m, err_l) > KERNEL_TOL:
                raise AssertionError(f"kernel disagrees with plain: {case}")
            max_err = max(max_err, err)
            case.update(wrapper_case(gen, q, kp, vp, pages, kv_len, window))

            # timing: rotate over enough pool copies to exceed the 50 MB
            # L2, as in a decode step where 28 layers' weights pass between
            # two launches on the same pool
            elt = kp.element_size()
            n_copies = max(2, math.ceil(100e6 / (2 * kp.numel() * elt)))
            pools = [(kp.clone(), vp.clone()) for _ in range(n_copies)]
            ms = cuda_ms(lambda i: paged_attention_kernel(
                q, *pools[i % n_copies], pages, kv_len, window=window), 50)
            plain_ms = cuda_ms(lambda i: paged_attention_plain(
                q, *pools[i % n_copies], pages, kv_len, window=window), 3)
            # library yardstick: one scaled_dot_product_attention call over
            # the gathered dense view with a mask (the gather is not timed)
            T = n_pages * ps
            pos = torch.arange(T, device=DEV)[None, :]
            ok = pos < kv_len[:, None]
            if window is not None:
                ok = ok & (pos >= kv_len[:, None] + 1 - window)
            mask = ok[:, None, None, :]
            qh = (q.reshape(B, KV * G, 1, D).float() * math.sqrt(D)).to(dtype)
            views = [tuple(gather_pages_ref(p, pages).repeat_interleave(G, 1)
                           for p in pair) for pair in pools]
            library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                qh, *views[i % n_copies], attn_mask=mask), 50)
            bms, by = bound_ms(pages, kv_len, B=B, KV=KV, G=G, D=D, ps=ps,
                               window=window, elt=elt)
            case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bms, bound_by=by)
            emit("kernels", kernel="paged_attention",
                 shape={"B": B, "KV": KV, "G": G, "D": D, "page_size": ps,
                        "n_pages": n_pages, "kv_len": kv_lens}, **case)
            if dtype == torch.bfloat16 and window is None:
                main_case = case      # what the bf16 serving path runs
            del pools, views
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:101",
            "max_abs_err": max_err, "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "launches_per_decode_step": n_layers}


def ssd_inputs(gen, BC, H, Q, P, N):
    """fp32 inputs of the SSD kernel on the card: a uniform in [-3, 0) per
    step, so the decays over a 256-step chunk span hundreds of e-folds."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    x = randn(BC, H, Q, P)
    dt = F.softplus(randn(BC, H, Q, 1))
    a = -3.0 * torch.rand((BC, H, Q, 1), generator=gen, device=DEV)
    return x, dt, a, randn(BC, Q, N), randn(BC, Q, N)


def ssd_bound_ms(BC, H, Q, P, N):
    """Least time for the SSD function on these shapes: the larger of its
    bytes over the card's memory rate and its fp32 operations over the
    fp32 rate.  Bytes: every input read once and y, S written once (fp32).
    Operations (an exp counted as one): C Bᵀ once per chunk over the causal
    half, Q(Q+1)/2 * 2N; per head, the causal entries' weights and the
    product with x, Q(Q+1)/2 * (2P + 3), and the state, Q * (2NP + N + 3)
    (weights, the product and the cumsum)."""
    nbytes = 4 * BC * (2 * H * Q * P + 2 * H * Q + 2 * Q * N + H * N * P)
    causal = Q * (Q + 1) // 2
    flops = BC * (causal * 2 * N
                  + H * (causal * (2 * P + 3) + Q * (2 * N * P + N + 3)))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_kernel_phase(n_layers: int) -> dict:
    from repro_torch.kernels.ssd_scan import (ssd_intra_chunk_kernel,
                                              ssd_intra_chunk_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(2)
    main_case = None
    max_err = 0.0
    # mamba2-370m's serving shapes: one chunk at the largest and smallest
    # bucket, and eight chunks at once
    for BC, Q in ((1, 256), (1, 16), (8, 256)):
        H, P, N = 32, 64, 128
        args = ssd_inputs(gen, BC, H, Q, P, N)
        y, S = ssd_intra_chunk_kernel(*args)
        torch.cuda.synchronize()
        y_p, S_p = ssd_intra_chunk_plain(*args)
        if not (torch.isfinite(y).all() and torch.isfinite(S).all()):
            raise AssertionError(f"SSD kernel output not finite (BC {BC}, "
                                 f"Q {Q})")
        err_y = float((y - y_p).abs().max())
        err_s = float((S - S_p).abs().max())
        case = {"shape": {"BC": BC, "H": H, "Q": Q, "P": P, "N": N},
                "max_abs_err": max(err_y, err_s),
                "y_rel_err": err_y / float(y_p.abs().max()),
                "S_rel_err": err_s / float(S_p.abs().max()),
                "tol": SSD_TOL}
        if max(case["y_rel_err"], case["S_rel_err"]) > SSD_TOL:
            raise AssertionError(f"SSD kernel disagrees with plain: {case}")
        max_err = max(max_err, case["max_abs_err"])
        # timing: rotate over input copies larger than the 50 MB L2, as in
        # a prefill chunk, where a layer's weights pass between launches
        in_bytes = sum(t.numel() * 4 for t in args)
        n_copies = max(2, math.ceil(100e6 / in_bytes))
        copies = [tuple(t.clone() for t in args) for _ in range(n_copies)]
        ms = cuda_ms(lambda i: ssd_intra_chunk_kernel(
            *copies[i % n_copies]), 50)
        plain_ms = cuda_ms(lambda i: ssd_intra_chunk_plain(
            *copies[i % n_copies]), 10)
        bms, by = ssd_bound_ms(BC, H, Q, P, N)
        case.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
        emit("kernels", kernel="ssd_scan", **case)
        if (BC, Q) == (1, 256):
            main_case = case        # what a full prefill chunk runs
        del copies
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:57",
            "max_abs_err": max_err, "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD "
                            "intra-chunk dual form",
            "launches_per_chunk": n_layers}


# ---------------------------------------------------------------------------
# full-width parity and serving
# ---------------------------------------------------------------------------


def parity_phase() -> None:
    from repro_torch.configs import get_config
    from repro_torch.serve import PageAllocator, PagedEngine
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                         DEV)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in (700, 300, 129)]          # slot 3 stays free
    engines = {impl: PagedEngine(cfg, params, batch=4, max_len=1024,
                                 page_size=16, prefill_chunk=256,
                                 attn_impl=impl, device=DEV)
               for impl in ("kernel", "ref")}
    n_steps = 12
    first = {}
    for impl, eng in engines.items():
        alloc = PageAllocator(eng.num_pages)
        for slot, p in enumerate(prompts):
            pages = alloc.alloc(eng.pages_needed(len(p), n_steps + 1))
            first[impl, slot] = eng.insert(slot, p, page_ids=pages,
                                           max_new=n_steps + 1)
    # teacher forcing: both engines decode the plain path's greedy tokens
    toks = np.zeros((4, 1), np.int32)
    for slot in range(len(prompts)):
        toks[slot, 0] = int(first["ref", slot][0, -1].argmax())
    worst, same, total = 0.0, 0, 0
    for _ in range(n_steps):
        lk = engines["kernel"].decode(toks).float()
        lr = engines["ref"].decode(toks).float()
        live = lk[:len(prompts), -1], lr[:len(prompts), -1]
        if not torch.isfinite(lk).all():
            raise AssertionError("kernel-path logits not finite")
        rel = float((live[0] - live[1]).abs().max() / live[1].abs().max())
        worst = max(worst, rel)
        gk, gr = live[0].argmax(-1), live[1].argmax(-1)
        same += int((gk == gr).sum())
        total += len(prompts)
        toks[:len(prompts), 0] = gr.cpu().numpy()
    emit("parity", model=cfg.name, layers=cfg.n_layers, compute="float32",
         decode_steps=n_steps, max_rel_logit_err=worst, tol=PARITY_TOL,
         greedy_token_match=same / total)
    if worst > PARITY_TOL:
        raise AssertionError(f"kernel path logits differ from the plain "
                             f"path: {worst} > {PARITY_TOL}")
    del engines, params, first
    torch.cuda.empty_cache()


def serve_phase(kernel_mod) -> tuple[int, int]:
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedEngine, ServeScheduler
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")                    # bf16 compute
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=DEV)
    del params                     # the engine holds its bf16 copy
    torch.cuda.empty_cache()
    sched = ServeScheduler(eng)
    rng = np.random.default_rng(0)
    # warm-up: cuBLAS handles and the first launches, off the record
    for n in (64, 300):
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (n,)), max_new=2)
    sched.run()
    sched.reset_metrics()

    decode_s: list[float] = []
    decode = eng.decode

    def timed_decode(tokens, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(tokens, **kw)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out

    eng.decode = timed_decode
    lens = rng.integers(64, 1501, 16)
    max_new = 32
    steps0 = eng.n_decode_calls
    kernel_mod.launches = 0
    t0 = time.perf_counter()
    for n in lens:
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (int(n),)),
                     max_new=max_new)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_mod.launches
    steps = eng.n_decode_calls - steps0

    if len(results) != len(lens):
        raise AssertionError(f"{len(results)} of {len(lens)} requests done")
    bad = [r.rid for r in results if r.n_generated != max_new]
    if bad:
        raise AssertionError(f"requests {bad} did not produce {max_new} "
                             f"tokens")
    if any(o.outcome != "completed" for o in sched.outcomes.values()):
        raise AssertionError(f"outcomes {sched.outcomes}")
    if launches != steps * cfg.n_layers:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{steps} x {cfg.n_layers} layers")
    vocab_ok = all(0 <= t < cfg.padded_vocab for r in results
                   for t in r.tokens)
    if not vocab_ok:
        raise AssertionError("a token id falls outside the vocabulary")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    emit("serve", model=cfg.name, layers=cfg.n_layers, compute="bfloat16",
         batch=8, page_size=16, prefill_chunk=256, max_len=2048,
         requests=len(results), prompt_lens=[int(n) for n in lens],
         max_new=max_new, gen_tokens=n_tok, wall_s=wall,
         tok_per_s=n_tok / wall, decode_steps=steps,
         chunk_calls=eng.n_chunk_calls,
         decode_ms_per_step_p50=float(np.median(decode_s) * 1e3),
         decode_ms_per_step_mean=float(np.mean(decode_s) * 1e3),
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p95_s=float(np.percentile(ttft, 95)),
         kernel_launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    eng.decode = decode
    profile_decode(sched, cfg, rng)
    return launches, steps


def profile_decode(sched, cfg, rng, n_steps: int = 8,
                   n_pairs: int = 4) -> None:
    """Where a decode step's time goes: a full batch of long prompts is
    prefilled; then decode-only scheduler steps run, first ``n_pairs``
    pairs timed alternately through the kernel path and the plain gather
    path (``attn_impl`` "kernel" / "ref", in the order kernel, ref, ref,
    kernel, ...), then ``n_steps`` through the kernel path under
    ``torch.profiler``: device time by kernel name and the device's busy
    share of the window (kernel time summed over wall time)."""
    from torch.profiler import ProfilerActivity, profile

    eng = sched.engine
    for n in rng.integers(1000, 1501, eng.batch):
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (int(n),)),
                     max_new=n_steps + 2 * n_pairs + 4)
    while len(sched.queue) or any(s.prefilling for s in sched.slots):
        sched.step()
    torch.cuda.synchronize()
    step_ms = {"kernel": [], "ref": []}
    for i in range(2 * n_pairs):
        impl = ("kernel", "ref")[(i + i // 2) % 2]
        eng.attn_impl = impl
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        step_ms[impl].append((time.perf_counter() - t0) * 1e3)
    eng.attn_impl = "auto"
    emit("decode_step_paths", batch=eng.batch, context="1000-1500 tokens",
         kernel_ms=step_ms["kernel"], ref_ms=step_ms["ref"],
         kernel_ms_median=float(np.median(step_ms["kernel"])),
         ref_ms_median=float(np.median(step_ms["ref"])))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    emit_profile("profile", prof, wall, "decode_steps", n_steps, "step")
    sched.run()


def dev_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return float(getattr(ev, attr))
    return 0.0


def emit_profile(phase: str, prof, wall: float, count_key: str, n: int,
                 per: str) -> None:
    """Device time by kernel name and the device's busy share (kernel time
    summed over wall time) of a profiled window of ``n`` steps or chunks
    (``per``)."""
    # device-side events only (kernels and copies): CPU ops carry their
    # children's device time too, and would count it twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit(phase, **{count_key: n, f"wall_ms_per_{per}": wall * 1e3 / n,
                   f"device_busy_ms_per_{per}": busy_ms / n,
                   "device_busy_share": (busy_ms / (wall * 1e3)
                                         if events else None),
                   "top_kernels": [{"name": e.key[:80], "calls": e.count,
                                    f"ms_per_{per}": dev_us(e) / 1e3 / n}
                                   for e in top]})


def prefill_through(eng, slot: int, prompt, page_ids, impl: str):
    """Chunk-prefill ``prompt`` into ``slot`` as ``PagedEngine.insert``
    does, with the SSD path pinned to ``impl``, and commit the slot.
    Returns the final chunk's logits."""
    from repro_torch.models.transformer import chunk_prefill_step
    from repro_torch.serve import chunk_plan

    eng.ensure_batch()
    row = torch.zeros((1, eng.max_pages), dtype=torch.int32, device=DEV)
    row[0, :len(page_ids)] = torch.tensor(page_ids, dtype=torch.int32)
    logits = None
    for start, blen, vlen in chunk_plan(len(prompt), eng.chunk_len,
                                        eng.chunk_buckets):
        ck = np.zeros((1, blen), np.int32)
        ck[0, :vlen] = prompt[start:start + vlen]
        logits, eng.cache = chunk_prefill_step(
            eng.cfg, eng.params, eng.cache, torch.tensor(ck, device=DEV),
            slot=slot, start=start, valid_len=vlen, pages_row=row,
            page_size=eng.page_size, impl=impl)
    eng.commit_slot(slot, page_ids)
    return logits


def parity_ssm_phase() -> None:
    from repro_torch.configs import get_config
    from repro_torch.serve import PageAllocator, PagedEngine
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                         DEV)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in (700, 300, 129)]          # slot 3 stays free
    engines = {impl: PagedEngine(cfg, params, batch=4, max_len=1024,
                                 page_size=16, prefill_chunk=256,
                                 device=DEV)
               for impl in ("kernel", "ref")}
    n_steps = 12
    worst, same, total = 0.0, 0, 0

    def compare(lk, lr):
        nonlocal worst, same, total
        lk, lr = lk.float(), lr.float()
        if not torch.isfinite(lk).all():
            raise AssertionError("kernel-path logits not finite")
        worst = max(worst, float((lk - lr).abs().max() / lr.abs().max()))
        same += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += lk.shape[0]
        return lr.argmax(-1)

    first = {}
    for impl, eng in engines.items():
        alloc = PageAllocator(eng.num_pages)
        for slot, p in enumerate(prompts):
            pages = alloc.alloc(eng.pages_needed(len(p), n_steps + 1))
            first[impl, slot] = prefill_through(eng, slot, p, pages, impl)
    toks = np.zeros((4, 1), np.int32)
    for slot in range(len(prompts)):
        tok = compare(first["kernel", slot][:, -1], first["ref", slot][:, -1])
        toks[slot, 0] = int(tok[0])
    # teacher forcing: both engines decode the plain path's greedy tokens
    for _ in range(n_steps):
        lk = engines["kernel"].decode(toks)[:len(prompts), -1]
        lr = engines["ref"].decode(toks)[:len(prompts), -1]
        toks[:len(prompts), 0] = compare(lk, lr).cpu().numpy()
    emit("parity_ssm", model=cfg.name, layers=cfg.n_layers,
         compute="float32", prompt_lens=[len(p) for p in prompts],
         decode_steps=n_steps, max_rel_logit_err=worst, tol=PARITY_TOL,
         greedy_token_match=same / total)
    if worst > PARITY_TOL:
        raise AssertionError(f"SSM kernel path logits differ from the plain "
                             f"path: {worst} > {PARITY_TOL}")
    del engines, params
    torch.cuda.empty_cache()


def serve_ssm_phase(kernel_mod) -> tuple[int, int]:
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedEngine, ServeScheduler
    from repro_torch.weights import init_params

    cfg = get_config("mamba2-370m")                   # bf16 compute
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=DEV)
    del params                     # the engine holds its bf16 copy
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = ServeScheduler(eng)
    rng = np.random.default_rng(0)
    # warm-up: cuBLAS handles and the first launches, off the record; the
    # same draws as the qwen2 serve phase, so the trace is the same
    for n in (64, 300):
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (n,)), max_new=2)
    sched.run()
    sched.reset_metrics()

    timed = {"decode": [], "prefill_chunk": []}
    originals = {name: getattr(eng, name) for name in timed}

    def timer(name):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            torch.cuda.synchronize()
            timed[name].append(time.perf_counter() - t0)
            return out
        return run

    for name in timed:
        setattr(eng, name, timer(name))
    lens = rng.integers(64, 1501, 16)
    max_new = 32
    steps0, chunks0 = eng.n_decode_calls, eng.n_chunk_calls
    kernel_mod.launches = 0
    t0 = time.perf_counter()
    for n in lens:
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (int(n),)),
                     max_new=max_new)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_mod.launches
    steps = eng.n_decode_calls - steps0
    chunks = eng.n_chunk_calls - chunks0
    for name, fn in originals.items():
        setattr(eng, name, fn)

    if len(results) != len(lens):
        raise AssertionError(f"{len(results)} of {len(lens)} requests done")
    bad = [r.rid for r in results if r.n_generated != max_new]
    if bad:
        raise AssertionError(f"requests {bad} did not produce {max_new} "
                             f"tokens")
    if any(o.outcome != "completed" for o in sched.outcomes.values()):
        raise AssertionError(f"outcomes {sched.outcomes}")
    if launches == 0 or launches != chunks * cfg.n_layers:
        raise AssertionError(f"SSD kernel launches {launches} != chunk "
                             f"calls {chunks} x {cfg.n_layers} layers")
    if not all(0 <= t < cfg.padded_vocab for r in results for t in r.tokens):
        raise AssertionError("a token id falls outside the vocabulary")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    emit("serve_ssm", model=cfg.name, layers=cfg.n_layers,
         compute="bfloat16", batch=8, page_size=16, prefill_chunk=256,
         max_len=2048, requests=len(results),
         prompt_lens=[int(n) for n in lens], max_new=max_new,
         gen_tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
         decode_steps=steps, chunk_calls=chunks,
         decode_ms_per_step_p50=float(np.median(timed["decode"]) * 1e3),
         decode_ms_per_step_mean=float(np.mean(timed["decode"]) * 1e3),
         prefill_ms_per_chunk_p50=float(
             np.median(timed["prefill_chunk"]) * 1e3),
         prefill_ms_per_chunk_mean=float(
             np.mean(timed["prefill_chunk"]) * 1e3),
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p95_s=float(np.percentile(ttft, 95)),
         kernel_launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    prefill_chunk_paths(eng, rng)
    return launches, chunks


def prefill_chunk_paths(eng, rng, n_pairs: int = 4,
                        n_profiled: int = 4) -> None:
    """Where a prefill chunk's time goes: full 256-token chunks of one
    prompt (a first chunk and a continuation) into a free slot, timed
    alternately through the kernel path and the plain einsum path
    (``impl`` "kernel" / "ref", in the order kernel, ref, ref, kernel,
    ...), then ``n_profiled`` kernel-path chunks under ``torch.profiler``:
    device time by kernel name and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import chunk_prefill_step

    C = eng.chunk_len
    prompt = rng.integers(0, eng.cfg.vocab_size - 1, (2 * C,))
    row = torch.zeros((1, eng.max_pages), dtype=torch.int32, device=DEV)
    chunks = [torch.tensor(prompt[None, i * C:(i + 1) * C].astype(np.int32),
                           device=DEV) for i in range(2)]

    def run(impl):
        for i, ck in enumerate(chunks):
            chunk_prefill_step(eng.cfg, eng.params, eng.cache, ck, slot=0,
                               start=i * C, valid_len=C, pages_row=row,
                               page_size=eng.page_size, impl=impl)

    run("kernel")
    run("ref")
    torch.cuda.synchronize()
    chunk_ms = {"kernel": [], "ref": []}
    for i in range(2 * n_pairs):
        impl = ("kernel", "ref")[(i + i // 2) % 2]
        t0 = time.perf_counter()
        run(impl)
        torch.cuda.synchronize()
        chunk_ms[impl].append((time.perf_counter() - t0) * 1e3 / 2)
    emit("prefill_chunk_paths", model=eng.cfg.name, chunk=C,
         kernel_ms=chunk_ms["kernel"], ref_ms=chunk_ms["ref"],
         kernel_ms_median=float(np.median(chunk_ms["kernel"])),
         ref_ms_median=float(np.median(chunk_ms["ref"])))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_profiled // 2):
            run("kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit_profile("profile_prefill", prof, wall, "chunks", n_profiled,
                 "chunk")


# ---------------------------------------------------------------------------
# the job-model runtime and the paper's Jacobi solver
# ---------------------------------------------------------------------------


def jacobi_inputs(gen, n, a_dtype, x_dtype):
    """A diagonally dominant system on the card as ``make_system`` draws
    it (normal / n, diagonal 3), and a random iterate x."""
    A = torch.randn((n, n), generator=gen, device=DEV) / n
    A.diagonal().fill_(3.0)
    x = torch.randn(n, generator=gen, device=DEV)
    b = torch.randn(n, generator=gen, device=DEV)
    A = A.to(a_dtype)
    return A, x.to(x_dtype), b, A.diagonal().contiguous()


def jacobi_bound_ms(inputs, outputs):
    """Least time for one sweep on these tensors: the larger of its bytes
    over the card's memory rate (A, x, b and d read once; x', and the fused
    kernel's fp32 partials, written once) and its 2N² fp32 operations over
    the fp32 rate."""
    n = inputs[0].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * n / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jacobi_kernel_phase() -> list[dict]:
    from repro_torch.kernels.jacobi_sweep import (
        jacobi_sweep, jacobi_sweep_kernel, jacobi_sweep_plain,
        jacobi_sweep_residual, jacobi_sweep_residual_kernel,
        jacobi_sweep_residual_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(n, f32, f32) for n in JACOBI_SIZES] + [
        (4209, f32, bf16), (7209, bf16, f32), (333, f32, f32)]
    gen = torch.Generator(device=DEV).manual_seed(3)
    # max_abs_err over the fp32-x cases; the bf16-x case apart (its x' is
    # rounded to bf16)
    entries = {name: {"max_abs_err": 0.0, "max_abs_err_bf16_x": 0.0}
               for name in ("jacobi_sweep", "jacobi_sweep_residual")}
    for n, a_dtype, x_dtype in cases:
        A, x, b, d = jacobi_inputs(gen, n, a_dtype, x_dtype)
        tol = JACOBI_TOL if x_dtype == f32 else JACOBI_TOL_BF16
        # timing: rotate over copies of A larger than the 50 MB L2, as in
        # the solver, where every sweep streams all of A from memory
        a_bytes = A.numel() * A.element_size()
        n_copies = max(2, math.ceil(100e6 / a_bytes))
        copies = [A.clone() for _ in range(n_copies)]
        # the check goes through the public wrappers (which launch the
        # kernel on these CUDA tensors, and for the fused sweep sum the
        # partials and take the root); the timing through the bindings
        for name, wrapper, kern, plain in (
                ("jacobi_sweep", jacobi_sweep, jacobi_sweep_kernel,
                 jacobi_sweep_plain),
                ("jacobi_sweep_residual", jacobi_sweep_residual,
                 jacobi_sweep_residual_kernel, jacobi_sweep_residual_plain)):
            fused = name == "jacobi_sweep_residual"
            out = wrapper(A, x, b, d)
            torch.cuda.synchronize()
            want = plain(A, x, b, d)
            got_x, want_x = (out[0], want[0]) if fused else (out, want)
            if got_x.dtype != x.dtype or not torch.isfinite(
                    got_x.float()).all():
                raise AssertionError(f"{name} x' misshapen or not finite "
                                     f"(N {n})")
            err = float((got_x.float() - want_x.float()).abs().max())
            case = {"N": n, "A": str(a_dtype).replace("torch.", ""),
                    "x": str(x_dtype).replace("torch.", ""),
                    "max_abs_err": err,
                    "x_rel_err": err / float(want_x.float().abs().max()),
                    "tol": tol}
            if fused:
                res = float(out[1])
                res_p = math.sqrt(float(want[1]))
                case["res_rel_err"] = abs(res - res_p) / res_p
            if max(case["x_rel_err"], case.get("res_rel_err", 0.0)) > tol:
                raise AssertionError(f"{name} disagrees with plain: {case}")
            ms = cuda_ms(lambda i: kern(copies[i % n_copies], x, b, d), 50)
            plain_ms = cuda_ms(lambda i: plain(copies[i % n_copies], x, b,
                                               d), 20)
            library_ms = None
            if a_dtype == x_dtype == f32:
                library_ms = cuda_ms(lambda i: torch.addmv(
                    b, copies[i % n_copies], x, alpha=-1), 50)
            bms, by = jacobi_bound_ms((A, x, b, d), kern(A, x, b, d)
                                      if fused else (out,))
            case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bms, bound_by=by)
            emit("kernels", kernel=name, **case)
            key = "max_abs_err" if x_dtype == f32 else "max_abs_err_bf16_x"
            entries[name][key] = max(entries[name][key], err)
            if (n, a_dtype, x_dtype) == (7209, f32, f32):
                entries[name].update(
                    {k: case[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
        del copies
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/jacobi_sweep.cu",
             "replaces": ("src/repro/kernels/jacobi_sweep/kernel.py:57"
                          if name == "jacobi_sweep" else
                          "src/repro/kernels/jacobi_sweep/kernel.py:105"),
             "shape": "N 7209, fp32",
             "library_call": "torch.addmv(b, A, x, alpha=-1)", **e}
            for name, e in entries.items()]


JOB_TEXT = """
  J1(1,0,0), J2(1,0,0);          # segment 1: search chunks in parallel
  J3(2,1,R1 R2);                 # segment 2: combine both results
"""


def jobmodel_phase() -> None:
    """The paper's §2.2 example (examples/quickstart.py): the maximum of an
    array in chunked jobs, on the card in every mode and strategy."""
    from repro_torch.core import (ChunkedData, FunctionRegistry,
                                  LocalExecutor, VirtualCluster,
                                  parse_job_text)

    reg = FunctionRegistry()
    reg.register(1, torch.max)                     # runs once per chunk

    def combine_max(*inputs):
        vals = [a for cd in inputs for a in cd.arrays()]
        return ChunkedData.from_arrays([torch.max(torch.stack(vals))])

    reg.register(2, combine_max, kind="whole")
    A = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    A_dev = torch.from_numpy(A).to(DEV)
    runs = []
    for mode in ("sync", "pipelined", "dataflow"):
        for strategy in ("greedy", "cost"):
            graph = parse_job_text(JOB_TEXT)
            graph.bind_input("J1", A_dev[:600], n_chunks=6)
            graph.bind_input("J2", A_dev[600:], n_chunks=4)
            cluster = VirtualCluster(n_schedulers=2, cores_per_worker=4,
                                     max_workers=4)
            t0 = time.perf_counter()
            results, report = LocalExecutor(cluster, reg, mode=mode,
                                            strategy=strategy).run(graph)
            wall = time.perf_counter() - t0
            out = results["J3"].to_array()
            if out.device.type != DEV or float(out) != float(A.max()):
                raise AssertionError(f"{mode}/{strategy}: max {float(out)} "
                                     f"on {out.device}, numpy {A.max()}")
            runs.append({"mode": mode, "strategy": strategy,
                         "max": float(out), "wall_s": wall,
                         "workers": len(cluster.workers),
                         "report": report.summary()})
    emit("jobmodel", graph=" ".join(JOB_TEXT.split()), numpy_max=float(A.max()),
         hybrid=parse_job_text(JOB_TEXT).is_hybrid()[1], runs=runs)


def jacobi_phase(kernel_mod) -> dict:
    """The paper's Fig. 3 at full size on the card, then a profiled window
    of the largest size.  Returns each Jacobi kernel's launches in the
    Fig. 3 runs."""
    from repro_torch.apps.jacobi import (jacobi_hypar, jacobi_spmd,
                                         jacobi_tailored, make_system)

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name in kernel_mod.launches:
        kernel_mod.launches[name] = 0
    for n in JACOBI_SIZES:
        A, b, _ = make_system(n, device=DEV)
        b_norm = float(torch.linalg.norm(b))
        runs = {"tailored": jacobi_tailored(A, b, iters=JACOBI_ITERS)}
        before = kernel_mod.launches["jacobi_sweep_residual"]
        runs["tailored_kernel"] = jacobi_tailored(A, b, iters=JACOBI_ITERS,
                                                  kernel=True)
        launched = kernel_mod.launches["jacobi_sweep_residual"] - before
        if launched != JACOBI_ITERS + 1:
            raise AssertionError(f"fused kernel launched {launched} times "
                                 f"for {JACOBI_ITERS} iterations + 1 warm-up")
        for mode in ("sync", "pipelined", "dataflow"):
            runs[f"hypar_{mode}"] = jacobi_hypar(
                A, b, iters=JACOBI_ITERS, n_chunks=4, mode=mode)
        runs["spmd"] = jacobi_spmd(A, b, iters=JACOBI_ITERS)
        base = runs["tailored"]
        row = {"n": n, "iters": JACOBI_ITERS, "kernel_launches": launched}
        for key, r in runs.items():
            dx = float(np.max(np.abs(r.x - base.x)))
            if (r.iters != JACOBI_ITERS or not np.isfinite(r.x).all()
                    or dx > JACOBI_X_TOL
                    or r.residual > JACOBI_RES_TOL * b_norm):
                raise AssertionError(
                    f"jacobi {key} at n {n}: iters {r.iters}, max|Δx| {dx}, "
                    f"residual {r.residual} (‖b‖ {b_norm})")
            row[key] = {"s": r.seconds, "residual": r.residual,
                        "max_dx_vs_tailored": dx,
                        "overhead_pct": 100.0 * (r.seconds / base.seconds
                                                 - 1.0)}
            if "report" in r.extra:
                row[key]["report"] = r.extra["report"]
        emit("jacobi", **row)
        rows.append(row)
        del A, b
        torch.cuda.empty_cache()
    launches = dict(kernel_mod.launches)
    variants = [k for k in rows[0] if isinstance(rows[0][k], dict)]
    emit("jacobi_mean_overhead_pct",
         **{k: float(np.mean([r[k]["overhead_pct"] for r in rows]))
            for k in variants if k != "tailored"})
    jacobi_loop_phase(rows[-1])
    profile_jacobi(JACOBI_SIZES[-1])
    return launches


def jacobi_loop_phase(fig3_row: dict, reps: int = 5) -> None:
    """What the host loop costs the tailored solve at the size of
    ``fig3_row``: the loop of ``jacobi_tailored`` (plain sweep and fused
    kernel) run four ways, in alternation, ``reps`` times each:
    ``checked`` as ``jacobi_tailored`` runs it (``run_while_loop``: the
    condition read every ``CHECK_EVERY`` iterations); ``masked``, the
    loop's first design (the carry masked on the device by the condition,
    ``carry = where(active, body(carry), carry)``, and an on-device count,
    read every ``CHECK_EVERY`` iterations); ``fixed``, a plain count with no
    condition at all, which is all a tol-0 run needs; and ``synced``, the
    condition read on the host before every iteration (a synchronise
    each).  Emits each way's median, least and greatest seconds, each
    median against ``fixed``, and the HyPar overheads of ``fig3_row``
    recomputed against each way's median."""
    from repro_torch.apps.jacobi import make_system
    from repro_torch.core import run_while_loop
    from repro_torch.core.executor import CHECK_EVERY
    from repro_torch.kernels.jacobi_sweep import jacobi_sweep_residual

    n = fig3_row["n"]
    A, b, _ = make_system(n, device=DEV)
    diag = torch.diagonal(A).contiguous()

    def plain(carry):
        x, _ = carry
        r = b - A @ x
        return x + r / diag, torch.linalg.norm(r)

    def kernel(carry):
        return jacobi_sweep_residual(A, carry[0], b, diag)

    def cond(carry):
        return carry[1] > 0.0

    def checked(body, carry):
        return run_while_loop(body, cond, carry, JACOBI_ITERS)

    def masked(body, carry):
        count = None
        for k in range(JACOBI_ITERS):
            active = cond(carry)
            if k % CHECK_EVERY == 0 and not bool(active):
                break
            carry = tuple(torch.where(active, new, old)
                          for new, old in zip(body(carry), carry))
            count = (active.to(torch.int32) if count is None
                     else count + active)
        return carry, (0 if count is None else int(count))

    def fixed(body, carry):
        for _ in range(JACOBI_ITERS):
            carry = body(carry)
        return carry, JACOBI_ITERS

    def synced(body, carry):
        n_it = 0
        while n_it < JACOBI_ITERS and bool(cond(carry)):
            carry = body(carry)
            n_it += 1
        return carry, n_it

    bodies = {"plain": plain, "kernel": kernel}
    ways = {"checked": checked, "masked": masked, "fixed": fixed,
            "synced": synced}
    x0 = (torch.zeros_like(b), torch.tensor(float("inf"), device=b.device))
    for body in bodies.values():                # warm-up, off the record
        body(x0)
    times = {f"{p}_{w}": [] for p in bodies for w in ways}
    dx = {}
    for _ in range(reps):
        for p, body in bodies.items():
            for w, way in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (x, _), n_it = way(body, x0)
                torch.cuda.synchronize()
                times[f"{p}_{w}"].append(time.perf_counter() - t0)
                if w == "checked":
                    x_ref = x
                d = float((x - x_ref).abs().max())
                dx[f"{p}_{w}"] = max(dx.get(f"{p}_{w}", 0.0), d)
                if n_it != JACOBI_ITERS or d > JACOBI_X_TOL:
                    raise AssertionError(f"jacobi loop {p}/{w}: {n_it} "
                                         f"iterations, max|Δx| {d}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    emit("jacobi_loop", n=n, iters=JACOBI_ITERS, reps=reps,
         s={k: {"median": med[k], "min": min(v), "max": max(v)}
            for k, v in times.items()},
         max_dx_vs_checked=dx,
         vs_fixed_pct={k: 100.0 * (med[k] / med[k.split("_")[0] + "_fixed"]
                                   - 1.0) for k in med},
         hypar_overhead_pct={
             mode: {w: 100.0 * (fig3_row[f"hypar_{mode}"]["s"]
                                / med[f"plain_{w}"] - 1.0) for w in ways}
             for mode in ("sync", "pipelined", "dataflow")})
    del A, b
    torch.cuda.empty_cache()


def profile_jacobi(n: int, iters: int = 100) -> None:
    """Where a Jacobi iteration's time goes at size ``n``: the tailored
    loop through the fused kernel and a HyPar sync solve, each for
    ``iters`` iterations under ``torch.profiler``: device time by kernel
    and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.jacobi import jacobi_hypar, jacobi_tailored, \
        make_system

    A, b, _ = make_system(n, device=DEV)
    for name, run in (("profile_jacobi_tailored_kernel",
                       lambda: jacobi_tailored(A, b, iters=iters,
                                               kernel=True)),
                      ("profile_jacobi_hypar_sync",
                       lambda: jacobi_hypar(A, b, iters=iters))):
        run()                                   # warm, off the record
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit_profile(name, prof, wall, "iterations", iters, "iteration")
    del A, b
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.jacobi_sweep import kernel as jacobi_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    smi = nvidia_smi_line()
    name, power = [s.strip() for s in smi.split(",", 1)]
    emit("device", name=name, power_limit=power,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = build.build_all(ptxas_verbose=True)
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])

    entry = kernel_phase(n_layers=28)
    parity_phase()
    launches, steps = serve_phase(pa_kernel)
    entry["launches"] = launches
    entry["launches_per_decode_step"] = launches / steps

    ssd_entry = ssd_kernel_phase(n_layers=48)
    parity_ssm_phase()
    launches, chunks = serve_ssm_phase(ssd_kernel)
    ssd_entry["launches"] = launches
    ssd_entry["launches_per_chunk"] = launches / chunks

    jacobi_entries = jacobi_kernel_phase()
    jobmodel_phase()
    launches = jacobi_phase(jacobi_kernel)
    for e in jacobi_entries:
        e["launches"] = launches[e["name"]]
        e["launches_per_iteration"] = (
            e["launches"] / (len(JACOBI_SIZES) * JACOBI_ITERS))
    if (launches["jacobi_sweep_residual"]
            != len(JACOBI_SIZES) * (JACOBI_ITERS + 1)):
        raise AssertionError(f"fused Jacobi kernel launched {launches} "
                             f"times")
    jacobi_entries[0]["note"] = ("not on the Fig. 3 path: the solver runs "
                                 "the fused sweep; the JAX package's path "
                                 "does not call the plain sweep either")
    print(json.dumps({"kernels": [entry, ssd_entry, *jacobi_entries]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
