#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``) and PyTorch — never JAX —
and prints one JSON line per phase:

1. ``device``  — the card's name and power limit (``nvidia-smi``);
2. ``build``   — builds every CUDA kernel of the port from ``src/repro_torch/
   csrc`` with ``nvcc`` (one process per source, all at once), with
   ptxas's register report; ``build_flash_bwd`` and ``build_flash_fwd``
   sum it up for the flash kernels' bf16 instances: registers, spill
   bytes and whether ptxas serialized their ``wgmma`` (C7520), reported,
   not checked;
3. ``kernels`` — calls each kernel's wrapper on the card at the shapes the
   serving path gives it (training for the flash kernel, phase 14), holds the result against its plain PyTorch
   version (stated tolerance) and times kernel, plain version and one
   PyTorch library call computing the same attention, beside the least time
   the card could take (``bound_ms``); the paged kernel at every
   ``pages_per_split`` of the tuner's grid and at its default, each held
   and timed; the wrapper the decode path calls (split pass, then the merge
   pass with the self term) is held against its gather oracle on the same
   inputs and timed (``wrapper_ms``);
4. ``parity``  — full-width qwen2-1.5b (all 28 layers) at fp32 compute
   (``parity_phase``, the kernel-vs-plain check of every paged model):
   prompts are chunk-prefilled, then teacher-forced decode steps run
   through the kernel path and through the plain gather path; chunk and
   decode logits must agree;
5. ``serve``   — (``serve_paged_phase``, the paged serving phase of every
   model) phase 4, and its paths in bf16 at full depth, reported; then
   full-width qwen2-1.5b in bf16 with random weights from a seeded
   ``torch.Generator``: ``ServeScheduler`` over ``PagedEngine`` serves 16
   requests (prompts 64-1500 tokens, 32 new tokens each, greedy); every
   request must finish with its token count, and the kernel's launch count
   must equal decode steps x layers;
5a. ``serve_hypar`` — the same engine configuration and trace, served four
   times on one engine, each by a fresh ``ServeScheduler``: direct, HyPar
   (``HyParRequestTracker``, cost strategy), HyPar, direct; then a fifth,
   HyPar run in which ``fail_slot(0)`` is called after the first decode
   step.  Every request gets its 32 tokens, every run's token streams
   equal the direct run's request by request (the failed slot's victim
   re-prefills to the same stream, ``n_recovered`` 1), launches equal
   decode steps x 28 in each run, and after each HyPar run the tracker's
   graph is empty, its 16 result records released and never sent back,
   and ``serve.decode`` has an EWMA.  Tok/s, TTFT, the decode step and the
   tracker's host seconds of each run, and ``hypar_overhead_pct`` from the
   medians beside the run-to-run spread (``overhead_resolved``);
5b. ``serve_groups`` — the ``serve`` engine settings and trace under
   reserve-on-demand, served by one device group, by two, and by two
   under a chaos plan (``ServeChaosInjector``): group 1 fails at
   scheduler call 6 for 10 calls, and at call 8 group 0's decode wave
   reports 10 watchdog budgets of extra time, the watchdog's budget 5
   times the fault-free two-group run's slowest step, ``unhealthy_after``
   2, ``max_restarts`` 4.  Every request completes, both groups end with
   no page outstanding, both serve in the fault-free two-group run, the
   chaos run fails over once and rejoins once with one watchdog trip for
   each injected slow reading, and the paged kernel runs 28 times a
   decode step.  Tok/s, TTFT, the host seconds of routing and probes,
   and the bf16 streams equal to the one-group run (counted, not gated);
5c. ``serve_groups_parity`` — the same three runs (two groups with the
   prefix cache for qwen2, whose longer prompts share a 512-token
   prefix) at fp32 for qwen2-1.5b and mamba2-370m at full width cut to
   4 layers: every stream equals the fault-free one-group run's, and
   SSD launches equal prefill chunks x 4, re-prefills included;
5d. ``serve_dense_trace`` — the same trace through ``ServeScheduler``
   over the dense ``Engine`` (batch 8, max_len 2048, prompts right-padded
   to the default buckets): every request gets its 32 tokens, each insert
   runs the flash forward once a layer (16 x 28), and tok/s, TTFT, the
   decode step and the insert stand beside the ``serve`` phase's;
5e. ``serve_waves`` — the launcher's wave mode at full width:
   ``Engine(batch=8, max_len=1064)``, 4 waves of 8 prompts of 1,024
   tokens (numpy seed 0), 32 greedy tokens; wave 0 is the warm-up.  First
   a batched prefill at the wave's shape through the kernel
   (``decode_step(impl="auto")``) and the plain core (``impl="dense"``):
   last-token logits within 1e-3 of max|logit| in fp32 compute (bf16
   reported); then the waves, the flash forward launched once a layer a
   wave (4 x 28); steady tok/s, prefill ms and the median decode step;
   then 4 decode steps under ``torch.profiler`` (``profile_serve_waves``);
6. ``decode_step_paths`` and ``profile`` — a full batch of long prompts:
   decode steps timed alternately through the kernel path and the plain
   gather path, then a few kernel-path steps under ``torch.profiler``:
   device time by kernel, the paged kernels' device time and launches a
   step, and the device's busy share;
7. ``kernels`` (``ssd_scan``) — the SSD intra-chunk kernel (a C·Bᵀ pass
   and a y/S pass) against its plain version at mamba2-370m's serving
   shapes (H 32, P 64, N 128; Q 256 and 16 at one chunk, Q 256 at
   eight), with strongly negative decays, at every row tile of the
   tuner's grid and at its default; timed at each
   (``ms_by_launch_shape``) beside its plain version and its bound;
8. ``parity_ssm`` — phase 4 for full-width mamba2-370m (all 48 layers):
   the chunks through the SSD kernel and its plain einsum path;
9. ``serve_ssm`` — phase 5 for mamba2-370m, the same 16-request trace;
   the SSD kernel's launch count must equal chunk calls x 48 layers;
10. ``prefill_chunk_paths`` — 256-token prefill chunks timed alternately
   through the kernel path and the plain path, then a few kernel-path
   chunks under ``torch.profiler``: the ``profile_prefill`` line gives
   the SSD device kernels' ms a chunk, per pass, and the device kernels
   a counted wrapper call (the script fails unless it is 2);
10a. ``serve_waves_ssm`` — phase 5c for mamba2-370m (48 layers, d 1024),
   the SSD kernel against ``impl="ref"``, launched 4 x 48 times;
10b. ``dense_vs_paged`` — qwen2-1.5b and mamba2-370m at full width cut to
   4 layers, fp32 compute: one 8-request mixed-length trace (prompts of
   up to four 256-token chunks) through ``ServeScheduler`` over the dense
   ``Engine`` and over ``PagedEngine`` (the paged kernel decoding);
   greedy streams and outcomes must be identical, a mismatch printed with
   the request, the token and both engines' top-2 logit gap;
10b'. ``kernels`` at a tensor-parallel position and ``serve_mesh`` — the
   paged kernel at qwen2-1.5b's decode split over TP=2 (bf16, B 8, KV 1,
   G 6, D 128, contexts 1,000-1,500) against its plain version, timed
   beside its bound, plain version and SDPA; then the serving mesh with
   every grid position on the card (``devices=[cuda:0] * size``):
   qwen2-1.5b (8 of its 28 layers; its vocabulary split at TP=2) in fp32
   at TP=2, DP=2 and TP=2 x DP=2 against no mesh (8 requests of 64-512
   tokens, 16 greedy tokens; streams equal, no page leaked, paged
   launches decode steps x 8 x tp x dp, 8 teacher-forced decode steps
   within 1e-3 of max|logit|, TP=2's per-position pool bytes half); bf16:
   a 1 x 1 mesh bit-equal to no mesh, TP=2's tok/s and stream agreement
   reported; qwen2-moe-a2.7b at TP=2 (its experts split 30 / 30): fp32 at
   4 layers with streams equal to no mesh, bf16 at full depth with tok/s,
   each position's weight bytes and no expert on the lead; mamba2-370m
   (48 layers, fp32) at DP=2: equal streams, SSD launches chunks x 48;
10c. ``kernels`` at the MoE and hybrid shapes — the paged kernel (bf16,
   batch 8, page 16, max_len 2048, G 1: qwen2-moe-a2.7b's KV 16 x D 128
   and zamba2-1.2b's KV 32 x D 64) at every pages-a-split value and the
   default, SSD at zamba2's chunk (1, 64, 256, 64, 64) at every row tile,
   the flash forward at the dense engine's batched prefill (bf16, causal,
   B 8, S 1,024, H = KV 16 x D 128 and 32 x D 64) at every launch shape
   (the default timed); each against its plain version, timed beside it,
   its bound and, where
   there is one, its library call (a ``model`` field names the model);
10d. ``serve_moe`` and ``serve_hybrid`` — qwen2-moe-a2.7b (24 MoE
   layers, 60 experts top-4 and 4 shared, d 2048, 16 heads of 128) and
   zamba2-1.2b (38 SSM layers and 6 invocations of one shared attention
   block, d 2048, 32 heads of 64) at full width, by phase 5's code: first
   ``parity_moe`` / ``parity_hybrid`` (phase 4; qwen2-moe cut to 4 layers,
   its fp32 weights being 57 GB, zamba2 whole), then the bf16 full-depth
   gap, reported with, for qwen2-moe, the decode rows whose top-4 experts
   differ between the two paths, by layer; then 8 requests of phase 5's
   trace: the paged kernel runs once an attention layer a decode step
   (24 / 6) and SSD once an SSM layer a chunk (0 / 38); tok/s, TTFT, a
   profiled decode step and, for zamba2, a profiled prefill chunk;
10e. ``serve_waves_moe`` and ``serve_waves_hybrid`` — phase 5e for the
   two models: 2 waves of 8 prompts of 1,024 tokens, 16 tokens each, the
   flash forward launched once an attention layer a wave and SSD once an
   SSM layer a wave; the fp32 prefill check against ``impl="dense"``
   (qwen2-moe, at 4 layers) and ``impl="ref"`` (zamba2, whole: plain
   attention and SSD);
10f. ``kernels`` at gemma3-4b's and whisper-base's shapes
   (``gemma3_whisper_kernel_phase``) — the flash forward at gemma3's
   batched prefill (B 8, S 2,048, H 8, KV 4, D 256; causal, and under the
   local window of 1,024) in bf16 and fp32 at every launch shape of the
   tuner's grid (128-key tiles must be refused at D 256; each bf16 shape
   timed), and at
   whisper's non-causal shapes (bf16, B 8, H = KV 8, D 64: 1,500 encoder
   frames over themselves, 64 and 1 decoder rows over them); the paged
   kernel at gemma3's decode (bf16, B 8, KV 4, G 2, D 256, page 16,
   contexts 1,000-1,500) without and with the window; each against its
   plain version, timed beside it, its bound and SDPA (the window as a
   boolean mask);
10g. ``serve_gemma3`` and ``serve_waves_gemma3`` — gemma3-4b at full
   width (34 layers: 29 local, 5 global) by phases 5 and 5e:
   ``parity_gemma3`` at full depth in fp32 with prompts of 1,500, 1,100
   and 129 tokens (max_len 2,048, so the window cuts in chunks and
   decode steps), the bf16 gap reported; 8 requests of phase 5's trace,
   the paged kernel once a layer a decode step (34); 2 waves of 8 prompts
   of 2,048 tokens, 16 tokens each, the flash forward once a layer a wave
   (its fp32 prefill check against ``impl="dense"``);
10h. ``parity_whisper``, ``serve_waves_whisper`` and
   ``serve_whisper_trace`` (``serve_whisper_phases``) — whisper-base at
   full width on the dense ``Engine``, 1,500 random encoder frames a
   request, 64-token prompts, 64 greedy tokens: a prefill and a decode
   step through the kernel path against ``impl="ref"`` (fp32 gated at
   1e-3 of max|logit|, bf16 reported); 4 waves of 8, then 16 requests
   through ``ServeScheduler`` (an insert each, splicing its encoder
   output).  The flash forward must launch once an encoder layer and
   twice a decoder layer a prefill or insert, and once a decoder layer
   (cross-attention) a decode step, exactly;
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
   share);
14. ``kernels`` (``flash_attention``) — both flash-attention kernels
   against their plain versions at the training shape (B 2, S 4096, H 12,
   KV 2, D 128, causal, bf16), in fp32, with a sliding window, at ragged
   S, at head width 24 and with rows that see no key: the forward at every
   (``q_block``, ``kv_block``) of the tuner's grid (output 2e-2 bf16 /
   1e-5 fp32, LSE 1e-4); the backward on the forward's output and LSE with
   one seeded dO (dq, dk, dv within 2e-2 bf16 / 1e-4 fp32 of max|plain|,
   bit-identical on a repeat call, dq zero on rows that see no key); each
   timed beside its bound, the training shape also beside its plain
   version and ``scaled_dot_product_attention``'s forward and backward,
   the forward at every launch shape; the autograd Function's gradients
   (both kernels) against autograd through the plain version, fp32;
15. ``train`` — full-width qwen2-1.5b (28 layers) trained by the fused
   step: fp32 params, bf16 compute, AdamW at 3e-4, ``remat="full"``, seq
   4096, global batch 4 in 2 micro-batches, 4 steps, data from
   ``SyntheticLMStream`` (seed 0), weights from a seeded generator.  Step
   time, tokens/s, ``mfu``, peak memory, loss and grad norm per step; the
   flash forward must launch steps x 2 x 28 x 2 times (the 2nd 2 is the
   remat recompute) and the backward kernel be called steps x 2 x 28
   times, and step 1 must match the plain path (``impl="tiled"``: loss
   1e-3, grad norm 2e-2); then one step under ``torch.profiler``: busy
   share, the device time of each flash half, three device kernels a
   backward call, and no einsum;
15a. ``train_families`` — one line per model: mamba2-370m (24 of its 48
   layers),
   zamba2-1.2b (38), whisper-base (6 + 6; 1,500 frames, 448 decoder
   tokens) and qwen2-moe-a2.7b cut to 2 layers, each at full width,
   trained as in phase 15 for 3 steps: the plain path's step 1 first
   (``impl="ref"``: every kernel's plain version; loss 1e-3, grad norm
   2e-2), then the kernel path with the flash forward launched steps x 2
   x attention layers x 2, its backward steps x 2 x attention layers and
   SSD steps x 2 x SSM layers x 2 (its backward is the plain version's
   derivative); finite losses and grad norms; step time, tokens/s, peak
   memory; one more mamba2 step profiled: the SSD plain backward's device
   time beside the kernels';
15b. ``train_mesh`` — the training mesh (``launch/mesh.py``,
   ``train.shard_state``, ``make_train_step(mesh=)``): qwen2-1.5b at full
   width as in phase 15 (seq 4096, batch 4 in 2 micro-batches, fp32
   params, bf16 compute, AdamW, ``remat="full"``) on TP=2, DP=2 and TP=2 x
   DP=2 grids with every position on the card, each from the meshless
   run's initial state (drawn once from a seeded generator, kept on the
   host) and batches.  For each: step 1's loss within 1e-3 and grad norm
   within 2e-2 of the meshless step 1's, every gradient leaf within
   ``TRAIN_LEAF_TOL`` of max|meshless| (``step1_ok``); 2 steps with the
   flash forward launched steps x 2 x 28 x 2 x tp x dp times and its
   backward steps x 2 x 28 x tp x dp; each position's state bytes equal
   to the specs' shard bytes; step s, tokens/s, peak memory.  Then a
   4-layer fp32-compute run of each grid against its meshless run:
   parameters after 2 steps within 1e-5 of max|param|.  The flash shapes
   of a TP=2 shard, a DP=2 row and a TP=2 x DP=2 row are phase 14's
   ``train_qwen2_tp2``, ``train_qwen2_dp2`` and ``train_qwen2_tp2_dp2``
   cases.  The model axis beyond attention and MLPs at TP=2: qwen2's
   vocabulary (its embedding, logits and cross-entropy by vocab shard);
   ``train_mesh_moe``, qwen2-moe-a2.7b at 2 of its 24 layers (30 experts
   a position, the positions' expert bytes the specs'); ``train_mesh_ssm``,
   mamba2-370m at 8 of 48 (16 SSD heads a position, SSD launched steps x
   2 x 8 x 2 x 2 times; the SSD shard's shape is phase 7's
   ``train_mamba2_tp2``), each at the same gates (the mixers' per-head
   scalars at 1.0); ``train_mesh_fp32`` adds both at 2 layers, TP=2,
   sequences of 1,024;
16. ``train_hypar`` — ``HyParTrainer`` (sync) against the fused step at
   the same widths, 4 layers, 3 steps of 2 micro-batches: seconds of each,
   HyPar's overhead, final params within 1e-6 (and whether to the bit),
   the forward and backward counts of each;
16a. ``train_proc`` — ``HyParTrainer`` on ``ProcessExecutor`` (2 spawned
   workers on the card, a ``JobStore`` under ``build/``, removed after) at
   ``train_hypar``'s widths and seq, 1 layer and 1 step, against the thread
   trainer from the same start: parameters within 1e-6; then a second run
   over the same store must serve every job from it (no ``grad`` job
   issued).  Seconds of each run, the workers' boot time and the store's
   inline and spilled bytes; the workers' gradients run the flash kernels
   (``impl="auto"`` on ``resolve_device("cuda")``), which the parent's
   counters cannot see;
17. ``train_launcher`` — ``repro_torch.launch.train.main`` at ``--smoke``:
   6 steps with a checkpoint every 3, then a resume to 8, the forward and
   backward counts of each run;
18. ``kernels`` (``rmsnorm``) and ``norm_switch`` — the RMSNorm kernel
   against its plain version (fp32 1e-5, bf16 2e-2 of max|plain|) at the
   kernel bench's (4096, 1024) fp32, qwen2-1.5b's (8192, 1536) bf16,
   ragged rows, d 16384 and two small ragged widths, under every
   rows-a-block candidate of the tuner; timed at each beside its plain
   version, ``F.rms_norm`` and its bound; then ``apply_norm(use_kernel=
   True)`` against the plain norm on a full-width qwen2-1.5b hidden state;
19. ``kernel_bench_check`` and ``kernel_bench`` — first every wrapper the
   autotune pass tunes, on its inputs at the bench's shapes, under every
   candidate config of the tuner, against ``impl="ref"`` (fp32: RMSNorm
   1e-5, SSD 1e-4, Jacobi 1e-5, paged 1e-5; the flash forward in bf16,
   2e-2); then
   ``repro_torch.benchmarks.kernel_bench.run`` on the card into a fresh
   tuning cache: 6 plain-version rows and 5 tuned rows
   (one ``kernel_bench_row`` line each, with its rates as shares of the
   card's peaks), the launch counts set to 0 before and read after; a
   second autotune pass that must hit the cache for every kernel and time
   nothing; the flash row must name a launch shape of the grid; the calibrated cost model beside ``CostModelParams()`` and the
   card's peaks (no rate above 1.05 of its peak); the SSD row's rate (the
   reference's operation count) as a share of the fp32 peak goes into
   the summary;
20. ``jacobi_cost`` — ``jacobi_hypar(strategy="cost")`` at n 2709 seeded
   from that cache: the same iterations and x within 1e-5 of the tailored
   solve, beside a greedy HyPar solve.

Then a ``{"kernels": [...]}`` summary line, the card's ``nvidia-smi`` line,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that last line; so does a machine
without a CUDA device, or a directory without the repository's sources.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
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
    """One JSON line; ``at_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``reps`` back-to-back
    calls, by the tuner's CUDA-event timer (``tuning.device_seconds``: one
    warm-up call, and the device held by a sleep kernel while the launches
    queue, so the events time the device's work, not the host's launch
    rate)."""
    from repro_torch.kernels.tuning import device_seconds
    return device_seconds(fn, reps) / reps * 1e3


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


def wrapper_case(gen, q, k_pool, v_pool, pages, kv_len, window, pps):
    """The wrapper the decode path calls (one kernel call at ``pps`` pages
    a split: the split pass with q's pre-scale and rounding, the merge pass
    with the self-term LSE merge) against its gather oracle on the same
    inputs.  Returns the errors and the wrapper's other inputs (q, kt, vt),
    for timing.

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
                                 window=window, impl="kernel",
                                 pages_per_split=pps)
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
    return {"wrapper_max_abs_err": err, "wrapper_tol": tol}, (qw, kt, vt)


def kernel_vs_plain(got, want) -> dict:
    """Errors of the kernel's (acc, m, l) against the plain version's: the
    normalised output acc / l (absolute), m and l (relative)."""
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    for name, t in (("acc", acc), ("m", m), ("l", l)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"kernel {name} not finite")
    out = acc / l.clamp_min(1e-30)[..., None]
    out_p = acc_p / l_p.clamp_min(1e-30)[..., None]
    return {"max_abs_err": float((out - out_p).abs().max()),
            "m_rel_err": float(((m - m_p).abs() / (1 + m_p.abs())).max()),
            "l_rel_err": float(((l - l_p).abs() / l_p.clamp_min(1.0)).max())}


def paged_timed_case(gen, *, B, KV, G, D, ps, n_pages, kv_lens, dtype,
                     window, trash_tail, grid, default_pps,
                     model: str | None = None) -> tuple[dict, float]:
    """One shape of the paged kernel: every pages-a-split value of the
    tuner's grid and the default against its plain version
    (``KERNEL_TOL``), the wrapper against its gather oracle, then timed at
    each beside its plain version, its bound, one SDPA call over the
    gathered view and the whole wrapper.  Emits a ``kernels`` line and
    returns it with the largest error."""
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain,
                                                     paged_decode_attention)
    from repro_torch.kernels.paged_attention.ref import gather_pages_ref

    t0 = time.perf_counter()
    max_err = 0.0
    q, kp, vp, pages, kv_len = paged_inputs(
        gen, B=B, KV=KV, G=G, D=D, ps=ps, n_pages=n_pages,
        kv_lens=kv_lens, dtype=dtype, trash_tail=trash_tail)
    want = paged_attention_plain(q, kp, vp, pages, kv_len, window=window)
    errs = {}
    for pps in [None, *grid]:
        got = paged_attention_kernel(q, kp, vp, pages, kv_len,
                                     window=window, pages_per_split=pps)
        torch.cuda.synchronize()
        e = kernel_vs_plain(got, want)
        errs["default" if pps is None else str(pps)] = e
        if max(e.values()) > KERNEL_TOL:
            raise AssertionError(
                f"kernel disagrees with plain at pages_per_split "
                f"{pps} ({dtype}, window={window}, D {D}): {e}")
        max_err = max(max_err, e["max_abs_err"])
    case = {"dtype": str(dtype).replace("torch.", ""),
            "window": window, "trash_tail": trash_tail,
            **errs["default"], "tol": KERNEL_TOL,
            "err_by_pages_per_split": errs}
    wcase, (qw, kt, vt) = wrapper_case(gen, q, kp, vp, pages, kv_len,
                                       window, default_pps)
    case.update(wcase)

    # timing: rotate over enough pool copies to exceed the 50 MB
    # L2, as in a decode step where every layer's weights pass between
    # two launches on the same pool
    elt = kp.element_size()
    n_copies = max(2, math.ceil(100e6 / (2 * kp.numel() * elt)))
    pools = [(kp.clone(), vp.clone()) for _ in range(n_copies)]
    ms_by = {str(p): cuda_ms(lambda i, p=p: paged_attention_kernel(
        q, *pools[i % n_copies], pages, kv_len, window=window,
        pages_per_split=p), 50) for p in grid}
    ms = cuda_ms(lambda i: paged_attention_kernel(
        q, *pools[i % n_copies], pages, kv_len, window=window), 50)
    wrapper_ms = cuda_ms(lambda i: paged_decode_attention(
        qw, *pools[i % n_copies], pages, kv_len, kt, vt,
        window=window, impl="kernel", pages_per_split=default_pps),
        50)
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
    case.update(ms=ms, pages_per_split=default_pps,
                ms_by_pages_per_split=ms_by, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, bound_by=by, ms_over_bound=ms / bms)
    extra = {} if model is None else {"model": model,
                                      "seconds": time.perf_counter() - t0}
    emit("kernels", kernel="paged_attention", **extra,
         shape={"B": B, "KV": KV, "G": G, "D": D, "page_size": ps,
                "n_pages": n_pages, "kv_len": kv_lens}, **case)
    del pools, views
    return case, max_err


def kernel_phase(n_layers: int) -> dict:
    """The paged kernel at every pages-a-split value of the tuner's grid and
    at its default, against its plain version (``KERNEL_TOL``), in fp32 and
    bf16, with and without a window and a trash tail; timed at each, beside
    its plain version, its bound, one SDPA call over the gathered view and
    the whole wrapper the decode path calls."""
    from repro_torch.kernels.paged_attention.kernel import \
        default_pages_per_split
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the serving path's shapes: qwen2-1.5b decode at batch 8, page 16,
    # max_len 2048 (128 pages a slot); ragged lengths, one free slot
    B, KV, G, D, ps, n_pages = 8, 2, 6, 128, 16, 128
    kv_lens = [2048, 1999, 1500, 1024, 777, 300, 17, 0]
    default_pps = default_pages_per_split(B, KV, n_pages)
    grid = [c["pages_per_split"] for c in DEFAULT_CANDIDATES["paged_attention"]]
    gen = torch.Generator(device=DEV).manual_seed(0)
    max_err = 0.0
    main_case = None
    for dtype in (torch.float32, torch.bfloat16):
        for window, trash_tail in ((None, 0), (512, 1)):
            case, err = paged_timed_case(
                gen, B=B, KV=KV, G=G, D=D, ps=ps, n_pages=n_pages,
                kv_lens=kv_lens, dtype=dtype, window=window,
                trash_tail=trash_tail, grid=grid, default_pps=default_pps)
            max_err = max(max_err, err)
            if dtype == torch.bfloat16 and window is None:
                main_case = case      # what the bf16 serving path runs
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:101",
            "max_abs_err": max_err, "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "wrapper_ms": main_case["wrapper_ms"],
            "pages_per_split": default_pps,
            "ms_by_pages_per_split": main_case["ms_by_pages_per_split"],
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


def ssd_timed_case(gen, BC, H, Q, P, N, grid, model: str | None = None,
                   case_id: str | None = None) -> tuple[dict, float]:
    """One shape of the SSD kernel: every row tile of the tuner's grid and
    the default against its plain version (``SSD_TOL``), then timed at
    each beside its plain version and its bound.  Emits a ``kernels`` line
    and returns it with the largest error."""
    from repro_torch.kernels.ssd_scan import (ssd_intra_chunk_kernel,
                                              ssd_intra_chunk_plain)
    from repro_torch.kernels.ssd_scan.kernel import default_row_tile

    t0 = time.perf_counter()
    max_err = 0.0
    args = ssd_inputs(gen, BC, H, Q, P, N)
    y_p, S_p = ssd_intra_chunk_plain(*args)
    errs = {}
    for rt in [None, *grid]:
        y, S = ssd_intra_chunk_kernel(*args, row_tile=rt)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(S).all()):
            raise AssertionError(f"SSD kernel output not finite (BC "
                                 f"{BC}, Q {Q}, row_tile {rt})")
        err_y = float((y - y_p).abs().max())
        err_s = float((S - S_p).abs().max())
        e = {"max_abs_err": max(err_y, err_s),
             "y_rel_err": err_y / float(y_p.abs().max()),
             "S_rel_err": err_s / float(S_p.abs().max())}
        errs["default" if rt is None else str(rt)] = e
        if max(e["y_rel_err"], e["S_rel_err"]) > SSD_TOL:
            raise AssertionError(f"SSD kernel disagrees with plain at "
                                 f"row_tile {rt} (BC {BC}, H {H}, Q {Q}, N "
                                 f"{N}): {e}")
        max_err = max(max_err, e["max_abs_err"])
    case = {"shape": {"BC": BC, "H": H, "Q": Q, "P": P, "N": N},
            **errs["default"], "tol": SSD_TOL,
            "err_by_launch_shape": errs}
    # timing: rotate over input copies larger than the 50 MB L2, as in
    # a prefill chunk, where a layer's weights pass between launches
    in_bytes = sum(t.numel() * 4 for t in args)
    n_copies = max(2, math.ceil(100e6 / in_bytes))
    copies = [tuple(t.clone() for t in args) for _ in range(n_copies)]
    ms_by = {str(rt): cuda_ms(lambda i, rt=rt: ssd_intra_chunk_kernel(
        *copies[i % n_copies], row_tile=rt), 50) for rt in grid}
    ms = cuda_ms(lambda i: ssd_intra_chunk_kernel(
        *copies[i % n_copies]), 50)
    plain_ms = cuda_ms(lambda i: ssd_intra_chunk_plain(
        *copies[i % n_copies]), 10)
    bms, by = ssd_bound_ms(BC, H, Q, P, N)
    case.update(ms=ms, row_tile=default_row_tile(BC, H, Q, P, N),
                ms_by_launch_shape=ms_by, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, ms_over_bound=ms / bms,
                library_ms=None)
    extra = {} if model is None else {"model": model,
                                      "seconds": time.perf_counter() - t0}
    if case_id is not None:
        extra["case"] = case_id
    emit("kernels", kernel="ssd_scan", **extra, **case)
    del copies
    return case, max_err


def ssd_kernel_phase(n_layers: int) -> dict:
    """The SSD kernel at every row tile of the tuner's grid and at its
    default, against its plain version (``SSD_TOL``), at mamba2-370m's
    serving shapes and at mamba2's and zamba2's training shapes (and a
    TP=2 head shard of mamba2's, ``train_mamba2_tp2``: its fp32 inputs,
    as ``ssd_chunked`` casts them in bf16 training); timed at each, beside
    its plain version and its bound."""
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = [c["row_tile"] for c in DEFAULT_CANDIDATES["ssd_scan"]]
    gen = torch.Generator(device=DEV).manual_seed(2)
    main_case = None
    max_err = 0.0
    # mamba2-370m's serving shapes: one chunk at the largest and smallest
    # bucket, and eight chunks at once
    for BC, Q in ((1, 256), (1, 16), (8, 256)):
        case, err = ssd_timed_case(gen, BC, 32, Q, 64, 128, grid)
        max_err = max(max_err, err)
        if (BC, Q) == (1, 256):
            main_case = case        # what a full prefill chunk runs
    # training at seq 4096 and micro-batch 2: 32 chunks of 256 at once
    train = {}
    # and a TP=2 shard of mamba2's training mesh: 16 of its 32 heads
    for model, H, N, case_id in (
            ("mamba2-370m", 32, 128, "train_mamba2-370m"),
            ("zamba2-1.2b", 64, 64, "train_zamba2-1.2b"),
            ("mamba2-370m TP=2 shard", 16, 128, "train_mamba2_tp2")):
        case, err = ssd_timed_case(gen, 32, H, 256, 64, N, grid, model=model,
                                   case_id=case_id)
        max_err = max(max_err, err)
        train[model] = dict(case_summary(case, err), row_tile=case["row_tile"])
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:57",
            "max_abs_err": max_err, "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD "
                            "intra-chunk dual form",
            "row_tile": main_case["row_tile"],
            "ms_by_launch_shape": main_case["ms_by_launch_shape"],
            "launches_per_chunk": n_layers, "train_shapes": train}


# ---------------------------------------------------------------------------
# full-width parity and serving
# ---------------------------------------------------------------------------


def profile_decode(sched, cfg, rng, kernel_mod, n_steps: int = 8,
                   n_pairs: int = 4, phase: str = "profile",
                   paths_phase: str = "decode_step_paths") -> float:
    """Where a decode step's time goes: a full batch of long prompts is
    prefilled; then decode-only scheduler steps run, first ``n_pairs``
    pairs timed alternately through the kernel path and the plain gather
    path (``attn_impl`` "kernel" / "ref", in the order kernel, ref, ref,
    kernel, ...), then ``n_steps`` through the kernel path under
    ``torch.profiler``: device time by kernel name and the device's busy
    share of the window (kernel time summed over wall time).  Returns the
    paged device kernels the profiler saw a counted wrapper call in that
    window (2: the split pass and the merge pass)."""
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
    emit(paths_phase, batch=eng.batch, context="1000-1500 tokens",
         kernel_ms=step_ms["kernel"], ref_ms=step_ms["ref"],
         kernel_ms_median=float(np.median(step_ms["kernel"])),
         ref_ms_median=float(np.median(step_ms["ref"])))
    kernel_mod.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = kernel_mod.launches

    per_call = emit_profile(phase, prof, wall, "decode_steps", n_steps,
                            "step", focus="paged_", focus_calls=calls)
    if per_call != 2:
        raise AssertionError(f"{per_call} paged device kernels a wrapper "
                             f"call ({calls} calls profiled), expected 2")
    sched.run()
    return per_call


SERVE_MAX_NEW = 32


SERVE_REQUESTS = 16


def serve_trace(cfg, n_requests: int = SERVE_REQUESTS, rng=None):
    """The ``serve`` phase's draws, in its order: the two warm-up prompts,
    then ``n_requests`` prompt lengths in 64-1500 and their prompts, from
    ``rng`` (a fresh numpy seed 0 by default)."""
    rng = np.random.default_rng(0) if rng is None else rng
    warm = [rng.integers(0, cfg.vocab_size - 1, (n,)) for n in (64, 300)]
    lens = rng.integers(64, 1501, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (int(n),)) for n in lens]
    return warm, lens, prompts


class HostTimer:
    """Host seconds spent in the wrapped methods of one object."""

    def __init__(self, obj, names):
        self.seconds = 0.0
        self.calls = 0
        for name in names:
            setattr(obj, name, self._wrap(getattr(obj, name)))

    def _wrap(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return timed


def serve_hypar_phase(kernel_mod) -> None:
    """HyPar request placement against direct slot filling on the ``serve``
    phase's engine and trace: four runs in the order direct, hypar, hypar,
    direct, each a fresh ``ServeScheduler`` over one engine; then a fifth,
    hypar run in which slot 0 fails after the first decode step.  Streams
    must match request by request, launches equal decode steps x layers,
    and the tracker's graph and result records must be drained."""
    from repro_torch.configs import get_config
    from repro_torch.serve import (HyParRequestTracker, PagedEngine,
                                   ServeScheduler)
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")                    # bf16 compute
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=DEV)
    del params
    torch.cuda.empty_cache()
    warm, lens, prompts = serve_trace(cfg)
    sched = ServeScheduler(eng)
    for w in warm:
        sched.submit(w, max_new=2)
    sched.run()

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

    def tracker():
        return HyParRequestTracker(
            eng.batch, strategy="cost", flops_per_token=2.0 * cfg.n_params(),
            devices=[torch.device("cuda", 0)])

    def check_tracker(tr, n):
        recs = list(tr.store.records.values())
        if (tr.graph.n_jobs() != 0 or len(recs) != n
                or any(r.data is not None or r.sent_back for r in recs)
                or tr.master._fn_time.get(tr.DECODE_FN, 0.0) <= 0.0):
            raise AssertionError(
                f"tracker not drained: {tr.graph.n_jobs()} jobs, "
                f"{len(recs)} records, EWMA {tr.master._fn_time}")

    def one_run(engine: str, fail_after: int | None = None) -> dict:
        tr = tracker() if engine == "hypar" else None
        timer = (HostTimer(tr, ("place_batch", "observe", "finish",
                                "retire")) if tr is not None else None)
        sched = ServeScheduler(eng, tracker=tr)
        decode_s.clear()
        steps0 = eng.n_decode_calls
        kernel_mod.launches = 0
        victim = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            sched.submit(p, max_new=SERVE_MAX_NEW)
        if fail_after is not None:
            while sched.n_steps < fail_after:
                sched.step()
            victim = sched.fail_slot(0)
        results = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.n_decode_calls - steps0
        launches = kernel_mod.launches
        if len(results) != len(prompts) or any(
                r.n_generated != SERVE_MAX_NEW for r in results):
            raise AssertionError(f"{engine}: {len(results)} requests done, "
                                 f"{[r.n_generated for r in results]}")
        if launches != steps * cfg.n_layers:
            raise AssertionError(f"{engine}: kernel launches {launches} != "
                                 f"decode steps {steps} x {cfg.n_layers}")
        if tr is not None:
            check_tracker(tr, len(prompts))
        ttft = np.array([r.ttft_s for r in results])
        n_tok = sum(r.n_generated for r in results)
        return {"engine": engine, "wall_s": wall, "tok_per_s": n_tok / wall,
                "ttft_p50_s": float(np.percentile(ttft, 50)),
                "ttft_p95_s": float(np.percentile(ttft, 95)),
                "decode_steps": steps, "kernel_launches": launches,
                "decode_ms_per_step_p50": float(np.median(decode_s) * 1e3),
                "tracker_host_s": timer.seconds if timer else None,
                "tracker_calls": timer.calls if timer else None,
                "victim": victim, "n_recovered": (tr.n_recovered if tr
                                                  else None),
                "streams": {r.rid: r.tokens for r in results}}

    runs = [one_run(e) for e in ("direct", "hypar", "hypar", "direct")]
    failed = one_run("hypar", fail_after=1)
    eng.decode = decode
    want = runs[0]["streams"]
    for r in runs[1:] + [failed]:
        if r["streams"] != want:
            bad = [rid for rid in want if r["streams"].get(rid) != want[rid]]
            raise AssertionError(f"{r['engine']} streams differ from the "
                                 f"direct run's for requests {bad}")
    if failed["victim"] is None or failed["n_recovered"] != 1:
        raise AssertionError(f"fail_slot(0): victim {failed['victim']}, "
                             f"n_recovered {failed['n_recovered']}")
    direct = [r["tok_per_s"] for r in runs if r["engine"] == "direct"]
    hypar = [r["tok_per_s"] for r in runs if r["engine"] == "hypar"]
    overhead = 100.0 * (float(np.median(direct)) / float(np.median(hypar))
                        - 1.0)
    # the spread of the alternated runs: the overhead a pair of single
    # runs could show (most and least favourable pairing), and the
    # run-to-run spread of each engine
    lo = 100.0 * (min(direct) / max(hypar) - 1.0)
    hi = 100.0 * (max(direct) / min(hypar) - 1.0)
    spread = max(100.0 * (max(v) / min(v) - 1.0) for v in (direct, hypar))
    hyp_runs = [r for r in runs if r["engine"] == "hypar"]
    emit("serve_hypar", model=cfg.name, layers=cfg.n_layers,
         compute="bfloat16", batch=8, page_size=16, prefill_chunk=256,
         max_len=2048, requests=len(prompts),
         prompt_lens=[int(n) for n in lens], max_new=SERVE_MAX_NEW,
         strategy="cost", order="direct, hypar, hypar, direct",
         runs=[{k: v for k, v in r.items() if k != "streams"}
               for r in runs],
         failed_slot_run={k: v for k, v in failed.items()
                          if k != "streams"},
         hypar_overhead_pct=overhead, overhead_pct_pairings=[lo, hi],
         run_to_run_spread_pct=spread,
         overhead_resolved=abs(overhead) > spread,
         tracker_host_share_of_wall=float(np.mean(
             [r["tracker_host_s"] / r["wall_s"] for r in hyp_runs])),
         streams_identical=True)
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# device groups and the robustness layer
# ---------------------------------------------------------------------------


# the chaos plan of serve_groups and serve_groups_parity: group 1 fails at
# scheduler call 6 and its fault lasts 10 calls; at call 8, while it is
# down, group 0's decode wave reports GROUPS_SLOW_X watchdog budgets of
# extra time (injected into the measurement, never slept).  One call on
# one group keeps its trips below GROUPS_UNHEALTHY_AFTER, so the kill is
# the run's one failover.
GROUPS_KILL = (1, 6, 10)
GROUPS_SLOW = (8, 1)             # (first call, calls)
GROUPS_SLOW_GID = 0
GROUPS_SLOW_X = 10.0
GROUPS_BUDGET_X = 5.0            # watchdog budget / slowest fault-free step
GROUPS_UNHEALTHY_AFTER = 2
GROUPS_MAX_RESTARTS = 4
GROUPS_PARITY_LAYERS = 4         # serve_groups_parity: depth cut, widths kept
GROUPS_SHARED_PREFIX = 512       # qwen2 parity prompts longer than this share it


def groups_run(eng, prompts, mods, n_layers, *, device_groups: int,
               budget: float | None = None, prefix_cache: bool = False
               ) -> dict:
    """One drain of ``prompts`` (SERVE_MAX_NEW tokens each, greedy) by a
    fresh reserve-on-demand ``ServeScheduler`` over ``eng``; with
    ``budget`` under the chaos plan, the watchdog at that budget.  Each
    step is timed, the device synchronised around it; the launches of
    ``mods`` are set to 0 before and read after.  Fails unless every
    request completes, every group ends healthy and leak-free, and the
    paged kernel ran once a layer in every decode step (attention
    models)."""
    from repro_torch.core.fault import ServeChaosInjector
    from repro_torch.serve import ServeScheduler

    chaos = None
    if budget is not None:
        chaos = ServeChaosInjector(
            kill_group=GROUPS_KILL,
            slow=(*GROUPS_SLOW, GROUPS_SLOW_X * budget),
            slow_gid=GROUPS_SLOW_GID)
    sched = ServeScheduler(eng, reserve="demand",
                           device_groups=device_groups,
                           prefix_cache=prefix_cache, chaos=chaos,
                           watchdog_budget_s=budget,
                           unhealthy_after=GROUPS_UNHEALTHY_AFTER,
                           max_restarts=(GROUPS_MAX_RESTARTS if chaos
                                         else None))
    route = HostTimer(sched, ("_route_order",))
    probe = HostTimer(sched, ("_probe_groups",))
    steps = CallTimer(sched, ("step",))
    steps0, chunks0 = eng.n_decode_calls, eng.n_chunk_calls
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        sched.submit(p, max_new=SERVE_MAX_NEW)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    while not all(g.healthy for g in sched.groups):
        sched.step()                 # the recovery tail: probes rejoin
    launches = read_launches(mods)
    decode_steps = eng.n_decode_calls - steps0
    chunks = eng.n_chunk_calls - chunks0
    steps.restore()
    tag = (f"{eng.cfg.name}, {device_groups} group(s)"
           + (", chaos" if chaos else ""))
    outcomes = {o.outcome for o in sched.outcomes.values()}
    if len(results) != len(prompts) or outcomes != {"completed"}:
        raise AssertionError(f"{tag}: {len(results)} of {len(prompts)} "
                             f"requests completed, outcomes {outcomes}")
    if chaos is not None:
        chaos.release_pages(sched)
        if any(chaos.held_pages(g.gid) for g in sched.groups):
            raise AssertionError(f"{tag}: pressure pages still held")
    sched.flush_prefix_cache()
    leaks = [g.allocator.n_outstanding for g in sched.groups]
    if any(leaks):
        raise AssertionError(f"{tag}: pages outstanding after the drain "
                             f"{leaks}")
    if (eng.cfg.family != "ssm"
            and launches["paged_attention"] != decode_steps * n_layers):
        raise AssertionError(f"{tag}: paged kernel launched "
                             f"{launches['paged_attention']} times for "
                             f"{decode_steps} decode steps x {n_layers}")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    out = {"device_groups": device_groups, "chaos": chaos is not None,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p95_s": float(np.percentile(ttft, 95)),
           "step_s_max": float(max(steps.seconds["step"])),
           "step_ms_p50": steps.ms("step"),
           "decode_steps": decode_steps, "chunk_calls": chunks,
           "step_calls": sched.step_calls,
           "kernel_launches": launches,
           "route_host_s": route.seconds, "route_calls": route.calls,
           "probe_host_s": probe.seconds, "probe_calls": probe.calls,
           "group_occupancy": sched.group_occupancy,
           "watchdog_budget_s": budget,
           "watchdog_trips": sched.watchdog_trips,
           "group_failovers": sched.n_group_failovers,
           "group_rejoins": sched.n_group_rejoins,
           "n_failed": sched.n_failed,
           "resume_tokens_recomputed": sched.resume_tokens_recomputed,
           "prefix_hits": sched.n_prefix_hits,
           "streams": {r.rid: r.tokens for r in results}}
    if chaos is not None:
        out.update(kills=chaos.n_kills, slow_steps=chaos.n_slow_steps)
    return out


def check_chaos_run(run: dict, tag: str) -> None:
    """The plan's count of everything: one kill, one failover and one
    rejoin, and as many watchdog trips as the plan injected slow
    readings (none from the real step times)."""
    if (run["kills"] != 1 or run["group_failovers"] != 1
            or run["group_rejoins"] != 1 or run["slow_steps"] < 1
            or run["watchdog_trips"] != run["slow_steps"]):
        raise AssertionError(
            f"{tag}: kills {run['kills']}, failovers "
            f"{run['group_failovers']}, rejoins {run['group_rejoins']}, "
            f"trips {run['watchdog_trips']} for {run['slow_steps']} slow "
            f"readings")


def serve_groups_phase(kernel_mod) -> int:
    """Two device groups on the ``serve`` phase's engine settings and
    trace (qwen2-1.5b, 28 layers, bf16), reserve-on-demand: one group,
    two groups, then two groups under the chaos plan with the watchdog at
    GROUPS_BUDGET_X times the two-group run's slowest step.  Every
    request completes, both groups end leak-free, both groups serve in
    the fault-free two-group run, the chaos run fails over and rejoins
    once with the plan's watchdog trips, and the paged kernel runs 28
    times a decode step.  The bf16 streams equal to the one-group run's
    are counted, not gated: a recomputed prefix runs the chunk path.
    Returns the paged kernel's launches in the three runs."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedEngine
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")                    # bf16 compute
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=DEV)
    del params
    torch.cuda.empty_cache()
    warm, lens, prompts = serve_trace(cfg)
    mods = (kernel_mod,)
    groups_run(eng, warm, mods, cfg.n_layers, device_groups=2)
    one = groups_run(eng, prompts, mods, cfg.n_layers, device_groups=1)
    two = groups_run(eng, prompts, mods, cfg.n_layers, device_groups=2)
    if not all(x > 0.0 for x in two["group_occupancy"]):
        raise AssertionError(f"serve_groups: a group served nothing "
                             f"{two['group_occupancy']}")
    budget = GROUPS_BUDGET_X * two["step_s_max"]
    chaos = groups_run(eng, prompts, mods, cfg.n_layers, device_groups=2,
                       budget=budget)
    check_chaos_run(chaos, "serve_groups")
    want = one["streams"]
    runs = [one, two, chaos]
    emit("serve_groups", model=cfg.name, layers=cfg.n_layers,
         compute="bfloat16", batch=8, page_size=16, prefill_chunk=256,
         max_len=2048, reserve="demand", requests=len(prompts),
         prompt_lens=[int(n) for n in lens], max_new=SERVE_MAX_NEW,
         plan={"kill_group": GROUPS_KILL, "slow": [*GROUPS_SLOW],
               "slow_gid": GROUPS_SLOW_GID, "slow_x_budget": GROUPS_SLOW_X,
               "budget_x_slowest_step": GROUPS_BUDGET_X,
               "unhealthy_after": GROUPS_UNHEALTHY_AFTER,
               "max_restarts": GROUPS_MAX_RESTARTS},
         runs=[{k: v for k, v in r.items() if k != "streams"}
               for r in runs],
         streams_equal_to_one_group=[
             sum(r["streams"][rid] == toks for rid, toks in want.items())
             for r in runs[1:]])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return sum(r["kernel_launches"]["paged_attention"] for r in runs)


def serve_groups_parity_phase(mods) -> dict:
    """The chaos plan at fp32, where recompute must be exact:
    qwen2-1.5b (prefix cache on, prompts longer than
    GROUPS_SHARED_PREFIX opening with one shared prefix) and mamba2-370m,
    full width cut to GROUPS_PARITY_LAYERS layers, the ``serve`` engine
    settings and trace.  Every stream of the two-group chaos run must
    equal the fault-free one-group run's (no prefix cache there), and
    mamba2's SSD kernel must run once a layer in every prefill chunk,
    re-prefills included.  Returns the launches of each kernel in the
    runs."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedEngine
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    total: dict = {}
    for arch in ("qwen2-1.5b", "mamba2-370m"):
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=GROUPS_PARITY_LAYERS,
                                  compute_dtype="float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(2),
                             DEV)
        eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                          prefill_chunk=256, device=DEV)
        del params
        warm, lens, prompts = serve_trace(cfg)
        attn = arch.startswith("qwen2")
        if attn:
            prefix = prompts[0][:GROUPS_SHARED_PREFIX]
            prompts = [np.concatenate([prefix, p[GROUPS_SHARED_PREFIX:]])
                       if len(p) > GROUPS_SHARED_PREFIX else p
                       for p in prompts]
        groups_run(eng, warm, mods, GROUPS_PARITY_LAYERS, device_groups=2)
        ref = groups_run(eng, prompts, mods, GROUPS_PARITY_LAYERS,
                         device_groups=1)
        two = groups_run(eng, prompts, mods, GROUPS_PARITY_LAYERS,
                         device_groups=2, prefix_cache=attn)
        chaos = groups_run(eng, prompts, mods, GROUPS_PARITY_LAYERS,
                           device_groups=2, prefix_cache=attn,
                           budget=GROUPS_BUDGET_X * two["step_s_max"])
        want = ref["streams"]
        bad = {name: [rid for rid in want if r["streams"].get(rid)
                      != want[rid]]
               for name, r in (("two_groups", two), ("chaos", chaos))}
        ssd_ok = all(r["kernel_launches"]["ssd_scan"]
                     == r["chunk_calls"] * GROUPS_PARITY_LAYERS
                     for r in (ref, two, chaos)) if not attn else True
        emit("serve_groups_parity", model=cfg.name,
             layers=GROUPS_PARITY_LAYERS, compute="float32",
             requests=len(prompts), max_new=SERVE_MAX_NEW,
             prefix_cache=attn,
             runs=[{k: v for k, v in r.items() if k != "streams"}
                   for r in (ref, two, chaos)],
             streams_identical=not any(bad.values()), mismatches=bad)
        if any(bad.values()):
            raise AssertionError(f"serve_groups_parity {cfg.name}: streams "
                                 f"differ from the one-group run: {bad}")
        if not ssd_ok:
            raise AssertionError(f"serve_groups_parity {cfg.name}: SSD "
                                 f"launches differ from chunk calls x "
                                 f"{GROUPS_PARITY_LAYERS}")
        check_chaos_run(chaos, f"serve_groups_parity {cfg.name}")
        for r in (ref, two, chaos):
            for name, n in r["kernel_launches"].items():
                total[name] = total.get(name, 0) + n
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return total


# the serving mesh (DESIGN.md §13): qwen2-1.5b at full width on a (dp, tp)
# grid whose every position is the one card, against the meshless engine
MESH_ARCH = "qwen2-1.5b"
MESH_LAYERS = 8                             # qwen2's depth cut, of 28
MESH_SSM_ARCH = "mamba2-370m"
MESH_MOE_ARCH = "qwen2-moe-a2.7b"
MESH_MOE_FP32_LAYERS = 4                    # its fp32 gate's depth cut
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))      # (tp, dp)
MESH_REQUESTS = 8
MESH_PROMPT_RANGE = (64, 512)
MESH_NEW = 16
MESH_TF_STEPS = 8                           # teacher-forced decode steps
MESH_MAX_LEN = 1024
# the paged kernel at a TP=2 position of qwen2-1.5b's decode (12 query
# and 2 KV heads split in two), contexts of 1,000-1,500 tokens
MESH_SHARD_LENS = [1500, 1431, 1362, 1293, 1224, 1155, 1086, 1000]


def mesh_engine(cfg, params, shape):
    """A ``PagedEngine`` (batch 8, page 16, chunk 256, max_len 1,024)
    without a mesh (``shape`` None) or on a ``shape`` = (tp, dp) mesh
    whose every position is the card."""
    from repro_torch.serve import PagedEngine
    from repro_torch.serve.mesh import MeshSpec, build_serve_mesh

    mesh = None
    if shape is not None:
        spec = MeshSpec(*shape)
        mesh = build_serve_mesh(spec, devices=[torch.device(DEV)]
                                * spec.size)
    return PagedEngine(cfg, params, batch=8, max_len=MESH_MAX_LEN,
                       page_size=16, prefill_chunk=256, mesh=mesh,
                       device=DEV)


def mesh_run(eng, prompts, mods, dp: int) -> dict:
    """One drain of ``prompts`` (MESH_NEW greedy tokens each) by a fresh
    ``ServeScheduler`` with ``dp`` device groups, the launches of ``mods``
    set to 0 just before and read just after.  Fails unless every request
    gets its tokens and no group leaks a page."""
    from repro_torch.serve import ServeScheduler

    sched = ServeScheduler(eng, device_groups=dp)
    steps0, chunks0 = eng.n_decode_calls, eng.n_chunk_calls
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        sched.submit(p, max_new=MESH_NEW)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(mods)
    tag = f"{eng.cfg.name} mesh {getattr(eng.mesh, 'spec', None)}"
    if (len(results) != len(prompts)
            or any(r.n_generated != MESH_NEW for r in results)):
        raise AssertionError(f"{tag}: {len(results)} of {len(prompts)} "
                             f"requests, tokens "
                             f"{[r.n_generated for r in results]}")
    leaks = [g.allocator.n_outstanding for g in sched.groups]
    if any(leaks):
        raise AssertionError(f"{tag}: pages outstanding {leaks}")
    n_tok = sum(r.n_generated for r in results)
    return {"streams": {r.rid: list(r.tokens) for r in results},
            "decode_steps": eng.n_decode_calls - steps0,
            "chunk_calls": eng.n_chunk_calls - chunks0,
            "launches": launches, "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_s": float(np.median([r.ttft_s for r in results]))}


def mesh_teacher_forced(eng, prompts, forced=None):
    """Each prompt inserted into its slot (pages from its DP=2 row's range,
    which every mesh of the phase accepts), then MESH_TF_STEPS decode steps
    fed ``forced`` (steps x batch tokens; the engine's own greedy tokens
    when None).  Returns the chunk logits (batch, V), the decode logits
    (steps, batch, V) and the tokens fed."""
    from repro_torch.serve.mesh import row_ranges

    nxt = {r: rows[1].start for r, rows in
           enumerate(row_ranges(eng.batch, eng.num_pages, 2))}
    half = -(-eng.batch // 2)
    firsts = []
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            r = 0 if slot < half else 1
            n = eng.pages_needed(len(p), MESH_TF_STEPS + 1)
            pages = list(range(nxt[r], nxt[r] + n))
            nxt[r] += n
            firsts.append(eng.insert(slot, p, page_ids=pages,
                                     max_new=MESH_TF_STEPS + 1)[:, -1])
        chunk = torch.cat(firsts).float()
        toks = chunk.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        decode, fed = [], []
        for i in range(MESH_TF_STEPS):
            if forced is not None:
                toks = forced[i]
            fed.append(toks.copy())
            lg = eng.decode(toks)[:, -1].float()
            decode.append(lg)
            toks = lg.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
    return chunk, torch.stack(decode), fed


def mesh_kernel_case() -> dict:
    """The paged kernel at the TP=2 position's shape (bf16, B 8, KV 1, G 6,
    D 128, page 16, contexts 1,000-1,500) against its plain version, timed
    beside its bound, its plain version and SDPA (``paged_timed_case``)."""
    from repro_torch.kernels.paged_attention.kernel import \
        default_pages_per_split
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(28)
    grid = [c["pages_per_split"]
            for c in DEFAULT_CANDIDATES["paged_attention"]]
    case, err = paged_timed_case(
        gen, B=8, KV=1, G=6, D=128, ps=16, n_pages=96,
        kv_lens=MESH_SHARD_LENS, dtype=torch.bfloat16, window=None,
        trash_tail=0, grid=grid, default_pps=default_pages_per_split(8, 1,
                                                                     96),
        model=f"{MESH_ARCH} TP=2 position")
    return dict(case_summary(case, err),
                pages_per_split=case["pages_per_split"],
                ms_by_pages_per_split=case["ms_by_pages_per_split"])


def mesh_weight_bytes(eng) -> list[dict]:
    """Row 0's weight bytes by grid position: the lead's own copy of the
    model (``lead_params``), then each position's attention heads,
    experts and vocabulary rows, and the lead's expert bytes."""
    from repro_torch.models.moe import EXPERT_KEYS
    from repro_torch.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    row = eng.rows[0]
    out = [{"lead_params": 0, "attention": 0, "experts": 0, "vocab": 0}
           for _ in row.devices]
    out[0]["lead_params"] = nbytes(row.params)
    out[0]["lead_experts"] = sum(
        nbytes(p["moe"][k]) for p in row.params["layers"] if "moe" in p
        for k in EXPERT_KEYS if k in p["moe"])
    if len(row.shards) > 1:        # one shard holds the lead's own heads
        for i, sh in enumerate(row.shards):
            out[i]["attention"] = nbytes(sh.attn)
    for _, shards in row.split.experts.values():
        for i, (p_s, _) in enumerate(shards):
            out[i]["experts"] += nbytes(p_s)
    for i, (rows, _, _) in enumerate(row.split.vocab or []):
        out[i]["vocab"] = nbytes(rows)
    return out


def serve_mesh_moe(mods, prompts) -> tuple[dict, list, int]:
    """qwen2-moe-a2.7b at TP=2 against no mesh: its experts split 30 / 30
    and its vocabulary in halves.  fp32 at ``MESH_MOE_FP32_LAYERS``
    layers: streams equal to the meshless run's, paged launches decode
    steps x layers x 2, 8 teacher-forced decode steps' logits reported
    beside the meshless ones; bf16 at full depth: tok/s of both, each
    position's weight bytes, the lead holding no expert, each position's
    expert bytes the specs'.  Returns ``(line, failures, paged
    launches)``."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import EXPERT_KEYS
    from repro_torch.parallel import DEFAULT_RULES, ShardingRules
    from repro_torch.parallel.partition import spec_bytes
    from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
    from repro_torch.weights import init_params

    failures, paged = [], 0
    cfg = dataclasses.replace(get_config(MESH_MOE_ARCH),
                              n_layers=MESH_MOE_FP32_LAYERS,
                              compute_dtype="float32")
    prompts = [p % cfg.vocab_size for p in prompts]
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(28),
                         DEV)
    fp32 = {}
    for name, shape in (("none", None), ("2,1", (2, 1))):
        eng = mesh_engine(cfg, params, shape)
        run = mesh_run(eng, prompts, mods, 1)
        chunk, decode, fed = mesh_teacher_forced(
            eng, prompts, None if name == "none" else fp32["none"]["fed"])
        fp32[name] = {**run, "chunk": chunk, "decode": decode, "fed": fed}
        paged += run["launches"]["paged_attention"]
        want = run["decode_steps"] * cfg.n_layers * (1 if shape is None
                                                     else 2)
        if run["launches"]["paged_attention"] != want:
            failures.append(f"{cfg.name} fp32 {name}: paged launches "
                            f"{run['launches']['paged_attention']} != "
                            f"{want}")
        del eng
    ref, tp2 = fp32["none"], fp32["2,1"]
    scale = float(ref["decode"].abs().max())
    line = {"model": cfg.name, "fp32": {
        "layers": cfg.n_layers,
        **{name: {k: r[k] for k in ("decode_steps", "chunk_calls",
                                    "launches", "wall_s", "tok_per_s")}
           for name, r in fp32.items()},
        "streams_equal": tp2["streams"] == ref["streams"],
        "chunk_max_rel_logit_err": float(
            (tp2["chunk"] - ref["chunk"]).abs().max()) / scale,
        "decode_max_rel_logit_err": float(
            (tp2["decode"] - ref["decode"]).abs().max()) / scale}}
    if not line["fp32"]["streams_equal"]:
        failures.append(f"{cfg.name} fp32 TP=2: streams differ")
    del fp32, ref, tp2, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(MESH_MOE_ARCH)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(28),
                         DEV, cast=True)
    experts = {"layers": [{"moe": {k: p["moe"][k] for k in EXPERT_KEYS}}
                          for p in params["layers"]]}
    row_mesh = build_serve_mesh(MeshSpec(2, 1), devices=[torch.device(DEV)]
                                * 2)
    want_experts = spec_bytes(experts, ShardingRules(row_mesh,
                                                     dict(DEFAULT_RULES)))
    del experts
    bf16 = {}
    for name, shape in (("none", None), ("2,1", (2, 1))):
        eng = mesh_engine(cfg, params, shape)
        if shape is not None:
            del params           # the lead keeps no expert: free the drawn
            gc.collect()         # ones, the positions hold their copies
            torch.cuda.empty_cache()
        mesh_run(eng, prompts[:2], mods, 1)             # warm-up
        run = mesh_run(eng, prompts, mods, 1)
        paged += run["launches"]["paged_attention"]
        bf16[name] = {**{k: run[k] for k in ("decode_steps", "launches",
                                             "wall_s", "tok_per_s",
                                             "ttft_p50_s")},
                      "streams": run["streams"],
                      "weight_bytes_by_position": mesh_weight_bytes(eng),
                      "memory_allocated_gib":
                          torch.cuda.memory_allocated() / 2**30}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    by_pos = bf16["2,1"]["weight_bytes_by_position"]
    line["bf16"] = {
        "layers": cfg.n_layers, "expert_spec_bytes": want_experts,
        **{name: {k: v for k, v in r.items() if k != "streams"}
           for name, r in bf16.items()},
        "streams_equal_to_no_mesh": sum(
            bf16["2,1"]["streams"][rid] == toks
            for rid, toks in bf16["none"]["streams"].items())}
    if by_pos[0]["lead_experts"]:
        failures.append(f"{cfg.name} TP=2: the lead holds "
                        f"{by_pos[0]['lead_experts']} bytes of experts")
    if [p["experts"] for p in by_pos] != [want_experts] * 2:
        failures.append(f"{cfg.name} TP=2: expert bytes "
                        f"{[p['experts'] for p in by_pos]}, the specs' "
                        f"{want_experts}")
    return line, failures, paged


def serve_mesh_phase(mods) -> dict:
    """The serving mesh on the card, every grid position on it
    (``devices=[cuda:0] * size``), against the meshless engine:

    * qwen2-1.5b (8 of its 28 layers, ``MESH_LAYERS``; its vocabulary
      split at TP=2) in fp32 compute (TF32 off) at TP=2, DP=2 and
      TP=2 x DP=2: MESH_REQUESTS prompts of 64-512 tokens (numpy seed 28),
      MESH_NEW greedy tokens through ``ServeScheduler`` with ``dp`` device
      groups — streams equal to the meshless run's, every request its
      tokens, no page leaked, the paged kernel launched decode steps x 28
      x tp x dp times; then MESH_TF_STEPS teacher-forced decode steps fed
      the meshless engine's tokens, chunk and decode logits within
      PARITY_TOL of max|logit|; TP=2's ``per_device_pool_bytes`` half of
      the meshless engine's;
    * bf16 compute: a 1 x 1 mesh's streams and teacher-forced logits
      bit-equal to no mesh; TP=2's tok/s and stream agreement beside the
      meshless run's, reported (partial sums in bf16 may flip a token);
    * qwen2-moe-a2.7b at TP=2 (``serve_mesh_moe``): fp32 streams at 4
      layers equal to the meshless run's; bf16 at full depth: tok/s, each
      position's weight bytes, no expert on the lead;
    * mamba2-370m (48 layers, fp32) at DP=2: streams equal to the
      meshless run's, the SSD kernel launched chunk calls x 48 times.

    Returns the phase's paged and SSD launches."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = {"paged_attention": 0, "ssd_scan": 0}
    rng = np.random.default_rng(28)
    lo, hi = MESH_PROMPT_RANGE
    lens = rng.integers(lo, hi + 1, MESH_REQUESTS)
    out: dict = {"prompt_lens": [int(n) for n in lens]}
    failures = []

    # fp32: every mesh against no mesh
    cfg = dataclasses.replace(get_config(MESH_ARCH), compute_dtype="float32",
                              n_layers=MESH_LAYERS)
    n_layers = cfg.n_layers
    prompts = [rng.integers(0, cfg.vocab_size - 1, (int(n),)).astype(
        np.int32) for n in lens]
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(28),
                         DEV)
    eng = mesh_engine(cfg, params, None)
    mesh_run(eng, prompts[:2], mods, 1)                 # warm-up
    base = mesh_run(eng, prompts, mods, 1)
    base_chunk, base_decode, fed = mesh_teacher_forced(eng, prompts)
    base_bytes = eng.per_device_pool_bytes()
    scale = float(base_decode.abs().max())
    total["paged_attention"] += base["launches"]["paged_attention"]
    if base["launches"]["paged_attention"] != base["decode_steps"] * n_layers:
        failures.append(f"fp32 no mesh: paged launches "
                        f"{base['launches']['paged_attention']} != "
                        f"{base['decode_steps']} x {n_layers}")
    runs = [{"mesh": None, **{k: v for k, v in base.items()
                              if k != "streams"},
             "per_device_pool_bytes": base_bytes}]
    del eng
    for tp, dp in MESH_SHAPES:
        eng = mesh_engine(cfg, params, (tp, dp))
        run = mesh_run(eng, prompts, mods, dp)
        chunk, decode, _ = mesh_teacher_forced(eng, prompts, fed)
        want_launches = run["decode_steps"] * cfg.n_layers * tp * dp
        row = {"mesh": f"{tp},{dp}",
               **{k: v for k, v in run.items() if k != "streams"},
               "expected_paged_launches": want_launches,
               "per_device_pool_bytes": eng.per_device_pool_bytes(),
               "total_pool_bytes": eng.total_pool_bytes(),
               "streams_equal": run["streams"] == base["streams"],
               "chunk_max_rel_logit_err": float(
                   (chunk - base_chunk).abs().max()) / scale,
               "decode_max_rel_logit_err": float(
                   (decode - base_decode).abs().max()) / scale}
        runs.append(row)
        total["paged_attention"] += run["launches"]["paged_attention"]
        if not row["streams_equal"]:
            failures.append(f"fp32 {tp},{dp}: streams differ")
        if run["launches"]["paged_attention"] != want_launches:
            failures.append(f"fp32 {tp},{dp}: paged launches "
                            f"{run['launches']['paged_attention']} != "
                            f"{want_launches}")
        if max(row["chunk_max_rel_logit_err"],
               row["decode_max_rel_logit_err"]) > PARITY_TOL:
            failures.append(f"fp32 {tp},{dp}: logits past {PARITY_TOL}")
        if (tp, dp) == (2, 1) and 2 * row["per_device_pool_bytes"] \
                != base_bytes:
            failures.append(f"TP=2 per-position pool bytes "
                            f"{row['per_device_pool_bytes']} not half of "
                            f"{base_bytes}")
        del eng
        gc.collect()
    out["fp32"] = runs
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: a 1 x 1 mesh is no mesh, bit for bit; TP=2 reported
    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=MESH_LAYERS)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(28),
                         DEV, cast=True)
    bf16 = {}
    for name, shape, dp in (("none", None, 1), ("1,1", (1, 1), 1),
                            ("2,1", (2, 1), 1)):
        eng = mesh_engine(cfg, params, shape)
        mesh_run(eng, prompts[:2], mods, dp)            # warm-up
        run = mesh_run(eng, prompts, mods, dp)
        chunk, decode, fed = mesh_teacher_forced(
            eng, prompts, None if name == "none" else bf16["none"]["fed"])
        bf16[name] = {**run, "chunk": chunk, "decode": decode, "fed": fed}
        del eng
    ref = bf16["none"]
    one = bf16["1,1"]
    out["bf16"] = {
        name: {"tok_per_s": r["tok_per_s"], "wall_s": r["wall_s"],
               "decode_steps": r["decode_steps"],
               "paged_launches": r["launches"]["paged_attention"],
               "streams_equal_to_no_mesh": sum(
                   r["streams"][rid] == toks
                   for rid, toks in ref["streams"].items())}
        for name, r in bf16.items()}
    out["bf16"]["1,1"]["logits_bit_equal"] = bool(
        torch.equal(one["chunk"], ref["chunk"])
        and torch.equal(one["decode"], ref["decode"]))
    out["bf16"]["2,1"]["decode_max_rel_logit_err"] = float(
        (bf16["2,1"]["decode"] - ref["decode"]).abs().max()
        / ref["decode"].abs().max())
    for r in bf16.values():
        total["paged_attention"] += r["launches"]["paged_attention"]
    if one["streams"] != ref["streams"] \
            or not out["bf16"]["1,1"]["logits_bit_equal"]:
        failures.append("bf16 1,1 mesh not bit-equal to no mesh")
    del bf16, ref, one, params
    gc.collect()
    torch.cuda.empty_cache()

    out["moe"], fails, n = serve_mesh_moe(mods, prompts)
    failures += fails
    total["paged_attention"] += n
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-370m at DP=2: the SSD kernel on each row's chunks
    cfg = dataclasses.replace(get_config(MESH_SSM_ARCH),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(28),
                         DEV)
    ssm_prompts = [p % cfg.vocab_size for p in prompts]
    ssm = {}
    for name, shape, dp in (("none", None, 1), ("1,2", (1, 2), 2)):
        eng = mesh_engine(cfg, params, shape)
        ssm[name] = mesh_run(eng, ssm_prompts, mods, dp)
        del eng
    dp2 = ssm["1,2"]
    out["ssm"] = {"model": cfg.name, "layers": cfg.n_layers,
                  "compute": "float32",
                  **{name: {k: v for k, v in r.items() if k != "streams"}
                     for name, r in ssm.items()},
                  "streams_equal": dp2["streams"] == ssm["none"]["streams"],
                  "expected_ssd_launches": dp2["chunk_calls"] * cfg.n_layers}
    total["ssd_scan"] += sum(r["launches"]["ssd_scan"] for r in ssm.values())
    if not out["ssm"]["streams_equal"]:
        failures.append("mamba2 DP=2 streams differ")
    if dp2["launches"]["ssd_scan"] != dp2["chunk_calls"] * cfg.n_layers:
        failures.append(f"mamba2 DP=2 SSD launches "
                        f"{dp2['launches']['ssd_scan']} != "
                        f"{dp2['chunk_calls']} x {cfg.n_layers}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    emit("serve_mesh", model=MESH_ARCH, layers=n_layers,
         depth_cut=f"{n_layers} of {get_config(MESH_ARCH).n_layers}",
         batch=8,
         page_size=16,
         prefill_chunk=256, max_len=MESH_MAX_LEN, requests=MESH_REQUESTS,
         max_new=MESH_NEW, teacher_forced_steps=MESH_TF_STEPS,
         devices=f"{DEV} at every position", tol=PARITY_TOL, **out,
         failures=failures, seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError(f"serve_mesh: {failures}")
    return total


# ---------------------------------------------------------------------------
# the dense engine: waves, the dense trace, dense against paged
# ---------------------------------------------------------------------------


WAVES = 4                        # wave 0 pays the one-time costs
WAVE_BATCH = 8
WAVE_PROMPT = 1024
WAVE_NEW = 32
WAVE_PROFILED_STEPS = 4
DVP_LAYERS = 4                   # dense_vs_paged: depth cut, widths kept
DVP_LENS = (700, 64, 300, 1000, 129, 513, 17, 256)
DVP_MAX_NEW = 16


class CallTimer:
    """Wall seconds of each call of the wrapped methods of one object, the
    device synchronised before and after; ``restore`` unwraps them."""

    def __init__(self, obj, names):
        self.obj = obj
        self.original = {name: getattr(obj, name) for name in names}
        self.seconds = {name: [] for name in names}
        for name in names:
            setattr(obj, name, self._wrap(name))

    def _wrap(self, name):
        fn = self.original[name]

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return timed

    def ms(self, name, skip: int = 0) -> float:
        return float(np.median(self.seconds[name][skip:]) * 1e3)

    def restore(self) -> None:
        for name, fn in self.original.items():
            setattr(self.obj, name, fn)


def prefill_check(cfg, params, prompts, max_len: int, plain: str) -> dict:
    """A batched prefill of ``prompts`` from a fresh dense cache through
    ``decode_step(impl="auto")`` (the path's kernel) and ``impl=plain``:
    the last-token logits' largest difference over max|logit| and the
    greedy tokens' agreement."""
    from repro_torch.models.transformer import decode_step, init_cache

    toks = torch.tensor(prompts, device=DEV)
    out = {}
    for impl in ("auto", plain):
        cache = init_cache(cfg, toks.shape[0], max_len, device=DEV)
        with torch.no_grad():
            lg, cache = decode_step(cfg, params, cache, toks, impl=impl,
                                    valid_len=toks.shape[1])
        out[impl] = lg[:, -1].float()
        del cache, lg
    got, want = out["auto"], out[plain]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: kernel-path prefill logits not "
                             f"finite")
    return {"compute": cfg.compute_dtype,
            "max_rel_logit_err": float((got - want).abs().max()
                                       / want.abs().max()),
            "greedy_token_match": float(
                (got.argmax(-1) == want.argmax(-1)).float().mean())}


def layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, SSM layers) of a model: every invocation of a
    shared block counts as an attention layer."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    return len(kinds) - kinds.count("ssm"), kinds.count("ssm")


def serve_waves_phase(arch: str, mods, plain: str, phase: str, *,
                      waves: int = WAVES, max_new: int = WAVE_NEW,
                      check_layers: int | None = None,
                      prompt: int = WAVE_PROMPT) -> dict:
    """The launcher's wave mode at full width: ``Engine(batch 8, max_len
    prompt + max_new + 8)`` generates ``waves`` waves of 8 prompts of
    ``prompt`` tokens (1,024 by default; numpy seed 0), ``max_new`` greedy
    tokens each; wave 0 pays the one-time costs.  First the
    kernel-vs-plain check of a batched prefill at the wave's shape (fp32 compute on fp32 weights, gated at
    ``PARITY_TOL``; the engine's bf16, reported) — on the model itself, or,
    with ``check_layers``, on its depth cut to that many layers with fp32
    weights of its own, the engine's weights then drawn in bf16 (qwen2-moe's
    fp32 weights and their bf16 copy would not fit the card together);
    then the waves, with the launch counts set to 0 just before and read
    just after: the flash forward must launch once an attention layer a
    wave and the SSD kernel once an SSM layer a wave; then a few decode
    steps under ``torch.profiler``.  Returns the kernels' launches in the
    waves."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, count_generated
    from repro_torch.weights import init_params

    cfg = get_config(arch)                            # bf16 compute
    n_attn, n_ssm = layer_counts(cfg)
    rng = np.random.default_rng(0)
    prompts_by_wave = [rng.integers(0, cfg.vocab_size - 1,
                                    (WAVE_BATCH, prompt)
                                    ).astype(np.int32) for _ in range(waves)]
    max_len = prompt + max_new + 8
    if check_layers is None:
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             DEV)
        checks = [prefill_check(dataclasses.replace(
            cfg, compute_dtype="float32"), params, prompts_by_wave[0],
            max_len, plain)]
    else:
        cut = dataclasses.replace(cfg, n_layers=check_layers,
                                  compute_dtype="float32")
        params = init_params(cut, torch.Generator(device=DEV).manual_seed(1),
                             DEV)
        checks = [dict(prefill_check(cut, params, prompts_by_wave[0],
                                     max_len, plain), layers=check_layers)]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
    eng = Engine(cfg, params, batch=WAVE_BATCH, max_len=max_len, device=DEV)
    del params                     # the engine holds its bf16 copy
    gc.collect()
    torch.cuda.empty_cache()
    checks.append(prefill_check(cfg, eng.params, prompts_by_wave[0], max_len,
                                plain))
    if checks[0]["max_rel_logit_err"] > PARITY_TOL:
        raise AssertionError(f"{phase}: kernel-path prefill logits differ "
                             f"from impl={plain!r}: {checks[0]}")
    torch.cuda.reset_peak_memory_stats()

    timer = CallTimer(eng, ("prefill", "decode"))
    seconds, tokens = [], []
    reset_launches(mods)
    for prompts in prompts_by_wave:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new)
        seconds.append(time.perf_counter() - t0)
        tokens.append(count_generated(out, -1))
        if out.shape != (WAVE_BATCH, max_new) or not (
                (out >= 0) & (out < cfg.padded_vocab)).all():
            raise AssertionError(f"{phase}: generated {out.shape}, ids "
                                 f"[{out.min()}, {out.max()}]")
    launches = read_launches(mods)
    timer.restore()
    expected = {"flash_attention": waves * n_attn, "ssd_scan": waves * n_ssm}
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"{phase}: {name} launched {launches[name]} "
                                 f"times, expected {waves} waves x "
                                 f"{n // waves} layers")
    steady_s = sum(seconds[1:])
    n_decode = len(timer.seconds["decode"]) // waves

    # where a decode step's time goes: a few more steps of the last wave's
    # cache under the profiler
    toks = out[:, -1:]
    eng.decode(toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WAVE_PROFILED_STEPS):
            eng.decode(toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit(phase, model=cfg.name, layers=cfg.n_layers,
         attention_layers=n_attn, ssm_layers=n_ssm, compute="bfloat16",
         batch=WAVE_BATCH, prompt_len=prompt, max_new=max_new,
         max_len=max_len, waves=waves, wave_s=seconds,
         steady_tokens=sum(tokens[1:]), steady_s=steady_s,
         steady_tok_per_s=sum(tokens[1:]) / steady_s,
         prefill_ms_p50=timer.ms("prefill", skip=1),
         decode_ms_per_step_p50=timer.ms("decode", skip=n_decode),
         kernels=[name for name, n in expected.items() if n],
         kernel_launches={name: launches[name] for name in expected},
         kernel_launches_per_wave={name: launches[name] / waves
                                   for name in expected},
         trace_counts={name: eng.trace_count(name)
                       for name in ("prefill", "decode", "splice")},
         kernel_vs_plain=checks, plain_impl=plain, tol=PARITY_TOL,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit_profile(f"profile_{phase}", prof, wall, "decode_steps",
                 WAVE_PROFILED_STEPS, "step")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {name: launches[name] for name in expected}


def serve_dense_trace_phase(mods, paged: dict) -> int:
    """``ServeScheduler`` over the dense ``Engine`` on the ``serve``
    phase's 16-request trace, at its widths and batch: every request gets
    its 32 tokens, each insert runs the flash forward once a layer (the
    counts set to 0 just before the trace and read just after), and tok/s,
    TTFT and the decode step stand beside the paged ``serve`` phase's from
    this run.  Returns the flash forward's launches."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, ServeScheduler
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")                    # bf16 compute
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    eng = Engine(cfg, params, batch=8, max_len=2048, device=DEV)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    warm, lens, prompts = serve_trace(cfg)
    sched = ServeScheduler(eng)
    for w in warm:
        sched.submit(w, max_new=2)
    sched.run()
    sched.reset_metrics()

    timer = CallTimer(eng, ("insert", "decode"))
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        sched.submit(p, max_new=SERVE_MAX_NEW)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(mods)["flash_attention"]
    timer.restore()
    inserts = len(timer.seconds["insert"])

    if len(results) != len(prompts) or any(
            r.n_generated != SERVE_MAX_NEW for r in results):
        raise AssertionError(f"serve_dense_trace: {len(results)} requests "
                             f"done, {[r.n_generated for r in results]}")
    if any(o.outcome != "completed" for o in sched.outcomes.values()):
        raise AssertionError(f"outcomes {sched.outcomes}")
    if inserts != len(prompts) or launches != inserts * cfg.n_layers:
        raise AssertionError(f"serve_dense_trace: flash launched {launches} "
                             f"times in {inserts} inserts x {cfg.n_layers}")
    if not all(0 <= t < cfg.padded_vocab for r in results for t in r.tokens):
        raise AssertionError("a token id falls outside the vocabulary")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    emit("serve_dense_trace", model=cfg.name, layers=cfg.n_layers,
         compute="bfloat16", batch=8, max_len=2048, buckets=sched.buckets,
         requests=len(results), prompt_lens=[int(n) for n in lens],
         max_new=SERVE_MAX_NEW, gen_tokens=n_tok, wall_s=wall,
         tok_per_s=n_tok / wall, decode_steps=len(timer.seconds["decode"]),
         decode_ms_per_step_p50=timer.ms("decode"),
         insert_ms_p50=timer.ms("insert"),
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p95_s=float(np.percentile(ttft, 95)),
         flash_launches=launches, inserts=inserts,
         trace_counts={name: eng.trace_count(name)
                       for name in ("prefill", "decode", "splice")},
         paged_serve={k: paged[k] for k in (
             "tok_per_s", "ttft_p50_s", "ttft_p95_s",
             "decode_ms_per_step_p50", "decode_steps")})
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def top2_gap(row: torch.Tensor) -> float:
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def dense_vs_paged_phase(mods) -> None:
    """qwen2-1.5b and mamba2-370m at full width, cut to ``DVP_LAYERS``
    layers, fp32 compute: one 8-request mixed-length trace (multi-chunk
    prompts included) through ``ServeScheduler`` over the dense ``Engine``
    (flash or SSD kernel in its inserts) and over ``PagedEngine`` (the
    paged kernel in its decode steps, SSD in its chunks).  Greedy streams
    and outcomes must be identical; on a mismatch the request, the token
    and both engines' top-2 logit gap there are printed before the run
    fails."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, PagedEngine, ServeScheduler
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen2-1.5b", "mamba2-370m"):
        cfg = dataclasses.replace(get_config(arch), n_layers=DVP_LAYERS,
                                  compute_dtype="float32")
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(2),
                             DEV)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
                   for n in DVP_LENS]
        max_len = max(DVP_LENS) + DVP_MAX_NEW + 8
        runs = {}
        for name in ("dense", "paged"):
            eng = (Engine(cfg, params, batch=4, max_len=max_len, device=DEV)
                   if name == "dense" else
                   PagedEngine(cfg, params, batch=4, max_len=max_len,
                               page_size=16, prefill_chunk=256, device=DEV))
            sched = ServeScheduler(eng)
            gaps = {}
            decode = eng.decode

            def recording(*args, sched=sched, decode=decode, gaps=gaps,
                          **kw):
                lg = decode(*args, **kw)
                for st in sched.slots:
                    if st.request is not None and not st.prefilling:
                        gaps[st.request.rid, len(st.tokens)] = top2_gap(
                            lg[st.slot, -1])
                return lg

            first = sched._first_token

            def recording_first(st, req, logits, first=first, gaps=gaps):
                gaps[req.rid, 0] = top2_gap(logits[0, -1])
                return first(st, req, logits)

            eng.decode = recording
            sched._first_token = recording_first
            reset_launches(mods)
            rids = [sched.submit(p, max_new=DVP_MAX_NEW) for p in prompts]
            results = {r.rid: r.tokens for r in sched.run()}
            runs[name] = {"rids": rids, "streams": results, "gaps": gaps,
                          "outcomes": {rid: o.outcome for rid, o
                                       in sched.outcomes.items()},
                          "launches": read_launches(mods)}
            del eng, sched
        dense, paged = runs["dense"], runs["paged"]
        bad = []
        for rid in dense["rids"]:
            a, b = dense["streams"].get(rid), paged["streams"].get(rid)
            if a != b:
                k = next((i for i, (x, y) in enumerate(zip(a or [], b or []))
                          if x != y), min(len(a or []), len(b or [])))
                bad.append({"rid": rid, "prompt_len": len(prompts[rid]),
                            "token": k,
                            "dense_top2_gap": dense["gaps"].get((rid, k)),
                            "paged_top2_gap": paged["gaps"].get((rid, k))})
        ok = (not bad and dense["outcomes"] == paged["outcomes"]
              and set(dense["outcomes"].values()) == {"completed"})
        kernels = ("flash_attention" if arch.startswith("qwen2")
                   else "ssd_scan")
        emit("dense_vs_paged", model=cfg.name, layers=DVP_LAYERS,
             compute="float32", prompt_lens=list(DVP_LENS),
             max_new=DVP_MAX_NEW, streams_identical=not bad,
             outcomes_identical=dense["outcomes"] == paged["outcomes"],
             mismatches=bad,
             min_top2_gap={k: min(r["gaps"].values())
                           for k, r in runs.items()},
             dense_launches={kernels: dense["launches"][kernels],
                             "paged_attention":
                                 dense["launches"]["paged_attention"]},
             paged_launches={kernels: paged["launches"][kernels],
                             "paged_attention":
                                 paged["launches"]["paged_attention"]})
        if not ok:
            raise AssertionError(f"dense_vs_paged {cfg.name}: streams or "
                                 f"outcomes differ: {bad}")
        if arch.startswith("qwen2") and (
                paged["launches"]["paged_attention"] == 0
                or dense["launches"]["flash_attention"] == 0):
            raise AssertionError(f"dense_vs_paged: kernels not run "
                                 f"{runs['dense']['launches']} "
                                 f"{runs['paged']['launches']}")
        if not arch.startswith("qwen2") and (
                dense["launches"]["ssd_scan"] == 0
                or paged["launches"]["ssd_scan"] == 0):
            raise AssertionError("dense_vs_paged: SSD kernel not run")
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()


def dev_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return float(getattr(ev, attr))
    return 0.0


def emit_profile(phase: str, prof, wall: float, count_key: str, n: int,
                 per: str, focus: str | None = None,
                 focus_calls: int = 0) -> float | None:
    """Device time by kernel name and the device's busy share (kernel time
    summed over wall time) of a profiled window of ``n`` steps or chunks
    (``per``); with ``focus``, also the device time and launches of the
    kernels whose name holds it, and their launches a counted wrapper call
    (``focus_calls`` calls in the window), which it returns."""
    # device-side events only (kernels and copies): CPU ops carry their
    # children's device time too, and would count it twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    extra = {}
    if focus is not None:
        mine = [e for e in events if focus in e.key]
        n_launch = sum(e.count for e in mine)
        extra = {f"{focus}kernels_ms_per_{per}":
                 sum(dev_us(e) for e in mine) / 1e3 / n,
                 f"{focus}kernels_launches_per_{per}": n_launch / n,
                 f"{focus}wrapper_calls": focus_calls,
                 f"{focus}kernels_per_call": (n_launch / focus_calls
                                              if focus_calls else None),
                 f"{focus}kernels": [{"name": e.key[:80], "calls": e.count,
                                      f"ms_per_{per}": dev_us(e) / 1e3 / n}
                                     for e in mine]}
    emit(phase, **extra, **{count_key: n, f"wall_ms_per_{per}": wall * 1e3 / n,
                   f"device_busy_ms_per_{per}": busy_ms / n,
                   "device_busy_share": (busy_ms / (wall * 1e3)
                                         if events else None),
                   "top_kernels": [{"name": e.key[:80], "calls": e.count,
                                    f"ms_per_{per}": dev_us(e) / 1e3 / n}
                                   for e in top]})
    return extra.get(f"{focus}kernels_per_call")


def prefill_through(eng, slot: int, prompt, page_ids, impl: str):
    """Chunk-prefill ``prompt`` into ``slot`` as ``PagedEngine.insert``
    does, with the SSD path pinned to ``impl``, and commit the slot.
    Returns the final chunk's logits."""
    from repro_torch.models.transformer import chunk_prefill_step
    from repro_torch.serve import chunk_plan

    eng.ensure_batch()
    (mrow,) = eng.rows              # no mesh: one row, local page ids
    row = torch.zeros((1, eng.max_pages), dtype=torch.int32, device=DEV)
    row[0, :len(page_ids)] = torch.tensor(page_ids, dtype=torch.int32)
    logits = None
    for start, blen, vlen in chunk_plan(len(prompt), eng.chunk_len,
                                        eng.chunk_buckets):
        ck = np.zeros((1, blen), np.int32)
        ck[0, :vlen] = prompt[start:start + vlen]
        logits, mrow.cache = chunk_prefill_step(
            eng.cfg, mrow.params, mrow.cache, torch.tensor(ck, device=DEV),
            slot=slot, start=start, valid_len=vlen, pages_row=row,
            page_size=eng.page_size, impl=impl, shards=mrow.shards)
    eng.commit_slot(slot, page_ids)
    return logits


def prefill_chunk_paths(eng, rng, kernel_mod, n_pairs: int = 4,
                        n_profiled: int = 4,
                        phase: str = "profile_prefill",
                        paths_phase: str = "prefill_chunk_paths") -> float:
    """Where a prefill chunk's time goes: full 256-token chunks of one
    prompt (a first chunk and a continuation) into a free slot, timed
    alternately through the kernel path and the plain einsum path
    (``impl`` "kernel" / "ref", in the order kernel, ref, ref, kernel,
    ...), then ``n_profiled`` kernel-path chunks under ``torch.profiler``:
    device time by kernel name, the device's busy share, and the SSD
    kernels' device time a chunk, per pass.  Returns the SSD device
    kernels the profiler saw a counted wrapper call (2: the C·Bᵀ pass and
    the y/S pass)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import chunk_prefill_step

    C = eng.chunk_len
    prompt = rng.integers(0, eng.cfg.vocab_size - 1, (2 * C,))
    row = torch.zeros((1, eng.max_pages), dtype=torch.int32, device=DEV)
    chunks = [torch.tensor(prompt[None, i * C:(i + 1) * C].astype(np.int32),
                           device=DEV) for i in range(2)]

    (mrow,) = eng.rows

    def run(impl):
        for i, ck in enumerate(chunks):
            chunk_prefill_step(eng.cfg, mrow.params, mrow.cache, ck, slot=0,
                               start=i * C, valid_len=C, pages_row=row,
                               page_size=eng.page_size, impl=impl,
                               shards=mrow.shards)

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
    emit(paths_phase, model=eng.cfg.name, chunk=C,
         kernel_ms=chunk_ms["kernel"], ref_ms=chunk_ms["ref"],
         kernel_ms_median=float(np.median(chunk_ms["kernel"])),
         ref_ms_median=float(np.median(chunk_ms["ref"])))
    kernel_mod.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_profiled // 2):
            run("kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = kernel_mod.launches
    per_call = emit_profile(phase, prof, wall, "chunks",
                            n_profiled, "chunk", focus="ssd_",
                            focus_calls=calls)
    if per_call != 2:
        raise AssertionError(f"{per_call} SSD device kernels a wrapper call "
                             f"({calls} calls profiled), expected 2")
    return per_call


PARITY_PROMPTS = (700, 300, 129)  # slot 3 stays free
PARITY_STEPS = 12


def parity_paths(cfg, params, shape=(PARITY_PROMPTS, 1024)) -> dict:
    """The kernel path against the plain path on one model: two
    ``PagedEngine``s (batch 4, page 16, chunk 256, max_len ``shape[1]``)
    on the same weights (``attn_impl`` kernel / ref), the prompts of
    ``shape[0]`` (``PARITY_PROMPTS`` by default; numpy seed 1)
    chunk-prefilled through the SSD kernel and through its
    plain version, then ``PARITY_STEPS`` teacher-forced decode steps (both
    decode the plain path's greedy tokens).  Returns the largest difference
    over max|logit| of the chunk (first-token) logits and of the decode
    logits, the greedy tokens' agreement and, for a MoE model, how many
    live decode rows picked other top-k experts on the kernel path than on
    the plain path, by MoE layer (``moe._route`` recorded on both)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import PageAllocator, PagedEngine

    prompt_lens, max_len = shape
    engines = {impl: PagedEngine(cfg, params, batch=4, max_len=max_len,
                                 page_size=16, prefill_chunk=256,
                                 attn_impl=impl, device=DEV)
               for impl in ("kernel", "ref")}
    worst = {"chunk": 0.0, "decode": 0.0}
    same = total = 0

    def compare(kind, lk, lr):
        nonlocal same, total
        lk, lr = lk.float(), lr.float()
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{cfg.name}: kernel-path logits not finite")
        worst[kind] = max(worst[kind], float((lk - lr).abs().max()
                                             / lr.abs().max()))
        same += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += lk.shape[0]
        return lr.argmax(-1)

    first = {}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in prompt_lens]
    for impl, eng in engines.items():
        alloc = PageAllocator(eng.num_pages)
        for slot, p in enumerate(prompts):
            pages = alloc.alloc(eng.pages_needed(len(p), PARITY_STEPS + 1))
            with torch.no_grad():
                first[impl, slot] = prefill_through(eng, slot, p, pages,
                                                    impl)
    toks = np.zeros((4, 1), np.int32)
    for slot in range(len(prompts)):
        toks[slot, 0] = int(compare("chunk", first["kernel", slot][:, -1],
                                    first["ref", slot][:, -1])[0])
    n = len(prompts)
    picks = {"kernel": [], "ref": []}
    route = moe._route

    def recording(impl):
        def run(*args):
            out = route(*args)
            picks[impl].append(out[2][:n, -1].sort(-1).values)
            return out
        return run

    try:
        for _ in range(PARITY_STEPS):
            moe._route = recording("kernel")
            lk = engines["kernel"].decode(toks)[:n, -1]
            moe._route = recording("ref")
            lr = engines["ref"].decode(toks)[:n, -1]
            toks[:n, 0] = compare("decode", lk, lr).cpu().numpy()
    finally:
        moe._route = route
    del engines, first
    out = {"compute": cfg.compute_dtype, "layers": cfg.n_layers,
           "prompt_lens": list(prompt_lens), "decode_steps": PARITY_STEPS,
           "chunk_max_rel_logit_err": worst["chunk"],
           "decode_max_rel_logit_err": worst["decode"],
           "max_rel_logit_err": max(worst.values()),
           "greedy_token_match": same / total,
           "greedy_streams_agree": same == total}
    n_moe = layer_kinds(cfg).count("moe")
    if n_moe:
        if not len(picks["kernel"]) == len(picks["ref"]) \
                == PARITY_STEPS * n_moe:
            raise AssertionError(f"{cfg.name}: router calls "
                                 f"{len(picks['kernel'])}, "
                                 f"{len(picks['ref'])}, expected "
                                 f"{PARITY_STEPS} x {n_moe}")
        flips = torch.stack([(a != b).any(-1).sum() for a, b in
                             zip(picks["kernel"], picks["ref"])])
        out["routing_rows_per_layer"] = PARITY_STEPS * n
        out["routing_flips_by_layer"] = \
            flips.view(PARITY_STEPS, n_moe).sum(0).tolist()
    return out


def parity_phase(phase: str, arch: str, depth: int | None = None,
                 shape=(PARITY_PROMPTS, 1024)) -> dict:
    """``parity_paths`` (at ``shape``) in fp32 compute (TF32 off) on fp32
    weights from a generator seeded 1, at full width and ``depth`` layers
    (all when None): emits ``phase`` and fails unless the chunk and decode
    logits agree within ``PARITY_TOL`` of max|logit|."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=depth or cfg.n_layers)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                         DEV)
    out = parity_paths(cfg, params, shape)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase, model=cfg.name, **out, tol=PARITY_TOL)
    if out["max_rel_logit_err"] > PARITY_TOL:
        raise AssertionError(f"{phase}: kernel path logits differ from the "
                             f"plain path: {out}")
    return out


def serve_paged_phase(phase: str, arch: str, mods, *, requests: int,
                      parity: str, depth: int | None = None,
                      tag: str | None = None,
                      parity_shape=(PARITY_PROMPTS, 1024)) -> dict:
    """One model served at full width through ``PagedEngine``.

    First ``parity_phase`` (emitted as ``parity``, at ``depth`` layers and
    ``parity_shape``) and the same two paths in bf16 at full depth,
    reported, not gated.
    Then ``ServeScheduler`` over ``PagedEngine(batch=8, page_size=16,
    prefill_chunk=256, max_len=2048)``, weights from a generator seeded 0
    cast to bf16 block by block, serves the first ``requests`` requests of
    ``serve_trace`` (prompts 64-1500, 32 greedy tokens each) after its
    two-request warm-up: every request gets its tokens, and, with the
    counts set to 0 just before and read just after, the paged kernel runs
    once an attention layer a decode step and SSD once an SSM layer a
    prefill chunk, each at least once where the model has such layers.
    Tok/s, TTFT p50/p95, the decode step and the prefill chunk; then
    ``profile_decode`` where the model has attention layers and
    ``prefill_chunk_paths`` where it has SSM layers, their lines suffixed
    with ``tag`` (``_<phase>`` by default).  Returns the launches by
    kernel, the decode steps and chunk calls, the device kernels a wrapper
    call each profile saw, and the serve figures."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.serve import PagedEngine, ServeScheduler
    from repro_torch.weights import init_params

    t_phase = time.perf_counter()
    tag = f"_{phase}" if tag is None else tag
    gate = parity_phase(parity, arch, depth, parity_shape)
    cfg = get_config(arch)                            # bf16 compute
    n_attn, n_ssm = layer_counts(cfg)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV, cast=True)
    bf16_gap = parity_paths(cfg, params, parity_shape)
    eng = PagedEngine(cfg, params, batch=8, max_len=2048, page_size=16,
                      prefill_chunk=256, device=DEV)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    warm, lens, prompts = serve_trace(cfg, requests, rng)
    sched = ServeScheduler(eng)
    # warm-up: cuBLAS handles and the first launches, off the record
    for w in warm:
        sched.submit(w, max_new=2)
    sched.run()
    sched.reset_metrics()

    timer = CallTimer(eng, ("decode", "prefill_chunk"))
    steps0, chunks0 = eng.n_decode_calls, eng.n_chunk_calls
    reset_launches(mods)
    t0 = time.perf_counter()
    for p in prompts:
        sched.submit(p, max_new=SERVE_MAX_NEW)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(mods)
    timer.restore()
    steps = eng.n_decode_calls - steps0
    chunks = eng.n_chunk_calls - chunks0

    if len(results) != len(prompts) or any(
            r.n_generated != SERVE_MAX_NEW for r in results):
        raise AssertionError(f"{phase}: {len(results)} requests done, "
                             f"{[r.n_generated for r in results]}")
    if any(o.outcome != "completed" for o in sched.outcomes.values()):
        raise AssertionError(f"{phase}: outcomes {sched.outcomes}")
    for kernel, calls, layers in (("paged_attention", steps, n_attn),
                                  ("ssd_scan", chunks, n_ssm)):
        if launches[kernel] != calls * layers or (
                layers and not launches[kernel]):
            raise AssertionError(f"{phase}: {kernel} launched "
                                 f"{launches[kernel]} times in {calls} "
                                 f"calls x {layers} layers")
    if not all(0 <= t < cfg.padded_vocab for r in results for t in r.tokens):
        raise AssertionError(f"{phase}: a token id falls outside the "
                             f"vocabulary")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    figures = {"tok_per_s": n_tok / wall,
               "ttft_p50_s": float(np.percentile(ttft, 50)),
               "ttft_p95_s": float(np.percentile(ttft, 95)),
               "decode_ms_per_step_p50": timer.ms("decode"),
               "decode_steps": steps}
    emit(phase, model=cfg.name, layers=cfg.n_layers,
         attention_layers=n_attn, ssm_layers=n_ssm, compute="bfloat16",
         batch=8, page_size=16, prefill_chunk=256, max_len=2048,
         requests=len(results), prompt_lens=[int(n) for n in lens],
         max_new=SERVE_MAX_NEW, gen_tokens=n_tok, wall_s=wall,
         chunk_calls=chunks, **figures,
         decode_ms_per_step_mean=float(
             np.mean(timer.seconds["decode"]) * 1e3),
         prefill_ms_per_chunk_p50=timer.ms("prefill_chunk"),
         prefill_ms_per_chunk_mean=float(
             np.mean(timer.seconds["prefill_chunk"]) * 1e3),
         kernel_launches={k: launches[k] for k in ("paged_attention",
                                                   "ssd_scan")},
         kernel_vs_plain_fp32=gate, tol=PARITY_TOL,
         kernel_vs_plain_bf16_full_depth=bf16_gap,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         seconds_so_far=time.perf_counter() - t_phase)
    per_call = {}
    if n_attn:
        per_call["paged_attention"] = profile_decode(
            sched, cfg, rng, pa_kernel, phase=f"profile{tag}",
            paths_phase=f"decode_step_paths{tag}")
    if n_ssm:
        per_call["ssd_scan"] = prefill_chunk_paths(
            eng, rng, ssd_kernel, phase=f"profile_prefill{tag}",
            paths_phase=f"prefill_chunk_paths{tag}")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in ("paged_attention",
                                                  "ssd_scan")},
            "chunk_calls": chunks, "device_kernels_per_call": per_call,
            **figures}


# ---------------------------------------------------------------------------
# the MoE and hybrid families: qwen2-moe-a2.7b and zamba2-1.2b
# ---------------------------------------------------------------------------


FAMILY_REQUESTS = 8
FAMILY_WAVES = 2
FAMILY_WAVE_NEW = 16


def case_summary(case: dict, err: float) -> dict:
    return {"max_abs_err": err, **{k: case[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def flash_timed_case(gen, *, B, S, T, H, KV, D, causal, window, dtype,
                     model: str, case_id: str,
                     time_grid: bool) -> tuple[dict, float]:
    """The flash forward at one shape of a served model (the ``kernels``
    line's ``case`` is ``case_id``): every launch shape of the tuner's
    grid and the default against its plain version (``FA_TOL``, LSE
    ``FA_LSE_TOL``; a shape the kernel does not take at this head dim,
    128-key tiles at D 256, must be refused before any launch), then the
    default timed beside its plain version, its bound and one
    ``scaled_dot_product_attention`` call (the window as a boolean
    ``attn_mask``), and with ``time_grid`` (bf16 only) each launch shape it
    takes.  Emits a ``kernels`` line and returns it with the largest
    error."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    t0 = time.perf_counter()
    q, k, v = fa_inputs(gen, B, S, T, H, KV, D, dtype)
    out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    errs, taken = {}, []
    for cfg in [{}, *DEFAULT_CANDIDATES["flash_attention"]]:
        name = f"{cfg['q_block']}x{cfg['kv_block']}" if cfg else "default"
        before = fa_kernel.launches["flash_attention"]
        try:
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, **cfg)
        except ValueError:
            if (not cfg or D <= fa_kernel.WIDE_D or cfg["kv_block"] == 64
                    or fa_kernel.launches["flash_attention"] != before):
                raise
            errs[name] = "refused"
            continue
        torch.cuda.synchronize()
        err = float((out.float() - out_p.float()).abs().max())
        lse_err = float((lse - lse_p).abs().max())
        errs[name] = [err, lse_err]
        if cfg:
            taken.append(cfg)
        if (out.shape != q.shape or not torch.isfinite(out.float()).all()
                or err > FA_TOL[dtype] or lse_err > FA_LSE_TOL):
            raise AssertionError(f"flash kernel disagrees with plain at "
                                 f"{case_id} ({name}, {dtype}): {err}, "
                                 f"{lse_err}")
    copies = _rotating((q, k, v))
    heads = [tuple(t.transpose(1, 2).contiguous() for t in c)
             for c in copies]
    mask = sdpa_mask(S, T, causal, window)
    bf16 = dtype == torch.bfloat16
    ms_by = {f"{c['q_block']}x{c['kv_block']}": cuda_ms(
        lambda i, c=c: flash_attention_kernel(
            *copies[i % len(copies)], causal=causal, window=window, **c), 20)
        for c in (taken if bf16 and time_grid else [])}
    case = {"case": case_id, "B": B, "S": S, "T": T, "H": H,
            "KV": KV, "D": D, "causal": causal, "window": window,
            "dtype": str(dtype).replace("torch.", ""), "tol": FA_TOL[dtype],
            "lse_tol": FA_LSE_TOL, "err_by_launch_shape": errs,
            "max_abs_err": max(e[0] for e in errs.values()
                               if e != "refused"),
            "ms": cuda_ms(lambda i: flash_attention_kernel(
                *copies[i % len(copies)], causal=causal, window=window), 20),
            "ms_by_launch_shape": ms_by,
            "plain_ms": cuda_ms(lambda i: flash_attention_plain(
                *copies[i % len(copies)], causal=causal, window=window), 3),
            "library_ms": cuda_ms(lambda i: F.scaled_dot_product_attention(
                *heads[i % len(heads)], attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), 20),
            **fa_bound(B, S, T, H, KV, D, causal, window, dtype)}
    emit("kernels", kernel="flash_attention", model=model,
         seconds=time.perf_counter() - t0, **case)
    del copies, heads
    torch.cuda.empty_cache()
    return case, case["max_abs_err"]


def family_kernel_phase() -> dict:
    """``kernels`` lines at the shapes qwen2-moe-a2.7b and zamba2-1.2b
    give the three kernels on their paths, each against its plain
    version: the paged kernel (bf16, decode at batch 8, page 16, max_len
    2048, G 1: KV 16 x D 128 and KV 32 x D 64) at every pages-a-split
    value and the default, SSD at zamba2's chunk (1, 64, 256, 64, 64) at
    every row tile, and the flash forward at the dense engine's batched
    prefill (B 8, S 1,024, H = KV 16 x D 128 and 32 x D 64).  Returns each
    kernel's figures by model."""
    from repro_torch.kernels.paged_attention.kernel import \
        default_pages_per_split
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(5)
    out = {"paged_attention": {}, "ssd_scan": {}, "flash_attention": {}}
    pps_grid = [c["pages_per_split"]
                for c in DEFAULT_CANDIDATES["paged_attention"]]
    kv_lens = [2048, 1999, 1500, 1024, 777, 300, 17, 0]
    shapes = (("qwen2-moe-a2.7b", 16, 128), ("zamba2-1.2b", 32, 64))
    for model, KV, D in shapes:
        case, err = paged_timed_case(
            gen, B=8, KV=KV, G=1, D=D, ps=16, n_pages=128, kv_lens=kv_lens,
            dtype=torch.bfloat16, window=None, trash_tail=0, grid=pps_grid,
            default_pps=default_pages_per_split(8, KV, 128), model=model)
        out["paged_attention"][model] = dict(
            case_summary(case, err), pages_per_split=case["pages_per_split"],
            ms_by_pages_per_split=case["ms_by_pages_per_split"])
    case, err = ssd_timed_case(
        gen, 1, 64, 256, 64, 64,
        [c["row_tile"] for c in DEFAULT_CANDIDATES["ssd_scan"]],
        model="zamba2-1.2b")
    out["ssd_scan"]["zamba2-1.2b"] = dict(
        case_summary(case, err), row_tile=case["row_tile"],
        ms_by_launch_shape=case["ms_by_launch_shape"])
    for model, H, D in shapes:        # H = KV: the models' head counts
        case, err = flash_timed_case(
            gen, B=WAVE_BATCH, S=WAVE_PROMPT, T=WAVE_PROMPT, H=H, KV=H, D=D,
            causal=True, window=None, dtype=torch.bfloat16, model=model,
            case_id=f"serve_{model}", time_grid=False)
        out["flash_attention"][model] = case_summary(case, err)
    emit("family_kernels", seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# gemma3's local/global attention and whisper's encoder-decoder:
# gemma3-4b and whisper-base
# ---------------------------------------------------------------------------


GEMMA3 = "gemma3-4b"
GEMMA3_WAVE_PROMPT = 2048        # twice the local window: the window cuts
GEMMA3_PARITY = ((1500, 1100, 129), 2048)   # prompts past the window
WHISPER = "whisper-base"
WHISPER_FRAMES = 1500            # 30 s of audio after the stubbed frontend
WHISPER_PROMPT = 64
WHISPER_NEW = 64                 # prompt + new stay within 448 positions
WHISPER_WAVES = 4
WHISPER_REQUESTS = 16
WHISPER_PROFILED_STEPS = 4


def gemma3_whisper_kernel_phase() -> dict:
    """``kernels`` lines at the shapes gemma3-4b and whisper-base give the
    two attention kernels on their paths, each against its plain version:
    the flash forward at gemma3's batched prefill (B 8, S 2,048, H 8, KV
    4, D 256; global: causal, local: the window of 1,024) in bf16 and fp32
    at every launch shape of the tuner's grid, and at whisper's
    non-causal shapes (bf16, B 8, H = KV 8, D 64: the encoder's 1,500
    frames over themselves, the decoder's 64-token prefill and one decode
    token over the frames); the paged kernel at gemma3's decode (bf16,
    B 8, KV 4, G 2, D 256, page 16, contexts 1,000-1,500) without and
    with the window.  Returns each kernel's figures by model and case."""
    from repro_torch.kernels.paged_attention.kernel import \
        default_pages_per_split
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(6)
    out = {"paged_attention": {}, "flash_attention": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for name, window in (("global", None), ("local", 1024)):
            tag = f"{name}_{str(dtype).replace('torch.', '')}"
            case, err = flash_timed_case(
                gen, B=WAVE_BATCH, S=GEMMA3_WAVE_PROMPT, T=GEMMA3_WAVE_PROMPT,
                H=8, KV=4, D=256, causal=True, window=window, dtype=dtype,
                model=GEMMA3, case_id=f"{GEMMA3}_{tag}", time_grid=True)
            out["flash_attention"][f"{GEMMA3} {tag}"] = dict(
                case_summary(case, err),
                ms_by_launch_shape=case["ms_by_launch_shape"],
                err_by_launch_shape=case["err_by_launch_shape"])
    for name, S in (("encoder", WHISPER_FRAMES),
                    ("cross_prefill", WHISPER_PROMPT), ("cross_decode", 1)):
        case, err = flash_timed_case(
            gen, B=WAVE_BATCH, S=S, T=WHISPER_FRAMES, H=8, KV=8, D=64,
            causal=False, window=None, dtype=torch.bfloat16, model=WHISPER,
            case_id=f"{WHISPER}_{name}", time_grid=False)
        out["flash_attention"][f"{WHISPER} {name}"] = case_summary(case, err)
    pps_grid = [c["pages_per_split"]
                for c in DEFAULT_CANDIDATES["paged_attention"]]
    kv_lens = [1500, 1431, 1362, 1293, 1224, 1155, 1086, 1000]
    for name, window in (("global", None), ("local", 1024)):
        case, err = paged_timed_case(
            gen, B=WAVE_BATCH, KV=4, G=2, D=256, ps=16, n_pages=128,
            kv_lens=kv_lens, dtype=torch.bfloat16, window=window,
            trash_tail=0, grid=pps_grid,
            default_pps=default_pages_per_split(WAVE_BATCH, 4, 128),
            model=GEMMA3)
        out["paged_attention"][f"{GEMMA3} {name}"] = dict(
            case_summary(case, err), pages_per_split=case["pages_per_split"],
            ms_by_pages_per_split=case["ms_by_pages_per_split"])
    emit("gemma3_whisper_kernels", seconds=time.perf_counter() - t0)
    return out


def whisper_flash_launches(cfg, prefills: int, decode_steps: int) -> int:
    """Flash forward launches of ``prefills`` prefills or inserts and
    ``decode_steps`` decode steps of an encoder-decoder model: a prefill
    runs each encoder layer's self-attention and each decoder layer's
    self- and cross-attention through it, a decode step each decoder
    layer's cross-attention (its one-token self-attention is plain)."""
    return (prefills * (cfg.n_encoder_layers + 2 * cfg.n_layers)
            + decode_steps * cfg.n_layers)


def whisper_check(cfg, params, prompts, frames) -> dict:
    """A batched prefill of ``prompts`` over ``frames`` from a fresh dense
    cache, then one decode step (on the plain path's greedy tokens),
    through ``impl="auto"`` (the flash kernel in the encoder, the
    decoder's prefill and its cross-attention) and ``impl="ref"``: the
    logits' largest difference over max|logit| and the greedy tokens'
    agreement."""
    from repro_torch.models.transformer import decode_step, encode, init_cache

    toks = torch.tensor(prompts, device=DEV)
    enc = torch.tensor(frames, device=DEV)
    out, nxt = {}, None
    for impl in ("ref", "auto"):
        with torch.no_grad():
            e = encode(cfg, params, enc, impl=impl)
            cache = init_cache(cfg, toks.shape[0], toks.shape[1] + 8,
                               device=DEV)
            a, cache = decode_step(cfg, params, cache, toks, impl=impl,
                                   valid_len=toks.shape[1], enc_out=e)
            if nxt is None:
                nxt = a[:, -1:].argmax(-1).to(torch.int32)
            b, _ = decode_step(cfg, params, cache, nxt, impl=impl, enc_out=e)
        out[impl] = torch.stack([a[:, -1], b[:, -1]]).float()
        del cache, e, a, b
    got, want = out["auto"], out["ref"]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: kernel-path logits not finite")
    return {"compute": cfg.compute_dtype,
            "max_rel_logit_err": float((got - want).abs().max()
                                       / want.abs().max()),
            "greedy_token_match": float(
                (got.argmax(-1) == want.argmax(-1)).float().mean())}


def serve_whisper_phases(mods) -> dict:
    """whisper-base at full width on the dense ``Engine`` (bf16), each
    request or wave row with ``WHISPER_FRAMES`` random encoder frames
    (numpy seed 0) and a ``WHISPER_PROMPT``-token prompt, ``WHISPER_NEW``
    greedy tokens.  ``parity_whisper``: ``whisper_check`` in fp32 compute
    on fp32 weights (gated at ``PARITY_TOL``) and in the engine's bf16
    (reported).  ``serve_waves_whisper``: ``WHISPER_WAVES`` waves of 8
    through ``Engine.generate``, then a few decode steps profiled.
    ``serve_whisper_trace``: ``WHISPER_REQUESTS`` requests through
    ``ServeScheduler`` (one insert each, which splices the slot's encoder
    output) after a two-request warm-up.  With the counts set to 0 just
    before each run and read just after, the flash forward must launch
    exactly ``whisper_flash_launches`` times.  Returns the launches by
    phase."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, ServeScheduler
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(WHISPER)                         # bf16 compute
    rng = np.random.default_rng(0)

    def frames(rows):
        return rng.standard_normal((rows, WHISPER_FRAMES, cfg.d_model),
                                   dtype=np.float32)

    waves = [(rng.integers(0, cfg.vocab_size - 1,
                           (WAVE_BATCH, WHISPER_PROMPT)).astype(np.int32),
              frames(WAVE_BATCH)) for _ in range(WHISPER_WAVES)]
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    gate = whisper_check(dataclasses.replace(cfg, compute_dtype="float32"),
                         params, *waves[0])
    max_len = WHISPER_PROMPT + WHISPER_NEW + 8
    eng = Engine(cfg, params, batch=WAVE_BATCH, max_len=max_len, device=DEV)
    del params
    bf16 = whisper_check(cfg, eng.params, *waves[0])
    emit("parity_whisper", model=cfg.name, frames=WHISPER_FRAMES,
         prompt_len=WHISPER_PROMPT, fp32=gate, bf16=bf16, tol=PARITY_TOL)
    if gate["max_rel_logit_err"] > PARITY_TOL:
        raise AssertionError(f"parity_whisper: kernel-path logits differ "
                             f"from impl='ref': {gate}")

    launches = {}
    timer = CallTimer(eng, ("prefill", "decode"))
    seconds, tokens = [], []
    reset_launches(mods)
    for prompts, enc in waves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=WHISPER_NEW, enc_embeds=enc)
        seconds.append(time.perf_counter() - t0)
        tokens.append(out.size)
        if out.shape != (WAVE_BATCH, WHISPER_NEW) or not (
                (out >= 0) & (out < cfg.padded_vocab)).all():
            raise AssertionError(f"serve_waves_whisper: generated "
                                 f"{out.shape}, ids [{out.min()}, "
                                 f"{out.max()}]")
    launches["serve_waves_whisper"] = read_launches(mods)["flash_attention"]
    timer.restore()
    n_decode = len(timer.seconds["decode"])
    want = whisper_flash_launches(cfg, WHISPER_WAVES, n_decode)
    # generate decodes after every sampled token, the last one included
    if (n_decode != WHISPER_WAVES * WHISPER_NEW
            or launches["serve_waves_whisper"] != want):
        raise AssertionError(f"serve_waves_whisper: flash launched "
                             f"{launches['serve_waves_whisper']} times in "
                             f"{WHISPER_WAVES} prefills and {n_decode} "
                             f"decode steps, expected {want}")
    toks = out[:, -1:]
    eng.decode(toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WHISPER_PROFILED_STEPS):
            eng.decode(toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steady_s = sum(seconds[1:])
    emit("serve_waves_whisper", model=cfg.name,
         layers=[cfg.n_encoder_layers, cfg.n_layers], compute="bfloat16",
         batch=WAVE_BATCH, frames=WHISPER_FRAMES, prompt_len=WHISPER_PROMPT,
         max_new=WHISPER_NEW, max_len=max_len, waves=WHISPER_WAVES,
         wave_s=seconds, steady_tokens=sum(tokens[1:]), steady_s=steady_s,
         steady_tok_per_s=sum(tokens[1:]) / steady_s,
         prefill_ms_p50=timer.ms("prefill", skip=1),
         decode_ms_per_step_p50=timer.ms("decode", skip=WHISPER_NEW),
         decode_steps=n_decode,
         flash_launches=launches["serve_waves_whisper"],
         trace_counts={name: eng.trace_count(name)
                       for name in ("prefill", "decode", "splice")})
    emit_profile("profile_serve_waves_whisper", prof, wall, "decode_steps",
                 WHISPER_PROFILED_STEPS, "step")

    # the trace: one insert a request, each splicing its encoder output
    eng = Engine(cfg, eng.params, batch=WAVE_BATCH, max_len=max_len,
                 device=DEV)
    sched = ServeScheduler(eng)
    for n in (WHISPER_PROMPT, 16):
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (n,)), max_new=2,
                     enc_embeds=frames(1))
    sched.run()
    sched.reset_metrics()
    reqs = [(rng.integers(0, cfg.vocab_size - 1, (WHISPER_PROMPT,)),
             frames(1)) for _ in range(WHISPER_REQUESTS)]
    timer = CallTimer(eng, ("insert", "decode"))
    steps0 = eng.n_decode_calls
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, enc in reqs:
        sched.submit(p, max_new=WHISPER_NEW, enc_embeds=enc)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["serve_whisper_trace"] = read_launches(mods)["flash_attention"]
    timer.restore()
    inserts, steps = len(timer.seconds["insert"]), eng.n_decode_calls - steps0
    if len(results) != len(reqs) or any(
            r.n_generated != WHISPER_NEW for r in results):
        raise AssertionError(f"serve_whisper_trace: {len(results)} requests "
                             f"done, {[r.n_generated for r in results]}")
    if any(o.outcome != "completed" for o in sched.outcomes.values()):
        raise AssertionError(f"serve_whisper_trace: {sched.outcomes}")
    want = whisper_flash_launches(cfg, inserts, steps)
    if inserts != len(reqs) or launches["serve_whisper_trace"] != want:
        raise AssertionError(f"serve_whisper_trace: flash launched "
                             f"{launches['serve_whisper_trace']} times in "
                             f"{inserts} inserts and {steps} decode steps, "
                             f"expected {want}")
    if not all(0 <= t < cfg.padded_vocab for r in results for t in r.tokens):
        raise AssertionError("a token id falls outside the vocabulary")
    ttft = np.array([r.ttft_s for r in results])
    n_tok = sum(r.n_generated for r in results)
    emit("serve_whisper_trace", model=cfg.name, compute="bfloat16",
         batch=WAVE_BATCH, frames=WHISPER_FRAMES, max_len=max_len,
         requests=len(results), prompt_len=WHISPER_PROMPT,
         max_new=WHISPER_NEW, gen_tokens=n_tok, wall_s=wall,
         tok_per_s=n_tok / wall, decode_steps=steps,
         decode_ms_per_step_p50=timer.ms("decode"),
         insert_ms_p50=timer.ms("insert"),
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p95_s=float(np.percentile(ttft, 95)),
         flash_launches=launches["serve_whisper_trace"], inserts=inserts,
         trace_counts={name: eng.trace_count(name)
                       for name in ("prefill", "decode", "splice")})
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


# ---------------------------------------------------------------------------
# training: flash attention, the fused step, HyPar, the launcher
# ---------------------------------------------------------------------------

H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # the reference's own
FA_LSE_TOL = 1e-4
FA_GRAD_TOL = 1e-4               # Function (kernel forward) vs autograd
# backward kernel vs plain backward, max|Δ| / max|plain| of dq, dk and dv:
# fp32 sums in other orders; bf16 rounds P and dS as product operands and
# its outputs to bf16 (the forward's own bf16 tolerance)
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# name, B, S, T, H, KV, D, causal, window, dtype: the training shape
# (qwen2-1.5b at seq 4096, micro-batch 2), fp32, a sliding window, ragged
# S, the smoke configs' head width, S > T with rows that see no key, and
# the other families' training shapes at micro-batch 2: zamba2's shared
# block and qwen2-moe (H = KV), whisper's encoder, cross-attention (448
# decoder tokens over 1,500 frames, non-causal) and decoder, gemma3's
# global and local (window 1,024) layers at head dim 256
FA_CASES = [
    ("train", 2, 4096, 4096, 12, 2, 128, True, None, torch.bfloat16),
    ("fp32", 1, 1024, 1024, 12, 2, 128, True, None, torch.float32),
    ("window", 2, 2048, 2048, 12, 2, 128, True, 512, torch.bfloat16),
    ("ragged", 2, 1000, 1000, 12, 2, 128, True, None, torch.bfloat16),
    ("d24", 4, 512, 512, 4, 2, 24, True, None, torch.bfloat16),
    ("no_visible_key", 1, 300, 100, 4, 2, 64, True, 64, torch.bfloat16),
    ("train_zamba2", 2, 4096, 4096, 32, 32, 64, True, None, torch.bfloat16),
    ("train_qwen2_moe", 2, 4096, 4096, 16, 16, 128, True, None,
     torch.bfloat16),
    ("train_whisper_enc", 2, 1500, 1500, 8, 8, 64, False, None,
     torch.bfloat16),
    ("train_whisper_cross", 2, 448, 1500, 8, 8, 64, False, None,
     torch.bfloat16),
    ("train_whisper_dec", 2, 448, 448, 8, 8, 64, True, None, torch.bfloat16),
    ("train_gemma3", 2, 4096, 4096, 8, 4, 256, True, None, torch.bfloat16),
    ("train_gemma3_local", 2, 4096, 4096, 8, 4, 256, True, 1024,
     torch.bfloat16),
    # the training mesh's (train_mesh): a TP=2 shard of qwen2-1.5b (H 6,
    # KV 1) at micro-batch 2, a DP=2 row's micro-batch of 1 at the whole
    # heads, and a TP=2 x DP=2 row's shard at micro-batch 1
    ("train_qwen2_tp2", 2, 4096, 4096, 6, 1, 128, True, None,
     torch.bfloat16),
    ("train_qwen2_dp2", 1, 4096, 4096, 12, 2, 128, True, None,
     torch.bfloat16),
    ("train_qwen2_tp2_dp2", 1, 4096, 4096, 6, 1, 128, True, None,
     torch.bfloat16),
]
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SEQ = 4096                 # the repo's train_4k cell
TRAIN_BATCH = 4                  # global; 2 micro-batches of 2
TRAIN_ACCUM = 2
TRAIN_STEPS = 4
TRAIN_LR = 3e-4
TRAIN_LOSS_TOL = 1e-3            # kernel vs plain path, step-1 loss, rel
TRAIN_GNORM_TOL = 2e-2           # kernel vs plain path, grad norm, rel
HYPAR_LAYERS = 4
HYPAR_STEPS = 3
HYPAR_PARAM_TOL = 1e-6           # HyPar vs fused final params, rel
PROC_LAYERS = 1                  # train_proc: depth and steps cut for the
PROC_STEPS = 1                   # store's traffic (see train_proc_phase)
PROC_WORKERS = 2
# train_proc's optimizer: Adafactor's factored moments, not AdamW's two
# full-size ones, so the optimizer jobs' state that crosses the process
# boundary and is hashed into the store is small (the phase is bound by
# those bytes: 105.3 s with AdamW)
PROC_OPTIMIZER = "adafactor"
PROC_PARAM_TOL = 1e-6            # process workers vs threads, rel
PROC_JOB_TIMEOUT_S = 600.0
PROC_BOOT_S = 120.0
FA_BWD_KERNELS = 3               # device kernels a backward call
# training runs, each at full width through the fused step, seq 4096,
# global batch 4 in 2 micro-batches, AdamW, remat="full": (phase, model,
# depth cut or None, the plain path's impl, steps, one more step under
# torch.profiler); mamba2-370m at 24 of its 48 layers (62.5 s of the run
# at 48) makes room for serve_mesh; qwen2-moe at 4 layers peaked at 67.4 GiB (72.4 GB) of
# the card's 80 GB; gemma3-4b at 12 layers is two periods of 5 local
# layers and 1 global (at 34, its 3.0 B parameters' fp32 values,
# gradients and AdamW moments alone take 48 GB, and the fp32 loss over
# 262,144 logits a token about 25 more)
TRAIN_RUNS = (
    ("train", TRAIN_ARCH, None, "tiled", TRAIN_STEPS, True),
    ("train_families", "mamba2-370m", 24, "ref", 3, True),
    ("train_families", "zamba2-1.2b", None, "ref", 3, False),
    ("train_families", "whisper-base", None, "ref", 3, False),
    ("train_families", "qwen2-moe-a2.7b", 2, "ref", 3, False),
    ("train_families", "gemma3-4b", 12, "ref", 3, False),
)
# kernel vs plain path, step 1's gradients leaf by leaf, max|Δ| / max|plain|
# of the worst leaf: bf16 products put it at 0.005-0.046 over TRAIN_RUNS,
# while halving one of the flash backward's or SSD backward's outputs puts
# it at 0.132 (mamba2's SSD dC, conv_w) to 0.64 (grad_gate.py).  The Mamba-2
# mixer's per-head scalars (TRAIN_HEAD_LEAVES) sum every token and channel
# of a head, which cancels: up to 0.158 unchanged, 4.9 with SSD's da halved
TRAIN_LEAF_TOL = 0.08
TRAIN_HEAD_LEAVES = ("dt_bias", "A_log", "D")
TRAIN_HEAD_LEAF_TOL = 1.0


def visible_pairs(S, T, causal, window) -> int:
    """(query, key) pairs the masks leave visible, for these sizes."""
    i = np.arange(S)
    hi = np.minimum(i + 1, T) if causal else np.full(S, T)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def _bound(flops, nbytes, dtype) -> dict:
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "flops": flops, "bytes": nbytes}


def fa_bound(B, S, T, H, KV, D, causal, window, dtype) -> dict:
    """Least time for the forward on these inputs: operations (4·D per
    visible pair: q·k and p·v) over the peak of the dtype's units (tensor
    cores for bf16, FMA for fp32), against q, k, v read once and the
    output and LSE written once over the memory rate."""
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 4 * B * H * D * visible_pairs(S, T, causal, window)
    nbytes = (2 * B * S * H * D + 2 * B * T * KV * D) * elt + B * H * S * 4
    return _bound(flops, nbytes, dtype)


def fa_bwd_bound(B, S, T, H, KV, D, causal, window, dtype) -> dict:
    """Least time for the backward: 10·D operations per visible pair (q·k
    and dO·vᵀ recomputed, dV, dQ, dK), against q, k, v, O, dO and LSE read
    once and dq, dk, dv written once."""
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 10 * B * H * D * visible_pairs(S, T, causal, window)
    nbytes = (4 * B * S * H * D + 4 * B * T * KV * D) * elt + B * H * S * 4
    return {f"bwd_{k}": v for k, v in _bound(flops, nbytes, dtype).items()}


def fa_inputs(gen, B, S, T, H, KV, D, dtype):
    return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def _rotating(tensors, floor_bytes: float = 100e6) -> list[tuple]:
    """Copies of ``tensors`` that together exceed ``floor_bytes`` (twice
    the L2), so a timed call finds its inputs in device memory."""
    n = max(2, math.ceil(floor_bytes / sum(
        t.numel() * t.element_size() for t in tensors)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each ``wgmma`` entry function, from
    ``nvcc -Xptxas -v`` output, and the entries ptxas reported a
    serialized ``wgmma`` for (C7520)."""
    entries, serialized, name = {}, [], None

    def label(mangled):   # flash_bwd_dq_wgmmaILi128EE... -> ..._wgmma<128>
        m = re.search(r"(flash_(?:fwd|bwd)_\w+?)I((?:Li\d+E)+)E", mangled)
        if not m:
            return mangled
        return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = label(m.group(1)) if "wgmma" in m.group(1) else None
            if name:
                entries[name] = {}
            continue
        if "C7520" in line:
            m = re.search(r"function '([^']+)'", line)
            serialized.append(label(m.group(1)) if m else line.strip())
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entries[name]["spill_store_bytes"] = int(m.group(1))
            entries[name]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[name]["registers"] = int(m.group(1))
    return {"entries": entries, "c7520": serialized}


def flash_kernel_phase() -> tuple[dict, dict]:
    """Both flash kernels against their plain versions on the cases above:
    the forward at every launch shape of the tuner's grid, the backward
    (on the kernel forward's output and LSE, one seeded dO) twice, which
    must agree to the bit; every case timed; the training shape also
    beside the plain versions, the bounds and SDPA's forward and backward.
    Returns the summary entries of the forward and the backward."""
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention_backward_kernel,
        flash_attention_backward_plain, flash_attention_kernel,
        flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        BLOCKS, WIDE_D, default_blocks)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(4)
    entry = None
    families = {"fwd": {}, "bwd": {}}     # the other families' training
    for name, B, S, T, H, KV, D, causal, window, dtype in FA_CASES:
        # the launch shapes the forward takes at this head dim, its default
        grid = [(qb, kb) for qb in BLOCKS for kb in BLOCKS
                if D <= WIDE_D or kb == 64]
        default = "{}x{}".format(*default_blocks(D))
        q, k, v = fa_inputs(gen, B, S, T, H, KV, D, dtype)
        dout = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
        out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
        case = {"case": name, "B": B, "S": S, "T": T, "H": H, "KV": KV,
                "D": D, "causal": causal, "window": window,
                "dtype": str(dtype).replace("torch.", ""),
                "tol": FA_TOL[dtype], "lse_tol": FA_LSE_TOL,
                "default_launch_shape": default, "err_by_launch_shape": {}}
        dark = T + window - 1 if name == "no_visible_key" else None
        for qb, kb in grid:
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, q_block=qb,
                                              kv_block=kb)
            torch.cuda.synchronize()
            if (out.shape != q.shape or out.dtype != dtype
                    or not torch.isfinite(out.float()).all()
                    or not torch.isfinite(lse).all()):
                raise AssertionError(f"flash kernel output misshapen or not "
                                     f"finite ({name}, {qb}x{kb})")
            err = float((out.float() - out_p.float()).abs().max())
            lse_err = float((lse - lse_p).abs().max())
            case["err_by_launch_shape"][f"{qb}x{kb}"] = [err, lse_err]
            if err > FA_TOL[dtype] or lse_err > FA_LSE_TOL:
                raise AssertionError(f"flash kernel disagrees with plain at "
                                     f"{qb}x{kb}: {case}")
            if dark is not None and out[:, dark:].abs().max() != 0:
                raise AssertionError("rows with no visible key not zero")
        case["max_abs_err"] = max(e for e, _ in
                                  case["err_by_launch_shape"].values())
        case["lse_max_abs_err"] = max(e for _, e in
                                      case["err_by_launch_shape"].values())
        if dark is not None:
            case["rows_with_no_key"] = S - dark

        # the backward on the default forward's output, as training runs it
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          window=window)
        want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                              causal=causal, window=window)
        got = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                              causal=causal, window=window)
        again = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                                causal=causal, window=window)
        torch.cuda.synchronize()
        rel = [float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want)]
        case.update(bwd_rel_err_dq_dk_dv=rel, bwd_tol=FA_BWD_TOL[dtype],
                    bwd_bitwise_repeat=all(torch.equal(a, b)
                                           for a, b in zip(got, again)))
        if (any(g.dtype != dtype or g.shape != w.shape
                or not torch.isfinite(g.float()).all()
                for g, w in zip(got, want))
                or not max(rel) <= FA_BWD_TOL[dtype]
                or not case["bwd_bitwise_repeat"]):
            raise AssertionError(f"flash backward kernel disagrees with the "
                                 f"plain backward: {case}")
        if dark is not None:
            case["dq_max_abs_on_rows_with_no_key"] = float(
                got[0][:, dark:].abs().max())
            if case["dq_max_abs_on_rows_with_no_key"] != 0:
                raise AssertionError("dq not zero on rows with no visible "
                                     "key")

        copies = _rotating((q, k, v))
        shapes = grid if name == "train" else [default_blocks(D)]
        case["ms_by_launch_shape"] = {
            f"{qb}x{kb}": cuda_ms(lambda i, qb=qb, kb=kb: (
                flash_attention_kernel(*copies[i % len(copies)],
                                       causal=causal, window=window,
                                       q_block=qb, kv_block=kb)), 20)
            for qb, kb in shapes}
        case["ms"] = case["ms_by_launch_shape"][default]
        case.update(fa_bound(B, S, T, H, KV, D, causal, window, dtype))
        bcopies = _rotating((q, k, v, out, lse, dout))
        case["bwd_ms"] = cuda_ms(lambda i: flash_attention_backward_kernel(
            *bcopies[i % len(bcopies)], causal=causal, window=window), 10)
        case.update(fa_bwd_bound(B, S, T, H, KV, D, causal, window, dtype))
        if name == "fp32":
            case.update(fa_grad_check(FlashAttentionFn, flash_attention_plain,
                                      q, k, v))
        # the training shape, gemma3's (the kernels' widest) and the
        # training mesh's: beside the plain versions and SDPA, forward and
        # backward (the window as a boolean attn_mask)
        yardsticks = name == "train" or name.startswith(("train_gemma3",
                                                          "train_qwen2"))
        if yardsticks:
            case["plain_ms"] = cuda_ms(lambda i: flash_attention_plain(
                *copies[i % len(copies)], causal=causal, window=window), 3)
            heads = [tuple(t.transpose(1, 2).contiguous() for t in c)
                     for c in copies]
            mask = sdpa_mask(S, T, causal, window)
            case["library_ms"] = cuda_ms(
                lambda i: F.scaled_dot_product_attention(
                    *heads[i % len(heads)], attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True), 20)
            case.update(fa_backward_times(bcopies, heads[0], causal, window))
            del heads
        if name == "train":
            entry = case
        if name.startswith("train_"):
            extra = ("plain_ms", "library_ms") if yardsticks else ()
            families["fwd"][name] = {k: case[k] for k in (
                "max_abs_err", "ms", "bound_ms", "bound_by", *extra)}
            families["bwd"][name] = {
                "max_abs_err": max(case["bwd_rel_err_dq_dk_dv"]),
                **{k: case[f"bwd_{k}"] for k in ("ms", "bound_ms",
                                                 "bound_by")},
                **({"plain_ms": case["plain_bwd_ms"],
                    "library_ms": case["library_bwd_ms"]}
                   if yardsticks else {})}
        emit("kernels", kernel="flash_attention", **case)
        del copies, bcopies, q, k, v, out, lse, out_p, lse_p, dout, got
        del want, again
        torch.cuda.empty_cache()
    shape = "B 2, S 4096, H 12, KV 2, D 128, causal, bf16"
    fwd = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
           "shape": shape, "launch_shape": "{}x{}".format(
               *default_blocks(entry["D"])),
           "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                           "enable_gqa=True)",
           **{k: entry[k] for k in ("max_abs_err", "ms", "ms_by_launch_shape",
                                    "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "bytes_bound_ms")},
           "train_shapes": families["fwd"]}
    bwd = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "none: the reference differentiates its plain paths "
                       "(src/repro/kernels/flash_attention/ops.py:35)",
           "shape": shape,
           "library_call": "autograd backward of "
                           "F.scaled_dot_product_attention",
           "max_abs_err": max(entry["bwd_rel_err_dq_dk_dv"]),
           "err_kind": "max|Δ| / max|plain| of dq, dk, dv",
           "ms": entry["bwd_ms"], "plain_ms": entry["plain_bwd_ms"],
           "library_ms": entry["library_bwd_ms"],
           "bound_ms": entry["bwd_bound_ms"],
           "bound_by": entry["bwd_bound_by"],
           "bytes_bound_ms": entry["bwd_bytes_bound_ms"],
           "train_shapes": families["bwd"]}
    return fwd, bwd


def fa_grad_check(fn_cls, plain, q, k, v) -> dict:
    """``FlashAttentionFn`` with both kernels against autograd through the
    plain version, fp32."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    dout = torch.randn(q.shape, device=DEV)
    out, _ = fn_cls.apply(q, k, v, True, None, "kernel")
    grads = torch.autograd.grad(out, (q, k, v), dout)
    out_p, _ = plain(q, k, v, causal=True)
    grads_p = torch.autograd.grad(out_p, (q, k, v), dout)
    errs = [float((g - gp).abs().max() / gp.abs().max())
            for g, gp in zip(grads, grads_p)]
    if max(errs) > FA_GRAD_TOL:
        raise AssertionError(f"FlashAttentionFn gradients disagree with "
                             f"autograd through the plain version: {errs}")
    return {"grad_rel_err_qkv": errs, "grad_tol": FA_GRAD_TOL}


def sdpa_mask(S, T, causal, window):
    """SDPA's boolean ``attn_mask`` for a window (None without one: the
    call takes ``is_causal`` then)."""
    if window is None:
        return None
    i = torch.arange(S, device=DEV)[:, None]
    j = torch.arange(T, device=DEV)[None, :]
    return (i - j < window) & ((i >= j) if causal else True)


def fa_backward_times(bcopies, heads, causal, window) -> dict:
    """The plain backward (torch ops over query tiles) and SDPA's backward
    (the yardstick; the port never calls it; the window as its mask)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain)
    plain_ms = cuda_ms(lambda i: flash_attention_backward_plain(
        *bcopies[i % len(bcopies)], causal=causal, window=window), 3)
    qh, kh, vh = (t.detach().requires_grad_() for t in heads)
    mask = sdpa_mask(qh.shape[2], kh.shape[2], causal, window)
    oh = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                        is_causal=causal and mask is None,
                                        enable_gqa=True)
    doh = bcopies[0][5].transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda i: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True), 10)
    return {"plain_bwd_ms": plain_ms, "library_bwd_ms": lib_ms}


def reset_launches(mods) -> None:
    for mod in mods:
        if isinstance(mod.launches, dict):
            for key in mod.launches:
                mod.launches[key] = 0
        else:
            mod.launches = 0


def read_launches(mods) -> dict:
    out = {}
    for mod in mods:
        name = mod.__name__.split(".")[-2]
        if isinstance(mod.launches, dict):
            out.update(mod.launches)
        else:
            out[name] = mod.launches
    return out


def train_batches(cfg, n_steps):
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    stream = SyntheticLMStream(cfg, DataConfig(
        seed=0, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    return [to_device(stream.batch(s), DEV) for s in range(n_steps)]


def train_counts(cfg) -> tuple[int, int]:
    """(flash-attention calls, SSD calls) of one micro-batch's forward:
    every attention layer (each invocation of a shared block; an
    encoder-decoder model's encoder layers and its decoder's self- and
    cross-attention) and every SSM layer once."""
    n_attn, n_ssm = layer_counts(cfg)
    if cfg.family == "encdec":
        n_attn += cfg.n_encoder_layers + cfg.n_layers
    return n_attn, n_ssm


def step1_gaps(cfg, params, batch, plain: str) -> dict:
    """Step 1's loss and gradients by the plain path (``impl=plain``) and
    by the kernel path on the same parameters and batch, no update: both
    losses and grad norms, and each gradient leaf's max|Δ| / max|plain|:
    the worst of the leaves in ``TRAIN_HEAD_LEAVES`` and of the others,
    and the worst five named."""
    from repro_torch.optim import global_norm
    from repro_torch.train import compute_grads
    from repro_torch.tree import tree_leaves, tree_paths

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads_p, loss_p, _ = compute_grads(cfg, params, batch,
                                       accum=TRAIN_ACCUM, impl=plain)
    torch.cuda.synchronize()
    out = {"plain_path_s": time.perf_counter() - t0,
           "plain_path_peak_memory_gib": torch.cuda.max_memory_allocated()
           / 2**30,
           "plain_path_step1_loss": float(loss_p),
           "plain_path_step1_grad_norm": float(global_norm(grads_p))}
    grads_k, loss_k, _ = compute_grads(cfg, params, batch,
                                       accum=TRAIN_ACCUM)
    out.update(kernel_path_step1_loss=float(loss_k),
               kernel_path_step1_grad_norm=float(global_norm(grads_k)))
    rel = {}
    for (path, gp), gk in zip(tree_paths(grads_p), tree_leaves(grads_k)):
        scale = float(gp.abs().max())
        diff = float((gk - gp).abs().max())
        rel[path] = (diff / scale if scale else
                     0.0 if diff == 0 else math.inf)
    head = [p for p in rel if p.rsplit("/", 1)[-1] in TRAIN_HEAD_LEAVES]
    worst = sorted(rel, key=rel.get, reverse=True)[:5]
    out.update(grad_leaves=len(rel),
               grad_leaf_rel_err=max(v for p, v in rel.items()
                                     if p not in head),
               grad_leaf_tol=TRAIN_LEAF_TOL,
               grad_head_leaf_rel_err=max((rel[p] for p in head),
                                          default=None),
               grad_head_leaf_tol=TRAIN_HEAD_LEAF_TOL,
               grad_leaf_worst={p: rel[p] for p in worst})
    del grads_p, grads_k
    torch.cuda.empty_cache()
    return out


def step1_ok(loss_err: float, gnorm_err: float, gaps: dict) -> bool:
    """Step 1 of the kernel path within the limits of the plain path's:
    loss, grad norm and every gradient leaf (``step1_gaps``)."""
    return (loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
            and gaps["grad_leaf_rel_err"] <= TRAIN_LEAF_TOL
            and (gaps["grad_head_leaf_rel_err"] or 0.0)
            <= TRAIN_HEAD_LEAF_TOL)


def train_profile(prof, wall: float, launches: dict) -> dict:
    """A profiled training step: wall and device-busy ms, the top device
    kernels, the device ms of the flash forward, of its backward (and its
    device kernels a backward call) and of the SSD kernels, the SSD plain
    backward (the profiler range around ``SsdIntraChunkFn.backward``: its
    children's device time) and its calls, and the einsum calls."""
    from repro_torch.kernels.ssd_scan.ops import BACKWARD_RANGE

    rows = prof.key_averages()
    events = [e for e in rows if str(e.device_type).endswith("CUDA")
              and dev_us(e) > 0 and e.key != BACKWARD_RANGE]
    busy = sum(dev_us(e) for e in events) / 1e3
    rng = [e for e in rows if e.key == BACKWARD_RANGE
           and not str(e.device_type).endswith("CUDA")]
    ssd_bwd_ms = sum(float(getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0.0)))
                     for e in rng) / 1e3

    def kernels(*names):
        mine = [e for e in events if any(n in e.key for n in names)]
        return sum(dev_us(e) for e in mine) / 1e3, sum(e.count for e in mine)

    fwd_ms, _ = kernels("flash_fwd")
    bwd_ms, bwd_kernels = kernels("flash_bwd")
    bwd_calls = launches["flash_attention_bwd"]
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "flash_fwd_kernel_ms": fwd_ms, "flash_bwd_kernel_ms": bwd_ms,
            "flash_fwd_share_of_device": fwd_ms / busy if busy else None,
            "flash_bwd_share_of_device": bwd_ms / busy if busy else None,
            "flash_bwd_calls": bwd_calls,
            "flash_bwd_kernels_per_call": (bwd_kernels / bwd_calls
                                           if bwd_calls else None),
            "ssd_kernels_ms": kernels("ssd_cb_kernel", "ssd_main_kernel")[0],
            "ssd_plain_backward_ms": ssd_bwd_ms,
            "ssd_plain_backward_calls": sum(e.count for e in rng),
            "ssd_plain_backward_calls_expected": launches["ssd_scan"] // 2,
            "ssd_plain_backward_share_of_device": (ssd_bwd_ms / busy
                                                   if busy else None),
            "einsum_calls": sum(e.count for e in rows
                                if e.key == "aten::einsum"),
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms": dev_us(e) / 1e3} for e in top]}


def check_train_profile(name: str, prof: dict, n_attn: int,
                        n_ssm: int) -> None:
    """The profiled step went through the kernels: three device kernels a
    flash backward call; each SSD call's plain backward once; no einsum
    (the plain attention's score tiles) in a model without SSM layers."""
    bad = []
    if n_attn and (prof["flash_bwd_kernels_per_call"] != FA_BWD_KERNELS
                   or prof["flash_bwd_kernel_ms"] <= 0):
        bad.append(f"{prof['flash_bwd_kernels_per_call']} flash backward "
                   f"kernels a call (expected {FA_BWD_KERNELS}), "
                   f"{prof['flash_bwd_kernel_ms']} ms of them")
    if n_ssm and (prof["ssd_plain_backward_calls"]
                  != prof["ssd_plain_backward_calls_expected"]
                  or prof["ssd_plain_backward_ms"] <= 0):
        bad.append(f"{prof['ssd_plain_backward_calls']} SSD plain backward "
                   f"calls (expected "
                   f"{prof['ssd_plain_backward_calls_expected']}), "
                   f"{prof['ssd_plain_backward_ms']} ms")
    if not n_ssm and prof["einsum_calls"]:
        bad.append(f"{prof['einsum_calls']} einsum calls")
    if bad:
        raise AssertionError(f"{name}: profiled step: {'; '.join(bad)}")


def train_phase(mods) -> dict:
    """Every family trained at full width by the fused step on the card,
    one ``TRAIN_RUNS`` entry after another: qwen2-1.5b (``train``),
    mamba2-370m cut to 24 of its 48 layers, zamba2-1.2b (38), whisper-base (6 + 6; 1,500
    frames and 448 decoder tokens, as the stream cuts them),
    qwen2-moe-a2.7b cut to 2 layers (at 4, its 2.9 B parameters' fp32
    values, gradients and AdamW moments, 46 GB, and a step's activations
    peaked at 72 GB) and gemma3-4b cut to 12 layers (two periods of 5
    local and 1 global; ``train_families``).  For each: step 1's loss and
    gradients by the plain path and by the kernel path, no update
    (``step1_gaps``); then its steps with the counts set to 0 just before
    and read just after: the flash forward steps x 2 x attention layers x
    2 (the remat recompute), its backward steps x 2 x attention layers,
    SSD steps x 2 x SSM layers x 2 (its backward is the plain version's
    derivative: no launch); finite losses and grad norms; step 1 within
    ``TRAIN_LOSS_TOL`` / ``TRAIN_GNORM_TOL`` of the plain path and every
    gradient leaf within ``TRAIN_LEAF_TOL`` (``TRAIN_HEAD_LEAF_TOL`` for
    the Mamba-2 mixer's per-head scalars).  A profiled run takes
    one more step under ``torch.profiler`` (``check_train_profile``).
    Returns each model's counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import _window_for, layer_kinds
    from repro_torch.optim import OptimizerSpec
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = OptimizerSpec(kind="adamw", lr=TRAIN_LR)
    out = {}
    for phase, arch, depth, plain, n_steps, profiled in TRAIN_RUNS:
        t_model = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        batches = train_batches(cfg, n_steps + profiled)
        state = TrainState.create(
            cfg, spec, torch.Generator(device=DEV).manual_seed(0), DEV)
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        gaps = step1_gaps(cfg, state.params, batches[0], plain)

        step = make_train_step(cfg, spec, grad_accum=TRAIN_ACCUM)
        torch.cuda.reset_peak_memory_stats()
        secs, losses, gnorms = [], [], []
        reset_launches(mods)
        for b in batches[:n_steps]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss_total"]))
            gnorms.append(float(m["grad_norm"]))
        launches = read_launches(mods)
        peak = torch.cuda.max_memory_allocated()
        n_attn, n_ssm = train_counts(cfg)
        micro = n_steps * TRAIN_ACCUM
        want = {"flash_attention": micro * n_attn * 2,
                "flash_attention_bwd": micro * n_attn,
                "ssd_scan": micro * n_ssm * 2}
        got = {k: launches[k] for k in want}
        tokens = batches[0]["tokens"].numel()
        step_s = float(np.median(secs[1:]))
        flops = None
        if cfg.family == "dense":     # 6·N a token and the visible scores
            pairs = sum(visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True,
                                      _window_for(cfg, kind))
                        for kind in layer_kinds(cfg))
            flops = 6 * n_params * tokens + 3 * 4 * TRAIN_BATCH * (
                cfg.n_heads * cfg.hd * pairs)
        loss_plain = gaps["plain_path_step1_loss"]
        gnorm_plain = gaps["plain_path_step1_grad_norm"]
        loss_err = abs(losses[0] - loss_plain) / abs(loss_plain)
        gnorm_err = abs(gnorms[0] - gnorm_plain) / gnorm_plain
        line = dict(
            model=cfg.name, layers=cfg.n_layers,
            encoder_layers=cfg.n_encoder_layers, depth_cut=depth,
            d_model=cfg.d_model, params=n_params,
            param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
            remat=cfg.remat, optimizer="adamw", lr=TRAIN_LR,
            seq=TRAIN_SEQ, decoder_tokens=batches[0]["tokens"].shape[1],
            encoder_frames=(batches[0]["enc_embeds"].shape[1]
                            if "enc_embeds" in batches[0] else None),
            global_batch=TRAIN_BATCH, grad_accum=TRAIN_ACCUM,
            steps=n_steps, step_s=secs, step_s_median_2_on=step_s,
            tokens_per_s=tokens / step_s, flops_per_step=flops,
            mfu=flops / step_s / H100_BF16_FLOPS if flops else None,
            peak_memory_gib=peak / 2**30, loss=losses, grad_norm=gnorms,
            plain_impl=plain, **gaps, loss_rel_err=loss_err,
            loss_tol=TRAIN_LOSS_TOL, grad_norm_rel_err=gnorm_err,
            grad_norm_tol=TRAIN_GNORM_TOL,
            attention_layers_per_micro_batch=n_attn,
            ssm_layers_per_micro_batch=n_ssm, launches=got,
            launches_expected=want)
        prof = None
        if profiled:
            reset_launches(mods)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                state, _ = step(state, batches[n_steps])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof = train_profile(trace, wall, read_launches(mods))
            del trace
        line["seconds"] = time.perf_counter() - t_model
        emit(phase, **line)
        if prof is not None:
            emit(f"profile_{phase}", model=cfg.name, **prof)
        if not all(math.isfinite(x)
                   for x in losses + gnorms + [loss_plain, gnorm_plain]):
            raise AssertionError(f"{cfg.name}: training losses or grad "
                                 f"norms not finite: {losses}, {gnorms}")
        if got != want:
            raise AssertionError(f"{cfg.name}: kernel launches {got}, "
                                 f"expected {want} (flash: steps x "
                                 f"grad_accum x attention layers x 2 for "
                                 f"the remat recompute; its backward: "
                                 f"steps x grad_accum x attention layers; "
                                 f"SSD: steps x grad_accum x SSM layers x 2)")
        if not step1_ok(loss_err, gnorm_err, gaps):
            raise AssertionError(f"{cfg.name}: kernel path vs plain path at "
                                 f"step 1: loss {loss_err}, grad norm "
                                 f"{gnorm_err}, gradient leaves "
                                 f"{gaps['grad_leaf_worst']}")
        if prof is not None:
            check_train_profile(cfg.name, prof, n_attn, n_ssm)
        out[cfg.name] = got
        del state, batches, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


TRAIN_MESH_SHAPES = ((1, 2), (2, 1), (2, 2))      # (data, model)
TRAIN_MESH_STEPS = 2
TRAIN_MESH_CHECK_LAYERS = 4      # the fp32-compute parity runs: depth cut
TRAIN_MESH_PARAM_TOL = 1e-5      # of max|param|, after 2 fp32 steps
# the parity runs' AdamW eps: the key biases' exact gradient is 0, and at
# 1e-8 AdamW steps them by about ±lr in the direction of their rounding
# noise (tests/test_torch_train_families.py)
TRAIN_MESH_CHECK_EPS = 1e-6
# the model axis beyond attention and MLPs, at TP=2: (arch, depth cut)
TRAIN_MESH_MOE = ("qwen2-moe-a2.7b", 2)     # experts split 30 / 30
TRAIN_MESH_SSM = ("mamba2-370m", 8)         # SSD heads split 16 / 16
TRAIN_MESH_FP32_FAMILIES = (("qwen2-moe-a2.7b", 2), ("mamba2-370m", 2))
TRAIN_MESH_FP32_SEQ = 1024


def _mesh_of(data: int, model: int):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(data, model, device=DEV,
                          devices=[torch.device(DEV)] * (data * model))


def _fresh_state(cfg, spec, mesh=None, seed: int = 0):
    """A fresh state drawn on the card from a seeded generator (the same
    values on every call: the runs of a comparison start from it),
    placed on ``mesh`` when one is given (the drawn copy freed after)."""
    from repro_torch.train import TrainState, shard_state
    state = TrainState.create(
        cfg, spec, torch.Generator(device=DEV).manual_seed(seed), DEV)
    return state if mesh is None else shard_state(state, mesh)


def mesh_state_bytes(state, mesh) -> dict:
    """Each position's state bytes against the specs' shard bytes."""
    from repro_torch.parallel import DEFAULT_RULES, ShardingRules
    from repro_torch.parallel.partition import position_bytes, spec_bytes
    tree = {"params": state.params, "opt_state": state.opt_state}
    return {"position_bytes": position_bytes(tree),
            "spec_bytes": spec_bytes(tree, ShardingRules(
                mesh, dict(DEFAULT_RULES)), kind="state")}


def _mesh_reference(cfg, spec, batch):
    """The meshless step 1 of a fresh state (``_fresh_state``): ``{"loss",
    "gnorm", "grads": [(path, gradient on the host)]}``."""
    from repro_torch.optim import global_norm
    from repro_torch.train import compute_grads
    from repro_torch.tree import tree_paths

    state = _fresh_state(cfg, spec)
    grads, loss, _ = compute_grads(cfg, state.params, batch,
                                   accum=TRAIN_ACCUM)
    ref = {"loss": float(loss), "gnorm": float(global_norm(grads)),
           "grads": [(path, g.cpu()) for path, g in tree_paths(grads)]}
    del state, grads
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def expert_bytes(state, mesh) -> dict:
    """Each position's bytes of the expert tensors (parameters and AdamW
    moments) against the specs' shard bytes."""
    from repro_torch.models.moe import EXPERT_KEYS
    from repro_torch.parallel import DEFAULT_RULES, ShardingRules
    from repro_torch.parallel.partition import position_bytes, spec_bytes

    def experts(tree):
        return {"layers": [{"moe": {k: p["moe"][k] for k in EXPERT_KEYS}}
                           for p in tree["layers"] if "moe" in p]}
    tree = {"params": experts(state.params),
            "opt_state": {k: experts(v) for k, v in state.opt_state.items()
                          if isinstance(v, dict) and "layers" in v}}
    return {"expert_position_bytes": position_bytes(tree),
            "expert_spec_bytes": spec_bytes(tree, ShardingRules(
                mesh, dict(DEFAULT_RULES)), kind="state")}


def mesh_grid_run(cfg, spec, ref, batches, data, model, mods,
                  phase) -> tuple[dict, list, dict]:
    """One grid of a training-mesh case: step 1's loss, grad norm and
    gradient leaves against the meshless step 1 (``step1_ok``; the
    Mamba-2 mixer's per-head scalars at ``TRAIN_HEAD_LEAF_TOL``), then
    ``len(batches)`` steps with the counts set to 0 just before and read
    just after: the flash forward steps x 2 x attention layers x 2 x tp x
    dp, its backward steps x 2 x attention layers x tp x dp, SSD steps x
    2 x SSM layers x 2 x tp x dp (each head shard runs its own scan), each
    position's state bytes against the specs'.  Emits ``phase`` and
    returns ``(line, failures, launches)``."""
    from repro_torch.optim import global_norm
    from repro_torch.train import compute_grads_mesh, make_train_step
    from repro_torch.tree import tree_leaves

    t_run = time.perf_counter()
    mesh = _mesh_of(data, model)
    tag = f"TP={model} x DP={data}"
    state = _fresh_state(cfg, spec, mesh)
    torch.cuda.reset_peak_memory_stats()
    grads, loss, _ = compute_grads_mesh(cfg, state.params, batches[0],
                                        mesh, accum=TRAIN_ACCUM)
    gnorm = float(global_norm(grads))
    rel = {}
    for (path, want), got in zip(ref["grads"], tree_leaves(grads)):
        want = want.to(DEV)
        scale = float(want.abs().max())
        diff = float((got.gather() - want).abs().max())
        rel[path] = (diff / scale if scale else
                     0.0 if diff == 0 else math.inf)
    del grads, want
    torch.cuda.empty_cache()
    head = [p for p in rel if p.rsplit("/", 1)[-1] in TRAIN_HEAD_LEAVES]
    worst = sorted(rel, key=rel.get, reverse=True)[:5]
    gaps = {"grad_leaf_rel_err": max(v for p, v in rel.items()
                                     if p not in head),
            "grad_head_leaf_rel_err": max((rel[p] for p in head),
                                          default=None),
            "grad_leaf_worst": {p: rel[p] for p in worst}}
    loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    gnorm_err = abs(gnorm - ref["gnorm"]) / ref["gnorm"]
    step = make_train_step(cfg, spec, grad_accum=TRAIN_ACCUM, mesh=mesh)
    secs, losses, gnorms = [], [], []
    reset_launches(mods)
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss_total"]))
        gnorms.append(float(m["grad_norm"]))
    launches = read_launches(mods)
    n_attn, n_ssm = train_counts(cfg)
    micro = len(batches) * TRAIN_ACCUM * model * data
    want_launches = {"flash_attention": micro * n_attn * 2,
                     "flash_attention_bwd": micro * n_attn,
                     "ssd_scan": micro * n_ssm * 2}
    got_launches = {k: launches[k] for k in want_launches}
    nbytes = mesh_state_bytes(state, mesh)
    if cfg.is_moe:
        nbytes.update(expert_bytes(state, mesh))
    tokens = batches[0]["tokens"].numel()
    line = dict(
        model=cfg.name, mesh=tag, data=data, tp=model,
        devices=[str(d) for d in mesh.flat], layers=cfg.n_layers,
        seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, grad_accum=TRAIN_ACCUM,
        steps=len(batches), step_s=secs, tokens_per_s=tokens / secs[-1],
        loss=losses, grad_norm=gnorms,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        step1_loss=float(loss), meshless_step1_loss=ref["loss"],
        loss_rel_err=loss_err, loss_tol=TRAIN_LOSS_TOL,
        step1_grad_norm=gnorm, meshless_step1_grad_norm=ref["gnorm"],
        grad_norm_rel_err=gnorm_err, grad_norm_tol=TRAIN_GNORM_TOL,
        grad_leaf_tol=TRAIN_LEAF_TOL, grad_head_leaf_tol=TRAIN_HEAD_LEAF_TOL,
        **gaps, launches=got_launches, launches_expected=want_launches,
        **nbytes)
    failures = []
    if not all(math.isfinite(x) for x in losses + gnorms):
        failures.append(f"{cfg.name} {tag}: losses or grad norms not "
                        f"finite")
    if not step1_ok(loss_err, gnorm_err, gaps):
        failures.append(f"{cfg.name} {tag}: step 1 against no mesh: loss "
                        f"{loss_err}, grad norm {gnorm_err}, leaves "
                        f"{gaps['grad_leaf_worst']}")
    if got_launches != want_launches:
        failures.append(f"{cfg.name} {tag}: launches {got_launches}, "
                        f"expected {want_launches}")
    if nbytes["position_bytes"] != [nbytes["spec_bytes"]] * mesh.size:
        failures.append(f"{cfg.name} {tag}: position bytes {nbytes}")
    if cfg.is_moe and nbytes["expert_position_bytes"] \
            != [nbytes["expert_spec_bytes"]] * mesh.size:
        failures.append(f"{cfg.name} {tag}: expert bytes {nbytes}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_run
    emit(phase, **line)
    return line, failures, got_launches


def mesh_fp32_parity(cfg, spec, shapes, seq: int) -> dict:
    """``cfg`` in fp32 compute, 2 steps on no mesh and on each grid of
    ``shapes`` from one initial state and batch stream (global batch
    ``TRAIN_BATCH``, sequences of ``seq``): each grid's final parameters'
    max|Δ| / max|param| against no mesh's, and that scale."""
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.parallel.partition import gather_tree
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves

    stream = SyntheticLMStream(cfg, DataConfig(
        seed=0, global_batch=TRAIN_BATCH, seq_len=seq))
    batches = [to_device(stream.batch(s), DEV)
               for s in range(TRAIN_MESH_STEPS)]
    ref, errs = None, {}
    for shape in (None, *shapes):
        mesh = None if shape is None else _mesh_of(*shape)
        state = _fresh_state(cfg, spec, mesh)
        step = make_train_step(cfg, spec, grad_accum=TRAIN_ACCUM, mesh=mesh)
        for b in batches:
            state, _ = step(state, b)
        final = tree_leaves(gather_tree(state.params))
        del state, step
        if ref is None:
            ref = final
            pscale = max(float(t.abs().max()) for t in ref)
        else:
            errs[f"TP={shape[1]} x DP={shape[0]}"] = max(
                float((a - b).abs().max()) for a, b in zip(final, ref)) \
                / pscale
        del final
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    return {"param_rel_err": errs, "max_abs_param": pscale}


def train_mesh_phase(mods) -> dict:
    """The training mesh at full width, every position on the card, each
    grid from the meshless run's initial state and batches
    (``mesh_grid_run``: step 1 against the meshless step 1 at the
    training gates, then ``TRAIN_MESH_STEPS`` steps with exact kernel
    counts, position bytes against the specs', step s, tokens/s, peak
    memory):

    * ``train_mesh``: qwen2-1.5b at TP=2, DP=2, TP=2 x DP=2
      (``TRAIN_MESH_SHAPES``); its embedding, logits and cross-entropy
      split by vocabulary at TP=2;
    * ``train_mesh_moe``: qwen2-moe-a2.7b at 2 of its 24 layers, TP=2: 30
      of its 60 experts a position (each position's expert bytes the
      specs');
    * ``train_mesh_ssm``: mamba2-370m at 8 of its 48 layers, TP=2: 16 of
      its 32 SSD heads a position, the SSD kernel launched steps x 2 x 8
      x 2 x tp times;
    * ``train_mesh_fp32``: fp32-compute runs against their meshless runs,
      parameters after 2 steps within ``TRAIN_MESH_PARAM_TOL`` of
      max|param|: qwen2 at 4 layers on every grid, qwen2-moe and mamba2
      at 2 layers at TP=2 (sequences of ``TRAIN_MESH_FP32_SEQ``: their
      fp32 activations at 4,096 do not fit beside the state).

    Returns the launches of each run."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptimizerSpec

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = OptimizerSpec(kind="adamw", lr=TRAIN_LR)
    out, failures = {}, []
    cases = [("train_mesh", TRAIN_ARCH, None, TRAIN_MESH_SHAPES),
             ("train_mesh_moe", *TRAIN_MESH_MOE, ((1, 2),)),
             ("train_mesh_ssm", *TRAIN_MESH_SSM, ((1, 2),))]
    for phase, arch, depth, shapes in cases:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        batches = train_batches(cfg, TRAIN_MESH_STEPS)
        ref = _mesh_reference(cfg, spec, batches[0])
        for data, model in shapes:
            _, fails, launches = mesh_grid_run(cfg, spec, ref, batches, data,
                                               model, mods, phase)
            failures += fails
            out[f"{cfg.name} TP={model} x DP={data}"] = launches
        del ref, batches
        gc.collect()
        torch.cuda.empty_cache()

    t_run = time.perf_counter()
    spec32 = dataclasses.replace(spec, eps=TRAIN_MESH_CHECK_EPS)
    parity = {}
    for arch, depth, shapes, seq in (
            (TRAIN_ARCH, TRAIN_MESH_CHECK_LAYERS, TRAIN_MESH_SHAPES,
             TRAIN_SEQ),
            *((arch, depth, ((1, 2),), TRAIN_MESH_FP32_SEQ)
              for arch, depth in TRAIN_MESH_FP32_FAMILIES)):
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  compute_dtype="float32")
        parity[cfg.name] = dict(mesh_fp32_parity(cfg, spec32, shapes, seq),
                                layers=depth, seq=seq)
        for tag, err in parity[cfg.name]["param_rel_err"].items():
            if not err <= TRAIN_MESH_PARAM_TOL:
                failures.append(f"{cfg.name} {tag}: fp32 parameters after "
                                f"{TRAIN_MESH_STEPS} steps {err} of "
                                f"max|param| from no mesh")
    emit("train_mesh_fp32", compute_dtype="float32",
         eps=TRAIN_MESH_CHECK_EPS, steps=TRAIN_MESH_STEPS, by_model=parity,
         tol=TRAIN_MESH_PARAM_TOL, seconds=time.perf_counter() - t_run,
         phase_seconds=time.perf_counter() - t_phase, failures=failures)
    if failures:
        raise AssertionError(f"train_mesh: {failures}")
    return out


def train_hypar_phase(mods) -> None:
    """``HyParTrainer`` (sync mode, greedy placement, on the card) against
    the fused step, same config and widths, depth cut to ``HYPAR_LAYERS``:
    ``HYPAR_STEPS`` steps of 2 micro-batches from the same parameters.
    HyPar runs first (its jobs leave their inputs untouched); the fused
    step then updates the same tensors in place."""
    from repro_torch.configs import get_config
    from repro_torch.core import VirtualCluster
    from repro_torch.optim import OptimizerSpec, init_opt_state
    from repro_torch.train import HyParTrainer, TrainState, make_train_step
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=HYPAR_LAYERS)
    spec = OptimizerSpec(kind="adamw", lr=TRAIN_LR)
    batches = train_batches(cfg, HYPAR_STEPS)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    micro = [[{k: v[m * mb:(m + 1) * mb] for k, v in b.items()}
              for m in range(TRAIN_ACCUM)] for b in batches]
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    trainer = HyParTrainer(cfg, spec, n_micro=TRAIN_ACCUM, mode="sync",
                           cluster=VirtualCluster([DEV], n_schedulers=1))
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, ho, report = trainer.run(micro, params=params)
    torch.cuda.synchronize()
    hypar_s = time.perf_counter() - t0
    hypar_launches = read_launches(mods)
    hypar_peak = torch.cuda.max_memory_allocated()
    # the trainer's cluster holds every job result while the trainer lives
    # (its registered functions close over it, so it goes with a collect):
    # drop them so that the fused run's peak is its own
    del ho, trainer
    gc.collect()
    torch.cuda.empty_cache()

    state = TrainState(params=params, opt_state=init_opt_state(spec, params))
    step = make_train_step(cfg, spec, grad_accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = read_launches(mods)
    fused_peak = torch.cuda.max_memory_allocated()

    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(tree_leaves(hp), tree_leaves(state.params)))
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(hp),
                                                    tree_leaves(state.params)))
    want = HYPAR_STEPS * TRAIN_ACCUM * cfg.n_layers * 2
    want_bwd = want // 2
    full = dataclasses.replace(cfg, n_layers=get_config(TRAIN_ARCH).n_layers)
    emit("train_hypar", model=cfg.name, layers=cfg.n_layers, seq=TRAIN_SEQ,
         global_batch=TRAIN_BATCH, n_micro=TRAIN_ACCUM, steps=HYPAR_STEPS,
         mode="sync", strategy="greedy", hypar_s=hypar_s, fused_s=fused_s,
         overhead_pct=100.0 * (hypar_s / fused_s - 1.0),
         params_max_rel_err=rel, tol=HYPAR_PARAM_TOL, bitwise_equal=bitwise,
         hypar_peak_memory_gib=hypar_peak / 2**30,
         fused_peak_memory_gib=fused_peak / 2**30,
         retained_opt_result_gib_at_full_depth=(
             3 * 4 * full.n_params() / 2**30),
         launches_hypar=hypar_launches, launches_fused=fused_launches,
         launches_expected_each=want, bwd_calls_expected_each=want_bwd,
         report=report.summary())
    if rel > HYPAR_PARAM_TOL:
        raise AssertionError(f"HyPar and fused params differ: {rel}")
    if any(n[kern] != w for n in (hypar_launches, fused_launches)
           for kern, w in (("flash_attention", want),
                           ("flash_attention_bwd", want_bwd))):
        raise AssertionError(f"flash launches {hypar_launches} / "
                             f"{fused_launches}, expected {want} forward "
                             f"and {want_bwd} backward each")
    del hp, state, params, micro, batches
    torch.cuda.empty_cache()


def train_proc_phase() -> None:
    """``HyParTrainer`` on ``ProcessExecutor``: 2 spawn workers on the card
    and a ``JobStore`` under ``build/`` (removed afterwards), against the
    thread trainer from the same start; then a second run over the same
    store, which must serve every job from it.  The widths and seq are
    ``train_hypar``'s; depth and steps are cut to ``PROC_LAYERS`` and
    ``PROC_STEPS``, and the optimizer is ``PROC_OPTIMIZER``, because every
    job result crosses the process boundary and lands in the store (at
    full width the embedding alone is 0.93 GB in fp32, and under AdamW the
    optimizer job's inputs hold it five times).  The
    children take their device from ``resolve_device("cuda")`` and the
    model's ``impl="auto"``, so their gradients run the flash forward and
    backward kernels; the parent's launch counters cannot see them."""
    from repro_torch.configs import get_config
    from repro_torch.core import JobStore, ProcessExecutor, VirtualCluster
    from repro_torch.optim import OptimizerSpec
    from repro_torch.train import HyParTrainer, procfns
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PROC_LAYERS)
    spec = OptimizerSpec(kind=PROC_OPTIMIZER, lr=TRAIN_LR)
    batches = train_batches(cfg, PROC_STEPS)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    micro = [[{k: v[m * mb:(m + 1) * mb] for k, v in b.items()}
              for m in range(TRAIN_ACCUM)] for b in batches]
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         DEV)
    trainer = HyParTrainer(cfg, spec, n_micro=TRAIN_ACCUM, mode="sync",
                           cluster=VirtualCluster([DEV], n_schedulers=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp, _, _ = trainer.run(micro, params=params)
    torch.cuda.synchronize()
    thread_s = time.perf_counter() - t0
    want = [t.cpu() for t in tree_leaves(tp)]
    del tp, trainer
    gc.collect()
    torch.cuda.empty_cache()

    store_dir = ROOT / "build" / "chip_smoke_train_proc"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    store = str(store_dir / "jobs.sqlite")
    procfns.export_env(cfg, spec, batch_keys=micro[0][0], device=DEV)
    runs = []
    try:
        for _ in range(2):
            made = []

            def factory(cluster, registry):
                ex = ProcessExecutor(
                    cluster, registry, procfns.WORKER_FNS_SPEC, store=store,
                    mode="pipelined", job_timeout_s=PROC_JOB_TIMEOUT_S,
                    heartbeat_interval_s=1.0, heartbeat_max_missed=30)
                made.append((ex, ex.wait_booted(PROC_BOOT_S)))
                return ex

            trainer = HyParTrainer(
                cfg, spec, n_micro=TRAIN_ACCUM, executor_factory=factory,
                cluster=VirtualCluster([DEV], n_schedulers=1,
                                       max_workers=PROC_WORKERS))
            t0 = time.perf_counter()
            pp, _, report = trainer.run(micro, params=params)
            secs = time.perf_counter() - t0
            ex, boot_s = made[0]
            got = tree_leaves(pp)
            rel = max(float((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30))
                      for a, b in zip(got, want))
            grads = [j for s in report.segments for j in s.jobs
                     if j.startswith("G")]
            runs.append({"seconds": secs, "workers_boot_s": boot_s,
                         "executed": ex.n_executed,
                         "memoised": len(report.memoised_jobs),
                         "grad_jobs_executed": len(
                             set(grads) - set(report.memoised_jobs)),
                         "params_max_rel_err": rel,
                         "bitwise_equal": all(torch.equal(a, b) for a, b
                                              in zip(got, want))})
            del pp, trainer, made, ex
            gc.collect()
        st = JobStore(store)
        try:
            nbytes, counts = st.payload_bytes(), st.counts()
            leaks = st.check_leaks()
        finally:
            st.close()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    first, second = runs
    emit("train_proc", model=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=cfg.n_params(),
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, n_micro=TRAIN_ACCUM,
         steps=PROC_STEPS, optimizer=PROC_OPTIMIZER, workers=PROC_WORKERS,
         device_of_workers=DEV,
         thread_s=thread_s, runs=runs, store_rows=counts,
         store_inline_bytes=nbytes["inline"],
         store_spilled_bytes=nbytes["spilled"], store_leaks=leaks,
         tol=PROC_PARAM_TOL)
    if any(r["params_max_rel_err"] > PROC_PARAM_TOL for r in runs):
        raise AssertionError(f"process-worker params differ from the "
                             f"thread trainer's: {runs}")
    if (second["executed"] != 0 or second["grad_jobs_executed"] != 0
            or second["memoised"] != first["executed"]
            or first["memoised"] != 0 or leaks):
        raise AssertionError(f"the second run was not served from the "
                             f"store: {runs}, leaks {leaks}")
    del params, micro, batches
    torch.cuda.empty_cache()


def train_launcher_phase(mods) -> None:
    """``repro_torch.launch.train.main`` on the card at ``--smoke``: 6 steps
    with a checkpoint every 3, then a resume to 8 from the same directory
    (under ``build/``, removed afterwards)."""
    import contextlib
    import io

    from repro_torch.launch.train import main as train_main

    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = []
    for steps in (6, 8):
        argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(steps),
                "--batch", "4", "--seq", "32", "--ckpt-dir", str(ckpt),
                "--ckpt-every", "3", "--log-every", "3", "--device", DEV]
        log = io.StringIO()
        reset_launches(mods)
        with contextlib.redirect_stdout(log):
            loss = train_main(argv)
        torch.cuda.synchronize()
        runs.append({"argv": " ".join(argv), "final_loss": loss,
                     "launches": read_launches(mods),
                     "log": log.getvalue().strip().splitlines()})
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("train_launcher", runs=runs)
    if not all(math.isfinite(r["final_loss"]) for r in runs):
        raise AssertionError(f"launcher losses not finite: {runs}")
    if not runs[1]["log"][0].startswith("resumed from checkpoint step 6"):
        raise AssertionError(f"the second run did not resume: {runs[1]}")
    # smoke config: 3 layers, no accumulation, the remat recompute
    for r, n_steps in zip(runs, (6, 2)):
        if (r["launches"]["flash_attention"] != n_steps * 3 * 2
                or r["launches"]["flash_attention_bwd"] != n_steps * 3):
            raise AssertionError(f"launcher flash launches: {r}")


# ---------------------------------------------------------------------------
# the kernel benchmark and tuner: RMSNorm, the bench, the cost-model bridge
# ---------------------------------------------------------------------------

RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # of max|plain|
RMS_EPS = 1e-6
# name, R, d, dtype: the kernel bench's shape; qwen2-1.5b's width at one
# micro-batch of the train phase (2 x 4096 tokens); ragged rows; the widest
# d (llama3-405b's); a d that leaves the vector loop ragged; an odd d, which
# defeats 16-byte vectors (the scalar path)
RMS_CASES = [
    ("bench", 4096, 1024, torch.float32),
    ("qwen2_train", 8192, 1536, torch.bfloat16),
    ("ragged_rows", 1000, 1536, torch.bfloat16),
    ("wide", 64, 16384, torch.bfloat16),
    ("ragged_d", 7, 200, torch.float32),
    ("odd_d", 5, 203, torch.float32),
]
CALIBRATION_MAX_SHARE = 1.05     # calibrated rate / the card's peak
JACOBI_COST_N = 2709


def rms_bound_ms(R: int, d: int, elt: int) -> tuple[float, str]:
    """Least time for RMSNorm on (R, d): x read once, the output written
    once and the fp32 gain read once over the memory rate, against 4
    operations an element (square-add, the mean's scale, two multiplies)
    over the fp32 rate."""
    t_bytes = (2 * R * d * elt + 4 * d) / H100_BYTES_PER_S * 1e3
    t_ops = 4.0 * R * d / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_kernel_phase() -> dict:
    """The RMSNorm kernel against its plain version at ``RMS_CASES`` under
    every rows-a-block candidate of the tuner; each case timed at every
    candidate beside its plain version, ``F.rms_norm`` and its bound."""
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    row_blocks = [c["row_block"] for c in DEFAULT_CANDIDATES["rmsnorm"]]
    gen = torch.Generator(device=DEV).manual_seed(5)
    entry, errs = None, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, R, d, dtype in RMS_CASES:
        x = torch.randn((R, d), generator=gen, device=DEV).to(dtype)
        g = torch.randn(d, generator=gen, device=DEV) + 1.0
        want = rmsnorm_plain(x, g, eps=RMS_EPS)
        scale = float(want.float().abs().max())
        case = {"case": name, "R": R, "d": d,
                "dtype": str(dtype).replace("torch.", ""),
                "tol": RMS_TOL[dtype], "rel_err_by_row_block": {}}
        for rb in row_blocks:
            got = rmsnorm_kernel(x, g, eps=RMS_EPS, row_block=rb)
            torch.cuda.synchronize()
            if (got.shape != x.shape or got.dtype != dtype
                    or not torch.isfinite(got.float()).all()):
                raise AssertionError(f"rmsnorm kernel output misshapen or "
                                     f"not finite ({name}, row_block {rb})")
            err = float((got.float() - want.float()).abs().max())
            case["rel_err_by_row_block"][rb] = err / scale
            errs[dtype] = max(errs[dtype], err)
            if err > RMS_TOL[dtype] * scale:
                raise AssertionError(f"rmsnorm kernel disagrees with plain: "
                                     f"{name}, row_block {rb}: {err} > "
                                     f"{RMS_TOL[dtype]} x {scale}")
        # timing: rotate over copies of x larger than the 50 MB L2
        x_bytes = x.numel() * x.element_size()
        n_copies = min(64, max(2, math.ceil(100e6 / x_bytes)))
        copies = [x.clone() for _ in range(n_copies)]
        by_rb = {rb: cuda_ms(lambda i, rb=rb: rmsnorm_kernel(
            copies[i % n_copies], g, eps=RMS_EPS, row_block=rb), 50)
            for rb in row_blocks}
        best = min(by_rb, key=by_rb.get)
        g_x = g.to(dtype)     # F.rms_norm's fused path wants one dtype
        bms, by = rms_bound_ms(R, d, x.element_size())
        case.update(
            ms=by_rb[best], row_block=best, ms_by_row_block=by_rb,
            plain_ms=cuda_ms(lambda i: rmsnorm_plain(
                copies[i % n_copies], g, eps=RMS_EPS), 10),
            library_ms=cuda_ms(lambda i: F.rms_norm(
                copies[i % n_copies], (d,), weight=g_x, eps=RMS_EPS), 50),
            bound_ms=bms, bound_by=by)
        emit("kernels", kernel="rmsnorm", **case)
        if name == "bench":
            entry = case
        del copies, x, want
    torch.cuda.empty_cache()
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:24",
            "shape": "R 4096, d 1024, fp32 (the kernel bench's)",
            "library_call": "F.rms_norm(x, (d,), weight=g.to(x.dtype), "
                            "eps=1e-6)",
            "max_abs_err": errs[torch.float32],
            "max_abs_err_bf16": errs[torch.bfloat16],
            **{k: entry[k] for k in ("ms", "row_block", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}}


def norm_switch_phase(rms_kernel) -> None:
    """``apply_norm(use_kernel=True)`` against ``use_kernel=False`` on a
    full-width qwen2-1.5b hidden state (one train micro-batch, bf16): the
    switch must launch the kernel once and agree within 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import apply_norm

    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=DEV).manual_seed(6)
    p = {"scale": 1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen,
                                          device=DEV)}
    h = torch.randn((TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, cfg.d_model),
                    generator=gen, device=DEV).to(torch.bfloat16)
    before = rms_kernel.launches
    got = apply_norm(cfg, p, h, use_kernel=True)
    torch.cuda.synchronize()
    launched = rms_kernel.launches - before
    want = apply_norm(cfg, p, h)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    emit("norm_switch", model=cfg.name, shape=list(h.shape), dtype="bfloat16",
         rel_err=rel, tol=RMS_TOL[torch.bfloat16], launches=launched)
    if launched != 1 or got.dtype != h.dtype or rel > RMS_TOL[torch.bfloat16]:
        raise AssertionError(f"apply_norm(use_kernel=True): {launched} "
                             f"launches, rel err {rel}")


def kernel_bench_check() -> None:
    """Every wrapper the autotune pass tunes, at the bench's shapes and on
    its inputs (``kernel_bench.tuned_cases``), under every candidate config
    of the tuner, against ``impl="ref"``: fp32, the flash forward in bf16
    (the dtype whose kernel takes the launch shapes), at the tolerances of
    the kernels' own phases."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    torch.backends.cuda.matmul.allow_tf32 = False

    def rel(got, want) -> float:
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    def absolute(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    # kernel -> (error of the kernel's outputs against the plain ones, tol)
    checks = {
        "jacobi_sweep": (lambda o, w: max(rel(o[0], w[0]), abs(
            float(o[1]) / float(w[1]) - 1.0)), JACOBI_TOL),
        "rmsnorm": (rel, RMS_TOL[torch.float32]),
        # bf16 on the card, the dtype of its launch shapes: its tolerance
        "flash_attention": (absolute, FA_TOL[torch.bfloat16]),
        "ssd_scan": (lambda o, w: max(rel(o[0], w[0]), rel(o[1], w[1])),
                     SSD_TOL),
        "paged_attention": (absolute, WRAPPER_TOL_F32),
    }
    results = {}
    for kernel, fn, args, shape, _, _ in kernel_bench.tuned_cases(device=DEV):
        err_fn, tol = checks[kernel]
        want = fn(*args, impl="ref")
        for cfg in DEFAULT_CANDIDATES[kernel]:
            got = fn(*args, impl="kernel", **cfg)
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            if not all(torch.isfinite(o.float()).all() for o in outs):
                raise AssertionError(f"{kernel} at the bench's shape "
                                     f"{shape}, config {cfg}: not finite")
            err = err_fn(got, want)
            results.setdefault(kernel, {"shape": list(shape), "tol": tol,
                                        "err_by_config": {}})
            results[kernel]["err_by_config"][json.dumps(cfg)] = err
            if not err <= tol:
                raise AssertionError(f"{kernel} at the bench's shape {shape}, "
                                     f"config {cfg}: error {err} > {tol}")
    emit("kernel_bench_check", kernels=results)
    torch.cuda.empty_cache()


def kernel_bench_phase(mods) -> tuple[dict, dict]:
    """``repro_torch.benchmarks.kernel_bench.run`` on the card against the
    fresh tuning cache ``main`` names in ``REPRO_TORCH_TUNE_CACHE``, with
    the launch counts set to 0 just before and read just after; then
    ``autotune_rows`` again, which must hit the cache for every kernel and
    time nothing; then the calibrated cost model beside
    ``CostModelParams()`` and the card's peaks.  Returns the bench run's
    launches and its rows by name."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.core.scheduler import CostModelParams
    from repro_torch.kernels import tuning

    kernel_bench_check()
    reset_launches(mods)
    t0 = time.perf_counter()
    rows = kernel_bench.run(device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(mods)
    ref = [r for r in rows if r["name"].endswith("_ref")]
    tuned = [r for r in rows if r["name"].endswith("_tuned")]
    for r in rows:
        r["bytes_per_s_share_of_hbm"] = (r["bytes"] / r["median_s"]
                                         / H100_BYTES_PER_S)
        peak = (H100_BF16_FLOPS if r["dtype"] == "bfloat16"
                else H100_FP32_FLOPS)
        r["flops_share_of_peak"] = r["flops"] / r["median_s"] / peak
        emit("kernel_bench_row", **r)
    by_name = {r["name"]: r for r in rows}
    paged = {k: by_name.get(f"paged_attention_{k}") for k in ("ref", "tuned")}
    flash = by_name.get("flash_attention_tuned")
    emit("kernel_bench", rows=len(rows), ref_rows=len(ref),
         tuned_rows=len(tuned), wall_s=wall, launches=launches,
         paged_attention={
             "ref_s": paged["ref"] and paged["ref"]["median_s"],
             "tuned_s": paged["tuned"] and paged["tuned"]["median_s"],
             "tuned_config": paged["tuned"] and paged["tuned"]["config"]},
         flash_attention={"tuned_s": flash and flash["median_s"],
                          "dtype": flash and flash["dtype"],
                          "tuned_config": flash and flash["config"]})
    if not flash or flash["config"] not in tuning.DEFAULT_CANDIDATES[
            "flash_attention"]:
        raise AssertionError(f"flash_attention_tuned names no launch shape "
                             f"of the grid: {flash}")
    if len(ref) != 6 or len(tuned) != 5:
        raise AssertionError(f"kernel bench gave {len(ref)} ref and "
                             f"{len(tuned)} tuned rows, expected 6 and 5")
    for r in rows:
        if not (math.isfinite(r["median_s"]) and r["median_s"] > 0):
            raise AssertionError(f"kernel bench row {r['name']}: median_s "
                                 f"{r['median_s']}")
    for r in tuned:
        if r["cache"] != "miss" or r["timed"] != r["candidates"]:
            raise AssertionError(f"first tune of {r['name']} timed "
                                 f"{r['timed']} of {r['candidates']} "
                                 f"candidates (cache {r['cache']})")
        kern = r["name"].removesuffix("_tuned")
        if launches[{"jacobi_sweep": "jacobi_sweep_residual"}.get(
                kern, kern)] == 0:
            raise AssertionError(f"the bench never launched {kern}")

    reset_launches(mods)
    again = kernel_bench.autotune_rows(device=DEV)
    relaunched = read_launches(mods)
    emit("kernel_bench_second_pass",
         cache=[r["cache"] for r in again], timed=[r["timed"] for r in again],
         launches=relaunched)
    if (any(r["cache"] != "hit" or r["timed"] != 0 for r in again)
            or any(relaunched.values())):
        raise AssertionError(f"second autotune pass was not all cache hits: "
                             f"{again}, launches {relaunched}")

    base = CostModelParams()
    cal = tuning.calibrated_cost_params(backend=torch.device(DEV).type)
    shares = {"peak_flops": cal.peak_flops / H100_FP32_FLOPS,
              "mem_bw": cal.mem_bw / H100_BYTES_PER_S}
    emit("kernel_bench_calibration", calibrated=dataclasses.asdict(cal),
         base=dataclasses.asdict(base),
         card_peaks={"peak_flops": H100_FP32_FLOPS,
                     "mem_bw": H100_BYTES_PER_S},
         share_of_card_peak=shares, max_share=CALIBRATION_MAX_SHARE)
    if cal.peak_flops == base.peak_flops or cal.mem_bw == base.mem_bw:
        raise AssertionError(f"calibration left the defaults: {cal}")
    if max(shares.values()) > CALIBRATION_MAX_SHARE:
        raise AssertionError(f"a calibrated rate exceeds the card's peak: "
                             f"{shares}")
    return launches, by_name


def jacobi_cost_phase(mods) -> None:
    """``jacobi_hypar(strategy="cost")`` at n ``JACOBI_COST_N`` with the
    tuned cache of the ``kernel_bench`` phase: seeded per-function times
    and calibrated params, against the tailored solve (same iterations, x
    within 1e-5) and beside a greedy HyPar solve."""
    from repro_torch.apps.jacobi import (jacobi_hypar, jacobi_tailored,
                                         make_system)
    from repro_torch.kernels import tuning

    torch.backends.cuda.matmul.allow_tf32 = False
    A, b, _ = make_system(JACOBI_COST_N, device=DEV)
    base = jacobi_tailored(A, b, iters=JACOBI_ITERS)
    reset_launches(mods)
    cost = jacobi_hypar(A, b, iters=JACOBI_ITERS, n_chunks=4,
                        strategy="cost")
    launches = read_launches(mods)
    greedy = jacobi_hypar(A, b, iters=JACOBI_ITERS, n_chunks=4)
    dx = float(np.max(np.abs(cost.x - base.x)))
    observed = cost.extra["observed_fn_times"]
    want_params = dataclasses.asdict(tuning.calibrated_cost_params(
        backend=torch.device(DEV).type))
    emit("jacobi_cost", n=JACOBI_COST_N, iters=cost.iters,
         tailored_iters=base.iters, max_dx_vs_tailored=dx, tol=JACOBI_X_TOL,
         seconds={"tailored": base.seconds, "hypar_cost": cost.seconds,
                  "hypar_greedy": greedy.seconds},
         overhead_pct={"hypar_cost": 100.0 * (cost.seconds / base.seconds
                                              - 1.0),
                       "hypar_greedy": 100.0 * (greedy.seconds
                                                / base.seconds - 1.0)},
         observed_fn_times=observed, cost_params=cost.extra["cost_params"],
         launches=launches, report=cost.extra["report"])
    if cost.iters != base.iters or dx > JACOBI_X_TOL:
        raise AssertionError(f"jacobi_hypar(strategy='cost'): {cost.iters} "
                             f"iterations against {base.iters}, max|Δx| {dx}")
    if (sorted(observed) != [f"sweep{i}" for i in range(4)]
            or cost.extra["cost_params"] != want_params):
        raise AssertionError(f"jacobi_hypar did not take the tuned seeds: "
                             f"{observed}, {cost.extra['cost_params']}")
    del A, b
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.jacobi_sweep import kernel as jacobi_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    smi = nvidia_smi_line()
    name, power = [s.strip() for s in smi.split(",", 1)]
    emit("device", name=name, power_limit=power,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = build.build_all(ptxas_verbose=True)
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])
    emit("build_flash_bwd", **ptxas_summary(
        build.BUILD_LOGS.get("flash_attention_bwd", "")))
    emit("build_flash_fwd", **ptxas_summary(
        build.BUILD_LOGS.get("flash_attention", "")))

    serve_mods = (pa_kernel, ssd_kernel, fa_kernel)
    entry = kernel_phase(n_layers=28)
    paged_serve = serve_paged_phase("serve", "qwen2-1.5b", serve_mods,
                                    requests=SERVE_REQUESTS, parity="parity",
                                    tag="")
    entry["launches"] = paged_serve["launches"]["paged_attention"]
    entry["launches_per_decode_step"] = (entry["launches"]
                                         / paged_serve["decode_steps"])
    entry["device_kernels_per_call"] = \
        paged_serve["device_kernels_per_call"]["paged_attention"]
    serve_hypar_phase(pa_kernel)
    # device groups and the robustness layer: the paged kernel, and SSD
    # in mamba2's chunks (counts read per run)
    entry["launches_serve_groups"] = serve_groups_phase(pa_kernel)
    groups_parity = serve_groups_parity_phase((pa_kernel, ssd_kernel))
    entry["launches_serve_groups_parity"] = groups_parity["paged_attention"]
    # the dense engine's paths: the flash forward in its batched prefills
    # and inserts, the SSD kernel likewise (counts read per phase)
    dense_launches = {
        "serve_dense_trace": serve_dense_trace_phase(serve_mods, paged_serve),
        "serve_waves": serve_waves_phase(
            "qwen2-1.5b", serve_mods, "dense",
            "serve_waves")["flash_attention"]}

    ssd_entry = ssd_kernel_phase(n_layers=48)
    ssm_serve = serve_paged_phase("serve_ssm", "mamba2-370m", serve_mods,
                                  requests=SERVE_REQUESTS,
                                  parity="parity_ssm", tag="")
    ssd_entry["launches"] = ssm_serve["launches"]["ssd_scan"]
    ssd_entry["launches_per_chunk"] = (ssd_entry["launches"]
                                       / ssm_serve["chunk_calls"])
    ssd_entry["device_kernels_per_call"] = \
        ssm_serve["device_kernels_per_call"]["ssd_scan"]
    ssd_entry["launches_serve_groups_parity"] = groups_parity["ssd_scan"]
    ssd_entry["launches_serve_waves_ssm"] = serve_waves_phase(
        "mamba2-370m", serve_mods, "ref", "serve_waves_ssm")["ssd_scan"]
    dense_vs_paged_phase(serve_mods)
    # the serving mesh: the paged kernel at a TP=2 position's shape, then
    # qwen2 and mamba2 served on meshes whose positions share the card
    # (counts read per run)
    mesh_shard = mesh_kernel_case()
    mesh_launches = serve_mesh_phase(serve_mods)
    entry["launches_serve_mesh"] = mesh_launches["paged_attention"]
    ssd_entry["launches_serve_mesh"] = mesh_launches["ssd_scan"]

    # the MoE and hybrid families: the three serving kernels at their
    # shapes, paged serving and the dense engine's waves (counts read per
    # phase); qwen2-moe's fp32 gate is cut to 4 layers (its fp32 weights
    # are 57 GB), zamba2's runs whole
    family_shapes = family_kernel_phase()
    family = {phase: serve_paged_phase(
        phase, arch, serve_mods, requests=FAMILY_REQUESTS,
        parity=f"parity_{phase[len('serve_'):]}", depth=depth)["launches"]
        for phase, arch, depth in (("serve_moe", "qwen2-moe-a2.7b", 4),
                                   ("serve_hybrid", "zamba2-1.2b", None))}
    for phase, arch, plain, cut in (
            ("serve_waves_moe", "qwen2-moe-a2.7b", "dense", 4),
            ("serve_waves_hybrid", "zamba2-1.2b", "ref", None)):
        family[phase] = serve_waves_phase(
            arch, serve_mods, plain, phase, waves=FAMILY_WAVES,
            max_new=FAMILY_WAVE_NEW, check_layers=cut)
    entry["launches_serve_moe"] = family["serve_moe"]["paged_attention"]
    entry["launches_serve_hybrid"] = family["serve_hybrid"]["paged_attention"]
    entry["by_model"] = family_shapes["paged_attention"]
    entry["by_model"][f"{MESH_ARCH} TP=2 position"] = mesh_shard
    ssd_entry["launches_serve_hybrid"] = family["serve_hybrid"]["ssd_scan"]
    ssd_entry["launches_serve_waves_hybrid"] = \
        family["serve_waves_hybrid"]["ssd_scan"]
    ssd_entry["by_model"] = family_shapes["ssd_scan"]

    # gemma3's local/global attention and whisper's encoder-decoder: the
    # flash forward at D 256 and at whisper's non-causal shapes, the paged
    # kernel at gemma3's decode; gemma3 paged (its fp32 gate at full depth)
    # and in waves of 2,048-token prompts, whisper's dense engine in waves
    # and a trace (counts read per phase)
    slice_shapes = gemma3_whisper_kernel_phase()
    gemma3 = serve_paged_phase("serve_gemma3", GEMMA3, serve_mods,
                               requests=FAMILY_REQUESTS,
                               parity="parity_gemma3",
                               parity_shape=GEMMA3_PARITY)["launches"]
    gemma3_waves = serve_waves_phase(
        GEMMA3, serve_mods, "dense", "serve_waves_gemma3",
        waves=FAMILY_WAVES, max_new=FAMILY_WAVE_NEW,
        prompt=GEMMA3_WAVE_PROMPT)
    whisper = serve_whisper_phases(serve_mods)
    entry["launches_serve_gemma3"] = gemma3["paged_attention"]
    entry["by_model"].update(slice_shapes["paged_attention"])

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

    mods = (pa_kernel, ssd_kernel, jacobi_kernel, fa_kernel)
    fa_entry, fa_bwd_entry = flash_kernel_phase()
    # every family's training: counts read per model
    trained = train_phase(mods)
    launches = trained.pop(TRAIN_ARCH)
    for e in (fa_entry, fa_bwd_entry):
        e["launches"] = launches[e["name"]]
        e["launches_per_step"] = e["launches"] / TRAIN_STEPS
    for phase, n in dense_launches.items():
        fa_entry[f"launches_{phase}"] = n
    for phase in ("serve_waves_moe", "serve_waves_hybrid"):
        fa_entry[f"launches_{phase}"] = family[phase]["flash_attention"]
    fa_entry["launches_serve_waves_gemma3"] = gemma3_waves["flash_attention"]
    for phase, n in whisper.items():
        fa_entry[f"launches_{phase}"] = n
    fa_entry["by_model"] = {**family_shapes["flash_attention"],
                            **slice_shapes["flash_attention"]}
    fa_bwd_entry["device_kernels_per_call"] = FA_BWD_KERNELS
    for e, key in ((fa_entry, "flash_attention"),
                   (fa_bwd_entry, "flash_attention_bwd"),
                   (ssd_entry, "ssd_scan")):
        e["launches_train_families"] = {m: n[key]
                                        for m, n in trained.items()}
    # the training mesh: qwen2-1.5b on TP=2, DP=2, TP=2 x DP=2, qwen2-moe
    # and mamba2 at TP=2 (counts read per grid)
    mesh_trained = train_mesh_phase(mods)
    for e, key in ((fa_entry, "flash_attention"),
                   (fa_bwd_entry, "flash_attention_bwd"),
                   (ssd_entry, "ssd_scan")):
        e["launches_train_mesh"] = {m: n[key]
                                    for m, n in mesh_trained.items()
                                    if n[key]}
    train_hypar_phase(mods)
    train_proc_phase()
    train_launcher_phase(mods)

    mods = (*mods, rms_kernel)
    rms_entry = rmsnorm_kernel_phase()
    norm_switch_phase(rms_kernel)
    # a fresh tuning cache under build/, for the bench and the solve
    tune_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_",
                                     dir=ROOT / "build"))
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tune_dir / "kernel_tune.json")
    try:
        bench, bench_rows = kernel_bench_phase(mods)
        jacobi_cost_phase(mods)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)
    rms_entry["launches"] = bench["rmsnorm"]
    # the SSD row's rate, by the reference's operation count, as a share
    # of the fp32 peak: what it offers the calibrated peak_flops
    ssd_row = bench_rows["ssd_scan_tuned"]
    ssd_entry["kernel_bench_config"] = ssd_row["config"]
    ssd_entry["peak_flops_share"] = ssd_row["flops_share_of_peak"]
    kernels = [entry, ssd_entry, *jacobi_entries, fa_entry, fa_bwd_entry,
               rms_entry]
    for e in kernels:
        e["launches_kernel_bench"] = bench[e["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
