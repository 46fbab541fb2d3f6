"""Per-kernel microbenchmarks and the autotune pass of the port: the
counterpart of the JAX package's ``benchmarks/kernel_bench.py``.

Run from the root of a checkout::

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench \\
        [--smoke] [--device cuda|cpu] [--out PATH]

Two row families, in the schema-v1 BENCH row format ``{name, backend,
device, shape, dtype, median_s, bytes, flops, ...}`` (``device`` is the
card's name, or ``cpu``):

* ``*_ref``: the plain PyTorch versions at the reference's benchmark
  shapes (``--smoke``: its small ones);
* ``*_tuned``: each kernel's wrapper timed through the autotuner
  (:mod:`repro_torch.kernels.tuning`) over its candidate launch shapes.
  On the card these are the hand-written kernels at the shapes the
  reference tunes on its chip; on the CPU, the plain versions (what
  ``auto`` runs there) at its small shapes, which exercises the same cache
  round trip.  Entries land in the persistent cache
  (``REPRO_TORCH_TUNE_CACHE``), so a second run times nothing, and the
  wrappers and the scheduler's cost model pick them up.

On the card every timed call rotates over copies of its inputs larger
than twice the 50 MB L2, so ``bytes / median_s`` is a device-memory rate
and not an L2 one.  The byte and operation counts are the reference's, row
for row; on the card the two flash rows run in bf16 (the dtype whose
kernel takes the tuned ``q_block``/``kv_block``), so their bytes are half
the reference's fp32 ones.  Nothing is written unless ``--out`` is given.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.jacobi_sweep.ops import (jacobi_sweep,
                                                  jacobi_sweep_residual)
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk

__all__ = ["bench_row", "ref_rows", "tuned_cases", "autotune_rows", "run",
           "main"]

#: the H100's L2; timed calls on the card rotate over twice this in inputs
L2_BYTES = 50e6


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel benchmark runs on CUDA by default and "
                           "found no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _cycle(args: tuple, dev: torch.device) -> Callable[[], tuple]:
    """A function giving ``args`` again on every call; on the card it
    cycles over copies of them that together exceed twice the L2, so no
    call finds its inputs there."""
    if dev.type != "cuda":
        return lambda: args
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
    copies = itertools.cycle([
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(n)])
    return lambda: next(copies)


def _time(fn, *args, dev: torch.device, iters: int = 5, **kw) -> float:
    """Median seconds per call, first call excluded: the statistic the
    autotuner records (:func:`tuning.median_call_s`), so ``median_s`` means
    the same thing in both row families."""
    nxt = _cycle(args, dev)
    return tuning.median_call_s(lambda: fn(*nxt(), **kw), iters)


def bench_row(name, shape, dtype, median_s, *, dev: torch.device,
              flops=0.0, nbytes=0.0, **extra) -> dict:
    """The one constructor of the schema-v1 BENCH row."""
    r = {"name": name, "backend": dev.type, "device": _device_name(dev),
         "shape": list(shape), "dtype": str(dtype), "median_s": median_s,
         "bytes": nbytes, "flops": flops}
    r.update(extra)
    return r


def _flash_dtype(dev: torch.device) -> torch.dtype:
    """The flash rows' dtype: bf16 on the card, where the forward kernel's
    launch shapes live (its fp32 twin has one), fp32 elsewhere, as the
    reference's rows."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _dt_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _randn(gen, dev, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev)


def _paged_inputs(gen, dev, B, H, KV, D, page_size, n_pages):
    """Serve-shaped decode inputs: full table rows (worst-case gather
    width), one pool page per logical page, three-quarter-full slots."""
    P = 1 + B * n_pages
    q = _randn(gen, dev, B, 1, H, D)
    kp = _randn(gen, dev, P, KV, page_size, D)
    vp = _randn(gen, dev, P, KV, page_size, D)
    tbl = torch.arange(1, P, dtype=torch.int32, device=dev).reshape(
        B, n_pages)
    kv_len = torch.full((B,), (3 * n_pages * page_size) // 4,
                        dtype=torch.int32, device=dev)
    kt = _randn(gen, dev, B, KV, 1, D)
    vt = _randn(gen, dev, B, KV, 1, D)
    return q, kp, vp, tbl, kv_len, kt, vt


def _ssd_inputs(gen, dev, BC, Hs, Q, P, N):
    xh = _randn(gen, dev, BC, Hs, Q, P)
    dt = F.softplus(_randn(gen, dev, BC, Hs, Q, 1))
    return xh, dt, -dt * 0.5, _randn(gen, dev, BC, Q, N), \
        _randn(gen, dev, BC, Q, N)


def _jacobi_inputs(gen, dev, n):
    A = _randn(gen, dev, n, n) / n + torch.eye(n, device=dev) * 3
    return A, _randn(gen, dev, n), _randn(gen, dev, n), \
        torch.diagonal(A).contiguous()


# ---------------------------------------------------------------------------
# Plain-version timings
# ---------------------------------------------------------------------------


def ref_rows(smoke: bool = False, device="cuda") -> list[dict]:
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    B, S, H, KV, D = (1, 256, 4, 2, 32) if smoke else (1, 1024, 8, 2, 64)
    dt = _flash_dtype(dev)
    q, k, v = (_randn(gen, dev, B, S, h, D).to(dt) for h in (H, KV, KV))
    s = _time(flash_attention, q, k, v, dev=dev, impl="ref")
    flops = 2 * 2 * B * H * S * S // 2 * D
    rows.append(bench_row("flash_attention_ref", (B, S, H, D), _dt_name(dt),
                          s, dev=dev, flops=flops, nbytes=_nbytes(q, k, v)))

    BC, Hs, Q, P, N = (2, 2, 32, 16, 16) if smoke else (8, 8, 128, 64, 64)
    xh, dt, a, Bm, Cm = _ssd_inputs(gen, dev, BC, Hs, Q, P, N)
    s = _time(ssd_intra_chunk, xh, dt, a, Bm, Cm, dev=dev, impl="ref")
    rows.append(bench_row("ssd_intra_chunk_ref", (BC, Hs, Q, P, N),
                          "float32", s, dev=dev,
                          flops=2.0 * BC * Hs * Q * Q * (P + N),
                          nbytes=4.0 * (xh.numel() + Bm.numel()
                                        + Cm.numel())))

    R, d = (256, 512) if smoke else (4096, 1024)
    x = _randn(gen, dev, R, d)
    g = torch.ones((d,), device=dev)
    s = _time(rmsnorm, x, g, dev=dev, impl="ref")
    rows.append(bench_row("rmsnorm_ref", (R, d), "float32", s, dev=dev,
                          flops=3.0 * x.numel(), nbytes=2.0 * x.numel() * 4))

    B, H, KV, D, ps, npg = (4, 4, 2, 32, 8, 4) if smoke else \
        (8, 8, 2, 64, 16, 16)
    paged = _paged_inputs(gen, dev, B, H, KV, D, ps, npg)
    s = _time(paged_decode_attention, *paged, dev=dev, impl="ref")
    T = npg * ps
    rows.append(bench_row("paged_attention_ref", (B, H, T, D), "float32", s,
                          dev=dev, flops=2.0 * 2 * B * H * T * D,
                          nbytes=4.0 * 2 * B * T * KV * D))

    n = 512 if smoke else 2048
    jac = _jacobi_inputs(gen, dev, n)
    s = _time(jacobi_sweep, *jac, dev=dev, impl="ref")
    rows.append(bench_row("jacobi_sweep_ref", (n, n), "float32", s, dev=dev,
                          flops=2.0 * n * n, nbytes=4.0 * n * n))
    s = _time(jacobi_sweep_residual, *jac, dev=dev, impl="ref")
    rows.append(bench_row("jacobi_sweep_residual_ref", (n, n), "float32", s,
                          dev=dev, flops=2.0 * n * n, nbytes=4.0 * n * n))
    return rows


# ---------------------------------------------------------------------------
# Autotune pass (populates the persistent tuning cache)
# ---------------------------------------------------------------------------


def tuned_cases(smoke: bool = False, device="cuda") -> list[tuple]:
    """The autotune pass's work, one ``(kernel, wrapper, args, shape, flops,
    bytes)`` a kernel, with its inputs made from seed 1: on the card at the
    shapes the reference tunes on its chip, on the CPU at its small ones.
    ``wrapper(*args, impl=..., **config)`` runs one candidate."""
    dev = _device(device)
    card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []

    # jacobi sweep (the fused-residual path: the §4 hot loop)
    n = 2048 if card else (128 if smoke else 256)
    cases.append(("jacobi_sweep", jacobi_sweep_residual,
                  _jacobi_inputs(gen, dev, n), (n, n), 2.0 * n * n,
                  4.0 * n * n))

    R, d = (4096, 1024) if card else ((32, 128) if smoke else (64, 256))
    x = _randn(gen, dev, R, d)
    cases.append(("rmsnorm", rmsnorm, (x, torch.ones((d,), device=dev)),
                  (R, d), 3.0 * x.numel(), 2.0 * x.numel() * 4))

    # flash attention in the dtype its launch shapes serve (bf16 on the
    # card: the fp32 kernel has one shape)
    B, S, H, KV, D = (1, 2048, 8, 2, 64) if card else (1, 128, 2, 2, 32)
    dt = _flash_dtype(dev)
    q, k, v = (_randn(gen, dev, B, S, h, D).to(dt) for h in (H, KV, KV))
    cases.append(("flash_attention", flash_attention, (q, k, v),
                  (B, S, H, D), 2.0 * 2 * B * H * S * S // 2 * D,
                  _nbytes(q, k, v)))

    # ssd scan (its launch shape is the rows of a tile of the y/S pass)
    BC, Hs, Q, P, N = (8, 8, 128, 64, 64) if card else (2, 2, 32, 16, 16)
    ssd = _ssd_inputs(gen, dev, BC, Hs, Q, P, N)
    cases.append(("ssd_scan", ssd_intra_chunk, ssd, (BC, Hs, Q, P, N),
                  2.0 * BC * Hs * Q * Q * (P + N),
                  4.0 * (ssd[0].numel() + ssd[3].numel() + ssd[4].numel())))

    # paged flash-decode attention (the whole wrapper: kernel + self term)
    B2, H2, KV2, D2, ps2, np2 = (8, 8, 2, 64, 16, 16) if card else \
        (2, 4, 2, 32, 8, 4)
    paged = _paged_inputs(gen, dev, B2, H2, KV2, D2, ps2, np2)
    T2 = np2 * ps2
    cases.append(("paged_attention", paged_decode_attention, paged,
                  tuple(paged[0].shape), 2.0 * 2 * B2 * H2 * T2 * D2,
                  4.0 * 2 * B2 * T2 * KV2 * D2))
    return cases


def autotune_rows(smoke: bool = False, device="cuda") -> list[dict]:
    """One ``*_tuned`` row a kernel of :func:`tuned_cases`, tuned through
    the shared tuner (:func:`tuning.get_tuner`).  Besides the schema's
    fields a row carries the winning ``config``, ``cache`` (``hit`` or
    ``miss``), ``candidates`` (the grid's size) and ``timed`` (candidates
    this call timed: 0 on a hit)."""
    dev = _device(device)
    backend = dev.type
    impl = tuning.default_impl(backend)
    tuner = tuning.get_tuner()
    rows = []
    for kernel, fn, args, shape, flops, nbytes in tuned_cases(smoke, dev):
        cands = tuning.DEFAULT_CANDIDATES[kernel]
        nxt = _cycle(args, dev)
        dt = args[0].dtype
        hit = tuner.observed_s(kernel, shape, dt,
                               backend=backend) is not None
        before = tuner.n_timed
        entry = tuner.tune(
            kernel, lambda cfg, fn=fn: (lambda: fn(*nxt(), impl=impl, **cfg)),
            shape=shape, dtype=dt, backend=backend,
            candidates=cands, flops=flops, bytes_moved=nbytes)
        rows.append(bench_row(f"{kernel}_tuned", shape, _dt_name(dt),
                              entry["median_s"], dev=dev, flops=flops,
                              nbytes=nbytes, config=entry["config"],
                              cache="hit" if hit else "miss",
                              candidates=len(cands),
                              timed=tuner.n_timed - before))
    return rows


def run(smoke: bool = False, device="cuda") -> list[dict]:
    return (ref_rows(smoke=smoke, device=device)
            + autotune_rows(smoke=smoke, device=device))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small shapes for the ref rows")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="write {schema_version, rows} here")
    args = ap.parse_args(argv)
    rows = run(smoke=args.smoke, device=args.device)
    for r in rows:
        extra = (f" config={r['config']} cache={r['cache']}"
                 if "config" in r else "")
        print(f"{r['name']},{r['median_s'] * 1e6:.1f}us{extra}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"schema_version": 1, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
