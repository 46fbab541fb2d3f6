"""Kernel autotuning for the port, the counterpart of the JAX package's
``repro/kernels/tuning.py``.

* a **launch-shape search**: time each candidate config and keep the
  fastest (:meth:`Autotuner.tune`);
* a **persistent JSON cache** keyed by ``kernel|backend|impl|bucket|dtype``
  so the search runs once per machine (:class:`TuningCache`; corrupt,
  truncated, foreign-schema and legacy 4-part entries are dropped, never
  fatal).  The schema and the dtype names are the reference's, so a cache
  written by either package reads the same in the other;
* **consultation** from the ``ops.py`` wrappers: when the caller does not
  pin a launch shape, :meth:`Autotuner.lookup` supplies the tuned one
  (cache only: a wrapper never times anything);
* the **cost-model bridge**: measured kernel rates calibrate
  :class:`repro_torch.core.scheduler.CostModelParams`
  (:func:`calibrated_cost_params`), and tuned times seed the master
  scheduler's per-function times (``apps/jacobi.py``).

The backend is the device type of the tensors a kernel runs on (``cuda``
or ``cpu``), always passed in, never read from a global.  The impl a real
run takes there (:func:`default_impl`) is ``kernel`` on ``cuda`` and
``ref`` (the plain version) on ``cpu``: the reference's ``kernel`` on a
TPU and ``interpret`` elsewhere.

Timing: a sample is enough back-to-back calls to last at least
:data:`MIN_SAMPLE_S`, since one call of a microsecond kernel would time
its launch and a synchronisation.  On a CUDA output the default timer is
CUDA events (:func:`device_seconds`), with the device first held by a sleep kernel while the
sample's launches queue behind it, so the events time the device's work
and not the host's launch rate; an injected ``timer`` (a
``time.perf_counter`` stand-in, as the tests use) or a CPU output takes
host-clock samples, the device synchronised around each.  Inputs are the
caller's: a caller that wants device-memory rates (the kernel benchmark
does) rotates over input copies larger than the card's L2.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "DEFAULT_CANDIDATES",
    "MIN_SAMPLE_S",
    "TuningCache",
    "Autotuner",
    "get_tuner",
    "shape_bucket",
    "cache_key",
    "default_impl",
    "device_seconds",
    "median_call_s",
    "calibrated_cost_params",
]

# Candidate grids per kernel: CUDA launch shapes, each a valid kwarg set of
# the kernel's ops-level wrapper.  The RMSNorm kernel takes its rows (warps)
# a block at launch, the paged flash-decode kernel its logical pages a
# split (block), the flash forward its query rows and keys a tile (the
# reference's key names), the SSD kernel the rows of a tile of its y/S
# pass (the reference's grid is one empty config: its TPU kernel has one
# launch shape); the Jacobi kernels have one fixed launch shape, so their
# grid is one empty config, and timing it feeds the cost-model bridge.
DEFAULT_CANDIDATES: dict[str, list[dict[str, int]]] = {
    "rmsnorm": [{"row_block": r} for r in (1, 2, 4, 8)],
    "jacobi_sweep": [{}],
    "flash_attention": [{"q_block": q, "kv_block": k} for q in (64, 128)
                        for k in (64, 128)],
    "ssd_scan": [{"row_tile": r} for r in (32, 64)],
    "paged_attention": [{"pages_per_split": p} for p in (1, 2, 4, 8, 16)],
}

#: shortest sample: calls per sample are raised until one lasts this long
MIN_SAMPLE_S = 1e-3
#: samples a candidate; its time is their median
TUNE_ITERS = 3
_MAX_REPS = 10_000
_SLEEP_CYCLES_PER_S = 2e9        # the device's sleep kernel counts cycles
_MAX_SLEEP_CYCLES = 2e10

_ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro_torch", "kernel_tune.json")


def shape_bucket(shape: Sequence[int]) -> tuple[int, ...]:
    """Round every dim up to the next power of two: one cache entry serves
    the whole bucket."""
    return tuple(1 if d <= 1 else 2 ** math.ceil(math.log2(d)) for d in shape)


def default_impl(backend: str) -> str:
    """The impl a real run on ``backend`` resolves ``auto`` to: the only
    impl whose timings describe that backend's hardware."""
    return "kernel" if backend == "cuda" else "ref"


def _dtype_name(dtype) -> str:
    """``float32``, ``bfloat16``, ...: the reference's names, for a torch
    dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def cache_key(kernel: str, backend: str, shape: Sequence[int], dtype,
              impl: str | None = None) -> str:
    """Five-part key ``kernel|backend|impl|bucket|dtype``; ``impl`` is the
    resolved path the timing was taken under (default: the backend's real
    one), so a forced plain-version run on a card never answers a kernel
    lookup."""
    bucket = "x".join(str(d) for d in shape_bucket(shape))
    impl = impl or default_impl(backend)
    return f"{kernel}|{backend}|{impl}|{bucket}|{_dtype_name(dtype)}"


class TuningCache:
    """Persistent JSON store: key -> {config, median_s, flops, bytes, ...}."""

    def __init__(self, path: str | None = None):
        self.path = path or os.environ.get(_ENV_CACHE) or _DEFAULT_CACHE
        self._entries: dict[str, dict] = {}
        self._loaded = False

    def load(self) -> dict[str, dict]:
        if self._loaded:
            return self._entries
        self._loaded = True
        try:
            with open(self.path) as f:
                raw = json.load(f)
            entries = raw.get("entries", raw) if isinstance(raw, dict) else {}
            if isinstance(entries, dict):
                # drop malformed entries here (they would crash every
                # lookup later) and legacy 4-part keys, which cannot say
                # which impl they were timed under
                self._entries = {
                    k: v for k, v in entries.items()
                    if isinstance(v, dict)
                    and isinstance(v.get("config"), dict)
                    and isinstance(v.get("median_s"), (int, float))
                    and len(k.split("|")) == 5}
        except (OSError, ValueError):
            # missing, unreadable or corrupt: start fresh; tuning is an
            # optimisation, never a correctness dependency
            self._entries = {}
        return self._entries

    def save(self) -> None:
        d = os.path.dirname(self.path)
        # atomic replace, never fatal (a read-only file system, or a config
        # value json cannot write), and no temp file left behind
        tmp = None
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"version": 1, "entries": self._entries}, f,
                          indent=1)
            os.replace(tmp, self.path)
        except Exception:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def get(self, key: str) -> dict | None:
        return self.load().get(key)

    def put(self, key: str, entry: dict) -> None:
        self.load()
        self._entries[key] = entry
        self.save()

    def __len__(self) -> int:
        return len(self.load())


def _cuda_device(out) -> torch.device | None:
    """The CUDA device of the first CUDA tensor in ``out`` (a tensor or a
    nest of tuples and lists), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if isinstance(out, (tuple, list)):
        for o in out:
            dev = _cuda_device(o)
            if dev is not None:
                return dev
    return None


def device_seconds(fn: Callable[[int], Any], reps: int,
                   dev: torch.device | None = None) -> float:
    """Device seconds of ``reps`` back-to-back calls ``fn(0) .. fn(reps-1)``
    on CUDA device ``dev`` (default: the current one), by CUDA events,
    after one warm-up call ``fn(0)``.  The device first sleeps for 1.5× the
    host time the calls take to enqueue (measured on the warm-up call), so
    every launch is queued before the first runs: the events then time the
    device's work, not the host's launch rate."""
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(1.5 * reps * host_s * _SLEEP_CYCLES_PER_S,
                                  _MAX_SLEEP_CYCLES)))
        start.record()
        for i in range(reps):
            fn(i)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3


def median_call_s(fn: Callable[[], Any], iters: int, *,
                  timer: Callable[[], float] | None = None) -> float:
    """Median seconds per call of ``fn`` over ``iters`` samples, the first
    call excluded (it builds the kernel).  See the module docstring for
    what a sample is; ``timer`` forces host-clock samples."""
    dev = _cuda_device(fn())

    def sample(reps: int) -> float:
        if timer is None and dev is not None:
            return device_seconds(lambda i: fn(), reps, dev)
        clock = timer or time.perf_counter
        if dev is not None:
            torch.cuda.synchronize(dev)
        t0 = clock()
        for _ in range(reps):
            fn()
        if dev is not None:
            torch.cuda.synchronize(dev)
        return clock() - t0

    one = sample(1)
    reps = max(1, min(_MAX_REPS, math.ceil(MIN_SAMPLE_S / max(one, 1e-9))))
    samples = sorted(sample(reps) / reps for _ in range(iters))
    return samples[len(samples) // 2]


class Autotuner:
    """Launch-shape search + cache consultation.

    ``timer`` is injectable (tests use a seeded stub so selection is
    deterministic); it must behave like ``time.perf_counter``.
    ``n_timed`` counts the candidates this tuner has timed, so a caller can
    show that a cache hit timed none.
    """

    def __init__(self, cache: TuningCache | None = None, *,
                 timer: Callable[[], float] | None = None):
        # `is not None`, not truthiness: an empty TuningCache has len 0
        self.cache = cache if cache is not None else TuningCache()
        self.timer = timer
        self.n_timed = 0

    def tune(self, kernel: str, make_call: Callable[[dict], Callable[[], Any]],
             *, shape: Sequence[int], dtype, backend: str,
             candidates: Iterable[Mapping[str, int]] | None = None,
             flops: float = 0.0, bytes_moved: float = 0.0) -> dict:
        """Find (or recall) the fastest config for ``kernel`` at ``shape``
        on ``backend``.

        ``make_call(config)`` returns a zero-arg callable running the kernel
        with that config; a config the wrapper refuses (``ValueError`` or
        ``TypeError``, its argument checks) is skipped, and any other error,
        a failed launch among them, reaches the caller.  The winning
        entry, ``{config, median_s, flops, bytes, backend, impl, timed}``,
        is persisted under the impl-resolved key; a later call with the
        same key returns it without timing anything.  ``make_call`` must
        run the backend's real path (:func:`default_impl`)."""
        impl = default_impl(backend)
        key = cache_key(kernel, backend, shape, dtype, impl)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        cands = list(candidates if candidates is not None
                     else DEFAULT_CANDIDATES.get(kernel, [{}]))
        best_cfg, best_t, timed, last_exc = None, float("inf"), 0, None
        for cfg in cands:
            try:
                t = median_call_s(make_call(dict(cfg)), TUNE_ITERS,
                                  timer=self.timer)
            except (ValueError, TypeError) as e:  # invalid for this shape
                last_exc = e
                continue
            timed += 1
            self.n_timed += 1
            if t < best_t:
                best_cfg, best_t = dict(cfg), t
        if best_cfg is None:
            raise RuntimeError(
                f"autotune({kernel}): no candidate ran for shape "
                f"{tuple(shape)}") from last_exc
        entry = {"config": best_cfg, "median_s": best_t, "flops": flops,
                 "bytes": bytes_moved, "backend": backend, "impl": impl,
                 "timed": timed}
        self.cache.put(key, entry)
        return entry

    def lookup(self, kernel: str, shape: Sequence[int], dtype, backend: str,
               impl: str | None = None) -> dict | None:
        """Tuned config for (kernel, backend, impl, bucket, dtype), or
        None."""
        entry = self.cache.get(cache_key(kernel, backend, shape, dtype,
                                         impl))
        return dict(entry["config"]) if entry else None

    def observed_s(self, kernel: str, shape: Sequence[int], dtype,
                   backend: str, impl: str | None = None,
                   nearest: bool = False) -> float | None:
        """Measured median seconds of the tuned config, or None.

        With ``nearest=True`` a miss falls back to the closest tuned bucket
        of the same kernel, backend, impl and dtype, its time scaled by the
        element-count ratio ∏shape / ∏bucket (the benchmark tunes one
        bucket a kernel; n 2709 buckets to 4096, the tune at 2048)."""
        impl = impl or default_impl(backend)
        entry = self.cache.get(cache_key(kernel, backend, shape, dtype,
                                         impl))
        if entry is not None:
            return float(entry["median_s"])
        if not nearest:
            return None
        want = shape_bucket(shape)
        name = _dtype_name(dtype)
        best = None
        for key, e in self.cache.load().items():
            parts = key.split("|")
            if (len(parts) != 5 or parts[0] != kernel
                    or parts[1] != backend or parts[2] != impl
                    or parts[4] != name):
                continue
            try:
                bucket = tuple(int(d) for d in parts[3].split("x"))
            except ValueError:
                continue
            if len(bucket) != len(want):
                continue
            dist = abs(math.log(math.prod(want) / math.prod(bucket)))
            if best is None or dist < best[0]:
                best = (dist, bucket, e)
        if best is None:
            return None
        _, bucket, e = best
        return float(e["median_s"]) * math.prod(shape) / math.prod(bucket)


_tuners: dict[str, Autotuner] = {}


def get_tuner(cache_path: str | None = None) -> Autotuner:
    """One tuner per cache path (``REPRO_TORCH_TUNE_CACHE`` redirects)."""
    path = cache_path or os.environ.get(_ENV_CACHE) or _DEFAULT_CACHE
    t = _tuners.get(path)
    if t is None:
        t = Autotuner(TuningCache(path))
        _tuners[path] = t
    return t


def calibrated_cost_params(*, backend: str, tuner: Autotuner | None = None):
    """``CostModelParams`` from observed kernel rates on ``backend``.

    Every float32 cache entry of ``backend`` under its real impl
    (:func:`default_impl`) that recorded flops or bytes gives an achieved
    rate ``flops / median_s`` and ``bytes / median_s``; the best of each
    replace the default ``CostModelParams()``'s roofline guesses.  Entries
    of other backends, timed under another impl (the plain version forced
    on a card), or of another dtype (the bf16 flash forward runs on tensor
    cores, not in the fp32 units the cost model prices jobs in) are
    ignored.  With no usable entry the defaults come back as they are."""
    from repro_torch.core.scheduler import CostModelParams
    base = CostModelParams()
    tuner = tuner or get_tuner()
    want_impl = default_impl(backend)
    peak, bw = 0.0, 0.0
    for key, entry in tuner.cache.load().items():
        if (entry.get("backend") != backend
                or entry.get("impl") != want_impl
                or key.split("|")[-1] != "float32"):
            continue
        t = float(entry.get("median_s") or 0.0)
        if t <= 0:
            continue
        peak = max(peak, float(entry.get("flops") or 0.0) / t)
        bw = max(bw, float(entry.get("bytes") or 0.0) / t)
    if peak <= 0.0 and bw <= 0.0:
        return base
    return CostModelParams(peak_flops=peak or base.peak_flops,
                           mem_bw=bw or base.mem_bw, link_bw=base.link_bw,
                           dispatch_s=base.dispatch_s)
