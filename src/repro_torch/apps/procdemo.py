"""Spawn-safe demo workload for the process executor.

This module is imported by *worker child processes* (via the
``"repro_torch.apps.procdemo:FNS"`` spec), so its import stays cheap: plain
numpy functions at module level, with the master-side registry and graph
builders importing the core lazily.  They are the JAX package's functions,
so both packages compute the same bits.

The workload is a chain of chunkwise matmul+tanh segments over a fixed
weight ending in a whole-kind reduction — enough structure to exercise placement,
pipelining, memoisation and crash recovery, deterministic end to end.

``REPRO_PROCDEMO_SLEEP`` (seconds, float) slows every worker function down;
crash tests use it to widen the window for killing a worker mid-run.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["FNS", "WORKER_FNS_SPEC", "make_registry", "build_graph",
           "expected_results"]

WORKER_FNS_SPEC = "repro_torch.apps.procdemo:FNS"


def _maybe_sleep() -> None:
    s = float(os.environ.get("REPRO_PROCDEMO_SLEEP", "0") or 0.0)
    if s > 0:
        import time
        time.sleep(s)


def init_chunk(x: np.ndarray) -> np.ndarray:
    _maybe_sleep()
    return np.asarray(x, np.float64) * 0.1


def step(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Chunkwise matmul+tanh; called as ``step(weight, activation)`` in the
    demo graph (bound inputs are prepended by the executors)."""
    _maybe_sleep()
    return np.tanh(a @ b)


def reduce_sum(*inputs) -> np.ndarray:
    """Whole-kind: one chunk collection per input ref, summed.  Elements may
    be raw arrays (process child) or DataChunks (LocalExecutor parity)."""
    _maybe_sleep()
    chunks = [np.asarray(getattr(c, "data", c))
              for cd in inputs for c in cd]
    return np.sum(np.stack(chunks), axis=0)


FNS = {"pd_init": init_chunk, "pd_step": step, "pd_reduce": reduce_sum}


def _weight(dim: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    return (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float64)


def make_registry(host: bool = False):
    """Master-side registry mirroring :data:`FNS` (same fids, same kinds);
    the master only consults the *kinds* — execution happens in the child.

    ``host=True`` instead registers whole-kind wrappers with the same
    zip-over-chunks semantics over numpy views of the chunks, so the SAME
    graph runs on LocalExecutor's worker threads (whose chunks are CPU
    tensors) bit-identically to the process children."""
    from ..core import ChunkedData, DataChunk, FunctionKind, FunctionRegistry
    reg = FunctionRegistry()
    if host:
        def chunkzip(f):
            def wrap(*cds):
                lists = [[np.asarray(getattr(c, "data", c)) for c in cd]
                         for cd in cds]
                return ChunkedData([DataChunk(f(*args))
                                    for args in zip(*lists)])
            return wrap

        reg.register("pd_init", chunkzip(init_chunk), kind=FunctionKind.WHOLE)
        reg.register("pd_step", chunkzip(step), kind=FunctionKind.WHOLE)
        reg.register("pd_reduce",
                     lambda *cds: ChunkedData([DataChunk(reduce_sum(*cds))]),
                     kind=FunctionKind.WHOLE)
        return reg
    reg.register("pd_init", init_chunk, kind=FunctionKind.CHUNKWISE)
    reg.register("pd_step", step, kind=FunctionKind.CHUNKWISE)
    reg.register("pd_reduce", reduce_sum, kind=FunctionKind.WHOLE)
    return reg


def build_graph(*, width: int = 4, depth: int = 3, dim: int = 16,
                seed: int = 0):
    """``width`` parallel chains of ``depth`` chunkwise steps feeding one
    whole-kind reduction.  Deterministic in ``seed``."""
    from ..core import (ChunkedData, ChunkRef, DataChunk, Job, JobGraph,
                        ParallelSegment)

    def host_chunks(*arrays):
        # float64 CPU tensors sharing the numpy arrays' memory
        return ChunkedData([DataChunk(a) for a in arrays])

    rng = np.random.default_rng(seed)
    w = _weight(dim)
    g = JobGraph([ParallelSegment(
        [Job(f"init{i}", "pd_init") for i in range(width)])])
    for i in range(width):
        g.bind_input(f"init{i}", host_chunks(
            rng.standard_normal((dim, dim)).astype(np.float64)))
    prev = [f"init{i}" for i in range(width)]
    for d in range(depth):
        jobs = []
        for i in range(width):
            name = f"step{d}_{i}"
            jobs.append(Job(name, "pd_step",
                            inputs=(ChunkRef(prev[i]),)))
            g.bind_input(name, host_chunks(w))
        g.add_segment(jobs)
        prev = [j.name for j in jobs]
    g.add_segment([Job("reduce", "pd_reduce",
                       inputs=tuple(ChunkRef(p) for p in prev))])
    return g


def expected_results(*, width: int = 4, depth: int = 3, dim: int = 16,
                     seed: int = 0) -> dict[str, list[np.ndarray]]:
    """Pure-numpy oracle for :func:`build_graph` — what any executor must
    produce, bit for bit."""
    rng = np.random.default_rng(seed)
    w = _weight(dim)
    out: dict[str, list[np.ndarray]] = {}
    prev = []
    for i in range(width):
        x = init_chunk(rng.standard_normal((dim, dim)).astype(np.float64))
        out[f"init{i}"] = [x]
        prev.append(x)
    for d in range(depth):
        nxt = []
        for i in range(width):
            # note: graph binds the weight FIRST (bound inputs prepend), so
            # the chunkwise call is step(w, x) — mirror that order here
            y = step(w, prev[i])
            out[f"step{d}_{i}"] = [y]
            nxt.append(y)
        prev = nxt
    out["reduce"] = [reduce_sum(*[[p] for p in prev])]
    return out
