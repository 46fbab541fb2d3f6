"""Training expressed as a HyPar job graph — the paper's technique applied
to the LM workload.

Per optimisation step s:

  segment GRAD_s : one job per micro-batch, ``no_send_back=True`` —
                   gradients are retained on the workers (the paper's
                   communication-avoidance) and only fetched by the OPT job;
  segment OPT_s  : mean of the gradients + optimizer update, consuming
                   ``R_grad[*]``, the previous parameters and optimizer
                   state;
  segment SPLIT_s: ``P_{s+1}`` / ``S_{s+1}`` take the parameters and the
                   optimizer state back apart.

Trees travel through the graph as ``ChunkedData`` of their leaves; the
structures are closed over by the registered functions (workers are
"fat": they hold all user functions, paper §3.2).  The jobs are pure: a
grad job reads the parameters through detached aliases and the opt job
returns new tensors, so every retained result keeps its value.  As in the
reference, every job result stays on the cluster's workers and schedulers
for as long as the trainer (its cluster) lives (no ``release_consumed``):
at full width, one copy of the parameters and optimizer state and one of
the gradients per step.

The fused step (:mod:`.step`) is the "tailored" implementation this is
compared against — the shape of the paper's Fig. 3 on the LM workload.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import (ChunkedData, ChunkRef, FunctionRegistry, Job, JobGraph,
                    LocalExecutor, VirtualCluster)
from ..models.config import ModelConfig
from ..models.transformer import check_trainable, clip_groups, init_params
from ..optim import OptimizerSpec, init_opt_state, opt_update
from ..tree import tree_leaves, tree_map, tree_unflatten
from .step import compute_grads

__all__ = ["HyParTrainer"]


class HyParTrainer:
    """Paper-faithful scheduled training on the LocalExecutor."""

    def __init__(self, cfg: ModelConfig, spec: OptimizerSpec, *,
                 n_micro: int = 2, cluster: VirtualCluster | None = None,
                 mode: str = "sync",
                 strategy: str = "greedy",
                 executor_factory: Callable[..., Any] | None = None):
        check_trainable(cfg)
        self.cfg, self.spec, self.n_micro = cfg, spec, n_micro
        self.mode, self.strategy = mode, strategy
        # executor injection: ``factory(cluster, registry) -> BaseExecutor``
        # swaps the thread-worker LocalExecutor for another executor
        # without the trainer special-casing either
        self.executor_factory = executor_factory
        self.cluster = cluster or VirtualCluster(n_schedulers=1)
        self.registry = FunctionRegistry()
        self._params_like = None
        self._opt_like = None
        self._batch_keys: list[str] = []
        self._register()

    # -- registered user functions (paper §3.2) -----------------------------
    def _register(self):
        cfg, spec = self.cfg, self.spec

        def grad_fn(params_cd: ChunkedData,
                    micro_cd: ChunkedData) -> ChunkedData:
            params = tree_unflatten(self._params_like, params_cd.arrays())
            batch = dict(zip(self._batch_keys, micro_cd.arrays()))
            grads, _, _ = compute_grads(cfg, params, batch)
            return ChunkedData.from_arrays(tree_leaves(grads))

        def opt_fn(*cds: ChunkedData) -> ChunkedData:
            params_cd, opt_cd, *grad_cds = cds
            params = tree_unflatten(self._params_like, params_cd.arrays())
            opt_state = tree_unflatten(self._opt_like, opt_cd.arrays())
            grads_sum = None
            for gcd in grad_cds:
                g = gcd.arrays()
                grads_sum = g if grads_sum is None else [
                    a + b for a, b in zip(grads_sum, g)]
            grads = tree_unflatten(self._params_like,
                                   [g / len(grad_cds) for g in grads_sum])
            new_p, new_o, _ = opt_update(
                spec, grads, opt_state, params,
                clip_groups=clip_groups(cfg, params))
            return ChunkedData.from_arrays(tree_leaves(new_p)
                                           + tree_leaves(new_o))

        def split_state(cd: ChunkedData, which: str) -> ChunkedData:
            n_p = len(tree_leaves(self._params_like))
            return ChunkedData(list(cd)[:n_p] if which == "p"
                               else list(cd)[n_p:])

        self.registry.register("grad", grad_fn, kind="whole")
        self.registry.register("opt", opt_fn, kind="whole")
        self.registry.register("take_params",
                               lambda cd: split_state(cd, "p"), kind="whole")
        self.registry.register("take_opt",
                               lambda cd: split_state(cd, "o"), kind="whole")
        # data jobs: identity over the micro-batch's bound leaves
        self.registry.register("data", lambda *xs: xs[0] if len(xs) == 1
                               else xs, kind="whole")

    # -- graph construction ----------------------------------------------------
    def _one_step_segments(self, graph: JobGraph, s: int, *,
                           params_ref: str, opt_ref: str) -> tuple[str, str]:
        grad_jobs = []
        for m in range(self.n_micro):
            job = Job(f"G{s}_{m}", "grad", 0,
                      (ChunkRef(params_ref), ChunkRef(f"D{s}_{m}")),
                      no_send_back=True)   # paper: grads stay on workers
            grad_jobs.append(job)
        graph.add_segment(grad_jobs)
        opt_name = f"O{s}"
        graph.add_segment([Job(opt_name, "opt", 0,
                               (ChunkRef(params_ref), ChunkRef(opt_ref)) +
                               tuple(ChunkRef(j.name) for j in grad_jobs))])
        p_name, o_name = f"P{s + 1}", f"S{s + 1}"
        graph.add_segment([
            Job(p_name, "take_params", 1, (ChunkRef(opt_name),)),
            Job(o_name, "take_opt", 1, (ChunkRef(opt_name),)),
        ])
        return p_name, o_name

    def run(self, batches: list[list[dict]], *, params=None,
            generator: torch.Generator | None = None
            ) -> tuple[Any, Any, Any]:
        """``batches[s][m]``: the micro-batch dict (tensors) of step s.
        Starts from ``params`` (left untouched), else from
        ``init_params`` drawn from ``generator`` (default: seeded 0 on the
        cluster's first device), with a fresh optimizer state.  Returns
        ``(params, opt_state, report)``."""
        if params is None:
            device = self.cluster.devices[0]
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_params(self.cfg, generator, device)
        opt_state = init_opt_state(self.spec, params)
        p_leaves, o_leaves = tree_leaves(params), tree_leaves(opt_state)
        self._params_like = tree_map(lambda _: None, params)
        self._opt_like = tree_map(lambda _: None, opt_state)
        self._batch_keys = sorted(batches[0][0])

        graph = JobGraph()
        graph.add_segment([Job("P0", "take_params", 1, ()),
                           Job("S0", "take_opt", 1, ())])
        full0 = ChunkedData.from_arrays(p_leaves + o_leaves)
        graph.bind_input("P0", full0)
        graph.bind_input("S0", full0)

        p_ref, o_ref = "P0", "S0"
        for s, step_batches in enumerate(batches):
            for m, mb in enumerate(step_batches):
                name = f"D{s}_{m}"
                graph.add_segment([Job(name, "data", 1, ())])
                graph.bind_input(name, ChunkedData.from_arrays(
                    [mb[k] for k in self._batch_keys]))
            p_ref, o_ref = self._one_step_segments(graph, s, params_ref=p_ref,
                                                   opt_ref=o_ref)

        if self.executor_factory is not None:
            executor = self.executor_factory(self.cluster, self.registry)
        else:
            executor = LocalExecutor(self.cluster, self.registry,
                                     mode=self.mode, strategy=self.strategy)
        try:
            results, report = executor.run(graph)
        finally:
            close = getattr(executor, "close", None)
            if close is not None:
                close()
        final_p = tree_unflatten(self._params_like, results[p_ref].arrays())
        final_o = tree_unflatten(self._opt_like, results[o_ref].arrays())
        return final_p, final_o, report
