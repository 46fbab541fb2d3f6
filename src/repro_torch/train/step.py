"""Train-step construction: grad accumulation, remat, optimizer, schedule.

``make_train_step`` builds the fused step — the "tailored" implementation
that the paper's framework would assemble from the job graph (DATA →
GRAD × micro-batches (no_send_back) → OPT); the HyPar-scheduled variant
that goes through the ``JobGraph`` and ``LocalExecutor`` lives in
:mod:`.hypar_loop`.

The step runs eagerly and UPDATES THE STATE IN PLACE under
``torch.no_grad()``: gradients accumulate in one fp32 buffer per parameter
over the micro-batches, and the optimizer writes the new parameters and
moments into the tensors it was given, so the model's state is held once.  (The reference's step is pure and returns a new state.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.config import ModelConfig
from ..models.transformer import check_trainable, init_params, loss_fn
from ..optim import OptimizerSpec, init_opt_state, opt_update
from ..tree import tree_leaves, tree_unflatten

__all__ = ["TrainState", "make_init_fn", "make_train_step", "compute_grads"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0

    @staticmethod
    def create(cfg: ModelConfig, spec: OptimizerSpec,
               generator: torch.Generator, device) -> "TrainState":
        params = init_params(cfg, generator, device)
        return TrainState(params=params,
                          opt_state=init_opt_state(spec, params), step=0)

    def tree(self) -> dict:
        """The state as one tree of tensors (what a checkpoint holds)."""
        dev = tree_leaves(self.params)[0].device
        return {"params": self.params, "opt_state": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int32,
                                     device=dev)}

    @staticmethod
    def from_tree(tree: dict) -> "TrainState":
        return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                          step=int(tree["step"]))


def make_init_fn(cfg: ModelConfig, spec: OptimizerSpec, device):
    def init_fn(generator: torch.Generator) -> TrainState:
        return TrainState.create(cfg, spec, generator, device)
    return init_fn


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} microbatches")
    mb = B // n
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(n)]


def compute_grads(cfg: ModelConfig, params, batch: dict, *, accum: int = 1,
                  impl: str = "auto"):
    """Mean gradients over ``accum`` micro-batches of ``batch``, accumulated
    in fp32.  Returns ``(grads, mean total loss, the last micro-batch's
    metrics)``; ``grads`` has the structure of ``params``.  The parameters
    are read through detached aliases, so the caller's tensors are not
    touched (their ``requires_grad`` and ``.grad`` included)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    for p in leaves:
        if p.dtype != torch.float32:
            raise TypeError(f"parameters must be fp32 (their gradients "
                            f"accumulate the micro-batches), got {p.dtype}")
    alias = tree_unflatten(params, leaves)
    lsum = 0.0
    metrics = {}
    for mb in _split_microbatches(batch, accum):
        total, metrics = loss_fn(cfg, alias, mb, impl=impl)
        total.backward()
        lsum = lsum + total.detach()
    grads = [p.grad.div_(accum) if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return tree_unflatten(params, grads), lsum / accum, metrics


def make_train_step(cfg: ModelConfig, spec: OptimizerSpec, *,
                    grad_accum: int | None = None,
                    schedule: Callable | None = None, impl: str = "auto"):
    """Returns ``step(state, batch) -> (state, metrics)``, which updates
    ``state`` in place and returns it.

    ``grad_accum`` > 1 splits the batch into micro-batches whose gradients
    accumulate in fp32 and are divided by the count; ``schedule(step)``
    gives the learning rate (else ``spec.lr``); ``impl`` picks the
    attention core of every layer (``auto``: the flash kernel on CUDA).
    Metrics: the last micro-batch's ``loss``, ``aux``, ``tokens``; the
    pre-clip ``grad_norm``, ``lr``, and ``loss_total`` (the mean total
    loss over the micro-batches)."""
    check_trainable(cfg)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    accum = max(1, accum)

    def step_fn(state: TrainState, batch: dict):
        grads, loss, metrics = compute_grads(cfg, state.params, batch,
                                             accum=accum, impl=impl)
        lr = schedule(state.step) if schedule is not None else spec.lr
        _, _, om = opt_update(spec, grads, state.opt_state, state.params, lr,
                              inplace=True)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss_total"] = loss
        state.step += 1
        return state, metrics

    return step_fn
