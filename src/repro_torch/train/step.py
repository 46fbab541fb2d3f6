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

On a training mesh (``mesh=``, a ``("data", "model")``
:class:`~repro_torch.launch.mesh.DeviceMesh`, one process driving every
position) the state is placed by the reference's specs
(``parallel.partition.place_state``: parameters and optimizer moments
FSDP over ``data``, TP over ``model``), each leaf a
:class:`~repro_torch.parallel.partition.Placed` of one block a position.
A step (:func:`compute_grads_mesh`) gathers the whole parameters on each
data row's lead, runs the row's slice of every micro-batch there, its
blocks' self-attention split by head and MLPs by ``d_ff`` over the row's
positions (and, where their specs put ``model`` on them, the experts,
SSM heads, cross-attention heads and the vocabulary: the embedding, the
logits and the cross-entropy), makes the loss of the whole micro-batch from every row's sums
and runs one backward over all rows; the rows' gradients are summed in
row order on the mesh's lead, divided, and placed by the parameters'
specs, and each block is updated on its position
(``optim.opt_update_placed``).  A 1 x 1 grid is no mesh: its state holds
the tensors themselves and its step is the meshless one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.config import ModelConfig
from ..models.transformer import (check_trainable, init_params, loss_fn,
                                  loss_from_sums, loss_sums)
from ..optim import OptimizerSpec, init_opt_state, opt_update, opt_update_placed
from ..parallel import DEFAULT_RULES, ShardingRules
from ..parallel.partition import Placed, gather_tree, place_leaf, place_state
from ..tree import tree_leaves, tree_unflatten

__all__ = ["TrainState", "make_init_fn", "make_train_step", "compute_grads",
           "compute_grads_mesh", "shard_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0

    @staticmethod
    def create(cfg: ModelConfig, spec: OptimizerSpec,
               generator: torch.Generator, device, *,
               mesh=None) -> "TrainState":
        """A fresh state drawn on ``device``; placed on ``mesh``
        (:func:`shard_state`) when one is given."""
        params = init_params(cfg, generator, device)
        state = TrainState(params=params,
                           opt_state=init_opt_state(spec, params), step=0)
        return state if mesh is None else shard_state(state, mesh)

    def tree(self) -> dict:
        """The state as one tree of whole tensors (what a checkpoint
        holds): a placed state's leaves gathered on its mesh's lead."""
        params = gather_tree(self.params)
        dev = tree_leaves(params)[0].device
        return {"params": params, "opt_state": gather_tree(self.opt_state),
                "step": torch.tensor(self.step, dtype=torch.int32,
                                     device=dev)}

    @staticmethod
    def from_tree(tree: dict) -> "TrainState":
        step = tree["step"]
        return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                          step=int(step.blocks[0] if isinstance(step, Placed)
                                   else step))


def shard_state(state: TrainState, mesh) -> TrainState:
    """``state`` placed on ``mesh`` by the reference's specs
    (``place_state``); on a 1 x 1 grid the same tensors."""
    tree = place_state({"params": state.params,
                        "opt_state": state.opt_state}, mesh)
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=state.step)


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


def _row_batches(batch: dict, rules: ShardingRules, rows: list) -> list:
    """A micro-batch's slice for each data row that runs: an equal slice a
    row where the ``batch`` rule keeps every data axis (the rows divide
    the batch), else the whole micro-batch on row 0 (the rule is dropped,
    as the reference replicates the batch; the values are the same)."""
    B = next(iter(batch.values())).shape[0]
    spec = rules.spec_for(("batch",), dims=(B,))
    n = rules.axis_size(spec[0]) if spec else 1
    if n != len(rows):
        return [batch]
    m = B // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def compute_grads_mesh(cfg: ModelConfig, params, batch: dict, mesh, *,
                       accum: int = 1, impl: str = "auto"):
    """:func:`compute_grads` over a training mesh: ``params`` holds
    :class:`Placed` leaves, and so do the gradients it returns (placed by
    the parameters' specs), beside the mean total loss over the
    micro-batches and the last one's metrics.

    Each data row that runs (:func:`_row_batches`) gathers the whole
    parameters on its lead as fresh fp32 leaves; every micro-batch's row
    slices run on their rows (``loss_sums``, the row's positions as its
    tensor-parallel devices), one scalar, the whole micro-batch's loss, is
    made of them on the mesh's lead (``loss_from_sums``), and one backward
    runs over every row's graph.  Each leaf's gradient is then the rows'
    sum, added in row order on the lead, divided by ``accum``."""
    for p in tree_leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"parameters must be fp32 (their gradients "
                            f"accumulate the micro-batches), got {p.dtype}")
    rules = ShardingRules(mesh=mesh, rules=dict(DEFAULT_RULES))
    leaves = tree_leaves(params)
    rows = [[mesh.flat[k] for k in row] for row in mesh.rows()]
    micro = [_row_batches(mb, rules, rows)
             for mb in _split_microbatches(batch, accum)]
    rows = rows[:len(micro[0])]
    row_leaves = [[leaf.gather(devs[0]).requires_grad_() for leaf in leaves]
                  for devs in rows]
    lsum = 0.0
    metrics = {}
    for parts in micro:
        sums = [loss_sums(cfg, tree_unflatten(params, w),
                          {k: v.to(devs[0]) for k, v in part.items()},
                          impl=impl, tp_devices=devs)
                for w, devs, part in zip(row_leaves, rows, parts)]
        total, metrics = loss_from_sums(cfg, sums, mesh.lead)
        total.backward()
        lsum = lsum + total.detach()
        del sums, total
    grads = []
    for j, leaf in enumerate(leaves):
        g = None
        for w in row_leaves:
            part = (w[j].grad if w[j].grad is not None
                    else torch.zeros_like(w[j])).to(mesh.lead)
            g = part if g is None else g + part
            w[j] = None
        grads.append(place_leaf(g.div_(accum), mesh, leaf.spec))
        del g, part
    metrics = {k: v.detach() for k, v in metrics.items()}
    return tree_unflatten(params, grads), lsum / accum, metrics


def make_train_step(cfg: ModelConfig, spec: OptimizerSpec, *,
                    grad_accum: int | None = None,
                    schedule: Callable | None = None, impl: str = "auto",
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``, which updates
    ``state`` in place and returns it.

    ``grad_accum`` > 1 splits the batch into micro-batches whose gradients
    accumulate in fp32 and are divided by the count; ``schedule(step)``
    gives the learning rate (else ``spec.lr``); ``impl`` picks the
    attention core of every layer (``auto``: the flash kernel on CUDA).
    Metrics: the last micro-batch's ``loss``, ``aux``, ``tokens``; the
    pre-clip ``grad_norm``, ``lr``, and ``loss_total`` (the mean total
    loss over the micro-batches).  ``mesh`` (more than one position)
    steps a state placed on it (:func:`shard_state`) through
    :func:`compute_grads_mesh` and ``opt_update_placed``; a 1 x 1 grid
    steps as no mesh."""
    check_trainable(cfg)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    accum = max(1, accum)
    placed = mesh is not None and mesh.size > 1

    def step_fn(state: TrainState, batch: dict):
        lr = schedule(state.step) if schedule is not None else spec.lr
        if placed:
            grads, loss, metrics = compute_grads_mesh(
                cfg, state.params, batch, mesh, accum=accum, impl=impl)
            om = opt_update_placed(spec, grads, state.opt_state,
                                   state.params, lr)
        else:
            grads, loss, metrics = compute_grads(cfg, state.params, batch,
                                                 accum=accum, impl=impl)
            _, _, om = opt_update(spec, grads, state.opt_state, state.params,
                                  lr, inplace=True)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss_total"] = loss
        state.step += 1
        return state, metrics

    return step_fn
