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

Parameters in bf16 (llama3-405b's ``param_dtype``) keep the reference's
dtypes: with one micro-batch the gradients stay in the parameters' dtype;
with more, each micro-batch's bf16 gradient is added into an fp32 buffer
as autograd produces it (a post-accumulate hook, so no whole set of bf16
gradients is held) and the sum is divided by the count.  The update is
computed in fp32 and cast back; the optimizer state stays fp32.

On a training mesh (``mesh=``, a ``("data", "model")``
:class:`~repro_torch.launch.mesh.DeviceMesh`, one process driving every
position) the state is placed by the reference's specs
(``parallel.partition.place_state``: parameters and optimizer moments
FSDP over ``data``, TP over ``model``), each leaf a
:class:`~repro_torch.parallel.partition.Placed` of one block a position.
A step (:func:`compute_grads_mesh`) runs each data row's slice of every
micro-batch on the row, its blocks' self-attention split by head and MLPs
by ``d_ff`` over the row's positions (and, where their specs put
``model`` on them, the experts, SSM heads, cross-attention heads and the
vocabulary: the embedding, the logits and the cross-entropy), makes the
loss of the whole micro-batch from every row's sums and runs one backward
over all rows.  No position gathers the model: each block's parameters
are gathered when the block runs, each position only the shard it
computes with (the blocks of its ``model`` column joined over the data
axis), the parts the row runs whole (norms, routers, shared experts,
attention whose heads the row does not split) on the row's lead, and
they die when the block ends; under ``remat`` the backward gathers them
again.  Each gathered region's gradient is added into fp32 sums at the
position's own blocks (``partition.RegionSums``), so during a step a
position holds its blocks of the state, one fp32 gradient sum of its
blocks, the saved activations, and the shards of the block that runs
(two at a boundary).  The sums are divided, placed as the parameters are,
and each block is updated on its position (``optim.opt_update_placed``;
Adafactor's factored moments and update-RMS clip add partial sums over
the blocks, as the reference's all-reduces do, and no leaf is gathered).
A 1 x 1 grid is no mesh: its state holds the tensors themselves and its
step is the meshless one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..analysis import opcount
from ..models.config import ModelConfig
from ..models.transformer import (check_trainable, clip_groups, init_params,
                                  loss_fn, loss_from_sums, loss_sums)
from ..optim import OptimizerSpec, init_opt_state, opt_update, opt_update_placed
from ..parallel import DEFAULT_RULES, ShardingRules
from ..parallel.partition import (Placed, RegionSums, gather_tree,
                                  place_state)
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


def _fp32_sums(leaves: list, fold: bool) -> list:
    """Where ``fold``, one fp32 sum a leaf that is not fp32: a
    post-accumulate hook adds each gradient autograd gives the leaf into
    it (the first one becomes it: ``0 + g`` in fp32) and frees the leaf's
    ``.grad``.  Returns the list of sums, each None until its leaf's first
    gradient; fp32 leaves (and every leaf without ``fold``) keep
    accumulating in ``.grad``, as they always have."""
    sums = [None] * len(leaves)
    if not fold:
        return sums

    def hook_for(j):
        def hook(p):
            g = p.grad
            sums[j] = g.float() if sums[j] is None else sums[j].add_(g)
            p.grad = None
        return hook

    for j, p in enumerate(leaves):
        if p.dtype != torch.float32:
            p.register_post_accumulate_grad_hook(hook_for(j))
    return sums


def _summed(p, acc, fold: bool):
    """A leaf's gradient sum: its fp32 fold (:func:`_fp32_sums`), else its
    ``.grad``, else zeros (fp32 where the leaves ``fold``)."""
    if acc is not None:
        return acc
    if p.grad is not None:
        return p.grad
    return torch.zeros(p.shape, device=p.device,
                       dtype=torch.float32 if fold else p.dtype)


def compute_grads(cfg: ModelConfig, params, batch: dict, *, accum: int = 1,
                  impl: str = "auto"):
    """Mean gradients over ``accum`` micro-batches of ``batch``.  Returns
    ``(grads, mean total loss, the last micro-batch's metrics)``;
    ``grads`` has the structure of ``params``.  fp32 parameters
    accumulate in their fp32 gradients; others (bf16), as the reference
    does, give gradients in their own dtype for one micro-batch and, for
    more, fp32 sums divided by the count.  The parameters are read through
    detached aliases, so the caller's tensors are not touched (their
    ``requires_grad`` and ``.grad`` included)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    sums = _fp32_sums(leaves, accum > 1)
    alias = tree_unflatten(params, leaves)
    lsum = 0.0
    metrics = {}
    for mb in opcount.micro_batches(_split_microbatches(batch, accum)):
        total, metrics = loss_fn(cfg, alias, mb, impl=impl)
        total.backward()
        lsum = lsum + total.detach()
    grads = [_summed(p, acc, accum > 1).div_(accum)
             for p, acc in zip(leaves, sums)]
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

    Every micro-batch's row slices (:func:`_row_batches`) run on their
    rows (``loss_sums`` over the placed tree, the row's positions as its
    tensor-parallel devices: each block gathered when it runs, each
    position's shard on it), one scalar, the whole micro-batch's loss, is
    made of them on the mesh's lead (``loss_from_sums``), and one backward
    runs over every row's graph.  The backward of each gather adds the
    region's gradient into the leaf's fp32 sums at the blocks it came from
    (:class:`~repro_torch.parallel.partition.RegionSums`): in micro-batch
    order, and within a micro-batch in the order the backward reaches the
    rows' gathers.  Each sum is divided by ``accum`` and, with one
    micro-batch, cast back to the leaf's dtype (bf16 parameters), as the
    meshless gradient is.  Under the operation counter each gather records
    its all-gather (``param_gather``) and each gradient its reduce-scatter
    (``grad_scatter``)."""
    rules = ShardingRules(mesh=mesh, rules=dict(DEFAULT_RULES))
    leaves = tree_leaves(params)
    positions = mesh.rows()
    rows = [[mesh.flat[k] for k in row] for row in positions]
    micro = [_row_batches(mb, rules, rows)
             for mb in _split_microbatches(batch, accum)]
    n_rows = len(micro[0])
    handle = torch.zeros((), device=mesh.lead, requires_grad=True)
    sums = [RegionSums(leaf, handle) for leaf in leaves]
    row_params = [tree_unflatten(params, [leaf.for_row(row, s)
                                          for leaf, s in zip(leaves, sums)])
                  for row in positions[:n_rows]]
    lsum = 0.0
    metrics = {}
    for parts in opcount.micro_batches(micro):
        row_sums = [loss_sums(cfg, w,
                              {k: v.to(devs[0]) for k, v in part.items()},
                              impl=impl, tp_devices=devs)
                    for w, devs, part in zip(row_params, rows, parts)]
        total, metrics = loss_from_sums(cfg, row_sums, mesh.lead)
        total.backward()
        lsum = lsum + total.detach()
        del row_sums, total
    grads = [s.placed(accum, cast=accum == 1) for s in sums]
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
    steps as no mesh.  Adafactor's update-RMS runs over the reference's
    stacked leaves (:func:`~repro_torch.models.transformer.clip_groups`)."""
    check_trainable(cfg)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    accum = max(1, accum)
    placed = mesh is not None and mesh.size > 1

    def step_fn(state: TrainState, batch: dict):
        lr = schedule(state.step) if schedule is not None else spec.lr
        groups = (clip_groups(cfg, state.params)
                  if spec.kind == "adafactor" else None)
        if placed:
            grads, loss, metrics = compute_grads_mesh(
                cfg, state.params, batch, mesh, accum=accum, impl=impl)
            om = opt_update_placed(spec, grads, state.opt_state,
                                   state.params, lr, clip_groups=groups)
        else:
            grads, loss, metrics = compute_grads(cfg, state.params, batch,
                                                 accum=accum, impl=impl)
            _, _, om = opt_update(spec, grads, state.opt_state, state.params,
                                  lr, inplace=True, clip_groups=groups)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss_total"] = loss
        state.step += 1
        return state, metrics

    return step_fn
