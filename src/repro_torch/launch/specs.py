"""Meta-tensor stand-ins and step functions for every (arch × cell), the
JAX package's ``launch/specs.py`` for the eager dry-run.

The reference hands XLA ``ShapeDtypeStruct`` trees with their shardings
over the whole production mesh and compiles one partitioned program a
device.  The port traces the step it really runs, eagerly, on meta tensors
(``launch/dryrun.py``).  One process drives a grid row by row, so the
traced program is ONE data row of the production grid: its tensor-parallel
positions (16 on ``"model"``), with the row's share of the batch — the
counterpart of the reference's per-device program.  A :class:`CellSpec`
holds that row's step, its meta arguments and the bytes each production
position holds before the step:

* **train** — the fused step (``make_train_step(mesh=)``) on a state drawn
  on meta and placed on the row; the row's micro-batches are the
  reference's ``choose_grad_accum`` where they divide the row's batch.
  Each position gathers a block's shard when the block runs (and again in
  its recompute) and adds the shard's gradient into fp32 sums at its own
  blocks.  The traced row holds the row's model shards, 16 times a
  production position's blocks: the trace counts the gradient sums at a
  production position's share of them (``opcount.production``: the
  reference's reduce-scatter over ``data``), and each gather's all-gather
  also the part a production position fetches from the other data rows;
* **prefill** — the row's forward under ``no_grad`` over the parameters
  (bf16) placed on the row, each block's shards gathered where it runs,
  returning the last position's logits;
* **decode** — ``decode_step`` under ``no_grad`` over the reference's
  dense stacked cache (``init_cache``) placed on the row by the cell's
  cache specs (``partition.place_cache``: slots over ``data``, KV heads
  over ``model`` where they divide, else the sequence; the SSM state by
  head and the conv tail by channel) and the parameters (bf16) placed on
  the row by their ``params`` specs, each block's shards gathered where
  it runs: distributed flash-decoding over the KV blocks, attention
  split by head where the row divides the KV heads, else q, k and v on
  the lead.  Where the spec sends the sequence over data rows too
  (``long_500k``: ``("data", "model")``), the traced row is data row 0,
  holding the first of the rows' contiguous ranges, and the merge of
  each position's softmax state across the rows is reckoned as an
  all-reduce (:func:`row_seq_parts`).  An encoder-decoder model's
  encoder output is an input of the cell.

A position's ``temp_bytes`` is then what the reference's device holds
beyond its stored state: the saved activations, one block's gathered
shards (two at a block boundary), its gradient sums, and the transients
(the logits, the update of one block: every block is updated on its
position, counted at a production position's share).  The record's
``gathered_bytes_per_device`` is the most of the gathered bytes a
position held alive at once (``opcount.GatherMarks``).

Deviations, each in ROADMAP queue C: the eager trace replaces the
compile; the work the port does not split (norms, routers, an attention
layer whose KV heads the row does not divide) runs on the row's lead; and
the data axis's share of the gathers and reductions (the parameter
all-gathers, the gradient sums, Adafactor's sums across blocks, the
decode merge across data rows) is reckoned, not traced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..analysis import opcount
from ..data.pipeline import make_batch_specs
from ..models.config import SHAPE_CELLS, ModelConfig, ShapeCell
from ..models.layers import dtype_of
from ..models.transformer import decode_step, forward, init_cache, init_params
from ..optim import OptimizerSpec
from ..parallel.partition import (cache_spec, place_cache, place_tree,
                                  position_bytes, production_share,
                                  spec_bytes)
from ..parallel.sharding import DEFAULT_RULES, ShardingRules
from ..train.step import TrainState, make_train_step
from .mesh import DeviceMesh, compat_make_mesh

__all__ = ["CellSpec", "build_cell", "choose_grad_accum", "model_flops_for",
           "row_mesh", "row_seq_parts", "rules_for_cell"]


@dataclasses.dataclass
class CellSpec:
    """Everything needed to trace one (arch × shape × mesh) cell: ``fn``
    run on ``args`` is one step of one data row (``row``) of the
    production grid ``mesh``.  ``static_bytes[k]``: what the row's
    position k holds before the step (parameters, optimizer state, cache),
    by the production placement."""

    arch: str
    cell: ShapeCell
    fn: Callable
    args: tuple
    mesh: DeviceMesh
    row: DeviceMesh
    static_bytes: list[int]
    model_flops: float
    grad_accum: int = 1
    row_batch: int = 1
    row_accum: int = 1
    notes: tuple[str, ...] = ()


def rules_for_cell(mesh, cell: ShapeCell,
                   cfg: ModelConfig | None = None) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if cell.kind == "decode" and cell.global_batch == 1:
        # long-context decode, batch 1: shard the KV sequence over everything
        rules["kv_seq"] = ("data", "model")
    if cfg is not None and not cfg.activation_seq_shard:
        rules["seq"] = None          # Megatron-style replicated residual
    return ShardingRules(mesh=mesh, rules=rules)


def choose_grad_accum(cfg: ModelConfig, cell: ShapeCell, n_data_shards: int,
                      *, tokens_per_device_micro: int = 8_192) -> int:
    """Pick microbatching so live activations fit: target <= ~8k tokens per
    device per microbatch, scaled down for very wide models (fp32 logits
    and saved layer boundaries are the live-set drivers)."""
    per_dev = cell.tokens // max(n_data_shards, 1)
    target = tokens_per_device_micro
    if cfg.d_model >= 8192:
        target //= 8
    elif cfg.d_model >= 4096:
        target //= 2
    if cfg.padded_vocab >= 150_000:
        target = min(target, 4_096)      # fp32 logits dominate
    accum = max(1, per_dev // target)
    # accum must divide the per-shard batch
    b = cell.global_batch
    while b % accum and accum > 1:
        accum -= 1
    return accum


def model_flops_for(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.active_params()
    if cell.kind == "train":
        return 6.0 * n * cell.tokens
    if cell.kind == "prefill":
        return 2.0 * n * cell.tokens
    return 2.0 * n * cell.global_batch          # decode: one token per slot


def _data_shards(rules: ShardingRules) -> int:
    return rules.axis_size(rules.rules.get("batch"))


def row_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """One data row of ``mesh``: its axes with every extent but
    ``"model"``'s cut to 1, on meta devices."""
    shape = [n if a == "model" else 1
             for a, n in zip(mesh.axis_names, mesh.dims)]
    return compat_make_mesh(shape, mesh.axis_names, device="meta")


def _row_accum(accum: int, row_batch: int) -> int:
    """The reference's micro-batch count where it divides the row's batch,
    else the largest count below it that does."""
    n = min(accum, row_batch)
    while row_batch % n:
        n -= 1
    return n


def _tensor_bytes(tree, seen: set | None = None) -> int:
    """The bytes of the tensors of ``tree``, each storage once (also
    across calls that share ``seen``)."""
    seen = set() if seen is None else seen
    if isinstance(tree, torch.Tensor):
        key = tree.untyped_storage()._cdata
        if key in seen:
            return 0
        seen.add(key)
        return opcount.tensor_bytes(tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in tree)
    return 0


def _shares(rules: ShardingRules):
    """``opcount.production``'s share of a leaf placed on the traced row
    (``partition.production_share`` at ``rules``' production grid)."""
    return lambda leaf: production_share(leaf, rules.mesh)


def _train_cell(arch, cfg, cell, rules, row) -> CellSpec:
    spec = OptimizerSpec(kind=cfg.optimizer)
    shards = _data_shards(rules)
    accum = choose_grad_accum(cfg, cell, shards)
    row_batch = max(1, cell.global_batch // shards)
    row_accum = _row_accum(accum, row_batch)
    state = TrainState.create(cfg, spec, None, "meta", mesh=row)
    tree = {"params": state.params, "opt_state": state.opt_state}
    static = spec_bytes(tree, rules, kind="state")
    step = make_train_step(cfg, spec, grad_accum=row_accum, mesh=row)

    def train_fn(state, batch):
        with opcount.production(_shares(rules)):
            return step(state, batch)

    return CellSpec(
        arch=arch, cell=cell, fn=train_fn,
        args=(state, make_batch_specs(cfg, row_batch, cell.seq_len,
                                      kind="train")),
        mesh=rules.mesh, row=row, static_bytes=[static] * row.size,
        model_flops=model_flops_for(cfg, cell), grad_accum=accum,
        row_batch=row_batch, row_accum=row_accum)


def _serving_params(cfg: ModelConfig) -> dict:
    """Inference serves in the compute dtype, as the engines cast it."""
    return init_params(cfg, None, "meta", cast=True)


def _prefill_cell(arch, cfg, cell, rules, row) -> CellSpec:
    row_batch = max(1, cell.global_batch // _data_shards(rules))
    params = _serving_params(cfg)
    static = spec_bytes(params, rules, kind="params")
    row_rules = ShardingRules(mesh=row, rules=dict(rules.rules))
    placed = place_tree(params, row, row_rules, kind="params")
    devices = list(row.flat)

    @torch.no_grad()
    def prefill_fn(placed, batch):
        with opcount.production(_shares(rules)):
            logits, _ = forward(cfg, placed, tokens=batch.get("tokens"),
                                enc_embeds=batch.get("enc_embeds"),
                                tp_devices=devices if row.size > 1 else None)
        # serving returns only the last position (next-token)
        return logits[:, -1, :]

    return CellSpec(
        arch=arch, cell=cell, fn=prefill_fn,
        args=(placed, make_batch_specs(cfg, row_batch, cell.seq_len,
                                       kind="prefill")),
        mesh=rules.mesh, row=row, static_bytes=[static] * row.size,
        model_flops=model_flops_for(cfg, cell), row_batch=row_batch)


def row_seq_parts(cfg: ModelConfig, cell: ShapeCell,
                  rules: ShardingRules) -> int:
    """Into how many data rows the cell's cache spec splits the KV
    sequence: the extent of its ``kv_seq`` axes other than ``"model"``
    (16 for ``long_500k``'s ``("data", "model")``, else 1)."""
    spec = cache_spec("k", (1, cell.global_batch, cfg.n_kv_heads,
                            cell.seq_len, cfg.hd), rules)
    axes = spec[3] if len(spec) > 3 else None
    axes = () if axes is None else axes if isinstance(axes, tuple) \
        else (axes,)
    return math.prod(rules.mesh.shape[a] for a in axes if a != "model")


def _decode_cell(arch, cfg, cell, rules, row) -> CellSpec:
    S = cell.seq_len
    row_batch = max(1, cell.global_batch // _data_shards(rules))
    params = _serving_params(cfg)
    row_rules = ShardingRules(mesh=row, rules=dict(rules.rules))
    placed = place_tree(params, row, row_rules, kind="params")
    tokens = torch.empty((row_batch, 1), dtype=torch.int32, device="meta")
    # the reference's dense stacked cache, the row's share of it: the
    # data rows that split the sequence hold contiguous ranges of it, and
    # the traced row (row 0) the first; its positions split it again
    parts = row_seq_parts(cfg, cell, rules)
    cache = init_cache(cfg, row_batch, S // parts, device="meta")
    # the dense engine decodes with one length a slot
    cache["len"] = torch.zeros((row_batch,), dtype=torch.int32,
                               device="meta")
    cache = place_cache(cache, row, row_rules)
    # a position's parameters by the production specs (the traced row
    # holds the row's model shards, as the prefill cell's does), its cache
    # blocks, and the whole batch's ``len``, which every position holds
    held = position_bytes(cache) or [_tensor_bytes(
        [v for k, v in cache.items() if k != "len"])]
    lens = torch.empty((cell.global_batch,), dtype=torch.int32,
                       device="meta")
    static = [spec_bytes(params, rules, kind="params") + b
              + spec_bytes({"len": lens}, rules, kind="cache") for b in held]
    # each position's softmax state a layer, fp32 (m, l, acc)
    n_attn = cache["k"].shape[0] if "k" in cache else 0
    merge_bytes = n_attn * row_batch * cfg.n_heads * (cfg.hd + 2) * 4
    notes = []
    if parts > 1:
        notes.append(f"KV sequence over {parts} data rows: the traced row "
                     f"holds the first {S // parts} positions; the merge "
                     f"across the rows is reckoned")
    extra = ()
    if cfg.family == "encdec":
        # the encoder's output is an input of the cell, as in the
        # reference's
        extra = (torch.empty((row_batch, 1500, cfg.d_model),
                             dtype=dtype_of(cfg.compute_dtype),
                             device="meta"),)

    @torch.no_grad()
    def decode_fn(params, cache, tokens, enc_out=None):
        with opcount.production(_shares(rules)):
            out = decode_step(cfg, params, cache, tokens, enc_out=enc_out)
        if parts > 1 and n_attn:
            # the rows not traced: the all-reduce of each position's
            # softmax state across the data rows that split the sequence
            for k in range(row.size):
                opcount.collective("all-reduce", nbytes=merge_bytes,
                                   site="seq_split_data_axis", position=k)
        return out

    return CellSpec(arch=arch, cell=cell, fn=decode_fn,
                    args=(placed, cache, tokens, *extra), mesh=rules.mesh,
                    row=row, static_bytes=static, notes=tuple(notes),
                    model_flops=model_flops_for(cfg, cell),
                    row_batch=row_batch)


def build_cell(arch: str, cfg: ModelConfig, cell_name: str,
               rules: ShardingRules) -> CellSpec:
    """The traced row's step of one cell on ``rules.mesh`` (the production
    grid)."""
    cell = SHAPE_CELLS[cell_name]
    row = row_mesh(rules.mesh)
    build = {"train": _train_cell, "prefill": _prefill_cell,
             "decode": _decode_cell}[cell.kind]
    return build(arch, cfg, cell, rules, row)

