"""The training mesh's per-block gathers (``parallel.partition``'s
``Placed.gather_region``/``take`` and ``RegionSums``, ``models.transformer``
``_block_parts``, ``train.step.compute_grads_mesh``, the dry-run's train
and prefill cells) on the CPU and on meta grids.

* ``gather_region`` against slicing the whole gathered leaf, for every
  parameter leaf of every family's smoke config on 2 x 2, 1 x 4 and 4 x 2
  grids: each position's own region, the whole leaf, and regions drawn by
  hypothesis (a dim's spans joined, as a Mamba-2 head shard's columns).
* The differentiable gather's gradient against autograd of a slice of the
  whole leaf: regions gathered on several positions, overlapping, added
  into fp32 sums at the blocks and cast back for a bf16 leaf; what the
  counter records of it.
* A meta trace of the fused step for every family (the dry-run's train
  cell at a few tokens on a 2 x 2 grid, its 1 x 2 row traced) under remat
  ``full`` and ``save_dots``: every position's gathered high-water mark is
  at most two of its gather scopes (a block, the embedding, the logits),
  and ``temp_bytes`` at 6 layers exceeds 2 layers' by no more than the 4
  layers' saved activations, the position's share of their gradient sums
  and one scope's gathered bytes (the whole-model gather a row made
  before grew by about two fp32 copies of each layer).
* Neither the fused step nor the prefill cell calls ``Placed.gather`` or
  ``gather_tree``, and the prefill cell's forward over the placed tree is
  the whole-gather forward's to the bit in fp32 on a 1 x 2 grid.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.analysis import opcount
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from repro_torch.models import transformer
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.models.transformer import forward, init_params
from repro_torch.parallel import DEFAULT_RULES, ShardingRules
from repro_torch.parallel import partition
from repro_torch.parallel.partition import (Placed, RegionSums, gather_tree,
                                            place_state, place_tree,
                                            view_region)
from repro_torch.train import compute_grads_mesh
from repro_torch.tree import tree_leaves, tree_paths

CPU = torch.device("cpu")
GRIDS = [(2, 2), (1, 4), (4, 2)]
FAMILIES = ["qwen2-1.5b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-1.2b",
            "whisper-base", "gemma3-4b"]


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


_PLACED: dict = {}


def _placed_params(arch, grid):
    """Every parameter leaf of ``arch``'s smoke config placed on ``grid``
    by the state specs: ``[(path, Placed, whole tensor)]``."""
    if (arch, grid) not in _PLACED:
        cfg = get_smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
        placed = place_state({"params": params}, make_test_mesh(*grid))
        _PLACED[arch, grid] = [
            (path, leaf, whole) for (path, leaf), whole in zip(
                tree_paths(placed["params"]), tree_leaves(params))]
    return _PLACED[arch, grid]


# ---------------------------------------------------------------------------
# gather_region against slicing the whole leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gather_region_of_every_leaf_is_the_slice(arch, grid):
    """Each position's own region is its block, and the whole leaf is
    ``gather()``, gathered on the last position."""
    for path, leaf, whole in _placed_params(arch, grid):
        assert isinstance(leaf, Placed), path
        assert torch.equal(leaf.gather(), whole), path
        for k, reg in enumerate(leaf.regions()):
            assert torch.equal(leaf.gather_region(reg, position=k),
                               leaf.blocks[k]), (path, k)
        assert torch.equal(leaf.gather_region(
            (), position=len(leaf.blocks) - 1), whole), path


def _regions(shape):
    """A region of a tensor of ``shape``: a slice a dim, one dim's spans
    joined where the dim allows two."""
    def dim(n):
        return st.tuples(st.integers(0, n - 1), st.integers(1, n)).map(
            lambda t: slice(min(t[0], t[1] - 1), max(t[0] + 1, t[1])))

    def spans(n):
        return st.lists(dim(n), min_size=2, max_size=3)
    if not shape:
        return st.just(())
    dims = [dim(n) for n in shape]
    joined = st.integers(0, len(shape) - 1).flatmap(
        lambda d: st.tuples(*(spans(n) if i == d else dims[i]
                              for i, n in enumerate(shape))))
    return st.one_of(st.tuples(*dims), joined)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "whisper-base", "llama3-405b"])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_gather_region_matches_slicing_the_gathered_leaf(arch, grid, data):
    leaves = _placed_params(arch, grid)
    path, leaf, whole = leaves[data.draw(st.integers(0, len(leaves) - 1))]
    region = data.draw(_regions(tuple(leaf.shape)))
    k = data.draw(st.integers(0, len(leaf.blocks) - 1))
    got = leaf.gather_region(region, position=k)
    assert torch.equal(got, view_region(whole, region)), (path, region, k)
    assert got.is_contiguous()


# ---------------------------------------------------------------------------
# the differentiable gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", [("data", "model"), (None, "model"),
                                  ("data",), ()], ids=str)
def test_gather_gradient_is_autograd_of_slices_of_the_whole(spec, dtype):
    """Three regions (overlapping, one with joined spans) gathered on
    three positions of a 2 x 2 grid: the fp32 sums at the blocks are the
    gradient of the same slices of one whole leaf (each use's gradient in
    the leaf's dtype, as autograd gives it), every position's gradient
    block is its region of it, cast back to a bf16 leaf's dtype; the
    counter records each gradient's reduce-scatter, and each gather's
    all-gather of the bytes it read from other positions."""
    mesh = make_test_mesh(2, 2)
    g = torch.Generator().manual_seed(1)
    whole = torch.randn(8, 12, generator=g).to(dtype)
    leaf = partition.place_leaf(whole, mesh, spec)
    uses = [((slice(1, 7), slice(0, 6)), 0),
            ((slice(None), [slice(4, 6), slice(9, 12)]), 3),
            ((slice(0, 4), slice(2, 10)), 2)]
    weights = [torch.randn(*view_region(whole, r).shape, generator=g)
               for r, _ in uses]

    ref = whole.float().requires_grad_()
    sum((view_region(ref, r) * w.to(dtype).float()).sum()
        for (r, _), w in zip(uses, weights)).backward()

    sums = RegionSums(leaf, torch.zeros((), requires_grad=True))
    read = leaf.for_row((0, 1, 2, 3), sums)
    with OpCounter(2) as c:
        outs = [read.take(r, i) for r, i in uses]
        for out, (r, _) in zip(outs, uses):
            assert out.dtype == dtype and out.requires_grad
            assert torch.equal(out.detach(), view_region(whole, r))
        sum((out.float() * w).sum()
            for out, w in zip(outs, weights)).backward()
    assert set(sums.acc) == set(leaf.distinct())
    assert {t.dtype for t in sums.acc.values()} == {torch.float32}
    torch.testing.assert_close(
        torch.cat([t.flatten() for t in sums.acc.values()]),
        torch.cat([ref.grad[leaf.regions()[k]].flatten()
                   for k in sums.acc]), rtol=1e-6, atol=0)
    grads = sums.placed(1, cast=True)
    for k, reg in enumerate(leaf.regions()):
        assert grads.blocks[k].dtype == dtype
        torch.testing.assert_close(grads.blocks[k].float(),
                                   ref.grad[reg].to(dtype).float(),
                                   rtol=1e-6, atol=0)
    sites = c.analysis().by_site
    scatter = sites[("reduce-scatter", "grad_scatter")]
    assert scatter["calls"] == 3
    assert scatter["bytes"] == sum(w.numel() for w in weights) \
        * whole.element_size()
    own = 0
    for (r, k), w in zip(uses, weights):
        spans = partition.region_spans(r, whole.shape)
        own += sum(
            dst_numel for dst_numel in (
                np.prod([s.stop - s.start for s in dst])
                for dst, _ in partition._overlap(spans, leaf.regions()[k])))
    fetched = sum(w.numel() for w in weights) - own
    got = sites.get(("all-gather", "param_gather"), {"bytes": 0})["bytes"]
    assert got == fetched * whole.element_size()


# ---------------------------------------------------------------------------
# the fused step's trace: what a position holds
# ---------------------------------------------------------------------------

#: a train cell of a few tokens: the smoke configs' parameters, and not
#: their activations, make the difference between the designs
TINY = ShapeCell("train_tiny", 16, 8, "train")


def _trace(arch, remat, layers):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat,
                              n_layers=layers)
    mesh = compat_make_mesh((2, 2), ("data", "model"), device="meta")
    spec, counter, _ = dryrun.trace_cell(arch, TINY.name, cfg=cfg,
                                         mesh=mesh)
    return cfg, spec, counter.analysis()


def _saved_bytes(cfg, spec) -> int:
    """What the meshless forward of one of the row's micro-batches keeps
    for its backward (its live bytes once the loss is made): every
    layer's whole saved activations, more than any position of a row
    saves of them."""
    params = init_params(cfg, None, "meta")
    for t in tree_leaves(params):
        t.requires_grad_()
    batch = make_batch_specs(cfg, spec.row_batch // spec.row_accum,
                             TINY.seq_len, kind="train")
    with OpCounter() as c:
        total, _ = transformer.loss_fn(cfg, params, batch)
        live = c.analysis().positions[0].live_bytes
    del total
    return live


def _sum_bytes(spec, lo: int, hi: int) -> list[int]:
    """Each row position's fp32 gradient sums of layers ``lo``..``hi``
    at a production position's share."""
    out = [0] * spec.row.size
    for leaf in tree_leaves(spec.args[0].params["layers"][lo:hi]):
        share = partition.production_share(leaf, spec.mesh)
        for k, blk in enumerate(leaf.blocks):
            out[k] += int(blk.numel() * 4 * share)
    return out


@pytest.mark.parametrize("remat", ["full", "save_dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_a_position_holds_one_block_of_gathered_shards(arch, remat,
                                                       monkeypatch):
    """The train cell's row (1 x 2 of a 2 x 2 grid) at 2 and 6 layers:
    each position's gathered high-water mark is at most two of its gather
    scopes, and its ``temp_bytes`` grows with the 4 layers by no more than
    their saved activations, its share of their gradient sums and one
    scope's gathered bytes."""
    monkeypatch.setitem(SHAPE_CELLS, TINY.name, TINY)
    runs = {n: _trace(arch, remat, n) for n in (2, 6)}
    for _, spec, an in runs.values():
        assert spec.row.size == 2 and len(an.gathered) == 2
        for k in range(2):
            assert 0 < an.gathered[k] <= 2 * an.gathered_scope[k], k
    (cfg2, spec2, an2), (cfg6, spec6, an6) = runs[2], runs[6]
    saved = _saved_bytes(cfg6, spec6) - _saved_bytes(cfg2, spec2)
    sums = _sum_bytes(spec6, 2, 6)
    for k in range(2):
        grew = an6.positions[k].peak_bytes - an2.positions[k].peak_bytes
        assert grew <= saved + sums[k] + an6.gathered_scope[k], (
            k, grew, saved, sums[k], an6.gathered_scope[k])


# ---------------------------------------------------------------------------
# no whole gather; the prefill cell
# ---------------------------------------------------------------------------


def _no_whole_gather(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a whole leaf was gathered")
    monkeypatch.setattr(Placed, "gather", refuse)
    monkeypatch.setattr(partition, "gather_tree", refuse)
    monkeypatch.setattr(specs_mod, "place_tree", place_tree)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-base"])
def test_step_and_prefill_cell_gather_no_whole_leaf(arch, monkeypatch):
    cfg = _fp32(get_smoke_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    mesh = make_test_mesh(2, 2)
    placed = place_state({"params": params}, mesh)["params"]
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    monkeypatch.setitem(SHAPE_CELLS, "prefill_tiny",
                        ShapeCell("prefill_tiny", 16, 4, "prefill"))
    meta = compat_make_mesh((2, 2), ("data", "model"), device="meta")
    cell = specs_mod.build_cell(arch, cfg, "prefill_tiny", ShardingRules(
        mesh=meta, rules=dict(DEFAULT_RULES)))
    _no_whole_gather(monkeypatch)
    compute_grads_mesh(cfg, placed, batch, mesh)
    with OpCounter(2):
        out = cell.fn(*cell.args)
    assert out.shape == (2, cfg.padded_vocab)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_over_the_placed_tree_is_the_whole_gather_forward(arch):
    """The prefill cell's forward (the serving parameters placed on a
    1 x 2 row by their specs, each block gathered where it runs) is the
    forward over the whole gathered tree to the bit, in fp32."""
    cfg = _fp32(get_smoke_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU,
                         cast=True)
    mesh = make_test_mesh(1, 2)
    placed = place_tree(params, mesh, ShardingRules(
        mesh=mesh, rules=dict(DEFAULT_RULES)), kind="params")
    rng = np.random.default_rng(1)
    kw = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (2, 24)))}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad(), opcount.gather_marks() as marks:
        got, aux = forward(cfg, placed, tp_devices=[CPU, CPU], **kw)
    with torch.no_grad():
        want, want_aux = forward(cfg, gather_tree(placed),
                                 tp_devices=[CPU, CPU], **kw)
    assert torch.equal(got, want)
    assert torch.equal(torch.as_tensor(aux), torch.as_tensor(want_aux))
    assert marks.peak[0] > 0 and marks.peak[1] > 0
