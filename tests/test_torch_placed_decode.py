"""``decode_step`` over weights placed by the ``params`` specs and a cache
placed by the ``cache`` specs (``partition.place_tree(..., kind="params")``,
``partition.place_cache``), on CPU grids and meta grids.

* Every configuration's smoke model decodes 3 greedy steps from a partly
  filled cache on 1 x 2 and 2 x 2 grids (and 1 x 4, where llama3's KV
  heads do not divide the row and the lead computes q, k and v, and
  mamba2's and zamba2's conv blocks cut across the head shards' channels):
  the logits and the caches equal, to the bit in fp32, the gathered
  weights' decode run with the same split (``tp_devices``), and within
  1e-5 of the logit scale the whole weights' decode without a split (the
  tensor-parallel sum of partial outputs in place of the whole product),
  with equal greedy tokens.  Each position's gathered high-water mark is
  at most two of its gather scopes.
* The dry-run's decode cell gathers no whole leaf (``Placed.gather`` and
  ``gather_tree`` refuse), and each row position's gathered high-water
  mark there is at most two of its gather scopes.

The dry-run's decode cells' bytes a position, against the reference's
specs, are held in ``tests/test_torch_seq_split_decode.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis import opcount
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from repro_torch.launch.specs import rules_for_cell
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_params)
from repro_torch.parallel import partition
from repro_torch.parallel.partition import (Placed, gather_tree, place_cache,
                                            place_tree)
from repro_torch.tree import tree_leaves

LOGIT_TOL = 1e-5            # of max|logit|, fp32, another split
CACHE_TOL = 1e-5            # of max|cache|, fp32, another split
STEPS = 3
CPU = torch.device("cpu")

#: (data, model) grids every configuration decodes on, and the extra
#: 1 x 4 cases: llama3 smoke's KV 2 does not divide 4 (q, k and v on the
#: lead, the positions' partials), mamba2's and zamba2's conv blocks of
#: 40 and 72 channels cut across their shards' x and B/C channels
GRIDS = [(1, 2), (2, 2)]
CASES = [(a, g) for a in ARCHS for g in GRIDS] + [
    (a, (1, 4)) for a in ("llama3-405b", "mamba2-370m", "zamba2-1.2b")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, grid):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    mesh = make_test_mesh(*grid)
    rules = rules_for_cell(mesh, SHAPE_CELLS["decode_32k"], cfg)
    gen = torch.Generator().manual_seed(1)
    B, T = 2, 32
    base = init_cache(cfg, B, T, device=CPU)
    for key, t in base.items():
        if key != "len":
            t.copy_(torch.randn(t.shape, generator=gen))
    # a partly filled cache: one slot early in its first block, one late
    base["len"] = torch.tensor([5, 27], dtype=torch.int32)
    enc = (torch.randn(B, 8, cfg.d_model, generator=gen)
           if cfg.family == "encdec" else None)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    return cfg, params, mesh, rules, base, enc, tok


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)


@pytest.mark.parametrize("arch,grid", CASES,
                         ids=[f"{a}-{g[0]}x{g[1]}" for a, g in CASES])
def test_placed_decode_matches_the_gathered_weights(arch, grid):
    cfg, params, mesh, rules, base, enc, tok = _setup(arch, grid)
    placed = place_tree(params, mesh, rules, kind="params")
    assert all(isinstance(t, Placed) for t in tree_leaves(placed))
    gathered = gather_tree(placed)
    row = [CPU] * grid[1]
    caches = [place_cache({k: v.clone() for k, v in base.items()}, mesh,
                          rules) for _ in range(3)]
    for _ in range(STEPS):
        with torch.no_grad(), opcount.gather_marks() as marks:
            got, _ = decode_step(cfg, placed, caches[0], tok, enc_out=enc)
        with torch.no_grad():
            same, _ = decode_step(cfg, gathered, caches[1], tok,
                                  enc_out=enc, tp_devices=row)
            whole, _ = decode_step(cfg, params, caches[2], tok, enc_out=enc)
        assert torch.equal(got, same)
        assert _gap(got, whole) <= LOGIT_TOL
        assert torch.equal(got.argmax(-1), whole.argmax(-1))
        peak, scope = marks.as_lists(mesh.size)
        for k in mesh.rows()[0]:
            assert 0 < peak[k] <= 2 * scope[k], (k, peak, scope)
        tok = whole.argmax(-1)
    a, b, c = map(gather_tree, caches)
    for key in a:
        assert torch.equal(a[key], b[key]), key
        if key != "len":
            assert _gap(a[key], c[key]) <= CACHE_TOL, key
    assert torch.equal(a["len"], base["len"] + STEPS)


#: a decode cell of a few positions
TINY = ShapeCell("decode_tiny", 16, 4, "decode")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "whisper-base", "mamba2-370m"])
def test_decode_cell_gathers_no_whole_leaf(arch, monkeypatch):
    """The decode cell's step on a 2 x 2 meta grid's 1 x 2 row, at the
    smoke config, with ``Placed.gather`` and ``gather_tree`` refusing."""
    cfg = get_smoke_config(arch)
    monkeypatch.setitem(SHAPE_CELLS, TINY.name, TINY)
    meta = compat_make_mesh((2, 2), ("data", "model"), device="meta")
    cell = specs_mod.build_cell(arch, cfg, TINY.name,
                                rules_for_cell(meta, TINY, cfg))

    def refuse(*a, **k):
        raise AssertionError("a whole leaf was gathered")
    monkeypatch.setattr(Placed, "gather", refuse)
    monkeypatch.setattr(partition, "gather_tree", refuse)
    with OpCounter(2) as c:
        logits, _ = cell.fn(*cell.args)
    assert logits.shape == (cell.row_batch, 1, cfg.padded_vocab)
    an = c.analysis()
    for k in range(2):
        assert 0 < an.gathered[k] <= 2 * an.gathered_scope[k]
