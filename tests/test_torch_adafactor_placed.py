"""Adafactor on a training mesh, each placed block updated on its position
(``optim.opt_update_placed``), as the reference's devices update their
shards: the row and column moments, the row mean and the update-RMS are
partial sums over the blocks, and no position holds a whole leaf.

* One update (two steps' gradients) on 1 x 2, 2 x 1, 2 x 2, 1 x 4 and
  4 x 2 grids for the qwen2, qwen2-moe (3-D expert leaves), mamba2 and
  llama3 (clip groups) smoke configs, moments factored
  (``factored_min`` 8), against the meshless ``opt_update``: fp32
  parameters and every moment within ``MESH_TOL`` of their scale.  bf16
  parameters are held to the bf16 bound of
  ``test_torch_llama3_dtypes._check_state``: within one bf16 spacing of
  the meshless value, or 2^-16 of the old value where the update cancels
  it.  The fp32 values before the rounding differ by about 1e-7 of the
  scale (the sums run in other orders), which puts a few elements of
  several hundred thousand on the other side of a rounding boundary.
* llama3 smoke's placed fused step from the JAX package's state, at the
  bounds of ``test_torch_adafactor_groups.py``.
* Every copy of a replicated region equal to the bit.
* The fused step on a 2 x 2 grid calls neither ``Placed.gather`` nor
  ``gather_tree`` (``Placed`` has no whole-leaf write-back any more); a
  state whose moments are not placed over their parameter's blocks is
  refused, naming the leaf.
* The dry-run's trace of llama3 smoke's train cell on a 1 x 2 meta row:
  a position's bytes made during the update stay within three fp32 copies
  of its largest block at a production position's share, and the
  update's sums across blocks are recorded as all-reduces.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import opcount
from repro_torch.configs import get_smoke_config
from repro_torch.data import to_device
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.models.transformer import clip_groups, init_params
from repro_torch.optim import (OptimizerSpec, init_opt_state, opt_update,
                               opt_update_placed)
from repro_torch.optim import optimizers
from repro_torch.parallel import partition
from repro_torch.parallel.partition import (Placed, gather_tree, place_leaf,
                                            place_state, production_share)
from repro_torch.train import TrainState, make_train_step, shard_state
from repro_torch.train import step as step_mod
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from repro_torch.weights import train_state_from_jax_numpy
from test_torch_adafactor_groups import (MOMENT_TOL, TOL, _cfg, _worst,
                                         reference)

CPU = torch.device("cpu")
MESH_TOL = 1e-5          # of the scale: placed vs meshless (the mesh tests')
GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 2)]      # (data, model)
ARCHS = ["qwen2-1.5b", "qwen2-moe-a2.7b", "mamba2-370m", "llama3-405b"]
SPEC = OptimizerSpec(kind="adafactor", lr=1e-3, factored_min=8)
#: a train cell of a few tokens (the smoke config's parameters, not its
#: activations, size the update)
TINY = ShapeCell("train_tiny", 16, 8, "train")
#: a position's bytes made during the update (the global norm's included),
#: in fp32 copies of its largest block: a direction, the new parameter in
#: fp32 and in its own dtype, and the moments' vectors
UPDATE_COPIES = 3

assert reference                 # the reference step, a fixture here too


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch: str, dtype: str):
    """Smoke parameters in ``dtype``, a fresh Adafactor state, the clip
    groups and two gradients drawn with numpy (seed 0)."""
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(0)
    grads = [tree_unflatten(params, [
        torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
            np.float32)).to(p.dtype) for p in tree_leaves(params)])
        for _ in range(2)]
    return params, init_opt_state(SPEC, params), clip_groups(cfg, params), \
        grads


def _placed_run(params, opt, groups, grads, grid):
    """The two updates on ``grid``: its placed parameters and state."""
    mesh = make_test_mesh(*grid)
    placed = place_state({"params": params, "opt_state": opt}, mesh)
    for g in grads:
        opt_update_placed(SPEC, place_state({"params": g}, mesh)["params"],
                          placed["opt_state"], placed["params"],
                          clip_groups=groups)
    return placed


def _meshless_run(params, opt, groups, grads):
    p, o = tree_map(torch.clone, params), tree_map(torch.clone, opt)
    for g in grads:
        opt_update(SPEC, tree_map(torch.clone, g), o, p, inplace=True,
                   clip_groups=groups)
    return p, o


def _bf16_spacing(w: torch.Tensor) -> torch.Tensor:
    a = w.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.fixture(scope="module")
def meshless():
    """The meshless updates by ``(arch, dtype)``, each run once."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            params, opt, groups, grads = _setup(arch, dtype)
            made[arch, dtype] = _meshless_run(params, opt, groups, grads)
        return made[arch, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_update_matches_meshless(meshless, arch, grid, dtype):
    params, opt, groups, grads = _setup(arch, dtype)
    factored = [t for path, t in tree_paths(opt["f"])
                if path.endswith("/vr")]
    assert factored, "no factored leaf"
    if arch == "qwen2-moe-a2.7b":
        assert any(t.dim() == 2 for t in factored)      # (E, rows)
    placed = _placed_run(params, opt, groups, grads, grid)
    ref_p, ref_o = meshless(arch, dtype)
    got_p = tree_leaves(gather_tree(placed["params"]))
    got_o = [t for t in tree_leaves(gather_tree(placed["opt_state"]))
             if t.dim()]
    want_o = [t for t in tree_leaves(ref_o) if t.dim()]
    oscale = max(float(t.abs().max()) for t in want_o)
    oerr = max(float((a - b).abs().max()) for a, b in zip(got_o, want_o))
    assert oerr <= MESH_TOL * oscale, oerr / oscale
    want_p = tree_leaves(ref_p)
    if dtype == "float32":
        pscale = max(float(t.abs().max()) for t in want_p)
        perr = max(float((a - b).abs().max())
                   for a, b in zip(got_p, want_p))
        assert perr <= MESH_TOL * pscale, perr / pscale
        return
    for (path, a), b, p0 in zip(tree_paths(got_p), want_p,
                                tree_leaves(params)):
        assert a.dtype == torch.bfloat16
        tol = torch.maximum(_bf16_spacing(b), p0.float().abs() * 2.0 ** -16)
        bad = (a.float() - b.float()).abs() > tol
        assert not bad.any(), (path, int(bad.sum()))


@pytest.mark.parametrize("grid", [(4, 2), (1, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_copies_stay_equal_to_the_bit(arch, grid):
    """Every block of a parameter or moment equals the block of its
    region's first holder after the two updates (bf16 parameters)."""
    params, opt, groups, grads = _setup(arch, "bfloat16")
    placed = _placed_run(params, opt, groups, grads, grid)
    copies = 0
    for leaf in tree_leaves(placed):
        regs = [tuple((s.start, s.stop) for s in r) for r in leaf.regions()]
        for k, r in enumerate(regs):
            first = regs.index(r)
            copies += first != k
            assert torch.equal(leaf.blocks[k], leaf.blocks[first])
    assert copies > 0


@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_llama3_placed_step_meets_the_reference(reference, grid):
    """llama3 smoke's fused step on a grid from the JAX package's state
    (fp32, lr 1e-2, the stacked groups' clip): every parameter within
    1e-6 of its leaf's scale and every moment within ``MOMENT_TOL`` of
    the reference's, the bounds of the meshless step."""
    cfg = _cfg()
    spec = OptimizerSpec(kind="adafactor", lr=1e-2)
    mesh = make_test_mesh(*grid)
    state = shard_state(train_state_from_jax_numpy(reference["init"], cfg,
                                                   CPU), mesh)
    step = make_train_step(cfg, spec, grad_accum=1, mesh=mesh)
    state, metrics = step(state, to_device(reference["batch"], CPU))
    np.testing.assert_allclose(float(metrics["loss_total"]),
                               reference["loss"], rtol=1e-6)
    want = train_state_from_jax_numpy(reference["after"], cfg, CPU)
    got = TrainState.from_tree(state.tree())
    worst = _worst(got.params, want.params)
    assert worst[0] <= TOL, worst
    worst = _worst(got.opt_state["f"], want.opt_state["f"])
    assert worst[0] <= MOMENT_TOL, worst


def test_fused_step_gathers_and_scatters_no_whole_leaf(monkeypatch):
    """``make_train_step(mesh=)`` under Adafactor on a 2 x 2 grid with
    every whole-leaf gather refused; the state it leaves is the meshless
    step's within ``MESH_TOL``."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              compute_dtype="float32", qkv_bias=False)
    state = TrainState.create(cfg, SPEC, torch.Generator().manual_seed(0),
                              CPU)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mesh = make_test_mesh(2, 2)
    placed = shard_state(TrainState(tree_map(torch.clone, state.params),
                                    tree_map(torch.clone, state.opt_state)),
                         mesh)
    with monkeypatch.context() as m:
        def refuse(*a, **k):
            raise AssertionError("a whole leaf was gathered")
        m.setattr(Placed, "gather", refuse)
        m.setattr(partition, "gather_tree", refuse)
        m.setattr(step_mod, "gather_tree", refuse)
        for _ in range(2):
            placed, _ = make_train_step(cfg, SPEC, grad_accum=2,
                                        mesh=mesh)(placed, batch)
    step = make_train_step(cfg, SPEC, grad_accum=2)
    for _ in range(2):
        state, _ = step(state, batch)
    for got, want in ((placed.params, state.params),
                      (placed.opt_state, state.opt_state)):
        want_l = [t for t in tree_leaves(want) if t.dim()]
        got_l = [t for t in tree_leaves(gather_tree(got)) if t.dim()]
        scale = max(float(t.abs().max()) for t in want_l)
        err = max(float((a - b).abs().max()) for a, b in zip(got_l, want_l))
        assert err <= MESH_TOL * scale, err / scale


def test_a_moment_placed_apart_from_its_parameter_is_refused():
    """A factored moment whose blocks do not cover the rows of its
    parameter's block on the same position: the update raises, naming the
    leaf and the specs, before any block is written, and falls back to
    nothing."""
    params, opt, groups, grads = _setup("qwen2-1.5b", "float32")
    mesh = make_test_mesh(2, 2)
    placed = place_state({"params": params, "opt_state": opt}, mesh)
    table = opt["f"]["embed"]["table"]
    assert placed["params"]["embed"]["table"].spec == ("model", "data")
    placed["opt_state"]["f"]["embed"]["table"]["vr"] = place_leaf(
        table["vr"], mesh, ("data",))
    before = [b.clone() for leaf in tree_leaves(placed)
              for b in leaf.blocks]
    with pytest.raises(ValueError, match=r"vr of embed/table .*'data'.*"
                                         r"'model', 'data'"):
        opt_update_placed(SPEC, place_state({"params": grads[0]},
                                            mesh)["params"],
                          placed["opt_state"], placed["params"],
                          clip_groups=groups)
    after = [b for leaf in tree_leaves(placed) for b in leaf.blocks]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_dryrun_update_holds_a_block_at_a_time(monkeypatch):
    """llama3 smoke's train cell under Adafactor, traced as the dry-run
    traces it (the 1 x 2 row of a 2 x 2 meta grid): the bytes each
    position makes during the update stay within ``UPDATE_COPIES`` fp32
    copies of its largest block at a production position's share (less
    than one fp32 copy of the largest whole leaf, of which the update on
    the lead made several), and the sums across blocks are all-reduces at site
    ``adafactor_reduce`` on both positions."""
    monkeypatch.setitem(SHAPE_CELLS, TINY.name, TINY)
    cfg = dataclasses.replace(get_smoke_config("llama3-405b"),
                              optimizer="adafactor")
    transient = []
    update = step_mod.opt_update_placed

    def measured(*args, **kw):
        counter = opcount.active()
        before = [(p.live_bytes, p.peak_bytes) for p in counter.pos]
        for p in counter.pos:
            p.peak_bytes = p.live_bytes
        out = update(*args, **kw)
        transient.append([p.peak_bytes - live for p, (live, _)
                          in zip(counter.pos, before)])
        for p, (_, peak) in zip(counter.pos, before):
            p.peak_bytes = max(p.peak_bytes, peak)
        return out
    monkeypatch.setattr(step_mod, "opt_update_placed", measured)
    mesh = compat_make_mesh((2, 2), ("data", "model"), device="meta")
    spec, counter, _ = dryrun.trace_cell("llama3-405b", TINY.name, cfg=cfg,
                                         mesh=mesh)
    assert spec.row.size == 2 and len(transient) == 1
    params = tree_leaves(spec.args[0].params)
    block = [max(int(leaf.blocks[k].numel() * 4
                     * production_share(leaf, spec.mesh)) for leaf in params)
             for k in range(2)]
    whole = max(leaf.shape.numel() * 4 for leaf in params)
    for k in range(2):
        assert 0 < transient[0][k] <= UPDATE_COPIES * block[k], (
            k, transient[0][k], block[k])
        assert UPDATE_COPIES * block[k] < whole
    sums = counter.analysis().by_site[("all-reduce",
                                       optimizers.REDUCE_SITE)]
    assert sums["calls"] > 0 and sums["bytes"] > 0
    reduces = [p.collectives.counts["all-reduce"] for p in counter.pos]
    assert all(n > 0 for n in reduces), reduces
