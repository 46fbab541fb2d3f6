"""The port's training mesh (``launch/mesh.py``, ``parallel.partition``'s
placement, ``TrainState.create(mesh=)``, ``make_train_step(mesh=)``,
``launch.train --data-axis/--model-axis``) on the CPU, where every grid
position is the CPU, against the port's meshless step and the JAX package.

* The reference's mesh test (``tests/test_sharding.py:90-158``): its MoE
  config (2 layers, d 64, 4 experts top-2, batch 8 x 32, 3 AdamW steps at
  lr 1e-3) on a 4 x 2 grid, from the JAX package's initial state: within
  1e-5 of max|param| of the port's meshless run, within 2e-5 of the JAX
  package's single-device run (the bound of 3 fused steps in
  ``test_torch_train_families.py``), and within the reference's own 5e-3
  of the JAX package's 4 x 2 mesh, run once in a subprocess on 8 forced
  host devices.  AdamW runs at eps 1e-6
  on every side, as ``test_torch_train_families.py`` explains: at 1e-8
  its first update turns the rounding noise of the key biases' gradients
  (exactly 0 in exact arithmetic) into steps of about ±lr.
* A 1 x 1 grid is no mesh: the same tensors, and parameters, moments and
  metrics bit-identical to the meshless step's after 3 steps.
* Each position holds exactly the specs' shard bytes.
* AdamW and Adafactor (factored) at TP=2, DP=2 and TP=2 x DP=2 with
  grad_accum 2, every family's gradients at TP=2 x DP=2 under each remat
  policy, a ``dp`` that does not divide the batch, the attention core's
  calls, checkpoints saved under 2 x 2 and restored under 1 x 1 and 2 x 2,
  and the launcher on a 2 x 2 grid.

Compute is fp32: in bf16 a TP shard's partial output and a DP row's weight
gradient round to bf16 before they are summed, where the meshless step
rounds the whole sum once.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import ModelConfig as JaxConfig
from repro.optim import OptimizerSpec as JaxSpec
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLMStream, to_device
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerSpec
from repro_torch.parallel import DEFAULT_RULES, ShardingRules
from repro_torch.parallel.partition import (Placed, gather_tree, place_state,
                                            position_bytes, spec_bytes,
                                            tree_specs)
from repro_torch.train import (TrainState, compute_grads, compute_grads_mesh,
                               make_train_step, shard_state)
from repro_torch.train import step as step_mod
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import train_state_from_jax_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MESH_TOL = 1e-5          # of max|param|: mesh vs the port's meshless step
JAX_TOL = 2e-5           # vs the JAX package's single device
JAX_MESH_TOL = 5e-3      # vs the JAX package's 4 x 2 mesh (its own bound)
SHAPES = [(1, 2), (2, 1), (2, 2)]          # (data, model)

# tests/test_sharding.py's MoE config
MOE_KW = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, n_experts=4, top_k=2,
              moe_d_ff=96, compute_dtype="float32")
JSPEC = JaxSpec(kind="adamw", lr=1e-3, eps=1e-6)
SPEC = OptimizerSpec(kind="adamw", lr=1e-3, eps=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _max_rel(got, want) -> float:
    scale = max(float(w.abs().max()) for w in tree_leaves(want))
    return max(float((g - w).abs().max()) for g, w in
               zip(tree_leaves(got), tree_leaves(want))) / scale


def _batches(cfg, n, batch=8, seq=32):
    """The synthetic stream's first ``n`` batches (numpy; the JAX
    package's stream gives the same arrays)."""
    stream = SyntheticLMStream(cfg, DataConfig(global_batch=batch,
                                               seq_len=seq))
    return [stream.batch(s) for s in range(n)]


def _run(cfg, spec, init, batches, mesh, *, accum=1):
    """Steps from ``init`` (a reference state as numpy) on ``mesh`` (None:
    no mesh); returns ``(state, metrics of each step)``."""
    state = train_state_from_jax_numpy(init, cfg, CPU)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = make_train_step(cfg, spec, grad_accum=accum, mesh=mesh)
    out = []
    for b in batches:
        state, m = step(state, to_device(b, CPU))
        out.append({k: v.clone() for k, v in m.items()})
    return state, out


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These steps are thousands of tiny ops (a leaf a grid position):
    under several test workers, each op's wait for a full pool of
    intra-op threads on the shared cores cost 30x their one-thread time.
    The process's thread count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moe_init():
    jcfg = JaxConfig(**MOE_KW)
    state = JaxTrainState.create(jcfg, JSPEC, jax.random.PRNGKey(0))
    return _np({"params": state.params, "opt_state": state.opt_state,
                "step": state.step})


# ---------------------------------------------------------------------------
# the reference's 4 x 2 MoE mesh test, against both packages
# ---------------------------------------------------------------------------

JAX_MESH = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.data import DataConfig, SyntheticLMStream
    from repro.launch.mesh import compat_make_mesh
    from repro.models.config import ModelConfig
    from repro.optim import OptimizerSpec
    from repro.parallel.partition import tree_shardings
    from repro.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                         use_rules)
    from repro.train import TrainState, make_train_step

    cfg = ModelConfig(**{kw})
    spec = OptimizerSpec(kind="adamw", lr=1e-3, eps=1e-6)
    stream = SyntheticLMStream(cfg, DataConfig(global_batch=8, seq_len=32))
    batches = [jax.tree.map(jnp.asarray, stream.batch(s)) for s in range(3)]
    mesh = compat_make_mesh((4, 2), ("data", "model"))
    rules = ShardingRules(mesh=mesh, rules=dict(DEFAULT_RULES))
    with use_rules(mesh, rules.rules):
        struct = jax.eval_shape(lambda k: TrainState.create(cfg, spec, k),
                                jax.random.PRNGKey(0))
        sh = tree_shardings(struct, rules, kind="state")
        step = jax.jit(make_train_step(cfg, spec), in_shardings=(sh, None),
                       out_shardings=(sh, None))
        state = jax.jit(lambda k: TrainState.create(cfg, spec, k),
                        out_shardings=sh)(jax.random.PRNGKey(0))
        for b in batches:
            state, _ = step(state, b)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, state.params), f)
    print("JAX_MESH_OK", len(jax.devices()))
""")


@pytest.fixture(scope="module")
def jax_mesh_params(tmp_path_factory):
    """The JAX package's 4 x 2 mesh run of the reference's test, in a
    subprocess on 8 forced host devices: its parameters as numpy."""
    out = tmp_path_factory.mktemp("jax_mesh") / "params.pkl"
    r = subprocess.run([sys.executable, "-c",
                        JAX_MESH.format(kw=repr(MOE_KW)), str(out)],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env={"PYTHONPATH": os.path.join(REPO, "src"),
                                      "PATH": "/usr/bin:/bin"})
    assert "JAX_MESH_OK 8" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    with open(out, "rb") as f:          # written by the subprocess above
        return pickle.load(f)


def test_moe_on_a_4x2_grid_matches_meshless_and_both_jax_runs(
        moe_init, jax_mesh_params):
    cfg = ModelConfig(**MOE_KW)
    batches = _batches(cfg, 3)
    mesh = make_test_mesh(4, 2)
    got, gm = _run(cfg, SPEC, moe_init, batches, mesh)
    assert all(isinstance(p, Placed) for p in tree_leaves(got.params))
    ref, rm = _run(cfg, SPEC, moe_init, batches, None)
    whole = gather_tree(got.params)
    assert _max_rel(whole, ref.params) <= MESH_TOL
    np.testing.assert_allclose([float(m["loss_total"]) for m in gm],
                               [float(m["loss_total"]) for m in rm],
                               rtol=1e-6)
    for key in ("aux", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(gm[-1][key]), float(rm[-1][key]),
                                   rtol=1e-5)

    jcfg = JaxConfig(**MOE_KW)
    js = JaxTrainState.create(jcfg, JSPEC, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, JSPEC))
    for b in batches:
        js, _ = jstep(js, jax.tree.map(jnp.asarray, b))
    single = train_state_from_jax_numpy(
        _np({"params": js.params, "opt_state": js.opt_state,
             "step": js.step}), cfg, CPU).params
    on_mesh = train_state_from_jax_numpy(
        {**_np({"opt_state": js.opt_state, "step": js.step}),
         "params": jax_mesh_params}, cfg, CPU).params
    for a, b in zip(tree_leaves(whole), tree_leaves(single)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=JAX_TOL)
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(whole), tree_leaves(on_mesh)))
    assert gap < JAX_MESH_TOL, gap


# ---------------------------------------------------------------------------
# a 1 x 1 grid is no mesh
# ---------------------------------------------------------------------------


def test_one_by_one_grid_is_bit_identical_to_no_mesh(moe_init):
    cfg = ModelConfig(**MOE_KW)
    batches = _batches(cfg, 3)
    one = compat_make_mesh((1, 1), ("data", "model"), device="cpu")
    state = train_state_from_jax_numpy(moe_init, cfg, CPU)
    placed = shard_state(state, one)
    for a, b in zip(tree_leaves(placed.params) + tree_leaves(placed.opt_state),
                    tree_leaves(state.params) + tree_leaves(state.opt_state)):
        assert a is b
    got, gm = _run(cfg, SPEC, moe_init, batches, one)
    ref, rm = _run(cfg, SPEC, moe_init, batches, None)
    for a, b in zip(tree_leaves(got.tree()), tree_leaves(ref.tree())):
        assert torch.equal(a, b)
    for g, r in zip(gm, rm):
        assert g.keys() == r.keys()
        for k in g:
            assert torch.equal(g[k], r[k]), k


# ---------------------------------------------------------------------------
# the bytes each position holds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", SHAPES + [(4, 2)])
def test_each_position_holds_the_specs_shard_bytes(shape, kind):
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    spec = OptimizerSpec(kind=kind, factored_min=8)
    mesh = make_test_mesh(*shape)
    state = TrainState.create(cfg, spec, torch.Generator().manual_seed(0),
                              CPU)
    tree = {"params": state.params, "opt_state": state.opt_state}
    rules = ShardingRules(mesh, dict(DEFAULT_RULES))
    specs = tree_specs(tree, rules, kind="state")
    want = spec_bytes(tree, rules, kind="state")
    placed = shard_state(state, mesh)
    got = position_bytes({"params": placed.params,
                          "opt_state": placed.opt_state})
    assert got == [want] * mesh.size
    total = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    assert want < total            # the big leaves are split
    # the embedding splits over both axes; the V projection is replicated
    # (the reference's stripped "v" key), K splits
    attn = specs["params"]["layers"][0]["attn"]
    if shape == (2, 2):
        V, d = state.params["embed"]["table"].shape
        assert placed.params["embed"]["table"].blocks[3].shape == (V // 2,
                                                                   d // 2)
        assert specs["params"]["embed"]["table"] == ("model", "data")
        assert attn["k"]["w"] == ("data", "model")
        assert attn["v"]["w"] == ()


# ---------------------------------------------------------------------------
# optimizers, families and remat policies on TP, DP and both
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", SHAPES)
def test_optimizers_on_tp_dp_and_both_match_no_mesh(shape, kind):
    """2 steps of grad_accum 2 (each micro-batch split over the rows):
    within 1e-5 of max|param| and of the moments' scale of the meshless
    step, Adafactor's moments factored (``factored_min`` 8), and every
    copy of a replicated region equal to the bit.

    Adafactor runs without the QKV biases: the key biases' exact gradient
    is 0 (a constant added to every score of a query leaves its softmax
    unchanged), and Adafactor, which has no eps to damp it, steps them by
    about ±lr in the direction of their gradients' rounding noise (up to
    5.5e-5 apart after 2 steps), as AdamW at eps 1e-8 does."""
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    if kind == "adafactor":
        cfg = dataclasses.replace(cfg, qkv_bias=False)
    spec = OptimizerSpec(kind=kind, lr=1e-3, eps=1e-6, factored_min=8)
    state = TrainState.create(cfg, spec, torch.Generator().manual_seed(0),
                              CPU)
    if kind == "adafactor":
        assert "vr" in state.opt_state["f"]["embed"]["table"]
    init = {"params": state.params, "opt_state": state.opt_state}
    batches = _batches(cfg, 2, batch=4, seq=16)
    mesh = make_test_mesh(*shape)
    got, gm = _run_port(cfg, spec, init, batches, mesh)
    ref, rm = _run_port(cfg, spec, init, batches, None)
    assert _max_rel(gather_tree(got.params), ref.params) <= MESH_TOL
    opt = [t for t in tree_leaves(ref.opt_state) if t.dim()]
    assert _max_rel([t for t in tree_leaves(gather_tree(got.opt_state))
                     if t.dim()], opt) <= MESH_TOL
    np.testing.assert_allclose(float(gm[-1]["grad_norm"]),
                               float(rm[-1]["grad_norm"]), rtol=1e-5)
    for leaf in tree_leaves(got.params) + tree_leaves(got.opt_state):
        regs = [tuple((s.start, s.stop) for s in r) for r in leaf.regions()]
        for k, r in enumerate(regs):
            first = regs.index(r)
            assert torch.equal(leaf.blocks[k], leaf.blocks[first])


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _run_port(cfg, spec, init, batches, mesh):
    """2 steps of grad_accum 2 from copies of ``init``'s tensors."""
    state = TrainState(params=_clone(init["params"]),
                       opt_state=_clone(init["opt_state"]), step=0)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = make_train_step(cfg, spec, grad_accum=2, mesh=mesh)
    out = []
    for b in batches:
        state, m = step(state, to_device(b, CPU))
        out.append(m)
    return state, out


FAMILIES = ["qwen2-1.5b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-1.2b",
            "whisper-base", "gemma3-4b"]


@pytest.mark.parametrize("remat", ["none", "full", "save_dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_gradients_on_a_2x2_grid(arch, remat):
    """One batch's loss and gradients (grad_accum 2) at TP=2 x DP=2 within
    1e-5 of the meshless step's: the shared block, cross-attention, the
    SSM mixers, experts and local/global windows, under each remat
    policy."""
    cfg = dataclasses.replace(_fp32(get_smoke_config(arch)), remat=remat)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    (batch,) = _batches(cfg, 1, batch=4, seq=24)
    batch = to_device(batch, CPU)
    grads, loss, metrics = compute_grads(cfg, params, batch, accum=2)
    mesh = make_test_mesh(2, 2)
    placed = place_state({"params": params}, mesh)["params"]
    mgrads, mloss, mmetrics = compute_grads_mesh(cfg, placed, batch, mesh,
                                                 accum=2)
    np.testing.assert_allclose(float(mloss), float(loss), rtol=1e-6)
    for k in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(mmetrics[k]), float(metrics[k]),
                                   rtol=1e-6, atol=1e-7)
    whole = gather_tree(mgrads)
    for g, w in zip(tree_leaves(whole), tree_leaves(grads)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("shape,calls_per_layer", [((1, 2), 2), ((2, 1), 2),
                                                   ((2, 2), 4), ((1, 4), 1)])
def test_attention_core_runs_once_a_shard_and_a_row(shape, calls_per_layer,
                                                    monkeypatch):
    """The cache-less attention core runs micro-batches x layers x 2 (the
    remat recompute) x tp x dp times; at TP=4 the smoke model's 2 KV heads
    do not split, so the row's lead runs the whole layer (its MLP still
    splits by d_ff)."""
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    assert cfg.remat == "full" and cfg.n_kv_heads == 2
    calls = []
    core = attn_mod._attn_core

    def counted(q, *a, **kw):
        calls.append(q.shape[2])
        return core(q, *a, **kw)
    monkeypatch.setattr(attn_mod, "_attn_core", counted)
    mlp_calls = []
    mlp_tp = transformer.apply_mlp_tp

    def counted_mlp(cfg_, shards, x):
        mlp_calls.append(len(shards))
        return mlp_tp(cfg_, shards, x)
    monkeypatch.setattr(transformer, "apply_mlp_tp", counted_mlp)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    (batch,) = _batches(cfg, 1, batch=4, seq=16)
    mesh = make_test_mesh(*shape)
    placed = place_state({"params": params}, mesh)["params"]
    compute_grads_mesh(cfg, placed, to_device(batch, CPU), mesh, accum=2)
    assert len(calls) == 2 * cfg.n_layers * 2 * calls_per_layer
    tp = shape[1]
    heads = cfg.n_heads // tp if cfg.n_kv_heads % tp == 0 else cfg.n_heads
    assert set(calls) == {heads}
    assert mlp_calls == ([tp] * (2 * cfg.n_layers * 2 * shape[0])
                         if tp > 1 else [])


def test_a_dp_that_does_not_divide_the_batch_runs_row_0(monkeypatch):
    """Batch 3 on 2 data rows: the ``batch`` rule is dropped, the whole
    batch runs on row 0, and the values are the meshless step's."""
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    spec = OptimizerSpec(kind="adamw", lr=1e-3, eps=1e-6)
    state = TrainState.create(cfg, spec, torch.Generator().manual_seed(0),
                              CPU)
    batches = [to_device(b, CPU) for b in _batches(cfg, 2, batch=3, seq=16)]
    mesh = make_test_mesh(2, 2)
    rows = []
    real = transformer.loss_sums

    def seen(cfg_, params, batch, **kw):
        rows.append(batch["tokens"].shape[0])
        return real(cfg_, params, batch, **kw)
    monkeypatch.setattr(step_mod, "loss_sums", seen)
    out = {}
    for m in (mesh, None):
        st = TrainState(params=_clone(state.params),
                        opt_state=_clone(state.opt_state), step=0)
        if m is not None:
            st = shard_state(st, m)
        step = make_train_step(cfg, spec, mesh=m)
        for b in batches:
            st, _ = step(st, b)
        out[m is None] = gather_tree(st.params)
    assert rows == [3, 3]
    assert _max_rel(out[False], out[True]) <= MESH_TOL


def test_bf16_data_rows_keep_every_gradient_leaf_close():
    """bf16 compute, 2 data rows, 4 x 1,024 Zipf tokens (one token over
    500 times a micro-batch): every gradient leaf within 1e-2 of
    max|meshless|.  The embedding's gradient is a scatter-add over
    repeated tokens; accumulated in bf16 it lost much of a frequent
    token's sum to rounding, differently for each split of the batch
    (0.092 of max|g| apart here, 0.295 on the card at seq 4,096);
    ``layers.embed`` gathers the fp32 rows before the cast, so it
    accumulates in fp32."""
    cfg = get_smoke_config("qwen2-1.5b")
    assert cfg.compute_dtype == "bfloat16"
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    (batch,) = _batches(cfg, 1, batch=4, seq=1024)
    batch = to_device(batch, CPU)
    grads, _, _ = compute_grads(cfg, params, batch, accum=2)
    mesh = make_test_mesh(2, 1)
    placed = place_state({"params": params}, mesh)["params"]
    mgrads, _, _ = compute_grads_mesh(cfg, placed, batch, mesh, accum=2)
    for g, w in zip(tree_leaves(gather_tree(mgrads)), tree_leaves(grads)):
        assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max())


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------


def test_checkpoint_saved_on_2x2_restores_on_1x1_and_2x2(tmp_path):
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    spec = OptimizerSpec(kind="adamw", lr=1e-3, eps=1e-6)
    batches = [to_device(b, CPU) for b in _batches(cfg, 3, batch=4, seq=16)]
    mesh = make_test_mesh(2, 2)
    state = TrainState.create(cfg, spec, torch.Generator().manual_seed(0),
                              CPU, mesh=mesh)
    step = make_train_step(cfg, spec, mesh=mesh)
    for b in batches[:2]:
        state, _ = step(state, b)
    saved = state.tree()
    save_checkpoint(str(tmp_path), saved, 2)
    like = {"params": state.params, "opt_state": state.opt_state,
            "step": torch.zeros((), dtype=torch.int32)}
    on_mesh, at = restore_checkpoint(str(tmp_path), like, mesh=mesh)
    one = compat_make_mesh((1, 1), ("data", "model"), device="cpu")
    on_one, _ = restore_checkpoint(str(tmp_path), saved, mesh=one)
    assert at == 2
    for a, b, c in zip(tree_leaves(gather_tree(on_mesh)), tree_leaves(saved),
                       tree_leaves(on_one)):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert all(isinstance(x, Placed) for x in tree_leaves(on_mesh))
    assert not any(isinstance(x, Placed) for x in tree_leaves(on_one))
    s_mesh = TrainState.from_tree(on_mesh)
    s_one = TrainState.from_tree(on_one)
    assert s_mesh.step == s_one.step == 2
    s_mesh, _ = step(s_mesh, batches[2])
    state, _ = step(state, batches[2])
    s_one, _ = make_train_step(cfg, spec)(s_one, batches[2])
    for a, b in zip(tree_leaves(gather_tree(s_mesh.params)),
                    tree_leaves(gather_tree(state.params))):
        assert torch.equal(a, b)
    assert _max_rel(s_one.params, gather_tree(state.params)) <= MESH_TOL


# ---------------------------------------------------------------------------
# the launcher and the grid's devices
# ---------------------------------------------------------------------------


def test_launcher_trains_on_a_2x2_grid_as_without_one(monkeypatch, capsys,
                                                      tmp_path):
    monkeypatch.setattr(launch_train, "get_smoke_config",
                        lambda arch: _fp32(get_smoke_config(arch)))
    def argv(steps, *more):
        return ["--smoke", "--device", "cpu", "--steps", str(steps),
                "--batch", "4", "--seq", "32", "--grad-accum", "2", *more]
    mesh = ("--data-axis", "2", "--model-axis", "2")
    plain = launch_train.main(argv(3))
    on_mesh = launch_train.main(argv(3, *mesh, "--ckpt-dir", str(tmp_path),
                                     "--ckpt-every", "2"))
    out = capsys.readouterr().out
    assert "mesh=(1,1)" in out and "mesh=(2,2)" in out
    np.testing.assert_allclose(on_mesh, plain, rtol=1e-5)
    resumed = launch_train.main(argv(4, *mesh, "--ckpt-dir", str(tmp_path)))
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    assert np.isfinite(resumed)


def test_cuda_grid_larger_than_the_visible_cards_raises():
    """No silent fallback: a CUDA grid with more positions than cards
    raises and names ``devices=``; a CUDA device that is not there too.
    The CPU grid of any size builds."""
    if torch.cuda.is_available():
        pytest.skip("wants a machine without CUDA devices")
    with pytest.raises(ValueError, match="devices="):
        compat_make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="not available"):
        compat_make_mesh((2, 1), ("data", "model"),
                         devices=["cuda:0"] * 2)
    mesh = make_test_mesh(2, 2, pod=2)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.rows() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.unique_devices() == [CPU]
