"""Parity of the port's training substrate against the JAX package, on the
CPU: optimizers, clipping and the schedule, the synthetic data stream and
the prefetcher, and checkpointing (ports of ``tests/test_substrate.py``'s
checkpoint cases)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.models.config import ModelConfig as JaxConfig
from repro.optim import OptimizerSpec as JaxSpec
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import init_opt_state as jax_init_opt
from repro.optim import opt_update as jax_opt_update
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import DataConfig, Prefetcher, SyntheticLMStream
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (OptimizerSpec, clip_by_global_norm,
                               cosine_schedule, global_norm, init_opt_state,
                               opt_update)
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _params(rng):
    """A tree with a factored (>= 128 x 128) matrix, a stacked 3-d tensor,
    a small matrix and a vector."""
    return {"w": rng.standard_normal((160, 130)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "layers": [rng.standard_normal((3, 200, 140)).astype(np.float32),
                       rng.standard_normal((12, 9)).astype(np.float32)]}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_optimizer_updates_match_jax(kind, wd, inplace):
    """Three updates, the first with a gradient norm far above the clip
    norm: parameters and state within 1e-6 of the reference."""
    rng = np.random.default_rng(40)
    p = _params(rng)
    jspec = JaxSpec(kind=kind, lr=1e-2, weight_decay=wd)
    spec = OptimizerSpec(kind=kind, lr=1e-2, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, p)
    tp = _torch(p)
    jst, tst = jax_init_opt(jspec, jp), init_opt_state(spec, tp)
    for step in range(3):
        g = _params(rng)
        if step == 0:
            g = jax.tree.map(lambda a: a * np.float32(50), g)
        jp, jst, jm = jax_opt_update(jspec, jax.tree.map(jnp.asarray, g),
                                     jst, jp, lr=1e-2 * (step + 1))
        out = opt_update(spec, _torch(g), tst, tp, lr=1e-2 * (step + 1),
                         inplace=inplace)
        if inplace:
            assert out[0] is tp and out[1] is tst
        tp, tst, tm = out
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
    js_leaves = jax.tree.leaves(jst)
    ts_leaves = tree_leaves(tst)
    assert len(js_leaves) == len(ts_leaves)
    for a, b in zip(ts_leaves, js_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_clip_and_global_norm_match_jax():
    p = _params(np.random.default_rng(41))
    for max_norm in (1.0, 1e6):
        jc, jn = jax_clip(jax.tree.map(jnp.asarray, p), max_norm)
        tc, tn = clip_by_global_norm(_torch(p), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(float(global_norm(_torch(p))), float(jn),
                                   rtol=1e-6)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_cosine_schedule_matches_jax():
    for step in (0, 1, 49, 50, 51, 300, 5000, 9999, 10_000, 20_000):
        kw = dict(base_lr=3e-4, warmup=50, total=10_000)
        np.testing.assert_allclose(cosine_schedule(step, **kw),
                                   float(jax_cosine(step, **kw)), rtol=1e-6)


def test_compress_grads_is_declared_and_inert():
    assert OptimizerSpec().compress_grads is False
    assert OptimizerSpec(compress_grads=True).compress_grads is True


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        init_opt_state(OptimizerSpec(kind="lion"), _torch(
            _params(np.random.default_rng(0))))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

CFG_KW = dict(name="d", family="dense", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=1, d_ff=64, vocab_size=1000)


@pytest.mark.parametrize("dc", [dict(seed=0, global_batch=8, seq_len=128),
                                dict(seed=3, global_batch=6, seq_len=40,
                                     n_hosts=3, host_id=2, zipf_a=1.5,
                                     pad_frac=0.1)])
def test_data_batches_equal_the_reference_bit_for_bit(dc):
    want = JaxStream(JaxConfig(**CFG_KW), JaxDataConfig(**dc))
    got = SyntheticLMStream(ModelConfig(**CFG_KW), DataConfig(**dc))
    assert got.local_batch == want.local_batch
    for step in (0, 1, 17):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="divide"):
        SyntheticLMStream(ModelConfig(**CFG_KW),
                          DataConfig(global_batch=5, n_hosts=2))


def test_prefetcher_preserves_order():
    it = Prefetcher(iter(range(20)), depth=3)
    assert list(it) == list(range(20))


# ---------------------------------------------------------------------------
# checkpointing (the cases of tests/test_substrate.py)
# ---------------------------------------------------------------------------


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "layers": [torch.randn((4,), generator=g),
                                  torch.randn((2, 2), generator=g).to(
                                      torch.bfloat16)]},
            "step": torch.tensor(17, dtype=torch.int32)}


def _like(tree):
    return tree_map(torch.empty_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), tree, 17, shard_groups=3)
    assert latest_step(str(tmp_path)) == 17
    assert len([f for f in os.listdir(tmp_path / "step_000000017")
                if f.endswith(".npz")]) == 3
    restored, step = restore_checkpoint(str(tmp_path), _like(tree))
    assert step == 17
    for (ka, a), (kb, b) in zip(tree_paths(tree), tree_paths(restored)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_restores_onto_a_given_device(tmp_path):
    tree = _tree(1)
    save_checkpoint(str(tmp_path), tree, 2)
    restored, _ = restore_checkpoint(str(tmp_path), _like(tree),
                                     device=torch.device("cpu"))
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))
    assert restored["params"]["layers"][1].dtype == torch.bfloat16


def test_checkpoint_corruption_detected(tmp_path):
    tree = _tree(1)
    path = save_checkpoint(str(tmp_path), tree, 1)
    shard = [f for f in os.listdir(path) if f.endswith(".npz")][0]
    with open(os.path.join(path, shard), "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), _like(tree))


def test_checkpoint_missing_leaf_raises(tmp_path):
    tree = _tree(3)
    save_checkpoint(str(tmp_path), tree, 1)
    like = _like(tree)
    like["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), like)


def test_checkpoint_atomicity_keeps_previous(tmp_path):
    """A newer incomplete write never shadows the last complete step."""
    t1 = _tree(2)
    save_checkpoint(str(tmp_path), t1, 1)
    os.makedirs(tmp_path / "step_000000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    _, step = restore_checkpoint(str(tmp_path), _like(t1))
    assert step == 1


def test_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _tree(3)
    for s in (1, 2, 3):
        ck.save(tree, s)
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000002", "step_000000003"]


def test_async_checkpointer_snapshots_before_in_place_updates(tmp_path):
    """The fused step updates its state in place right after a save: the
    checkpoint must hold the values at the save."""
    ck = AsyncCheckpointer(str(tmp_path))
    tree = _tree(4)
    want = tree_map(torch.clone, tree)
    ck.save(tree, 1)
    tree["params"]["w"].add_(1.0)
    ck.wait()
    restored, _ = restore_checkpoint(str(tmp_path), _like(tree))
    assert torch.equal(restored["params"]["w"], want["params"]["w"])


def test_async_checkpointer_gc_keep_zero_deletes_all(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=0)
    tree = _tree(5)
    for s in (1, 2):
        ck.save(tree, s)
    ck.wait()
    assert [d for d in os.listdir(tmp_path) if d.startswith("step_")] == []


def test_async_checkpointer_gc_retains_all_when_under_keep(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    tree = _tree(7)
    for s in (1, 2):
        ck.save(tree, s)
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000001", "step_000000002"]


def test_latest_step_falls_back_to_scanning_step_dirs(tmp_path):
    tree = _tree(6)
    save_checkpoint(str(tmp_path), tree, 3)
    save_checkpoint(str(tmp_path), tree, 7)
    (tmp_path / "LATEST").write_text("")            # crashed mid-write
    assert latest_step(str(tmp_path)) == 7
    (tmp_path / "LATEST").write_text("not-a-step")  # corrupt
    assert latest_step(str(tmp_path)) == 7
    _, step = restore_checkpoint(str(tmp_path), _like(tree))
    assert step == 7
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "LATEST").write_text("")
    assert latest_step(str(empty)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(empty), _like(tree))
