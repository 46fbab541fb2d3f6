"""The training and serving meshes' model axis beyond attention and MLPs,
on the CPU (every grid position is the CPU): the expert products split by
``experts`` (or by ``d_ff`` where the experts do not divide), the
embedding and the cross-entropy by ``vocab``, the Mamba-2 mixers by head
(``ssm_inner``) and whisper's cross-attention by head (``heads_flat``),
each where its leaf's spec puts ``model`` on that axis
(``partition.model_axis_dim``).

* Training, fp32, at TP=2, DP=2 and TP=2 x DP=2: the loss and every
  gradient leaf within 1e-5 of max|g| of the port's meshless step and of
  ``jax.grad`` of the JAX package's ``loss_fn``, on the JAX package's
  weights (``weights.from_jax_numpy``) and the same synthetic batch, for
  qwen2-moe, mixtral, mamba2, zamba2, qwen2 (a tied table: its gradient
  sums the embedding's and the unembedding's uses on each shard) and
  whisper.
* The splits that run, and those that do not: qwen2-moe smoke's 8
  experts on a 1 x 3 grid fall to the ``d_ff`` split (96 / 3); its
  vocabulary of 512 and whisper's 4 heads run whole on the lead there.
* The gated norm: each head shard's Σ y² is added before the rsqrt; a
  norm over a shard's own heads misses by more than 1e-3.
* The SSD scan runs once a shard, at the shard's heads: micro-batches x
  layers x 2 (remat) x tp calls.
* Serving (the streams themselves are held in ``tests/test_torch_mesh.py``
  against the meshless engine and the JAX package's mesh): the lead keeps
  no expert and no table once they are split, and each position holds
  the specs' expert bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.data import to_device
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers, moe, ssm, transformer
from repro_torch.models.layers import apply_norm, dense
from repro_torch.parallel import DEFAULT_RULES, ShardingRules
from repro_torch.parallel.partition import (gather_tree, model_axis_dim,
                                            place_state, spec_bytes)
from repro_torch.serve import PagedEngine
from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
from repro_torch.train import compute_grads, compute_grads_mesh
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_numpy

CPU = torch.device("cpu")
TOL = 1e-5                         # of max|g|
SHAPES = [(1, 2), (2, 1), (2, 2)]  # (data, model)
# arch, sequence length (tests/test_torch_train_families.py's: the MoE
# rows drop tokens, the SSM lengths are not a multiple of the chunk,
# whisper has more frames than decoder tokens)
ARCHS = [("qwen2-moe-a2.7b", 80), ("mixtral-8x7b", 80), ("mamba2-370m", 40),
         ("zamba2-1.2b", 40), ("qwen2-1.5b", 32), ("whisper-base", 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of tiny ops: one intra-op thread each, as in
    ``tests/test_torch_train_mesh.py``; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(arch),
                                compute_dtype="float32"))


@pytest.fixture(scope="module")
def reference():
    """By arch: ``(cfg, port params, batch, JAX total loss, JAX gradients
    in the port's layout, the port's meshless gradients and loss)``."""
    made = {}

    def get(arch, seq):
        if arch not in made:
            jcfg, cfg = _configs(arch)
            pj = jax_init_params(jcfg, jax.random.PRNGKey(0))
            batch = JaxStream(jcfg, JaxDataConfig(
                seed=0, global_batch=4, seq_len=seq, pad_frac=0.1)).batch(0)
            (jtotal, _), jg = jax.jit(jax.value_and_grad(
                lambda p: jax_loss_fn(jcfg, p,
                                      jax.tree.map(jnp.asarray, batch)),
                has_aux=True))(pj)
            params = from_jax_numpy(_np(pj), cfg, CPU)
            batch = to_device(batch, CPU)
            grads, loss, _ = compute_grads(cfg, params, batch)
            made[arch] = (cfg, params, batch, float(jtotal),
                          tree_leaves(from_jax_numpy(_np(jg), cfg, CPU)),
                          tree_leaves(grads), float(loss))
        return made[arch]
    return get


def _mesh_grads(cfg, params, batch, shape):
    mesh = make_test_mesh(*shape)
    placed = place_state({"params": params}, mesh)["params"]
    grads, loss, _ = compute_grads_mesh(cfg, placed, batch, mesh)
    return tree_leaves(gather_tree(grads)), float(loss)


def _worst(got, want) -> float:
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


# ---------------------------------------------------------------------------
# training: every split against the meshless step and jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"dp{s[0]}-tp{s[1]}")
@pytest.mark.parametrize("arch,seq", ARCHS, ids=[a for a, _ in ARCHS])
def test_mesh_gradients_match_meshless_and_jax(reference, arch, seq, shape):
    cfg, params, batch, jtotal, jgrads, grads, loss = reference(arch, seq)
    got, mloss = _mesh_grads(cfg, params, batch, shape)
    np.testing.assert_allclose(loss, jtotal, rtol=1e-6)
    np.testing.assert_allclose(mloss, loss, rtol=1e-6)
    np.testing.assert_allclose(mloss, jtotal, rtol=1e-6)
    assert len(got) == len(grads) == len(jgrads)
    assert _worst(got, grads) <= TOL
    assert _worst(got, jgrads) <= TOL


def _shards_seen(monkeypatch):
    """Record the splits ``_tp_shards``/``_vocab_shards`` hand out."""
    seen = {"moe": set(), "ssm": set(), "cross": set(), "vocab": set()}
    real_tp, real_vocab = transformer._tp_shards, transformer._vocab_shards

    def tp(cfg, p, devices):
        out = real_tp(cfg, p, devices)
        if "moe_tp" in out:
            axis, shards = out["moe_tp"]
            seen["moe"].add((axis, tuple(tuple(s["gate"].shape)
                                         for s, _ in shards)))
        if "ssm_tp" in out:
            seen["ssm"].add(tuple(s["A_log"].shape[0]
                                  for s, _ in out["ssm_tp"]))
        if "cross_tp" in out:
            seen["cross"].add(tuple(c.n_heads for c, _, _ in
                                    out["cross_tp"]))
        return out

    def vocab(p, devices):
        out = real_vocab(p, devices)
        if out is not None:
            seen["vocab"].add(tuple((rows["table"].shape[0], lo)
                                    for rows, lo, _ in out))
        return out
    monkeypatch.setattr(transformer, "_tp_shards", tp)
    monkeypatch.setattr(transformer, "_vocab_shards", vocab)
    return seen


@pytest.mark.parametrize("arch,seq,want", [
    ("qwen2-moe-a2.7b", 80, {"moe": {("experts", ((4, 64, 96),) * 2)},
                             "vocab": {((256, 0), (256, 256))}}),
    ("mixtral-8x7b", 80, {"moe": {("experts", ((2, 64, 96),) * 2)},
                          "vocab": {((256, 0), (256, 256))}}),
    ("mamba2-370m", 40, {"ssm": {(4, 4)},
                         "vocab": {((256, 0), (256, 256))}}),
    ("zamba2-1.2b", 40, {"ssm": {(4, 4)},
                         "vocab": {((256, 0), (256, 256))}}),
    ("whisper-base", 48, {"cross": {(2, 2)},
                          "vocab": {((256, 0), (256, 256))}}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_specs_split_each_part_at_tp2(reference, monkeypatch, arch, seq,
                                         want):
    """At TP=2 each part runs on its shards: 4 / 2 experts a position, 4 of
    8 SSM heads, 2 of 4 cross-attention heads, 256 vocabulary rows."""
    cfg, params, batch, *_ = reference(arch, seq)
    seen = _shards_seen(monkeypatch)
    _mesh_grads(cfg, params, batch, (1, 2))
    assert {k: v for k, v in seen.items() if v} == want


def test_non_dividing_tp_falls_to_d_ff_or_runs_whole(reference, monkeypatch):
    """A 1 x 3 grid: qwen2-moe smoke's 8 experts do not divide, so its
    experts split by ``d_ff`` (96 / 3, the partial ``down`` outputs summed
    in shard order), and its vocabulary of 512 runs whole on the lead;
    whisper's 4 heads run whole too.  Both within 1e-5 of max|g| of the
    meshless step and of ``jax.grad``."""
    for arch, seq, want in [
            ("qwen2-moe-a2.7b", 80, {"moe": {("d_ff", ((8, 64, 32),) * 3)}}),
            ("whisper-base", 48, {})]:
        cfg, params, batch, jtotal, jgrads, grads, loss = reference(arch,
                                                                    seq)
        assert model_axis_dim(("embed", "table"),
                              params["embed"]["table"].shape, 3) is None
        seen = _shards_seen(monkeypatch)
        got, mloss = _mesh_grads(cfg, params, batch, (1, 3))
        assert {k: v for k, v in seen.items() if v} == want, arch
        np.testing.assert_allclose(mloss, jtotal, rtol=1e-6)
        assert _worst(got, grads) <= TOL
        assert _worst(got, jgrads) <= TOL


def test_a_split_the_heads_do_not_divide_raises():
    """No fallback: where the specs split a mixer over 3 positions but its
    2 heads do not divide, the split raises instead of running whole
    (d_inner 96 and ``in_proj``'s 2·96 + 2·17 + 2 = 228 columns divide)."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), d_model=48,
                              ssm_head_dim=48, ssm_state=17)
    assert (cfg.ssm_d_inner, cfg.ssm_n_heads) == (96, 2)
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, CPU)
    assert model_axis_dim(("mixer", "in_proj", "w"),
                          p["in_proj"]["w"].shape, 3) == 1
    assert model_axis_dim(("mixer", "out_proj", "w"),
                          p["out_proj"]["w"].shape, 3) == 0
    with pytest.raises(ValueError, match="do not split"):
        ssm.ssm_head_split(cfg, p, 3)


# ---------------------------------------------------------------------------
# the SSM head split: the shared gated norm and the scan's calls
# ---------------------------------------------------------------------------


def _mixer(seed=0):
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"),
                              compute_dtype="float32")
    g = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba2(g, cfg, CPU)
    # the reference draws ones; a trained scale differs per channel
    p["norm"]["scale"] = 0.5 + torch.rand(p["norm"]["scale"].shape,
                                          generator=g)
    x = torch.randn((2, 40, cfg.d_model), generator=g)
    return cfg, p, x


def test_head_split_shares_the_gated_norm_a_per_shard_norm_misses():
    """TP=2: the mixer's output within 1e-5 of the whole mixer's.  A norm
    over each shard's own heads (its own Σ y² over its half of
    ``d_inner``) is another function: it misses by more than 1e-3 of
    max|out|."""
    cfg, p, x = _mixer()
    want, _ = ssm.apply_mamba2(cfg, p, x)
    shards = [(ssm.split_mamba2(cfg, p, 2, i), CPU) for i in range(2)]
    got = ssm.apply_mamba2_tp(cfg, shards, x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale

    per_shard = None
    for p_s, _ in shards:
        g, _, _ = ssm._mixer_core(cfg, p_s, x, di=cfg.ssm_d_inner // 2,
                                  H=cfg.ssm_n_heads // 2, cache=None,
                                  valid_len=None, impl="ref")
        part = dense(p_s["out_proj"], apply_norm(cfg, p_s["norm"], g),
                     torch.float32)
        per_shard = part if per_shard is None else per_shard + part
    assert float((per_shard - want).abs().max()) > 1e-3 * scale


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_ssd_scan_runs_once_a_shard_at_its_heads(reference, monkeypatch, tp):
    """mamba2 smoke (3 layers, 8 heads, remat ``full``): the chunked scan
    runs micro-batches x layers x 2 (the recompute) x tp times, each at
    8 / tp heads (40 tokens, padded to 48 inside the call: a call counts
    once)."""
    cfg, params, batch, *_ = reference("mamba2-370m", 40)
    assert cfg.remat == "full" and cfg.ssm_n_heads == 8
    heads = []
    real = ssm.ssd_chunked

    def counted(xh, *a, **kw):
        if xh.shape[1] == 40:
            heads.append(xh.shape[2])
        return real(xh, *a, **kw)
    monkeypatch.setattr(ssm, "ssd_chunked", counted)
    if tp == 1:
        compute_grads(cfg, params, batch, accum=2)
    else:
        mesh = make_test_mesh(1, tp)
        placed = place_state({"params": params}, mesh)["params"]
        compute_grads_mesh(cfg, placed, batch, mesh, accum=2)
    assert heads == [cfg.ssm_n_heads // tp] * (2 * cfg.n_layers * 2 * tp)


# ---------------------------------------------------------------------------
# the vocab-parallel embedding and cross-entropy
# ---------------------------------------------------------------------------


def test_vocab_shards_embed_and_nll_match_whole_with_padding():
    """A padded vocabulary (500 of 512, the padding on the last shard) and
    gemma3's ``embed_scale``: the embedding, the logits and each token's
    NLL of 4 vocab shards against the whole table's, and the gradient of
    the tied table (both uses summed) within 1e-5."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), vocab_size=500,
                              compute_dtype="float32")
    assert cfg.padded_vocab == 512 and cfg.embed_scale
    g = torch.Generator().manual_seed(0)
    table = layers.init_embedding(g, cfg, CPU)["table"]
    tokens = torch.randint(0, 500, (2, 24), generator=g)
    labels = torch.randint(0, 500, (2, 24), generator=g)

    def run(split):
        t = table.clone().requires_grad_()
        p = {"table": t}
        vocab = (transformer._vocab_shards(p, [CPU] * 4) if split else None)
        x = transformer._embed(cfg, {"embed": p}, tokens, vocab)
        h = torch.tanh(x)
        logits = transformer._logits(cfg, {"embed": p}, h, vocab)
        nll = (transformer._nll_tp(cfg, vocab, h, labels) if split
               else transformer._nll(cfg, logits.clone(), labels))
        nll.sum().backward()
        return x.detach(), logits.detach(), nll.detach(), t.grad

    whole, split = run(False), run(True)
    assert torch.equal(split[0], whole[0])
    for a, b in zip(split[1:], whole[1:]):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max())


# ---------------------------------------------------------------------------
# serving: where the experts and tables live
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_serving_lead_holds_no_expert_and_positions_the_specs_bytes(arch, tp,
                                                                   dp):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     CPU)
    mesh = build_serve_mesh(MeshSpec(tp=tp, dp=dp), device="cpu")
    eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                      num_pages=26, prefill_chunk=16, mesh=mesh,
                      device="cpu")
    experts = {"layers": [{"moe": {k: p["moe"][k] for k in moe.EXPERT_KEYS}}
                          for p in params["layers"]]}
    row_mesh = build_serve_mesh(MeshSpec(tp=tp, dp=1), device="cpu")
    want = spec_bytes(experts, ShardingRules(row_mesh, dict(DEFAULT_RULES)))
    n_moe = len(params["layers"])
    for row in eng.rows:
        for p in row.params["layers"]:
            assert not set(moe.EXPERT_KEYS) & set(p["moe"])
            assert "router" in p["moe"]
        assert row.params["embed"] == {}
        assert sorted(row.split.experts) == list(range(n_moe))
        per_position = [0] * tp
        for axis, shards in row.split.experts.values():
            assert axis == "experts"
            for i, (p_s, dev) in enumerate(shards):
                assert dev == row.devices[i]
                per_position[i] += sum(t.numel() * t.element_size()
                                       for t in p_s.values())
        assert per_position == [want] * tp
        assert [(r["table"].shape[0], lo) for r, lo, _ in row.split.vocab] \
            == [(cfg.padded_vocab // tp, i * cfg.padded_vocab // tp)
                for i in range(tp)]
    # the caller's parameters keep every weight
    assert all(set(moe.EXPERT_KEYS) <= set(p["moe"])
               for p in params["layers"])
