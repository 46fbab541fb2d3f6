"""llama3-405b's own dtypes in the port, against the JAX package on the
CPU: float8 e4m3 KV caches (``kv_cache_dtype="float8_e4m3fn"``) in both
engines and on the serving mesh, and bf16 parameters (the smoke config's
own ``param_dtype``) in the fused step, on a training mesh and in the
HyPar trainer.

Inputs come from numpy seeds; weights go through ``weights.from_jax_numpy``
(bf16 leaves carried as their values, exact), float8 pools as their raw
bytes.

* The KV cast (``repro_torch.dtypes.cast_kv``) equals JAX's
  ``astype(float8_e4m3fn)`` bit for bit, from fp32 and from bf16,
  overflow and ±inf to NaN included; torch's own cast saturates there.
* The plain paged version on e4m3 pools equals the reference's oracle at
  2e-6.
* Serving: logits within 1e-4 of the logit scale of the JAX package's,
  greedy streams equal, pools one byte an element, the mesh's streams
  equal to no mesh.
* Training with bf16 parameters at fp32 compute: loss within 1e-5,
  parameters within one bf16 spacing of |p|, optimizer state within 1e-5
  of its leaf's scale, and the reference's dtypes (bf16 gradients at one
  micro-batch, fp32 sums at two, fp32 state).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro.models.transformer import init_params as jax_init
from repro.serve import Engine as JaxEngine
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.dtypes import cast_kv
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import paged_decode_attention_ref
from repro_torch.serve import Engine, PagedEngine, ServeScheduler
from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
from repro_torch.weights import from_jax_numpy

ARCH = "llama3-405b"
F8 = torch.float8_e4m3fn
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# of max|logit|: fp32 compute; in bf16 the two frameworks round at other
# places (llama3 smoke's paged prefill logits differ by 7.5e-3 of their
# scale with a bf16 cache, 1.5e-2 with an e4m3 one, where a rounding
# difference crosses an e4m3 boundary): four bf16 spacings there
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 4 * 2.0 ** -7}


def _f8_torch(x_np_f8: np.ndarray) -> torch.Tensor:
    """A numpy (ml_dtypes) float8 array as a torch float8 tensor, the same
    bytes."""
    return torch.from_numpy(np.ascontiguousarray(x_np_f8).view(
        np.uint8)).view(F8)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# (a) the cast
# ---------------------------------------------------------------------------

# ±448 (the largest), 449 and 464 (round to 448; 464 the tie to even),
# 465, 480, 500 and 1e4 (past it: NaN), ±inf, NaN of both signs, the
# subnormals (2^-9 the least, 2^-10 its half: the tie to 0) and their
# ties, normal ties (1.0625 between 1 and 1.125, 3.3, -17.5), zero and -0
SWEEP = np.array(
    [448, -448, 449, -449, 464, -464, 465, -465, 480, 500, -500, 1e4, -1e4,
     np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 2.0 ** -9, -(2.0 ** -9),
     2.0 ** -10, 3 * 2.0 ** -10, 3 * 2.0 ** -11, 5 * 2.0 ** -11,
     2.0 ** -6, 2.0 ** -7 * 1.0625, 0.0137, 1.0625, 1.1875, 3.3, -17.5,
     240, 232, 248, 1e-12, -1e-12], np.float32)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_kv_cast_equals_jax_bit_for_bit(src):
    """The sweep plus 4,096 random values over the whole range, from fp32
    and from bf16: the port's cast gives JAX's bytes, where torch's own
    cast does not (it saturates 500 and +inf to 448)."""
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(4096) * np.exp2(
        rng.integers(-14, 11, 4096))).astype(np.float32)
    x = np.concatenate([SWEEP, wide])
    if src == "bfloat16":     # one set of bf16 words for both sides
        x = x.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    np.testing.assert_array_equal(_bits(cast_kv(tx, F8)), want)
    own = _bits(tx.to(F8))
    assert (own != want).any()          # torch's own cast differs
    # other dtypes are a plain cast
    assert torch.equal(cast_kv(tx, torch.bfloat16).view(torch.int16),
                       tx.to(torch.bfloat16).view(torch.int16))
    assert cast_kv(cast_kv(tx, F8), F8).dtype == F8


def test_kv_cast_works_on_meta():
    """The dry-run traces the cast on the meta device."""
    out = cast_kv(torch.empty((2, 3), device="meta"), F8)
    assert out.is_meta and out.dtype == F8 and out.shape == (2, 3)


# ---------------------------------------------------------------------------
# (b) the plain paged version on e4m3 pools
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_plain_version_on_e4m3_pools_matches_jax(qdt, window):
    """The port's gather oracle on e4m3 pools (the trash page NaN), kt and
    vt against the reference's ``paged_decode_attention_ref``, at 2e-6."""
    rng = np.random.default_rng(1)
    B, KV, G, D, ps, n = 3, 2, 4, 64, 8, 4
    P = 1 + B * n
    pools = [rng.standard_normal((P, KV, ps, D)).astype(np.float32)
             for _ in range(2)]
    for p in pools:
        p[0] = np.nan
    pages = np.arange(1, 1 + B * n, dtype=np.int32).reshape(B, n)
    pages[2, 3] = 0                        # a trash tail
    kv_len = np.array([30, 9, 27], np.int32)
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kt, vt = (rng.standard_normal((B, KV, 1, D)).astype(np.float32)
              for _ in range(2))
    f8 = [np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))
          for a in pools + [kt, vt]]
    jq = jnp.asarray(q).astype(getattr(jnp, qdt))
    want = jax_paged_ref(jq, *map(jnp.asarray, f8[:2]), jnp.asarray(pages),
                         jnp.asarray(kv_len), *map(jnp.asarray, f8[2:]),
                         window=window)
    tq = torch.from_numpy(q).to(getattr(torch, qdt))
    got = paged_decode_attention_ref(
        tq, *map(_f8_torch, f8[:2]), torch.from_numpy(pages),
        torch.from_numpy(kv_len), *map(_f8_torch, f8[2:]), window=window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-6, rtol=2e-6)


def test_paged_binding_refuses_unbuilt_mixes_before_a_launch():
    """On meta tensors (no build, no card) the binding takes q bf16 or
    fp32 over pools of its dtype or e4m3, kt in the pools' dtype, and
    refuses every other mix; ``cost()`` counts one byte an e4m3 pool
    element."""
    meta = "meta"

    def call(q_dt, k_dt, v_dt, kt_dt):
        q = torch.empty((2, 1, 4, 64), dtype=q_dt, device=meta)
        kp = torch.empty((3, 2, 8, 64), dtype=k_dt, device=meta)
        vp = torch.empty((3, 2, 8, 64), dtype=v_dt, device=meta)
        kt = torch.empty((2, 2, 1, 64), dtype=kt_dt, device=meta)
        vt = torch.empty((2, 2, 1, 64), dtype=kt_dt, device=meta)
        tbl = torch.empty((2, 1), dtype=torch.int32, device=meta)
        kl = torch.empty((2,), dtype=torch.int32, device=meta)
        return pa_kernel.paged_decode_kernel(q, kp, vp, tbl, kl, kt, vt,
                                             scale=0.125)

    bf, f32 = torch.bfloat16, torch.float32
    for q_dt in (bf, f32):
        assert call(q_dt, F8, F8, F8).dtype == q_dt
        assert call(q_dt, q_dt, q_dt, q_dt).dtype == q_dt
    for mix in [(f32, bf, bf, bf), (bf, f32, f32, f32),
                (torch.float16, F8, F8, F8), (bf, F8, bf, F8),
                (bf, torch.float8_e5m2, torch.float8_e5m2,
                 torch.float8_e5m2), (bf, F8, F8, bf)]:
        with pytest.raises(TypeError):
            call(*mix)
    tbl = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    kl = torch.tensor([64, 30], dtype=torch.int32)
    shape = dict(B=2, KV=2, G=4, D=128, ps=16, window=None, elt=2)
    two, one = (pa_kernel.cost(tbl, kl, **shape),
                pa_kernel.cost(tbl, kl, kv_elt=1, **shape))
    assert two == pa_kernel.cost(tbl, kl, kv_elt=2, **shape)
    assert two["bytes"] - one["bytes"] == 2 * 6 * 2 * 16 * 128
    assert two["flops"] == one["flops"]


# ---------------------------------------------------------------------------
# (c) serving with e4m3 caches
# ---------------------------------------------------------------------------


def _models(compute_dtype):
    kw = dict(compute_dtype=compute_dtype, kv_cache_dtype="float8_e4m3fn")
    jc = dataclasses.replace(jax_smoke(ARCH), **kw)
    tc = dataclasses.replace(get_smoke_config(ARCH), **kw)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, CPU)


@pytest.fixture(scope="module")
def serve_models():
    made = {}

    def get(compute_dtype):
        if compute_dtype not in made:
            made[compute_dtype] = _models(compute_dtype)
        return made[compute_dtype]
    return get


def _close_logits(got: torch.Tensor, want, compute_dtype) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=LOGIT_TOL[compute_dtype], rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_paged_engine_on_e4m3_pools_matches_jax(serve_models, compute_dtype):
    """A two-chunk prefill (a full chunk and a padded partial bucket) and
    decode steps of the paged engine over e4m3 pools: logits within 1e-4
    of the logit scale of the JAX package's, the same pool bytes, one
    byte an element."""
    jc, tc, jp, tp = serve_models(compute_dtype)
    kw = dict(batch=2, max_len=32, page_size=8, prefill_chunk=16)
    je = JaxPagedEngine(jc, jp, attn_impl="ref", **kw)
    te = PagedEngine(tc, tp, device="cpu", **kw)
    te.ensure_batch()
    (row,) = te.rows
    (shard,) = row.shards
    assert shard.k.dtype == shard.v.dtype == F8
    assert te.total_pool_bytes() == shard.k.numel() + shard.v.numel()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jc.vocab_size - 1, (21,)).astype(np.int32)
    ids = [1, 2, 3, 4]
    lj, lt = je.insert(0, prompt, page_ids=ids), te.insert(0, prompt,
                                                            page_ids=ids)
    _close_logits(lt, lj, compute_dtype)
    toks = np.zeros((2, 1), np.int32)
    for _ in range(5):
        toks[0, 0] = int(np.argmax(np.asarray(
            jnp.asarray(lj).astype(jnp.float32))[0, -1]))
        live = np.array([True, False])
        lj = je.decode(jnp.asarray(toks), live_mask=live)
        lt = te.decode(toks, live_mask=live)
        _close_logits(lt[:1], np.asarray(jnp.asarray(lj)[:1]), compute_dtype)
    if compute_dtype == "float32":     # the slot's pages hold JAX's bytes
        jpool = np.asarray(je.cache["groups"][0]["self"]["k"]).view(np.uint8)
        np.testing.assert_array_equal(_bits(shard.k)[:, 1:5], jpool[:, 1:5])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_engine_on_e4m3_cache_matches_jax(serve_models, compute_dtype):
    """The dense engine's batched prefill, insert and decode over e4m3
    buffers against the JAX package's."""
    jc, tc, jp, tp = serve_models(compute_dtype)
    rng = np.random.default_rng(6)
    batch = rng.integers(0, jc.vocab_size - 1, (2, 9)).astype(np.int32)
    jd = JaxEngine(jc, jp, batch=2, max_len=32)
    td = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    _close_logits(td.prefill(batch), jd.prefill(jnp.asarray(batch)),
                  compute_dtype)
    assert td.cache["k"].dtype == F8
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = batch[0, :1].repeat(11)
    _close_logits(td.insert(1, padded, true_len=11),
                  jd.insert(1, jnp.asarray(padded), true_len=11),
                  compute_dtype)
    for _ in range(3):
        _close_logits(td.decode(batch[:, :1]),
                      jd.decode(jnp.asarray(batch[:, :1])), compute_dtype)


def _trace(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, (n,)).astype(np.int32) for n in lens]


LENS = (5, 40, 12, 23, 33, 9)


def _drain(sched, prompts, max_new=8):
    rids = [sched.submit(p, max_new=max_new) for p in prompts]
    assert all(r is not None for r in rids)
    return {r.rid: r.tokens for r in sched.run()}


def test_scheduler_streams_on_e4m3_pools_match_jax(serve_models):
    """Six requests through the scheduler (fp32 compute, e4m3 pools): the
    greedy streams equal the JAX package's."""
    jc, tc, jp, tp = serve_models("float32")
    kw = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)
    prompts = _trace(3, jc.vocab_size, LENS)
    want = _drain(JaxServeScheduler(JaxPagedEngine(jc, jp, attn_impl="ref",
                                                   **kw)), prompts)
    got = _drain(ServeScheduler(PagedEngine(tc, tp, device="cpu", **kw)),
                 prompts)
    assert got == want
    assert all(len(t) == 8 for t in got.values())


@pytest.mark.parametrize("tp_dp", [(2, 1), (1, 2), (2, 2)],
                         ids=["tp2", "dp2", "tp2_dp2"])
def test_serving_mesh_holds_e4m3_pools(serve_models, tp_dp):
    """The serving mesh at TP=2, DP=2 and TP=2 x DP=2 holds e4m3 pools
    (each position a byte an element of its heads' share) and serves the
    streams of no mesh."""
    _, tc, _, tp = serve_models("float32")
    kw = dict(batch=4, max_len=64, page_size=8, prefill_chunk=16)
    prompts = _trace(4, tc.vocab_size, LENS)
    plain = PagedEngine(tc, tp, device="cpu", **kw)
    want = _drain(ServeScheduler(plain), prompts)
    mesh = build_serve_mesh(MeshSpec(*tp_dp), device="cpu")
    eng = PagedEngine(tc, tp, device="cpu", mesh=mesh, **kw)
    eng.ensure_batch()
    for row in eng.rows:
        for sh in row.shards:
            assert sh.k.dtype == sh.v.dtype == F8
    assert eng.per_device_pool_bytes() * tp_dp[0] * tp_dp[1] == \
        eng.total_pool_bytes()
    assert _drain(ServeScheduler(eng, device_groups=tp_dp[1]),
                  prompts) == want


# ---------------------------------------------------------------------------
# (d) bf16 parameters in the fused step, on a mesh and in the HyPar trainer
# ---------------------------------------------------------------------------

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMStream as JaxStream  # noqa: E402
from repro.optim import OptimizerSpec as JaxSpec  # noqa: E402
from repro.train import TrainState as JaxTrainState  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.data import to_device  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.optim import OptimizerSpec, init_opt_state  # noqa: E402
from repro_torch.train import (TrainState, compute_grads,  # noqa: E402
                               make_train_step, shard_state)
from repro_torch.tree import (tree_leaves, tree_leaves_like,  # noqa: E402
                              tree_paths)
from repro_torch.weights import train_state_from_jax_numpy  # noqa: E402

TRAIN_KW = dict(compute_dtype="float32")      # param_dtype: the smoke's bf16
LR = 1e-3
OPTS = ("adamw", "adafactor")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _jax_start(opt: str):
    """The reference's llama3 smoke config, optimizer spec and initial
    state for ``opt``."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **TRAIN_KW)
    jspec = JaxSpec(kind=opt, lr=LR)
    return jcfg, jspec, JaxTrainState.create(jcfg, jspec,
                                             jax.random.PRNGKey(1))


@functools.cache
def _jax_step(opt: str, accum: int):
    """The reference's jitted fused step, compiled once for the module."""
    jcfg, jspec, _ = _jax_start(opt)
    return jax.jit(jax_make_train_step(jcfg, jspec, grad_accum=accum))


@pytest.fixture(scope="module")
def train_ref():
    """The reference's state, one batch, and its fused step's result for
    each optimizer at grad_accum 1 and 2."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **TRAIN_KW)
    assert jcfg.param_dtype == "bfloat16"
    batch = JaxStream(jcfg, JaxDataConfig(global_batch=4,
                                          seq_len=32)).batch(0)
    out = {"batch": batch}
    for opt in OPTS:
        _, _, state = _jax_start(opt)
        out[opt, "init"] = _np({"params": state.params,
                                "opt_state": state.opt_state,
                                "step": state.step})
        for accum in (1, 2):
            step = _jax_step(opt, accum)
            new, m = step(state, jax.tree.map(jnp.asarray, batch))
            out[opt, accum] = (_np({"params": new.params,
                                    "opt_state": new.opt_state,
                                    "step": new.step}),
                               float(m["loss_total"]))
    return out


def _tcfg():
    return dataclasses.replace(get_smoke_config(ARCH), **TRAIN_KW)


def _bf16_spacing(w: torch.Tensor) -> torch.Tensor:
    """One bf16 spacing at |w| (the smallest normal's below it)."""
    a = w.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _grad_slack(cfg, params, batch, accum, pieces=None) -> tuple:
    """``(|g|, slack)`` a leaf: the port's step gradient, and how far
    another run's may be from it.  Each framework (and each data row of a
    mesh) rounds its gradient of each of ``pieces`` equal parts of the
    batch (default: the micro-batches) to bf16 from fp32 sums taken in
    other orders, so where one lies near a rounding boundary the two round
    apart: one bf16 spacing of each part's gradient, over the micro-batch
    count, twice (at one micro-batch the global-norm clip rounds to bf16
    once more)."""
    pieces = pieces or accum
    g, _, _ = compute_grads(cfg, params, batch, accum=accum)
    B = next(iter(batch.values())).shape[0] // pieces
    slack = None
    for i in range(pieces):
        mb = {k: v[i * B:(i + 1) * B] for k, v in batch.items()}
        gi, _, _ = compute_grads(cfg, params, mb)
        sp = [2 * _bf16_spacing(t) / accum for t in tree_leaves(gi)]
        slack = sp if slack is None else [a + b for a, b in zip(slack, sp)]
    return [t.float().abs() for t in tree_leaves(g)], slack


def _state_slack(kind: str, key: str, g, s, spec) -> torch.Tensor:
    """How far a moment after the first step may move for a gradient
    that moves by ``s`` at ``|g|`` (β₂ is 0 at Adafactor's first step)."""
    sq = 2 * g * s + s * s                  # |Δ(g²)|
    if kind == "adamw":
        return (1 - spec.b1) * s if key == "m" else (1 - spec.b2) * sq
    if key == "v":
        return sq
    return sq.mean(dim=-1) if key == "vr" else sq.mean(dim=-2)


def _step_slack(st: dict | None, g, s) -> torch.Tensor:
    """How far the first step's direction may move for a gradient that
    moves by ``s`` at ``|g|``: AdamW's and an unfactored Adafactor
    leaf's is the gradient's sign (``g / (|g| + eps)``, ``g / sqrt(g²)``),
    which flips only where ``|g| <= s``; a factored leaf's is ``g`` times
    its row and column factors (read from the reference's ``vr``, ``vc``),
    which hardly move."""
    if st is not None and "vr" in st:
        vr, vc = st["vr"], st["vc"]
        fac = (torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True) + 1e-30)
               [..., None] * torch.rsqrt(vc + 1e-30)[..., None, :])
        return 1.01 * s * fac
    return 2.0 * (g <= s)


def _check_state(state, want, init_params, slack, spec, loss, want_loss):
    """Loss within 1e-5.  Each bf16 parameter within one bf16 spacing of
    the reference's, plus ``lr`` times what the gradients' bf16 roundings
    may move its step by (:func:`_step_slack`), or 2^-16 of its old value
    where the update cancels it (the update's own fp32 noise).  Each fp32
    moment within 1e-5 of its leaf's scale plus what those roundings
    allow (:func:`_grad_slack`)."""
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    g_abs, g_slack = slack
    sts = (tree_leaves_like(want.opt_state["f"], want.params)
           if spec.kind == "adafactor" else [None] * len(g_abs))
    for (path, p), w, p0, st, g, s in zip(
            tree_paths(state.params), tree_leaves(want.params), init_params,
            sts, g_abs, g_slack):
        assert p.dtype == torch.bfloat16, path
        tol = torch.maximum(_bf16_spacing(w) + spec.lr * _step_slack(st, g, s),
                            p0.float().abs() * 2.0 ** -16)
        bad = (p.float() - w.float()).abs() > tol
        assert not bad.any(), (path, int(bad.sum()))
    if spec.kind == "adamw":
        pairs = [(key, i) for key in ("m", "v") for i in range(len(g_abs))]
        got = tree_leaves(state.opt_state["m"]) + tree_leaves(
            state.opt_state["v"])
        ref = tree_leaves(want.opt_state["m"]) + tree_leaves(
            want.opt_state["v"])
    else:
        per = [sorted(d) for d in tree_leaves_like(state.opt_state["f"],
                                                   state.params)]
        pairs = [(key, i) for i, keys in enumerate(per) for key in keys]
        got = tree_leaves(state.opt_state["f"])
        ref = tree_leaves(want.opt_state["f"])
    assert int(state.opt_state["count"]) == int(want.opt_state["count"])
    for (key, i), a, b in zip(pairs, got, ref):
        assert a.dtype == torch.float32
        tol = 1e-5 * float(b.abs().max()) + _state_slack(
            spec.kind, key, g_abs[i], g_slack[i], spec)
        bad = (a - b).abs() > tol
        assert not bad.any(), (key, i, int(bad.sum()))


@pytest.fixture(scope="module")
def meshless_step(train_ref):
    """:func:`_step_once` without a mesh by ``(opt, accum)``, each run
    once for the module: the fused-step and the mesh tests read the same
    steps (which nothing changes)."""
    made = {}

    def get(opt, accum):
        if (opt, accum) not in made:
            made[opt, accum] = _step_once(opt, accum, train_ref)
        return made[opt, accum]
    return get


def _step_once(opt, accum, train_ref, mesh=None):
    """The port's fused step from the reference's initial state: the new
    state, its loss, the old parameters and the gradients' slack."""
    cfg = _tcfg()
    spec = OptimizerSpec(kind=opt, lr=LR)
    state = train_state_from_jax_numpy(train_ref[opt, "init"], cfg, CPU)
    p0 = [p.clone() for p in tree_leaves(state.params)]
    batch = to_device(train_ref["batch"], CPU)
    dp = 1 if mesh is None else mesh.shape["data"]
    slack = _grad_slack(cfg, state.params, batch, accum, pieces=accum * dp)
    if mesh is not None:
        state = shard_state(state, mesh)
    state, m = make_train_step(cfg, spec, grad_accum=accum,
                               mesh=mesh)(state, batch)
    if mesh is not None:
        state = TrainState.from_tree(state.tree())
    return state, float(m["loss_total"]), p0, slack, spec


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt", OPTS)
def test_bf16_params_fused_step_matches_jax(train_ref, meshless_step, opt,
                                           accum):
    """One fused step of llama3 smoke with bf16 parameters (fp32 compute)
    under AdamW and Adafactor at grad_accum 1 and 2, against the
    reference's ``make_train_step`` (tolerances: ``_check_state``)."""
    state, loss, p0, slack, spec = meshless_step(opt, accum)
    want = train_state_from_jax_numpy(train_ref[opt, accum][0], _tcfg(),
                                      CPU)
    _check_state(state, want, p0, slack, spec, loss, train_ref[opt, accum][1])


@pytest.fixture(scope="module")
def three_steps_ref():
    """The reference's Adafactor state and 3 fused steps of it at
    grad_accum 2, one batch a step: the state before each step and
    after the last, and each step's loss."""
    jcfg, _, state = _jax_start("adafactor")
    stream = JaxStream(jcfg, JaxDataConfig(global_batch=4, seq_len=32))
    batches = [stream.batch(i) for i in range(3)]
    step = _jax_step("adafactor", 2)
    states, losses = [], []
    for b in batches:
        states.append(_np({"params": state.params,
                           "opt_state": state.opt_state, "step": state.step}))
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss_total"]))
    states.append(_np({"params": state.params, "opt_state": state.opt_state,
                       "step": state.step}))
    return batches, states, losses


def test_bf16_params_three_fused_steps_match_jax(three_steps_ref):
    """Three fused steps of llama3 smoke under its own optimizer
    (Adafactor) with bf16 parameters at grad_accum 2, one step function
    for all of them, against 3 steps of the reference's
    ``make_train_step`` from its state.  Each step of the port from the
    reference's state before it meets the reference's state after it by
    ``_check_state`` (Adafactor's ``β₂`` and step count at steps 2 and 3
    included); the port's own chain, each step from its last, keeps the
    reference's loss within ``_check_state``'s 1e-5 at every step and its
    step count.  (The chain's parameters are not held leaf by leaf: one
    bf16 rounding apart after step 1, they drift apart by more than one
    step's slack by step 3, 440 spacings of one ``unembed`` element near
    0, while the loss stays within 2e-6.)"""
    batches, states, losses = three_steps_ref
    cfg = _tcfg()
    spec = OptimizerSpec(kind="adafactor", lr=LR)
    step = make_train_step(cfg, spec, grad_accum=2)
    chain = None
    for k, b in enumerate(batches):
        batch = to_device(b, CPU)
        state = train_state_from_jax_numpy(states[k], cfg, CPU)
        p0 = [p.clone() for p in tree_leaves(state.params)]
        slack = _grad_slack(cfg, state.params, batch, 2)
        state, m = step(state, batch)
        want = train_state_from_jax_numpy(states[k + 1], cfg, CPU)
        _check_state(state, want, p0, slack, spec, float(m["loss_total"]),
                     losses[k])
        if chain is None:
            # the chain's first step is this one: both from states[0]
            chain = state
        else:
            chain, m = step(chain, batch)
        np.testing.assert_allclose(float(m["loss_total"]), losses[k],
                                   rtol=1e-5)
    assert int(chain.opt_state["count"]) == 3 == \
        int(states[-1]["opt_state"]["count"])


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_params_keep_the_reference_dtypes(train_ref, accum):
    """bf16 gradients at one micro-batch, fp32 sums at two, folded as
    autograd gives them (no bf16 gradient is left on a leaf); the
    parameters stay bf16 and the state fp32 through the step."""
    cfg = _tcfg()
    state = train_state_from_jax_numpy(train_ref["adamw", "init"], cfg, CPU)
    batch = to_device(train_ref["batch"], CPU)
    grads, _, _ = compute_grads(cfg, state.params, batch, accum=accum)
    want = torch.bfloat16 if accum == 1 else torch.float32
    assert {g.dtype for g in tree_leaves(grads)} == {want}
    assert all(p.grad is None for p in tree_leaves(state.params))
    step = make_train_step(cfg, OptimizerSpec(kind="adafactor", lr=LR),
                           grad_accum=accum)
    st = TrainState(params=state.params, opt_state=init_opt_state(
        OptimizerSpec(kind="adafactor"), state.params))
    st, _ = step(st, batch)
    assert {p.dtype for p in tree_leaves(st.params)} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(st.opt_state["f"])} == {
        torch.float32}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)],
                         ids=["tp2", "dp2", "tp2_dp2"])
def test_bf16_params_on_a_training_mesh(train_ref, meshless_step, grid,
                                        accum):
    """The fused step on a (data, model) grid with bf16 parameters under
    Adafactor: a row's lead gathers bf16 parameters, the rows' gradients
    are summed in fp32, and the result is the meshless step's within one
    bf16 rounding of each row's gradients (``_check_state`` with the
    meshless state as the reference)."""
    base, loss, p0, _, spec = meshless_step("adafactor", accum)
    state, mloss, _, slack, _ = _step_once(
        "adafactor", accum, train_ref, mesh=make_test_mesh(*grid))
    _check_state(state, base, p0, slack, spec, mloss, loss)


def test_bf16_params_hypar_trainer_matches_jax(train_ref):
    """The HyPar trainer with bf16 parameters (one step of 2 micro-batches,
    AdamW) against the reference's: it sums the grad jobs' bf16 results
    in bf16, as the reference does (``_check_state``, the micro-batches'
    slack)."""
    from repro.core import VirtualCluster as JaxCluster
    from repro.train import HyParTrainer as JaxHyParTrainer
    from repro_torch.core import VirtualCluster
    from repro_torch.train import HyParTrainer

    jcfg = dataclasses.replace(jax_smoke(ARCH), **TRAIN_KW)
    jspec, spec = JaxSpec(kind="adamw", lr=LR), OptimizerSpec(kind="adamw",
                                                              lr=LR)
    batch = train_ref["batch"]

    def micro(b):
        return [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()}
                for i in range(2)]
    key = jax.random.PRNGKey(2)
    trainer = JaxHyParTrainer(jcfg, jspec, n_micro=2, cluster=JaxCluster(
        jax.devices()[:1], n_schedulers=1))
    jp, jo, _ = trainer.run([[jax.tree.map(jnp.asarray, mb)
                              for mb in micro(batch)]], key=key)
    want = train_state_from_jax_numpy(
        _np({"params": jp, "opt_state": jo, "step": 1}), _tcfg(), CPU)
    cfg = _tcfg()
    init = from_jax_numpy(_np(jax_init(jcfg, key)), cfg, CPU)
    p0 = [p.clone() for p in tree_leaves(init)]
    tb = to_device(batch, CPU)
    slack = _grad_slack(cfg, init, tb, 2)
    hp, ho, _ = HyParTrainer(cfg, spec, n_micro=2, cluster=VirtualCluster(
        [CPU], n_schedulers=1)).run([micro(tb)], params=init)
    got = TrainState(params=hp, opt_state=ho, step=1)
    loss = float(want.params is not None)      # the trainer reports none
    _check_state(got, want, p0, slack, spec, loss, loss)


def test_checkpoint_stores_float8_and_bf16_leaves_raw(tmp_path):
    """float8 e4m3 and bf16 leaves are stored as their raw bytes, as the
    reference stores them: a tree saved by one package restores in the
    other with the same bytes."""
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.checkpoint import save_checkpoint as jax_save
    from repro_torch.checkpoint import (restore_checkpoint,
                                        save_checkpoint)

    rng = np.random.default_rng(8)
    x = np.concatenate([SWEEP, rng.standard_normal(64).astype(np.float32)])
    f8 = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    tree = {"pool": _f8_torch(f8), "w": torch.from_numpy(
        bf.view(np.int16).copy()).view(torch.bfloat16)}
    save_checkpoint(str(tmp_path / "port"), tree, 3)
    got, _ = jax_restore(str(tmp_path / "port"),
                         {"pool": jnp.asarray(f8), "w": jnp.asarray(bf)})
    np.testing.assert_array_equal(np.asarray(got["pool"]).view(np.uint8),
                                  f8.view(np.uint8))
    np.testing.assert_array_equal(np.asarray(got["w"]).view(np.uint16),
                                  bf.view(np.uint16))
    jax_save(str(tmp_path / "jax"), {"pool": jnp.asarray(f8),
                                     "w": jnp.asarray(bf)}, 4)
    back, step = restore_checkpoint(str(tmp_path / "jax"), tree)
    assert step == 4 and back["pool"].dtype == F8
    np.testing.assert_array_equal(_bits(back["pool"]), f8.view(np.uint8))
    assert torch.equal(back["w"].view(torch.int16), tree["w"].view(
        torch.int16))
