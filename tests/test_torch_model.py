"""The port's model steps against the JAX package's, at the logits level.

JAX weights (``init_params(cfg, PRNGKey(0))`` on the smoke config
``qwen2-1.5b-smoke``, fp32 compute) are carried over with
``weights.from_jax_numpy``; both sides run the same paged-engine calls —
a multi-chunk ``chunk_prefill_step`` (full chunk plus a padded partial
bucket), then ``decode_step``s with per-slot lengths, one slot freed and
decoded past the width of its page table.  Logits and the K/V pools agree
to atol = rtol = 1e-4 (fp32; 3 layers of differently ordered sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import init_params as jax_init
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import chunk_plan as jax_chunk_plan
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_paged_cache
from repro_torch.serve import PagedEngine, chunk_plan
from repro_torch.weights import from_jax_numpy, init_params

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_smoke("qwen2-1.5b"), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                             compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def test_port_init_matches_reference_layout(models):
    """``init_params`` (torch.Generator) draws the tree ``from_jax_numpy``
    produces: same keys, shapes and dtypes, truncated-normal scales."""
    _, tc, _, tp = models
    mine = init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in flat(v, f"{prefix}/{i}").items()}
        return {prefix: tree}

    a, b = flat(mine), flat(tp)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    w = a["/layers/0/mlp/down/w"]
    assert abs(float(w.std()) * np.sqrt(tc.d_ff) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(
        tc.d_ff) + 1e-6


def test_chunked_prefill_then_decode_matches_jax(models):
    jc, tc, jp, tp = models
    B, ps, C, max_len, steps = 3, 8, 16, 32, 8
    je = JaxPagedEngine(jc, jp, batch=B, max_len=max_len, page_size=ps,
                        prefill_chunk=C, attn_impl="ref")
    te = PagedEngine(tc, tp, batch=B, max_len=max_len, page_size=ps,
                     prefill_chunk=C, device="cpu")
    rng = np.random.default_rng(7)
    # slot 0: a full chunk + a padded partial bucket; slot 1: one short
    # chunk; slot 2: prefilled, then freed and decoded past its table
    lens = {0: 21, 1: 5, 2: 28}
    toks = np.zeros((B, 1), np.int32)
    for slot, n in lens.items():
        prompt = rng.integers(0, jc.vocab_size - 1, (n,)).astype(np.int32)
        ids = list(range(1 + slot * 4, 5 + slot * 4))
        plan = chunk_plan(n, C, te.chunk_buckets)
        assert plan == jax_chunk_plan(n, C, je.chunk_buckets)
        for start, blen, valid in plan:
            ck = np.zeros((1, blen), np.int32)
            ck[0, :valid] = prompt[start:start + valid]
            lj = je.prefill_chunk(slot, jnp.asarray(ck), ids, start, valid)
            lt = te.prefill_chunk(slot, ck, ids, start, valid)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert len(plan) == (2 if slot != 1 else 1)
        je.commit_slot(slot, ids)
        te.commit_slot(slot, ids)
        toks[slot, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
    je.free_slot(2)
    te.free_slot(2)
    toks[2, 0] = 0
    for _ in range(steps):
        lj = np.asarray(je.decode(jnp.asarray(toks)))
        lt = te.decode(toks).numpy()
        np.testing.assert_allclose(lt, lj, **TOL)
        toks[:2, 0] = np.argmax(lj[:2, -1], axis=-1)
    # the free slot ran past its table (4 pages of 8) without raising
    (row,) = te.rows                    # no mesh: one row, one shard
    (shard,) = row.shards
    assert int(row.cache["len"][2]) == lens[2] + steps > max_len
    np.testing.assert_array_equal(row.cache["len"].numpy(),
                                  np.asarray(je.cache["len"]))
    # every real page (not the trash page 0) holds the same K/V
    for kk in ("k", "v"):
        want = np.asarray(je.cache["groups"][0]["self"][kk])[:, 1:]
        np.testing.assert_allclose(getattr(shard, kk)[:, 1:].numpy(), want,
                                   **TOL)


def test_engine_defaults_to_cuda_and_refuses_what_is_not_ported(models):
    _, tc, _, tp = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedEngine(tc, tp, batch=1, max_len=16)
    with pytest.raises(TypeError, match="ServeMesh"):
        PagedEngine(tc, tp, batch=1, max_len=16, device="cpu", mesh=object())
    # encoder-decoder models serve on the dense engine only, as in the
    # reference (cross-attention has no paged buffers)
    with pytest.raises(NotImplementedError, match="encdec"):
        PagedEngine(get_smoke_config("whisper-base"), tp, batch=1,
                    max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec"):
        init_paged_cache(get_smoke_config("whisper-base"), 1, num_pages=4,
                         page_size=8, device="cpu")


#: dense archs the port runs beyond qwen2: qk-norm (chameleon), a wide
#: GQA stack (deepseek-coder) and llama3 (whose smoke config keeps the KV
#: cache in the compute dtype)
DENSE_ARCHS = ("chameleon-34b", "deepseek-coder-33b", "llama3-405b")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_arch_serving_steps_match_jax(arch):
    """Both engines of the port against the JAX package's on the arch's
    smoke config: a multi-chunk paged prefill and paged decode steps, and
    the dense engine's batched prefill, insert and decode steps."""
    from repro.serve import Engine as JaxEngine
    from repro_torch.serve import Engine

    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    assert tc.kv_cache_dtype == jc.kv_cache_dtype == ""
    jp = jax_init(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jc.vocab_size - 1, (21,)).astype(np.int32)

    je = JaxPagedEngine(jc, jp, batch=2, max_len=32, page_size=8,
                        prefill_chunk=16, attn_impl="ref")
    te = PagedEngine(tc, tp, batch=2, max_len=32, page_size=8,
                     prefill_chunk=16, device="cpu")
    ids = [1, 2, 3, 4]
    lj, lt = je.insert(0, prompt, page_ids=ids), te.insert(0, prompt,
                                                            page_ids=ids)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    toks = np.zeros((2, 1), np.int32)
    for _ in range(4):
        toks[0, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
        lj = je.decode(jnp.asarray(toks), live_mask=np.array([True, False]))
        lt = te.decode(toks, live_mask=np.array([True, False]))
        np.testing.assert_allclose(lt.numpy()[:1], np.asarray(lj)[:1], **TOL)

    batch = rng.integers(0, jc.vocab_size - 1, (2, 9)).astype(np.int32)
    jd = JaxEngine(jc, jp, batch=2, max_len=32)
    td = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    np.testing.assert_allclose(td.prefill(batch).numpy(),
                               np.asarray(jd.prefill(jnp.asarray(batch))),
                               **TOL)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = prompt[:11]
    np.testing.assert_allclose(
        td.insert(1, padded, true_len=11).numpy(),
        np.asarray(jd.insert(1, jnp.asarray(padded), true_len=11)), **TOL)
    for _ in range(3):
        np.testing.assert_allclose(td.decode(batch[:, :1]).numpy(),
                                   np.asarray(jd.decode(
                                       jnp.asarray(batch[:, :1]))), **TOL)
