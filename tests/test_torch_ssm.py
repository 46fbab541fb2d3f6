"""The port's Mamba-2 path against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages; model weights
are made on the JAX side (``init_params(cfg, PRNGKey(0))`` on the smoke
config ``mamba2-370m-smoke``, fp32 compute) and carried over with
``weights.from_jax_numpy``.  Levels:

* the SSD intra-chunk plain version against the JAX kernel (interpret
  mode) and its jnp oracle, at 1e-5 (fp32, the JAX package's own kernel
  tolerance);
* ``ssd_chunked`` (the einsum path and the kernel-layout path) against
  JAX's ``jnp`` and ``interpret`` paths, at 1e-5;
* ``apply_mamba2`` chunk continuation with padding, and the decode
  recurrence, at 1e-5;
* the paged engine: chunked prefill and decode logits and per-slot state
  against JAX's ``PagedEngine`` at 1e-4 (3 layers of differently ordered
  fp32 sums, as ``test_torch_model.py``), and the two SSM serving
  regressions at the logits level: interleaved decode must not advance a
  mid-prefill slot, and a reused slot starts from zero state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.ssd_scan import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models import ssm as jax_ssm
from repro.models.transformer import init_params as jax_init
from repro.serve import PagedEngine as JaxPagedEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import (kernel, ssd_intra_chunk,
                                          ssd_intra_chunk_plain)
from repro_torch.models import ssm
from repro_torch.serve import PageAllocator, PagedEngine, chunk_plan
from repro_torch.weights import from_jax_numpy, init_params

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def ssd_inputs(seed, BC, H, Q, P, N):
    """The JAX kernel test's distributions: dt = softplus(normal), a =
    -exp(0.3 normal) * dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, H, Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BC, H, Q, 1)))).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal((BC, H, Q, 1)) * 0.3) * dt).astype(
        np.float32)
    B = rng.standard_normal((BC, Q, N)).astype(np.float32)
    C = rng.standard_normal((BC, Q, N)).astype(np.float32)
    return x, dt, a, B, C


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_smoke("mamba2-370m"), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config("mamba2-370m"),
                             compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# SSD intra-chunk and ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
@pytest.mark.parametrize("case", [(2, 2, 8, 16, 16), (1, 3, 16, 8, 32),
                                  (2, 1, 64, 16, 8)])
def test_ssd_intra_chunk_plain_matches_jax(case, jax_impl):
    arrays = ssd_inputs(1, *case)
    y_j, s_j = jax_ssd_intra_chunk(*map(jnp.asarray, arrays), impl=jax_impl)
    y, s = ssd_intra_chunk_plain(*_t(*arrays))
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    # auto on CPU tensors is the plain version
    y2, s2 = ssd_intra_chunk(*_t(*arrays))
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)


def test_ssd_intra_chunk_kernel_needs_cuda_tensors():
    arrays = _t(*ssd_inputs(2, 1, 2, 8, 8, 8))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_intra_chunk(*arrays, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_intra_chunk_kernel(*arrays)
    with pytest.raises(ValueError, match="impl"):
        ssd_intra_chunk(*arrays, impl="interpret")
    assert kernel.launches == before


def test_ssd_intra_chunk_refuses_a_launch_shape_outside_the_grid(
        monkeypatch):
    """``row_tile`` of the grid leaves the plain version's result
    unchanged; a value outside it is refused on either path before any
    build, and nothing is launched."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(kernel, "_lib", None)
    arrays = _t(*ssd_inputs(4, 1, 2, 8, 8, 8))
    want = ssd_intra_chunk_plain(*arrays)
    for cfg in DEFAULT_CANDIDATES["ssd_scan"]:
        got = ssd_intra_chunk(*arrays, **cfg)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    before = kernel.launches
    for bad in (16, 48, 128):
        for impl in ("auto", "ref", "kernel"):
            with pytest.raises(ValueError, match="launch shapes"):
                ssd_intra_chunk(*arrays, impl=impl, row_tile=bad)
        with pytest.raises(ValueError, match="launch shapes"):
            kernel.ssd_intra_chunk_kernel(*arrays, row_tile=bad)
    assert kernel.launches == before


def chunked_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.2)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("port_path", ["einsum", "kernel_layout"])
@pytest.mark.parametrize("jax_impl", ["jnp", "interpret"])
def test_ssd_chunked_matches_jax(jax_impl, port_path, monkeypatch):
    """S = 40 at chunk 16: three chunks, the last one padded; a nonzero
    initial state and the final state.  ``kernel_layout`` runs the port's
    kernel branch (the (B·nc, H, Q, P) views and back) with the plain
    intra-chunk version in the kernel's place, taking and giving the
    kernel's memory layouts."""
    x, dt, A, Bm, Cm, s0 = chunked_inputs(3, 2, 40, 3, 8, 4)
    y_j, f_j = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16,
        initial_state=jnp.asarray(s0), return_final_state=True,
        impl=jax_impl)
    impl = "ref"
    if port_path == "kernel_layout":
        impl = "kernel"

        def as_kernel(xh, dt, a, Bm, Cm, *, impl):
            # the kernel's contract: the model's memory comes in as strided
            # views, and y, S go back as views of (BC, Q, H, P) and
            # (BC, H, P, N) memory
            assert xh.stride(-1) == 1 and xh.transpose(1, 2).is_contiguous()
            y, S = ssd_intra_chunk_plain(xh, dt, a, Bm, Cm)
            return (y.transpose(1, 2).contiguous().transpose(1, 2),
                    S.transpose(2, 3).contiguous().transpose(2, 3))

        monkeypatch.setattr(ssm, "resolve_impl", lambda impl, device: impl)
        monkeypatch.setattr(ssm, "ssd_intra_chunk", as_kernel)
    y, f = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=16,
                           initial_state=torch.from_numpy(s0), impl=impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **TOL)
    # no initial state: the scan starts from zeros
    y0, f0 = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=16, impl=impl)
    y0_j, f0_j = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                     chunk=16, return_final_state=True,
                                     impl=jax_impl)
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_j), **TOL)
    np.testing.assert_allclose(f0.numpy(), np.asarray(f0_j), **TOL)


# ---------------------------------------------------------------------------
# The mixer: chunk continuation and decode
# ---------------------------------------------------------------------------


def _mixer(models, layer=0):
    jc, tc, jp, tp = models
    jmix = jax.tree.map(lambda t: t[layer], jp["groups"][0]["mixer"])
    return jc, tc, jmix, tp["layers"][layer]["mixer"]


def test_apply_mamba2_chunk_continuation_matches_jax(models):
    """Two full 16-token chunks, then a 16-token bucket holding 5 real
    tokens, each continuing from the previous chunk's cache; outputs and
    caches agree with JAX's, and the chunked run agrees with one
    unpadded pass over the 37 real tokens."""
    jc, tc, jmix, tmix = _mixer(models)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 48, tc.d_model)).astype(np.float32)
    x[:, 37:] = rng.standard_normal((1, 11, tc.d_model))   # padding junk
    jcache = tcache = None
    outs = []
    for start, valid in ((0, 16), (16, 16), (32, 5)):
        xc = x[:, start:start + 16]
        jo, jcache = jax_ssm.apply_mamba2(
            jc, jmix, jnp.asarray(xc), cache=jcache, valid_len=valid,
            return_cache=True, impl="jnp")
        to, tcache = ssm.apply_mamba2(tc, tmix, torch.from_numpy(xc),
                                      cache=tcache, valid_len=valid)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for key in ("conv", "state"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)
        outs.append(to[:, :valid])
    whole, wcache = ssm.apply_mamba2(tc, tmix, torch.from_numpy(x[:, :37]))
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, **TOL)
    for key in ("conv", "state"):
        torch.testing.assert_close(tcache[key], wcache[key], **TOL)


def test_mamba2_decode_step_matches_jax(models):
    jc, tc, jmix, tmix = _mixer(models, layer=1)
    rng = np.random.default_rng(5)
    B = 3
    one = ssm.init_ssm_cache(tc, B, "cpu")
    cache_np = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                for k, v in one.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache_np.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    for _ in range(3):
        x = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
        jo, jcache = jax_ssm.mamba2_decode_step(jc, jmix, jnp.asarray(x),
                                                jcache)
        to, tcache = ssm.mamba2_decode_step(tc, tmix, torch.from_numpy(x),
                                            tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for key in ("conv", "state"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)


def test_port_init_matches_reference_layout(models):
    """``init_params`` (torch.Generator) draws the tree ``from_jax_numpy``
    produces for the SSM family: same keys, shapes and dtypes."""
    _, tc, _, tp = models
    mine = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert len(mine["layers"]) == len(tp["layers"]) == tc.n_layers
    for a, b in zip(mine["layers"], tp["layers"]):
        assert a.keys() == b.keys() == {"ln1", "mixer"}
        assert a["mixer"].keys() == b["mixer"].keys()
        for k in a["mixer"]:
            x, y = a["mixer"][k], b["mixer"][k]
            if isinstance(x, dict):
                assert {kk: (v.shape, v.dtype) for kk, v in x.items()} == \
                    {kk: (v.shape, v.dtype) for kk, v in y.items()}, k
            else:
                assert (x.shape, x.dtype) == (y.shape, y.dtype), k
    dt = torch.nn.functional.softplus(mine["layers"][0]["mixer"]["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------


def test_chunked_prefill_then_decode_matches_jax(models):
    """Three slots: a full chunk plus a padded partial bucket, one short
    chunk, and a prompt that is prefilled, freed and decoded on as a free
    slot.  Logits, lengths and every layer's per-slot state agree; the
    engine keeps no attention pool and no prefix cache."""
    jc, tc, jp, tp = models
    B, ps, C, max_len, steps = 3, 8, 16, 48, 6
    je = JaxPagedEngine(jc, jp, batch=B, max_len=max_len, page_size=ps,
                        prefill_chunk=C, attn_impl="ref")
    te = PagedEngine(tc, tp, batch=B, max_len=max_len, page_size=ps,
                     prefill_chunk=C, device="cpu")
    assert not te.supports_prefix_cache and not je.supports_prefix_cache
    assert te.total_pool_bytes() == je.total_pool_bytes() == 0
    rng = np.random.default_rng(7)
    lens = {0: 21, 1: 5, 2: 28}
    toks = np.zeros((B, 1), np.int32)
    for slot, n in lens.items():
        prompt = rng.integers(0, jc.vocab_size - 1, (n,)).astype(np.int32)
        ids = list(range(1 + slot * 6, 7 + slot * 6))
        for start, blen, valid in chunk_plan(n, C, te.chunk_buckets):
            ck = np.zeros((1, blen), np.int32)
            ck[0, :valid] = prompt[start:start + valid]
            lj = je.prefill_chunk(slot, jnp.asarray(ck), ids, start, valid)
            lt = te.prefill_chunk(slot, ck, ids, start, valid)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       **MODEL_TOL)
        je.commit_slot(slot, ids)
        te.commit_slot(slot, ids)
        toks[slot, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
    je.free_slot(2)
    te.free_slot(2)
    toks[2, 0] = 0
    for _ in range(steps):
        lj = np.asarray(je.decode(jnp.asarray(toks)))
        lt = te.decode(toks).numpy()
        np.testing.assert_allclose(lt, lj, **MODEL_TOL)
        toks[:2, 0] = np.argmax(lj[:2, -1], axis=-1)
    (row,) = te.rows                    # no mesh: one row
    np.testing.assert_array_equal(row.cache["len"].numpy(),
                                  np.asarray(je.cache["len"]))
    for key in ("conv", "state"):
        want = np.asarray(je.cache["groups"][0][key])
        np.testing.assert_allclose(row.cache[key].numpy(), want, **MODEL_TOL)
    te.copy_page(1, 2)                  # no attention pool: nothing to copy


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)


def test_chunked_prefill_immune_to_interleaved_decode(models):
    """Decode steps of the live batch between the chunks of a mid-prefill
    slot must not perturb that slot's state: the live mask freezes its
    dense per-slot SSM buffers.  Logits-level check; without the mask
    the logits move."""
    _, tc, _, tp = models
    rng = np.random.default_rng(10)
    short = _prompt(rng, tc, 6)
    long = _prompt(rng, tc, 40)                     # 3 chunks at 16

    def setup():
        eng = PagedEngine(tc, tp, batch=2, max_len=64, page_size=8,
                          prefill_chunk=16, device="cpu")
        alloc = PageAllocator(eng.num_pages)
        pg0 = alloc.alloc(eng.pages_needed(len(short), 8))
        lg = eng.insert(0, short, page_ids=pg0, max_new=8)
        tok = np.array([[int(lg[0, -1].argmax())], [0]], np.int32)
        return eng, alloc.alloc(eng.pages_needed(len(long), 4)), tok

    eng, pages, _ = setup()
    want = eng.insert(1, long, page_ids=pages, max_new=4)

    def interleaved(live_mask):
        eng, pages, tok = setup()
        got = None
        for start, blen, vlen in chunk_plan(len(long), eng.chunk_len,
                                            eng.chunk_buckets):
            ck = np.zeros((1, blen), np.int32)
            ck[0, :vlen] = long[start:start + vlen]
            got = eng.prefill_chunk(1, ck, pages, start, vlen)
            eng.decode(tok, live_mask=live_mask)
        return got

    got = interleaved(np.array([True, False]))
    torch.testing.assert_close(got, want, **TOL)
    unmasked = interleaved(None)
    assert float((unmasked - want).abs().max()) > 1e-3


def test_paged_slot_reuse_resets_state(models):
    """A request inserted into a freed slot sees none of the previous
    occupant's state: the first chunk starts from zero conv tail and SSD
    state."""
    _, tc, _, tp = models
    rng = np.random.default_rng(11)
    a, b = _prompt(rng, tc, 20), _prompt(rng, tc, 9)

    def insert_b(eng, alloc):
        pages = alloc.alloc(eng.pages_needed(len(b), 4))
        return eng.insert(0, b, page_ids=pages, max_new=4)

    def engine():
        eng = PagedEngine(tc, tp, batch=1, max_len=48, page_size=8,
                          prefill_chunk=16, device="cpu")
        return eng, PageAllocator(eng.num_pages)

    want = insert_b(*engine())
    used, alloc = engine()
    pages = alloc.alloc(used.pages_needed(len(a), 6))
    lg = used.insert(0, a, page_ids=pages, max_new=6)
    tok = np.array([[int(lg[0, -1].argmax())]], np.int32)
    for _ in range(3):
        lg = used.decode(tok)
        tok = lg[:, -1].argmax(-1).to(torch.int32).numpy()[:, None]
    assert float(used.rows[0].cache["state"].abs().max()) > 0
    alloc.free(pages)
    used.free_slot(0)
    torch.testing.assert_close(insert_b(used, alloc), want, **TOL)
