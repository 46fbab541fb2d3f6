"""whisper's encoder-decoder in the port against the JAX package, on the
CPU.

``whisper-base-smoke`` (2 encoder and 2 decoder layers, d 64, layer norm,
plain gelu MLPs, learned position tables, no RoPE; the conv frontend
stubbed by precomputed frames) at fp32 compute with the JAX weights
carried over by ``weights.from_jax_numpy``.  The forward with
``enc_embeds``, the step-by-step reference prefill, the dense ``Engine``'s
batched prefill, decode, ``generate`` and ``insert`` (which splices the
slot's encoder output), and 6-request ``ServeScheduler`` traces agree:
logits within 1e-4 of the logit scale, greedy streams and outcomes equal,
also through the launcher's trace and wave modes.  The refusals the
reference keeps hold too: no paged engine, paged cache or chunked prefill
for an encoder-decoder model, and no insert without its ``enc_embeds``.
The cross-attention layer, and the flash forward's plain version at the
non-causal S != T shapes it runs on the card (1 and 8 decoder rows over
the frames), match the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.attention import attention as jax_attention
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import prefill as jax_prefill
from repro.serve import Engine as JaxEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import attention
from repro_torch.models.transformer import (check_trainable,
                                            chunk_prefill_step, encode,
                                            forward, init_paged_cache,
                                            init_params, layer_plan, prefill)
from repro_torch.serve import Engine, PagedEngine, ServeScheduler
from repro_torch.weights import from_jax_numpy

ARCH = "whisper-base"
LOGIT_TOL = 1e-4                 # of max|logit|, port vs JAX, fp32
T_ENC = 24                       # encoder frames in these tests


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


def _close(got, want, tol=LOGIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _ints(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab - 1, shape).astype(np.int32)


def _frames(seed, rows, d, frames=T_ENC):
    return np.random.default_rng(seed).standard_normal(
        (rows, frames, d), dtype=np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("S", [1, 8, 24])
def test_flash_plain_non_causal_cross_shapes_match_jax(S):
    """The flash wrapper's CPU path, non-causal, S queries over 24 frames
    (H = KV 4, D 16, whisper's smoke widths), against the JAX oracle."""
    rng = np.random.default_rng(60 + S)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, S, 4, 16), (2, T_ENC, 4, 16),
                             (2, T_ENC, 4, 16)))
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                     impl="ref")
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("impl", ["auto", "dense", "tiled"])
def test_cross_attention_layer_matches_jax(models, impl):
    """A decoder block's cross-attention: K/V projected from the encoder
    output, no RoPE, no mask, at per-slot decode positions."""
    jc, tc, jp, tp = models
    p_j = jp["groups"][0]["cross"]
    p_j = jax.tree.map(lambda t: t[0], p_j)
    p_t = tp["layers"][0]["cross"]
    x = _frames(70, 2, jc.d_model, 3)
    enc = _frames(71, 2, jc.d_model)
    pos = np.array([[5, 6, 7], [9, 10, 11]], np.int32)
    want, _ = jax_attention(jc, p_j, jnp.asarray(x), kv_x=jnp.asarray(enc),
                            positions=jnp.asarray(pos),
                            kv_positions=jnp.arange(T_ENC), causal=False,
                            rope=False)
    got, kv = attention(tc, p_t, torch.as_tensor(x), cache=None,
                        kv_x=torch.as_tensor(enc),
                        positions=torch.as_tensor(pos), causal=False,
                        rope=False, impl=impl)
    assert kv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="no cache"):
        attention(tc, p_t, torch.as_tensor(x), cache={},
                  kv_x=torch.as_tensor(enc), positions=torch.as_tensor(pos))


def test_port_init_matches_reference_layout(models):
    """``init_params`` draws the tree ``from_jax_numpy`` carries over:
    decoder blocks with their cross-attention, the encoder blocks, its
    final norm and both position tables (max_seq, d)."""
    jc, tc, jp, tp = models
    mine = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    a, b = _flat(mine), _flat(tp)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    assert len(tp["enc_layers"]) == layer_plan(tc).enc_groups == 2
    assert {"ln_cross", "cross"} <= tp["layers"][0].keys()
    assert tp["dec_pos"].shape == (tc.max_seq, tc.d_model)
    for key in ("enc_pos", "dec_pos"):
        assert float(mine[key].std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("S", [1, 9, 30])
def test_encdec_forward_matches_jax(models, S):
    """Decoder sequences of 1, 9 and 30 tokens over 24 encoder frames."""
    jc, tc, jp, tp = models
    toks = _ints(1, (2, S), jc.vocab_size)
    enc = _frames(2, 2, jc.d_model)
    want, _ = jax_forward(jc, jp, tokens=jnp.asarray(toks),
                          enc_embeds=jnp.asarray(enc))
    with torch.no_grad():
        got, _ = forward(tc, tp, tokens=torch.as_tensor(toks),
                         enc_embeds=torch.as_tensor(enc))
    _close(got, want)
    with pytest.raises(ValueError, match="enc_embeds"):
        forward(tc, tp, tokens=torch.as_tensor(toks))


def test_stepwise_prefill_matches_jax_and_the_engine(models):
    """The step-by-step reference prefill returns the cache, the last
    logits and the encoder output, as the reference's does; the engine's
    batched prefill gives the same logits and encoder output."""
    jc, tc, jp, tp = models
    toks = _ints(5, (2, 9), jc.vocab_size)
    enc = _frames(6, 2, jc.d_model)
    jcache, jlast, jenc = jax_prefill(jc, jp, jnp.asarray(toks), max_len=24,
                                      enc_embeds=jnp.asarray(enc))
    cache, last, enc_out = prefill(tc, tp, torch.as_tensor(toks), max_len=24,
                                   enc_embeds=torch.as_tensor(enc))
    _close(last, jlast)
    np.testing.assert_allclose(enc_out.numpy(), np.asarray(jenc),
                               atol=1e-5, rtol=1e-5)
    assert int(cache["len"]) == 9 == int(jcache["len"])
    eng = Engine(tc, tp, batch=2, max_len=24, device="cpu")
    _close(eng.prefill(toks, enc_embeds=enc), jlast)
    np.testing.assert_allclose(eng._enc_out.numpy(), enc_out.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        encode(tc, tp, torch.as_tensor(enc)).numpy(), enc_out.numpy(),
        atol=1e-6, rtol=1e-6)


def test_engine_prefill_insert_decode_match_jax(models):
    """A batched prefill, an insert of a padded prompt with new frames
    into slot 1, and decode steps against both slots' encoder outputs."""
    jc, tc, jp, tp = models
    batch = _ints(2, (2, 7), jc.vocab_size)
    enc = _frames(3, 2, jc.d_model)
    jd = JaxEngine(jc, jp, batch=2, max_len=40)
    td = Engine(tc, tp, batch=2, max_len=40, device="cpu")
    _close(td.prefill(batch, enc_embeds=enc),
           jd.prefill(jnp.asarray(batch), enc_embeds=jnp.asarray(enc)))
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = _ints(4, (11,), jc.vocab_size)
    new = _frames(5, 1, jc.d_model)
    _close(td.insert(1, padded, true_len=11, enc_embeds=new),
           jd.insert(1, jnp.asarray(padded), true_len=11,
                     enc_embeds=jnp.asarray(new)))
    toks = batch[:, :1]
    for _ in range(4):
        lj = jd.decode(jnp.asarray(toks))
        _close(td.decode(toks), lj)
        toks = np.argmax(np.asarray(lj)[:, -1], axis=-1)[:, None].astype(
            np.int32)
    assert td.trace_count("splice") == 1


def test_engine_generate_matches_jax(models):
    jc, tc, jp, tp = models
    prompts = _ints(7, (3, 6), jc.vocab_size)
    enc = _frames(8, 3, jc.d_model)
    want = JaxEngine(jc, jp, batch=3, max_len=32).generate(
        jnp.asarray(prompts), max_new=10, enc_embeds=jnp.asarray(enc))
    got = Engine(tc, tp, batch=3, max_len=32, device="cpu").generate(
        prompts, max_new=10, enc_embeds=enc)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_insert_checks_its_encoder_input(models):
    """An insert needs enc_embeds of the live batch's length and a live
    encoder output; ``ensure_batch`` needs the length to size it."""
    _, tc, _, tp = models
    eng = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    prompt = _ints(9, (1, 5), tc.vocab_size)
    with pytest.raises(RuntimeError, match="live batch"):
        eng.insert(0, prompt, enc_embeds=_frames(1, 1, tc.d_model))
    with pytest.raises(ValueError, match="enc_len"):
        eng.ensure_batch()
    eng = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    eng.ensure_batch(enc_len=T_ENC)
    assert eng._enc_out.shape == (2, T_ENC, tc.d_model)
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.insert(0, prompt)
    with pytest.raises(ValueError, match="encoder length"):
        eng.insert(0, prompt, enc_embeds=_frames(1, 1, tc.d_model, 8))
    eng.insert(0, prompt, enc_embeds=_frames(1, 1, tc.d_model))
    assert int(eng.cache["len"][0]) == 5


def test_encdec_refusals(models):
    """As in the reference: no paged engine, paged cache or chunked
    prefill for an encoder-decoder model.  Training it is not refused
    (``tests/test_torch_train_families.py`` holds it to the reference)."""
    _, tc, _, tp = models
    with pytest.raises(NotImplementedError, match="encdec"):
        PagedEngine(tc, tp, batch=2, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec"):
        init_paged_cache(tc, 2, num_pages=4, page_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec"):
        chunk_prefill_step(tc, tp, {}, torch.zeros((1, 8), dtype=torch.int32),
                           slot=0, start=0, valid_len=8,
                           pages_row=torch.zeros((1, 1), dtype=torch.int32),
                           page_size=8)
    check_trainable(tc)


def test_encdec_scheduler_streams_match_jax(models):
    """A 6-request trace, each request with its own frames, through each
    package's ``ServeScheduler`` over its dense engine (one insert a
    request, splicing its encoder output): identical greedy streams and
    outcomes."""
    jc, tc, jp, tp = models
    prompts = [_ints(20 + i, (n,), jc.vocab_size)
               for i, n in enumerate((5, 20, 12, 3, 16, 9))]
    frames = [_frames(40 + i, 1, jc.d_model) for i in range(len(prompts))]

    def drain(sched, wrap):
        for p, f in zip(prompts, frames):
            assert sched.submit(p, max_new=8, enc_embeds=wrap(f)) is not None
        tokens = {r.rid: r.tokens for r in sched.run()}
        return tokens, {rid: o.outcome for rid, o in sched.outcomes.items()}

    want = drain(JaxServeScheduler(JaxEngine(jc, jp, batch=3, max_len=48)),
                 jnp.asarray)
    got = drain(ServeScheduler(Engine(tc, tp, batch=3, max_len=48,
                                      device="cpu")), lambda f: f)
    assert got == want
    assert len(got[0]) == len(prompts)
    assert set(got[1].values()) == {"completed"}


def _patch_launchers(monkeypatch, models):
    """Both launchers on one fp32 config, the port's on the JAX launcher's
    weights (drawn from the same seed)."""
    import repro.launch.serve as jax_launcher
    import repro_torch.launch.serve as launcher

    jc, tc, jp, tp = models
    monkeypatch.setattr(jax_launcher, "get_smoke_config", lambda arch: jc)
    monkeypatch.setattr(launcher, "get_smoke_config", lambda arch: tc)
    monkeypatch.setattr(launcher, "init_params",
                        lambda cfg, gen, device, cast=False: tp)
    return launcher, jax_launcher


def test_launcher_trace_matches_jax(models, monkeypatch):
    """``--arch whisper-base --smoke --trace`` (the dense engine; 64
    random encoder frames a request, drawn as the reference draws them):
    the same greedy streams, outcomes and signatures in both packages."""
    launcher, jax_launcher = _patch_launchers(monkeypatch, models)
    streams = []
    for mod, pick in ((launcher, lambda snap: snap["results"]),
                      (jax_launcher, lambda snap: snap[1])):
        replay = mod.replay_trace

        def recording(sched, reqs, replay=replay, pick=pick):
            snap = replay(sched, reqs)
            streams.append({r.rid: list(r.tokens) for r in pick(snap)})
            return snap

        monkeypatch.setattr(mod, "replay_trace", recording)
    argv = ["--arch", ARCH, "--smoke", "--trace", "--batch", "3",
            "--n-requests", "5", "--prompt-lens", "4", "9", "--max-new", "6"]
    got = launcher.main(argv + ["--device", "cpu"])
    want = jax_launcher.main(argv)
    assert len(streams) == 2 and streams[0] == streams[1]
    assert got["outcomes"] == want["outcomes"] == {"completed": 5}
    assert got["gen_tokens"] == want["gen_tokens"] == 30
    assert got["trace_counts"] == want["trace_counts"]
    with pytest.raises(NotImplementedError, match="encdec"):
        launcher.main(argv + ["--device", "cpu", "--paged"])


def test_launcher_waves_match_jax(models, monkeypatch, capsys):
    """Wave mode: two waves of 2 prompts with 64 frames a row; the sample
    rows the two launchers print are equal."""
    launcher, jax_launcher = _patch_launchers(monkeypatch, models)
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--max-new", "5", "--requests", "2"]
    got = launcher.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out
    jax_launcher.main(argv)
    theirs = capsys.readouterr().out

    def rows(out):
        return [l.split("sample row: ")[1] for l in out.splitlines()
                if "sample row: " in l]

    assert rows(ours) == rows(theirs) and len(rows(ours)) == 2
    assert got["trace_counts"] == {"prefill": 1, "decode": 1, "splice": 0}
