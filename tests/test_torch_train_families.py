"""Training of every family the port trains, against the JAX package, on
the CPU: the MoE blocks (qwen2-moe, mixtral), Mamba-2 (mamba2), the hybrid
stack (zamba2), the encoder-decoder (whisper) and the local/global blocks
(gemma3).

Weights are drawn by the JAX package (``init_params(cfg, PRNGKey(0))``)
and carried over by ``weights.from_jax_numpy``; batches come from the same
synthetic stream on both sides; compute is fp32.  Levels:

* the loss and every gradient against ``jax.grad`` of the reference's
  ``loss_fn`` at 1e-5 (mamba2 and zamba2 at a length that is not a
  multiple of the chunk, whisper with more encoder frames than decoder
  tokens, gemma3 and mixtral past their windows of 16, the MoE models at
  a length whose capacity drops tokens);
* 3 fused steps with grad_accum 2 and the HyPar trainer against the
  reference's at 2e-5 (qwen2-moe, mamba2);
* ``remat="save_dots"``: gradients bit-identical to ``none`` and
  ``full``, and a backward that re-runs no 2-D product;
* ``SsdIntraChunkFn`` (the kernel path's autograd) with the plain version
  in the kernel's place against autograd through the plain version, and
  finite gradients where the reference's ``exp`` overflows;
* the launcher and the process workers for the new families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke
from repro.core import VirtualCluster as JaxCluster
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.kernels.ssd_scan import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models import ssm as jax_ssm
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.optim import OptimizerSpec as JaxSpec
from repro.train import HyParTrainer as JaxHyParTrainer
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import VirtualCluster
from repro_torch.data import to_device
from repro_torch.kernels.flash_attention.kernel import MAX_D_BWD
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain
from repro_torch.models import ssm
from repro_torch.models.transformer import (SAVE_DOTS_OPS, check_trainable,
                                            loss_fn)
from repro_torch.optim import OptimizerSpec
from repro_torch.train import HyParTrainer, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import from_jax_numpy, train_state_from_jax_numpy

CPU = torch.device("cpu")
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = 2e-5
SSD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# arch, sequence length: ssm chunks of 16 (40 is not a multiple), windows
# of 16, whisper's smoke decoder of 32 positions under 48 frames, and 80
# tokens a MoE row (capacity 25 < 80 · 2 / 8 · 1.25 rounded up: drops)
FAMILIES = [("qwen2-moe-a2.7b", 80), ("mixtral-8x7b", 80),
            ("mamba2-370m", 40), ("zamba2-1.2b", 40), ("whisper-base", 48),
            ("gemma3-4b", 40)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(arch),
                                compute_dtype="float32"))


def _batch(jcfg, batch, seq, seed=0, step=0):
    return JaxStream(jcfg, JaxDataConfig(seed=seed, global_batch=batch,
                                         seq_len=seq,
                                         pad_frac=0.1)).batch(step)


# ---------------------------------------------------------------------------
# the loss and its gradients against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seq", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_loss_and_gradients_match_jax(arch, seq):
    _check_loss_and_gradients(*_configs(arch), seq)


def test_gemma3_at_head_dim_256_matches_jax():
    """gemma3's smoke config at its full model's head dim (256, the flash
    backward kernel's widest), on both sides: the loss and every gradient
    against ``jax.grad`` at 1e-5, past its window of 16."""
    jcfg, cfg = (dataclasses.replace(c, head_dim=256)
                 for c in _configs("gemma3-4b"))
    assert cfg.hd == MAX_D_BWD
    _check_loss_and_gradients(jcfg, cfg, 40)


def _check_loss_and_gradients(jcfg, cfg, seq):
    params_j = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg, 2, seq)
    if cfg.family == "encdec":
        assert batch["enc_embeds"].shape[1] > batch["tokens"].shape[1]
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(params_j)

    params = from_jax_numpy(_np(params_j), cfg, CPU)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    total, metrics = loss_fn(cfg, params, to_device(batch, CPU))
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   rtol=1e-6, atol=1e-6)
    assert (float(metrics["aux"]) > 0) == cfg.is_moe
    want = tree_leaves(from_jax_numpy(_np(jg), cfg, CPU))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


# ---------------------------------------------------------------------------
# 3 fused steps and the HyPar trainer against the reference's
# ---------------------------------------------------------------------------


def _micro(batch, n):
    B = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * B:(i + 1) * B] for k, v in batch.items()}
            for i in range(n)]


@pytest.mark.parametrize("arch,seq", [("qwen2-moe-a2.7b", 80),
                                      ("mamba2-370m", 40)])
def test_fused_steps_and_hypar_trainer_match_jax(arch, seq):
    """3 steps of grad_accum 2 from the reference's initial TrainState:
    the fused step and the HyPar trainer (2 micro-batches a step) against
    the reference's, 2e-5; the port's two agree to the bit.

    AdamW runs at eps 1e-6.  A few gradient entries are rounding noise on
    both sides: qwen2-moe's key biases (a constant added to every score of
    a query leaves its softmax unchanged, so their exact gradient is 0),
    and one of mamba2's in_proj entries (about 1e-9, against 1e-3 for its
    neighbours).  At the default eps of 1e-8, AdamW's first update turns
    any such noise into a step of about ±lr (g / (|g| + eps)), whose sign
    is the noise's own: the two packages' gradients agree within 2e-9
    there, and their steps still differ by up to 1.6e-4."""
    jcfg, cfg = _configs(arch)
    jspec, spec = (JaxSpec(kind="adamw", lr=1e-3, eps=1e-6),
                   OptimizerSpec(kind="adamw", lr=1e-3, eps=1e-6))
    batches = [_batch(jcfg, 4, seq, step=s) for s in range(3)]
    state_j = JaxTrainState.create(jcfg, jspec, jax.random.PRNGKey(0))
    init = _np({"params": state_j.params, "opt_state": state_j.opt_state,
                "step": state_j.step})
    jstep = jax.jit(jax_make_train_step(jcfg, jspec, grad_accum=2))
    jlosses = []
    for b in batches:
        state_j, m = jstep(state_j, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss_total"]))
    jhp, _, _ = JaxHyParTrainer(
        jcfg, jspec, n_micro=2,
        cluster=JaxCluster(jax.devices()[:1], n_schedulers=1)).run(
        [[jax.tree.map(jnp.asarray, mb) for mb in _micro(b, 2)]
         for b in batches], key=jax.random.PRNGKey(0))

    hp, _, _ = HyParTrainer(cfg, spec, n_micro=2,
                            cluster=VirtualCluster([CPU], n_schedulers=1)
                            ).run([_micro(to_device(b, CPU), 2)
                                   for b in batches],
                                  params=train_state_from_jax_numpy(
                                      init, cfg, CPU).params)
    state = train_state_from_jax_numpy(init, cfg, CPU)
    step = make_train_step(cfg, spec, grad_accum=2)
    losses = []
    for b in batches:
        state, m = step(state, to_device(b, CPU))
        losses.append(float(m["loss_total"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for got, want_j in ((state.params, state_j.params), (hp, jhp)):
        want = from_jax_numpy(_np(want_j), cfg, CPU)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_TOL)
    for a, b in zip(tree_leaves(hp), tree_leaves(state.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# remat="save_dots"
# ---------------------------------------------------------------------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "whisper-base"])
def test_save_dots_gradients_equal_none_and_full(arch):
    """The three policies give the same gradients, to the bit.  In the
    backward pass, ``full`` re-runs the blocks' 2-D products (more
    ``aten.mm`` than under ``none``), ``save_dots`` re-runs none of them
    (as many as under ``none``: only the gradients' own) but does re-run
    the batched ones (as many ``aten.bmm`` as ``full``)."""
    jcfg, cfg = _configs(arch)
    batch = to_device(_batch(jcfg, 2, 40), CPU)
    params = from_jax_numpy(
        _np(jax_init_params(jcfg, jax.random.PRNGKey(0))), cfg, CPU)
    grads, counts = {}, {}
    for remat in ("none", "full", "save_dots"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        alias = tree_unflatten(params, leaves)
        total, _ = loss_fn(dataclasses.replace(cfg, remat=remat), alias,
                           batch)
        with _CountOps() as mode:
            grads[remat] = torch.autograd.grad(total, leaves)
        counts[remat] = {op: mode.counts.get(op, 0) for op in
                         (torch.ops.aten.mm.default,
                          torch.ops.aten.bmm.default)}
    for a, b, c in zip(grads["none"], grads["full"], grads["save_dots"]):
        assert torch.equal(a, b) and torch.equal(a, c)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert mm in SAVE_DOTS_OPS and bmm not in SAVE_DOTS_OPS
    assert counts["full"][mm] > counts["none"][mm]
    assert counts["save_dots"][mm] == counts["none"][mm]
    assert counts["save_dots"][bmm] == counts["full"][bmm] > \
        counts["none"][bmm]


# ---------------------------------------------------------------------------
# the SSD kernel path's autograd, and finite gradients under strong decay
# ---------------------------------------------------------------------------


def ssd_inputs(seed, BC, H, Q, P, N, decay=0.3):
    """The JAX kernel test's distributions: dt = softplus(normal), a =
    -exp(decay · normal) · dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, H, Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BC, H, Q, 1)))).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal((BC, H, Q, 1)) * decay) * dt).astype(
        np.float32)
    B = rng.standard_normal((BC, Q, N)).astype(np.float32)
    C = rng.standard_normal((BC, Q, N)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, a, B, C)]


@pytest.fixture
def plain_as_kernel(monkeypatch):
    """The plain version in the SSD kernel's place, in its contract: fp32
    inputs with grad mode off (``SsdIntraChunkFn.forward``), ``y``/``S`` as
    views of (BC, Q, H, P) and (BC, H, P, N) memory; counts its calls."""
    calls = []

    def fake_kernel(xh, dt, a, Bm, Cm, *, row_tile=None):
        assert not torch.is_grad_enabled()
        assert all(t.dtype == torch.float32 for t in (xh, dt, a, Bm, Cm))
        y, S = ssd_intra_chunk_plain(xh, dt, a, Bm, Cm)
        calls.append(row_tile)
        return (y.transpose(1, 2).contiguous().transpose(1, 2),
                S.transpose(2, 3).contiguous().transpose(2, 3))

    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk_kernel", fake_kernel)
    monkeypatch.setattr(ssd_ops, "resolve_impl", lambda impl, device: impl)
    return calls


@pytest.mark.parametrize("case", [(2, 2, 8, 16, 16), (1, 3, 16, 8, 32),
                                  (2, 1, 64, 16, 8)])
def test_ssd_intra_chunk_fn_gives_autograd_gradients(case, plain_as_kernel):
    """``ssd_intra_chunk(impl="kernel")`` goes through ``SsdIntraChunkFn``:
    the kernel's forward, and the plain version's gradient in every input
    against autograd through the plain version."""
    ins = [t.requires_grad_() for t in ssd_inputs(5, *case)]
    y, S = ssd_ops.ssd_intra_chunk(*ins, impl="kernel")
    assert y.grad_fn is not None and len(plain_as_kernel) == 1
    gen = torch.Generator().manual_seed(0)
    dy = torch.randn(y.shape, generator=gen)
    dS = torch.randn(S.shape, generator=gen)
    got = torch.autograd.grad((y, S), ins, (dy, dS))
    y_p, S_p = ssd_intra_chunk_plain(*ins)
    want = torch.autograd.grad((y_p, S_p), ins, (dy, dS))
    torch.testing.assert_close(y, y_p, atol=0, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SSD_TOL)
    # one gradient wanted: the others are not computed
    xh = ins[0].detach().requires_grad_()
    y, _ = ssd_ops.ssd_intra_chunk(xh, *(t.detach() for t in ins[1:]),
                                   impl="kernel")
    (gx,) = torch.autograd.grad(y, xh, dy)
    torch.testing.assert_close(gx, torch.autograd.grad(
        ssd_intra_chunk_plain(xh, *(t.detach() for t in ins[1:]))[0], xh,
        dy)[0], **SSD_TOL)


def test_mamba2_loss_gradients_through_the_kernel_path_match_jax(
        plain_as_kernel, monkeypatch):
    """The model's kernel branch of ``ssd_chunked`` (strided views into
    ``SsdIntraChunkFn`` and back) under grad: mamba2's loss and gradients
    against ``jax.grad`` at 1e-5, one call a layer and a micro-batch and
    one more for the remat recompute."""
    jcfg, cfg = _configs("mamba2-370m")
    monkeypatch.setattr(ssm, "resolve_impl", lambda impl, device: "kernel")
    params_j = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg, 2, 40)
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(params_j)
    params = from_jax_numpy(_np(params_j), cfg, CPU)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    total, _ = loss_fn(cfg, params, to_device(batch, CPU))
    grads = torch.autograd.grad(total, leaves)
    assert len(plain_as_kernel) == 2 * cfg.n_layers
    for g, w in zip(grads, tree_leaves(from_jax_numpy(_np(jg), cfg, CPU))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_ssd_kernel_binding_refuses_inputs_that_need_a_gradient(
        monkeypatch):
    """Called directly, the binding has no gradient to give: it refuses
    inputs that require grad while grad mode is on, before any build, so
    no gradient is dropped silently; under ``no_grad`` it goes on to its
    device check."""
    from repro_torch.kernels import build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(ssd_kernel, "_lib", None)
    ins = ssd_inputs(6, 1, 2, 8, 8, 8)
    before = ssd_kernel.launches
    ins[3].requires_grad_()
    with pytest.raises(RuntimeError, match="SsdIntraChunkFn"):
        ssd_kernel.ssd_intra_chunk_kernel(*ins)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_intra_chunk_kernel(*ins)
    assert ssd_kernel.launches == before


def test_ssd_gradients_stay_finite_under_strong_decay():
    """A per-step decay of about -100 over 64-step chunks: above the
    diagonal ``cum_t - cum_s`` reaches thousands and ``exp`` overflows.
    The reference takes ``exp`` there before its select, so ``jax.grad``
    is NaN; the port selects before ``exp`` as well: the same forward
    values as the reference's plain form, to the bit as the old form of
    the port, and finite gradients (intra-chunk and the chunked scan)."""
    ins = ssd_inputs(7, 2, 2, 64, 8, 8, decay=0.1)
    ins[2] = ins[2] * 100.0
    assert float(torch.cumsum(ins[2][..., 0], -1).min()) < -1000
    y_j, s_j = jax_ssd_intra_chunk(*(jnp.asarray(t.numpy()) for t in ins),
                                   impl="ref")
    jgrad = jax.grad(lambda a: jnp.sum(jax_ssd_intra_chunk(
        *(jnp.asarray(t.numpy()) for t in ins[:2]), a,
        *(jnp.asarray(t.numpy()) for t in ins[3:]), impl="ref")[0]))(
        jnp.asarray(ins[2].numpy()))
    assert not np.isfinite(np.asarray(jgrad)).all()

    leaves = [t.clone().requires_grad_() for t in ins]
    y, S = ssd_intra_chunk_plain(*leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **SSD_TOL)
    np.testing.assert_allclose(S.detach().numpy(), np.asarray(s_j),
                               **SSD_TOL)
    # the old form (exp, then select) gives the same values to the bit
    cum = torch.cumsum(ins[2][..., 0], -1)
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((64, 64), dtype=torch.bool).tril()
    old = torch.where(tri, torch.exp(seg), torch.zeros(()))
    new = torch.where(tri, torch.exp(torch.where(tri, seg, torch.zeros(()))),
                      torch.zeros(()))
    assert not torch.isfinite(torch.exp(seg)).all()
    assert torch.equal(old, new)
    grads = torch.autograd.grad((y.sum() + S.sum()), leaves)
    assert all(torch.isfinite(g).all() for g in grads)

    # the chunked scan: 2 chunks of 64 with the same decay
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 128, 2, 8)).astype(
        np.float32)).requires_grad_()
    dt = torch.full((1, 128, 2), 1.0, requires_grad=True)
    A = torch.tensor([-100.0, -50.0], requires_grad=True)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((1, 128, 8)).astype(
        np.float32)).requires_grad_() for _ in range(2))
    y, state = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=64, impl="ref")
    y_j, f_j = jax_ssm.ssd_chunked(
        *(jnp.asarray(t.detach().numpy()) for t in (x, dt, A, Bm, Cm)),
        chunk=64, return_final_state=True, impl="jnp")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **SSD_TOL)
    np.testing.assert_allclose(state.detach().numpy(), np.asarray(f_j),
                               **SSD_TOL)
    grads = torch.autograd.grad(y.sum() + state.sum(), (x, dt, A, Bm, Cm))
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# which configs train; the launcher and the process workers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_trains_but_gemma3(arch):
    """Named when gemma3-4b was refused; every config of the repo passes
    ``check_trainable`` now: mamba2 (one "head" of 1,024, but no attention
    layer) and gemma3-4b, whose head dim 256 is the flash backward
    kernel's widest, among them.  A head dim past it is refused."""
    cfg = get_config(arch)
    assert cfg.family == "ssm" or cfg.hd <= MAX_D_BWD
    check_trainable(cfg)
    if cfg.family != "ssm":
        with pytest.raises(NotImplementedError, match="head dim"):
            check_trainable(dataclasses.replace(cfg,
                                                head_dim=MAX_D_BWD + 8))
    check_trainable(get_smoke_config(arch))
    for remat in ("none", "full", "save_dots"):
        check_trainable(dataclasses.replace(get_smoke_config(arch),
                                            remat=remat))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-base",
                                  "gemma3-4b"])
@pytest.mark.parametrize("engine", ["fused", "hypar"])
def test_train_launcher_runs_every_family(arch, engine, capsys):
    """``launch/train.py`` at ``--smoke --device cpu``: a finite final loss
    (fused) or run time (hypar, 2 micro-batches a step)."""
    from repro_torch.launch.train import main
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "32", "--engine", engine]
    if engine == "hypar":
        argv += ["--grad-accum", "2"]
    out = main(argv)
    assert np.isfinite(out) and out > 0
    if engine == "fused":
        assert f"arch={get_smoke_config(arch).name}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-moe-a2.7b"])
def test_proc_engine_trains_the_family_as_threads_do(arch, monkeypatch,
                                                     capsys):
    """The process workers (spawned children, every array down a pipe:
    whisper's frames among the micro-batch's leaves) against the thread
    trainer, 1e-6 of max|params|, as the dense family's test holds them."""
    from repro_torch.launch.train import main

    runs = []
    run = HyParTrainer.run

    def recording(self, *args, **kw):
        out = run(self, *args, **kw)
        runs.append(tree_leaves(out[0]))
        return out

    monkeypatch.setattr(HyParTrainer, "run", recording)
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
            "--batch", "4", "--seq", "32", "--grad-accum", "2"]
    main(argv + ["--engine", "hypar"])
    main(argv + ["--engine", "proc", "--proc-workers", "2"])
    assert "job store: 9 executed, 0 memoised" in capsys.readouterr().out
    thread, proc = runs
    assert max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(proc, thread)) <= 1e-6
