"""The port's operation counter and roofline (``repro_torch.analysis``),
the counterpart of ``tests/test_analysis.py``.

Matmul flops are held exactly to 2·M·N·K, and the counted matmul flops of
a smoke forward (fp32, plain attention on both sides) to ``analyze_hlo``
of the JAX package's compiled forward, at 1e-6, for every family with a
smoke config here.  The traffic model, the live-byte peak, the positions
and the collective records are held to figures reckoned from the shapes.
Each hand-written kernel's meta branch gives its plain version's output
shapes and dtypes without a launch, and each kernel's ``cost()`` gives,
digit for digit, the bounds ``chip_smoke.py`` printed from its own
formulas before they moved into the kernel packages (those formulas are
kept below as they were).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo import analyze_hlo
from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro_torch.analysis import opcount
from repro_torch.analysis.opcount import (OpAnalysis, OpCounter,
                                          PositionCounts)
from repro_torch.analysis.roofline import H100, roofline_from_counts
from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModelParams
from repro_torch.kernels import (flash_attention, jacobi_sweep,
                                 paged_attention, rmsnorm, ssd_scan)
from repro_torch.kernels.runtime import resolve_impl
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import forward, init_params
from repro_torch.optim import OptimizerSpec
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
META = "meta"
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12


# -- the counter --------------------------------------------------------------


MATMULS = [
    ("mm", (7, 5), (5, 3), lambda a, b: a @ b, 7 * 3 * 5),
    ("bmm", (4, 7, 5), (4, 5, 3), torch.bmm, 4 * 7 * 3 * 5),
    ("matmul_3d_2d", (2, 7, 5), (5, 3), torch.matmul, 2 * 7 * 3 * 5),
    ("einsum", (2, 6, 5), (2, 5, 4),
     lambda a, b: torch.einsum("bik,bkj->bij", a, b), 2 * 6 * 4 * 5),
    ("linear_bias", (9, 5), (3, 5),
     lambda a, w: torch.nn.functional.linear(
         a, w, torch.zeros(3, device=a.device)),
     9 * 3 * 5),
]


@pytest.mark.parametrize("name,sa,sb,fn,mnk", MATMULS,
                         ids=[m[0] for m in MATMULS])
@pytest.mark.parametrize("device", ["cpu", META])
def test_matmul_flops_are_2mnk(name, sa, sb, fn, mnk, device):
    a = torch.ones(sa, device=device)
    b = torch.ones(sb, device=device)
    with OpCounter() as c:
        fn(a, b)
    an = c.analysis()
    assert an.flops == 2 * mnk
    assert an.matmul_flops == 2 * mnk


def test_stacked_matmuls_add_up():
    x = torch.ones(8, 16)
    ws = [torch.ones(16, 16) for _ in range(4)]
    with OpCounter() as c:
        for w in ws:
            x = torch.tanh(x @ w)
    assert c.analysis().flops == 4 * 2 * 8 * 16 * 16


def test_traffic_model_on_a_known_chain():
    """Elementwise ops read their operands and write their output, views
    are free, allocations write nothing, a gather moves twice its
    output."""
    x = torch.ones(4, 8)                       # 128 B
    table = torch.ones(100, 8)
    idx = torch.zeros(3, dtype=torch.int64)
    with OpCounter() as c:
        y = x * 2                              # 128 + 128
        z = y.t()                              # view: 0
        w = z.contiguous()                     # 128 + 128
        torch.empty(1000)                      # 0
        s = w + y.t()                          # 128 + 128 + 128
        table[idx]                             # 2 * 96
    an = c.analysis()
    assert an.traffic_bytes == 256 + 256 + 384 + 2 * 3 * 8 * 4
    assert an.by_op["t"]["traffic"] == 0
    assert an.by_op["mul"]["calls"] == 1
    assert s.shape == (8, 4)


def test_live_peak_follows_frees_and_saved_tensors():
    n = 1024                                   # 4 KiB a tensor
    with OpCounter() as c:
        a = torch.ones(n)
        b = a + 1
        del a
        d = b * 2                              # a freed: two live
        del b, d
        w = torch.ones(n, requires_grad=True)
        loss = (w.exp() * 3).sum()             # exp's output saved
        loss.backward()
    an = c.analysis()
    # w, exp(w) (saved) and their product live together; after the
    # backward w, its gradient and the loss scalar are left
    assert an.peak_bytes >= 3 * 4 * n
    assert an.positions[0].live_bytes == 2 * 4 * n + 4


def test_positions_and_the_backward_follow_the_forward():
    w0, w1 = (torch.ones(8, 8, requires_grad=True) for _ in range(2))
    x = torch.ones(4, 8)
    with OpCounter(2) as c:
        outs = [x @ w for w in opcount.each_position([w0, w1])]
        (outs[0] + outs[1]).sum().backward()
    p0, p1 = c.analysis().positions
    mm = 2 * 4 * 8 * 8
    # position 1: its forward product and the weight's gradient product
    # (x is no leaf that needs one)
    assert p1.flops == 2 * mm
    assert p0.flops == 2 * mm
    assert opcount.current_position() == 0


def test_micro_batch_sampling_counts_the_rest():
    w = torch.ones(8, 8)
    xs = [torch.ones(4, 8) for _ in range(5)]
    with OpCounter(sample_micro=2) as c:
        seen = [x @ w for x in opcount.micro_batches(xs)]
    assert len(seen) == 2
    assert c.analysis().flops == 5 * 2 * 4 * 8 * 8


def test_hooks_are_no_ops_outside_a_counter():
    items = [1, 2, 3]
    assert list(opcount.each_position(items)) == items
    assert list(opcount.micro_batches(items)) == items
    opcount.collective("all-reduce", torch.ones(3))
    opcount.kernel("x", {"flops": 1, "bytes": 1})
    assert opcount.active() is None


def test_one_counter_at_a_time():
    with OpCounter():
        with pytest.raises(RuntimeError, match="already active"):
            with OpCounter():
                pass
    assert opcount.active() is None


# -- the roofline ---------------------------------------------------------


def _analysis(flops, traffic, coll):
    p = PositionCounts(flops=flops, traffic_bytes=traffic)
    p.collectives.bytes_by_kind["all-reduce"] = coll
    p.collectives.counts["all-reduce"] = 1
    return OpAnalysis(positions=[p, PositionCounts()], by_op={}, by_site={})


@pytest.mark.parametrize("flops,traffic,coll,dominant", [
    (989e12, 1e9, 1e6, "compute"),
    (1e9, 3.35e12, 1e6, "memory"),
    (1e9, 1e9, 900e9, "collective"),
])
def test_roofline_terms_and_dominance(flops, traffic, coll, dominant):
    t = roofline_from_counts(_analysis(flops, traffic, coll), n_chips=4,
                             model_flops=2e12)
    assert t.compute_s == pytest.approx(flops / 989e12)
    assert t.memory_s == pytest.approx(traffic / 3.35e12)
    assert t.collective_s == pytest.approx(coll / 450e9)
    assert t.dominant == dominant
    assert t.step_s == max(t.compute_s, t.memory_s, t.collective_s)
    assert t.useful_flops_ratio == pytest.approx(0.5e12 / flops)
    assert t.roofline_fraction == pytest.approx(0.5e12 / t.step_s / 989e12)
    assert set(t.row()) >= {"compute_s", "memory_s", "collective_s",
                            "dominant", "useful_ratio"}


def test_h100_profile_and_cost_model_params():
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80 * 2**30)
    p = CostModelParams.from_hw(H100)
    assert (p.peak_flops, p.mem_bw, p.link_bw) == (989e12, 3.35e12, 450e9)
    assert p.dispatch_s == CostModelParams().dispatch_s


# -- collectives on a CPU 2 x 2 mesh ---------------------------------------


def _qwen2_fp32():
    return dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                               compute_dtype="float32")


def test_tp_collectives_of_a_forward_match_the_shapes():
    """A forward split over two tensor-parallel positions: each position
    all-reduces its attention and MLP partials (B, S, d) once a layer,
    its vocab shard's embedding partial once, and gathers the whole
    logits; hlo.py counts an all-reduce as twice its operand."""
    cfg = _qwen2_fp32()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    tokens = torch.zeros((B, S), dtype=torch.int64)
    with torch.no_grad(), OpCounter(2) as c:
        forward(cfg, params, tokens=tokens, tp_devices=["cpu", "cpu"])
    an = c.analysis()
    act = B * S * cfg.d_model * 4
    logits = B * S * cfg.padded_vocab * 4
    sites = {site: d["bytes"] for (_, site), d in an.by_site.items()}
    assert sites["attention_tp"] == 2 * cfg.n_layers * 2 * act
    assert sites["mlp_tp"] == 2 * cfg.n_layers * 2 * act
    assert sites["embed_tp"] == 2 * 2 * act
    assert sites["logits_tp"] == 2 * logits
    for p in an.positions:
        assert p.collectives.bytes_by_kind["all-reduce"] == (
            (2 * cfg.n_layers + 1) * 2 * act)
        assert p.collectives.bytes_by_kind["all-gather"] == logits


def test_gradient_rows_reduce_their_blocks():
    """On a 2 x 2 grid no row gathers the model or reduces a whole
    gradient: every region a row gathers in the forward sends its
    gradient back once, recorded as the reference's reduce-scatter onto
    the blocks (each row reads every parameter once, the tied table
    twice: the embedding and the logits), and the gathers record, as an
    all-gather, the bytes that came from other positions, which are less
    than what they gathered."""
    cfg = _qwen2_fp32()
    assert cfg.tie_embeddings
    spec = OptimizerSpec(kind="adamw")
    mesh = make_test_mesh(2, 2)
    state = TrainState.create(cfg, spec, torch.Generator().manual_seed(0),
                              "cpu", mesh=mesh)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 9)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "mask": torch.ones(4, 8)}
    step = make_train_step(cfg, spec, mesh=mesh)
    with OpCounter(2) as c:
        step(state, batch)
    sites = c.analysis().by_site
    assert ("all-reduce", "grad_rows") not in sites
    whole = sum(math.prod(leaf.shape) * 4
                for leaf in tree_leaves(state.params))
    table = math.prod(state.params["embed"]["table"].shape) * 4
    scatter = sites[("reduce-scatter", "grad_scatter")]
    assert scatter["bytes"] == 2 * (whole + table)
    fetched = sites[("all-gather", "param_gather")]["bytes"]
    assert 0 < fetched < scatter["bytes"]


# -- the kernels on meta -----------------------------------------------------


def _meta(*tensors):
    return [t.to(META) for t in tensors]


def _same(meta_out, plain_out):
    meta_out = meta_out if isinstance(meta_out, tuple) else (meta_out,)
    plain_out = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    assert len(meta_out) == len(plain_out)
    for m, p in zip(meta_out, plain_out):
        assert m.is_meta
        assert (m.shape, m.dtype) == (p.shape, p.dtype)


def _paged_inputs(B=3, KV=2, G=2, D=16, ps=4, n_pages=5):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, n_pages * ps, B).astype(np.int32)
    table = np.zeros((B, n_pages), np.int32)
    nxt = 1
    for b in range(B):
        need = -(-int(lens[b]) // ps)
        table[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    P = nxt
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return (f(B, 1, KV * G, D), f(P, KV, ps, D), f(P, KV, ps, D),
            torch.from_numpy(table), torch.from_numpy(lens),
            f(B, KV, 1, D), f(B, KV, 1, D))


def _ssd_inputs(BC=2, H=3, Q=8, P=4, N=5):
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(BC, H, Q, P), f(BC, H, Q, 1).abs(), -f(BC, H, Q, 1).abs(), \
        f(BC, Q, N), f(BC, Q, N)


def _jacobi_inputs(n=37):
    A = torch.eye(n) * 3 + 0.01
    return A, torch.ones(n), torch.ones(n), A.diagonal().contiguous()


def _case_paged():
    ins = _paged_inputs()
    return (paged_attention.paged_decode_attention(*_meta(*ins)),
            paged_attention.paged_decode_attention_ref(*ins))


def _case_ssd():
    ins = _ssd_inputs()
    return (ssd_scan.ssd_intra_chunk(*_meta(*ins)),
            ssd_scan.ssd_intra_chunk_plain(*ins))


def _case_jacobi():
    ins = _jacobi_inputs()
    return (jacobi_sweep.jacobi_sweep(*_meta(*ins)),
            jacobi_sweep.jacobi_sweep_plain(*ins))


def _case_jacobi_residual():
    ins = _jacobi_inputs()
    return (jacobi_sweep.jacobi_sweep_residual(*_meta(*ins)),
            jacobi_sweep.jacobi_sweep_residual(*ins))


def _flash_inputs():
    rng = np.random.default_rng(2)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(2, 12, 4, 16), f(2, 12, 2, 16), f(2, 12, 2, 16)


def _case_flash():
    ins = _flash_inputs()
    return (flash_attention.flash_attention(*_meta(*ins)),
            flash_attention.flash_attention(*ins))


def _case_flash_backward():
    def grads(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = flash_attention.flash_attention(q, k, v)
        (out ** 2).sum().backward()
        return q.grad, k.grad, v.grad
    ins = _flash_inputs()
    return grads(*_meta(*ins)), grads(*ins)


def _case_rmsnorm():
    x, g = torch.ones(7, 24), torch.ones(24)
    return (rmsnorm.rmsnorm(*_meta(x, g)), rmsnorm.rmsnorm_plain(x, g))


KERNEL_CASES = {"paged_attention": _case_paged, "ssd_intra_chunk": _case_ssd,
                "jacobi_sweep": _case_jacobi,
                "jacobi_sweep_residual": _case_jacobi_residual,
                "flash_attention": _case_flash,
                "flash_attention_bwd": _case_flash_backward,
                "rmsnorm": _case_rmsnorm}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_meta_outputs_match_the_plain_version(name):
    """On meta tensors ``auto`` takes the kernel path, which records its
    cost and returns the kernel's outputs without building or
    launching."""
    launches = {m: _launch_count(m) for m in _KERNEL_MODULES}
    with OpCounter() as c:
        got, want = KERNEL_CASES[name]()
    _same(got, want)
    assert c.analysis().by_op[f"kernel:{name}"]["calls"] >= 1
    assert {m: _launch_count(m) for m in _KERNEL_MODULES} == launches


_KERNEL_MODULES = (paged_attention.kernel, ssd_scan.kernel,
                   jacobi_sweep.kernel, flash_attention.kernel,
                   rmsnorm.kernel)


def _launch_count(mod):
    n = mod.launches
    return sum(n.values()) if isinstance(n, dict) else n


def test_auto_resolves_to_the_kernel_on_meta_only():
    assert resolve_impl("auto", META) == "kernel"
    assert resolve_impl("kernel", META) == "kernel"
    assert resolve_impl("auto", "cpu") == "ref"
    with pytest.raises(ValueError, match="needs CUDA"):
        resolve_impl("kernel", "cpu")
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention.flash_attention(*_flash_inputs(), impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm.kernel.rmsnorm_kernel(torch.ones(2, 8), torch.ones(8),
                                      eps=1e-6, row_block=1)


# -- cost() against chip_smoke.py's old formulas ------------------------------
# (the bound functions as chip_smoke.py had them before they read cost())


def _old_paged_bound(pages, kv_len, *, B, KV, G, D, ps, window, elt):
    tbl = pages.cpu().numpy()
    lens = kv_len.cpu().numpy()
    n_read = n_run = 0
    for b in range(B):
        for j in range(tbl.shape[1]):
            if j * ps >= lens[b]:
                break
            if window is not None and (j + 1) * ps - 1 < lens[b] + 1 - window:
                continue
            n_run += 1
            n_read += int(tbl[b, j] != 0)
    nbytes = (2 * n_read * KV * ps * D * elt + n_run * 4 + B * KV * G * D * elt
              + B * 4 + B * KV * G * (D + 2) * 4)
    flops = 4 * n_run * KV * G * ps * D
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _old_ssd_bound(BC, H, Q, P, N):
    nbytes = 4 * BC * (2 * H * Q * P + 2 * H * Q + 2 * Q * N + H * N * P)
    causal = Q * (Q + 1) // 2
    flops = BC * (causal * 2 * N
                  + H * (causal * (2 * P + 3) + Q * (2 * N * P + N + 3)))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _old_jacobi_bound(inputs, outputs):
    n = inputs[0].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * n / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _old_visible_pairs(S, T, causal, window) -> int:
    i = np.arange(S)
    hi = np.minimum(i + 1, T) if causal else np.full(S, T)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def _old_bound(flops, nbytes, dtype) -> dict:
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "flops": flops, "bytes": nbytes}


def _old_fa_bound(B, S, T, H, KV, D, causal, window, dtype) -> dict:
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 4 * B * H * D * _old_visible_pairs(S, T, causal, window)
    nbytes = (2 * B * S * H * D + 2 * B * T * KV * D) * elt + B * H * S * 4
    return _old_bound(flops, nbytes, dtype)


def _old_fa_bwd_bound(B, S, T, H, KV, D, causal, window, dtype) -> dict:
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 10 * B * H * D * _old_visible_pairs(S, T, causal, window)
    nbytes = (4 * B * S * H * D + 4 * B * T * KV * D) * elt + B * H * S * 4
    return {f"bwd_{k}": v for k, v in _old_bound(flops, nbytes, dtype).items()}


def _old_rms_bound(R, d, elt):
    t_bytes = (2 * R * d * elt + 4 * d) / H100_BYTES_PER_S * 1e3
    t_ops = 4.0 * R * d / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serving_table(B, n_pages, ps, lens, trash_every=0):
    table = np.zeros((B, n_pages), np.int32)
    nxt = 1
    for b in range(B):
        need = -(-int(lens[b]) // ps)
        table[b, :need] = np.arange(nxt, nxt + need)
        if trash_every:
            table[b, :need:trash_every] = 0
        nxt += need
    return torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32)


# PERF.md §6's shapes: qwen2-1.5b's decode (and at TP=2), gemma3-4b's with
# and without its window, qwen2-moe's and zamba2's
PAGED_SHAPES = [
    dict(B=8, KV=2, G=6, D=128, ps=16, n_pages=128, window=None, elt=2),
    dict(B=8, KV=1, G=6, D=128, ps=16, n_pages=96, window=None, elt=2),
    dict(B=8, KV=4, G=2, D=256, ps=16, n_pages=96, window=1024, elt=2),
    dict(B=8, KV=4, G=2, D=256, ps=16, n_pages=96, window=None, elt=4),
    dict(B=8, KV=16, G=1, D=128, ps=16, n_pages=128, window=None, elt=2),
    dict(B=8, KV=32, G=1, D=64, ps=16, n_pages=128, window=None, elt=2),
]


@pytest.mark.parametrize("shape", PAGED_SHAPES,
                         ids=[f"paged{i}" for i in range(len(PAGED_SHAPES))])
@pytest.mark.parametrize("trash_every", [0, 5])
def test_paged_cost_gives_the_old_bound(shape, trash_every, chip_smoke):
    shape = dict(shape)
    n_pages = shape.pop("n_pages")
    lens = np.linspace(1000, 1500, shape["B"]).astype(np.int32)
    pages, kv_len = _serving_table(shape["B"], n_pages, shape["ps"], lens,
                                   trash_every)
    old = _old_paged_bound(pages, kv_len, **shape)
    assert chip_smoke.bound_ms(pages, kv_len, **shape) == old
    c = paged_attention.cost(pages, kv_len, **shape)
    t_bytes = c["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = c["flops"] / H100_FP32_FLOPS * 1e3
    assert max(t_bytes, t_ops) == old[0]


# llama3-405b's decode with e4m3 pools (with and without a window of 512),
# and the same work with an fp32 q: G 16 makes 32 operations a pool byte
@pytest.mark.parametrize("elt,window,by", [
    (2, None, "bytes"), (2, 512, "bytes"), (4, None, "operations")])
def test_paged_bound_takes_the_peak_of_qs_type(elt, window, by, chip_smoke):
    shape = dict(B=8, KV=8, G=16, D=128, ps=16, window=window, elt=elt,
                 kv_elt=1)
    lens = np.linspace(1000, 1500, 8).astype(np.int32)
    pages, kv_len = _serving_table(8, 96, 16, lens, 0)
    c = paged_attention.cost(pages, kv_len, **shape)
    peak = H100_BF16_FLOPS if elt == 2 else H100_FP32_FLOPS
    t_bytes = c["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = c["flops"] / peak * 1e3
    assert chip_smoke.bound_ms(pages, kv_len, **shape) == (max(t_bytes,
                                                               t_ops), by)


def test_paged_cost_on_meta_reads_every_page():
    B, n_pages, ps = 4, 10, 16
    shape = dict(B=B, KV=2, G=3, D=64, ps=ps, window=None, elt=2)
    full = [n_pages * ps] * B
    pages, kv_len = _serving_table(B, n_pages, ps, full)
    assert paged_attention.cost(pages.to(META), kv_len.to(META),
                                **shape) == paged_attention.cost(
        pages, kv_len, **shape)


SSD_SHAPES = [(1, 32, 256, 64, 128), (8, 32, 256, 64, 128),
              (1, 32, 16, 64, 128), (1, 64, 256, 64, 64),
              (2, 16, 256, 64, 128)]


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_cost_gives_the_old_bound(shape, chip_smoke):
    assert chip_smoke.ssd_bound_ms(*shape) == _old_ssd_bound(*shape)


@pytest.mark.parametrize("n", [2709, 4209, 7209, 333])
@pytest.mark.parametrize("a_dtype,x_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("fused", [False, True])
def test_jacobi_cost_gives_the_old_bound(n, a_dtype, x_dtype, fused,
                                         chip_smoke):
    ins = (torch.empty((n, n), dtype=a_dtype, device=META),
           torch.empty(n, dtype=x_dtype, device=META),
           torch.empty(n, device=META),
           torch.empty(n, dtype=a_dtype, device=META))
    outs = (torch.empty(n, dtype=x_dtype, device=META),)
    if fused:
        outs += (torch.empty(jacobi_sweep.kernel.n_blocks(n), device=META),)
    assert chip_smoke.jacobi_bound_ms(ins, outs) == _old_jacobi_bound(ins,
                                                                      outs)


# B, S, T, H, KV, D, causal, window: the training shape, its shards, the
# dense engine's prefill, gemma3's and whisper's shapes (PERF.md §6)
FA_SHAPES = [
    (2, 4096, 4096, 12, 2, 128, True, None),
    (2, 4096, 4096, 6, 1, 128, True, None),
    (1, 4096, 4096, 12, 2, 128, True, None),
    (8, 1024, 1024, 16, 16, 128, True, None),
    (8, 2048, 2048, 8, 4, 256, True, None),
    (8, 2048, 2048, 8, 4, 256, True, 1024),
    (8, 1500, 1500, 8, 8, 64, False, None),
    (8, 64, 1500, 8, 8, 64, False, None),
    (2, 1000, 1000, 12, 2, 128, True, 256),
]


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_cost_gives_the_old_bounds(shape, dtype, chip_smoke):
    assert chip_smoke.fa_bound(*shape, dtype) == _old_fa_bound(*shape, dtype)
    assert chip_smoke.fa_bwd_bound(*shape, dtype) == _old_fa_bwd_bound(
        *shape, dtype)


@pytest.mark.parametrize("R,d,elt", [(4096, 1024, 4), (8192, 1536, 2),
                                     (1000, 1536, 2), (64, 16384, 2),
                                     (7, 200, 4), (5, 203, 4)])
def test_rmsnorm_cost_gives_the_old_bound(R, d, elt, chip_smoke):
    assert chip_smoke.rms_bound_ms(R, d, elt) == _old_rms_bound(R, d, elt)


# -- against the JAX package: matmul flops of a forward ---------------------


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               param_dtype="float32")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "qwen2-moe-a2.7b", "whisper-base",
                                  "zamba2-1.2b", "gemma3-4b"])
def test_matmul_flops_match_analyze_hlo(arch):
    """The counted matmul flops of the port's smoke forward (fp32, plain
    attention and plain SSD) equal ``analyze_hlo``'s flops of the JAX
    package's compiled forward: the two run the same products."""
    jcfg, cfg = _fp32(jax_smoke(arch)), _fp32(get_smoke_config(arch))
    B, S, T = 2, 32, 16
    enc = (B, T, cfg.d_model) if cfg.family == "encdec" else None
    jparams = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                             jax.random.PRNGKey(0))

    def jfwd(p, t, e):
        return jax_forward(jcfg, p, tokens=t, enc_embeds=e, impl="dense")[0]

    compiled = jax.jit(jfwd).lower(
        jparams, jax.ShapeDtypeStruct((B, S), jnp.int32),
        None if enc is None else jax.ShapeDtypeStruct(enc, jnp.float32)
    ).compile()
    want = analyze_hlo(compiled.as_text()).flops
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), OpCounter() as c:
        forward(cfg, params, tokens=torch.zeros((B, S), dtype=torch.int64),
                enc_embeds=None if enc is None else torch.zeros(enc),
                impl="ref")
    assert c.analysis().matmul_flops == pytest.approx(want, rel=1e-6)
    assert want > 0


def test_meta_and_cpu_traces_count_the_same_matmuls():
    cfg = _fp32(get_smoke_config("qwen2-1.5b"))
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    flops = []
    for device in ("cpu", META):
        params = init_params(cfg, None if device == META
                             else torch.Generator().manual_seed(0), device)
        with torch.no_grad(), OpCounter() as c:
            forward(cfg, params, tokens=tokens.to(device), impl="ref")
        flops.append(c.analysis().matmul_flops)
    assert flops[0] == flops[1] > 0
    assert math.isfinite(flops[0])


def test_the_backward_all_reduces_each_shard_input_gradient():
    """Under grad, every shard's input gradient is summed over the
    shards: one all-reduce of (B, S, d) a position for each attention and
    MLP split, paired with the forward's (no remat here: a recompute
    runs the forward's sums again)."""
    cfg = dataclasses.replace(_qwen2_fp32(), remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    B, S = 2, 16
    tokens = torch.zeros((B, S), dtype=torch.int64)
    with OpCounter(2) as c:
        logits, _ = forward(cfg, params, tokens=tokens,
                            tp_devices=["cpu", "cpu"])
        logits.float().square().mean().backward()
    sites = {site: d["bytes"] for (_, site), d in c.analysis().by_site.items()}
    act = B * S * cfg.d_model * 4
    assert sites["attention_tp_grad"] == sites["attention_tp"]
    assert sites["mlp_tp_grad"] == sites["mlp_tp"] == (
        2 * cfg.n_layers * 2 * act)
    # the final norm's output, read by both vocab shards
    assert sites["unembed_tp_grad"] == 2 * 2 * act
    p0, p1 = c.analysis().positions
    assert p0.collectives.bytes_by_kind == p1.collectives.bytes_by_kind
