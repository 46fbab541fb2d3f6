"""The port's serving mesh (``repro_torch.serve.mesh``, ``PagedEngine(
mesh=)``, ``launch.serve --mesh``) on the CPU, where every grid position is
the CPU.

The reference's mesh tests (``tests/test_serve_sharded.py``,
``tests/_sharded_driver.py``) held on the port: ``MeshSpec`` parsing, a
mesh of size 1 bit-identical to no mesh, and ``_sharded_driver.py``'s
trace (batch 2, ``max_len`` 64, page 8, 26 pages, chunk 16, 4 requests of
12 tokens, 6 new, fp32) at TP=2, DP=2 and TP=2 x DP=2 with token streams
identical to the meshless engine's, TP=2 halving the per-position pool
bytes and no group leaking a page.  Then against the JAX package: one
subprocess runs the reference's ``PagedEngine(mesh=…)`` on 4 forced host
devices (qwen2, mamba2, and the MoE models qwen2-moe and mixtral, whose
experts and vocabulary the port splits at TP=2), and its streams and TP=2
pool bytes must be the port's on the JAX package's weights.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import (_blocks, chunk_prefill_step,
                                            decode_step)
from repro_torch.serve import PagedEngine, SamplingParams, ServeScheduler
from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (1, 2), (2, 2)]          # (tp, dp)


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """The JAX package's smoke weights (PRNGKey 0, fp32 compute) in the
    port's layout, by arch."""
    made = {}

    def get(arch):
        if arch not in made:
            jc = _fp32(jax_smoke(arch))
            tc = _fp32(get_smoke_config(arch))
            jp = jax.tree.map(np.asarray, jax_init(jc, jax.random.PRNGKey(0)))
            made[arch] = tc, from_jax_numpy(jp, tc, "cpu")
        return made[arch]
    return get


def _mesh(tp, dp):
    return build_serve_mesh(MeshSpec(tp=tp, dp=dp), device="cpu")


def run_variant(cfg, params, mesh, *, device_groups=1, batch=2,
                num_pages=26, prefix_cache=False, shared=0):
    """``tests/_sharded_driver.py``'s trace through the port (``shared`` > 0
    opens every prompt with one shared prefix, for the prefix cache)."""
    eng = PagedEngine(cfg, params, batch=batch, max_len=64, page_size=8,
                      num_pages=num_pages, prefill_chunk=16, mesh=mesh,
                      device="cpu")
    sched = ServeScheduler(eng, sp=SamplingParams(), reserve="demand",
                           admit_watermark=1, device_groups=device_groups,
                           prefix_cache=prefix_cache)
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 50, shared).astype(np.int32)
    for _ in range(2 * batch):
        p = rng.integers(1, 50, 12).astype(np.int32)
        sched.submit(np.concatenate([prefix, p]) if shared else p, 6)
    toks = [tuple(int(t) for t in r.tokens)
            for r in sorted(sched.run(), key=lambda r: r.rid)]
    if prefix_cache:
        sched.flush_prefix_cache()
    assert all(g.allocator.n_outstanding == 0 for g in sched.groups), \
        "a group leaked pages after the drain"
    return toks, eng.per_device_pool_bytes(), eng, sched


# ---------------------------------------------------------------------------
# mesh spec and grid
# ---------------------------------------------------------------------------


def test_mesh_spec_parse():
    assert MeshSpec.parse("2,1") == MeshSpec(tp=2, dp=1)
    assert MeshSpec.parse(" 1 , 2 ") == MeshSpec(tp=1, dp=2)
    assert MeshSpec.parse("1,1").size == 1
    for bad in ("2", "2,2,2", "a,b", "0,1", "1,-1"):
        with pytest.raises(ValueError):
            MeshSpec.parse(bad)


def test_cuda_mesh_needs_devices_or_raises():
    """No silent fallback: a CUDA mesh on a machine with fewer CUDA
    devices raises and names ``devices=``; so does a CUDA device that is
    not there."""
    if torch.cuda.is_available():
        pytest.skip("wants a machine without CUDA devices")
    with pytest.raises(ValueError, match="devices="):
        build_serve_mesh(MeshSpec(tp=2, dp=1))
    with pytest.raises(ValueError, match="not available"):
        build_serve_mesh(MeshSpec(tp=1, dp=1), devices=["cuda:0"])


@pytest.mark.parametrize("tp,dp", [(1, 1), (2, 1), (1, 4), (4, 2)])
def test_cpu_mesh_of_any_size_builds(tp, dp):
    mesh = _mesh(tp, dp)
    assert mesh.shape == {"data": dp, "model": tp}
    assert mesh.axis_names == ("data", "model")
    assert len(mesh.devices) == dp and all(len(r) == tp
                                           for r in mesh.devices)
    assert mesh.unique_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs"):
        build_serve_mesh(MeshSpec(tp=tp, dp=dp),
                         devices=["cpu"] * (tp * dp + 1))


def test_engine_refuses_a_device_the_mesh_does_not_start_with(models):
    cfg, params = models("qwen2-1.5b")
    mesh = build_serve_mesh(MeshSpec(1, 1), devices=["meta"])
    with pytest.raises(ValueError, match="disagrees"):
        PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                    prefill_chunk=16, mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# a mesh of size 1 is no mesh (reference test_serve_sharded.py:248-279)
# ---------------------------------------------------------------------------


def test_mesh_of_one_is_bit_identical(models):
    cfg, params = models("qwen2-1.5b")

    def drive(mesh):
        eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                          num_pages=25, prefill_chunk=16, mesh=mesh,
                          device="cpu")
        rng = np.random.default_rng(3)
        prompt = rng.integers(1, 50, 12).astype(np.int32)
        pages = list(range(1, 1 + eng.pages_needed(12, 4)))
        logits = [eng.insert(0, prompt, page_ids=pages, max_new=4).numpy()]
        tok = np.argmax(logits[-1][0, -1])
        for _ in range(4):
            step = np.full((eng.batch, 1), int(tok), np.int32)
            out = eng.decode(step, live_mask=np.array([True, False]))
            logits.append(out.numpy())
            tok = np.argmax(logits[-1][0, -1])
        return logits, eng.per_device_pool_bytes()

    ref, ref_bytes = drive(None)
    one, one_bytes = drive(_mesh(1, 1))
    for a, b in zip(ref, one):
        np.testing.assert_array_equal(a, b)
    assert one_bytes == ref_bytes


def test_meshless_engine_is_one_row_on_the_weights_storage(models):
    """No mesh: one row of every slot and page on the engine's device, and
    one shard whose attention weights are the row's own tensors (no
    copy); the paged steps refuse to run the attention layers without
    their shards."""
    cfg, params = models("qwen2-1.5b")
    eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                      num_pages=25, prefill_chunk=16, device="cpu")
    (row,) = eng.rows
    assert (row.slots, row.pages) == (range(0, 2), range(1, 25))
    assert row.devices == (torch.device("cpu"),) and eng.mesh is None
    (shard,) = row.shards
    attn = [p["attn"] for kind, p in _blocks(cfg, row.params)]
    assert len(attn) == len(shard.attn) == cfg.n_layers
    for a, b in zip(attn, shard.attn):
        assert all(x is y for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert shard.cfg is cfg
    eng.ensure_batch()
    assert "k" not in row.cache and shard.k.shape[2] == cfg.n_kv_heads
    pages = torch.zeros((2, eng.max_pages), dtype=torch.int32)
    with pytest.raises(ValueError, match="pass shards"):
        decode_step(cfg, row.params, row.cache,
                    torch.zeros((2, 1), dtype=torch.int32), pages=pages,
                    page_size=8)
    with pytest.raises(ValueError, match="pass shards"):
        chunk_prefill_step(cfg, row.params, row.cache,
                           torch.zeros((1, 16), dtype=torch.int32), slot=0,
                           start=0, valid_len=16, pages_row=pages[:1],
                           page_size=8)


def test_tp_lead_holds_no_whole_attention_weight(models):
    """TP=2 x DP=2: each row's lead keeps the model without its attention
    weights (the shards hold them, half the heads each, with o's bias on
    shard 0 alone), so no position holds a whole layer's q/k/v/o."""
    cfg, params = models("qwen2-1.5b")
    eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                      num_pages=26, prefill_chunk=16, mesh=_mesh(2, 2),
                      device="cpu")
    hd = cfg.hd
    for row in eng.rows:
        assert all("attn" not in p for _, p in _blocks(cfg, row.params))
        assert "mlp" in row.params["layers"][0]
        assert [sh.cfg.n_heads for sh in row.shards] == [cfg.n_heads // 2] * 2
        for sh in row.shards:
            for layer in sh.attn:
                assert layer["q"]["w"].shape == (cfg.d_model,
                                                 cfg.n_heads // 2 * hd)
                assert layer["k"]["w"].shape == (cfg.d_model,
                                                 cfg.n_kv_heads // 2 * hd)
                assert layer["o"]["w"].shape == (cfg.n_heads // 2 * hd,
                                                 cfg.d_model)
                assert ("b" in layer["o"]) == (
                    sh is row.shards[0] and "b" in params["layers"][0]
                    ["attn"]["o"])
    # the caller's parameters keep every weight
    assert all("attn" in p for _, p in _blocks(cfg, params))


# ---------------------------------------------------------------------------
# ``tests/_sharded_driver.py``'s trace at TP=2, DP=2 and TP=2 x DP=2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "zamba2-1.2b", "gemma3-4b",
                                  "qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_mesh_streams_equal_the_meshless_streams(models, arch):
    """``_sharded_driver.py``'s trace; gemma3 adds the shared qk-norm scales
    and local windows to the split, qwen2-moe the split biases beside the
    experts split by ``experts`` (and a shared expert on the lead),
    mixtral its experts split and its window, zamba2 its shared block's
    invocations; every model's vocabulary splits at TP=2."""
    cfg, params = models(arch)
    base, base_bytes, _, _ = run_variant(cfg, params, None)
    for tp, dp in MESHES:
        toks, nbytes, eng, sched = run_variant(cfg, params, _mesh(tp, dp),
                                               device_groups=dp)
        assert toks == base, f"{arch} TP={tp} DP={dp} streams diverged"
        assert len(sched.groups) == dp
        if tp == 2 and dp == 1:
            assert 2 * nbytes == base_bytes       # 0 for mamba2: no pools
        assert eng.total_pool_bytes() >= base_bytes
        assert eng.probe_device() and all(eng.probe_device(group=g)
                                          for g in range(dp))


def test_tp_that_does_not_divide_kv_keeps_the_whole_pool(models):
    """qwen2 smoke has 2 KV heads: TP=4 drops ``kv_heads``, so one
    position holds the whole pool and runs every head."""
    cfg, params = models("qwen2-1.5b")
    assert cfg.n_kv_heads == 2
    base, base_bytes, _, _ = run_variant(cfg, params, None)
    toks, nbytes, eng, _ = run_variant(cfg, params, _mesh(4, 1))
    assert toks == base
    assert nbytes == base_bytes == eng.total_pool_bytes()
    assert [len(row.shards) for row in eng.rows] == [1]


def test_dp_rows_hold_their_groups_pages(models):
    """DP=2: each row's pools hold its group's page range plus a local
    trash page (26 pages: rows of 1 + 13 and 1 + 12), and the prefix
    cache's shared pages and copy-on-write stay inside a row; streams
    equal the meshless engine's with the prefix cache on."""
    cfg, params = models("qwen2-1.5b")
    base, _, _, _ = run_variant(cfg, params, None, batch=4, num_pages=40,
                                shared=16)
    toks, _, eng, sched = run_variant(cfg, params, _mesh(1, 2),
                                      device_groups=2, batch=4,
                                      num_pages=40, prefix_cache=True,
                                      shared=16)
    assert toks == base
    assert sched.n_prefix_hits > 0
    assert [(r.pages.start, r.pages.stop) for r in eng.rows] == [(1, 21),
                                                                 (21, 40)]
    assert [r.shards[0].k.shape[1] for r in eng.rows] == [21, 20]
    with pytest.raises(ValueError, match="crosses mesh rows"):
        eng.copy_page(3, 30)
    with pytest.raises(ValueError, match="outside its mesh row"):
        eng.commit_slot(0, [25])


def test_scheduler_groups_must_be_the_mesh_rows(models):
    """device_groups must equal dp, and ``pool_pages`` may shrink the
    groups' page ranges but not move them out of their rows."""
    cfg, params = models("qwen2-1.5b")
    eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                      num_pages=26, prefill_chunk=16, mesh=_mesh(1, 2),
                      device="cpu")
    with pytest.raises(ValueError, match="device_groups=2"):
        ServeScheduler(eng, sp=SamplingParams(), device_groups=1)
    with pytest.raises(ValueError, match="pool_pages"):
        ServeScheduler(eng, sp=SamplingParams(), device_groups=2,
                       pool_pages=20)
    ServeScheduler(eng, sp=SamplingParams(), device_groups=2, pool_pages=26)
    tp = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                     num_pages=26, prefill_chunk=16, mesh=_mesh(2, 1),
                     device="cpu")
    ServeScheduler(tp, sp=SamplingParams(), pool_pages=20)


# ---------------------------------------------------------------------------
# against the JAX package's mesh (4 forced host devices, one subprocess)
# ---------------------------------------------------------------------------

JAX_RUNS = [("qwen2-1.5b", 2, 1), ("qwen2-1.5b", 1, 2),
            ("qwen2-1.5b", 2, 2), ("mamba2-370m", 1, 2)] + [
    (arch, tp, dp) for arch in ("qwen2-moe-a2.7b", "mixtral-8x7b")
    for tp, dp in MESHES]

JAX_DRIVER = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, json, sys
    import jax
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.models.transformer import init_params
    from repro.serve import PagedEngine, SamplingParams, ServeScheduler
    from repro.serve.mesh import MeshSpec, build_serve_mesh

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    for arch, tp, dp in json.loads(sys.argv[1]):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                          num_pages=26, prefill_chunk=16,
                          mesh=build_serve_mesh(MeshSpec(tp=tp, dp=dp)))
        sched = ServeScheduler(eng, sp=SamplingParams(), reserve="demand",
                               admit_watermark=1, device_groups=dp)
        rng = np.random.default_rng(7)
        for _ in range(4):
            sched.submit(rng.integers(1, 50, 12).astype(np.int32), 6)
        toks = [[int(t) for t in r.tokens]
                for r in sorted(sched.run(), key=lambda r: r.rid)]
        out[f"{arch} {tp},{dp}"] = {
            "streams": toks,
            "per_device_pool_bytes": int(eng.per_device_pool_bytes())}
    print("JAX_MESH", json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_mesh_runs():
    r = subprocess.run(
        [sys.executable, "-c", JAX_DRIVER, json.dumps(JAX_RUNS)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("JAX_MESH")]
    assert lines, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(lines[-1].split(" ", 1)[1])


@pytest.mark.parametrize("arch,tp,dp", JAX_RUNS,
                         ids=[f"{a}-tp{t}-dp{d}" for a, t, d in JAX_RUNS])
def test_mesh_streams_equal_the_jax_packages(models, jax_mesh_runs, arch,
                                             tp, dp):
    cfg, params = models(arch)
    toks, nbytes, _, _ = run_variant(cfg, params, _mesh(tp, dp),
                                     device_groups=dp)
    want = jax_mesh_runs[f"{arch} {tp},{dp}"]
    assert [list(t) for t in toks] == want["streams"]
    if dp == 1:          # TP: the reference's pool bytes exactly
        assert nbytes == want["per_device_pool_bytes"]


# ---------------------------------------------------------------------------
# the launcher's --mesh
# ---------------------------------------------------------------------------

LAUNCH = ["--smoke", "--device", "cpu", "--trace", "--paged",
          "--prefill-chunk", "32", "--n-requests", "4", "--prompt-lens",
          "6", "12", "40", "--max-new", "4"]


@pytest.mark.parametrize("mesh,groups", [("2,1", 1), ("2,2", 2)])
def test_launcher_serves_on_a_mesh(capsys, mesh, groups):
    stats = launch_serve.main(LAUNCH + ["--mesh", mesh])
    assert stats["mesh"] == mesh and stats["device_groups"] == groups
    assert stats["n_requests"] == 4
    total, per_dev = stats["total_pool_bytes"], stats["per_device_pool_bytes"]
    if mesh == "2,1":
        assert 2 * per_dev == total
    # the default pool: 1 + batch 4 x 4 pages of 16 (max_len 40 + 4 + 8)
    pool_tokens = (1 + 4 * 4) * 16
    assert stats["kv_budget_tokens"] == round(pool_tokens * per_dev / total)
    assert stats["kv_budget_tokens"] == {"2,1": 136, "2,2": 68}[mesh]
    assert f"mesh={mesh} groups={groups}" in capsys.readouterr().out


def test_launcher_refuses_a_mesh_without_paged(capsys):
    """``--mesh`` larger than 1 needs ``--paged``, as in the reference; a
    size-1 ``--mesh`` without it builds no mesh and reports none."""
    with pytest.raises(SystemExit):
        launch_serve.main(["--smoke", "--device", "cpu", "--trace",
                           "--mesh", "2,1"])
    assert "requires --paged" in capsys.readouterr().err
    stats = launch_serve.main([a for a in LAUNCH if a != "--paged"]
                              + ["--mesh", "1,1"])
    assert stats["mesh"] is None and not stats["paged"]
    assert "mesh=" not in capsys.readouterr().out
