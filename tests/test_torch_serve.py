"""The port's serving stack against the JAX package's, on the CPU.

The same request trace — greedy, submitted up front, drained with
``run()`` — goes through the JAX ``ServeScheduler(PagedEngine(...,
attn_impl="ref"))`` and through the port's, on the smoke configs
``qwen2-1.5b-smoke`` and ``mamba2-370m-smoke`` at fp32 compute with the
JAX weights carried over.  Per-request token streams and terminal
outcomes must be IDENTICAL, for full-lifetime reservation and
reserve-on-demand with a pool small enough to preempt (both models), and
the prefix cache with a shared prompt prefix (qwen2; an SSM model keeps
it off).  Also the host-side units (chunk planning, the page allocator)
and the launcher.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import init_params as jax_init
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import (Engine, PageAllocator, PagedEngine,
                               ServeScheduler, chunk_buckets_for, chunk_plan)
from repro_torch.weights import from_jax_numpy


def _models(arch):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


@pytest.fixture(scope="module")
def arch_models():
    """Models by arch, made on first use and shared by the module."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _models(arch)
        return made[arch]
    return get


@pytest.fixture(scope="module")
def models(arch_models):
    return arch_models("qwen2-1.5b")


@pytest.fixture(scope="module")
def arch_engines(arch_models):
    """One engine per side and arch, shared by the traces (a drained
    scheduler leaves every table row on the trash page; the JAX engine
    keeps its compiled programs)."""
    made = {}

    def get(arch):
        if arch not in made:
            jc, tc, jp, tp = arch_models(arch)
            kw = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)
            made[arch] = (JaxPagedEngine(jc, jp, attn_impl="ref", **kw),
                          PagedEngine(tc, tp, device="cpu", **kw))
        return made[arch]
    return get


def _trace(seed, vocab, lens, shared_prefix=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab - 1, (shared_prefix,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        0, vocab - 1, (n - shared_prefix,)).astype(np.int32)]) for n in lens]


CONFIGS = {
    "lifetime": dict(sched={}, lens=(5, 40, 12, 23, 33, 9), max_new=8),
    # 10 usable pages for 3 slots of up to 8 pages each: demand admission
    # has to preempt and resume by recompute
    "demand_preempt": dict(sched=dict(reserve="demand", pool_pages=1 + 10),
                           lens=(20, 30, 12, 25), max_new=14),
    "prefix_cache": dict(sched=dict(prefix_cache=True),
                         lens=(40, 37, 45, 33, 41), max_new=6,
                         shared_prefix=32),
}
# the SSM model: per-slot state under the live mask, rebuilt from zeros on
# every (re)prefill, through both reservation modes
CONFIGS.update({f"mamba2_{name}": dict(CONFIGS[name], arch="mamba2-370m")
                for name in ("lifetime", "demand_preempt")})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheduler_token_streams_match_jax(arch_models, arch_engines, name):
    conf = CONFIGS[name]
    arch = conf.get("arch", "qwen2-1.5b")
    jc = arch_models(arch)[0]
    engines = arch_engines(arch)
    prompts = _trace(3, jc.vocab_size, conf["lens"],
                     conf.get("shared_prefix", 0))

    def drain(sched):
        rids = [sched.submit(p, max_new=conf["max_new"]) for p in prompts]
        assert all(r is not None for r in rids)
        tokens = {r.rid: r.tokens for r in sched.run()}
        outcomes = {rid: (o.outcome, o.detail)
                    for rid, o in sched.outcomes.items()}
        counters = (sched.n_preempted, sched.resume_tokens_recomputed,
                    sched.n_prefix_hits, sched.pages_shared)
        return tokens, outcomes, counters

    want = drain(JaxServeScheduler(engines[0], **conf["sched"]))
    got = drain(ServeScheduler(engines[1], **conf["sched"]))
    assert got == want
    tokens, outcomes, (n_preempted, _, n_hits, _) = got
    assert len(tokens) == len(prompts)
    assert all(len(t) == conf["max_new"] for t in tokens.values())
    assert {o for o, _ in outcomes.values()} == {"completed"}
    if name.endswith("demand_preempt"):
        assert n_preempted > 0
    if name == "prefix_cache":
        assert n_hits > 0


def test_scheduler_refuses_what_is_not_ported(models):
    """The scheduler's refusals are the reference's: device groups, the
    chaos harness, the watchdog and the restart budget are accepted, and
    out-of-range values of their knobs raise the JAX package's errors with
    its messages.  The engine's ``mesh=`` takes a ``ServeMesh`` and
    refuses anything else."""
    from repro.core.fault import ServeChaosInjector as JaxChaos
    from repro_torch.core.fault import ServeChaosInjector

    jc, tc, jp, tp = models
    kw = dict(batch=2, max_len=32, page_size=8, prefill_chunk=16)
    eng = PagedEngine(tc, tp, device="cpu", **kw)
    jeng = JaxPagedEngine(jc, jp, attn_impl="ref", **kw)
    sched = ServeScheduler(eng, chaos=ServeChaosInjector(), device_groups=2,
                           watchdog_budget_s=1.0, max_restarts=2,
                           unhealthy_after=1, probe_interval_steps=1,
                           rejoin_backoff_cap=1)
    jsched = JaxServeScheduler(jeng, chaos=JaxChaos(), device_groups=2,
                               watchdog_budget_s=1.0, max_restarts=2,
                               unhealthy_after=1, probe_interval_steps=1,
                               rejoin_backoff_cap=1)
    assert ([(g.slot_ids, g.page_lo, g.page_hi) for g in sched.groups]
            == [(g.slot_ids, g.page_lo, g.page_hi) for g in jsched.groups])
    for bad in (dict(device_groups=0), dict(device_groups=3),
                dict(watchdog_budget_s=0.0), dict(unhealthy_after=0),
                dict(probe_interval_steps=0), dict(rejoin_backoff_cap=0),
                dict(max_restarts=-1),
                dict(reserve="lifetime", admit_watermark=2)):
        with pytest.raises(ValueError) as want:
            JaxServeScheduler(jeng, **bad)
        with pytest.raises(ValueError) as got:
            ServeScheduler(eng, **bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="ServeMesh"):
        PagedEngine(tc, tp, device="cpu", mesh=object(), **kw)
    from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
    PagedEngine(tc, tp, device="cpu", **kw,
                mesh=build_serve_mesh(MeshSpec(1, 1), device="cpu"))
    # the dense engine has nothing to append: demand reservation is
    # refused, as in the reference
    dense = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="reserve='demand'"):
        ServeScheduler(dense, reserve="demand")


def test_prefix_cache_gates_ssm(arch_models):
    """Models with SSM layers keep per-slot dense state, no pages to
    share: the engine says so and the scheduler accepts the knob but
    keeps sharing off, as the JAX package does."""
    jc, tc, jp, tp = arch_models("mamba2-370m")
    kw = dict(batch=1, max_len=32, page_size=8, prefill_chunk=16)
    eng = PagedEngine(tc, tp, device="cpu", **kw)
    jeng = JaxPagedEngine(jc, jp, **kw)
    assert not eng.supports_prefix_cache and not jeng.supports_prefix_cache
    sched = ServeScheduler(eng, prefix_cache=True)
    assert sched.prefix is None and not sched.prefix_cache_active
    jsched = JaxServeScheduler(jeng, prefix_cache=True)
    assert jsched.prefix is None and not jsched.prefix_cache_active
    assert PagedEngine(*arch_models("qwen2-1.5b")[1::2], device="cpu",
                       **kw).supports_prefix_cache


def test_page_allocator_exhaustion_free_and_no_aliasing():
    a = PageAllocator(8)                    # page 0 reserved -> 7 usable
    assert a.n_free == 7
    p1 = a.alloc(3)
    p2 = a.alloc(4)
    assert a.alloc(1) is None               # exhausted -> admission refusal
    assert len(set(p1) | set(p2)) == 7
    assert 0 not in p1 + p2
    a.free(p1)
    assert a.n_free == 3
    with pytest.raises(ValueError):         # double free refused
        a.free(p1)
    p3 = a.alloc(3)
    assert set(p3) == set(p1)
    a.free(p2 + p3)
    assert a.n_free == 7 and a.n_outstanding == 0


def test_page_allocator_refcounts_and_batch_free_validation():
    a = PageAllocator(6, watermark=2)
    assert a.admit(4) is None               # would leave < 2 free
    p = a.admit(3)
    a.share(p[:1])
    assert a.refcount(p[0]) == 2 and not a.writable(p[0])
    with pytest.raises(ValueError):         # over-free: nothing is freed
        a.free([p[1], p[1]])
    assert a.refcount(p[1]) == 1
    a.free(p + p[:1])
    assert a.n_outstanding == 0 and a.n_free == 5


def test_chunk_plan_is_page_aligned_and_suffix_closed():
    buckets = chunk_buckets_for(64, 16)
    assert buckets == (16, 32, 64)
    assert chunk_plan(70, 64, buckets) == [(0, 64, 64), (64, 16, 6)]
    assert chunk_plan(64, 64, buckets) == [(0, 64, 64)]
    assert chunk_plan(5, 64, buckets) == [(0, 16, 5)]
    for true_len in (1, 17, 64, 65, 130):
        plan = chunk_plan(true_len, 64, buckets)
        assert all(s % 16 == 0 and b % 16 == 0 for s, b, _ in plan)
        assert sum(v for _, _, v in plan) == true_len
        for start in range(64, true_len, 64):
            assert chunk_plan(true_len, 64, buckets, start=start) == \
                [c for c in plan if c[0] >= start]
    with pytest.raises(ValueError):
        chunk_plan(0, 64, buckets)
    with pytest.raises(ValueError):
        chunk_plan(70, 64, buckets, start=16)


def test_launcher_trace_on_cpu(tmp_path):
    out = tmp_path / "stats.json"
    stats = serve_main(["--smoke", "--device", "cpu", "--trace", "--paged",
                        "--prefill-chunk", "32", "--n-requests", "4",
                        "--prompt-lens", "6", "12", "40", "--max-new", "4",
                        "--reserve", "demand", "--stats-json", str(out)])
    assert stats["n_requests"] == 4 and stats["gen_tokens"] == 16
    assert stats["outcomes"] == {"completed": 4}
    assert stats["device"] == "cpu" and out.exists()
    with pytest.raises(SystemExit):                    # watermark needs demand
        serve_main(["--smoke", "--device", "cpu", "--trace", "--paged",
                    "--admit-watermark", "2"])


@pytest.mark.parametrize("arch", ["chameleon-34b", "deepseek-coder-33b",
                                  "llama3-405b"])
def test_dense_arch_scheduler_streams_match_jax(arch_models, arch):
    """The lifetime trace through the paged scheduler of each package on
    the arch's smoke config: identical token streams and outcomes."""
    jc, tc, jp, tp = arch_models(arch)
    kw = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)
    prompts = _trace(3, jc.vocab_size, CONFIGS["lifetime"]["lens"])

    def drain(sched):
        for p in prompts:
            assert sched.submit(p, max_new=8) is not None
        tokens = {r.rid: r.tokens for r in sched.run()}
        return tokens, {rid: o.outcome for rid, o in sched.outcomes.items()}

    want = drain(JaxServeScheduler(JaxPagedEngine(jc, jp, attn_impl="ref",
                                                  **kw)))
    got = drain(ServeScheduler(PagedEngine(tc, tp, device="cpu", **kw)))
    assert got == want
    assert len(got[0]) == len(prompts)
    assert set(got[1].values()) == {"completed"}
