"""The port's autotuner, its kernel benchmark and the cost-model bridge,
against the JAX package's, on the CPU.

* Each test of ``tests/test_tuning.py`` on the port's tuner, with the
  port's ``ref``/``cpu`` (the plain version) where those use
  ``interpret``/``cpu``, and the RMSNorm wrapper's launch-shape lookup
  where those use the Jacobi wrapper's block lookup (the port's Jacobi
  kernel has one launch shape).
* One cache file, two packages: a cache written by JAX's ``TuningCache``
  gives the same ``lookup``, ``observed_s(nearest=True)`` and
  ``calibrated_cost_params`` rates through the port's, and the reverse;
  ``shape_bucket`` and ``cache_key`` agree on a hypothesis sweep.
* ``LocalExecutor(strategy="cost", cost_params=, observed_fn_times=)``
  places every job on the same worker and reports the same as JAX's.
* ``jacobi_hypar``'s seeding, fed a hand-written ``cuda`` entry, gives
  the per-chunk times the reference's formula gives; off the card it
  seeds nothing, as the reference off a TPU.
* ``kernel_bench`` gives the reference's rows (names, shapes, bytes,
  operations), and a second pass is all cache hits with nothing timed.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jc
import repro.kernels.tuning as jt
import repro_torch.core as tc
from benchmarks import kernel_bench as jbench
from repro.apps import jacobi as jj
from repro_torch.apps import jacobi as tj
from repro_torch.benchmarks import kernel_bench as tbench
from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import (Autotuner, TuningCache, cache_key,
                                        calibrated_cost_params, shape_bucket)
from test_torch_executor import (FIXTURES, _assert_results_match, _clusters,
                                 _report_view)


class SeededTimer:
    """perf_counter stub: each call advances the clock by a seeded
    pseudo-random amount, so measured intervals (and the selected config)
    are deterministic functions of the seed."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.calls = 0

    def __call__(self) -> float:
        self.calls += 1
        self.now += float(self.rng.random())
        return self.now


CANDS = [{"block": b} for b in (64, 128, 256)]
F32 = torch.float32


def _make_call(cfg):
    return lambda: torch.zeros((4,))


def _tuner(path, seed=0):
    return Autotuner(TuningCache(str(path)), timer=SeededTimer(seed))


# ---------------------------------------------------------------------------
# tests/test_tuning.py, on the port's tuner
# ---------------------------------------------------------------------------


def test_shape_bucketing():
    assert shape_bucket((1000, 1000)) == (1024, 1024)
    assert shape_bucket((1024, 1)) == (1024, 1)
    k1 = cache_key("jacobi_sweep", "cpu", (1000, 1000), F32)
    k2 = cache_key("jacobi_sweep", "cpu", (1024, 1024), F32)
    k3 = cache_key("jacobi_sweep", "cpu", (2048, 2048), F32)
    assert k1 == k2 and k1 != k3
    assert cache_key("jacobi_sweep", "cpu", (1024, 1024),
                     torch.bfloat16) != k2
    assert k2 == "jacobi_sweep|cpu|ref|1024x1024|float32"
    assert cache_key("rmsnorm", "cuda", (4096, 1024),
                     torch.bfloat16) == "rmsnorm|cuda|kernel|4096x1024|bfloat16"


def test_cache_miss_times_then_hit_skips_timing(tmp_path):
    timer = SeededTimer(0)
    tuner = Autotuner(TuningCache(str(tmp_path / "t.json")), timer=timer)
    e1 = tuner.tune("k", _make_call, shape=(256, 256), dtype=F32,
                    backend="cpu", candidates=CANDS)
    assert e1["timed"] == len(CANDS) == tuner.n_timed
    assert e1["impl"] == "ref" and e1["backend"] == "cpu"
    assert timer.calls > 0
    calls_after_miss = timer.calls
    e2 = tuner.tune("k", _make_call, shape=(256, 256), dtype=F32,
                    backend="cpu", candidates=CANDS)
    assert timer.calls == calls_after_miss        # hit: nothing re-timed
    assert tuner.n_timed == len(CANDS)
    assert e2 == e1
    # a second tuner on the same cache file also hits (persistence)
    timer3 = SeededTimer(1)
    tuner3 = Autotuner(TuningCache(str(tmp_path / "t.json")), timer=timer3)
    e3 = tuner3.tune("k", _make_call, shape=(250, 250), dtype=F32,
                     backend="cpu", candidates=CANDS)  # same bucket
    assert timer3.calls == 0
    assert e3 == e1


def test_corrupt_cache_file_recovers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text("{definitely not json")
    entry = _tuner(path).tune("k", _make_call, shape=(64,), dtype=F32,
                              backend="cpu", candidates=CANDS)
    assert entry["config"] in CANDS
    data = json.loads(path.read_text())       # rewritten, valid, one entry
    assert data["version"] == 1 and len(data["entries"]) == 1


def test_truncated_cache_file_recovers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text('{"version": 1, "entries": {"a": ')
    assert TuningCache(str(path)).load() == {}


def test_schema_corrupt_entries_are_dropped(tmp_path):
    path = tmp_path / "t.json"
    good = {"config": {"block": 64}, "median_s": 1e-3}
    path.write_text(json.dumps({"version": 1, "entries": {
        "k|cpu|ref|256x256|float32": {"median": 1},          # wrong keys
        "k|cpu|ref|512x512|float32": {"config": "x", "median_s": 1e-3},
        "k|cpu|ref|64x64|float32": good,
    }}))
    tuner = Autotuner(TuningCache(str(path)))
    assert tuner.lookup("k", (256, 256), F32, backend="cpu") is None
    assert tuner.observed_s("k", (512, 512), F32, backend="cpu") is None
    assert tuner.lookup("k", (64, 64), F32, backend="cpu") == good["config"]


def test_legacy_four_part_keys_dropped_on_load(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 1, "entries": {
        "k|cpu|64x64|float32": {"config": {"block": 64}, "median_s": 1e-3},
        "k|cpu|ref|64x64|float32": {"config": {"block": 32},
                                    "median_s": 2e-3},
    }}))
    cache = TuningCache(str(path))
    assert list(cache.load()) == ["k|cpu|ref|64x64|float32"]
    assert Autotuner(cache).lookup("k", (64, 64), F32,
                                   backend="cpu") == {"block": 32}


def test_unserializable_config_save_is_not_fatal(tmp_path):
    tuner = _tuner(tmp_path / "t.json")
    e = tuner.tune("k", lambda cfg: (lambda: torch.zeros((2,))), shape=(64,),
                   dtype=F32, backend="cpu", candidates=[{"block": object()}])
    assert e["timed"] == 1                        # the result survived
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".tmp"] == []


def test_selection_deterministic_under_seeded_timer(tmp_path):
    picks = []
    for run in range(2):
        e = _tuner(tmp_path / f"t{run}.json", 42).tune(
            "k", _make_call, shape=(128, 128), dtype=F32, backend="cpu",
            candidates=CANDS)
        picks.append(tuple(sorted(e["config"].items())))
    assert picks[0] == picks[1]


def test_failing_candidates_are_skipped(tmp_path):
    def make_call(cfg):
        if cfg["block"] == 128:
            raise ValueError("invalid for shape")
        return lambda: torch.zeros((2,))

    tuner = _tuner(tmp_path / "t.json")
    e = tuner.tune("k", make_call, shape=(64,), dtype=F32, backend="cpu",
                   candidates=CANDS)
    assert e["timed"] == len(CANDS) - 1
    assert e["config"]["block"] != 128
    with pytest.raises(RuntimeError, match="no candidate ran"):
        tuner.tune("k2", lambda cfg: (_ for _ in ()).throw(ValueError()),
                   shape=(64,), dtype=F32, backend="cpu", candidates=CANDS)


def test_launch_failure_in_a_candidate_reaches_the_caller(tmp_path):
    """Only the wrappers' argument errors mark a candidate invalid; any
    other error (a failed CUDA launch raises RuntimeError from its binding)
    stops the tune, and nothing is cached."""
    def make_call(cfg):
        if cfg["block"] == 128:
            def launch():
                raise RuntimeError("rmsnorm launch failed: CUDA error 700")
            return launch
        return lambda: torch.zeros((2,))

    tuner = _tuner(tmp_path / "t.json")
    with pytest.raises(RuntimeError, match="launch failed"):
        tuner.tune("k", make_call, shape=(64,), dtype=F32, backend="cpu",
                   candidates=CANDS)
    assert tuner.lookup("k", (64,), F32, backend="cpu") is None
    assert not (tmp_path / "t.json").exists()
    # a TypeError (a dtype the wrapper refuses) is skipped like a ValueError
    e = tuner.tune("k", lambda cfg: (_ for _ in ()).throw(TypeError())
                   if cfg["block"] == 64 else (lambda: torch.zeros((2,))),
                   shape=(64,), dtype=F32, backend="cpu", candidates=CANDS)
    assert e["timed"] == len(CANDS) - 1 and e["config"]["block"] != 64


def test_ops_wrappers_consult_cache(tmp_path, monkeypatch):
    """A tuned entry supplies the RMSNorm kernel's rows a block; an
    explicit value wins; an untuned bucket, or a plain-version entry,
    gives the default."""
    from repro_torch.kernels.rmsnorm.ops import (DEFAULT_ROW_BLOCK,
                                                 _tuned_row_block)
    path = str(tmp_path / "t.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    cache = TuningCache(path)
    cache.put(cache_key("rmsnorm", "cuda", (4096, 1024), F32),
              {"config": {"row_block": 2}, "median_s": 1e-5})
    cache.put(cache_key("rmsnorm", "cuda", (64, 64), F32, "ref"),
              {"config": {"row_block": 8}, "median_s": 1e-5})
    assert _tuned_row_block((4000, 1000), F32, None, backend="cuda") == 2
    assert _tuned_row_block((4096, 1024), F32, 8, backend="cuda") == 8
    assert _tuned_row_block((4096, 1024), torch.bfloat16, None,
                            backend="cuda") == DEFAULT_ROW_BLOCK
    assert _tuned_row_block((64, 64), F32, None,
                            backend="cuda") == DEFAULT_ROW_BLOCK


def test_observed_s_nearest_bucket_scaling(tmp_path):
    cache = TuningCache(str(tmp_path / "t.json"))
    cache.put(cache_key("jacobi_sweep", "cpu", (2048, 2048), F32),
              {"config": {}, "median_s": 1e-2, "backend": "cpu"})
    tuner = Autotuner(cache)
    assert tuner.observed_s("jacobi_sweep", (2048, 2048), F32,
                            backend="cpu") == pytest.approx(1e-2)
    assert tuner.observed_s("jacobi_sweep", (2709, 2709), F32,
                            backend="cpu") is None
    t = tuner.observed_s("jacobi_sweep", (2709, 2709), F32, backend="cpu",
                         nearest=True)
    assert t == pytest.approx(1e-2 * 2709 ** 2 / 2048 ** 2)
    assert tuner.observed_s("rmsnorm", (2709, 2709), F32, backend="cpu",
                            nearest=True) is None
    assert tuner.observed_s("jacobi_sweep", (2709, 2709), torch.bfloat16,
                            backend="cpu", nearest=True) is None
    assert tuner.observed_s("jacobi_sweep", (2709, 2709), F32,
                            backend="cuda", nearest=True) is None


def test_calibrated_cost_params(tmp_path):
    cache = TuningCache(str(tmp_path / "t.json"))
    tuner = Autotuner(cache)
    base = calibrated_cost_params(tuner=tuner, backend="cpu")  # empty
    assert base == tc.CostModelParams() and base.peak_flops == 100e9
    cache.put("a|cpu|ref|256x256|float32",
              {"config": {}, "median_s": 1e-3, "flops": 2e9, "bytes": 4e8,
               "backend": "cpu", "impl": "ref"})
    cache.put("b|cpu|ref|256x256|float32",
              {"config": {}, "median_s": 1e-3, "flops": 1e9, "bytes": 8e8,
               "backend": "cpu", "impl": "ref"})
    # a foreign-backend entry must not poison the calibration
    cache.put("c|cuda|kernel|256x256|float32",
              {"config": {}, "median_s": 1e-6, "flops": 2e12, "bytes": 4e11,
               "backend": "cuda", "impl": "kernel"})
    p = calibrated_cost_params(tuner=tuner, backend="cpu")
    assert p.peak_flops == pytest.approx(2e9 / 1e-3)
    assert p.mem_bw == pytest.approx(8e8 / 1e-3)
    assert p.link_bw == base.link_bw and p.dispatch_s == base.dispatch_s
    q = calibrated_cost_params(tuner=tuner, backend="cuda")
    assert q.peak_flops == pytest.approx(2e18) and q.mem_bw == \
        pytest.approx(4e17)


def test_calibration_reads_only_float32_entries(tmp_path):
    """The cost model prices fp32 work: a bf16 entry (the flash forward
    on the tensor cores) leaves the calibrated rates alone."""
    cache = TuningCache(str(tmp_path / "t.json"))
    tuner = Autotuner(cache)
    cache.put("jacobi_sweep|cuda|kernel|2048x2048|float32",
              {"config": {}, "median_s": 1e-3, "flops": 8e9, "bytes": 2e9,
               "backend": "cuda", "impl": "kernel"})
    cache.put("flash_attention|cuda|kernel|1x2048x8x64|bfloat16",
              {"config": {"q_block": 64, "kv_block": 64}, "median_s": 1e-5,
               "flops": 4e9, "bytes": 3e6, "backend": "cuda",
               "impl": "kernel"})
    p = calibrated_cost_params(tuner=tuner, backend="cuda")
    assert p.peak_flops == pytest.approx(8e12)
    assert p.mem_bw == pytest.approx(2e12)


def test_plain_version_entries_cannot_poison_the_card(tmp_path):
    """Timings of the plain version, on the CPU or forced on a card
    (``...|cuda|ref|...``), never answer a kernel lookup on the card nor
    alter its calibration."""
    path = tmp_path / "t.json"
    cache = TuningCache(str(path))
    cache.put(cache_key("flash_attention", "cpu", (4, 8, 512, 64), F32),
              {"config": {"q_block": 128}, "median_s": 3.0, "flops": 1e9,
               "bytes": 1e8, "backend": "cpu", "impl": "ref"})
    cache.put(cache_key("flash_attention", "cuda", (4, 8, 512, 64), F32,
                        "ref"),
              {"config": {"q_block": 256}, "median_s": 7.0, "flops": 1e15,
               "bytes": 1e14, "backend": "cuda", "impl": "ref"})
    tuner = Autotuner(cache)
    assert tuner.lookup("flash_attention", (4, 8, 512, 64), F32,
                        backend="cuda", impl="kernel") is None
    assert tuner.observed_s("flash_attention", (4, 8, 512, 64), F32,
                            backend="cuda", nearest=True) is None
    base = calibrated_cost_params(tuner=Autotuner(TuningCache(
        str(tmp_path / "empty.json"))), backend="cuda")
    p = calibrated_cost_params(tuner=tuner, backend="cuda")
    assert p.peak_flops == base.peak_flops and p.mem_bw == base.mem_bw
    assert tuner.lookup("flash_attention", (4, 8, 512, 64), F32,
                        backend="cpu") == {"q_block": 128}
    assert len(TuningCache(str(path)).load()) == 2


def test_get_tuner_per_cache_path(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "a.json"))
    ta = tuning.get_tuner()
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "b.json"))
    tb = tuning.get_tuner()
    assert ta is not tb and ta.cache.path != tb.cache.path
    assert tuning.get_tuner() is tb
    assert tuning.get_tuner(str(tmp_path / "a.json")) is ta


def test_median_call_s_samples_last_the_minimum(tmp_path):
    """Calls are batched until a sample lasts ``MIN_SAMPLE_S``: a call of
    1/8 of it is sampled 8 at a time, and the median is per call."""
    clock = {"now": 0.0, "calls": 0}

    def timer():
        return clock["now"]

    def fn():
        clock["calls"] += 1
        clock["now"] += tuning.MIN_SAMPLE_S / 8

    t = tuning.median_call_s(fn, 3, timer=timer)
    assert t == pytest.approx(tuning.MIN_SAMPLE_S / 8)
    assert clock["calls"] == 1 + 1 + 3 * 8       # warm-up, probe, samples


# ---------------------------------------------------------------------------
# one cache file, two packages
# ---------------------------------------------------------------------------

# kernel, backend, impl, shape, dtype name, config, median_s, flops, bytes
ENTRIES = [
    ("rmsnorm", "cuda", "kernel", (4096, 1024), "float32",
     {"row_block": 2}, 1.2e-5, 1.26e7, 3.36e7),
    ("jacobi_sweep", "cuda", "kernel", (2048, 2048), "float32", {}, 8e-6,
     8.4e6, 1.68e7),
    ("jacobi_sweep", "cuda", "kernel", (1000, 1000), "bfloat16", {}, 2e-6,
     2e6, 2e6),
    ("flash_attention", "tpu", "kernel", (1, 2048, 8, 64), "float32", {},
     1e-4, 4.3e9, 6e6),
    # the same measurements under each package's CPU impl
    ("jacobi_sweep", "cpu", "ref", (256, 256), "float32", {}, 1e-4, 1.3e5,
     2.6e5),
    ("jacobi_sweep", "cpu", "interpret", (256, 256), "float32", {}, 1e-4,
     1.3e5, 2.6e5),
    ("rmsnorm", "cpu", "ref", (64, 256), "float32", {"row_block": 8}, 3e-5,
     4.9e4, 1.3e5),
    ("rmsnorm", "cpu", "interpret", (64, 256), "float32", {"row_block": 8},
     3e-5, 4.9e4, 1.3e5),
]


def _write(pkg_tuning, path):
    cache = pkg_tuning.TuningCache(str(path))
    for kern, backend, impl, shape, dt, cfg, med, flops, nbytes in ENTRIES:
        cache.put(pkg_tuning.cache_key(kern, backend, shape, dt, impl),
                  {"config": cfg, "median_s": med, "flops": flops,
                   "bytes": nbytes, "backend": backend, "impl": impl,
                   "timed": 1})


def _params(p):
    return (p.peak_flops, p.mem_bw, p.link_bw, p.dispatch_s)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_cache_file_reads_the_same_in_both_packages(tmp_path, writer):
    path = tmp_path / "t.json"
    _write(jt if writer == "jax" else tuning, path)
    jtun = jt.Autotuner(jt.TuningCache(str(path)))
    ttun = Autotuner(TuningCache(str(path)))
    assert set(ttun.cache.load()) == set(jtun.cache.load())
    for kern, backend, impl, shape, dt, cfg, med, *_ in ENTRIES:
        tdt = getattr(torch, dt)
        jdt = getattr(jnp, dt)
        assert ttun.lookup(kern, shape, tdt, backend, impl) == cfg
        assert jtun.lookup(kern, shape, jdt, backend, impl) == cfg
        # nearest buckets, scaled by the element-count ratio
        big = tuple(3 * s - 1 for s in shape)
        assert ttun.observed_s(kern, big, tdt, backend, impl,
                               nearest=True) == pytest.approx(
            jtun.observed_s(kern, big, jdt, backend, impl, nearest=True))
    # CPU calibration: each package reads its own impl's entries, which
    # carry the same measurements here; foreign backends are ignored
    assert _params(calibrated_cost_params(tuner=ttun, backend="cpu")) == \
        pytest.approx(_params(jt.calibrated_cost_params(tuner=jtun,
                                                        backend="cpu")))
    # the card's kernel entries: the port's rates, from the same entries
    p = calibrated_cost_params(tuner=ttun, backend="cuda")
    assert p.peak_flops == pytest.approx(1.26e7 / 1.2e-5)
    assert p.mem_bw == pytest.approx(3.36e7 / 1.2e-5)


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(st.integers(1, 70000), min_size=1, max_size=5),
       dt=st.sampled_from(["float32", "bfloat16", "float16", "int32"]),
       backend=st.sampled_from(["cpu", "cuda", "tpu"]),
       impl=st.sampled_from(["kernel", "ref", "interpret"]))
def test_bucket_and_key_agree_with_the_reference(shape, dt, backend, impl):
    assert shape_bucket(shape) == jt.shape_bucket(shape)
    assert cache_key("k", backend, shape, getattr(torch, dt), impl) == \
        jt.cache_key("k", backend, shape, getattr(jnp, dt), impl)


# ---------------------------------------------------------------------------
# the cost-model bridge: the executor and jacobi_hypar
# ---------------------------------------------------------------------------

COST = dict(peak_flops=3e12, mem_bw=2e12, link_bw=4e8, dispatch_s=2e-5)


@pytest.mark.parametrize("mode", ["sync", "dataflow"])
@pytest.mark.parametrize("name", ["paper-max", "two-producers",
                                  "dynamic-iteration"])
def test_cost_strategy_with_seeds_matches_jax(name, mode):
    """The cost strategy with calibrated params and seeded per-function
    times: the same workers for every job and the same report."""
    jfix, tfix, _ = FIXTURES[name]
    (jg, jreg), (tg, treg) = jfix(), tfix()
    jcl, tcl = _clusters(max_workers=3)
    seeds = {1: 3e-3, 2: 1e-4}
    jex = jc.LocalExecutor(jcl, jreg, mode=mode, strategy="cost",
                           cost_params=jc.CostModelParams(**COST),
                           observed_fn_times=seeds)
    tex = tc.LocalExecutor(tcl, treg, mode=mode, strategy="cost",
                           cost_params=tc.CostModelParams(**COST),
                           observed_fn_times=seeds)
    jres, jrep = jex.run(jg)
    tres, trep = tex.run(tg)
    _assert_results_match(jres, tres)
    assert _report_view(trep) == _report_view(jrep)
    assert ({n: r.owner_worker for n, r in tex.store.records.items()}
            == {n: r.owner_worker for n, r in jex.store.records.items()})


def test_master_scheduler_takes_the_seeds():
    g = tc.JobGraph()
    g.add_segment([tc.Job("J1", 1, 0)])
    cl = tc.VirtualCluster([torch.device("cpu")], n_schedulers=1)
    m = tc.MasterScheduler(g, cl, strategy="cost",
                           cost_params=tc.CostModelParams(**COST),
                           observed_fn_times={1: 5e-3})
    assert m.cost_params == tc.CostModelParams(**COST)
    assert m._est_fn_time(1) == 5e-3 and m._est_fn_time(9) == 5e-3
    m.observe(1, 1e-3)
    assert m._est_fn_time(1) == pytest.approx(0.7 * 5e-3 + 0.3 * 1e-3)
    plain = tc.MasterScheduler(g, cl)
    assert plain.cost_params == tc.CostModelParams()
    assert plain._est_fn_time(1) == plain.cost_params.dispatch_s


def test_jacobi_seeding_on_the_card_follows_the_reference(tmp_path):
    """A hand-written ``cuda`` entry of the fused sweep at 2048: the seeded
    per-chunk times are the reference's formula (the nearest bucket's time
    scaled to n², times each chunk's row share) through JAX's tuner on the
    same file, and ``strategy="cost"`` gets the calibrated params."""
    path = tmp_path / "t.json"
    TuningCache(str(path)).put(
        cache_key("jacobi_sweep", "cuda", (2048, 2048), F32),
        {"config": {}, "median_s": 9e-6, "flops": 2.0 * 2048 ** 2,
         "bytes": 4.0 * 2048 ** 2, "backend": "cuda", "impl": "kernel"})
    n = 2709
    A = np.zeros((n, n), np.float32)
    bounds = np.cumsum([0] + [c.data.shape[0] for c in
                              jc.ChunkedData.from_array(jnp.asarray(A), 4)])
    t_full = jt.Autotuner(jt.TuningCache(str(path))).observed_s(
        "jacobi_sweep", (n, n), jnp.float32, backend="cuda", impl="kernel",
        nearest=True)
    want = {f"sweep{i}": t_full * float(bounds[i + 1] - bounds[i]) / n
            for i in range(4)}
    tuner = Autotuner(TuningCache(str(path)))
    observed, params = tj.tuned_schedule_inputs(
        n, bounds, F32, strategy="cost", backend="cuda", tuner=tuner)
    assert observed.keys() == want.keys()
    for k in want:
        assert observed[k] == pytest.approx(want[k], rel=1e-12)
    assert params.mem_bw == pytest.approx(4.0 * 2048 ** 2 / 9e-6)
    assert params.peak_flops == pytest.approx(2.0 * 2048 ** 2 / 9e-6)
    assert tj.tuned_schedule_inputs(n, bounds, F32, strategy="greedy",
                                    backend="cuda", tuner=tuner)[1] is None
    # off the card: nothing, whatever the cache holds
    assert tj.tuned_schedule_inputs(n, bounds, F32, strategy="cost",
                                    backend="cpu", tuner=tuner) == ({}, None)


def test_jacobi_hypar_cost_strategy_matches_jax_on_the_cpu(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    import jax
    Aj, bj, _ = jj.make_system(128)
    At, bt, _ = tj.make_system(128, device="cpu")
    rj = jj.jacobi_hypar(Aj, bj, iters=20, strategy="cost",
                         cluster=jc.VirtualCluster(jax.devices()[:1],
                                                   n_schedulers=1,
                                                   max_workers=4))
    rt = tj.jacobi_hypar(At, bt, iters=20, strategy="cost")
    assert rt.iters == rj.iters == 20
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-5, rtol=1e-5)
    assert rt.extra["report"] == rj.extra["report"]
    assert rt.extra["observed_fn_times"] == {}
    assert rt.extra["cost_params"] is None


# ---------------------------------------------------------------------------
# the kernel benchmark
# ---------------------------------------------------------------------------


def _reference_rows(monkeypatch):
    """The reference bench's rows at its smoke shapes with nothing timed:
    its timer stubbed, and every tune answered without a call."""
    def fake_tune(self, kernel, make_call, *, shape, dtype, candidates=None,
                  **kw):
        return {"config": {}, "median_s": 0.0}
    monkeypatch.setattr(jbench, "_time", lambda fn, *a, **k: 0.0)
    monkeypatch.setattr(jt.Autotuner, "tune", fake_tune)
    monkeypatch.setattr(jt.Autotuner, "observed_s",
                        lambda self, *a, **k: None)
    return jbench.run(smoke=True)


def test_kernel_bench_rows_and_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    out = tmp_path / "bench.json"
    rows = tbench.main(["--smoke", "--device", "cpu", "--out", str(out)])
    ref = _reference_rows(monkeypatch)
    key = ("name", "shape", "dtype", "flops", "bytes")
    assert [tuple(r[k] for k in key) for r in rows] == \
        [tuple(r[k] for k in key) for r in ref]
    assert all(r["backend"] == "cpu" and r["device"] == "cpu"
               and r["median_s"] > 0 for r in rows)
    tuned = [r for r in rows if r["name"].endswith("_tuned")]
    assert len(tuned) == 5 and len(rows) == 11
    assert all(r["cache"] == "miss" and r["timed"] == r["candidates"]
               for r in tuned)
    assert json.loads(out.read_text()) == {"schema_version": 1,
                                           "rows": rows}
    again = tbench.autotune_rows(smoke=True, device="cpu")
    assert [r["cache"] for r in again] == ["hit"] * 5
    assert [r["timed"] for r in again] == [0] * 5
    assert [r["median_s"] for r in again] == [r["median_s"] for r in tuned]


def test_kernel_bench_tuned_cases_run_under_every_candidate():
    """``tuned_cases`` (the inputs the card's check and the autotune pass
    share) gives one case a tuned row, in the rows' order, and each
    wrapper runs its plain version under every candidate config; its
    inputs are the autotune pass's, so a tuned row's shape is its case's."""
    cases = tbench.tuned_cases(smoke=True, device="cpu")
    assert [c[0] for c in cases] == ["jacobi_sweep", "rmsnorm",
                                     "flash_attention", "ssd_scan",
                                     "paged_attention"]
    for kernel, fn, args, shape, flops, nbytes in cases:
        want = fn(*args, impl="ref")
        for cfg in tuning.DEFAULT_CANDIDATES[kernel]:
            got = fn(*args, impl="ref", **cfg)
            got, want_ = ((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))
            assert all(torch.equal(g, w) for g, w in zip(got, want_))
            assert all(torch.isfinite(g).all() for g in got)
        assert flops > 0 and nbytes > 0 and len(shape) >= 2
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, impl="kernel")


def test_ssd_tuner_grid_names_rows_a_tile():
    """The port's SSD grid: one ``row_tile`` a candidate, every launch
    shape the kernel takes (the reference's grid is one empty config)."""
    from repro_torch.kernels.ssd_scan.kernel import ROW_TILES
    grid = tuning.DEFAULT_CANDIDATES["ssd_scan"]
    assert {frozenset(c) for c in grid} == {frozenset({"row_tile"})}
    assert sorted(c["row_tile"] for c in grid) == list(ROW_TILES) == [32, 64]


def test_kernel_bench_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run(smoke=True)
