"""The port's dry-run tools (``repro_torch.launch.dryrun``, ``specs``,
``diagnose``, ``hillclimb``; ``launch.mesh.make_production_mesh``;
``data.make_batch_specs``) against the JAX package.

``plan_jobfile`` is held to the reference's planner on the same job texts
under both strategies (the same workers, lanes, co-scheduling and cost
estimates, rel 1e-9).  The reference's ``plan_jobfile`` is replayed here
from its body (``repro/launch/dryrun.py:104``) rather than imported: that
module raises the process's forced host device count to 512 when it is
imported, which would reach every test sharing the worker.  The spec
helpers are held to the reference's for every arch × cell, and
``run_cell`` traces every family and cell kind of the smoke configs on a
small meta grid.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.core import MasterScheduler as JaxMaster
from repro.core import ResultStore as JaxStore
from repro.core import VirtualCluster as JaxCluster
from repro.core import parse_job_file as jax_parse_job_file
from repro.data.pipeline import make_batch_specs as jax_batch_specs
from repro.launch.specs import choose_grad_accum as jax_choose_grad_accum
from repro.launch.specs import model_flops_for as jax_model_flops_for
from repro.launch.specs import rules_for_cell as jax_rules_for_cell
from repro.models.config import SHAPE_CELLS as JAX_CELLS
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import ARCHS, cells_for, get_config, get_smoke_config
from repro_torch.data import make_batch_specs
from repro_torch.launch import diagnose, dryrun, hillclimb
from repro_torch.launch.mesh import (compat_make_mesh, grid_devices,
                                     make_production_mesh)
from repro_torch.launch.specs import (choose_grad_accum, model_flops_for,
                                      rules_for_cell)
from repro_torch.models.config import SHAPE_CELLS
from repro_torch.optim import OptimizerSpec
from repro_torch.train.step import TrainState, make_train_step

JOB_TEXTS = {
    "paper": """J1(1,0,0), J2(2,1,0);
J3(2,2,R1[0..5],true), J4(2,2,R1[5..10],true), J5(3,0,R1 R2),
 J6(4,0,R1 R2);
J7(5,1, R2 R3 R4 R5);""",
    "max": """
  J1(1,0,0), J2(1,0,0);          # segment 1: search chunks in parallel
  J3(2,1,R1 R2);                 # segment 2: combine both results
""",
    "coschedule": """J1(1,2,0), J2(1,2,0), J3(1,2,0), J4(2,1,0);
J5(3,4,R1 R2 R3 R4), J6(3,1,R1[0..2]);""",
}


def _jax_plan(path, *, n_workers, cores, strategy):
    """The reference's ``plan_jobfile`` body, without its printing."""
    graph = jax_parse_job_file(path)
    cluster = JaxCluster(n_schedulers=1, cores_per_worker=cores,
                         max_workers=n_workers)
    master = JaxMaster(graph, cluster, strategy=strategy)
    store = JaxStore(cluster)
    return [master.plan_segment(seg.jobs, store) for seg in graph.segments]


def _rows(plans):
    return [[(p.job.name, p.worker.wid, p.n_sequences,
              tuple(p.co_scheduled_with), p.est_cost_s) for p in seg]
            for seg in plans]


@pytest.mark.parametrize("name", list(JOB_TEXTS))
@pytest.mark.parametrize("strategy", ["greedy", "cost"])
@pytest.mark.parametrize("n_workers,cores", [(4, 1), (2, 4)])
def test_plan_jobfile_matches_the_reference(name, strategy, n_workers, cores,
                                            tmp_path):
    path = tmp_path / "jobs.txt"
    path.write_text(JOB_TEXTS[name])
    got = _rows(dryrun.plan_jobfile(str(path), n_workers=n_workers,
                                    cores=cores, strategy=strategy,
                                    devices=[torch.device("cpu")],
                                    verbose=False))
    want = _rows(_jax_plan(str(path), n_workers=n_workers, cores=cores,
                           strategy=strategy))
    assert [[r[:4] for r in seg] for seg in got] == \
        [[r[:4] for r in seg] for seg in want]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g[4] == pytest.approx(w[4], rel=1e-9, abs=0)


def test_jobfile_cli_prints_the_plan(tmp_path, capsys):
    path = tmp_path / "jobs.txt"
    path.write_text(JOB_TEXTS["paper"])
    dryrun.main(["--jobfile", str(path), "--workers", "3", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "S0:"
    assert "J7 -> worker" in out and "(seq=" in out and "est=" in out
    dryrun.main(["--jobfile", str(path), "--strategy", "greedy",
                 "--device", "cpu"])
    assert "est=" not in capsys.readouterr().out


def test_plan_jobfile_places_on_cuda_by_default(tmp_path):
    path = tmp_path / "jobs.txt"
    path.write_text(JOB_TEXTS["max"])
    if torch.cuda.is_available():
        assert dryrun.plan_jobfile(str(path), verbose=False)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.plan_jobfile(str(path), verbose=False)


ARCH_CELLS = [(a, c) for a in ARCHS for c in cells_for(a)]


@pytest.mark.parametrize("arch,cell", ARCH_CELLS,
                         ids=[f"{a}-{c}" for a, c in ARCH_CELLS])
def test_spec_helpers_match_the_reference(arch, cell):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cells_for(arch) == jax_cells_for(arch)
    sc, jsc = SHAPE_CELLS[cell], JAX_CELLS[cell]
    assert model_flops_for(cfg, sc) == jax_model_flops_for(jcfg, jsc)
    for shards in (1, 16, 32):
        assert choose_grad_accum(cfg, sc, shards) == \
            jax_choose_grad_accum(jcfg, jsc, shards)
    for c, jc in ((cfg, jcfg), (None, None)):
        assert rules_for_cell(None, sc, c).rules == \
            jax_rules_for_cell(None, jsc, jc).rules
    if sc.kind != "decode":
        batch = 2
        got = make_batch_specs(cfg, batch, sc.seq_len, kind=sc.kind)
        want = jax_batch_specs(jcfg, batch, sc.seq_len, kind=sc.kind)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.is_meta
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == \
                jnp.dtype(want[k].dtype).name


@pytest.mark.parametrize("multi_pod,dims,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_make_production_mesh(multi_pod, dims, axes):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.dims == dims and mesh.axis_names == axes
    assert mesh.size == int(np.prod(dims))
    assert {d.type for d in mesh.flat} == {"meta"}
    rows = mesh.rows()
    assert len(rows) == mesh.size // 16 and {len(r) for r in rows} == {16}


def test_grid_devices_on_meta():
    assert grid_devices(3, device="meta") == [torch.device("meta")] * 3
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'meta'"):
        grid_devices(2, device="xpu")


def test_sampled_micro_batches_count_as_all_of_them():
    """The fused step over a meta grid row counts the same with two of
    its four micro-batches traced as with all four."""
    cfg = get_smoke_config("qwen2-1.5b")
    spec = OptimizerSpec(kind="adamw")
    mesh = compat_make_mesh((1, 2), ("data", "model"), device="meta")
    batch = make_batch_specs(cfg, 8, 16)
    counts = []
    for sample in (0, 2):
        state = TrainState.create(cfg, spec, None, "meta", mesh=mesh)
        step = make_train_step(cfg, spec, grad_accum=4, mesh=mesh)
        with OpCounter(2, sample_micro=sample) as c:
            step(state, batch)
        an = c.analysis()
        counts.append((an.flops, an.traffic_bytes,
                       an.collectives.total_bytes,
                       [p.peak_bytes for p in an.positions]))
    assert counts[0][:3] == counts[1][:3]
    assert counts[1][3] == counts[0][3]


def _smoke(arch):
    """The smoke config at the cells' lengths: the full configs' SSD
    chunk (a 16-step chunk makes a 32,768-token prefill 2,048 chunks) and
    position tables (the encoder reads as many frames as the cell has
    tokens)."""
    cfg = get_smoke_config(arch)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=256)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, max_seq=get_config(arch).max_seq)
    if arch == "llama3-405b":     # the full config's float8 pools (its
        cfg = dataclasses.replace(  # smoke keeps bf16 ones); bf16 params
            cfg, kv_cache_dtype=get_config(arch).kv_cache_dtype)
    return cfg


SMOKE_CELLS = [(a, c) for a in ("qwen2-1.5b", "mamba2-370m",
                                "qwen2-moe-a2.7b", "zamba2-1.2b",
                                "gemma3-4b", "whisper-base", "llama3-405b")
               for c in cells_for(a)]
RECORD_KEYS = {"arch", "cell", "mesh", "n_chips", "grad_accum", "trace_s",
               "bytes_per_device", "fits_hbm", "arg_bytes", "temp_bytes",
               "alias_bytes", "op_flops_per_dev", "op_traffic_per_dev",
               "collective_bytes_per_dev", "collective_counts", "compute_s",
               "memory_s", "collective_s", "dominant", "model_flops",
               "useful_ratio", "roofline_fraction", "while_trips"}


@pytest.mark.parametrize("arch,cell", SMOKE_CELLS,
                         ids=[f"{a}-{c}" for a, c in SMOKE_CELLS])
def test_run_cell_traces_every_family_on_a_meta_grid(arch, cell):
    mesh = compat_make_mesh((2, 2), ("data", "model"), device="meta")
    rec = dryrun.run_cell(arch, cell, cfg=_smoke(arch), mesh=mesh,
                          verbose=False)
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "2x2" and rec["n_chips"] == 4
    assert rec["fits_hbm"] and rec["bytes_per_device"] > 0
    assert len(rec["bytes_by_position"]) == 2
    assert rec["op_flops_per_dev"] > 0 and rec["op_traffic_per_dev"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert json.loads(json.dumps(rec)) == rec
    if SHAPE_CELLS[cell].kind == "train":
        # the row's gathers and its gradients' reduce-scatter onto blocks
        assert rec["collective_counts"]["all-reduce"] > 0
        assert rec["collective_counts"]["reduce-scatter"] > 0
        assert rec["temp_bytes"] > rec["gathered_bytes_per_device"] > 0


def test_sweep_cli_writes_one_record_per_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config", _smoke)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: compat_make_mesh(
                            (2, 1, 2) if multi_pod else (2, 2),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model"), device="meta"))
    out = tmp_path / "dryrun.jsonl"
    dryrun.main(["--arch", "qwen2-1.5b", "--both-meshes", "--out",
                 str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["cell"], r["mesh"]) for r in recs] == [
        (c, m) for c in cells_for("qwen2-1.5b") for m in ("2x2", "2x1x2")]
    assert "cells traced OK" in capsys.readouterr().out


def test_diagnose_ranks_the_counter_tables(capsys):
    mesh = compat_make_mesh((1, 2), ("data", "model"), device="meta")
    _, counter, _ = dryrun.trace_cell(
        "qwen2-1.5b", "prefill_32k", cfg=get_smoke_config("qwen2-1.5b"),
        mesh=mesh)
    top = diagnose.diagnose(counter.analysis(), top=5)
    flops = [d["flops"] for _, d in top["by_flops"]]
    assert flops == sorted(flops, reverse=True) and flops[0] > 0
    assert any(name.startswith("kernel:flash_attention")
               for name, _ in counter.analysis().by_op.items())
    assert top["sites"] and "summary" in capsys.readouterr().out


def test_hillclimb_diffs_against_the_last_record(tmp_path, monkeypatch):
    base = {"arch": "qwen2-1.5b", "cell": "train_4k", "mesh": "16x16",
            "compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0,
            "bytes_per_device": 2**30, "roofline_fraction": 0.5,
            "dominant": "memory"}
    (tmp_path / "base.jsonl").write_text(json.dumps(base) + "\n")
    new = dict(base, compute_s=0.5, memory_s=3.0, dominant="memory")
    monkeypatch.setattr(hillclimb, "run_cell", lambda *a, **k: dict(new))
    log = tmp_path / "log.jsonl"
    for note in ("first", "second"):
        hillclimb.main(["--arch", "qwen2-1.5b", "--cell", "train_4k",
                        "--baseline", str(tmp_path / "base.jsonl"),
                        "--log", str(log), "--note", note])
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert recs[0]["delta_compute_s_pct"] == pytest.approx(-50.0)
    assert recs[0]["delta_memory_s_pct"] == pytest.approx(50.0)
    assert recs[0]["delta_collective_s_pct"] is None
    # the second run compares with the first logged one
    assert recs[1]["delta_compute_s_pct"] == pytest.approx(0.0)
    assert [r["note"] for r in recs] == ["first", "second"]
