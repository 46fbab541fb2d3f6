"""The port's job model against the JAX package's, on the CPU.

Every graph is built from one plain description in both packages
(``repro.core`` and ``repro_torch.core``): the paper §3.3 job-file text
that ``format_job_text`` writes must be identical, parsing must give the
same graph back, malformed and structurally invalid inputs must raise
``GraphValidationError`` in both, ``is_hybrid`` must classify alike, and
``DataChunk.nbytes`` must count the same bytes for fp32 and bf16.
"""
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

import repro.core as jc
import repro_torch.core as tc

PACKAGES = (jc, tc)

# segments of (name, fn, n_threads, refs, no_send_back); a ref is a job
# name or (job name, lo, hi) — the grammar cases of the JAX round-trip test
GRAPHS = {
    "minimal": [[("J1", 1, 0, (), False)]],
    "whole-refs": [[("J1", 1, 0, (), False), ("J2", 2, 1, (), False)],
                   [("J3", 3, 0, ("J1", "J2"), False)]],
    "sliced-refs": [[("J1", 1, 0, (), False)],
                    [("J2", 2, 2, (("J1", 0, 5),), True),
                     ("J3", 2, 2, (("J1", 5, 10),), True)]],
    "symbolic-fns": [[("A", "sweep", 4, (), False)],
                     [("B", "residual", 0, ("A",), False)]],
    "paper-sample": [[("J1", 1, 0, (), False), ("J2", 2, 1, (), False)],
                     [("J3", 2, 2, (("J1", 0, 5),), True),
                      ("J4", 2, 2, (("J1", 5, 10),), True),
                      ("J5", 3, 0, ("J1", "J2"), False)],
                     [("J7", 5, 1, ("J2", "J3", "J4", "J5"), False)]],
}


def build(pkg, spec):
    def ref(r):
        return pkg.ChunkRef(r) if isinstance(r, str) else pkg.ChunkRef(*r)
    return pkg.JobGraph([
        pkg.ParallelSegment([pkg.Job(name, fn, nt, tuple(ref(r) for r in refs),
                                     no_send_back=nsb)
                             for name, fn, nt, refs, nsb in seg])
        for seg in spec])


def describe(graph):
    """Package-independent view of a graph."""
    return [[(j.name, j.fn, j.n_threads,
              tuple((r.job, r.lo, r.hi) for r in j.inputs), j.no_send_back,
              j.segment) for j in seg.jobs] for seg in graph.segments]


def assert_same_text_and_parse(spec):
    graphs = [build(pkg, spec) for pkg in PACKAGES]
    texts = [pkg.format_job_text(g) for pkg, g in zip(PACKAGES, graphs)]
    assert texts[0] == texts[1]
    # each package parses the other's text to the same graph
    for pkg in PACKAGES:
        parsed = pkg.parse_job_text(texts[0])
        assert describe(parsed) == describe(graphs[0])
        assert pkg.format_job_text(parsed) == texts[0]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_format_and_parse_match_jax(name):
    assert_same_text_and_parse(GRAPHS[name])


@pytest.mark.parametrize("text", [
    "# header comment\nJ1(1,0,0);  # inline\nJ2(1,0,R1);;",
    """J1(1,0,0), J2(2,1,0);
J3(2,2,R1[0..5],true), J4(2,2,R1[5..10],true), J5(3,0,R1 R2);
J7(5,1, R2 R3 R4 R5);""",
    "J1(1,0,0), J2(1,0,0);\nJ3(2,1,R1 R2);",
], ids=["comments", "paper-sample", "paper-max"])
def test_parse_text_matches_jax(text):
    jg, tg = jc.parse_job_text(text), tc.parse_job_text(text)
    assert describe(jg) == describe(tg)
    assert jc.format_job_text(jg) == tc.format_job_text(tg)


@given(st.lists(st.lists(st.tuples(
    st.integers(1, 9),          # fn id
    st.integers(0, 4),          # n_threads
    st.booleans(),              # no_send_back
    st.integers(0, 2),          # 0 = no ref, 1 = whole ref, 2 = sliced ref
), min_size=1, max_size=4), min_size=1, max_size=5))
@settings(max_examples=25, deadline=None)
def test_random_graphs_format_alike(spec):
    segments, counter, prev = [], 0, []
    for seg in spec:
        jobs = []
        for fid, nt, nsb, kind in seg:
            counter += 1
            if prev and kind == 1:
                refs = (prev[counter % len(prev)],)
            elif prev and kind == 2:
                lo = counter % 3
                refs = ((prev[counter % len(prev)], lo, lo + 1 + counter % 4),)
            else:
                refs = ()
            jobs.append((f"J{counter}", fid, nt, refs, nsb))
        segments.append(jobs)
        prev = [j[0] for j in jobs]
    assert_same_text_and_parse(segments)
    graphs = [build(pkg, segments) for pkg in PACKAGES]
    assert graphs[0].is_hybrid() == graphs[1].is_hybrid()


@pytest.mark.parametrize("bad", [
    "J1(1,0",                    # unbalanced parens
    "J1(1)",                     # too few args
    "J1(1,0,0,true,extra)",      # too many args
    "J1(1,0,R1[3..2x])",         # malformed slice
    "J1(1,0,0,maybe)",           # bad no_send_back literal
    "J1(1,0,Q1)",                # refs must start with R
    "(1,0,0)",                   # missing job name
    "J1(1,0,0), J2(1,0,R1)",     # same-segment dependency
    "J1(1,0,R9)",                # unknown producer
    "J1(1,0,0); J1(2,0,0)",      # duplicate name
], ids=["unbalanced", "few-args", "many-args", "bad-slice", "bad-flag",
        "bad-ref", "no-name", "same-segment", "unknown", "duplicate"])
def test_malformed_and_invalid_inputs_raise_in_both(bad):
    for pkg in PACKAGES:
        with pytest.raises(pkg.GraphValidationError):
            pkg.parse_job_text(bad + ";")


def test_graph_mutation_errors_match():
    """add_dynamic into a completed segment, a duplicate dynamic name, and
    removing a job still consumed all raise in both packages."""
    for pkg in PACKAGES:
        g = pkg.parse_job_text("J1(1,0,0); J2(1,0,R1);")
        with pytest.raises(pkg.GraphValidationError):
            g.add_dynamic(pkg.Job("J3", 1, 0), 0, current=1)
        with pytest.raises(pkg.GraphValidationError):
            g.add_dynamic(pkg.Job("J2", 1, 0), 2, current=1)
        with pytest.raises(pkg.GraphValidationError):
            g.remove_job("J1")
        g.add_dynamic(pkg.Job("J3", 1, 0, (pkg.ChunkRef("J2"),)), 3,
                      current=1)
        assert [len(s) for s in g.segments] == [1, 1, 0, 1]
        g.remove_job("J3")
        assert g.n_jobs() == 2


@pytest.mark.parametrize("name", list(GRAPHS))
def test_is_hybrid_matches_jax(name):
    assert (build(jc, GRAPHS[name]).is_hybrid()
            == build(tc, GRAPHS[name]).is_hybrid())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_datachunk_nbytes_matches_jax(dtype):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    jchunk = jc.DataChunk(jnp.asarray(data, dtype=getattr(jnp, dtype)))
    tchunk = tc.DataChunk(torch.from_numpy(data).to(getattr(torch, dtype)))
    assert tchunk.nbytes == jchunk.nbytes == 12 * (4 if dtype == "float32"
                                                   else 2)
    assert tchunk.n_elem == jchunk.n_elem == 12
    jcd = jc.ChunkedData.from_array(jnp.asarray(data, getattr(jnp, dtype)), 2)
    tcd = tc.ChunkedData.from_array(torch.from_numpy(data).to(
        getattr(torch, dtype)), 2)
    assert [c.nbytes for c in tcd] == [c.nbytes for c in jcd]


def test_chunking_matches_jax():
    """Uneven splits follow np.array_split in both; numpy input becomes a
    tensor; to_array concatenates back."""
    data = np.arange(10, dtype=np.float32)
    jcd = jc.ChunkedData.from_array(data, 4)
    tcd = tc.ChunkedData.from_array(data, 4)
    assert [c.n_elem for c in tcd] == [c.n_elem for c in jcd] == [3, 3, 2, 2]
    assert all(isinstance(c.data, torch.Tensor) for c in tcd)
    np.testing.assert_array_equal(tcd.to_array().numpy(),
                                  np.asarray(jcd.to_array()))
    assert tc.ChunkRef("J1", 1, 3).select(tcd).nbytes == 20
    with pytest.raises(tc.GraphValidationError):
        tc.ChunkRef("J1", 2, 9).select(tcd)
