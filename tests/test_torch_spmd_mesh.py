"""The port's ``SpmdExecutor`` over a device mesh, and ``jacobi_spmd(mesh=)``,
on the CPU, where every grid position is the CPU.

* The reference's multi-device test (``tests/test_sharding.py:160-186``):
  8 positions on ``("data",)``, J1 (16 chunks) and J2 (8 chunks)
  co-scheduled in one segment, then ``run_iterative``'s fused loop.
* ``tests/test_executor_parity.py``'s SPMD fixtures (and the paper's max
  example) over an 8-position ``("data",)`` grid and a 4 x 2 ``("data",
  "model")`` grid against the JAX package's ``SpmdExecutor``: the chunk
  axis splits over the longest prefix of the chunk axes whose extents'
  product divides the chunk count, ``no_send_back`` results stay as blocks
  on their positions, sent-back results are gathered on the lead.
* ``jacobi_spmd(mesh=)`` against the meshless solve.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.apps import jacobi as tj
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from test_torch_executor import FIXTURES, _assert_results_match, _report_view

CPU = torch.device("cpu")
MESHES = {"data8": ((8,), ("data",)), "data4_model2": ((4, 2),
                                                        ("data", "model"))}


def _mesh(name):
    shape, axes = MESHES[name]
    return compat_make_mesh(shape, axes, device="cpu")


def test_eight_positions_co_schedule_and_iterate():
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c * c)
    g = tc.JobGraph()
    g.add_segment([tc.Job("J1", 1, 0), tc.Job("J2", 1, 0)])
    g.bind_input("J1", np.arange(16, dtype=np.float32).reshape(16, 1),
                 n_chunks=16)
    g.bind_input("J2", np.arange(8, dtype=np.float32).reshape(8, 1),
                 n_chunks=8)
    ex = tc.SpmdExecutor(_mesh("data8"), reg, chunk_axes=("data",))
    assert ex.device == CPU
    res, report = ex.run(g)
    assert report.mode == "spmd" and len(report.segments) == 1
    assert report.segments[0].co_scheduled == [("J1", "J2")]
    assert isinstance(res["J1"], torch.Tensor)      # sent back: gathered
    np.testing.assert_allclose(res["J1"].numpy().ravel(),
                               np.arange(16) ** 2)
    np.testing.assert_allclose(res["J2"].numpy().ravel(), np.arange(8) ** 2)
    spec = tc.IterativeSpec(body=lambda c: c * 0.5,
                            cond=lambda c: c.max() > 1.0, max_iters=100)
    final, iters = ex.run_iterative(spec, torch.tensor([64.0]))
    assert iters == 6 and float(final[0]) == 1.0, (iters, final)


@pytest.mark.parametrize("chunks,blocks", [(16, 8), (8, 8), (4, 4), (12, 4),
                                           (3, 1)])
def test_no_send_back_results_stay_in_blocks(chunks, blocks):
    """A ``no_send_back`` group's result is one block a position of the
    longest dividing prefix of (data 4, model 2): 8 blocks, else 4, else
    one (data's 4 does not divide 3 chunks: the prefix is empty).  One
    block is a tensor on the lead.  Slices keep their pieces in place."""
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c + 1.0)
    g = tc.JobGraph()
    g.add_segment([tc.Job("P", 1, 0, no_send_back=True)])
    g.bind_input("P", np.arange(chunks * 2, dtype=np.float32).reshape(
        chunks, 2), n_chunks=chunks)
    res, _ = tc.SpmdExecutor(_mesh("data4_model2"), reg).run(g)
    want = np.arange(chunks * 2).reshape(chunks, 1, 2) + 1.0   # a row a chunk
    got = res["P"]
    if blocks == 1:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert isinstance(got, tc.ChunkBlocks) and len(got.blocks) == blocks
    assert got.shape == (chunks, 1, 2) and len(got) == chunks
    np.testing.assert_array_equal(np.asarray(got), want)
    part = got[1:chunks - 1]
    np.testing.assert_array_equal(part.gather(CPU).numpy(), want[1:-1])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", [n for n, f in FIXTURES.items() if f[2]])
def test_spmd_fixtures_on_a_mesh_match_jax(name, mesh):
    jfix, tfix, _ = FIXTURES[name]
    (jg, jreg), (tg, treg) = jfix(), tfix()
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jres, jrep = jc.SpmdExecutor(jmesh, jreg).run(jg)
    tres, trep = tc.SpmdExecutor(_mesh(mesh), treg).run(tg)
    _assert_results_match(jres, tres)
    assert _report_view(trep) == _report_view(jrep)


def test_a_device_is_the_one_by_one_grid():
    ex = tc.SpmdExecutor("cpu", tc.FunctionRegistry())
    assert ex.mesh.size == 1 and ex.device == CPU
    assert ex.mesh.shape == {"data": 1}


@pytest.mark.parametrize("mesh", [make_test_mesh(2, 2),
                                  compat_make_mesh((8,), ("data",),
                                                   device="cpu")],
                         ids=["2x2", "data8"])
def test_jacobi_spmd_on_a_mesh_matches_the_meshless_solve(mesh):
    A, b, _ = tj.make_system(256, device="cpu")
    plain = tj.jacobi_spmd(A, b, iters=50)
    on_mesh = tj.jacobi_spmd(A, b, iters=50, mesh=mesh)
    assert on_mesh.iters == plain.iters
    np.testing.assert_array_equal(on_mesh.x, plain.x)
    assert on_mesh.residual == plain.residual
