"""The port's Jacobi kernels and solver against the JAX package's, on the
CPU.

* The plain versions (the CPU path of the port's wrappers) against JAX's
  ``impl="ref"`` oracles and the Pallas kernels in interpret mode, at the
  JAX kernel tests' shapes: (N, row block, col block) = (256, 128, 128) and
  (512, 256, 128), bf16 x, and ragged N 200/300/333.  Tolerance 1e-5 in
  fp32 and 3e-2 with bf16 x, as ``tests/test_kernels.py`` states.
* ``make_system`` builds bitwise the same system in both packages.
* ``jacobi_tailored`` (both ``kernel`` values; on the CPU ``auto`` runs
  the plain version), ``jacobi_hypar`` (three dispatch modes) and
  ``jacobi_spmd`` at n 256, 50 iterations: the same iteration count, x
  within 1e-5 and the same report (moved bytes, dynamic jobs); a tol > 0
  run stops at the same iteration in both, through the lagged residual.

The CUDA kernels themselves are held against the plain versions in
``test_torch_kernels_cuda.py``, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import jacobi as jj
from repro.core import VirtualCluster as JaxCluster
from repro.kernels.jacobi_sweep import ops as jops
from repro_torch.apps import jacobi as tj
from repro_torch.kernels.jacobi_sweep import (jacobi_sweep,
                                              jacobi_sweep_residual, kernel)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def system(n, seed=0):
    """The JAX kernel tests' distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) / n + np.eye(n) * 3.0).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return A, x, b, np.ascontiguousarray(np.diag(A))


def both(A, x, b, d, bf16_x=False):
    jx = jnp.asarray(x, jnp.bfloat16 if bf16_x else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16_x else torch.float32)
    return ((jnp.asarray(A), jx, jnp.asarray(b), jnp.asarray(d)),
            (torch.from_numpy(A), tx, torch.from_numpy(b),
             torch.from_numpy(d)))


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@pytest.mark.parametrize("n,rb,cb", [(256, 128, 128), (512, 256, 128)])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["fp32", "bf16x"])
def test_plain_versions_match_jax_kernels(n, rb, cb, bf16_x):
    jargs, targs = both(*system(n, seed=n), bf16_x=bf16_x)
    tol = BF16_TOL if bf16_x else TOL
    x_t = jacobi_sweep(*targs)
    assert x_t.dtype == targs[1].dtype
    for impl in ("ref", "interpret"):
        blocks = {} if impl == "ref" else dict(row_block=rb, col_block=cb)
        close(x_t, jops.jacobi_sweep(*jargs, impl=impl, **blocks), tol)
        x2_j, res_j = jops.jacobi_sweep_residual(*jargs, impl=impl, **blocks)
        x2_t, res_t = jacobi_sweep_residual(*targs)
        assert x2_t.dtype == targs[1].dtype and res_t.dtype == torch.float32
        close(x2_t, x2_j, tol)
        np.testing.assert_allclose(float(res_t), float(res_j), rtol=1e-5)


@pytest.mark.parametrize("n", [200, 300, 333])
def test_plain_versions_match_jax_at_ragged_n(n):
    """The JAX wrapper pads A to the block lcm; the port's kernel masks the
    tails.  Both must give the unpadded answer."""
    jargs, targs = both(*system(n, seed=n))
    close(jacobi_sweep(*targs),
          jops.jacobi_sweep(*jargs, impl="interpret", row_block=128,
                            col_block=128), TOL)
    x2_j, res_j = jops.jacobi_sweep_residual(*jargs, impl="interpret",
                                             row_block=128, col_block=128)
    x2_t, res_t = jacobi_sweep_residual(*targs)
    assert x2_t.shape == (n,)
    close(x2_t, x2_j, TOL)
    np.testing.assert_allclose(float(res_t), float(res_j), rtol=1e-5)


def test_kernel_impl_refuses_cpu_tensors():
    """No fallback: ``impl="kernel"`` on the CPU raises, and ``auto`` on
    the CPU never touches the kernel."""
    _, targs = both(*system(16))
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        jacobi_sweep(*targs, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        jacobi_sweep_residual(*targs, impl="kernel")
    jacobi_sweep_residual(*targs)
    assert kernel.launches == before


@pytest.mark.parametrize("n,seed", [(64, 0), (256, 3)])
def test_make_system_is_bitwise_the_same(n, seed):
    Aj, bj, xj = jj.make_system(n, seed)
    At, bt, xt = tj.make_system(n, seed, device="cpu")
    assert At.device.type == "cpu" and At.dtype == torch.float32
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(xt, xj)


N, ITERS = 256, 50


@pytest.fixture(scope="module")
def systems():
    Aj, bj, _ = jj.make_system(N)
    At, bt, _ = tj.make_system(N, device="cpu")
    return (Aj, bj), (At, bt)


def _jax_cluster():
    # one device on both sides (the tier-1 run may force several host
    # devices on the JAX side), so the byte accounting compares like with
    # like
    return JaxCluster(jax.devices()[:1], n_schedulers=1, max_workers=4)


def _assert_same_run(rt, rj):
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.x, rj.x, **TOL)
    assert rt.residual == pytest.approx(rj.residual, rel=1e-2, abs=1e-5)


@pytest.mark.parametrize("kern", [False, True], ids=["plain", "kernel"])
def test_tailored_matches_jax(systems, kern):
    (Aj, bj), (At, bt) = systems
    rj = jj.jacobi_tailored(Aj, bj, iters=ITERS, kernel=kern)
    rt = tj.jacobi_tailored(At, bt, iters=ITERS, kernel=kern)
    _assert_same_run(rt, rj)
    assert rt.iters == ITERS


@pytest.mark.parametrize("mode", ["sync", "pipelined", "dataflow"])
def test_hypar_matches_jax(systems, mode):
    (Aj, bj), (At, bt) = systems
    rj = jj.jacobi_hypar(Aj, bj, iters=ITERS, mode=mode,
                         cluster=_jax_cluster())
    rt = tj.jacobi_hypar(At, bt, iters=ITERS, mode=mode)
    _assert_same_run(rt, rj)
    assert rt.extra["moved_bytes"] == rj.extra["moved_bytes"]
    # the summary carries segments, moved/local bytes and dynamic jobs
    assert rt.extra["report"] == rj.extra["report"]


def test_spmd_matches_jax(systems):
    (Aj, bj), (At, bt) = systems
    _assert_same_run(tj.jacobi_spmd(At, bt, iters=ITERS),
                     jj.jacobi_spmd(Aj, bj, iters=ITERS))


@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_tol_stops_at_the_same_iteration(systems, tol):
    """Convergence is tested on the lagged residual ‖b − A·x_{k−1}‖: every
    variant of both packages stops at the same iteration, before the
    iteration bound.  The tolerances stay well above the fp32 floor of the
    residual (about 1e-6 at n 256, where the two packages' matvecs round
    differently)."""
    (Aj, bj), (At, bt) = systems
    want = jj.jacobi_tailored(Aj, bj, iters=500, tol=tol).iters
    assert 2 < want < 500
    got = {"tailored": tj.jacobi_tailored(At, bt, iters=500, tol=tol),
           "tailored-kernel": tj.jacobi_tailored(At, bt, iters=500, tol=tol,
                                                 kernel=True),
           "hypar": tj.jacobi_hypar(At, bt, iters=500, tol=tol),
           "spmd": tj.jacobi_spmd(At, bt, iters=500, tol=tol)}
    assert {k: r.iters for k, r in got.items()} == dict.fromkeys(got, want)
    assert jj.jacobi_hypar(Aj, bj, iters=500, tol=tol,
                           cluster=_jax_cluster()).iters == want
    assert jj.jacobi_spmd(Aj, bj, iters=500, tol=tol).iters == want
