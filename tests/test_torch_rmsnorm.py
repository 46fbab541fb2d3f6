"""The port's RMSNorm against the JAX package's, on the CPU.

* ``rmsnorm(impl="ref")`` (the plain version, the port's CPU path) against
  JAX's ``rmsnorm`` under ``impl="ref"`` (its jnp oracle) and
  ``impl="interpret"`` (the Pallas kernel through the interpreter), at the
  shapes of ``tests/test_kernels.py``'s RMSNorm test, (64, 128), (256,
  512) and (8, 1024), plus ragged rows (13, 96) and a 3-d input (2, 5,
  64), in fp32 and bf16.  Inputs are drawn with numpy (seed 0) and cast to
  bf16 on each side, which rounds both the same way.  Tolerance 1e-6 in
  fp32 (the two sum the squares in different orders) and 2e-2 in bf16
  (one output spacing at |out| of a few), the reference test's own.
* ``apply_norm(use_kernel=True)`` equals ``use_kernel=False`` in the port
  and JAX's ``apply_norm`` with the switch either way.
* The kernel path refuses CPU tensors.

The CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``, on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_kernel, rmsnorm_plain
from repro_torch.models import layers as tlayers

SHAPES = [(64, 128), (256, 512), (8, 1024), (13, 96), (2, 5, 64)]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, jnp.asarray(g)), (tx, torch.from_numpy(g))


@pytest.mark.parametrize("jax_impl", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_jax(shape, dtype, jax_impl):
    (jx, jg), (tx, tg) = _inputs(shape, dtype)
    want = jax_rmsnorm(jx, jg, impl=jax_impl)
    got = rmsnorm(tx, tg, impl="ref")
    assert got.shape == tx.shape and got.dtype == tx.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_auto_on_cpu_is_the_plain_version(eps):
    _, (tx, tg) = _inputs((3, 7, 48), "float32", seed=1)
    want = rmsnorm_plain(tx.reshape(-1, 48), tg, eps=eps).reshape(tx.shape)
    assert torch.equal(rmsnorm(tx, tg, eps=eps), want)
    # a pinned launch shape means nothing to the plain version
    assert torch.equal(rmsnorm(tx, tg, eps=eps, row_block=2), want)


@pytest.fixture(scope="module")
def cfgs():
    j = dataclasses.replace(jax_smoke("qwen2-1.5b"), compute_dtype="float32")
    t = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                            compute_dtype="float32")
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_kernel_switch_matches_plain_and_jax(cfgs, dtype):
    jc, tc = cfgs
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(tc.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tp = {"scale": torch.from_numpy(scale)}
    jp = {"scale": jnp.asarray(scale)}
    got = tlayers.apply_norm(tc, tp, tx, use_kernel=True)
    assert torch.equal(got, tlayers.apply_norm(tc, tp, tx))
    tol = TOL[dtype]
    for use_kernel in (False, True):
        want = jlayers.apply_norm(jc, jp, jx, use_kernel=use_kernel)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_kernel_impl_refuses_cpu_tensors():
    _, (tx, tg) = _inputs((4, 32), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(tx, tg, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm_kernel(tx, tg, eps=1e-6, row_block=4)
    with pytest.raises(ValueError, match="unknown impl"):
        rmsnorm(tx, tg, impl="interpret")
