"""Port parity: field starts and SU(N) algebra against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import sun as jsun  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import sun as tsun  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

TOL = 1e-13


def _herm(rng, shape, nc):
    a = rng.standard_normal(shape + (nc, nc)) + 1j * rng.standard_normal(shape + (nc, nc))
    return np.array(jsun.traceless_hermitian(jnp.asarray(a)))


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_hot_start_bit_identical(dtype):
    lat = (4, 2, 2, 4)
    a = np.asarray(jfields.hot_start(lat, 3, seed=17, dtype=jnp.dtype(dtype)))
    b = to_numpy(tfields.hot_start(lat, 3, seed=17, dtype=getattr(torch, dtype), device="cpu"))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_cold_start_and_roll():
    from latticeqcd_tpu.ops import rolls as jrolls
    from latticeqcd_torch.ops import rolls as trolls

    lat = (2, 4, 2, 2)
    np.testing.assert_array_equal(np.asarray(jfields.cold_start(lat, 3)),
                                  to_numpy(tfields.cold_start(lat, 3, device="cpu")))
    u = jfields.hot_start(lat, 2, seed=3)
    for mu in range(4):
        np.testing.assert_array_equal(np.asarray(jrolls.roll(u[0], -1, mu)),
                                      to_numpy(trolls.roll(to_torch(u[0]), -1, mu)))
    np.testing.assert_array_equal(np.asarray(jrolls.roll(u, (1, -1), (1, 3))),
                                  to_numpy(trolls.roll(to_torch(u), (1, -1), (1, 3))))


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_expi_hermitian(nc):
    rng = np.random.default_rng(nc)
    h = _herm(rng, (3, 5), nc)
    h[0, 0] *= 1e-6  # the small-Q branches
    for eps in (0.05, 0.7):
        a = np.asarray(jsun.expi_hermitian(jnp.asarray(h), eps))
        b = to_numpy(tsun.expi_hermitian(to_torch(h), eps))
        assert np.abs(a - b).max() < TOL


def test_projections_energy_reunitarize():
    rng = np.random.default_rng(5)
    m = rng.standard_normal((2, 3, 3, 3)) + 1j * rng.standard_normal((2, 3, 3, 3))
    for f in ("traceless_hermitian", "dagger"):
        a = np.asarray(getattr(jsun, f)(jnp.asarray(m)))
        assert np.abs(a - to_numpy(getattr(tsun, f)(to_torch(m)))).max() < TOL
    h = _herm(rng, (4, 2), 3)
    assert abs(float(jsun.kinetic_energy(jnp.asarray(h)))
               - float(tsun.kinetic_energy(to_torch(h)))) < TOL * 10
    u = np.asarray(jfields.hot_start((2, 2, 2, 2), 3, seed=9))
    noisy = u + 1e-4 * (rng.standard_normal(u.shape) + 1j * rng.standard_normal(u.shape))
    a = np.asarray(jsun.reunitarize(jnp.asarray(noisy)))
    b = to_numpy(tsun.reunitarize(to_torch(noisy)))
    assert np.abs(a - b).max() < TOL
    assert abs(float(jsun.unitarity_defect(jnp.asarray(noisy)))
               - float(tsun.unitarity_defect(to_torch(noisy)))) < TOL


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_random_hermitian_momentum_from_jax_normals(dtype):
    """The port fed the JAX package's own normals gives its momenta."""
    key = jax.random.PRNGKey(21)
    shape = (4, 2, 2, 2, 2)
    rdt = jnp.float64 if dtype == "complex128" else jnp.float32
    h = jsun.random_hermitian_momentum(key, shape, 3, dtype=jnp.dtype(dtype))
    k1, k2 = jax.random.split(key)
    re = jax.random.normal(k1, shape + (3, 3), dtype=rdt)
    im = jax.random.normal(k2, shape + (3, 3), dtype=rdt)
    got = tsun.random_hermitian_momentum(shape, 3, dtype=getattr(torch, dtype),
                                         normals=(to_torch(re), to_torch(im)))
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(np.asarray(h) - to_numpy(got)).max() < (TOL if dtype == "complex128" else 1e-6)


def test_random_hermitian_momentum_from_generator():
    g = torch.Generator().manual_seed(4)
    h = tsun.random_hermitian_momentum((4, 8, 8), 3, device="cpu", generator=g)
    assert torch.allclose(h, tsun.dagger(h))
    assert float(tsun.trace(h).abs().max()) < 1e-14
    # E tr(H^2) = (NC^2 - 1)/2 per matrix
    per = float(tsun.kinetic_energy(h)) / (4 * 8 * 8)
    assert abs(per - 4.0) < 0.3
