"""Port parity: ``solvers.bicgstab`` against the JAX package's.

The same numpy inputs go through both: the Wilson D at kappa = 0.12 on 4^4
hot links in complex128 (with and without a start vector) and complex64, the
A = I breakdown guard and b = 0. On the CPU ``WilsonDirac.apply`` takes
wilson_window's plain version; the ``gpu`` test runs the solve through the
kernel on the card and holds it against the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import solvers as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import solvers as ts  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA = 0.12


def _inputs(dtype, seed=11):
    """Hot links with the boundary phases, and a gaussian b and x0, as numpy."""
    rng = np.random.default_rng(seed)
    u = np.asarray(jw.apply_boundary_phases(jfields.hot_start(LAT, 3, seed=seed)))
    shape = LAT + (4, 3)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x0 = 0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return u.astype(dtype), b.astype(dtype), x0.astype(dtype)


def _both(dtype, eps, with_x0):
    u, b, x0 = _inputs(dtype)
    jd, td = jw.WilsonDirac(kappa=KAPPA), tw.WilsonDirac(kappa=KAPPA)
    uj, ut = jnp.asarray(u), to_torch(u)
    xj, itj, rsqj = js.bicgstab(lambda v: jd.apply(uj, v), jnp.asarray(b),
                                x0=jnp.asarray(x0) if with_x0 else None, eps=eps)
    xt, itt, rsqt = ts.bicgstab(lambda v: td.apply(ut, v), to_torch(b),
                                x0=to_torch(x0) if with_x0 else None, eps=eps)
    res = td.apply(ut, xt) - to_torch(b)
    return np.asarray(xj), int(itj), float(rsqj), to_numpy(xt), itt, float(rsqt), \
        float(torch.real(torch.sum(res.conj() * res))), b


@pytest.mark.parametrize("with_x0", [False, True], ids=["zero-start", "x0"])
def test_wilson_solve_matches_jax(with_x0):
    """tests/test_dirac.py's solve (kappa 0.12, eps 1e-22) in both packages."""
    xj, itj, rsqj, xt, itt, rsqt, true_rsq, b = _both(np.complex128, 1e-22, with_x0)
    assert abs(itt - itj) <= 1, (itt, itj)
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 1e-10
    assert true_rsq < 1e-16
    target = 1e-22 * max(float(np.vdot(b, b).real), 1.0)
    assert rsqt <= target and rsqj <= target
    assert itt < 500


def test_complex64_default_eps_ends_below_maxiter():
    """The f64-tuned default eps is clamped in complex64, in both packages."""
    xj, itj, rsqj, xt, itt, rsqt, true_rsq, b = _both(np.complex64, 1e-19, False)
    assert itj < 3000 and itt < 3000, (itj, itt)
    assert abs(itt - itj) <= 1, (itt, itj)
    bsq = float(np.vdot(b, b).real)
    assert rsqt <= 2.5e-13 * bsq
    assert true_rsq < 1e-9 * bsq
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 1e-5


def test_breakdown_guard_identity():
    """A = I converges at the alpha half step (s = 0 exactly): omega's 0/0 must
    not poison x with NaN (tests/test_dirac.py's guard case)."""
    b = np.random.default_rng(1).normal(size=(64,)) + 1j * np.random.default_rng(2).normal(size=(64,))
    xj, itj, _ = js.bicgstab(lambda v: v, jnp.asarray(b), eps=1e-22)
    xt, itt, rsqt = ts.bicgstab(lambda v: v, to_torch(b), eps=1e-22)
    xt = to_numpy(xt)
    assert np.all(np.isfinite(xt))
    assert np.max(np.abs(xt - b)) < 1e-12
    assert itt == int(itj) == 1
    assert float(rsqt) == 0.0
    np.testing.assert_array_equal(xt, np.asarray(xj))


def test_zero_rhs():
    """b = 0 meets the target before any iteration: x = 0, no apply."""
    calls = []

    def apply_a(v):
        calls.append(1)
        return v

    b = np.zeros(LAT + (4, 3), dtype=np.complex128)
    xj, itj, rsqj = js.bicgstab(lambda v: v, jnp.asarray(b))
    xt, itt, rsqt = ts.bicgstab(apply_a, to_torch(b))
    assert itt == int(itj) == 0 and not calls
    assert float(rsqt) == float(rsqj) == 0.0
    assert not np.any(to_numpy(xt)) and not np.any(np.asarray(xj))


@pytest.mark.gpu
def test_wilson_window_solve_on_gpu_matches_cpu():
    """On the card: bicgstab on WilsonDirac.apply launches wilson_window twice per
    iteration (once more with x0) and gives the CPU's iterations and x."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_bicgstab.py)")
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    u, b, x0 = _inputs(np.complex128)
    d = tw.WilsonDirac(kappa=KAPPA)
    dev = torch.device("cuda")
    for start in (None, x0):
        cpu = ts.bicgstab(lambda v: d.apply(to_torch(u), v), to_torch(b),
                          x0=None if start is None else to_torch(start), eps=1e-22)
        ug = to_torch(u, device=dev)
        before = ww.launches
        card = ts.bicgstab(lambda v: d.apply(ug, v), to_torch(b, device=dev),
                           x0=None if start is None else to_torch(start, device=dev), eps=1e-22)
        assert ww.launches - before == 2 * card[1] + (start is not None)
        assert card[1] == cpu[1]
        xc, xg = to_numpy(cpu[0]), to_numpy(card[0])
        assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-10
