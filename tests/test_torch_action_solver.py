"""Port parity: CG on the even-odd normal operator and the two-flavour
Wilson pseudofermion action, its sampling and its force."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import solvers as jsolvers  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import solvers as tsolvers  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA = 0.141139


@pytest.fixture(scope="module")
def links():
    return jfields.hot_start(LAT, 3, seed=61)


def _rhs(seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    shape = (LAT[0] // 2,) + LAT[1:] + (4, 3)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _ops(u, dtype):
    jd, td = jw.WilsonDirac(kappa=KAPPA), tw.WilsonDirac(kappa=KAPPA)
    uj = jw.apply_boundary_phases(u).astype(dtype)
    ut = tw.apply_boundary_phases(to_torch(np.asarray(u))).to(getattr(torch, jnp.dtype(dtype).name))
    ueo_j, ueo_t = jd.packed_links(uj), td.packed_links(ut)
    return (lambda v: jd.apply_dhat_ddag(ueo_j, v)), (lambda v: td.apply_dhat_ddag(ueo_t, v))


def test_cg_matches_jax_on_normal_operator(links):
    a_j, a_t = _ops(links, jnp.complex128)
    b = _rhs(1)
    xj, itj, _ = jsolvers.cg(a_j, jnp.asarray(b), eps=1e-20)
    log = []
    xt, itt, rsq = tsolvers.cg(a_t, to_torch(b), eps=1e-20, log=log)
    assert np.abs(np.asarray(xj) - to_numpy(xt)).max() < 1e-10
    assert abs(int(itj) - itt) <= 1
    assert log[0]["iterations"] == itt and log[0]["rsq"] <= log[0]["target"]
    # a warm start from a nearby guess converges to the same solution, to
    # the solver's tolerance (|r| ~ 1e-10 |b|, two different Krylov paths)
    x0 = xt + 1e-3 * to_torch(_rhs(2))
    xw, itw, _ = tsolvers.cg(a_t, to_torch(b), x0=x0, eps=1e-20)
    assert itw < itt
    assert float((xw - xt).abs().max()) < 1e-8


def test_cg_complex64_verified_restarts(links):
    """complex64: the returned |r|^2 is the verified true residual and the
    solution agrees with the JAX package's complex64 CG."""
    a_j, a_t = _ops(links, jnp.complex64)
    b = _rhs(3, np.complex64)
    xj, itj, rsq_j = jsolvers.cg(a_j, jnp.asarray(b), eps=1e-19)
    log = []
    bt = to_torch(b)
    xt, itt, rsq_t = tsolvers.cg(a_t, bt, eps=1e-19, log=log)
    r_true = bt - a_t(xt)
    assert abs(float(torch.sum(r_true.conj() * r_true).real) - float(rsq_t)) < 1e-3 * float(rsq_t)
    bsq = float(torch.sum(bt.conj() * bt).real)
    assert log[0]["target"] == pytest.approx(3e-11)
    assert float(rsq_t) / bsq < 1e-9
    assert float(rsq_j) / bsq < 1e-9
    xt_scale = float(xt.abs().max())
    assert np.abs(np.asarray(xj) - to_numpy(xt)).max() < 1e-4 * xt_scale
    assert abs(int(itj) - itt) <= 3
    assert tsolvers._effective_eps(1e-19, torch.complex64) == 2.5e-13


def test_sample_pseudofermion_from_jax_normals(links):
    key = jax.random.PRNGKey(8)
    ja, ta = JFA(jw.WilsonDirac(kappa=KAPPA)), TFA(tw.WilsonDirac(kappa=KAPPA))
    s_j, phi_j = ja.sample_pseudofermion(links, key)
    k1, k2 = jax.random.split(key)
    shape = (LAT[0] // 2,) + LAT[1:] + (4, 3)
    normals = (to_torch(jax.random.normal(k1, shape, dtype=jnp.float64)),
               to_torch(jax.random.normal(k2, shape, dtype=jnp.float64)))
    s_t, phi_t = ta.sample_pseudofermion(to_torch(np.asarray(links)), normals=normals)
    assert abs(float(s_j) - float(s_t)) < 1e-10
    assert np.abs(np.asarray(phi_j) - to_numpy(phi_t)).max() < 1e-12


def test_action_and_force_match_jax(links):
    ja = JFA(jw.WilsonDirac(kappa=KAPPA), eps_cg=1e-20)
    ta = TFA(tw.WilsonDirac(kappa=KAPPA), eps_cg=1e-20)
    phi = _rhs(4)
    ut = to_torch(np.asarray(links))
    s_j = float(ja.action(links, jnp.asarray(phi)))
    s_t = float(ta.action(ut, to_torch(phi)))
    assert abs(s_j - s_t) < 1e-10 * abs(s_j)
    f_j = np.asarray(ja.force(links, jnp.asarray(phi)))
    f_t, x_t = ta.force_with_guess(ut, to_torch(phi), None)
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-10
    f_w, _ = ta.force_with_guess(ut, to_torch(phi), x_t)
    assert float((f_w - f_t).abs().max()) < 1e-10
    assert float((ta.force(ut, to_torch(phi)) - f_t).abs().max()) < 1e-12


def test_force_matches_jax_at_r_half(links):
    """The Wilson fermion force at r = 0.5 (the even-odd path through the packed hop's
    plain version at r = 0.5 and its r-generic link gradients) against the JAX
    package's jitted force on the same pseudofermion, complex128."""
    ja = JFA(jw.WilsonDirac(kappa=KAPPA, r=0.5), eps_cg=1e-20)
    ta = TFA(tw.WilsonDirac(kappa=KAPPA, r=0.5), eps_cg=1e-20)
    phi = _rhs(6)
    f_j = np.asarray(ja.force(links, jnp.asarray(phi)))
    f_t = ta.force(to_torch(np.asarray(links)), to_torch(phi))
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-12


def test_force_full_volume_path_matches_jax():
    """Odd x extent: no even-odd packing, CG on D D^dag (WilsonDslash backward)."""
    lat = (3, 2, 2, 2)
    u = jfields.hot_start(lat, 3, seed=62)
    rng = np.random.default_rng(5)
    phi = rng.standard_normal(lat + (4, 3)) + 1j * rng.standard_normal(lat + (4, 3))
    ja = JFA(jw.WilsonDirac(kappa=0.12), eps_cg=1e-22)
    ta = TFA(tw.WilsonDirac(kappa=0.12), eps_cg=1e-22)
    f_j = np.asarray(ja.force(u, jnp.asarray(phi)))
    f_t = ta.force(to_torch(np.asarray(u)), to_torch(phi))
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-10
