"""Port parity: the staggered RHMC stack. The rational approximations,
the multi-shift CG, the Lanczos spectral guard, StaggeredFermiAction
(sampling, action, force) and staggered HMC trajectories replayed from the
JAX package's own draws, and run_lqcd_params end to end on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import eigen as jeigen  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops import rational as jrational  # noqa: E402
from latticeqcd_tpu.ops import solvers as jsolvers  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import eigen as teigen  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import rational as trational  # noqa: E402
from latticeqcd_torch.ops import solvers as tsolvers  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack, staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction as TSFA  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC, Draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
MASS = 0.5
BETA = 5.7


@pytest.fixture(scope="module")
def links():
    return jfields.hot_start(LAT, 3, seed=21)


def _actions(nf, lat=LAT, **kw):
    return (JSFA(js.StaggeredDirac(MASS, lat), nf=nf, **kw),
            TSFA(ts.StaggeredDirac(MASS, lat), nf=nf, **kw))


def _w_ops(u, lat=LAT):
    """The packed W of both packages on the same phased links."""
    jd, td = js.StaggeredDirac(MASS, lat), ts.StaggeredDirac(MASS, lat)
    ueo_j = jd.packed_links(jw.apply_boundary_phases(u))
    ueo_t = td.packed_links(tw.apply_boundary_phases(to_torch(np.asarray(u))))
    return (lambda v: jd.apply_w_packed(ueo_j, v)), (lambda v: td.apply_w_packed(ueo_t, v))


def _packed_field(seed, lat=LAT):
    rng = np.random.default_rng(seed)
    shape = (lat[0] // 2,) + lat[1:] + (3,)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _full_phi(seed, n_pf, lat=LAT):
    """Even-supported pseudofermions [n_pf, X, Y, Z, T, 3]."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n_pf,) + lat + (3,)) + 1j * rng.standard_normal((n_pf,) + lat + (3,))
    return phi * js.ks_phases(lat)[1][None, ..., None]


def jax_pf_normals(key, fa_t, lat=LAT, rdt=jnp.float64):
    """The normals StaggeredFermiAction.sample_pseudofermion draws from key in
    the JAX package (one split per pseudofermion, then re/im), in the port's
    noise_shape: masked to even sites and packed when every extent is even."""
    res, ims = [], []
    for _ in range(fa_t.n_pf):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        for out, k in ((res, k1), (ims, k2)):
            f = to_torch(jax.random.normal(k, lat + (3,), dtype=rdt))
            out.append(eo_pack.pack(f, lat, 0) if eo_pack.packable(lat) else f)
    return torch.stack(res), torch.stack(ims)


# ------------------------------------------------------------------ rational


@pytest.mark.parametrize("nf", range(1, 9))
def test_rational_coefficients_equal_jax(nf):
    fa_j, fa_t = _actions(nf)
    lo, hi = fa_j._bounds()
    assert (lo, hi) == fa_t._bounds()
    for jfn, tfn, beta in ((jrational.rational_inverse_power, trational.rational_inverse_power,
                            fa_j.action_beta),
                           (jrational.rational_power, trational.rational_power, fa_j.sample_beta)):
        a, b = jfn(beta, lo, hi, tol=1e-10), tfn(beta, lo, hi, tol=1e-10)
        assert (a.const, a.residues, a.shifts, a.lo, a.hi, a.max_rel_err) == \
            (b.const, b.residues, b.shifts, b.lo, b.hi, b.max_rel_err)
    with pytest.raises(ValueError):
        trational.rational_inverse_power(2.0, lo, hi)


# ------------------------------------------------------------------- solvers


def test_multishift_cg_matches_jax(links):
    w_j, w_t = _w_ops(links)
    b = _packed_field(1)
    pf = trational.rational_inverse_power(0.5, 0.25 * 0.999, 16.75)
    xj, itj, _ = jsolvers.multishift_cg(w_j, jnp.asarray(b), pf.shifts, eps=1e-22)
    log = []
    xt, itt, rsq = tsolvers.multishift_cg(w_t, to_torch(b), pf.shifts, eps=1e-22, log=log)
    assert xt.shape == (len(pf.shifts),) + b.shape
    assert np.abs(np.asarray(xj) - to_numpy(xt)).max() < 1e-10
    assert abs(int(itj) - itt) <= 1
    assert len(log) == 1 and log[0]["iterations"] == itt and log[0]["shifts"] == len(pf.shifts)
    assert log[0]["rsq"] <= log[0]["target"] == 1e-22
    # every shifted system is solved
    bt = to_torch(b)
    for k, sigma in enumerate(pf.shifts):
        res = bt - w_t(xt[k]) - sigma * xt[k]
        assert float(res.abs().max()) < 1e-8


def test_lanczos_and_extreme_eigs_match_jax(links):
    w_j, w_t = _w_ops(links)
    v0 = _packed_field(2)
    aj, bj = jeigen.lanczos_tridiag(w_j, jnp.asarray(v0), 12)
    at, bt = teigen.lanczos_tridiag(w_t, to_torch(v0), 12)
    assert np.abs(np.asarray(aj) - to_numpy(at)).max() < 1e-10
    assert np.abs(np.asarray(bj) - to_numpy(bt)).max() < 1e-10
    ej = jeigen.extreme_eigs(w_j, jnp.asarray(v0), m=24)
    et = teigen.extreme_eigs(w_t, to_torch(v0), m=24)
    assert np.abs(np.subtract(ej, et)).max() < 1e-10
    assert MASS ** 2 * 0.999 < et[0] < et[1] < MASS ** 2 + 16.5


def test_spectral_guard_matches_jax(links):
    fa_j, fa_t = _actions(2)
    ut = to_torch(np.asarray(links))
    _, v0 = fa_j._w_matvec_packed_start(links)
    v0t = to_torch(np.asarray(v0))
    rj = fa_j.spectral_range_w(links, m=16)
    rt = fa_t.spectral_range_w(ut, m=16, v0=v0t)
    assert np.abs(np.subtract(rj, rt)).max() < 1e-10
    lj = float(fa_j.lambda_max_w(links, 12))
    lt = float(fa_t.lambda_max_w(ut, 12, v0=v0t))
    assert abs(lj - lt) < 1e-10
    # the port's own start vector: seeded, even-supported, packed
    _, v_own = fa_t._w_matvec_packed_start(ut)
    assert v_own.shape == v0t.shape and torch.equal(v_own, fa_t._w_matvec_packed_start(ut)[1])
    same, lam = fa_t.ensure_spectral_bounds(ut, lam=rt[1])
    assert same is fa_t and lam == rt[1]
    wide, _ = fa_t.ensure_spectral_bounds(ut, lam=20.0)
    assert wide._bounds()[1] == pytest.approx(21.0) and wide.nf == 2


# -------------------------------------------------------------------- action


@pytest.mark.parametrize("nf", [2, 3, 4, 6])
def test_sample_action_force_match_jax(links, nf):
    fa_j, fa_t = _actions(nf, eps_cg=1e-22)
    ut = to_torch(np.asarray(links))
    key = jax.random.PRNGKey(30 + nf)
    s_j, phi_j = fa_j.sample_pseudofermion(links, key)
    assert fa_t.noise_shape(ut) == (fa_t.n_pf, 2, 4, 4, 4, 3)
    s_t, phi_t = fa_t.sample_pseudofermion(ut, normals=jax_pf_normals(key, fa_t))
    assert phi_t.shape == phi_j.shape == (fa_t.n_pf,) + LAT + (3,)
    assert abs(float(s_j) - float(s_t)) < 1e-10 * float(s_j)
    assert np.abs(np.asarray(phi_j) - to_numpy(phi_t)).max() < 1e-10

    phi = _full_phi(40 + nf, fa_t.n_pf)
    log = []
    a_j = float(fa_j.action(links, jnp.asarray(phi)))
    a_t = float(fa_t.action(ut, to_torch(phi), log=log))
    assert abs(a_j - a_t) < 1e-10 * abs(a_j)
    assert len(log) == fa_t.n_pf and all(r["rsq"] <= r["target"] for r in log)
    f_j = np.asarray(fa_j.force(links, jnp.asarray(phi)))
    f_t, xs = fa_t.force_with_guess(ut, to_torch(phi), None)
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-10
    if nf == 4:  # single pole: a plain CG whose solution W^-1 phi threads on
        w_t = _w_ops(links)[1]
        b = ts.StaggeredDirac(MASS, LAT).pack(to_torch(phi[0]), 0)
        assert len(xs) == 1 and float((w_t(xs[0]) - b).abs().max()) < 1e-9
        f_w, _ = fa_t.force_with_guess(ut, to_torch(phi), xs)
        assert float((f_w - f_t).abs().max()) < 1e-10
    else:  # multi-shift CG starts from zero: no guess to thread
        assert xs is None
    assert float((fa_t.force(ut, to_torch(phi)) - f_t).abs().max()) < 1e-12


def test_force_full_volume_path_matches_jax():
    """Odd x extent: no even-odd packing, W on masked full-volume fields."""
    lat = (3, 2, 2, 2)
    u = jfields.hot_start(lat, 3, seed=62)
    fa_j, fa_t = _actions(3, lat=lat, eps_cg=1e-22)
    ut = to_torch(np.asarray(u))
    assert fa_t.noise_shape(ut) == (1,) + lat + (3,)
    phi = _full_phi(5, 1, lat=lat)
    assert abs(float(fa_j.action(u, jnp.asarray(phi))) - float(fa_t.action(ut, to_torch(phi)))) < 1e-10
    f_j = np.asarray(fa_j.force(u, jnp.asarray(phi)))
    assert np.abs(f_j - to_numpy(fa_t.force(ut, to_torch(phi)))).max() < 1e-10


@pytest.mark.parametrize("nf", [1, 2, 3, 4, 5, 8])
def test_sampling_action_consistency(links, nf):
    """S_f(phi; U) right after sampling equals |xi|^2 up to the rational
    tolerance: the W^(Nf/8) / W^(-Nf/4) pair and the multi-shift CG end to end."""
    _, fa = _actions(nf, eps_cg=1e-26, rational_tol=1e-12)
    s_old, phi = fa.sample_pseudofermion(to_torch(np.asarray(links)),
                                         generator=torch.Generator().manual_seed(nf))
    s_eval = fa.action(to_torch(np.asarray(links)), phi)
    assert abs(float(s_old) - float(s_eval)) < 1e-6 * float(s_old)


# ----------------------------------------------------------------------- HMC


def jax_draws(key, u, fa_t) -> Draws:
    """The draws of HMC._step_fused for this key: momentum normals from
    k_mom, the pseudofermion normals from k_ferm, the uniform from k_acc."""
    _, k_mom, k_ferm, k_acc = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_mom)
    mom = (to_torch(jax.random.normal(k1, u.shape, dtype=jnp.float64)),
           to_torch(jax.random.normal(k2, u.shape, dtype=jnp.float64)))
    return Draws(mom, jax_pf_normals(k_ferm, fa_t), float(jax.random.uniform(k_acc, dtype=jnp.float64)))


@pytest.mark.parametrize("nf,md_steps", [(4, 10), (2, 4)])
def test_staggered_trajectory_matches_jax(nf, md_steps):
    """beta 5.7, mass 0.5, dtau 0.1: Nf=4 HMC (single pole, chronological
    CG) and Nf=2 RHMC (18 poles, multi-shift CG)."""
    u = jfields.hot_start(LAT, 3, seed=80 + nf)
    key = jax.random.PRNGKey(90 + nf)
    fa_j, fa_t = _actions(nf)
    kw = dict(dtau=0.1, md_steps=md_steps)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA), fermi_action=fa_j,
                        staged=False, **kw).step(u, key)
    ut = to_torch(np.asarray(u))
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, BETA), fermi_action=fa_t, **kw).step(
        ut, draws=jax_draws(key, u, fa_t))
    assert abs(float(st_j["dH"]) - st_t["dH"]) < 1e-9
    assert bool(st_j["accepted"]) == st_t["accepted"]
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-10
    for k in ("sf_old", "sf_new", "sg_new", "sp_new"):
        a = float(st_j[k])
        assert abs(a - st_t[k]) < 1e-9 * max(1.0, abs(a)), k
    # one solve per force and the final action solve, all converged
    assert len(st_t["cg"]) == md_steps + 1
    assert all(c["rsq"] <= c["target"] for c in st_t["cg"])
    assert ("shifts" in st_t["cg"][0]) == (nf != 4)


def _params(**kw):
    base = dict(L=LAT, NC=3, beta=BETA, initial="hot", update_method="HMC", quench=False,
                Dirac_operator="Staggered", mass=MASS, Nf=2, dtau=0.05, MDsteps=3, Nsteps=2,
                eps=1e-14, randomseed=5, verboselevel=2,
                measurement_methods=[{"methodname": "Plaquette"}])
    base.update(kw)
    return Params(**base)


def test_run_lqcd_params_staggered_cpu(capsys):
    history = []
    plaq = run_lqcd_params(_params(), make_dirs=False, dtype=torch.complex128, device="cpu",
                           history=history)
    out = capsys.readouterr().out
    assert 0.0 < plaq < 1.0
    assert [r["itrj"] for r in history] == [1, 2]
    assert all(np.isfinite(r["dH"]) and r["cg"] for r in history)
    assert all(c["shifts"] == 18 for r in history for c in r["cg"])
    assert "# staggered W: spectrum ~ [" in out and "rational window [0.2497, 16.75]" in out


def test_run_refuses_odd_staggered_lattice_on_the_card():
    with pytest.raises(NotImplementedError, match="A11"):
        run_lqcd_params(_params(L=(3, 4, 4, 4)), make_dirs=False, device="cuda")
