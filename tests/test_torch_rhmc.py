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


# ------------------------------------------------- the pbp anchor's dH (C5)

ANCHOR_LAT = (12, 12, 12, 8)
ANCHOR_KEYS = (101, 202)  # two sets of draws


def _anchor_start(dtype):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "PERF_CAPTURE", "pbp56_ckpt.npz")) as z:
        return np.asarray(z["u"]).astype(dtype)


def _anchor_draws(key, u, fa_t, rdt) -> Draws:
    """jax_draws in the real type rdt of the run (the JAX package draws its
    momenta, noise and uniform in the links' real type)."""
    _, k_mom, k_ferm, k_acc = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_mom)
    mom = (to_torch(jax.random.normal(k1, u.shape, dtype=rdt)),
           to_torch(jax.random.normal(k2, u.shape, dtype=rdt)))
    return Draws(mom, jax_pf_normals(k_ferm, fa_t, lat=ANCHOR_LAT, rdt=rdt),
                 float(jax.random.uniform(k_acc, dtype=rdt)))


def _anchor_trajectory(u_np, key, device="cpu", jax_too=True):
    """One trajectory of the pbp anchor (beta 5.6, Nf=4 staggered, m = 0.025,
    35 QPQ steps of 1/35, eps_cg 1e-10): (JAX dH or None, the port's dH)."""
    rdt = jnp.float64 if u_np.dtype == np.complex128 else jnp.float32
    kw = dict(nf=4, eps_cg=1e-10, max_cg=4000)
    fa_t = TSFA(ts.StaggeredDirac(0.025, ANCHOR_LAT), **kw)
    hmc_kw = dict(dtau=1.0 / 35, md_steps=35)
    draws = _anchor_draws(key, u_np, fa_t, rdt)
    if device != "cpu":
        draws = Draws(tuple(x.to(device) for x in draws.mom),
                      tuple(x.to(device) for x in draws.xi), draws.uniform)
    _, st_t = THMC(action=tga.wilson_gauge_action(3, 5.6), fermi_action=fa_t, **hmc_kw).step(
        convert.to_torch(u_np, device=device), draws=draws)
    assert all(c["iterations"] < 4000 for c in st_t["cg"])
    if not jax_too:
        return None, st_t["dH"]
    fa_j = JSFA(js.StaggeredDirac(0.025, ANCHOR_LAT), **kw)
    _, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.6), fermi_action=fa_j, staged=False,
                      **hmc_kw).step(jnp.asarray(u_np), key)
    return float(st_j["dH"]), st_t["dH"]


@pytest.mark.slow
@pytest.mark.parametrize("dtype,bar", [(np.complex128, 1e-6), (np.complex64, 0.5)])
def test_anchor_trajectory_dh_matches_jax(dtype, bar):
    """ROADMAP C5: one anchor trajectory from PERF_CAPTURE/pbp56_ckpt.npz per
    set of draws, the same injected momenta, noise and uniform in both
    packages. complex128 holds the port to the JAX package's dH (the same
    arithmetic); complex64 only to 0.5, as the packages sum float32 in
    different orders."""
    u = _anchor_start(dtype)
    for seed in ANCHOR_KEYS:
        dh_j, dh_t = _anchor_trajectory(u, jax.random.PRNGKey(seed))
        print(f"anchor dH {np.dtype(dtype).name} key {seed}: JAX {dh_j!r} port {dh_t!r}")
        assert abs(dh_j - dh_t) < bar, (seed, dh_j, dh_t)


def _anchor_energy_change(u_np, seed, device="cpu"):
    """The port's complex64 anchor trajectory for key ``seed`` on ``device``: (its
    dH, the energy change of that same trajectory recomputed in complex128 with
    float64 sums and the final action solved to 1e-24, and S_f(U_old, phi) -
    |xi|^2, the part of dH the pseudofermion heatbath's solve at eps_cg 1e-10
    leaves, as HMC takes S_f(U_old, phi) to be |xi|^2)."""
    from unittest import mock

    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import sun as tsun
    from latticeqcd_torch.updates import hmc as thmc

    cap = {}
    run_md, sample = integrators.run_md, TSFA.sample_pseudofermion

    def recorded_md(u0, h0, *a, **k):
        un, hn = run_md(u0, h0, *a, **k)
        cap.update(u0=u0, h0=h0, un=un, hn=hn)
        return un, hn

    def recorded_sample(self, uu, *a, **k):
        s_old, phi = sample(self, uu, *a, **k)
        cap.update(s_old=float(s_old), phi=phi)
        return s_old, phi

    with mock.patch.object(thmc.integrators, "run_md", recorded_md), \
            mock.patch.object(TSFA, "sample_pseudofermion", recorded_sample):
        _, dh = _anchor_trajectory(u_np, jax.random.PRNGKey(seed), device=device, jax_too=False)
    c128 = lambda x: x.to(torch.complex128)  # noqa: E731
    act = tga.wilson_gauge_action(3, 5.6)
    exact = TSFA(ts.StaggeredDirac(0.025, ANCHOR_LAT), nf=4, eps_cg=1e-24, max_cg=20000)

    def gauge_and_momenta(h, uu):
        return float(tsun.kinetic_energy(c128(h))) + float(tga.action_value(act, c128(uu)))

    sf_new = float(exact.action(c128(cap["un"]), c128(cap["phi"])))
    sf_old = float(exact.action(c128(cap["u0"]), c128(cap["phi"])))
    dh_exact = (gauge_and_momenta(cap["hn"], cap["un"]) + sf_new
                - gauge_and_momenta(cap["h0"], cap["u0"]) - cap["s_old"])
    return dh, dh_exact, sf_old - cap["s_old"]


@pytest.mark.slow
def test_anchor_complex64_dh_is_its_trajectorys_energy_change(monkeypatch):
    """ROADMAP C5, what the complex64 dH holds: the port's complex64 dH of an
    anchor trajectory equals the energy change of that same trajectory (with
    S_f(U_old) = |xi|^2, as HMC takes it) recomputed in complex128, within
    0.05. Also prints S_f(U_old, phi) - |xi|^2 and the JAX package's complex64
    dH for the same draws with its energies summed in float32 (as it runs) and
    with the momentum and gauge energies summed in float64."""
    from latticeqcd_tpu.ops import gauge_action as jga_mod
    from latticeqcd_tpu.ops import sun as jsun

    u = _anchor_start(np.complex64)
    port = []
    for seed in ANCHOR_KEYS:
        dh, dh_exact, heatbath_part = _anchor_energy_change(u, seed)
        print(f"anchor complex64 key {seed}: port dH {dh!r}, energy change of its trajectory "
              f"{dh_exact!r}, S_f(U_old, phi) - |xi|^2 {heatbath_part!r}")
        port.append((dh, dh_exact))
    fa_j = JSFA(js.StaggeredDirac(0.025, ANCHOR_LAT), nf=4, eps_cg=1e-10, max_cg=4000)

    def jax_dh(seed):
        hmc = JHMC(action=jga.wilson_gauge_action(3, 5.6), fermi_action=fa_j, staged=False,
                   dtau=1.0 / 35, md_steps=35)
        return float(hmc.step(jnp.asarray(u), jax.random.PRNGKey(seed))[2]["dH"])

    f32 = [jax_dh(seed) for seed in ANCHOR_KEYS]
    # the momentum and gauge energies (about 2e5 each) summed in float64; neither
    # function is on the MD's force path, so the trajectory stays the same
    ke, av = jsun.kinetic_energy, jga_mod.action_value
    monkeypatch.setattr(jsun, "kinetic_energy", lambda h: ke(h.astype(jnp.complex128)))
    monkeypatch.setattr(jga_mod, "action_value", lambda a, uu: av(a, uu.astype(jnp.complex128)))
    jax.clear_caches()  # retrace with the float64 sums
    f64 = [jax_dh(seed) for seed in ANCHOR_KEYS]
    jax.clear_caches()
    for seed, a, b in zip(ANCHOR_KEYS, f32, f64):
        print(f"anchor complex64 key {seed}: JAX dH {a!r} (float32 sums), {b!r} (momentum "
              f"and gauge energies summed in float64)")
    for dh, dh_exact in port:
        assert abs(dh - dh_exact) < 0.05, (dh, dh_exact)


@pytest.mark.gpu
@pytest.mark.slow
def test_anchor_trajectory_dh_card_against_cpu():
    """ROADMAP C5 on the card: the same complex64 anchor trajectories as
    test_anchor_trajectory_dh_matches_jax through the port on the card and on
    the CPU; prints both dH per set of draws and the energy change of the
    card's trajectory recomputed in complex128 on the card (run with -s), which
    the card's dH must equal within 0.05."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu -s "
                    "tests/test_torch_rhmc.py::test_anchor_trajectory_dh_card_against_cpu)")
    u = _anchor_start(np.complex64)
    for seed in ANCHOR_KEYS:
        _, dh_cpu = _anchor_trajectory(u, jax.random.PRNGKey(seed), jax_too=False)
        dh_gpu, dh_exact, heatbath_part = _anchor_energy_change(u, seed, device="cuda")
        print(f"anchor dH complex64 key {seed}: card {dh_gpu!r} CPU {dh_cpu!r} "
              f"difference {dh_gpu - dh_cpu!r}; energy change of the card's trajectory "
              f"{dh_exact!r}, S_f(U_old, phi) - |xi|^2 {heatbath_part!r}")
        assert np.isfinite(dh_gpu) and abs(dh_gpu - dh_cpu) < 1.0
        assert abs(dh_gpu - dh_exact) < 0.05, (dh_gpu, dh_exact)
