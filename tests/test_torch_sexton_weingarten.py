"""Port parity: the Sexton-Weingarten integrators (md/integrators.py) and
HMC.step with an improved action, stout-smeared fermions and a
multi-timescale integrator, replayed from the JAX package's own draws."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.md import integrators as jint  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops import sun as jsun  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_tpu.system import params as jparams  # noqa: E402
from latticeqcd_tpu.system import universe as juniv  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.md import integrators as tint  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction as TSFA  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402
from latticeqcd_torch.system import params as tparams  # noqa: E402
from latticeqcd_torch.system import universe as tuniv  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC, Draws  # noqa: E402
from test_torch_hmc import _compare, jax_draws  # noqa: E402
from test_torch_rhmc import jax_draws as rhmc_jax_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
# the chip's full-width action at 4^4: Iwasaki at beta_I = 2.6, Wilson kappa 0.12
IWASAKI = dict(beta=3.648 * 2.6, couplinglist=["rectangular"], couplingcoeff=[-0.331 * 2.6])


def _iwasaki():
    return (juniv.build_gauge_action(jparams.Params(L=LAT, **IWASAKI)),
            tuniv.build_gauge_action(tparams.Params(L=LAT, **IWASAKI)))


# ------------------------------------------------------------------ integrators


def _forces():
    """(JAX, port) pairs of deterministic force callables: the plaquette
    force as the gauge force, the Iwasaki force as the 'fermion' force,
    and a chair action's force as the fine-scale extra force."""
    ja, ta = jga.wilson_gauge_action(3, 5.7), tga.wilson_gauge_action(3, 5.7)
    ji, ti = _iwasaki()
    jc, tc = (m.general_gauge_action(3, [-0.2], [m.make_loops_fromname("chair", 4)])
              for m in (jga, tga))
    return ((lambda u: jga.force(ja, u), lambda u: tga.force(ta, u)),
            (lambda u: jga.force(ji, u), lambda u: tga.force(ti, u)),
            (lambda u: jga.force(jc, u), lambda u: tga.force(tc, u)))


@pytest.mark.parametrize("fine", [False, True], ids=["", "force_fine"])
@pytest.mark.parametrize("nsw", [2, 4])
@pytest.mark.parametrize("scheme", ["QPQ", "Omelyan"])
def test_sw_integrators_match_jax(scheme, nsw, fine):
    (gj, gt), (fj, ft), (xj, xt) = _forces()
    u = jfields.hot_start(LAT, 3, seed=90)
    h = jsun.random_hermitian_momentum(jax.random.PRNGKey(91), u.shape[:-2], 3)
    kw_j = dict(force_fermion=fj, scheme=scheme, sexton_weingarten=True, nsw=nsw,
                force_fine=xj if fine else None)
    kw_t = dict(force_fermion=ft, scheme=scheme, sexton_weingarten=True, nsw=nsw,
                force_fine=xt if fine else None)
    u_j, h_j = jint.run_md(u, h, gj, 0.05, 3, **kw_j)
    u_t, h_t = tint.run_md(to_torch(np.asarray(u)), to_torch(np.asarray(h)), gt, 0.05, 3, **kw_t)
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-12
    assert np.abs(np.asarray(h_j) - to_numpy(h_t)).max() < 1e-12
    # the fine scale moved the links: not the plain integrator
    u_p, _ = tint.run_md(to_torch(np.asarray(u)), to_torch(np.asarray(h)), gt, 0.05, 3,
                         force_fermion=ft, scheme=scheme)
    assert float((u_p - u_t).abs().max()) > 1e-8


@pytest.mark.parametrize("case", ["quench", "pqp", "odd_nsw"])
def test_run_md_errors_match_jax(case):
    (gj, gt), (fj, ft), _ = _forces()
    u = jfields.cold_start((2, 2, 2, 2), 3)
    h = jnp.zeros_like(u)
    kw = {"quench": dict(scheme="QPQ", force_fermion=None),
          "pqp": dict(scheme="PQP", force_fermion="f"),
          "odd_nsw": dict(scheme="Omelyan", force_fermion="f", nsw=3)}[case]

    def call(run_md, g, f, uu, hh):
        args = dict(kw, force_fermion=None if kw["force_fermion"] is None else f)
        with pytest.raises(ValueError) as err:
            run_md(uu, hh, g, 0.1, 2, sexton_weingarten=True, **args)
        return str(err.value)

    msg_j = call(jint.run_md, gj, fj, u, h)
    msg_t = call(tint.run_md, gt, ft, to_torch(np.asarray(u)), to_torch(np.asarray(h)))
    assert msg_t == msg_j
    if case == "quench":  # the HMC refuses it before any step, with the same words
        with pytest.raises(ValueError, match=msg_j):
            THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2,
                 sexton_weingarten=True).step(to_torch(np.asarray(u)), torch.Generator())


# ------------------------------------------------------------------------ HMC


def _step_both(u, key, hmc_j, hmc_t, draws):
    u_j, _, st_j = hmc_j.step(u, key)
    u_t, st_t = hmc_t.step(to_torch(np.asarray(u)), draws=draws)
    _compare(st_j, u_j, st_t, u_t)
    assert abs(float(st_j["sf_old"]) - st_t["sf_old"]) < 1e-9 * max(1.0, abs(float(st_j["sf_old"])))
    assert all(c["rsq"] <= c["target"] for c in st_t["cg"])
    return st_t


def _wilson_draws(key, u):
    return jax_draws(key, u, pf_shape=TFA(TW(kappa=0.12)).noise_shape(to_torch(np.asarray(u))))


# The JAX package compiles a whole trajectory into one program (minutes at full
# depth on the CPU), so the fast lane cuts the depth; the full depth runs as slow.


@pytest.mark.parametrize("md_steps", [2, pytest.param(5, marks=pytest.mark.slow)])
def test_iwasaki_stout_omelyan_sw_trajectory_matches_jax(md_steps):
    """The chip's full-width action at 4^4: Iwasaki, Wilson kappa 0.12 on 2
    plaquette stout layers of rho 0.1, Omelyan with nsw 4, steps of 0.04."""
    act_j, act_t = _iwasaki()
    kw = dict(dtau=0.04, md_steps=md_steps, scheme="Omelyan", sexton_weingarten=True, nsw=4)
    hmc_j = JHMC(action=act_j, fermi_action=JFA(JW(kappa=0.12)), staged=False,
                 smearing=jstout_stack([0.1, 0.1]), **kw)
    hmc_t = THMC(action=act_t, fermi_action=TFA(TW(kappa=0.12)),
                 smearing=tstout_stack([0.1, 0.1]), **kw)
    key, u = jax.random.PRNGKey(92), jfields.hot_start(LAT, 3, seed=93)
    st = _step_both(u, key, hmc_j, hmc_t, _wilson_draws(key, u))
    # 1 + 2 per step fermion forces and the final action, each one solve
    assert len(st["cg"]) == 2 * md_steps + 1 + 1


@pytest.mark.parametrize("md_steps", [4, pytest.param(20, marks=pytest.mark.slow)])
def test_scenario7_trajectory_matches_jax(md_steps):
    """BASELINE.md scenario 7's action: Wilson beta 5.7, kappa 0.141139, QPQ
    with nsw 10, steps of 0.05, 20 of them at full depth (hot links stand in
    for its start file)."""
    kappa = 0.141139
    kw = dict(dtau=0.05, md_steps=md_steps, sexton_weingarten=True, nsw=10)
    hmc_j = JHMC(action=jga.wilson_gauge_action(3, 5.7),
                 fermi_action=JFA(JW(kappa=kappa), eps_cg=1e-19), staged=False, **kw)
    hmc_t = THMC(action=tga.wilson_gauge_action(3, 5.7),
                 fermi_action=TFA(TW(kappa=kappa), eps_cg=1e-19), **kw)
    key, u = jax.random.PRNGKey(94), jfields.hot_start(LAT, 3, seed=95)
    st = _step_both(u, key, hmc_j, hmc_t, _wilson_draws(key, u))
    assert len(st["cg"]) == md_steps + 1


def test_staggered_stout_qpq_sw_trajectory_matches_jax():
    """Staggered Nf = 2 RHMC at mass 0.5 on one stout layer, QPQ with nsw 2."""
    kw = dict(dtau=0.1, md_steps=2, sexton_weingarten=True, nsw=2)
    fa_j = JSFA(js.StaggeredDirac(0.5, LAT), nf=2)
    fa_t = TSFA(ts.StaggeredDirac(0.5, LAT), nf=2)
    hmc_j = JHMC(action=jga.wilson_gauge_action(3, 5.7), fermi_action=fa_j, staged=False,
                 smearing=jstout_stack([0.1]), **kw)
    hmc_t = THMC(action=tga.wilson_gauge_action(3, 5.7), fermi_action=fa_t,
                 smearing=tstout_stack([0.1]), **kw)
    key, u = jax.random.PRNGKey(96), jfields.hot_start(LAT, 3, seed=97)
    st = _step_both(u, key, hmc_j, hmc_t, rhmc_jax_draws(key, u, fa_t))
    assert len(st["cg"]) == 2 + 1


def test_reversibility_of_the_improved_action():
    """Integrate the 4^4 improved action forward, flip the momenta, integrate back."""
    _, act = _iwasaki()
    u = to_torch(np.asarray(jfields.hot_start(LAT, 3, seed=98)))
    fa = TFA(TW(kappa=0.12), eps_cg=1e-24)
    net = tstout_stack([0.1, 0.1])
    hmc = THMC(action=act, dtau=0.04, md_steps=5, fermi_action=fa, smearing=net,
               scheme="Omelyan", sexton_weingarten=True, nsw=4)
    draws = Draws.sample(hmc, u, torch.Generator().manual_seed(99))
    _, phi = fa.sample_pseudofermion(net.smear(u), normals=draws.xi)
    force_f = lambda uu: fa.force(uu, phi, smear_fn=net.smear)
    force_g = lambda uu: tga.force(act, uu)
    kw = dict(force_fermion=force_f, scheme="Omelyan", sexton_weingarten=True, nsw=4)
    u1, h1 = tint.run_md(u, draws.momentum(u), force_g, 0.04, 5, **kw)
    u2, _ = tint.run_md(u1, -h1, force_g, 0.04, 5, **kw)
    assert float((u2 - u).abs().max()) < 1e-8
