"""Port parity: the self-learning HMC and the dense fermion determinant
(updates/slhmc.py's EffectiveGaugeBasis, SLMCLearner, SLHMC,
dense_logdet_fermi_action, integrated_hmc; updates/factory.py's
_exact_logdet), held to the JAX package in complex128 with the JAX
package's own draws replayed (test_torch_hmc.jax_draws,
test_torch_rhmc.jax_pf_normals)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA  # noqa: E402
from latticeqcd_tpu.ops import wilsonline as jwl  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_tpu.system import lqcd as jlqcd  # noqa: E402
from latticeqcd_tpu.system.params import Params as JParams  # noqa: E402
from latticeqcd_tpu.updates import slhmc as jsl  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch import run as trun  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import wilsonline as twl  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction as TSFA  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402
from latticeqcd_torch.updates import slhmc as tsl  # noqa: E402
from latticeqcd_torch.updates.hmc import Draws  # noqa: E402

from test_torch_hmc import jax_draws  # noqa: E402
from test_torch_rhmc import jax_pf_normals  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
SMALL = (4, 4, 2, 2)
KAPPA = 0.141139
TOL = 1e-12


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------- the basis


BASES = {
    "plaquette": dict(couplinglist=("plaquette",)),
    "rectangular": dict(couplinglist=("rectangular",)),
    "chair": dict(couplinglist=("chair",)),
    "plaquette+rectangular": dict(couplinglist=("plaquette", "rectangular")),
    "coupling_loops": dict(coupling_loops=[[(0, 1), (1, 2), (0, -1), (1, -2)],
                                           [(2, 1), (3, 1), (2, -1), (3, -1)]]),
}


@pytest.mark.parametrize("name", list(BASES))
def test_basis_loop_values_action_and_force_match_jax(name):
    u = jfields.hot_start(SMALL, 3, seed=5)
    ut = to_torch(np.asarray(u))
    jb, tb = jsl.EffectiveGaugeBasis(3, **BASES[name]), tsl.EffectiveGaugeBasis(3, **BASES[name])
    assert jb.names == tb.names and jb.n == tb.n
    coeffs = np.linspace(5.5, -0.4, tb.n)
    lj, lt = np.asarray(jb.loop_values(u)), to_numpy(tb.loop_values(ut))
    assert np.abs(lj - lt).max() < TOL * max(1.0, np.abs(lj).max())
    sj = float(jb.action_value(u, jnp.asarray(coeffs)))
    st = float(tb.action_value(ut, torch.as_tensor(coeffs)))
    assert abs(sj - st) < TOL * max(1.0, abs(sj))
    fj = np.asarray(jax.jit(jb.force)(u, jnp.asarray(coeffs)))
    ft = to_numpy(tb.force(ut, torch.as_tensor(coeffs)))
    assert np.abs(fj - ft).max() < TOL
    assert np.abs(ft).max() > 0.1


# -------------------------------------------------------------- the learner


def _histories():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((9, 2))
    target = 3.0 + feats @ np.array([5.7, -0.3]) + 1e-3 * rng.standard_normal(9)
    return {
        "determined": (feats, target),
        "underdetermined": (feats[:2], target[:2]),
        "rank-deficient": (np.stack([feats[:, 0], 2.0 * feats[:, 0]], axis=1), target),
        "constant feature": (np.stack([feats[:, 0], np.full(9, 4.0)], axis=1), target),
        "not finite": (feats, np.where(np.arange(9) == 4, np.inf, target)),
    }


@pytest.mark.parametrize("case", list(_histories()))
def test_learner_fit_matches_jax(case):
    feats, target = _histories()[case]
    lj, lt = jsl.SLMCLearner(2), tsl.SLMCLearner(2)
    for f, y in zip(feats, target):
        lj.record(f, y)
        lt.record(f, y)
    bj, bt = lj.fit(), lt.fit()
    if case == "determined":
        assert np.abs(bj - bt).max() < TOL and np.abs(bt - [5.7, -0.3]).max() < 1e-2
    else:
        assert bj is None and bt is None


def test_learner_history_is_bounded(monkeypatch):
    monkeypatch.setattr(tsl.SLMCLearner, "MAX_HISTORY", 4)
    lt = tsl.SLMCLearner(1)
    for k in range(6):
        lt.record([float(k)], 2.0 * k)
    assert lt.targets == [4.0, 6.0, 8.0, 10.0] and len(lt.feats) == 4
    assert tsl.SLMCLearner.MAX_HISTORY == 4 and jsl.SLMCLearner.MAX_HISTORY == 8192


# ------------------------------------------------------------- trajectories


def _compare_steps(st_j, u_j, st_t, u_t):
    assert abs(float(st_j["dH"]) - st_t["dH"]) < 1e-9
    assert bool(st_j["accepted"]) == st_t["accepted"]
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-10
    bj, bt = np.asarray(st_j["beta_eff"]), np.asarray(st_t["beta_eff"])
    assert bj.shape == bt.shape and np.abs(bt - bj).max() < 1e-7 * np.abs(bj).max()
    for k in ("sg_old", "sg_new", "sp_new", "sf_old", "sf_new"):
        a = float(st_j[k])
        assert abs(a - st_t[k]) < 1e-9 * max(1.0, abs(a)), k


def _chain(up_j, up_t, u, key, ntraj, pf_shape=None, pf_normals=None):
    """ntraj trajectories of both updaters from the same draws; the
    port's stats of each."""
    ut = to_torch(np.asarray(u))
    out = []
    for _ in range(ntraj):
        draws = jax_draws(key, u, pf_shape)
        if pf_normals is not None:
            draws = Draws(draws.mom, pf_normals(key), draws.uniform)
        u, key, st_j = up_j.step(u, key)
        ut, st_t = up_t.step(ut, draws=draws)
        _compare_steps(st_j, u, st_t, ut)
        out.append(st_t)
    return out


@pytest.mark.parametrize("scheme,ntraj", [("QPQ", 5), ("Omelyan", 2)])
def test_quenched_slhmc_learns_beta_as_jax(scheme, ntraj):
    """beta = 5.7 learnt from beta_eff = 3.0: the first fit recovers it exactly
    (the true action lies in the span), and both packages agree step by step."""
    kw = dict(dtau=0.01, md_steps=10, beta_eff=3.0, firstlearn=1, scheme=scheme)
    up_j = jsl.SLHMC(jga.wilson_gauge_action(3, 5.7), **kw)
    up_t = tsl.SLHMC(tga.wilson_gauge_action(3, 5.7), **kw)
    stats = _chain(up_j, up_t, jfields.hot_start(LAT, 3, seed=1), jax.random.PRNGKey(7), ntraj)
    assert abs(stats[0]["beta_eff"][0] - 5.7) < 1e-6
    assert abs(stats[-1]["dH"]) < 0.1
    assert len(up_t.learner.targets) == ntraj + 1  # the start point and the proposals


def test_quenched_slhmc_two_coupling_basis_matches_jax():
    """A plaquette + rectangle basis from beta_eff [6, 0] over a plaquette +
    rectangle action (6.0, -0.5): the fit, determined from the third sample
    on, recovers both couplings."""
    kw = dict(dtau=0.02, md_steps=5, beta_eff=[6.0, 0.0], firstlearn=2,
              couplinglist=("plaquette", "rectangular"))
    acts = [ga.general_gauge_action(3, [6.0, -0.5], [make_loops_fromname("plaquette"),
                                                     make_loops_fromname("rectangular")])
            for ga, make_loops_fromname in ((jga, jwl.make_loops_fromname),
                                            (tga, twl.make_loops_fromname))]
    up_j, up_t = jsl.SLHMC(acts[0], **kw), tsl.SLHMC(acts[1], **kw)
    _chain(up_j, up_t, jfields.hot_start(SMALL, 3, seed=2), jax.random.PRNGKey(8), 2)
    assert np.abs(up_t.beta_eff - [6.0, -0.5]).max() < 1e-6


@pytest.mark.parametrize("smeared", [False, True], ids=["bare", "stout"])
def test_dynamical_wilson_slhmc_matches_jax(smeared):
    """Two-flavour Wilson at kappa 0.141139: the pseudofermion and the final
    action on the (smeared) endpoints, gluonic MD under beta_eff."""
    fa_j = JFA(jw.WilsonDirac(kappa=KAPPA), eps_cg=1e-22)
    fa_t = TFA(tw.WilsonDirac(kappa=KAPPA), eps_cg=1e-22)
    kw = dict(dtau=0.02, md_steps=5, beta_eff=5.5, firstlearn=2)
    up_j = jsl.SLHMC(jga.wilson_gauge_action(3, 5.7), fermi_action=fa_j,
                     smearing=jstout_stack([0.1]) if smeared else None, **kw)
    up_t = tsl.SLHMC(tga.wilson_gauge_action(3, 5.7), fermi_action=fa_t,
                     smearing=tstout_stack([0.1]) if smeared else None, **kw)
    u = jfields.hot_start(SMALL, 3, seed=3)
    stats = _chain(up_j, up_t, u, jax.random.PRNGKey(9), 1 if smeared else 2,
                   pf_shape=fa_t.noise_shape(to_torch(np.asarray(u))))
    # one solve per trajectory: the final action (the MD is gluonic)
    assert all(len(st["cg"]) == 1 and st["cg"][0]["rsq"] <= st["cg"][0]["target"]
               for st in stats)
    if not smeared:
        assert stats[-1]["beta_eff"][0] != 5.5  # learnt after the second trajectory


def test_dynamical_staggered_slhmc_matches_jax():
    """Staggered Nf = 4 at m = 1.0 on cold links, as the JAX package's own test."""
    fa_j = JSFA(js.StaggeredDirac(mass=1.0, lattice=SMALL), nf=4, eps_cg=1e-22, max_cg=500)
    fa_t = TSFA(ts.StaggeredDirac(mass=1.0, lattice=SMALL), nf=4, eps_cg=1e-22, max_cg=500)
    kw = dict(dtau=0.02, md_steps=5, beta_eff=5.7, firstlearn=2)
    up_j = jsl.SLHMC(jga.wilson_gauge_action(3, 5.7), fermi_action=fa_j, **kw)
    up_t = tsl.SLHMC(tga.wilson_gauge_action(3, 5.7), fermi_action=fa_t, **kw)
    pf = lambda key: jax_pf_normals(jax.random.split(key, 4)[2], fa_t, lat=SMALL)  # noqa: E731
    stats = _chain(up_j, up_t, jfields.cold_start(SMALL, 3), jax.random.PRNGKey(11), 2,
                   pf_normals=pf)
    assert any(st["accepted"] for st in stats)
    assert len(up_t.learner.targets) == 3


# --------------------------------------------------------- the dense log det


def _logdets(kind, lat, nc=3, mass=0.7, u=None, bc=(1, 1, 1, -1)):
    """(JAX S_f, port S_f) of the dense -w log det(D^dag D) on the same links."""
    u = jfields.hot_start(lat, nc, seed=21) if u is None else u
    up_j = jw.apply_boundary_phases(u, bc)
    up_t = tw.apply_boundary_phases(to_torch(np.asarray(u)), bc)
    if kind == "Wilson":
        shape, weight = lat + (4, nc), 1.0
        dj, dt = jw.WilsonDirac(kappa=KAPPA, bc=bc), tw.WilsonDirac(kappa=KAPPA, bc=bc)
    else:
        shape, weight = lat + (nc,), 0.5
        dj, dt = js.StaggeredDirac(mass=mass, lattice=lat, bc=bc), \
            ts.StaggeredDirac(mass=mass, lattice=lat, bc=bc)
    return (float(jsl.dense_logdet_fermi_action(dj, shape, weight)(up_j)),
            float(tsl.dense_logdet_fermi_action(dt, shape, weight)(up_t)))


@pytest.mark.parametrize("kind,lat", [("Wilson", SMALL), ("Staggered", LAT),
                                      ("Staggered", (2, 2, 2, 2)), ("Staggered", (3, 4, 2, 2))],
                         ids=["wilson-4x4x2x2", "staggered-4^4", "staggered-2^4",
                              "staggered-odd"])
def test_dense_logdet_matches_jax(kind, lat):
    sj, st = _logdets(kind, lat)
    assert _rel(st, sj) < TOL
    assert abs(sj) > 1.0


def test_dense_logdet_casts_complex64_links_up():
    """complex64 links give the complex128 determinant of the same (rounded) links."""
    u = np.asarray(jfields.hot_start(SMALL, 3, seed=22)).astype(np.complex64)
    d = tw.WilsonDirac(kappa=KAPPA)
    sf = tsl.dense_logdet_fermi_action(d, SMALL + (4, 3), 1.0)
    s64, s128 = sf(to_torch(u)), sf(to_torch(u.astype(np.complex128)))
    assert s64.dtype == torch.float64 and float(s64) == float(s128)


@pytest.mark.parametrize("lat", [(2, 2, 2, 2), (4, 4, 2, 2)])
def test_dense_logdet_free_staggered(lat):
    """At U = 1 det(D^dag D) = prod_p (m^2 + sum_mu sin^2 p_mu)^NC with
    antiperiodic momenta in t."""
    mass = 0.5
    d = ts.StaggeredDirac(mass=mass, lattice=lat)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.cold_start(lat, 3))))
    got = float(tsl.dense_logdet_fermi_action(d, lat + (3,), weight=0.5)(u))
    total = 0.0
    for n in np.ndindex(*lat):
        p = [2 * np.pi * (n[mu] + (0.5 if mu == 3 else 0.0)) / lat[mu] for mu in range(4)]
        total += 3 * np.log(mass ** 2 + sum(np.sin(q) ** 2 for q in p))
    assert _rel(got, -0.5 * total) < TOL


def test_integrated_hmc_matches_jax_and_adds_the_exact_fermion_action():
    """IntegratedHMC: dH equals the quenched dH plus S_f(new) - S_f(old) (the
    fermion force never enters the MD), and both equal the JAX package's."""
    lat = (2, 2, 2, 2)
    act_j, act_t = jga.wilson_gauge_action(3, 5.7), tga.wilson_gauge_action(3, 5.7)
    dj, dt = js.StaggeredDirac(mass=0.7, lattice=lat), ts.StaggeredDirac(mass=0.7, lattice=lat)
    sfj = jsl.dense_logdet_fermi_action(dj, lat + (3,), weight=0.5)
    sft = tsl.dense_logdet_fermi_action(dt, lat + (3,), weight=0.5)
    u = jfields.hot_start(lat, 3, seed=13)
    key = jax.random.PRNGKey(29)
    draws = jax_draws(key, u)
    kw = dict(dtau=0.05, md_steps=4)
    up_f = tsl.integrated_hmc(act_t, fermi_logdet=lambda uu: sft(tw.apply_boundary_phases(uu)),
                              **kw)
    assert Draws.sample(up_f, to_torch(np.asarray(u)), torch.Generator()).xi is None
    _, st_q = tsl.integrated_hmc(act_t, **kw).step(to_torch(np.asarray(u)), draws=draws)
    u_t, st_f = up_f.step(to_torch(np.asarray(u)), draws=draws)
    assert abs(st_f["dH"] - (st_q["dH"] + st_f["sf_new"] - st_f["sf_old"])) < 1e-9
    u_j, _, st_j = jsl.integrated_hmc(
        act_j, fermi_logdet=lambda uu: sfj(jw.apply_boundary_phases(uu)), **kw).step(u, key)
    _compare_steps(st_j, u_j, st_f, u_t)


# ------------------------------------------ run_lqcd_params, TOML and the limits


def _run_params(**kw):
    base = dict(L=LAT, NC=3, beta=5.7, initial="hot", update_method="SLHMC", quench=True,
                Nsteps=3, randomseed=4, verboselevel=2, MDsteps=5, dtau=0.02, beta_eff=4.0,
                firstlearn=1, measurement_methods=[])
    base.update(kw)
    return base


@pytest.mark.parametrize("method,kw", [
    ("SLHMC", {}),
    ("SLHMC", dict(quench=False, Dirac_operator="Wilson", hop=KAPPA, L=SMALL, Nsteps=2)),
    ("IntegratedHMC", dict(quench=False, Dirac_operator="Staggered", mass=1.0, Nf=4,
                           initial="cold", Nsteps=2)),
], ids=["SLHMC-quenched", "SLHMC-Wilson", "IntegratedHMC-staggered"])
def test_run_lqcd_params_runs_the_self_learning_hmc(method, kw, capsys):
    history = []
    plaq = run_lqcd_params(TParams(**_run_params(update_method=method, **kw)), device="cpu",
                           history=history)
    out = capsys.readouterr().out
    assert 0.0 < plaq <= 1.0 and len(history) == _run_params(**kw)["Nsteps"]
    assert all(math.isfinite(h["dH"]) for h in history)
    assert out.count("beta_eff = (") == len(history)
    assert history[-1]["beta_eff"] is not None
    if method == "SLHMC" and not kw:  # quenched: the first fit recovers beta exactly
        assert abs(history[-1]["beta_eff"][0] - 5.7) < 1e-6


TOML = """
["Physical setting"]
L = [4, 4, 4, 4]
"β" = 5.7
NC = 3
Nsteps = 2
update_method = "{method}"
"βeff" = 4.0
firstlearn = 1
initial = "{initial}"
verboselevel = 2
randomseed = 6

["Physical setting(fermions)"]
{fermions}

["HMC related"]
MDsteps = 5
"Δτ" = 0.02
"""


@pytest.mark.parametrize("method,initial,fermions", [
    ("SLHMC", "hot", "quench = true"),
    ("IntegratedHMC", "cold",
     'quench = false\nDirac_operator = "Staggered"\nmass = 1.0\nNf = 4'),
], ids=["SLHMC", "IntegratedHMC"])
def test_toml_runs_the_self_learning_hmc(tmp_path, monkeypatch, capsys, method, initial,
                                         fermions):
    monkeypatch.chdir(tmp_path)
    toml = tmp_path / "run.toml"
    toml.write_text(TOML.format(method=method, initial=initial, fermions=fermions))
    assert trun.main([str(toml), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("beta_eff = (") == 2
    plaq = float(out.split("final plaquette = ")[1].split()[0])
    assert 0.0 < plaq <= 1.0


@pytest.mark.parametrize("method", ["IntegratedHMC", "IntegratedHB", "SLMC"])
@pytest.mark.parametrize("case", ["cap", "domainwall"])
def test_dense_updaters_refuse_as_jax(method, case):
    """The dense Dirac matrix is capped at dim 4608 (4^3x8 Wilson is 6144),
    and only Wilson and staggered fermions have one: the same ValueError."""
    kw = dict(L=(4, 4, 4, 8), Dirac_operator="Wilson", hop=KAPPA) if case == "cap" else \
        dict(Dirac_operator="Domainwall", Domainwall_L5=4)
    kw = _run_params(update_method=method, quench=False, Nsteps=1, **kw)
    with pytest.raises(ValueError) as jerr:
        jlqcd.run_lqcd_params(JParams(**kw), make_dirs=False)
    with pytest.raises(ValueError) as terr:
        run_lqcd_params(TParams(**kw), make_dirs=False, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert ("dim=6144 > 4608" if case == "cap" else "Wilson/Staggered") in str(terr.value)


@pytest.mark.gpu
def test_odd_extent_staggered_logdet_is_refused_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_slhmc.py)")
    lat = (3, 4, 2, 2)
    d = ts.StaggeredDirac(mass=0.7, lattice=lat)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=23))))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tsl.dense_logdet_fermi_action(d, lat + (3,), 0.5)(u.to("cuda"))
