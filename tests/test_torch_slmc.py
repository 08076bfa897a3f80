"""Port parity: the self-learning Monte Carlo and its coupling-basis heatbath
(updates/heatbath.py's sweep_with_coeffs and overrelax_with_coeffs;
updates/slhmc.py's SLMC and integrated_hb), held to the JAX package in
complex128 with the JAX package's own key schedule replayed
(test_torch_heatbath.JaxUniforms), and the SLMC and IntegratedHB
update methods through run_lqcd_params and a TOML file."""

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
from latticeqcd_tpu.ops import wilsonline as jwl  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.updates import heatbath as jhb  # noqa: E402
from latticeqcd_tpu.updates import slhmc as jsl  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch import run as trun  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import wilsonline as twl  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402
from latticeqcd_torch.updates import heatbath as thb  # noqa: E402
from latticeqcd_torch.updates import slhmc as tsl  # noqa: E402

from test_torch_heatbath import JaxUniforms, warm_links  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
# a 2x1 rectangle closes on itself along an extent of 2 (the staple of a
# link would hold the link), so the rectangle basis runs at extent 3
RECT_LAT = (3, 3, 3, 3)
KAPPA = 0.141139
TOL = 1e-12
# basis name -> (couplinglist, lattice, coefficients): a plaquette basis
# keeps the even-odd checkerboard, a rectangle basis takes the per-axis
# colouring (81 colours on 3^4)
BASES = {
    "plaquette": (("plaquette",), LAT, [5.7]),
    "plaquette+rectangular": (("plaquette", "rectangular"), RECT_LAT, [6.0, -0.5]),
}
NC = {"plaquette": 3, "plaquette+rectangular": 2}


def _bases(names, nc):
    return jsl.EffectiveGaugeBasis(nc, names), tsl.EffectiveGaugeBasis(nc, names)


def _heatbaths(names, nc):
    jb, tb = _bases(names, nc)
    return (jhb.Heatbath(action=jb.unit_actions[0], basis=jb.unit_actions),
            thb.Heatbath(action=tb.unit_actions[0], basis=tb.unit_actions))


@pytest.mark.parametrize("name", list(BASES))
@pytest.mark.parametrize("lat", [LAT, RECT_LAT, (3, 5, 2, 6)], ids=["4^4", "3^4", "odd"])
def test_colour_masks_match_jax(name, lat):
    jb, tb = _bases(BASES[name][0], 3)
    ext = max(a.max_extent() for a in tb.unit_actions)
    assert ext == max(a.max_extent() for a in jb.unit_actions) == (1 if name == "plaquette" else 2)
    plaq_eo = ext == 1 and all(n % 2 == 0 for n in lat)
    ref = np.stack([np.asarray(m) for m in jhb._parity_masks(
        lat, jhb._color_moduli_ext(ext, lat), plaq_eo)])
    got = thb.color_masks_ext(ext, lat)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    assert np.array_equal(np.sum(got, axis=0), np.ones(lat, dtype=np.int64))
    if name == "plaquette" and lat == LAT:
        assert len(got) == 2


@pytest.mark.parametrize("name", list(BASES))
def test_sweep_with_coeffs_matches_jax(name):
    names, lat, coeffs = BASES[name]
    hb_j, hb_t = _heatbaths(names, NC[name])
    u = jfields.hot_start(lat, NC[name], seed=31)
    key = jax.random.PRNGKey(32)
    u_j, key_j = hb_j.sweep_with_coeffs(u, key, jnp.asarray(coeffs))
    src = JaxUniforms(key)
    u_t = hb_t.sweep_with_coeffs(to_torch(np.asarray(u)), torch.as_tensor(coeffs, dtype=torch.float64), uniforms=src)
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    assert np.array_equal(np.asarray(src.key), np.asarray(key_j))  # the same key schedule
    assert np.abs(np.asarray(u) - to_numpy(u_t)).max() > 0.1


@pytest.mark.parametrize("name", list(BASES))
def test_overrelax_with_coeffs_matches_jax_and_keeps_the_action(name):
    names, lat, coeffs = BASES[name]
    hb_j, hb_t = _heatbaths(names, 3)
    u = warm_links(lat, 3, seed=33)
    u_j, _ = hb_j.overrelax_with_coeffs(jnp.asarray(u), jax.random.PRNGKey(0), jnp.asarray(coeffs))
    u_t = hb_t.overrelax_with_coeffs(to_torch(u), torch.as_tensor(coeffs, dtype=torch.float64))
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    tb = tsl.EffectiveGaugeBasis(3, names)
    c = torch.as_tensor(coeffs, dtype=torch.float64)
    s0, s1 = float(tb.action_value(to_torch(u), c)), float(tb.action_value(u_t, c))
    assert abs(s1 - s0) < 1e-10 * abs(s0)
    assert np.abs(u - to_numpy(u_t)).max() > 1e-3


def test_sweep_with_coeffs_needs_a_basis():
    hb = thb.Heatbath(action=tga.wilson_gauge_action(3, 5.7))
    with pytest.raises(ValueError, match="basis"):
        hb.overrelax_with_coeffs(to_torch(np.asarray(jfields.cold_start(LAT, 3))),
                                 torch.tensor([5.7]))


# ---------------------------------------------------------------- SLMC steps


def _compare_steps(st_j, u_j, st_t, u_t):
    assert abs(float(st_j["dH"]) - st_t["dH"]) < 1e-9
    assert bool(st_j["accepted"]) == st_t["accepted"]
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-10
    bj, bt = np.asarray(st_j["beta_eff"]), np.asarray(st_t["beta_eff"])
    assert bj.shape == bt.shape and np.abs(bt - bj).max() < 1e-7 * np.abs(bj).max()


def _slmc_chain(up_j, up_t, u, key, nsteps):
    """nsteps SLMC steps of both packages from the JAX key schedule: k_acc
    split off first, then the sweeps' uniforms from the rest."""
    ut = to_torch(np.asarray(u))
    rdt = jnp.float64
    out = []
    for _ in range(nsteps):
        k_sweep, k_acc = jax.random.split(key)
        src = JaxUniforms(k_sweep)
        u, key, st_j = up_j.step(u, key)
        ut, st_t = up_t.step(ut, uniforms=src,
                             uniform=float(jax.random.uniform(k_acc, dtype=rdt)))
        assert np.array_equal(np.asarray(src.key), np.asarray(key))
        _compare_steps(st_j, u, st_t, ut)
        out.append(st_t)
    return out


def test_slmc_learns_beta_as_jax():
    """SU(2) at beta = 1.9 from beta_eff = 1.2: the first fit recovers beta
    exactly, after which every proposal is accepted with |dH| < 1e-8."""
    act_j, act_t = jga.wilson_gauge_action(2, 1.9), tga.wilson_gauge_action(2, 1.9)
    up_j = jsl.SLMC(act_j, beta_eff=1.2, firstlearn=1)
    up_t = tsl.SLMC(act_t, beta_eff=1.2, firstlearn=1)
    stats = _slmc_chain(up_j, up_t, jfields.hot_start(LAT, 2, seed=6), jax.random.PRNGKey(17), 4)
    assert abs(up_t.beta_eff[0] - 1.9) < 1e-6
    assert all(st["accepted"] and abs(st["dH"]) < 1e-8 for st in stats[1:])
    assert len(up_t.learner.targets) == 5


def test_slmc_two_coupling_basis_matches_jax():
    """SU(2), a plaquette + rectangle basis from beta_eff [2, 0] over a
    plaquette + rectangle action (2.0, -0.2): the fit of the second step,
    from three samples, recovers both couplings."""
    acts = [ga.general_gauge_action(2, [2.0, -0.2], [wl.make_loops_fromname("plaquette"),
                                                     wl.make_loops_fromname("rectangular")])
            for ga, wl in ((jga, jwl), (tga, twl))]
    kw = dict(beta_eff=[2.0, 0.0], firstlearn=2, couplinglist=("plaquette", "rectangular"))
    up_j, up_t = jsl.SLMC(acts[0], **kw), tsl.SLMC(acts[1], **kw)
    _slmc_chain(up_j, up_t, jfields.hot_start(RECT_LAT, 2, seed=7), jax.random.PRNGKey(18), 2)
    assert np.abs(up_t.beta_eff - [2.0, -0.2]).max() < 1e-6


@pytest.mark.parametrize("nc,beta", [(2, 1.9), (3, 5.7)])
def test_slmc_with_the_true_coupling_accepts_every_step(nc, beta):
    """beta_eff = beta: S_true - S_eff is constant, so every heatbath
    proposal is accepted with |dH| < 1e-8 (from a torch.Generator)."""
    up = tsl.SLMC(tga.wilson_gauge_action(nc, beta), beta_eff=beta, learn=False)
    u = to_torch(np.asarray(jfields.hot_start(LAT, nc, seed=8)))
    gen = torch.Generator().manual_seed(9)
    for _ in range(3):
        u, st = up.step(u, gen)
        assert st["accepted"] and abs(st["dH"]) < 1e-8


def test_integrated_hb_with_wilson_fermions_matches_jax():
    """IntegratedHB: a plaquette heatbath proposal at beta_eff = beta,
    reweighted by the exact two-flavour Wilson determinant."""
    lat = (4, 2, 2, 2)
    bc = (1, 1, 1, -1)
    sfj = jsl.dense_logdet_fermi_action(jw.WilsonDirac(kappa=KAPPA), lat + (4, 3), 1.0)
    sft = tsl.dense_logdet_fermi_action(tw.WilsonDirac(kappa=KAPPA), lat + (4, 3), 1.0)
    up_j = jsl.integrated_hb(jga.wilson_gauge_action(3, 5.7),
                             fermi_logdet=lambda u: sfj(jw.apply_boundary_phases(u, bc)))
    up_t = tsl.integrated_hb(tga.wilson_gauge_action(3, 5.7),
                             fermi_logdet=lambda u: sft(tw.apply_boundary_phases(u, bc)))
    stats = _slmc_chain(up_j, up_t, jfields.hot_start(lat, 3, seed=10), jax.random.PRNGKey(19), 2)
    # the reweighting is the fermion action's change alone
    assert all(st["dH"] != 0.0 for st in stats)
    assert up_t.learner.targets == []


# ------------------------------------------------- run_lqcd_params and TOML


def _run_params(**kw):
    base = dict(L=LAT, NC=3, beta=5.7, initial="hot", update_method="SLMC", quench=True,
                Nsteps=3, randomseed=4, verboselevel=2, beta_eff=5.0, firstlearn=1,
                measurement_methods=[])
    base.update(kw)
    return base


@pytest.mark.parametrize("method,kw", [
    ("SLMC", {}),
    ("SLMC", dict(quench=False, Dirac_operator="Staggered", mass=1.0, Nf=4, Nsteps=2,
                  initial="cold")),
    ("IntegratedHB", dict(quench=False, Dirac_operator="Wilson", hop=KAPPA, L=(4, 2, 2, 2),
                          Nsteps=2)),
], ids=["SLMC-quenched", "SLMC-staggered", "IntegratedHB-Wilson"])
def test_run_lqcd_params_runs_the_self_learning_mc(method, kw, capsys):
    history = []
    plaq = run_lqcd_params(TParams(**_run_params(update_method=method, **kw)), device="cpu",
                           history=history)
    out = capsys.readouterr().out
    assert 0.0 < plaq <= 1.0 and len(history) == _run_params(**kw)["Nsteps"]
    assert all(math.isfinite(h["dH"]) for h in history)
    assert out.count("beta_eff = (") == len(history)
    if method == "SLMC" and not kw:  # quenched: the first fit recovers beta exactly
        assert abs(history[-1]["beta_eff"][0] - 5.7) < 1e-6
        assert all(h["accepted"] for h in history[1:])


TOML = """
["Physical setting"]
L = {L}
"β" = 5.7
NC = 3
Nsteps = 2
update_method = "{method}"
"βeff" = 5.0
firstlearn = 1
initial = "hot"
verboselevel = 2
randomseed = 6

["Physical setting(fermions)"]
{fermions}
"""


@pytest.mark.parametrize("method,lat,fermions", [
    ("SLMC", [4, 4, 4, 4], "quench = true"),
    ("IntegratedHB", [4, 2, 2, 2], f'quench = false\nDirac_operator = "Wilson"\nhop = {KAPPA}'),
], ids=["SLMC", "IntegratedHB"])
def test_toml_runs_the_self_learning_mc(tmp_path, monkeypatch, capsys, method, lat, fermions):
    monkeypatch.chdir(tmp_path)
    toml = tmp_path / "run.toml"
    toml.write_text(TOML.format(method=method, L=lat, fermions=fermions))
    assert trun.main([str(toml), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("beta_eff = (") == 2
    plaq = float(out.split("final plaquette = ")[1].split()[0])
    assert 0.0 < plaq <= 1.0
