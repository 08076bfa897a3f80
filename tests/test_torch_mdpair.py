"""Port parity for mixed-precision MD (HMC md_precision = "mixed", ops/mdpair.py).

The port's MD state is a complex128 tensor where the JAX package holds
float64 (re, im) pairs. Held here against the JAX package on the same
inputs, made with numpy from a seed, at 4^4: the exponential, the link
update and the kinetic energy (1e-12); mixed trajectories from the JAX
package's own draws, quenched and two-flavour Wilson, in complex128 (dH
1e-9, links 1e-12) and complex64 (dH 5e-4, the complex64 force-noise bar
of test_mdpair.py's dynamical case, the quenched links 1e-6 and the
float64 kinetic part of dH 1e-5); on the port alone, the property the
fix exists for: mixed complex64 MD lands at least 5x closer to the
complex128 trajectory than plain complex64 MD does; and the MDprecision
key through the TOML, run_lqcd_params and the command line.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops import mdpair as jmdpair  # noqa: E402
from latticeqcd_tpu.ops import sun as jsun  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.md import integrators  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import mdpair, sun  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import construct_params_from_toml  # noqa: E402
from latticeqcd_torch.system.universe import build_universe  # noqa: E402
from latticeqcd_torch.updates.factory import updatemethod  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC  # noqa: E402
from test_torch_hmc import _params, jax_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA = 0.141139
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hermitian(nc, seed):
    """A traceless hermitian momentum field from numpy normals, on both sides."""
    rng = np.random.default_rng(seed)
    shape = (4,) + LAT + (nc, nc)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    return sun.random_hermitian_momentum(shape[:-2], nc, device="cpu",
                                         normals=(torch.from_numpy(re), torch.from_numpy(im)))


@pytest.mark.parametrize("nc", [2, 3])
def test_exponential_update_and_kinetic_energy_match_the_pair(nc):
    """The port's MD operations on the lifted complex128 state against the JAX pair's,
    at 1e-12: sun.expi_hermitian (Cayley-Hamilton at NC = 3, the SU(2) closed form at
    NC = 2) against mdpair.expi_hermitian (Cayley-Hamilton, Taylor with scaling and
    squaring), integrators.update_links against mdpair.update_links and
    sun.kinetic_energy against mdpair.kinetic_energy."""
    h = _hermitian(nc, seed=nc)
    u = tfields.hot_start(LAT, nc, seed=nc + 10, device="cpu")
    hj, uj = jnp.asarray(to_numpy(h)), jnp.asarray(to_numpy(u))
    h_md, u_md = mdpair.lift(h), mdpair.lift(u)
    for eps in (0.05, 0.7, 3.0):
        ref = jmdpair.lower(jmdpair.expi_hermitian(jmdpair.lift(hj), eps))
        assert np.abs(to_numpy(sun.expi_hermitian(h_md, eps)) - np.asarray(ref)).max() < 1e-12
    ref = jmdpair.lower(jmdpair.update_links(jmdpair.lift(uj), jmdpair.lift(hj), 0.05))
    got = integrators.update_links(u_md, h_md, 0.05)
    assert got.dtype == torch.complex128
    assert np.abs(to_numpy(got) - np.asarray(ref)).max() < 1e-12
    ke = float(jmdpair.kinetic_energy(jmdpair.lift(hj)))
    got = sun.kinetic_energy(h_md)
    assert got.dtype == torch.float64
    assert abs(float(got) - ke) < 1e-12 * ke
    # the lift of a complex64 field is exact and the lowering rounds it back
    h64 = h.to(torch.complex64)
    assert torch.equal(mdpair.lift(h64).to(torch.complex64), h64)


def _mixed_pair(dtype, dynamical, seed, dtau, md_steps):
    """One mixed trajectory of the JAX package and of the port from the same draws."""
    jdt = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    u = jfields.hot_start(LAT, 3, seed=seed).astype(jdt)
    key = jax.random.PRNGKey(seed + 1)
    kw = dict(dtau=dtau, md_steps=md_steps, md_precision="mixed")
    fa_j = JFA(JW(kappa=KAPPA)) if dynamical else None
    fa_t = TFA(TW(kappa=KAPPA)) if dynamical else None
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 6.0), fermi_action=fa_j, staged=False,
                        **kw).step(u, key)
    ut = to_torch(np.asarray(u))
    draws = jax_draws(key, u, pf_shape=fa_t.noise_shape(ut) if dynamical else None)
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 6.0), fermi_action=fa_t, **kw).step(
        ut, draws=draws)
    assert u_t.dtype == dtype
    return st_j, np.asarray(u_j), st_t, to_numpy(u_t)


@pytest.mark.parametrize("case", [
    # (dtype, dynamical, dH bar, links bar)
    ("complex128", False, 1e-9, 1e-12),
    ("complex128", True, 1e-9, 1e-12),
    ("complex64", False, 5e-4, 1e-6),
    ("complex64", True, 5e-4, None),
], ids=["quenched-c128", "wilson-c128", "quenched-c64", "wilson-c64"])
def test_mixed_trajectory_matches_jax(case):
    """HMC(md_precision="mixed") against the JAX package's fused mixed trajectory
    (staged=False) from its own draws.

    In complex64 S_g, and S_f, are float32 sums over the lattice in both packages,
    and the two sum in different orders: at 4^4 their S_g values differ by about
    1e-4 while the links agree to 1e-7. So dH is held at test_mdpair.py's complex64
    force-noise bar of 5e-4, and the float64 part of dH, the kinetic energy the
    mixed state carries, at 1e-5."""
    dtype_name, dynamical, dh_bar, u_bar = case
    dtype = getattr(torch, dtype_name)
    st_j, u_j, st_t, u_t = _mixed_pair(dtype, dynamical, seed=81, dtau=0.02, md_steps=10)
    assert st_t["accepted"] == bool(st_j["accepted"])
    assert abs(float(st_j["dH"]) - st_t["dH"]) < dh_bar, (st_j["dH"], st_t["dH"])
    if u_bar is not None:
        assert st_t["accepted"]  # a real comparison of evolved links
        assert np.abs(u_j - u_t).max() < u_bar
    # the kinetic energies in float64 on the lifted momenta
    assert abs(float(st_j["sp_old"]) - st_t["sp_old"]) < 1e-9 * float(st_j["sp_old"])
    kinetic = lambda st: float(st["sp_new"]) - float(st["sp_old"])  # noqa: E731
    assert abs(kinetic(st_j) - kinetic(st_t)) < (1e-9 if dtype == torch.complex128 else 1e-5)
    if dynamical:
        assert len(st_t["cg"]) == 11


def test_mixed_complex128_equals_plain_up_to_rounding():
    """Mixed with complex128 links is plain complex128 arithmetic."""
    u = tfields.hot_start(LAT, 3, seed=83, device="cpu")
    fa = TFA(TW(kappa=KAPPA))
    kw = dict(action=tga.wilson_gauge_action(3, 6.0), dtau=0.05, md_steps=4, fermi_action=fa)
    u_p, st_p = THMC(**kw).step(u, torch.Generator().manual_seed(84))
    u_m, st_m = THMC(**kw, md_precision="mixed").step(u, torch.Generator().manual_seed(84))
    assert abs(st_p["dH"] - st_m["dH"]) < 1e-9
    assert float((u_p - u_m).abs().max()) < 1e-12


def test_mixed_md_tracks_the_complex128_trajectory():
    """From one (U, H) start, quenched, 5 steps of 0.05: mixed complex64 MD lands at
    least 5x closer to the complex128 trajectory than plain complex64 MD does, and
    within 5e-6 (test_mdpair.py's property, on the port alone)."""
    act = tga.wilson_gauge_action(3, 5.7)
    u = tfields.hot_start(LAT, 3, seed=9, device="cpu")
    h = _hermitian(3, seed=10)
    c64 = torch.complex64

    def md(u0, h0, view):
        return integrators.run_md(u0, h0, lambda uu: tga.force(act, view(uu)), 0.05, 5)[0]

    u_ref = md(u, h, lambda uu: uu)
    u_pl = md(u.to(c64), h.to(c64), lambda uu: uu)
    u_mx = md(mdpair.lift(u.to(c64)), mdpair.lift(h.to(c64)), lambda uu: uu.to(c64))
    dev_plain = float((u_pl.to(torch.complex128) - u_ref).abs().max())
    dev_mixed = float((u_mx.to(c64).to(torch.complex128) - u_ref).abs().max())
    assert dev_mixed < dev_plain / 5.0, (dev_plain, dev_mixed)
    assert dev_mixed < 5e-6, dev_mixed


def test_mixed_toml_key_plumbs_to_updater(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = construct_params_from_toml({"HMC related": {"MDprecision": "mixed", "MDsteps": 4}},
                                   make_dirs=False)
    univ = build_universe(p, dtype=torch.complex64, device="cpu")
    up = updatemethod(p, univ)
    assert up.md_precision == "mixed"
    u2, st = up.step(univ.u, torch.Generator().manual_seed(0))
    assert u2.dtype == torch.complex64 and np.isfinite(st["dH"])
    with pytest.raises(ValueError, match="md_precision"):
        THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2,
             md_precision="bogus").step(univ.u, torch.Generator().manual_seed(0))


def test_mixed_wilson_run_in_complex64(tmp_path):
    """run_lqcd_params with MDprecision = "mixed" and Wilson fermions in complex64."""
    history = []
    p = _params(MDprecision="mixed", Nsteps=1, MDsteps=2, eps=1e-10, measuredir=str(tmp_path),
                measurement_methods=[])
    plaq = run_lqcd_params(p, dtype=torch.complex64, device="cpu", history=history)
    assert 0.0 < plaq < 1.0 and np.isfinite(history[0]["dH"]) and history[0]["cg"]


# every fermion action the port's HMC takes, as Params fields (and TOML keys)
ACTIONS = {
    "wilson": dict(Dirac_operator="Wilson", hop=KAPPA),
    "clover": dict(Dirac_operator="WilsonClover", hop=0.13625, Clover_coefficient=1.90952),
    "hasenbusch-sw": dict(Dirac_operator="Wilson", hop=KAPPA, hasenbusch=True,
                          hasenbusch_mu=0.5, SextonWeingargten=True, N_SextonWeingargten=2),
    "staggered-nf4": dict(Dirac_operator="Staggered", Nf=4, mass=0.5),
    "staggered-nf2": dict(Dirac_operator="Staggered", Nf=2, mass=0.5),
    "domainwall": dict(Dirac_operator="Domainwall", Domainwall_m=0.3),
    "stout-omelyan": dict(Dirac_operator="Wilson", hop=KAPPA, smearing_for_fermion="stout",
                          stout_numlayers=1, stout_rho=[0.1], MDscheme="Omelyan"),
}


@pytest.mark.parametrize("action", sorted(ACTIONS))
def test_mixed_runs_every_action(action):
    """run_lqcd_params with MDprecision = "mixed" for every fermion action of the
    port's HMC: in complex128 the plain run up to the exponential's rounding (dH
    1e-9, plaquette 1e-12), in complex64 a finite dH."""
    runs = {}
    for precision, dtype in (("auto", torch.complex128), ("mixed", torch.complex128),
                             ("mixed", torch.complex64)):
        history = []
        p = _params(MDprecision=precision, **ACTIONS[action], Nsteps=1, MDsteps=2,
                    measurement_methods=[])
        plaq = run_lqcd_params(p, dtype=dtype, device="cpu", history=history)
        assert 0.0 < plaq < 1.0 and len(history) == 1 and np.isfinite(history[0]["dH"])
        runs[precision, dtype] = (plaq, history[0]["dH"])
    (plaq_p, dh_p), (plaq_m, dh_m) = runs["auto", torch.complex128], runs["mixed", torch.complex128]
    assert abs(dh_m - dh_p) < 1e-9
    assert abs(plaq_m - plaq_p) < 1e-12


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    return f'"{v}"' if isinstance(v, str) else repr(v)


def _run_cli(tmp_path, action, device_args):
    """python -m latticeqcd_torch.run on a 4^4 complex64 TOML with MDprecision = "mixed"
    (quenched, or one of ACTIONS); returns the final plaquette."""
    keys = {} if action == "quenched" else dict(quench=False, **ACTIONS[action])
    toml = tmp_path / f"{action}.toml"
    toml.write_text(
        '["Physical setting"]\nL = [4, 4, 4, 4]\n"β" = 6.0\ninitial = "cold"\nNsteps = 1\n'
        + "".join(f"{k} = {_toml_value(v)}\n" for k, v in keys.items())
        + '["HMC related"]\n"Δτ" = 0.05\nMDsteps = 3\nMDprecision = "mixed"\n'
        '["System Control"]\nverboselevel = 1\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", str(toml), *device_args,
                          "--f32"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return float(out.stdout.split("final plaquette = ")[1].split()[0])


@pytest.mark.parametrize("action", ["quenched"] + sorted(ACTIONS))
def test_cli_runs_mixed_md(tmp_path, action):
    assert 0.9 < _run_cli(tmp_path, action, ["--device", "cpu"]) < 1.0


@pytest.mark.gpu
def test_cli_runs_mixed_md_on_gpu(tmp_path):
    """The command line on the card (its default device) with MDprecision = "mixed",
    quenched and for every fermion action of the port's HMC."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_mdpair.py)")
    for action in ["quenched"] + sorted(ACTIONS):
        assert 0.9 < _run_cli(tmp_path, action, []) < 1.0, action


def test_jax_pair_kinetic_energy_is_the_sum_of_squares():
    """The pair's kinetic energy is sum |H_ij|^2, tr H^2 for hermitian H: the port's
    tr H^2 on the lifted H agrees with it and with the JAX package's tr H^2."""
    h = mdpair.lift(_hermitian(3, seed=12))
    hj = jnp.asarray(to_numpy(h))
    ke = float(sun.kinetic_energy(h))
    assert abs(float(jmdpair.kinetic_energy(jmdpair.lift(hj))) - ke) < 1e-10
    assert abs(float(jsun.kinetic_energy(hj)) - ke) < 1e-10
