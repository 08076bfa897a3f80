"""Port parity: HMC trajectories replayed from the JAX package's own draws,
and the port's run_lqcd_params end to end on the CPU."""

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
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC, Draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA = 0.141139
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_draws(key, u, pf_shape=None) -> Draws:
    """The draws of HMC._step_fused for this key: momentum normals from
    k_mom, pseudofermion normals from k_ferm, the uniform from k_acc."""
    _, k_mom, k_ferm, k_acc = jax.random.split(key, 4)
    rdt = jnp.float64 if u.dtype == jnp.complex128 else jnp.float32

    def normals(k, shape):
        k1, k2 = jax.random.split(k)
        return (to_torch(jax.random.normal(k1, shape, dtype=rdt)),
                to_torch(jax.random.normal(k2, shape, dtype=rdt)))

    xi = normals(k_ferm, pf_shape) if pf_shape is not None else None
    return Draws(normals(k_mom, u.shape), xi, float(jax.random.uniform(k_acc, dtype=rdt)))


def _compare(st_j, u_j, st_t, u_t):
    assert abs(float(st_j["dH"]) - st_t["dH"]) < 1e-9
    assert bool(st_j["accepted"]) == st_t["accepted"]
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-10
    # the evolved state itself (also on a rejected trajectory)
    for k in ("sg_new", "sp_new", "sf_new"):
        a = float(st_j[k])
        assert abs(a - st_t[k]) < 1e-9 * max(1.0, abs(a)), k


def test_quenched_trajectory_matches_jax():
    u = jfields.hot_start(LAT, 3, seed=71)
    key = jax.random.PRNGKey(72)
    kw = dict(dtau=0.02, md_steps=10)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 6.0), staged=False, **kw).step(u, key)
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 6.0), **kw).step(
        to_torch(np.asarray(u)), draws=jax_draws(key, u))
    assert st_t["accepted"]  # a real comparison of evolved links
    _compare(st_j, u_j, st_t, u_t)
    assert st_t["cg"] == []


def test_wilson_dynamical_trajectory_matches_jax():
    """The 4^4 reference workload: beta 6.0, kappa 0.141139, dtau 0.1, 10 steps."""
    u = jfields.hot_start(LAT, 3, seed=73)
    key = jax.random.PRNGKey(74)
    kw = dict(dtau=0.1, md_steps=10)
    fa_j = JFA(JW(kappa=KAPPA))
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 6.0), fermi_action=fa_j,
                        staged=False, **kw).step(u, key)
    fa_t = TFA(TW(kappa=KAPPA))
    ut = to_torch(np.asarray(u))
    draws = jax_draws(key, u, pf_shape=fa_t.noise_shape(ut))
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 6.0), fermi_action=fa_t, **kw).step(
        ut, draws=draws)
    _compare(st_j, u_j, st_t, u_t)
    assert abs(float(st_j["sf_old"]) - st_t["sf_old"]) < 1e-9
    # 10 warm-started force solves and the final action solve, all converged
    assert len(st_t["cg"]) == 11
    assert all(c["rsq"] <= c["target"] for c in st_t["cg"])


def test_complex64_trajectory_keeps_dtype():
    u = tfields.hot_start(LAT, 3, seed=75, dtype=torch.complex64, device="cpu")
    fa = TFA(TW(kappa=KAPPA), eps_cg=1e-10, max_cg=500)
    hmc = THMC(action=tga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=2, fermi_action=fa)
    u2, st = hmc.step(u, torch.Generator().manual_seed(1))
    assert u2.dtype == torch.complex64
    assert np.isfinite(st["dH"])


def _params(**kw):
    base = dict(L=LAT, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
                Dirac_operator="Wilson", hop=KAPPA, dtau=0.05, MDsteps=4, Nsteps=2, eps=1e-14,
                randomseed=5, verboselevel=2,
                measurement_methods=[{"methodname": "Plaquette"},
                                     {"methodname": "Polyakov_loop"}])
    base.update(kw)
    return Params(**base)


def test_run_lqcd_params_cpu_smoke(tmp_path, capsys):
    history = []
    p = _params(measuredir=str(tmp_path))
    plaq = run_lqcd_params(p, dtype=torch.complex128, device="cpu", history=history)
    out = capsys.readouterr().out
    assert 0.0 < plaq < 1.0
    assert [r["itrj"] for r in history] == [1, 2]
    assert all(np.isfinite(r["dH"]) and r["cg"] for r in history)
    assert "Snew - Sold = " in out and "Acceptance" in out
    lines = (tmp_path / "Plaquette.txt").read_text().splitlines()
    assert [line.split()[0] for line in lines] == ["0", "1", "2"]
    assert abs(float(lines[-1].split()[1]) - plaq) < 1e-12
    assert (tmp_path / "Polyakov_loop.txt").exists()


@pytest.mark.parametrize("field,value", [
    ("update_method", "Heatbath"), ("Dirac_operator", "Domainwall"),
    ("Dirac_operator", "WilsonClover"),
    ("SextonWeingargten", True), ("MDprecision", "mixed"), ("hasenbusch", True),
    ("smearing_for_fermion", "stout"), ("couplinglist", ["rectangular"]),
])
def test_run_refuses_what_is_not_ported(field, value):
    if (field, value) == ("update_method", "Heatbath"):
        # ported, and quenched only: with these Wilson fermions it raises as the JAX package does
        with pytest.raises(ValueError, match="only for quench"):
            run_lqcd_params(_params(**{field: value}), device="cpu")
        return
    ported = {"SextonWeingargten": dict(N_SextonWeingargten=2),
              "smearing_for_fermion": dict(stout_numlayers=1, stout_rho=[0.1]),
              "couplinglist": dict(couplingcoeff=[-6.0 / 20])}
    if field in ported:
        # ported: one CPU trajectory with a finite dH
        history = []
        p = _params(**{field: value}, **ported[field], Nsteps=1, MDsteps=2,
                    measurement_methods=[])
        plaq = run_lqcd_params(p, device="cpu", history=history)
        assert 0.0 < plaq < 1.0 and len(history) == 1 and np.isfinite(history[0]["dH"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_lqcd_params(_params(**{field: value}), device="cpu")


def test_cli_runs_a_toml_on_the_cpu(tmp_path):
    toml = tmp_path / "run.toml"
    toml.write_text(
        '["Physical setting"]\nL = [4, 4, 4, 4]\n"β" = 6.0\ninitial = "cold"\nNsteps = 1\n'
        '["HMC related"]\n"Δτ" = 0.05\nMDsteps = 3\n'
        '["System Control"]\nverboselevel = 1\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", str(toml), "--device",
                          "cpu", "--f32"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    plaq = float(out.stdout.split("final plaquette = ")[1].split()[0])
    assert 0.9 < plaq < 1.0
