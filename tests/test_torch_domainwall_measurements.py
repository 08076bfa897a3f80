"""Port parity: the domain-wall measurements (the 4D effective propagator of
wall sources, the chiral condensate, the pion correlator, the low spectrum of
the 5D D^dag D), their scheduler lines, and domain-wall runs of
run_lqcd_params (HMC and Fileloading) on the CPU.

Z4 noise goes to both packages as the same integers, the Lanczos start
vector as the same fields (jax.random draws that torch cannot reproduce).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.measurements import MeasurementSet as JMeasurementSet  # noqa: E402
from latticeqcd_tpu.measurements import fermionic as jferm  # noqa: E402
from latticeqcd_tpu.measurements import scheduler as jsched  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac as JD  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.measurements import fermionic as tferm  # noqa: E402
from latticeqcd_torch.measurements import scheduler as tsched  # noqa: E402
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac as TD  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases as tapply_bc  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 2, 2)
ODD = (3, 4, 2, 2)
L5 = 4
EPS = 1e-24
DW = {"Dirac_operator": "Domainwall", "Domainwall_m": 0.3, "Domainwall_M": -1.8,
      "Domainwall_L5": L5}


def _links(lat, seed=51):
    u = jfields.hot_start(lat, 3, seed=seed, dtype=jnp.complex128)
    return u, to_torch(np.asarray(u))


def _z4_draws(key, lattice, nr):
    """The integers JAX's chiral_condensate draws for its nr noise vectors."""
    out = []
    for _ in range(nr):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.randint(sub, tuple(lattice) + (4, 3), 0, 4)))
    return np.stack(out)


def _jax_start_vector(monkeypatch):
    """Make the port's Lanczos start vectors the JAX package's: a Generator
    seeded with SPECTRUM_SEED + s stands for PRNGKey(SPECTRUM_SEED + s)."""
    def start(lattice, nc, nspin=4, dtype=torch.complex128, device="cpu", generator=None):
        key = jax.random.PRNGKey(generator.initial_seed())
        return to_torch(np.asarray(jw.gaussian_spinor(key, lattice, nc, nspin=nspin))).to(dtype)

    monkeypatch.setattr(tferm, "gaussian_spinor", start)


@pytest.mark.parametrize("lat", [LAT, ODD], ids=["schur", "full"])
def test_effective_propagator_matches_jax(lat):
    u, ut = _links(lat)
    jd, td = JD(0.3, -1.8, L5), TD(0.3, -1.8, L5)
    rng = np.random.default_rng(52)
    b = rng.standard_normal((2,) + lat + (4, 3)) + 1j * rng.standard_normal((2,) + lat + (4, 3))
    q_j = jferm._dw_effective_propagator_multi(jd, jw.apply_boundary_phases(u), jnp.asarray(b),
                                               EPS, 3000)
    log = []
    q_t = tferm._dw_effective_propagator_multi(td, tapply_bc(ut), to_torch(b), EPS, 3000, log=log)
    assert np.abs(np.asarray(q_j) - to_numpy(q_t)).max() < 1e-10
    assert len(log) == 2 and all(c["rsq"] <= c["target"] for c in log)
    # batched (the card's dispatch) and sequential solves agree
    q_b = tferm._dw_effective_propagator_multi(td, tapply_bc(ut), to_torch(b), EPS, 3000,
                                               force_mode="batched")
    assert float((q_b - q_t).abs().max()) < 1e-10


@pytest.mark.parametrize("lat,mass", [(LAT, 0.3), (LAT, 0.5), (ODD, 0.3)],
                         ids=["schur-m0.3", "schur-m0.5", "full-m0.3"])
def test_condensate_per_noise_matches_jax(lat, mass):
    u, ut = _links(lat, seed=53)
    jd, td = JD(mass, -1.8, L5), TD(mass, -1.8, L5)
    key = jax.random.PRNGKey(54)
    pbp_j, vals_j = jferm.chiral_condensate(u, jd, key, nr=2, eps=EPS)
    pbp_t, vals_t = tferm.chiral_condensate(ut, td, nr=2, eps=EPS, draws=_z4_draws(key, lat, 2))
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-9)
    assert abs(pbp_t - pbp_j) < 1e-9 * abs(pbp_j)


def test_pion_correlator_matches_jax():
    u, ut = _links(LAT, seed=55)
    c_j = jferm.pion_correlator(u, JD(0.3, -1.8, L5), eps=1e-20)
    log = []
    c_t = tferm.pion_correlator(ut, TD(0.3, -1.8, L5), eps=1e-20, log=log)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-9)
    assert np.all(c_t > 0) and len(log) == 12


def test_spectrum_matches_jax_from_the_same_start(monkeypatch):
    """The low spectrum of the full-volume 5D D^dag D from the JAX package's
    start vector (one PRNGKey(SPECTRUM_SEED + s) field per slice)."""
    u, ut = _links(LAT, seed=56)
    vals_j = jferm.dirac_low_spectrum(u, JD(0.3, -1.8, L5), k=3, m=24)
    v0 = torch.stack([to_torch(np.asarray(jw.gaussian_spinor(
        jax.random.PRNGKey(tferm.SPECTRUM_SEED + s), LAT, 3))) for s in range(L5)])
    vals_t = tferm.dirac_low_spectrum(ut, TD(0.3, -1.8, L5), k=3, m=24, v0=v0)
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-9)
    assert np.all(np.diff(vals_t) >= 0) and np.all(vals_t > 0)
    # the default start vector is drawn from SPECTRUM_SEED + s, the same as the injected one
    _jax_start_vector(monkeypatch)
    np.testing.assert_array_equal(tferm.dirac_low_spectrum(ut, TD(0.3, -1.8, L5), k=3, m=24),
                                  vals_t)


@pytest.mark.parametrize("fparams", [
    DW,
    {"Dirac_operator": "Domainwall"},
    {"Dirac_operator": "domainwall", "mass": 0.2, "M": -1.5, "L5": 6,
     "boundarycondition": [1, 1, 1, 1]},
], ids=["long-keys", "defaults", "short-keys"])
def test_build_dirac_from_params_matches_jax(fparams):
    j = jsched.build_dirac_from_params(fparams, LAT)
    t = tsched.build_dirac_from_params(fparams, LAT)
    assert isinstance(t, TD)
    assert (t.mass, t.m5, t.l5, t.r, tuple(t.bc)) == (j.mass, j.m5, j.l5, j.r, tuple(j.bc))


def _parse(line):
    """(numbers, comment) of a measurement line: "[#] n1 n2 ... [# comment]";
    a line of text alone ("#pioncorrelator") is all comment."""
    body, _, comment = (line[1:] if line.startswith("#") else line).partition("#")
    try:
        return [float(x) for x in body.split()], comment
    except ValueError:
        return [], line


def _same_lines(lj, lt, itrj, rtol):
    assert len(lj) == len(lt) > 0
    for a, b in zip(lj, lt):
        (na, ca), (nb, cb) = _parse(a), _parse(b)
        assert ca == cb and len(na) == len(nb), (a, b)
        if na:
            assert na[0] == nb[0] == itrj
            np.testing.assert_allclose(nb, na, rtol=rtol)


def test_measurement_set_writes_the_jax_lines(tmp_path, monkeypatch):
    """Pion_correlator, Chiral_condensate and Dirac_spectrum with domain-wall
    fermion_parameters through both packages' MeasurementSet: the same files,
    lines and values (1e-7)."""
    u, ut = _links(LAT, seed=57)
    methods = [
        {"methodname": "Pion_correlator", "eps": 1e-16, "fermion_parameters": DW},
        {"methodname": "Chiral_condensate", "Nr": 2, "eps": 1e-16, "noise_seed": 7,
         "fermion_parameters": DW},
        {"methodname": "Dirac_spectrum", "Neig": 3, "Nlanczos": 24, "fermion_parameters": DW},
    ]
    itrj = 2
    draws = iter(_z4_draws(jax.random.PRNGKey(7 + itrj), LAT, 2))
    _jax_start_vector(monkeypatch)
    z4 = tferm.z4_spinor
    monkeypatch.setattr(tferm, "z4_spinor",
                        lambda *a, **kw: z4(*a, **dict(kw, generator=None, draws=next(draws))))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jms = JMeasurementSet.from_methods(methods, measuredir=str(jdir))
    jms.calc_measurement_values(itrj, u)
    jms.close()
    tms = tsched.MeasurementSet.from_methods(methods, measuredir=str(tdir))
    assert len(tms.calc_measurement_values(itrj, ut)) == 3
    tms.close()
    for name in ("Pion_correlator", "Chiral_condensate", "Dirac_spectrum"):
        _same_lines((jdir / f"{name}.txt").read_text().splitlines(),
                    (tdir / f"{name}.txt").read_text().splitlines(), itrj, 1e-7)


def _params(**kw):
    base = dict(L=LAT, NC=3, beta=5.7, initial="hot", update_method="HMC", quench=False,
                Dirac_operator="Domainwall", Domainwall_m=0.3, Domainwall_M=-1.8,
                Domainwall_L5=L5, dtau=0.05, MDsteps=2, Nsteps=1, eps=1e-16, randomseed=5,
                verboselevel=1)
    base.update(kw)
    return TParams(**base)


def test_run_lqcd_params_domainwall_then_fileloading(tmp_path):
    """A domain-wall HMC run saving NPZ with a domain-wall chiral condensate,
    then a Fileloading run over its files measuring the same: the lines of the
    saved trajectory's links agree."""
    pbp = [{"methodname": "Chiral_condensate", "Nr": 1, "eps": 1e-16, "fermion_parameters": DW}]
    history = []
    (tmp_path / "confs").mkdir()
    plaq = run_lqcd_params(_params(measuredir=str(tmp_path / "hmc"), saveU_format="NPZ",
                                   saveU_dir=str(tmp_path / "confs"), saveU_every=1,
                                   measurement_methods=pbp),
                           dtype=torch.complex128, device="cpu", history=history)
    assert 0.0 < plaq < 1.0 and len(history) == 1 and np.isfinite(history[0]["dH"])
    assert history[0]["cg"] and all(c["rsq"] <= c["target"] for c in history[0]["cg"])
    run_lqcd_params(_params(update_method="Fileloading", loadU_format="NPZ",
                            loadU_dir=str(tmp_path / "confs"), measuredir=str(tmp_path / "load"),
                            measurement_methods=pbp), dtype=torch.complex128, device="cpu")
    hmc = (tmp_path / "hmc" / "Chiral_condensate.txt").read_text().splitlines()
    loaded = (tmp_path / "load" / "Chiral_condensate.txt").read_text().splitlines()
    # two lines per measurement: itrj 0 and 1 from HMC; the start, conf_00000001.npz and
    # checkpoint.npz (the same links) when loaded
    assert len(hmc) == 4 and len(loaded) == 6
    assert hmc[2:] == loaded[2:4] and hmc[2].startswith("# 1 1 ")


def test_run_lqcd_params_domainwall_with_stout_and_sexton_weingarten():
    history = []
    p = _params(smearing_for_fermion="stout", stout_numlayers=1, stout_rho=[0.1],
                SextonWeingargten=True, N_SextonWeingargten=2, measurement_methods=[])
    plaq = run_lqcd_params(p, dtype=torch.complex128, device="cpu", history=history)
    assert 0.0 < plaq < 1.0 and np.isfinite(history[0]["dH"]) and abs(history[0]["dH"]) < 1.0
