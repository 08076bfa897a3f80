"""Port parity: the fermionic measurements with the clover-improved Wilson
operator (the clover Schur branch of ``_solve_dinv_multi``, full-volume CGNE and
the Lanczos spectrum with the clover term built once per call), the dense
clover log det of the integrated updaters, and run_lqcd_params with
Dirac_operator = "WilsonClover" and hasenbusch = true on the CPU.

Z4 noise and the Lanczos start vector are injected as the numbers the JAX
package draws. The ``gpu`` test holds the card against the CPU (run: python -m
pytest -m gpu tests/test_torch_clover_measurements.py -n 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.measurements import fermionic as jferm  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.system import lqcd as jlqcd  # noqa: E402
from latticeqcd_tpu.system.params import Params as JParams  # noqa: E402
from latticeqcd_tpu.updates.slhmc import dense_logdet_fermi_action as jdense  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.measurements import fermionic as tferm  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402
from latticeqcd_torch.updates.slhmc import dense_logdet_fermi_action as tdense  # noqa: E402
from test_torch_measurements import _jax_start_vector, _lines, _same_lines, _z4_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
ODD = (3, 4, 2, 4)
KAPPA, CSW = 0.13625, 1.90952
EPS = 1e-22
CLOVER = {"Dirac_operator": "WilsonClover", "hop": KAPPA, "Clover_coefficient": CSW}


def _links(lat, seed):
    u = jfields.hot_start(lat, 3, seed=seed, dtype=jnp.complex128)
    return u, to_torch(np.asarray(u))


def _diracs(csw=CSW):
    return jw.WilsonDirac(kappa=KAPPA, csw=csw), tw.WilsonDirac(kappa=KAPPA, csw=csw)


class _Count:
    """Counts calls of a WilsonDirac method (monkeypatched in)."""

    def __init__(self, monkeypatch, name):
        self.n = 0
        fn = getattr(tw.WilsonDirac, name)

        def counted(dirac, *a, **kw):
            self.n += 1
            return fn(dirac, *a, **kw)

        monkeypatch.setattr(tw.WilsonDirac, name, counted)


# -------------------------------------------------------------- measurements


@pytest.mark.parametrize("lat", [LAT, ODD], ids=["schur-4^4", "cgne-3x4x2x4"])
def test_clover_pion_correlator_matches_jax(lat, monkeypatch):
    """Even lattices take the clover Schur solve (the blocks built once for the
    12 sources), an odd extent full-volume CGNE (the clover term built once)."""
    u, ut = _links(lat, seed=sum(lat))
    jd, td = _diracs()
    blocks, terms = _Count(monkeypatch, "clover_packed_blocks"), _Count(monkeypatch, "clover_term")
    log = []
    c_t = tferm.pion_correlator(ut, td, eps=EPS, log=log)
    np.testing.assert_allclose(c_t, jferm.pion_correlator(u, jd, eps=EPS), rtol=1e-9)
    assert len(log) == 12 and all(r["rsq"] <= r["target"] for r in log)
    assert (blocks.n, terms.n) == ((1, 1) if lat == LAT else (0, 1))


def test_clover_chiral_condensate_matches_jax():
    u, ut = _links(LAT, seed=21)
    jd, td = _diracs()
    key = jax.random.PRNGKey(22)
    pbp_j, vals_j = jferm.chiral_condensate(u, jd, key, nr=3, eps=EPS)
    pbp_t, vals_t = tferm.chiral_condensate(ut, td, nr=3, eps=EPS,
                                            draws=_z4_draws(key, LAT, 3, 4, 3))
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-9)
    np.testing.assert_allclose(pbp_t, pbp_j, rtol=1e-9)


def test_clover_dirac_spectrum_matches_jax(monkeypatch):
    """Lanczos on the clover D^dag D from the JAX package's start vector, the
    clover term built once for the 40 steps."""
    lat = (4, 4, 2, 2)
    u, ut = _links(lat, seed=2)
    jd, td = _diracs()
    v0 = jw.gaussian_spinor(jax.random.PRNGKey(tferm.SPECTRUM_SEED), lat, 3, nspin=4)
    vals_j = jferm.dirac_low_spectrum(u, jd, k=3, m=40)
    terms = _Count(monkeypatch, "clover_term")
    vals_t = tferm.dirac_low_spectrum(ut, td, k=3, m=40, v0=to_torch(np.asarray(v0)))
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-8)
    assert list(vals_t) == sorted(vals_t) and np.all(vals_t > 0) and terms.n == 1


def test_clover_schur_solve_is_not_the_wilson_one():
    """The clover Schur branch must come before the csw = 0 one: a clover
    operator on an all-even lattice solved as plain Wilson would leave a
    residual of the clover term's size."""
    _, ut = _links(LAT, seed=23)
    _, td = _diracs()
    up = tw.apply_boundary_phases(ut, td.bc)
    b = torch.zeros(LAT + (4, 3), dtype=ut.dtype)
    b[0, 0, 0, 0, 0, 0] = 1.0
    x = tferm._solve_dinv(td, up, b, EPS, 3000)
    assert float((td.apply(up, x) - b).abs().max()) < 1e-9
    x0 = tferm._solve_dinv(tw.WilsonDirac(kappa=KAPPA), up, b, EPS, 3000)
    assert float((td.apply(up, x0) - b).abs().max()) > 1e-3


def test_measurement_set_writes_the_jax_lines(tmp_path, monkeypatch):
    """The three methods with WilsonClover fermion_parameters through both
    packages' MeasurementSet: the same files and values (1e-7)."""
    from latticeqcd_tpu.measurements import MeasurementSet as JMeasurementSet
    from latticeqcd_torch.measurements import scheduler as tsched

    u, ut = _links(LAT, seed=31)
    methods = [
        {"methodname": "Pion_correlator", "eps": EPS, "fermion_parameters": CLOVER},
        {"methodname": "Chiral_condensate", "Nr": 2, "eps": EPS, "noise_seed": 7,
         "fermion_parameters": CLOVER},
        {"methodname": "Dirac_spectrum", "Neig": 3, "Nlanczos": 40, "fermion_parameters": CLOVER},
    ]
    itrj = 3
    draws = iter(_z4_draws(jax.random.PRNGKey(7 + itrj), LAT, 3, 4, 2))
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
    assert tsched.build_dirac_from_params(CLOVER, LAT).csw == CSW
    for name in ("Pion_correlator", "Chiral_condensate", "Dirac_spectrum"):
        _same_lines(_lines(jdir / f"{name}.txt"), _lines(tdir / f"{name}.txt"), itrj, 1e-7)


# ------------------------------------------------------------ dense log det


def test_clover_dense_logdet_matches_jax(monkeypatch):
    """The integrated updaters' -log det(D^dag D) of the clover operator at
    4x2x2x2 (dim 384), the clover term built once for the 384 columns."""
    lat = (4, 2, 2, 2)
    u, ut = _links(lat, seed=24)
    jd, td = _diracs()
    shape = lat + (4, 3)
    s_j = float(jdense(jd, shape, 1.0)(jw.apply_boundary_phases(u)))
    terms = _Count(monkeypatch, "clover_term")
    s_t = float(tdense(td, shape, 1.0)(tw.apply_boundary_phases(ut)))
    assert abs(s_t - s_j) < 1e-12 * abs(s_j) and terms.n == 1
    s_0 = float(tdense(tw.WilsonDirac(kappa=KAPPA), shape, 1.0)(tw.apply_boundary_phases(ut)))
    assert abs(s_0 - s_t) > 1e-3


# ---------------------------------------------------------- run_lqcd_params


def _params(**kw):
    base = dict(L=LAT, NC=3, beta=5.3, initial="hot", update_method="HMC", quench=False,
                Dirac_operator="WilsonClover", hop=KAPPA, Clover_coefficient=CSW, dtau=0.05,
                MDsteps=2, Nsteps=1, eps=1e-16, randomseed=5, verboselevel=1)
    base.update(kw)
    return TParams(**base)


@pytest.mark.parametrize("case", [
    "clover-sw", "clover-stout", "clover-integrated-hmc",
    "hasenbusch-packed", "hasenbusch-packed-sw", "hasenbusch-clover-sw",
])
def test_run_lqcd_params_clover_and_hasenbusch(case):
    """One CPU trajectory of each route through run_lqcd_params: a finite dH,
    every solve at its target."""
    kw = {
        "clover-sw": dict(SextonWeingargten=True, N_SextonWeingargten=2),
        "clover-stout": dict(smearing_for_fermion="stout", stout_numlayers=1, stout_rho=[0.1]),
        "clover-integrated-hmc": dict(update_method="IntegratedHMC", L=(4, 4, 2, 2)),
        "hasenbusch-packed": dict(Dirac_operator="Wilson", hasenbusch=True),
        "hasenbusch-packed-sw": dict(Dirac_operator="Wilson", hasenbusch=True,
                                     SextonWeingargten=True, N_SextonWeingargten=2),
        "hasenbusch-clover-sw": dict(hasenbusch=True, hasenbusch_mu=0.3, SextonWeingargten=True,
                                     N_SextonWeingargten=2),
    }[case]
    history = []
    plaq = run_lqcd_params(_params(**kw, measurement_methods=[]), dtype=torch.complex128,
                           device="cpu", history=history)
    assert 0.0 < plaq < 1.0 and len(history) == 1 and np.isfinite(history[0]["dH"])
    assert all(c["rsq"] <= c["target"] for c in history[0]["cg"])
    if case.startswith("hasenbusch") and case.endswith("sw"):
        # per MD step one light and two heavy forces, then the action's two solves
        assert len(history[0]["cg"]) == 2 * 3 + 2


def test_integrated_updaters_refuse_hasenbusch():
    with pytest.raises(ValueError, match="Wilson/Staggered fermions only"):
        run_lqcd_params(_params(update_method="IntegratedHMC", hasenbusch=True, L=(4, 4, 2, 2)),
                        device="cpu")


def test_run_with_clover_measurements_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: both packages' run_lqcd_params with the clover
    action on the same hot start (Nsteps 0: the trajectory-0 measurements)
    write the same clover Pion_correlator and Dirac_spectrum files."""
    methods = [
        {"methodname": "Pion_correlator", "eps": EPS, "fermion_parameters": CLOVER},
        {"methodname": "Dirac_spectrum", "Neig": 3, "Nlanczos": 40, "fermion_parameters": CLOVER},
    ]
    kw = dict(L=LAT, NC=3, beta=5.3, initial="hot", update_method="HMC", quench=False,
              Dirac_operator="WilsonClover", hop=KAPPA, Clover_coefficient=CSW, hasenbusch=True,
              Nsteps=0, randomseed=31, verboselevel=1, measurement_methods=methods)
    _jax_start_vector(monkeypatch)
    jlqcd.run_lqcd_params(JParams(**kw, measuredir=str(tmp_path / "jax")))
    run_lqcd_params(TParams(**kw, measuredir=str(tmp_path / "torch")), dtype=torch.complex128,
                    device="cpu")
    for name in ("Pion_correlator", "Dirac_spectrum"):
        _same_lines(_lines(tmp_path / "jax" / f"{name}.txt"),
                    _lines(tmp_path / "torch" / f"{name}.txt"), 0, 1e-7)


def test_fileloading_measures_clover(tmp_path):
    """A clover HMC run saving NPZ with a clover pion correlator, then a
    Fileloading run over its files measuring the same: the saved trajectory's
    lines agree."""
    pion = [{"methodname": "Pion_correlator", "eps": 1e-16, "fermion_parameters": CLOVER}]
    (tmp_path / "confs").mkdir()
    run_lqcd_params(_params(measuredir=str(tmp_path / "hmc"), saveU_format="NPZ",
                            saveU_dir=str(tmp_path / "confs"), saveU_every=1,
                            measurement_methods=pion), dtype=torch.complex128, device="cpu")
    run_lqcd_params(_params(update_method="Fileloading", loadU_format="NPZ",
                            loadU_dir=str(tmp_path / "confs"), measuredir=str(tmp_path / "load"),
                            measurement_methods=pion), dtype=torch.complex128, device="cpu")
    hmc = _lines(tmp_path / "hmc" / "Pion_correlator.txt")
    loaded = _lines(tmp_path / "load" / "Pion_correlator.txt")
    # two lines per measurement: itrj 0 and 1 from HMC; the start, conf_00000001.npz and
    # checkpoint.npz when loaded
    assert len(hmc) == 4 and len(loaded) == 6
    assert hmc[2:] == loaded[2:4] and hmc[2].startswith("1 ")


# ---------------------------------------------------------------------- card


@pytest.mark.gpu
def test_clover_measurements_on_gpu():
    """On the card: the clover pion correlator through the Schur branch
    (wilson_hop_packed) and through CGNE (wilson_window), against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_clover_measurements.py)")
    _, td = _diracs()
    for lat, counter in ((LAT, lambda: wk.launches), (ODD, lambda: ww.launches)):
        _, ut = _links(lat, seed=sum(lat))
        c_c = tferm.pion_correlator(ut, td, eps=EPS)
        before = counter()
        c_g = tferm.pion_correlator(ut.cuda(), td, eps=EPS)
        assert counter() > before
        np.testing.assert_allclose(c_g, c_c, rtol=1e-9)
