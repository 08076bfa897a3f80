"""Port parity: the fermionic measurements (pion correlator, chiral
condensate, low Dirac spectrum), the batched CG and the Lanczos Ritz pairs
behind them, and the wilson_window kernel module (B2).

Inputs are drawn by JAX or numpy and injected into the port: Z4 noise as
the same integers, the Lanczos start vector as the same field. On the CPU
the kernel wrappers take their plain versions; the CUDA kernel is held
against its plain version by the ``gpu`` tests below and by chip_smoke.py.
"""

import functools
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.measurements import MeasurementSet as JMeasurementSet  # noqa: E402
from latticeqcd_tpu.measurements import fermionic as jferm  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import solvers as jsolvers  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_tpu.system import lqcd as jlqcd  # noqa: E402
from latticeqcd_tpu.system.params import Params as JParams  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.measurements import fermionic as tferm  # noqa: E402
from latticeqcd_torch.measurements import scheduler as tsched  # noqa: E402
from latticeqcd_torch.ops import eigen as teigen  # noqa: E402
from latticeqcd_torch.ops import solvers as tsolvers  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
EPS = 1e-22
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")


def _links(lat, nc=3, seed=1):
    u = jfields.hot_start(lat, nc, seed=seed, dtype=jnp.complex128)
    return u, to_torch(np.asarray(u))


def _z4_draws(key, lattice, nc, nspin, nr):
    """The integers JAX's chiral_condensate draws for its nr noise vectors."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    out = []
    for _ in range(nr):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.randint(sub, shape, 0, 4)))
    return np.stack(out)


# ------------------------------------------------------------------ noise


@pytest.mark.parametrize("nspin", [4, 1])
def test_z4_spinor_from_the_same_integers(nspin):
    key = jax.random.PRNGKey(5)
    lat = (2, 4, 2, 2)
    k = np.array(jax.random.randint(key, lat + ((nspin, 3) if nspin > 1 else (3,)), 0, 4))
    a = np.asarray(jw.z4_spinor(key, lat, 3, nspin=nspin))
    b = to_numpy(tw.z4_spinor(lat, 3, nspin=nspin, device="cpu", draws=k))
    np.testing.assert_array_equal(a, b)
    g = tw.z4_spinor(lat, 3, nspin=nspin, device="cpu", generator=torch.Generator().manual_seed(1))
    assert set(np.unique(to_numpy(g)).tolist()) <= {1, 1j, -1, -1j}


# ------------------------------------------------------------- batched CG


def _dhat_normal_stack(lat=LAT, n=3, dtype=torch.complex128):
    """3 right-hand sides of the packed Wilson Dhat^dag Dhat, as both packages
    see them (the port's operator in ``dtype``)."""
    u, ut = _links(lat, seed=11)
    up, upt = jw.apply_boundary_phases(u), tw.apply_boundary_phases(ut).to(dtype)
    jd, td = jw.WilsonDirac(kappa=0.12), tw.WilsonDirac(kappa=0.12)
    ueo_j, ueo_t = jd.packed_links(up), td.packed_links(upt)
    rng = np.random.default_rng(12)
    shape = (n, lat[0] // 2) + lat[1:] + (4, 3)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    b[1] *= 1e-3  # RHS of different scale converge at different iterations
    op_j = lambda v: jd.apply_dhat_dagger(ueo_j, jd.apply_dhat(ueo_j, v))  # noqa: E731
    op_t = lambda v: td.apply_dhat_dagger(ueo_t, td.apply_dhat(ueo_t, v))  # noqa: E731
    return op_j, op_t, b


def test_cg_multi_matches_jax():
    op_j, op_t, b = _dhat_normal_stack()
    x_j, it_j, rsq_j = jsolvers.cg_multi(jax.vmap(op_j), jnp.asarray(b), eps=1e-20)
    log = []
    x_t, it_t, rsq_t = tsolvers.cg_multi(lambda v: torch.stack([op_t(vi) for vi in v]),
                                         to_torch(b), eps=1e-20, log=log)
    assert int(it_j) == it_t
    assert float(np.abs(np.asarray(x_j) - to_numpy(x_t)).max()) < 1e-10
    np.testing.assert_allclose(to_numpy(rsq_t), np.asarray(rsq_j), rtol=1e-6, atol=1e-30)
    assert log[0]["iterations"] == it_t and log[0]["rhs"] == 3
    assert log[0]["rsq"] <= log[0]["target"]


def test_cg_multi_auto_sequential_matches_batched():
    _, op_t, b = _dhat_normal_stack()
    bt = to_torch(b)
    x_s, it_s, rsq_s = tsolvers.cg_multi_auto(op_t, bt, eps=1e-20, force_mode="sequential")
    x_b, it_b, rsq_b = tsolvers.cg_multi_auto(op_t, bt, eps=1e-20, force_mode="batched")
    np.testing.assert_allclose(to_numpy(x_b), to_numpy(x_s), rtol=1e-9, atol=1e-12)
    assert it_s == it_b
    # the CPU dispatches sequentially
    x_d, _, _ = tsolvers.cg_multi_auto(op_t, bt, eps=1e-20)
    np.testing.assert_array_equal(to_numpy(x_d), to_numpy(x_s))
    with pytest.raises(ValueError):
        tsolvers.cg_multi_auto(op_t, bt, force_mode="vmap")


def test_cg_multi_complex64_verifies_each_rhs():
    """complex64: a zero RHS stays frozen at x = 0, the others reach the
    attainable target on their true residual (per-RHS verified restarts)."""
    _, op_t, b = _dhat_normal_stack(dtype=torch.complex64)
    b[1] = 0.0
    bt = to_torch(b).to(torch.complex64)
    x, it, rsq = tsolvers.cg_multi(lambda v: torch.stack([op_t(vi) for vi in v]), bt, eps=1e-19,
                                   maxiter=500)
    assert it < 500
    assert float(x[1].abs().max()) == 0.0
    bsq = torch.clamp(torch.sum(torch.abs(bt) ** 2, dim=(1, 2, 3, 4, 5, 6)), min=1.0)
    true = torch.stack([torch.sum(torch.abs(bt[i] - op_t(x[i])) ** 2) for i in range(3)])
    np.testing.assert_allclose(to_numpy(rsq), to_numpy(true), rtol=1e-3, atol=1e-30)
    assert bool(torch.all(rsq / bsq <= tsolvers._VERIFY_FLOOR))


# -------------------------------------------------------------- Ritz pairs


def test_ritz_pairs_low_complex64_breakdown_is_finite():
    """A start vector that is an eigenvector breaks down after one step: the
    masked steps sort past the genuine value, everything stays finite, and
    the deflation guess is exact on the one mode (ROADMAP C2)."""
    diag = torch.linspace(0.5, 4.0, 64, dtype=torch.float32).to(torch.complex64)
    v0 = torch.zeros(64, dtype=torch.complex64)
    v0[3] = 1.0
    evals, vecs = teigen.ritz_pairs_low(lambda v: diag * v, v0, 8, 5)
    assert evals.dtype == torch.float32
    assert torch.all(torch.isfinite(evals)) and torch.all(torch.isfinite(torch.view_as_real(vecs)))
    assert float(evals[0]) == float(diag[3].real)
    assert bool(torch.all(evals[1:] > 1e3 * float(diag[3].real)))
    assert float(vecs[1:].abs().max()) == 0.0
    x0 = teigen.deflation_guess(evals, vecs, v0[None])
    np.testing.assert_allclose(to_numpy(x0[0]), to_numpy(v0 / diag), rtol=1e-6)


def test_masked_tridiagonal_keeps_the_genuine_ritz_values():
    """Breakdown rows beside a genuine 3x3 block of a complex64 run: the
    genuine Ritz values come out to float64 accuracy, not swamped by the
    sentinel as a 1e30 diagonal in float32 would swamp them (ROADMAP C2)."""
    alphas = torch.tensor([1.0, 2.0, 3.0, 0.0, 0.0], dtype=torch.float32)
    betas = torch.tensor([0.5, 0.25, 0.0, 0.0, 0.0], dtype=torch.float32)
    valid = torch.tensor([True, True, True, False, False])
    w, _ = teigen._tridiagonal_eigh(alphas, betas, valid)
    t3 = np.diag([1.0, 2.0, 3.0]) + np.diag([0.5, 0.25], 1) + np.diag([0.5, 0.25], -1)
    np.testing.assert_allclose(w[:3], np.linalg.eigvalsh(t3), rtol=1e-12)
    assert np.all(np.isfinite(w)) and np.all(w[3:] > 1e3 * 3.0)


# ------------------------------------------------------------ measurements


@pytest.mark.parametrize("lat,nc", [((4, 4, 4, 4), 3), ((2, 4, 2, 6), 2), ((3, 4, 2, 4), 3)],
                         ids=["wilson-4^4", "su2-2x4x2x6", "cgne-odd-3x4x2x4"])
def test_pion_correlator_matches_jax(lat, nc):
    """Even lattices take the packed Schur solve (wilson_hop), the odd extent
    full-volume CGNE on D^dag D (wilson_window)."""
    u, ut = _links(lat, nc, seed=sum(lat))
    c_j = jferm.pion_correlator(u, jw.WilsonDirac(kappa=0.12), eps=EPS)
    log = []
    c_t = tferm.pion_correlator(ut, tw.WilsonDirac(kappa=0.12), eps=EPS, log=log)
    assert c_t.shape == (lat[3],) and c_t.dtype == np.float64
    np.testing.assert_allclose(c_t, c_j, rtol=1e-8)
    assert len(log) == nc * 4 and all(r["rsq"] <= r["target"] for r in log)


def test_pion_correlator_batched_matches_sequential():
    lat = (2, 4, 2, 6)
    _, ut = _links(lat, 3, seed=17)
    d = tw.WilsonDirac(kappa=0.12)
    c_s = tferm.pion_correlator(ut, d, eps=1e-20, force_mode="sequential")
    c_b = tferm.pion_correlator(ut, d, eps=1e-20, force_mode="batched")
    np.testing.assert_allclose(c_b, c_s, rtol=1e-9)


@pytest.mark.parametrize("kind", ["wilson", "staggered"])
def test_chiral_condensate_matches_jax(kind):
    u, ut = _links(LAT, seed=21)
    if kind == "wilson":
        jd, td, nspin, nf = jw.WilsonDirac(kappa=0.12), tw.WilsonDirac(kappa=0.12), 4, 1.0
    else:
        jd, td = js.StaggeredDirac(mass=0.5, lattice=LAT), ts.StaggeredDirac(mass=0.5, lattice=LAT)
        nspin, nf = 1, 0.5
    key = jax.random.PRNGKey(22)
    pbp_j, vals_j = jferm.chiral_condensate(u, jd, key, nr=3, nf_factor=nf, eps=EPS)
    pbp_t, vals_t = tferm.chiral_condensate(ut, td, nr=3, nf_factor=nf, eps=EPS,
                                            draws=_z4_draws(key, LAT, 3, nspin, 3))
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-9)
    np.testing.assert_allclose(pbp_t, pbp_j, rtol=1e-9)


def test_staggered_deflated_guess_gives_the_same_condensate():
    _, ut = _links(LAT, seed=21)
    d = ts.StaggeredDirac(mass=0.5, lattice=LAT)
    draws = np.random.default_rng(3).integers(0, 4, (2,) + LAT + (3,))
    a = tferm.chiral_condensate(ut, d, nr=2, eps=EPS, draws=draws)
    b = tferm.chiral_condensate(ut, d, nr=2, eps=EPS, draws=draws, deflate_k=4)
    np.testing.assert_allclose(b[1], a[1], rtol=1e-9)


def test_dirac_low_spectrum_wilson_matches_jax():
    lat = (4, 4, 2, 2)
    u, ut = _links(lat, seed=2)
    # the JAX package's start vector: PRNGKey(20260822), which SPECTRUM_SEED copies
    v0 = jw.gaussian_spinor(jax.random.PRNGKey(tferm.SPECTRUM_SEED), lat, 3, nspin=4)
    vals_j = jferm.dirac_low_spectrum(u, jw.WilsonDirac(kappa=0.12), k=3, m=40)
    vals_t = tferm.dirac_low_spectrum(ut, tw.WilsonDirac(kappa=0.12), k=3, m=40,
                                      v0=to_torch(np.asarray(v0)))
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-8)
    assert list(vals_t) == sorted(vals_t) and np.all(vals_t > 0)


def test_dirac_low_spectrum_staggered_matches_dense():
    """Full-dimension Lanczos (m = dim) is exact: the k lowest Ritz values of
    the packed W equal the dense eigvalsh lowest k."""
    _, ut = _links(LAT, seed=13)
    d = ts.StaggeredDirac(mass=0.3, lattice=LAT)
    ueo = d.packed_links(tw.apply_boundary_phases(ut, d.bc))
    half = (LAT[0] // 2,) + LAT[1:] + (3,)
    dim = int(np.prod(half))
    eye = torch.eye(dim, dtype=torch.complex128).reshape((dim,) + half)
    wmat = torch.stack([d.apply_w_packed(ueo, e) for e in eye]).reshape(dim, dim).T
    ev = np.linalg.eigvalsh(0.5 * (to_numpy(wmat) + to_numpy(wmat).conj().T))
    vals = tferm.dirac_low_spectrum(ut, d, k=4, m=dim)
    np.testing.assert_allclose(vals, ev[:4], rtol=1e-6, atol=1e-9)
    assert np.all(vals >= d.mass ** 2 * 0.999)


# -------------------------------------------------------------- scheduler


def _jax_start_vector(monkeypatch):
    """Make the port's Lanczos start vector the JAX package's
    (PRNGKey(20260822)), which jax.random draws and torch cannot."""
    def start(lattice, nc, nspin=4, dtype=torch.complex128, device="cpu", generator=None):
        v = jw.gaussian_spinor(jax.random.PRNGKey(tferm.SPECTRUM_SEED), lattice, nc, nspin=nspin)
        return to_torch(np.asarray(v)).to(dtype)

    monkeypatch.setattr(tferm, "gaussian_spinor", start)


def _lines(path):
    return path.read_text().splitlines()


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


def test_measurement_set_writes_the_jax_line_formats(tmp_path, monkeypatch):
    """The three methods through both packages' MeasurementSet on the same
    links: same files, same line structure, same values (the port's Z4 noise
    replaced by the integers JAX draws from noise_seed + itrj)."""
    u, ut = _links(LAT, seed=31)
    methods = [
        {"methodname": "Pion_correlator", "eps": EPS,
         "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12}},
        {"methodname": "Chiral_condensate", "Nr": 2, "eps": EPS, "noise_seed": 7,
         "fermion_parameters": {"Dirac_operator": "Staggered", "mass": 0.5, "Nf": 2}},
        {"methodname": "Dirac_spectrum", "Neig": 3, "Nlanczos": 40,
         "fermion_parameters": {"Dirac_operator": "Staggered", "mass": 0.5}},
    ]
    itrj = 3
    draws = iter(_z4_draws(jax.random.PRNGKey(7 + itrj), LAT, 3, 1, 2))
    _jax_start_vector(monkeypatch)
    z4 = tferm.z4_spinor
    monkeypatch.setattr(tferm, "z4_spinor",
                        lambda *a, **kw: z4(*a, **dict(kw, generator=None, draws=next(draws))))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jms = JMeasurementSet.from_methods(methods, measuredir=str(jdir))
    jms.calc_measurement_values(itrj, u)
    jms.close()
    tms = tsched.MeasurementSet.from_methods(methods, measuredir=str(tdir))
    out = tms.calc_measurement_values(itrj, ut)
    tms.close()
    assert len(out) == 3
    for name in ("Pion_correlator", "Chiral_condensate", "Dirac_spectrum"):
        _same_lines(_lines(jdir / f"{name}.txt"), _lines(tdir / f"{name}.txt"), itrj, 1e-7)
    pion = tms.measurements[0]
    assert pion.value.shape == (LAT[3],) and len(pion.solves) == 12


@pytest.mark.parametrize("fparams", [
    {"Dirac_operator": "WilsonClover", "Clover_coefficient": 1.0},
    {"Dirac_operator": "Domainwall", "Domainwall_L5": 4},
])
def test_clover_and_domainwall_raise_naming_a12(fparams):
    """Both are ported: the clover and the domain-wall operator build from their
    fermion_parameters and a Pion_correlator measures (the parity against the
    JAX package is in test_torch_clover_measurements.py and
    test_torch_domainwall_measurements.py); an unknown operator raises."""
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac

    ms = tsched.MeasurementSet.from_methods(
        [{"methodname": "Pion_correlator", "fermion_parameters": fparams, "eps": 1e-14}])
    dirac = tsched.build_dirac_from_params(fparams, LAT)
    if fparams["Dirac_operator"] == "Domainwall":
        assert isinstance(dirac, DomainwallDirac)
    else:
        assert isinstance(dirac, tw.WilsonDirac) and dirac.csw == 1.0
    ms.calc_measurement_values(0, _links(LAT)[1])
    cpi = ms.measurements[0].value
    assert cpi.shape == (LAT[3],) and np.all(cpi > 0)
    with pytest.raises(ValueError):
        tsched.build_dirac_from_params({"Dirac_operator": "Overlap"}, LAT)


def test_staggered_odd_extent_refuses_the_card():
    """Staggered on an odd extent needs the full-volume operator, which runs
    on the CPU only: a tensor elsewhere raises instead of falling back."""
    lat = (3, 4, 2, 4)
    d = ts.StaggeredDirac(mass=0.5, lattice=lat)
    u = torch.empty((4,) + lat + (3, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(NotImplementedError, match="A11"):
        tferm._solve_dinv(d, u, torch.empty(lat + (3,), dtype=torch.complex64, device="meta"),
                          1e-10, 10)


def test_run_with_measurements_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: both packages' run_lqcd_params on the same hot
    start (Nsteps 0, so only the trajectory-0 measurements run) write the
    same Pion_correlator and Dirac_spectrum files."""
    methods = [
        {"methodname": "Pion_correlator", "eps": EPS,
         "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12}},
        {"methodname": "Dirac_spectrum", "Neig": 3, "Nlanczos": 40,
         "fermion_parameters": {"Dirac_operator": "Staggered", "mass": 0.5}},
    ]
    kw = dict(L=LAT, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=True, Nsteps=0,
              randomseed=31, verboselevel=1, measurement_methods=methods)
    _jax_start_vector(monkeypatch)
    jlqcd.run_lqcd_params(JParams(**kw, measuredir=str(tmp_path / "jax")))
    run_lqcd_params(TParams(**kw, measuredir=str(tmp_path / "torch")), dtype=torch.complex128,
                    device="cpu")
    for name in ("Pion_correlator", "Dirac_spectrum"):
        _same_lines(_lines(tmp_path / "jax" / f"{name}.txt"),
                    _lines(tmp_path / "torch" / f"{name}.txt"), 0, 1e-7)


# ------------------------------------------------------ wilson_window (B2)


def test_window_plain_matches_pallas_window_interpret():
    """The wilson_window wrapper's plain version against the Pallas kernel it
    replaces, dslash_planes_window, in interpret mode."""
    from latticeqcd_tpu.ops.dirac import wilson_pallas as wp

    u, ut = _links(LAT, seed=40)
    u = jw.apply_boundary_phases(u)
    rng = np.random.default_rng(41)
    psi = rng.standard_normal(LAT + (4, 3)) + 1j * rng.standard_normal(LAT + (4, 3))
    got = ww.wilson_window(tw.apply_boundary_phases(ut), to_torch(psi), 0.141139)
    u_k, _ = wp.links_to_planes(u)
    out_k = wp.dslash_planes_window(wp.psi_to_planes(jnp.asarray(psi)), u_k, LAT, 0.141139,
                                    interpret=True)
    ref = wp.planes_to_psi_shaped(out_k, LAT, dtype=jnp.complex128)
    assert float(np.abs(np.asarray(ref) - to_numpy(got)).max()) < 1e-12


@pytest.mark.parametrize("lat", [(4, 4, 2, 2), (3, 5, 2, 6), (2, 1, 3, 2)])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_window_apply_matches_jax_apply(lat, dtype):
    """WilsonDirac.apply at r = 1 (the wilson_window path) against the JAX
    package's, at T = 2, odd extents and extent 1."""
    u, ut = _links(lat, seed=sum(lat))
    rng = np.random.default_rng(5)
    psi = rng.standard_normal(lat + (4, 3)) + 1j * rng.standard_normal(lat + (4, 3))
    jd, td = jw.WilsonDirac(kappa=0.13), tw.WilsonDirac(kappa=0.13)
    up = jw.apply_boundary_phases(u).astype(dtype)
    upt = tw.apply_boundary_phases(ut).to(getattr(torch, dtype))
    psit = to_torch(psi).to(getattr(torch, dtype))
    a = jd.apply(up, jnp.asarray(psi, dtype=dtype))
    b = td.apply(upt, psit)
    assert b.dtype == getattr(torch, dtype)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    assert float(np.abs(np.asarray(a) - to_numpy(b)).max()) < bar
    np.testing.assert_array_equal(to_numpy(b), to_numpy(wk.dslash_reference(upt, psit, 0.13)))


def test_window_backward_gradcheck():
    lat = (2, 3, 2, 2)
    _, ut = _links(lat, seed=6)
    u = tw.apply_boundary_phases(ut)
    psi = torch.randn(lat + (4, 3), dtype=torch.complex128,
                      generator=torch.Generator().manual_seed(1))
    leaves = [u.clone().requires_grad_(True), psi.clone().requires_grad_(True)]
    assert torch.autograd.gradcheck(lambda a, b: ww.wilson_window(a, b, 0.12), leaves,
                                    fast_mode=True)


def test_window_never_falls_back_off_cpu():
    u = torch.empty((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    psi = torch.empty((2, 2, 2, 2, 4, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        ww.wilson_window(u, psi, 0.12)


# The kernel body of csrc/wilson_window.cu compiles with g++ against test_torch_hop_packed.py's
# mock headers: the block's CUDA threads as cooperative contexts on one OS thread, the bulk
# copies a memcpy, the mbarrier wait and __syncthreads a barrier over the block's threads.
# Blocks run one after another.
# run<R, BY, BZ, TSMAX, MINB, PREFETCH>: the launch function's t segments and block, x cut
# into chunks of the given length.
_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool GENERIC_R>
int run(int lx, int ly, int lz, int lt, int chunk, double kappa, double r) {
  using V = typename Vec<R>::type;
  const long vol = (long)lx * ly * lz * lt;
  std::vector<V> u(36 * vol), psi(12 * vol), out(12 * vol);
  if (fread(u.data(), sizeof(V), u.size(), stdin) != u.size()) return 1;
  if (fread(psi.data(), sizeof(V), psi.size(), stdin) != psi.size()) return 1;
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = (lt + nts - 1) / nts;
  const int blocks = ((lx + chunk - 1) / chunk) * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * nts;
  const int threads = 3 * BY * BZ * ts;
  for (int b = 0; b < blocks; ++b) {
    MockBarrier bar(threads);
    block_barrier = &bar;
    std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
    run_block(threads, [&](int tid) {
      threadIdx = dim3{(unsigned)tid, 1, 1};
      blockIdx = dim3{(unsigned)b, 1, 1};
      wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, false, GENERIC_R>(
          u.data(), psi.data(), out.data(), lx, ly, lz, lt, ts, chunk, (R)kappa, {}, (R)r);
    });
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
// at r != 1 the r mode
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH>
int run_at(const int (&l)[5], double kappa, double r) {
  return r == 1.0 ? run<R, BY, BZ, TSMAX, MINB, PREFETCH, false>(l[0], l[1], l[2], l[3], l[4],
                                                                 kappa, r)
                  : run<R, BY, BZ, TSMAX, MINB, PREFETCH, true>(l[0], l[1], l[2], l[3], l[4],
                                                                kappa, r);
}
int main(int argc, char** argv) {
  int l[5];
  for (int i = 0; i < 5; ++i) l[i] = atoi(argv[i + 1]);
  const double kappa = atof(argv[6]);
  const int c128 = atoi(argv[7]), tile = atoi(argv[8]);
  const double r = argc > 9 ? atof(argv[9]) : 1.0;
  if (tile == 0)  // the tiles of the C entry points
    return c128 ? run_at<double, WILSON_WINDOW_TILE_C128>(l, kappa, r)
                : run_at<float, WILSON_WINDOW_TILE_C64>(l, kappa, r);
  // 2 x 2 rows over t segments of at most 4 sites
  return c128 ? run_at<double, 2, 2, 4, 1, true>(l, kappa, r)
              : run_at<float, 2, 2, 4, 1, true>(l, kappa, r);
}
"""


@pytest.fixture(scope="module")
def window_body_exe(tmp_path_factory):
    """The kernel body of csrc/wilson_window.cu (the file up to its launch
    function), compiled for the CPU with g++ against the mock headers."""
    from test_torch_hop_packed import _MOCK_RUNTIME, _MOCK_TMA

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("window")
    (d / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    (d / "tma.h").write_text(_MOCK_TMA)
    src = open(os.path.join(CSRC, "wilson_window.cu")).read()
    (d / "body.inc").write_text(src[:src.index("// Launch one wave")] + "}  // namespace\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I", str(d),
                    "-I", CSRC, str(d / "harness.cpp"), "-o", str(exe)], check=True)
    return str(exe)


def _window_body(exe, lat, chunk, dtype, tile, r=1.0):
    """The kernel body's D at Wilson r on a seeded field against the plain D."""
    tdt = getattr(torch, dtype)
    u = tw.apply_boundary_phases(_links(lat, seed=sum(lat))[1]).to(tdt)
    psi = torch.randn(lat + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(3))
    out = subprocess.run(
        [exe, *map(str, lat), str(chunk), "0.13", str(int(dtype == "complex128")), str(tile),
         repr(r)],
        input=to_numpy(u).tobytes() + to_numpy(psi).tobytes(), capture_output=True, check=True)
    got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(psi.shape)
    ref = to_numpy(wk.dslash_reference(u, psi, 0.13, r))
    assert float(np.abs(got - ref).max()) < (1e-12 if dtype == "complex128" else 1e-5)


# T = 2; odd extents; extent 1; and an odd T = 19 that the complex128 entry tile (t segments of
# at most 16) and the ragged tile (at most 4) cut into uneven segments, with one x chunk
WINDOW_BODY_SHAPES = pytest.mark.parametrize(
    "lat,chunk", [((4, 8, 2, 2), 1), ((3, 5, 2, 6), 2), ((2, 1, 9, 3), 2), ((3, 2, 3, 19), 3)],
    ids=["T2", "odd", "extent1", "tcut"])


@WINDOW_BODY_SHAPES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_kernel_body_on_the_cpu(window_body_exe, lat, chunk, dtype):
    """The CUDA kernel's own body, run on the CPU thread by thread, against
    the plain D at the tiles of the C entry points: tiles that exceed, do
    not divide or wrap onto an extent, T = 2, extent 1, t cut into segments
    at complex128, and x cut into chunks."""
    _window_body(window_body_exe, lat, chunk, dtype, tile=0)


@WINDOW_BODY_SHAPES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_kernel_body_at_a_ragged_tile(window_body_exe, lat, chunk, dtype):
    """The same at 2 x 2 rows over t segments of at most 4 sites, which cut
    every T above 4 into segments, the odd T = 19 unevenly."""
    _window_body(window_body_exe, lat, chunk, dtype, tile=1)


@WINDOW_BODY_SHAPES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("tile", [0, 1], ids=["entry", "ragged"])
def test_window_kernel_body_r_mode(window_body_exe, lat, chunk, dtype, tile):
    """The r mode at r = 0.5 (the four-spin -x carry, (r -+ g_mu) on U psi) at both
    tiles on the same shapes, against the plain D's projector form at r = 0.5."""
    _window_body(window_body_exe, lat, chunk, dtype, tile, r=0.5)


@pytest.mark.gpu
def test_window_kernel_matches_plain_on_gpu():
    """On the card: wilson_window against its plain version, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_measurements.py)")
    dev = torch.device("cuda")
    for lat in ((4, 8, 2, 2), (3, 5, 2, 6)):
        for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            u = tw.apply_boundary_phases(
                convert.to_torch(np.asarray(jfields.hot_start(lat, 3, seed=9)), dtype=dtype))
            psi = torch.randn(lat + (4, 3), dtype=dtype, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(2))
            before = ww.launches
            out = ww.wilson_window(u, psi, 0.13)
            assert ww.launches == before + 1
            assert float((out - wk.dslash_reference(u, psi, 0.13)).abs().max()) < bar
            cot = torch.randn_like(psi)
            leaves = [t.clone().requires_grad_(True) for t in (u, psi)]
            ga_ = torch.autograd.grad(ww.wilson_window(*leaves, 0.13), leaves, cot)
            gb_ = torch.autograd.grad(wk.dslash_reference(*leaves, 0.13), leaves, cot)
            for a, b in zip(ga_, gb_):
                assert float((a - b).abs().max()) < bar
    # the bulk copies need a 16-byte aligned spinor: a contiguous view 8 bytes in is refused
    flat = torch.zeros(12 * 2 ** 4 + 1, dtype=torch.complex64, device=dev)
    u = torch.zeros((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        ww.wilson_window(u, flat[1:].view(2, 2, 2, 2, 4, 3), 0.13)


@pytest.mark.gpu
def test_measurements_kernel_path_on_gpu():
    """On the card: the Wilson pion correlator through the kernels against the
    same measurement on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_measurements.py)")
    for lat in ((4, 4, 4, 4), (3, 4, 2, 4)):
        _, ut = _links(lat, seed=sum(lat))
        d = tw.WilsonDirac(kappa=0.12)
        c_cpu = tferm.pion_correlator(ut, d, eps=EPS)
        c_gpu = tferm.pion_correlator(ut.cuda(), d, eps=EPS)
        np.testing.assert_allclose(c_gpu, c_cpu, rtol=1e-9)
