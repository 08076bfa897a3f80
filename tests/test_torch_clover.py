"""Port parity: the clover-improved Wilson operator (latticeqcd_torch/ops/dirac/wilson.py,
csw != 0) and its two-flavour action, held to the JAX package on the same inputs.

The clover term's site matrices, D and D^dag with the clover term, the packed
Schur blocks (A_ee and A_oo^-1), the clover Schur complement Dhat and its dagger,
and the clover force with and without a stout layer. Inputs are made from a seed
with numpy; on the CPU the Wilson kernels take their plain versions. The ``gpu``
test holds the card against the CPU (run: python -m pytest -m gpu
tests/test_torch_clover.py -n 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import apply_boundary_phases as japply_bc  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import sun  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

# the two-flavour O(a)-improved point of the CLS Nf = 2 ensembles (beta 5.3)
KAPPA, CSW = 0.13625, 1.90952
LAT = (4, 4, 4, 4)
EXT2 = (4, 2, 4, 2)  # a clover leaf wraps onto itself along y and t
ODD = (3, 4, 2, 2)  # no even-odd packing
BARS = {"c128": 1e-12, "c64": 1e-5}
DTYPES = {"c128": (jnp.complex128, torch.complex128), "c64": (jnp.complex64, torch.complex64)}


def _links(lat, dtype="c128", seed=81):
    jdt, tdt = DTYPES[dtype]
    u = japply_bc(jfields.hot_start(lat, 3, seed=seed)).astype(jdt)
    return u, to_torch(np.asarray(u)).to(tdt)


def _spinor(shape, seed, dtype="c128"):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(psi, dtype=jdt), to_torch(psi).to(tdt)


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - to_numpy(b))))


def _rel(a, b) -> float:
    return _diff(a, b) / float(np.max(np.abs(np.asarray(a))))


# ------------------------------------------------------------------ operator


@pytest.mark.parametrize("dtype", ["c128", "c64"])
@pytest.mark.parametrize("lat", [LAT, EXT2, ODD], ids=["4^4", "4x2x4x2", "3x4x2x2"])
def test_clover_block_and_operator_match_jax(lat, dtype):
    """The site matrix A = 1 + T (each plane built once and doubled, against the
    JAX package's sum over the 12 ordered pairs), D and D^dag with the clover
    term, in the links' dtype."""
    u, ut = _links(lat, dtype)
    jd, td = JW(kappa=KAPPA, csw=CSW), TW(kappa=KAPPA, csw=CSW)
    a_t = td.clover_site_matrix(ut)
    assert a_t.dtype == ut.dtype and a_t.shape == lat + (4, 3, 4, 3)
    assert _diff(jd.clover_site_matrix(u), a_t) < BARS[dtype]
    jpsi, tpsi = _spinor(lat + (4, 3), 1, dtype)
    d_t = td.apply(ut, tpsi)
    assert d_t.dtype == ut.dtype
    assert _rel(jd.apply(u, jpsi), d_t) < BARS[dtype]
    assert _rel(jd.apply_dagger(u, jpsi), td.apply_dagger(ut, tpsi)) < BARS[dtype]
    # the term built once and passed in is the same D
    assert float((td.apply(ut, tpsi, td.clover_term(ut)) - d_t).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["c128", "c64"])
@pytest.mark.parametrize("lat", [LAT, EXT2], ids=["4^4", "4x2x4x2"])
def test_clover_schur_blocks_match_jax(lat, dtype):
    """The packed blocks (a_e, A_oo^-1), the site product, and the clover Schur
    complement Dhat = A_ee - kappa^2 H_eo A_oo^-1 H_oe with and without dag."""
    u, ut = _links(lat, dtype, seed=82)
    jd, td = JW(kappa=KAPPA, csw=CSW), TW(kappa=KAPPA, csw=CSW)
    (ja, jinv), (ta, tinv) = jd.clover_packed_blocks(u), td.clover_packed_blocks(ut)
    assert ta.dtype == tinv.dtype == ut.dtype
    assert _diff(ja, ta) < BARS[dtype]
    assert _rel(jinv, tinv) < BARS[dtype]
    half = (lat[0] // 2,) + lat[1:] + (4, 3)
    jx, tx = _spinor(half, 2, dtype)
    assert _rel(jd.site_apply(jinv, jx), td.site_apply(tinv, tx)) < BARS[dtype]
    jeo, teo = jd.packed_links(u), td.packed_links(ut)
    assert _rel(jd.apply_dhat_clover(jeo, ja, jinv, jx),
                td.apply_dhat_clover(teo, ta, tinv, tx)) < BARS[dtype]
    assert _rel(jd.apply_dhat_clover_dagger(jeo, ja, jinv, jx),
                td.apply_dhat_clover_dagger(teo, ta, tinv, tx)) < BARS[dtype]


def test_inverse_block_inverts_the_odd_block():
    _, ut = _links(LAT)
    td = TW(kappa=KAPPA, csw=CSW)
    a = td.clover_site_matrix(ut)
    _, ainv_o = td.clover_packed_blocks(ut)
    from latticeqcd_torch.ops.dirac import eo_pack

    a_o = eo_pack.pack(a, LAT, 1)
    x = _spinor((2,) + LAT[1:] + (4, 3), 3)[1]
    assert float((td.site_apply(a_o, td.site_apply(ainv_o, x)) - x).abs().max()) < 1e-13
    # A is hermitian: its 12x12 site matrices have real eigenvalues near 1 on hot links
    w = torch.linalg.eigvalsh(a.reshape(-1, 12, 12))
    assert 0.2 < float(w.min()) < 1.0 < float(w.max()) < 2.0


def test_clover_operators_are_gamma5_hermitian():
    """<phi, D psi> = <D^dag phi, psi> for D and for the clover Dhat, and the
    clover term contributes."""
    _, ut = _links(LAT)
    td = TW(kappa=KAPPA, csw=CSW)
    (_, psi), (_, phi) = _spinor(LAT + (4, 3), 4), _spinor(LAT + (4, 3), 5)
    lhs = torch.sum(phi.conj() * td.apply(ut, psi))
    assert abs(complex(lhs - torch.sum(td.apply_dagger(ut, phi).conj() * psi))) < 1e-12 * abs(lhs)
    teo = td.packed_links(ut)
    a_e, ainv_o = td.clover_packed_blocks(ut)
    psi, phi = psi[:2], phi[:2]
    lhs = torch.sum(phi.conj() * td.apply_dhat_clover(teo, a_e, ainv_o, psi))
    rhs = torch.sum(td.apply_dhat_clover_dagger(teo, a_e, ainv_o, phi).conj() * psi)
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(lhs)
    plain = TW(kappa=KAPPA).apply(ut, _spinor(LAT + (4, 3), 4)[1])
    assert float((td.apply(ut, _spinor(LAT + (4, 3), 4)[1]) - plain).abs().max()) > 1e-3


def test_clover_apply_off_cpu_goes_to_the_kernel():
    """A field off the CPU takes the wilson_window kernel (meta tensors: the
    dispatch, no data), never the plain version, with the clover term as with
    csw = 0, at r = 1 and at r != 1 (the kernel's r mode)."""
    meta_u = torch.empty((4,) + LAT + (3, 3), dtype=torch.complex64, device="meta")
    meta_psi = torch.empty(LAT + (4, 3), dtype=torch.complex64, device="meta")
    before = (wk.launches, ww.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TW(kappa=KAPPA, csw=CSW).apply(meta_u, meta_psi)
    with pytest.raises(ValueError, match="CUDA"):
        TW(kappa=KAPPA, csw=CSW, r=0.7).apply(meta_u, meta_psi)
    assert (wk.launches, ww.launches) == before


# -------------------------------------------------------------------- force


def test_clover_operator_matches_jax_at_r_half():
    """The clover operator at r = 0.5 in both packages, complex128: D and D^dag with
    the clover term (the full D's plain version at r = 0.5) and the clover Schur
    complement with and without dag (the packed hop's)."""
    u, ut = _links(LAT, seed=83)
    jd, td = JW(kappa=KAPPA, csw=CSW, r=0.5), TW(kappa=KAPPA, csw=CSW, r=0.5)
    jpsi, tpsi = _spinor(LAT + (4, 3), 4)
    assert _rel(jd.apply(u, jpsi), td.apply(ut, tpsi)) < BARS["c128"]
    assert _rel(jd.apply_dagger(u, jpsi), td.apply_dagger(ut, tpsi)) < BARS["c128"]
    (ja, jinv), (ta, tinv) = jd.clover_packed_blocks(u), td.clover_packed_blocks(ut)
    jeo, teo = jd.packed_links(u), td.packed_links(ut)
    jx, tx = _spinor((LAT[0] // 2,) + LAT[1:] + (4, 3), 5)
    assert _rel(jd.apply_dhat_clover(jeo, ja, jinv, jx),
                td.apply_dhat_clover(teo, ta, tinv, tx)) < BARS["c128"]
    assert _rel(jd.apply_dhat_clover_dagger(jeo, ja, jinv, jx),
                td.apply_dhat_clover_dagger(teo, ta, tinv, tx)) < BARS["c128"]


def test_clover_action_runs_on_the_full_volume():
    td = TW(kappa=KAPPA, csw=CSW)
    _, ut = _links(LAT)
    fa = TFA(td)
    assert fa.noise_shape(ut) == LAT + (4, 3)
    assert TFA(TW(kappa=KAPPA)).noise_shape(ut) == (2,) + LAT[1:] + (4, 3)


@pytest.mark.parametrize("layers", [0, 1], ids=["bare", "stout"])
def test_clover_force_matches_jax(layers):
    """The force through WilsonDslash's autograd and the clover term's
    construction (the conjugation of PyTorch's complex gradient through
    traceless_antihermitian), to 1e-12, with and without one stout layer;
    the action and the warm start beside it."""
    u = jfields.hot_start(LAT, 3, seed=83)
    ut = to_torch(np.asarray(u))
    fa_j = JFA(JW(kappa=KAPPA, csw=CSW), eps_cg=1e-26)
    fa_t = TFA(TW(kappa=KAPPA, csw=CSW), eps_cg=1e-26)
    jphi, tphi = _spinor(LAT + (4, 3), 6)
    smear_j = jstout_stack([0.1]).smear if layers else None
    smear_t = tstout_stack([0.1]).smear if layers else None
    f_j = np.asarray(fa_j.force(u, jphi, smear_fn=smear_j))
    log = []
    f_t, x_t = fa_t.force_with_guess(ut, tphi, None, log=log, smear_fn=smear_t)
    assert _diff(f_j, f_t) < 1e-12
    assert len(log) == 1 and log[0]["rsq"] <= log[0]["target"]
    if not layers:
        s_j, s_t = float(fa_j.action(u, jphi)), float(fa_t.action(ut, tphi))
        assert abs(s_j - s_t) < 1e-12 * abs(s_j)
    f_w, _ = fa_t.force_with_guess(ut, tphi, x_t, log=log, smear_fn=smear_t)
    assert float((f_w - f_t).abs().max()) < 1e-10
    assert log[1]["iterations"] < log[0]["iterations"]


def test_clover_force_is_the_derivative_of_the_action():
    """dS/dt along U(t) = exp(i t H) U against -2 Re tr(H F)."""
    _, ut = _links(LAT, seed=84)
    fa = TFA(TW(kappa=KAPPA, csw=CSW), eps_cg=1e-26)
    _, phi = fa.sample_pseudofermion(ut, generator=torch.Generator().manual_seed(1))
    h = sun.random_hermitian_momentum(ut.shape[:-2], 3, dtype=ut.dtype, device="cpu",
                                      generator=torch.Generator().manual_seed(2))

    def s_along(t):
        e = sun.expi_hermitian(h, t)
        return float(fa.action(torch.stack([sun.mul(e[mu], ut[mu]) for mu in range(4)]), phi))

    dt = 1e-4
    ds_num = (s_along(dt) - s_along(-dt)) / (2 * dt)
    ds_force = -2.0 * float(torch.sum(torch.real(sun.trace(sun.mul(h, fa.force(ut, phi))))))
    assert abs(ds_num - ds_force) < 1e-6 * max(1.0, abs(ds_num)), (ds_num, ds_force)


def test_clover_complex64_keeps_its_dtype():
    """complex64 links: the clover term, the pseudofermion and the force stay
    complex64 (the JAX package casts sigma to the field's dtype)."""
    _, ut = _links(LAT, "c64", seed=85)
    fa = TFA(TW(kappa=KAPPA, csw=CSW), eps_cg=1e-10, max_cg=500)
    s, phi = fa.sample_pseudofermion(ut, generator=torch.Generator().manual_seed(3))
    assert phi.dtype == torch.complex64 and np.isfinite(float(s))
    f = fa.force(ut, phi)
    assert f.dtype == torch.complex64 and bool(torch.isfinite(f).all())


# ---------------------------------------------------------------------- card


@pytest.mark.gpu
def test_clover_kernel_path_on_gpu():
    """On the card: the clover term, D with the clover term (one wilson_window
    launch), the clover Dhat (two wilson_hop_packed launches) and the force,
    against the same on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_clover.py)")
    dev = torch.device("cuda")
    td = TW(kappa=KAPPA, csw=CSW)
    _, ut = _links(LAT)
    ug = ut.to(dev)
    psi = _spinor(LAT + (4, 3), 7)[1]
    assert float((td.clover_term(ug).cpu() - td.clover_term(ut)).abs().max()) < 1e-12
    before = ww.launches
    got = td.apply(ug, psi.to(dev))
    assert ww.launches == before + 1
    assert float((got.cpu() - td.apply(ut, psi)).abs().max()) < 1e-12
    a_e, ainv_o = td.clover_packed_blocks(ug)
    geo = td.packed_links(ug)
    before = wk.launches
    got = td.apply_dhat_clover(geo, a_e, ainv_o, psi[:2].to(dev))
    assert wk.launches == before + 2
    ref = td.apply_dhat_clover(td.packed_links(ut), *td.clover_packed_blocks(ut), psi[:2])
    assert float((got.cpu() - ref).abs().max()) < 1e-12
    fa = TFA(td, eps_cg=1e-26)
    f_c = fa.force(ut, psi)
    f_g = fa.force(ug, psi.to(dev))
    assert float((f_g.cpu() - f_c).abs().max()) < 1e-10 * float(f_c.abs().max())
    # r = 0.5: the same through the kernels' r mode
    tr = TW(kappa=KAPPA, csw=CSW, r=0.5)
    before = (ww.r_launches, wk.r_launches)
    got = tr.apply(ug, psi.to(dev))
    assert float((got.cpu() - tr.apply(ut, psi)).abs().max()) < 1e-12
    got = tr.apply_dhat_clover(geo, *tr.clover_packed_blocks(ug), psi[:2].to(dev))
    ref = tr.apply_dhat_clover(td.packed_links(ut), *tr.clover_packed_blocks(ut), psi[:2])
    assert float((got.cpu() - ref).abs().max()) < 1e-12
    assert (ww.r_launches, wk.r_launches) == (before[0] + 1, before[1] + 2)
