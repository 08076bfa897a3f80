"""Port parity: the domain-wall operator (latticeqcd_torch/ops/dirac/domainwall.py)
and its two-flavour action with the Pauli-Villars partner, held to the JAX
package on the same inputs.

Inputs are made from a seed with numpy, or drawn by JAX and injected (the
pseudofermion normals, the HMC draws). On the CPU every 4D piece runs the
Wilson kernels' plain versions; the ``gpu`` test holds the card against the
CPU (run: python -m pytest -m gpu tests/test_torch_domainwall.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac as JD  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import apply_boundary_phases as japply_bc  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import DomainwallFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac as TD  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases as tapply_bc  # noqa: E402
from latticeqcd_torch.ops.fermion_action import DomainwallFermiAction as TFA  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC, Draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 2, 2)
ODD = (3, 4, 2, 2)
L5 = 4
BAR = 1e-12
MASSES = [(0.3, -1.0), (0.3, -1.8), (0.5, -1.0), (0.5, -1.8)]


def _links(lat, seed=41):
    u = jfields.hot_start(lat, 3, seed=seed, dtype=jnp.complex128)
    return u, to_torch(np.asarray(u))


def _spinor(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - to_numpy(b))))


# ------------------------------------------------------------------ operator


@pytest.mark.parametrize("mass,m5", MASSES)
def test_operators_match_jax(mass, m5):
    """D, D^dag, D^dag D, A, A^-1, the packed hop and the Schur operator,
    each with and without dag, and the 5D packing, on 4x4x2x2 at L5 = 4."""
    u, ut = _links(LAT)
    up, upt = japply_bc(u), tapply_bc(ut)
    jd, td = JD(mass, m5, L5), TD(mass, m5, L5)
    psi = _spinor((L5,) + LAT + (4, 3), 1)
    jpsi, tpsi = jnp.asarray(psi), to_torch(psi)
    assert _diff(jd.apply(up, jpsi), td.apply(upt, tpsi)) < BAR
    assert _diff(jd.apply_dagger(up, jpsi), td.apply_dagger(upt, tpsi)) < BAR
    assert _diff(jd.apply_ddag_d(up, jpsi), td.apply_ddag_d(upt, tpsi)) < BAR
    jeo, teo = jd.packed_links(up), td.packed_links(upt)
    for parity in (0, 1):
        pe = np.asarray(jd.pack5(jpsi, LAT, parity))
        assert _diff(pe, td.pack5(tpsi, LAT, parity)) == 0.0
        assert _diff(jd.unpack5(jnp.asarray(pe), LAT, parity),
                     td.unpack5(to_torch(pe), LAT, parity)) == 0.0
    phi = _spinor((L5, LAT[0] // 2) + LAT[1:] + (4, 3), 2)
    jphi, tphi = jnp.asarray(phi), to_torch(phi)
    for dag in (False, True):
        assert _diff(jd.apply_a(jphi, dag=dag), td.apply_a(tphi, dag=dag)) < BAR
        assert _diff(jd.apply_a_inv(jphi, dag=dag), td.apply_a_inv(tphi, dag=dag)) < BAR
        for parity, (ja, jb), (ta, tb) in ((0, jeo, teo), (1, jeo[::-1], teo[::-1])):
            assert _diff(jd._packed_hop(ja, jb, jphi, parity, dag=dag),
                         td._packed_hop(ta, tb, tphi, parity, dag=dag)) < BAR
        assert _diff(jd.apply_schur(jeo, jphi, dag=dag), td.apply_schur(teo, tphi, dag=dag)) < BAR
    assert _diff(jd.apply_schur_ddag_d(jeo, jphi), td.apply_schur_ddag_d(teo, tphi)) < BAR


@pytest.mark.parametrize("mass,m5", MASSES[:2])
def test_odd_extent_full_volume_matches_jax(mass, m5):
    """3x4x2x2: the full-volume 5D D and D^dag (the wilson_window slices)."""
    u, ut = _links(ODD, seed=43)
    up, upt = japply_bc(u), tapply_bc(ut)
    jd, td = JD(mass, m5, L5), TD(mass, m5, L5)
    psi = _spinor((L5,) + ODD + (4, 3), 3)
    assert _diff(jd.apply(up, jnp.asarray(psi)), td.apply(upt, to_torch(psi))) < BAR
    assert _diff(jd.apply_dagger(up, jnp.asarray(psi)), td.apply_dagger(upt, to_torch(psi))) < BAR


@pytest.mark.parametrize("dag", [False, True])
def test_a_inverse_inverts_a(dag):
    td = TD(0.3, -1.8, L5)
    phi = to_torch(_spinor((L5, 2, 4, 2, 2, 4, 3), 4))
    assert float((td.apply_a_inv(td.apply_a(phi, dag=dag), dag=dag) - phi).abs().max()) < BAR
    assert float((td.apply_a(td.apply_a_inv(phi, dag=dag), dag=dag) - phi).abs().max()) < BAR


def test_adjoints_are_adjoint():
    """<phi, D psi> = <D^dag phi, psi> for the full and the Schur operator."""
    _, ut = _links(LAT)
    upt = tapply_bc(ut)
    td = TD(0.3, -1.8, L5)
    psi, phi = (to_torch(_spinor((L5,) + LAT + (4, 3), s)) for s in (5, 6))
    lhs = torch.sum(phi.conj() * td.apply(upt, psi))
    assert abs(complex(lhs - torch.sum(td.apply_dagger(upt, phi).conj() * psi))) < 1e-12 * abs(lhs)
    teo = td.packed_links(upt)
    psi, phi = (to_torch(_spinor((L5, 2) + LAT[1:] + (4, 3), s)) for s in (7, 8))
    lhs = torch.sum(phi.conj() * td.apply_schur(teo, psi))
    rhs = torch.sum(td.apply_schur_dagger(teo, phi).conj() * psi)
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(lhs)


def test_generic_r_matches_jax_on_cpu_and_raises_elsewhere():
    """r != 1: the projector form on the CPU, the kernels' r mode on any other
    device; at any r a field off the CPU goes to the kernel, never to the plain
    version (meta tensors: no data, only the dispatch, so the wrappers raise)."""
    u, ut = _links(LAT)
    up, upt = japply_bc(u), tapply_bc(ut)
    psi = _spinor((L5,) + LAT + (4, 3), 9)
    jd, td = JD(0.3, -1.8, L5, r=0.7), TD(0.3, -1.8, L5, r=0.7)
    assert _diff(jd.apply(up, jnp.asarray(psi)), td.apply(upt, to_torch(psi))) < BAR
    jeo, teo = jd.packed_links(up), td.packed_links(upt)
    phi = _spinor((L5, 2) + LAT[1:] + (4, 3), 10)
    for dag in (False, True):
        assert _diff(jd.apply_schur(jeo, jnp.asarray(phi), dag=dag),
                     td.apply_schur(teo, to_torch(phi), dag=dag)) < BAR
    meta_u = torch.empty(ut.shape, dtype=ut.dtype, device="meta")
    meta_psi = torch.empty((L5,) + LAT + (4, 3), dtype=ut.dtype, device="meta")
    before = (wk.launches, ww.launches)
    with pytest.raises(ValueError, match="CUDA"):
        td.apply(meta_u, meta_psi)
    with pytest.raises(ValueError, match="CUDA"):
        td.apply_schur(td.packed_links(meta_u), meta_psi[:, :2].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        TD(0.3, -1.8, L5).apply(meta_u, meta_psi)
    with pytest.raises(ValueError, match="CUDA"):
        TD(0.3, -1.8, L5).apply_schur(td.packed_links(meta_u), meta_psi[:, :2].contiguous())
    assert (wk.launches, ww.launches) == before


def test_schur_operator_matches_jax_at_r_half():
    """DomainwallDirac(r = 0.5) in both packages: the Schur operator with and without
    dag, its normal operator and the packed hop (the Wilson kernels' plain versions
    at r = 0.5), complex128."""
    u, ut = _links(LAT, seed=43)
    up, upt = japply_bc(u), tapply_bc(ut)
    jd, td = JD(0.3, -1.8, L5, r=0.5), TD(0.3, -1.8, L5, r=0.5)
    jeo, teo = jd.packed_links(up), td.packed_links(upt)
    phi = _spinor((L5, LAT[0] // 2) + LAT[1:] + (4, 3), 13)
    jphi, tphi = jnp.asarray(phi), to_torch(phi)
    for dag in (False, True):
        assert _diff(jd.apply_schur(jeo, jphi, dag=dag), td.apply_schur(teo, tphi, dag=dag)) < BAR
        assert _diff(jd._packed_hop(*jeo, jphi, 0, dag=dag),
                     td._packed_hop(*teo, tphi, 0, dag=dag)) < BAR
    assert _diff(jd.apply_schur_ddag_d(jeo, jphi), td.apply_schur_ddag_d(teo, tphi)) < BAR


# -------------------------------------------------------------------- action


def _jax_xi_normals(key, shape):
    """The normals of JAX's sample_pseudofermion for this key (k1, k2 split)."""
    k1, k2 = jax.random.split(key)
    return (to_torch(jax.random.normal(k1, shape, dtype=jnp.float64)),
            to_torch(jax.random.normal(k2, shape, dtype=jnp.float64)))


@pytest.mark.parametrize("lat", [LAT, ODD], ids=["schur", "full"])
def test_sample_and_action_match_jax(lat):
    u, ut = _links(lat, seed=44)
    fa_j = JFA(JD(0.3, -1.8, L5), eps_cg=1e-24)
    fa_t = TFA(TD(0.3, -1.8, L5), eps_cg=1e-24)
    key = jax.random.PRNGKey(45)
    shape = fa_t.noise_shape(ut)
    assert shape == (L5, lat[0] // 2 if lat[0] % 2 == 0 else lat[0]) + lat[1:] + (4, 3)
    s_j, phi_j = fa_j.sample_pseudofermion(u, key)
    s_t, phi_t = fa_t.sample_pseudofermion(ut, normals=_jax_xi_normals(key, shape))
    assert abs(float(s_j) - float(s_t)) < 1e-10 * float(s_j)
    assert _diff(phi_j, phi_t) < 1e-10
    a_j, a_t = float(fa_j.action(u, phi_j)), float(fa_t.action(ut, phi_t))
    assert abs(a_j - a_t) < 1e-10 * abs(a_j)
    assert abs(a_t - float(s_t)) < 1e-8 * float(s_t)  # S(phi) = |xi|^2


@pytest.mark.parametrize("lat,layers", [(LAT, 0), (LAT, 1), (ODD, 0), (ODD, 1)],
                         ids=["schur", "schur-stout", "full", "full-stout"])
def test_force_with_guess_matches_jax(lat, layers):
    """The force (relative 1e-10) with and without one stout layer, and the
    warm start threaded back in."""
    u, ut = _links(lat, seed=46)
    fa_j = JFA(JD(0.3, -1.8, L5), eps_cg=1e-24)
    fa_t = TFA(TD(0.3, -1.8, L5), eps_cg=1e-24)
    phi = _spinor(fa_t.noise_shape(ut), 47)
    smear_j = jstout_stack([0.1]).smear if layers else None
    smear_t = tstout_stack([0.1]).smear if layers else None
    f_j, x_j = fa_j.force_with_guess(u, jnp.asarray(phi), None, smear_fn=smear_j)
    log = []
    f_t, x_t = fa_t.force_with_guess(ut, to_torch(phi), None, log=log, smear_fn=smear_t)
    scale = float(np.max(np.abs(np.asarray(f_j))))
    assert _diff(f_j, f_t) < 1e-10 * scale
    assert _diff(x_j, x_t) < 1e-9
    assert len(log) == 1 and log[0]["rsq"] <= log[0]["target"]
    f2, _ = fa_t.force_with_guess(ut, to_torch(phi), x_t, log=log, smear_fn=smear_t)
    assert float((f2 - f_t).abs().max()) < 1e-9 * scale
    assert log[1]["iterations"] < log[0]["iterations"]


def test_force_is_the_derivative_of_the_action():
    """dS/dt along U(t) = exp(i t H) U against -2 Re tr(H F)."""
    from latticeqcd_torch.ops import sun

    _, ut = _links(LAT, seed=48)
    fa = TFA(TD(0.3, -1.8, L5), eps_cg=1e-26)
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


def _jax_draws(key, u, pf_shape) -> Draws:
    """The draws of the JAX package's fused trajectory for this key."""
    _, k_mom, k_ferm, k_acc = jax.random.split(key, 4)

    def normals(k, shape):
        k1, k2 = jax.random.split(k)
        return (to_torch(jax.random.normal(k1, shape, dtype=jnp.float64)),
                to_torch(jax.random.normal(k2, shape, dtype=jnp.float64)))

    return Draws(normals(k_mom, u.shape), normals(k_ferm, pf_shape),
                 float(jax.random.uniform(k_acc, dtype=jnp.float64)))


def test_trajectory_matches_jax():
    """One 4x4x2x2 two-flavour domain-wall trajectory from the JAX package's own
    draws: dH 1e-9, links 1e-10."""
    u, ut = _links(LAT, seed=49)
    kw = dict(dtau=0.1, md_steps=3)
    fa_j = JFA(JD(0.3, -1.8, L5), eps_cg=1e-22)
    fa_t = TFA(TD(0.3, -1.8, L5), eps_cg=1e-22)
    key = jax.random.PRNGKey(50)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.7), fermi_action=fa_j, staged=False,
                        **kw).step(u, key)
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 5.7), fermi_action=fa_t, **kw).step(
        ut, draws=_jax_draws(key, u, fa_t.noise_shape(ut)))
    assert abs(float(st_j["dH"]) - st_t["dH"]) < 1e-9
    assert bool(st_j["accepted"]) == st_t["accepted"]
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-10
    for k in ("sf_old", "sf_new", "sg_new", "sp_new"):
        assert abs(float(st_j[k]) - st_t[k]) < 1e-9 * max(1.0, abs(float(st_j[k]))), k
    # 3 warm-started force solves and the final action solve, all converged
    assert len(st_t["cg"]) == 4 and all(c["rsq"] <= c["target"] for c in st_t["cg"])


# ---------------------------------------------------------------------- card


@pytest.mark.gpu
def test_domainwall_kernel_path_on_gpu():
    """On the card: the operators and the force through wilson_hop_packed and
    wilson_window against the same on the CPU, with the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_domainwall.py)")
    dev = torch.device("cuda")
    td = TD(0.3, -1.8, L5)
    for lat in (LAT, ODD):
        _, ut = _links(lat)
        upt = tapply_bc(ut)
        psi = to_torch(_spinor((L5,) + lat + (4, 3), 11))
        before = ww.launches
        got = td.apply_ddag_d(upt.to(dev), psi.to(dev))
        assert ww.launches == before + 2 * L5
        assert float((got.cpu() - td.apply_ddag_d(upt, psi)).abs().max()) < BAR
    _, ut = _links(LAT)
    teo = td.packed_links(tapply_bc(ut))
    geo = tuple(t.to(dev) for t in teo)
    phi = to_torch(_spinor((L5, 2) + LAT[1:] + (4, 3), 12))
    for dag in (False, True):
        before = wk.launches
        got = td.apply_schur(geo, phi.to(dev), dag=dag)
        assert wk.launches == before + 2 * L5
        assert float((got.cpu() - td.apply_schur(teo, phi, dag=dag)).abs().max()) < BAR
    # r != 1 runs the kernels' r mode, against the CPU's projector form
    tr = TD(0.3, -1.8, L5, r=0.7)
    before = (ww.r_launches, wk.r_launches)
    got = tr.apply_ddag_d(tapply_bc(ut).to(dev), psi.to(dev))
    assert float((got.cpu() - tr.apply_ddag_d(tapply_bc(ut), psi)).abs().max()) < BAR
    got = tr.apply_schur(geo, phi.to(dev))
    assert float((got.cpu() - tr.apply_schur(teo, phi)).abs().max()) < BAR
    assert (ww.r_launches, wk.r_launches) == (before[0] + 2 * L5, before[1] + 2 * L5)
    # no fall-back to the plain version on the card: NC != 3 raises at any r
    su2 = torch.from_numpy(np.array(jfields.hot_start(LAT, 2, seed=13))).to(dev)
    x = torch.zeros((L5,) + LAT + (4, 2), dtype=su2.dtype, device=dev)
    with pytest.raises(ValueError):
        tr.apply(su2, x)
    with pytest.raises(ValueError):
        td.apply(su2, x)
    fa = TFA(td, eps_cg=1e-24)
    f_c = fa.force(ut, phi)
    f_g = fa.force(ut.to(dev), phi.to(dev))
    assert float((f_g.cpu() - f_c).abs().max()) < 1e-10 * float(f_c.abs().max())
