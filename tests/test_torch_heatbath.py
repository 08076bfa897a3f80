"""Port parity: the SU(N) heatbath and overrelaxation (updates/heatbath.py).

The heatbath sweep is replayed from the JAX package's own key schedule:
``JaxUniforms`` splits the key as ``Heatbath._sweep_impl`` does (per mu,
colour and subgroup: key -> key, k_a0, k_dir; per try k_a0 -> k_a0, k1..k4;
k_dir -> ct, phi) and hands the same uniforms to the port.
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
from latticeqcd_tpu.updates import heatbath as jhb  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import sun as tsun  # noqa: E402
from latticeqcd_torch.updates import heatbath as thb  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
ODD = (3, 5, 2, 6)
TOL = 1e-12


class JaxUniforms:
    """The uniforms of the JAX package's Heatbath.sweep for ``key``."""

    def __init__(self, key):
        self.key = key
        self.k_dir = None
        self.tries_drawn = 0

    def _u(self, k, shape, dtype, lo, hi):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return to_torch(jax.random.uniform(k, shape, minval=lo, maxval=hi, dtype=jdt))

    def tries(self, shape, dtype, device):
        self.key, k_a0, self.k_dir = jax.random.split(self.key, 3)

        def gen(k):
            while True:
                k, k1, k2, k3, k4 = jax.random.split(k, 5)
                self.tries_drawn += 1
                yield tuple(self._u(kk, shape, dtype, lo, 1.0)
                            for kk, lo in ((k1, 1e-30), (k2, 0.0), (k3, 1e-30), (k4, 0.0)))

        return gen(k_a0)

    def direction(self, shape, dtype, device):
        k1, k2 = jax.random.split(self.k_dir)
        return (self._u(k1, shape, dtype, -1.0, 1.0),
                self._u(k2, shape, dtype, 0.0, 2 * jnp.pi))


def warm_links(lat, nc, seed, eps=0.3):
    """exp(i eps H) with H traceless hermitian from numpy's default_rng(seed):
    links with a plaquette of 0.7-0.8, as a thermalised configuration near
    beta = 6 has. On Haar-random links an overrelaxation sweep amplifies a
    1e-16 change of its input to 5e-12 (NC = 3) and 5e-10 (NC = 4) in the
    JAX package alone, so a 1e-12 comparison of two implementations needs
    ordered links."""
    rng = np.random.default_rng(seed)
    shape = (4, *lat, nc, nc)
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    h = 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))
    h -= np.trace(h, axis1=-2, axis2=-1)[..., None, None] * np.eye(nc) / nc
    return to_numpy(tsun.expi_hermitian(to_torch(h), eps))


def _both(nc, beta):
    return (jhb.Heatbath(action=jga.wilson_gauge_action(nc, beta)),
            thb.Heatbath(action=tga.wilson_gauge_action(nc, beta)))


# ------------------------------------------------------------ overrelaxation


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_overrelaxation_matches_jax(nc):
    u = warm_links(LAT, nc, seed=nc)
    hb_j, hb_t = _both(nc, 5.7)
    u_j, _ = hb_j.overrelax(jnp.asarray(u), jax.random.PRNGKey(0))
    u_t = hb_t.overrelax(to_torch(u))
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    assert np.abs(u - to_numpy(u_t)).max() > 1e-3


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_overrelaxation_conserves_the_action(nc):
    """On Haar-random links: every masked reflection keeps its local weight and
    no two sites of a colour share a staple, so the total action is conserved."""
    u = to_torch(np.asarray(jfields.hot_start(LAT, nc, seed=2)))
    act = tga.wilson_gauge_action(nc, 5.7)
    u1 = thb.Heatbath(action=act).overrelax(u)
    s0, s1 = float(tga.action_value(act, u)), float(tga.action_value(act, u1))
    assert abs(s1 - s0) < 1e-8 * max(1.0, abs(s0))
    assert float((u1 - u).abs().max()) > 1e-3
    assert float(tsun.unitarity_defect(u1)) < 1e-12


def test_overrelaxation_odd_lattice_matches_jax():
    """3x5x2x6: the plaquette action colours every site on its own."""
    u = warm_links(ODD, 3, seed=7)
    hb_j, hb_t = _both(3, 5.7)
    u_j, _ = hb_j.overrelax(jnp.asarray(u), jax.random.PRNGKey(0))
    assert np.abs(np.asarray(u_j) - to_numpy(hb_t.overrelax(to_torch(u)))).max() < TOL


# ------------------------------------------------------------------ heatbath


@pytest.mark.parametrize("nc,beta", [(2, 2.2), (3, 5.7)])
@pytest.mark.parametrize("start", ["hot", "warm"])
def test_heatbath_sweep_matches_jax(nc, beta, start):
    u = (np.asarray(jfields.hot_start(LAT, nc, seed=7)) if start == "hot"
         else warm_links(LAT, nc, seed=7))
    key = jax.random.PRNGKey(3 + nc)
    hb_j, hb_t = _both(nc, beta)
    u_j, _ = hb_j.sweep(jnp.asarray(u), key)
    uniforms = JaxUniforms(key)
    u_t = hb_t.sweep(to_torch(u), uniforms=uniforms)
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    # the port stopped the tries early: far fewer than 48 per update
    updates = 4 * 2 * nc * (nc - 1) // 2
    assert updates <= uniforms.tries_drawn < 12 * updates
    assert float(tsun.unitarity_defect(u_t)) < TOL


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((50, 2, 2)) + 1j * rng.standard_normal((50, 2, 2))
    q = rng.standard_normal((4, 50))
    x_j = jhb._quat_of_block(*(s[..., a, b] for a in (0, 1) for b in (0, 1)))
    st = to_torch(s)
    x_t = thb._quat_of_block(*thb._block(st, 0, 1))
    for a, b in zip(x_j, x_t):
        assert np.array_equal(np.asarray(a), to_numpy(b))
    v_j = np.asarray(jhb._su2_from_quat(*(jnp.asarray(c) for c in q), jnp.complex128))
    v_t = to_numpy(thb._su2_from_quat(*(to_torch(c) for c in q), torch.complex128))
    assert np.array_equal(v_j, v_t)
    # Re tr(V S) = 2 (v0 x0 + v.x)
    lhs = np.real(np.trace(v_t @ s, axis1=-2, axis2=-1))
    assert np.abs(lhs - 2 * sum(q[k] * to_numpy(x_t[k]) for k in range(4))).max() < TOL


@pytest.mark.parametrize("lat", [LAT, ODD, (2, 4, 6, 8), (3, 4, 4, 4)])
def test_colour_masks_match_jax(lat):
    act_j, act_t = jga.wilson_gauge_action(3, 6.0), tga.wilson_gauge_action(3, 6.0)
    ext = act_j.max_extent()
    assert ext == act_t.max_extent() == 1
    moduli = jhb._color_moduli_ext(ext, lat)
    assert moduli == thb._color_moduli_ext(ext, lat)
    plaq_eo = all(l % 2 == 0 for l in lat)
    ref = np.stack([np.asarray(m) for m in jhb._parity_masks(lat, moduli, plaq_eo)])
    got = thb.color_masks(act_t, lat)
    assert np.array_equal(ref, got)
    assert got.shape[0] == (2 if plaq_eo else int(np.prod(lat)))
    assert np.array_equal(got.sum(0), np.ones(lat, dtype=int))
    for ext in (2, 3):  # wider loops: the per-axis moduli
        assert jhb._color_moduli_ext(ext, lat) == thb._color_moduli_ext(ext, lat)


@pytest.mark.parametrize("alpha", [0.01, 0.5, 1.9, 2.1, 10.0])
def test_sampler_first_moment_against_quadrature(alpha):
    """The KP/Creutz hybrid draws from sqrt(1 - a0^2) exp(alpha a0) on both
    sides of the switch: its mean against Gauss-Jacobi quadrature."""
    from scipy.special import roots_jacobi

    xg, wg = roots_jacobi(200, 0.5, 0.5)
    n = 120000
    a = torch.full((n,), alpha, dtype=torch.float64)
    tries = thb.GeneratorUniforms(torch.Generator().manual_seed(3)).tries((n,), torch.float64,
                                                                           "cpu")
    a0, done = thb._kp_sample_a0(a, torch.ones(n, dtype=torch.bool), 10 ** 5, tries)
    assert bool(done.all())
    a0 = to_numpy(a0)
    w = wg * np.exp(alpha * xg)
    m1 = (xg * w).sum() / w.sum()
    err = a0.std() / n ** 0.5
    assert abs(a0.mean() - m1) < 4 * err, (alpha, a0.mean(), m1, err)


def test_no_exhausted_sites_at_any_coupling():
    for nc, betas in ((2, (1.0, 0.01)), (3, (5.7, 0.5, 0.01))):
        for beta in betas:
            hb = thb.Heatbath(action=tga.wilson_gauge_action(nc, beta))
            u = tfields.hot_start(LAT, nc, seed=1, device="cpu")
            gen = torch.Generator().manual_seed(0)
            tot_e = tot_a = 0
            for _ in range(3):
                u, ne, na = hb.sweep_diag(u, gen)
                tot_e += ne
                tot_a += na
            assert tot_a == 3 * 4 * (nc * (nc - 1) // 2) * int(np.prod(LAT))
            assert tot_e == 0, (nc, beta, tot_e, tot_a)


def test_complex64_storage_stays_complex64():
    hb = thb.Heatbath(action=tga.wilson_gauge_action(3, 5.7), use_or=True, num_or=2)
    u = tfields.cold_start(LAT, 3, dtype=torch.complex64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        u, stats = hb.step(u, gen)
        assert stats == {"accepted": True}
    assert u.dtype == torch.complex64
    p = float(tga.mean_plaquette(u))
    assert 0.3 < p < 1.0, p
    assert float(tsun.unitarity_defect(u)) < 1e-5


def test_sweep_diag_links_equal_sweep():
    hb = thb.Heatbath(action=tga.wilson_gauge_action(3, 2.0))
    u = tfields.hot_start(LAT, 3, seed=3, device="cpu")
    u1 = hb.sweep(u, torch.Generator().manual_seed(9))
    u2, ne, na = hb.sweep_diag(u, torch.Generator().manual_seed(9))
    assert torch.equal(u1, u2)
    assert na > 0 and ne == 0


def test_update_is_a_sweep_then_overrelaxations():
    hb = thb.Heatbath(action=tga.wilson_gauge_action(3, 6.0), use_or=True, num_or=3)
    u = tfields.hot_start(LAT, 3, seed=4, device="cpu")
    ref = hb.sweep(u, torch.Generator().manual_seed(5))
    for _ in range(3):
        ref = hb.overrelax(ref)
    assert torch.equal(hb.update(u, torch.Generator().manual_seed(5)), ref)
    plain = thb.Heatbath(action=tga.wilson_gauge_action(3, 6.0))
    assert torch.equal(plain.update(u, torch.Generator().manual_seed(5)),
                       plain.sweep(u, torch.Generator().manual_seed(5)))


@pytest.mark.slow
@pytest.mark.parametrize("beta,p_ref", [(5.7, 0.549195), (6.0, 0.593679)])
def test_published_su3_plaquette_mid_coupling(beta, p_ref):
    """The port's mirror of tests/test_physics_anchors.py's test of the same
    name: 8^4 cold-start heatbath, 60 sweeps to thermalise, then 90
    measurements one every 2 sweeps, within 4 sigma_MC + 0.016 of the
    published infinite-volume plaquette."""
    hb = thb.Heatbath(action=tga.wilson_gauge_action(3, beta))
    u = tfields.cold_start((8, 8, 8, 8), 3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(60):
        u = hb.sweep(u, gen)
    ps = []
    for _ in range(90):
        u = hb.sweep(hb.sweep(u, gen), gen)
        ps.append(float(tga.mean_plaquette(u)))
    ps = np.asarray(ps)
    mean, err = ps.mean(), ps.std() / np.sqrt(len(ps) / 3.0)
    band = 4.0 * err + 0.016
    assert abs(mean - p_ref) < band, (beta, mean, p_ref, err, band)
