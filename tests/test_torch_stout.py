"""Port parity: stout smearing (smearing/stout.py, system/universe.py's
build_smearing) and the fermion forces through it (ops/fermion_action.py's
smear_fn), held to the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_tpu.system import params as jparams  # noqa: E402
from latticeqcd_tpu.system import universe as juniv  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import sun as tsun  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction as TSFA  # noqa: E402
from latticeqcd_torch.ops.fermion_action import WilsonFermiAction as TFA  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402
from latticeqcd_torch.system import params as tparams  # noqa: E402
from latticeqcd_torch.system import universe as tuniv  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
TOL = 1e-12
LOOPS = [("plaquette",), ("plaquette", "rectangular")]


def _links(start, nc, seed=50):
    return jfields.cold_start(LAT, nc) if start == "cold" else jfields.hot_start(LAT, nc, seed=seed)


@pytest.mark.parametrize("nc", [2, 3])
@pytest.mark.parametrize("loops", LOOPS, ids=["plaq", "plaq+rect"])
@pytest.mark.parametrize("rhos", [[0.1], [0.1, 0.12]], ids=["1layer", "2layers"])
def test_stout_smear_matches_jax(rhos, loops, nc):
    u = _links("hot", nc, seed=51 + nc)
    ref = np.asarray(jstout_stack(rhos, loop_names=loops).smear(u))
    got = tstout_stack(rhos, loop_names=loops).smear(to_torch(np.asarray(u)))
    assert np.abs(ref - to_numpy(got)).max() < TOL
    assert float(tsun.unitarity_defect(got)) < TOL
    # smearing raises the plaquette of hot links
    assert float(tga.mean_plaquette(got)) > float(jga.mean_plaquette(u))


def _grad_mean_plaquette(net, ut):
    uu = ut.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tga.mean_plaquette(net.smear(uu)), uu)
    return g


@pytest.mark.parametrize("nc", [2, 3])
@pytest.mark.parametrize("start", ["cold", "hot"])
@pytest.mark.parametrize("loops", LOOPS, ids=["plaq", "plaq+rect"])
def test_stout_gradient_matches_jax(loops, start, nc):
    """d<P>(smear(U))/dU: torch.autograd against jax.grad with the conjugate
    rule (PyTorch's gradient is the complex conjugate of JAX's), finite on
    cold links too, where Q = 0 in every layer."""
    u = _links(start, nc)
    rhos = [0.1, 0.1]
    net_t = tstout_stack(rhos, loop_names=loops)
    g_t = _grad_mean_plaquette(net_t, to_torch(np.asarray(u)))
    assert bool(torch.isfinite(g_t).all())
    assert float(g_t.abs().max()) > 1e-6
    g_j = np.asarray(jax.grad(lambda x: jga.mean_plaquette(jstout_stack(rhos, loops).smear(x)))(u))
    if np.isfinite(g_j).all():
        assert np.abs(np.conj(g_j) - to_numpy(g_t)).max() < 1e-10
    else:
        # the JAX package's SU(2) exponential has a 0 * inf in its backward at Q = 0:
        # hold the port against its own scaling-and-squaring exponential instead
        assert nc == 2 and start == "cold"
        taylor = lambda h, eps: tsun._expm_taylor_ss(1j * eps * h)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsun, "expi_hermitian", taylor)
            g_ref = _grad_mean_plaquette(net_t, to_torch(np.asarray(u)))
        assert float((g_ref - g_t).abs().max()) < 1e-10


def test_build_smearing_matches_jax():
    for kw in (dict(), dict(stout_numlayers=3), dict(stout_numlayers=2, stout_rho=[0.1, 0.2]),
               dict(stout_loops=["plaquette", "rectangular"], stout_rho=[0.05])):
        j = juniv.build_smearing(jparams.Params(smearing_for_fermion="stout", **kw))
        t = tuniv.build_smearing(tparams.Params(smearing_for_fermion="stout", **kw))
        assert [(l.rho, l.loop_names) for l in t.layers] == [(l.rho, l.loop_names) for l in j.layers]
    assert tuniv.build_smearing(tparams.Params()) is None
    with pytest.raises(ValueError, match="not supported"):
        tuniv.build_smearing(tparams.Params(smearing_for_fermion="hex"))


# ------------------------------------------------------- forces through the smearing


def _packed_spinor(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("loops", LOOPS, ids=["plaq", "plaq+rect"])
def test_smeared_wilson_force_matches_jax(loops):
    u = _links("hot", 3, seed=55)
    ut = to_torch(np.asarray(u))
    net_j, net_t = jstout_stack([0.1, 0.1], loops), tstout_stack([0.1, 0.1], loops)
    fa_j, fa_t = JFA(JW(kappa=0.12), eps_cg=1e-22), TFA(TW(kappa=0.12), eps_cg=1e-22)
    phi = _packed_spinor(56, fa_t.noise_shape(ut))
    f_j = np.asarray(fa_j.force(u, jnp.asarray(phi), smear_fn=net_j.smear))
    f_t, x = fa_t.force_with_guess(ut, to_torch(phi), None, smear_fn=net_t.smear)
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-10
    # the smearing changes the force, and the solve ran on the smeared links
    assert float((fa_t.force(ut, to_torch(phi)) - f_t).abs().max()) > 1e-3
    d = TW(kappa=0.12)
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    ueo = d.packed_links(apply_boundary_phases(net_t.smear(ut)))
    assert float((d.apply_dhat_ddag(ueo, x) - to_torch(phi)).abs().max()) < 1e-9


@pytest.mark.parametrize("nf", [4, 2])
def test_smeared_staggered_force_matches_jax(nf):
    u = _links("hot", 3, seed=57)
    ut = to_torch(np.asarray(u))
    net_j, net_t = jstout_stack([0.1, 0.1]), tstout_stack([0.1, 0.1])
    fa_j = JSFA(js.StaggeredDirac(0.5, LAT), nf=nf, eps_cg=1e-22)
    fa_t = TSFA(ts.StaggeredDirac(0.5, LAT), nf=nf, eps_cg=1e-22)
    rng = np.random.default_rng(58 + nf)
    shape = (fa_t.n_pf,) + LAT + (3,)
    phi = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        * js.ks_phases(LAT)[1][None, ..., None]  # even-supported
    f_j = np.asarray(fa_j.force(u, jnp.asarray(phi), smear_fn=net_j.smear))
    f_t = fa_t.force(ut, to_torch(phi), smear_fn=net_t.smear)
    assert np.abs(f_j - to_numpy(f_t)).max() < 1e-10
    assert float((fa_t.force(ut, to_torch(phi)) - f_t).abs().max()) > 1e-3


def test_smeared_force_is_the_derivative_of_the_smeared_action():
    """dS_f(smear(U_t))/dt along U_t = exp(i t H) U against -2 tr(H F)."""
    u = to_torch(np.asarray(_links("hot", 3, seed=59)))
    net = tstout_stack([0.1, 0.1])
    fa = TFA(TW(kappa=0.12), eps_cg=1e-24)
    phi = to_torch(_packed_spinor(60, fa.noise_shape(u)))
    h = tsun.random_hermitian_momentum(u.shape[:-2], 3, device="cpu",
                                       generator=torch.Generator().manual_seed(61))
    s_at = lambda t: float(fa.action(net.smear(tsun.mul(tsun.expi_hermitian(h, t), u)), phi))
    dt = 1e-4
    ds_num = (s_at(dt) - s_at(-dt)) / (2 * dt)
    ds_force = -2.0 * float(torch.sum(torch.real(tsun.trace(tsun.mul(h, fa.force(u, phi,
                                                                                 smear_fn=net.smear))))))
    assert abs(ds_num - ds_force) < 2e-6 * max(1.0, abs(ds_num)), (ds_num, ds_force)
