"""Port parity: Hasenbusch mass preconditioning (``HasenbuschWilsonFermiAction``)
and its Sexton-Weingarten split in HMC.step, held to the JAX package on the
same inputs and the JAX package's own draws.

At csw = 0 on an all-even lattice the action runs on the packed Schur Dhat
(wilson_hop_packed), at csw != 0 on the full D with the clover term
(wilson_window). The ``gpu`` test holds the card against the CPU (run: python
-m pytest -m gpu tests/test_torch_hasenbusch.py -n 0).
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
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction as JH  # noqa: E402
from latticeqcd_tpu.smearing import stout_stack as jstout_stack  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.fermion_action import HasenbuschWilsonFermiAction as TH  # noqa: E402
from latticeqcd_torch.smearing.stout import stout_stack as tstout_stack  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC  # noqa: E402
from test_torch_hmc import _compare, jax_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA, MU = 0.13625, 0.5
CSWS = [0.0, 1.90952]
IDS = ["packed", "clover"]


def _links(seed):
    u = jfields.hot_start(LAT, 3, seed=seed)
    return u, to_torch(np.asarray(u))


def _actions(csw, eps=1e-26, mu=MU):
    return (JH(JW(kappa=KAPPA, csw=csw), mu=mu, eps_cg=eps),
            TH(TW(kappa=KAPPA, csw=csw), mu=mu, eps_cg=eps))


def _jax_noise(key, shape):
    """The normals (re, im) of the JAX package's Hasenbusch sampling for this
    key: one key per noise, each split for gaussian_spinor's re and im."""
    parts = []
    for k in jax.random.split(key, shape[0]):
        k_re, k_im = jax.random.split(k)
        parts.append((jax.random.normal(k_re, shape[1:], dtype=jnp.float64),
                      jax.random.normal(k_im, shape[1:], dtype=jnp.float64)))
    return tuple(to_torch(np.stack(p)) for p in zip(*parts))


def _sampled(csw, seed):
    """Both packages' pseudofermions from the same JAX key: (links, actions,
    (S_old, phi) of each)."""
    u, ut = _links(seed)
    fa_j, fa_t = _actions(csw)
    key = jax.random.PRNGKey(seed + 1)
    return (u, ut, fa_j, fa_t, fa_j.sample_pseudofermion(u, key),
            fa_t.sample_pseudofermion(ut, normals=_jax_noise(key, fa_t.noise_shape(ut))))


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - to_numpy(b))))


def test_noise_shape_names_both_noises():
    _, ut = _links(1)
    assert _actions(0.0)[1].noise_shape(ut) == (2, 2) + LAT[1:] + (4, 3)
    assert _actions(1.9)[1].noise_shape(ut) == (2,) + LAT + (4, 3)
    odd = torch.zeros((4, 3, 4, 2, 2, 3, 3), dtype=torch.complex128)
    assert _actions(0.0)[1].noise_shape(odd) == (2, 3, 4, 2, 2, 4, 3)


@pytest.mark.parametrize("csw", CSWS, ids=IDS)
def test_sampling_matches_jax_and_its_action(csw):
    """phi1, phi2 and S_old against the JAX package from the same key, and
    S(U, phi) = S_old right after sampling (1e-7 relative: the sign of the
    twisted term under Dhat^dag decides it)."""
    u, ut, fa_j, fa_t, (s_j, phi_j), (s_t, phi_t) = _sampled(csw, 11)
    assert abs(float(s_j) - float(s_t)) < 1e-12 * float(s_j)
    assert _diff(phi_j[0], phi_t[0]) < 1e-12 and _diff(phi_j[1], phi_t[1]) < 1e-12
    a_t = float(fa_t.action(ut, phi_t))
    assert abs(a_t - float(s_t)) < 1e-7 * float(s_t)
    assert abs(float(fa_j.action(u, phi_j)) - a_t) < 1e-12 * a_t


@pytest.mark.parametrize("csw", CSWS, ids=IDS)
def test_forces_match_jax(csw):
    """The total, heavy and light forces to 1e-12 against the JAX package, and
    heavy + light = total."""
    u, ut, fa_j, fa_t, (_, phi_j), (_, phi_t) = _sampled(csw, 12)
    total = fa_t.force(ut, phi_t)
    parts = {}
    for name in ("force", "force_heavy", "force_light"):
        f_t = total if name == "force" else getattr(fa_t, name)(ut, phi_t)
        assert _diff(getattr(fa_j, name)(u, phi_j), f_t) < 1e-12, name
        parts[name] = f_t
    assert float((parts["force_heavy"] + parts["force_light"] - total).abs().max()) < 1e-12


@pytest.mark.parametrize("csw", CSWS, ids=IDS)
def test_forces_with_guess_return_their_solutions(csw):
    """force_heavy_with_guess / force_light_with_guess: (force, x) as the JAX
    package returns them, and a warm start from x takes fewer iterations."""
    u, ut, fa_j, fa_t, (_, phi_j), (_, phi_t) = _sampled(csw, 13)
    for name in ("force_heavy_with_guess", "force_light_with_guess"):
        f_j, x_j = getattr(fa_j, name)(u, phi_j, None)
        log = []
        f_t, x_t = getattr(fa_t, name)(ut, phi_t, None, log=log)
        assert _diff(f_j, f_t) < 1e-12 and _diff(x_j, x_t) < 1e-10
        f_w, _ = getattr(fa_t, name)(ut, phi_t, x_t, log=log)
        assert float((f_w - f_t).abs().max()) < 1e-10
        assert len(log) == 2 and log[1]["iterations"] < log[0]["iterations"]


def test_stout_smeared_forces_match_jax():
    """The split forces through one stout layer, at csw != 0."""
    u, ut, fa_j, fa_t, (_, phi_j), (_, phi_t) = _sampled(CSWS[1], 14)
    sj, st = jstout_stack([0.1]).smear, tstout_stack([0.1]).smear
    for name in ("force_heavy", "force_light"):
        f_j = getattr(fa_j, name)(u, phi_j, smear_fn=sj)
        f_t = getattr(fa_t, name)(ut, phi_t, smear_fn=st)
        assert _diff(f_j, f_t) < 1e-12, name


# ---------------------------------------------------------------- trajectories


@pytest.mark.parametrize("sw", [False, True], ids=["plain", "sw"])
@pytest.mark.parametrize("csw", CSWS, ids=IDS)
def test_trajectory_matches_jax(csw, sw):
    """One 4^4 trajectory against the JAX package's fused trajectory from its
    own draws (dH 1e-9, links 1e-10). With Sexton-Weingarten (nsw 2) the
    light force kicks on the coarse scale and the heavy one on the fine gauge
    scale, each with its own warm-start chain; without, the total force
    solves from zero. The JAX package compiles the whole trajectory, so only
    the packed SW case takes two steps (the light force's warm start); the
    others take one (with SW the two heavy forces of a step still chain)."""
    u, ut = _links(15)
    fa_j, fa_t = _actions(csw, eps=1e-22)
    kw = dict(dtau=0.1, md_steps=2 if sw and csw == 0.0 else 1, sexton_weingarten=sw, nsw=2)
    key = jax.random.PRNGKey(16)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.3), fermi_action=fa_j,
                        staged=False, **kw).step(u, key)
    draws = jax_draws(key, u, fa_t.noise_shape(ut), split_noises=True)
    before = (wk.launches, ww.launches)
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 5.3), fermi_action=fa_t, **kw).step(
        ut, draws=draws)
    assert (wk.launches, ww.launches) == before  # the CPU takes the plain versions
    _compare(st_j, u_j, st_t, u_t)
    assert abs(float(st_j["sf_old"]) - st_t["sf_old"]) < 1e-9 * float(st_j["sf_old"])
    # per MD step: one light force (with SW also nsw = 2 heavy ones) or one total
    # force of two solves; then the final action's two solves
    per_step = 1 + 2 if sw else 2
    assert len(st_t["cg"]) == kw["md_steps"] * per_step + 2
    assert all(c["rsq"] <= c["target"] for c in st_t["cg"])


# ---------------------------------------------------------------------- card


@pytest.mark.gpu
def test_hasenbusch_on_gpu():
    """On the card: sampling and the split forces at csw 0 (wilson_hop_packed
    only) and csw != 0 (wilson_window only), against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_hasenbusch.py)")
    dev = torch.device("cuda")
    _, ut = _links(17)
    for csw, kernel in zip(CSWS, ("packed", "window")):
        fa = _actions(csw)[1]
        shape = fa.noise_shape(ut)
        gen = torch.Generator().manual_seed(18)
        normals = (torch.randn(shape, generator=gen, dtype=torch.float64),
                   torch.randn(shape, generator=gen, dtype=torch.float64))
        s_c, phi_c = fa.sample_pseudofermion(ut, normals=normals)
        before = (wk.launches, ww.launches)
        s_g, phi_g = fa.sample_pseudofermion(ut.to(dev), normals=tuple(n.to(dev) for n in normals))
        launched = (wk.launches - before[0], ww.launches - before[1])
        assert (launched[0] > 0 and launched[1] == 0) if kernel == "packed" else (
            launched[0] == 0 and launched[1] > 0)
        assert abs(float(s_g) - float(s_c)) < 1e-10 * float(s_c)
        for name in ("force_heavy", "force_light"):
            f_c = getattr(fa, name)(ut, phi_c)
            f_g = getattr(fa, name)(ut.to(dev), tuple(p.to(dev) for p in phi_g))
            assert float((f_g.cpu() - f_c).abs().max()) < 1e-10 * float(f_c.abs().max())
