"""Port parity for batched independent chains (HMC.step_batched).

n chains in one call, with a leading chain axis on the links: chain i must
evolve as HMC.step(us[i]) would alone, from the same draws. Held here, at
4^4 in complex128: step_batched against per-chain steps within the port
(dH 1e-10, links 1e-12, the same accept decision), quenched, two-flavour
Wilson, staggered Nf = 4 and Nf = 2 (RHMC), and every Wilson-family action
on two chains: clover, Hasenbusch with the Sexton-Weingarten split (packed
and clover), domain wall, stout-smeared Wilson, Wilson at r = 0.7 and on
the unpackable 3x4x4x4, and stout-smeared staggered Nf = 4; against the JAX package's own step_batched on
quenched and on clover chains, and against its single-chain step per chain
for Wilson and staggered Nf = 2; mixed MD together with batched chains
(Wilson, and clover in complex64); the shape error and the refusals of
what has no batched form yet (staggered on an unpackable lattice, ROADMAP
B3c; an action without batched forms, A12.7b), raised before any work. Below the trajectory: the batched multi-shift CG against the
per-chain one, the chain axis of the hop wrappers and their autograd
Functions on the CPU, and the body of csrc/staggered_w.cu (both launches
of the W, and the hop) compiled with g++ against mock headers, one and two
chains, against the plain version. The chain-axis kernels themselves run
on the card in the ``gpu`` test below and in chip_smoke.py.
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

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jwilson  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA  # noqa: E402
from latticeqcd_tpu.updates.hmc import HMC as JHMC  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import rational, solvers  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered_kernel as sk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac  # noqa: E402
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac as TS  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac as TW  # noqa: E402
from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases  # noqa: E402
from latticeqcd_torch.ops.fermion_action import (  # noqa: E402
    DomainwallFermiAction,
    HasenbuschWilsonFermiAction,
    StaggeredFermiAction as TSFA,
    WilsonFermiAction as TFA,
)
from latticeqcd_torch.smearing.stout import stout_stack  # noqa: E402
from latticeqcd_torch.updates import hmc as thmc  # noqa: E402
from latticeqcd_torch.updates.slhmc import _LogdetAsFermiAction  # noqa: E402
from latticeqcd_torch.updates.hmc import HMC as THMC, Draws  # noqa: E402
from test_torch_hmc import jax_draws as wilson_jax_draws  # noqa: E402
from test_torch_hop_packed import _MOCK_RUNTIME  # noqa: E402
from test_torch_rhmc import jax_draws as staggered_jax_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
KAPPA = 0.141139
MASS = 0.5
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")


def _chains(seeds, dtype=torch.complex128):
    return torch.stack([tfields.hot_start(LAT, 3, seed=s, dtype=dtype, device="cpu")
                        for s in seeds])


CLOVER = dict(kappa=0.13625, csw=1.90952)
# the Wilson-family actions of two-chain cases: (fermion action, lattice, smearing, SW)
FAMILY = {
    "clover": lambda: (TFA(TW(**CLOVER)), LAT, None, False),
    "hasenbusch-packed-sw": lambda: (HasenbuschWilsonFermiAction(TW(kappa=KAPPA)), LAT, None,
                                     True),
    "hasenbusch-clover-sw": lambda: (HasenbuschWilsonFermiAction(TW(**CLOVER)), LAT, None, True),
    "domainwall": lambda: (DomainwallFermiAction(DomainwallDirac(mass=0.3, m5=-1.8, l5=2)), LAT,
                           None, False),
    "stout": lambda: (TFA(TW(kappa=KAPPA)), LAT, stout_stack([0.1]), False),
    "wilson-r0.7": lambda: (TFA(TW(kappa=0.12, r=0.7)), LAT, None, False),
    "wilson-unpackable": lambda: (TFA(TW(kappa=KAPPA)), (3, 4, 4, 4), None, False),
    # the smearing reaches the staggered batched forms too
    "staggered-stout": lambda: (TSFA(TS(mass=MASS, lattice=LAT), nf=4), LAT, stout_stack([0.1]),
                                False),
}


def _action(kind):
    if kind == "quenched":
        return None
    if kind == "wilson":
        return TFA(TW(kappa=KAPPA))
    return TSFA(TS(mass=MASS, lattice=LAT), nf={"staggered-nf4": 4, "staggered-nf2": 2}[kind])


def _case(kind):
    """(HMC, chains' links, chain count): three chains over four MD steps for the
    original cases, two over two for each Wilson-family action."""
    if kind not in FAMILY:
        us = _chains((31, 32, 33))
        return THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=4,
                    fermi_action=_action(kind)), us, 3
    fa, lat, smearing, sw = FAMILY[kind]()
    us = torch.stack([tfields.hot_start(lat, 3, seed=s, device="cpu") for s in (31, 32)])
    return THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2, fermi_action=fa,
                smearing=smearing, sexton_weingarten=sw, nsw=2), us, 2


def _compare_chain(st_b, u_b, i, st, u, dh_bar=1e-10, u_bar=1e-12):
    assert abs(float(st_b["dH"][i]) - st["dH"]) < dh_bar, (float(st_b["dH"][i]), st["dH"])
    assert bool(st_b["accepted"][i]) == st["accepted"]
    assert float((u_b[i] - u).abs().max()) < u_bar
    for k in ("sf_old", "sf_new", "sg_new", "sp_new"):
        assert abs(float(st_b[k][i]) - st[k]) < dh_bar * max(1.0, abs(st[k])), k


@pytest.mark.parametrize("kind", ["quenched", "wilson", "staggered-nf4", "staggered-nf2"]
                         + list(FAMILY))
def test_step_batched_equals_per_chain_steps(kind):
    """Each chain from its own generator's draws; every chain but chain 1 is
    accepted whatever dH (uniform 0), so their evolved links are compared. A
    Hasenbusch action with the Sexton-Weingarten split runs its light force on
    the coarse scale and its heavy force on the fine one, as step does."""
    hmc, us, n = _case(kind)
    draws = [Draws.sample(hmc, us[i], torch.Generator().manual_seed(40 + i)) for i in range(n)]
    draws = [Draws(d.mom, d.xi, 0.0 if i != 1 else d.uniform) for i, d in enumerate(draws)]
    u_b, st_b = hmc.step_batched(us, draws=draws)
    assert st_b["dH"].shape == (n,) and st_b["accepted"].dtype == torch.bool
    for i in range(n):
        u_i, st_i = hmc.step(us[i], draws=draws[i])
        _compare_chain(st_b, u_b, i, st_i, u_i)
        # one batched solve over the n chains for each solve of step
        assert len(st_b["cg"]) == len(st_i["cg"])
    assert all(bool(st_b["accepted"][i]) for i in range(n) if i != 1)
    if kind != "quenched":
        assert all(c["rhs"] == n for c in st_b["cg"])
        assert all(c["rsq"] <= c["target"] for c in st_b["cg"])
    if kind in ("wilson", "staggered-nf4", "staggered-nf2"):
        # one batched solve per force and one for the final action
        assert len(st_b["cg"]) == 5
    # generators give the same draws as step would take
    gens = [torch.Generator().manual_seed(50 + i) for i in range(n)]
    u_g, st_g = hmc.step_batched(us, generators=gens)
    u_1, st_1 = hmc.step(us[1], torch.Generator().manual_seed(51))
    _compare_chain(st_g, u_g, 1, st_1, u_1)


def test_step_batched_matches_jax_step_batched_quenched():
    """The JAX package's step_batched (vmap of its fused trajectory) on two quenched
    chains, from its own keys."""
    uj = jnp.stack([jfields.hot_start(LAT, 3, seed=s) for s in (61, 62)])
    keys = jnp.stack([jax.random.PRNGKey(63), jax.random.PRNGKey(64)])
    kw = dict(dtau=0.02, md_steps=10)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 6.0), staged=False,
                        **kw).step_batched(uj, keys)
    us = to_torch(np.asarray(uj))
    draws = [wilson_jax_draws(keys[i], uj[i]) for i in range(2)]
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 6.0), **kw).step_batched(us, draws=draws)
    assert st_t["accepted"].all()  # a real comparison of evolved links
    for i in range(2):
        assert abs(float(st_j["dH"][i]) - float(st_t["dH"][i])) < 1e-9
        assert bool(st_j["accepted"][i]) == bool(st_t["accepted"][i])
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-12


def test_step_batched_matches_jax_step_batched_clover():
    """The JAX package's step_batched on two clover chains (one MD step), from its own
    keys: the clover D of each chain at 1e-12, dH at 1e-9 and the links at 1e-10 (the
    JAX suite's fused-against-staged bars)."""
    uj = jnp.stack([jfields.hot_start(LAT, 3, seed=s) for s in (65, 66)])
    keys = jnp.stack([jax.random.PRNGKey(67), jax.random.PRNGKey(68)])
    kw = dict(dtau=0.1, md_steps=1)
    us = to_torch(np.asarray(uj))
    fa_t = TFA(TW(**CLOVER))
    psi = np.random.default_rng(69).standard_normal((2,) + LAT + (4, 3, 2)) @ [1, 1j]
    d_t = fa_t.dirac.apply(apply_boundary_phases(us), to_torch(psi))
    for i in range(2):
        d_j = JW(**CLOVER).apply(jwilson.apply_boundary_phases(uj[i]), jnp.asarray(psi[i]))
        assert np.abs(np.asarray(d_j) - to_numpy(d_t[i])).max() < 1e-12
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.7), fermi_action=JFA(JW(**CLOVER)),
                        staged=False, **kw).step_batched(uj, keys)
    draws = [wilson_jax_draws(keys[i], uj[i], pf_shape=fa_t.noise_shape(us[0]))
             for i in range(2)]
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 5.7), fermi_action=fa_t,
                     **kw).step_batched(us, draws=draws)
    for i in range(2):
        assert abs(float(st_j["dH"][i]) - float(st_t["dH"][i])) < 1e-9
        assert bool(st_j["accepted"][i]) == bool(st_t["accepted"][i])
        assert np.abs(np.asarray(u_j[i]) - to_numpy(u_t[i])).max() < 1e-10


@pytest.mark.parametrize("kind", ["wilson", "staggered-nf2"])
def test_step_batched_matches_jax_per_chain(kind):
    """Each chain against the JAX package's single-chain fused step from the same key."""
    uj = [jfields.hot_start(LAT, 3, seed=s) for s in (71, 72)]
    keys = [jax.random.PRNGKey(73), jax.random.PRNGKey(74)]
    fa_t = _action(kind)
    if kind == "wilson":
        fa_j, beta, kw = JFA(JW(kappa=KAPPA)), 6.0, dict(dtau=0.1, md_steps=4)
    else:
        fa_j, beta, kw = JSFA(js.StaggeredDirac(MASS, LAT), nf=2), 5.7, dict(dtau=0.1, md_steps=2)
    hmc_j = JHMC(action=jga.wilson_gauge_action(3, beta), fermi_action=fa_j, staged=False, **kw)
    us = torch.stack([to_torch(np.asarray(u)) for u in uj])
    draws = [wilson_jax_draws(k, u, pf_shape=fa_t.noise_shape(us[0])) if kind == "wilson"
             else staggered_jax_draws(k, u, fa_t) for k, u in zip(keys, uj)]
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, beta), fermi_action=fa_t,
                     **kw).step_batched(us, draws=draws)
    for i in range(2):
        u_j, _, st_j = hmc_j.step(uj[i], keys[i])
        assert abs(float(st_j["dH"]) - float(st_t["dH"][i])) < 1e-9
        assert bool(st_j["accepted"]) == bool(st_t["accepted"][i])
        assert np.abs(np.asarray(u_j) - to_numpy(u_t[i])).max() < 1e-10
        for k in ("sf_old", "sf_new", "sg_new", "sp_new"):
            a = float(st_j[k])
            assert abs(a - float(st_t[k][i])) < 1e-9 * max(1.0, abs(a)), k


def test_mixed_step_batched():
    """Mixed MD with batched chains lifts each chain's state: complex128 Wilson
    chains equal per-chain mixed steps, and complex64 quenched chains the JAX
    package's mixed step_batched (dH at test_mdpair.py's complex64 bar of 5e-4,
    S_g being a float32 sum in both packages; links 1e-6)."""
    us = _chains((81, 82))
    hmc = THMC(action=tga.wilson_gauge_action(3, 6.0), dtau=0.05, md_steps=3,
               fermi_action=_action("wilson"), md_precision="mixed")
    draws = [Draws.sample(hmc, us[i], torch.Generator().manual_seed(83 + i)) for i in range(2)]
    draws = [Draws(d.mom, d.xi, 0.0) for d in draws]
    u_b, st_b = hmc.step_batched(us, draws=draws)
    for i in range(2):
        u_i, st_i = hmc.step(us[i], draws=draws[i])
        _compare_chain(st_b, u_b, i, st_i, u_i)

    uj = jnp.stack([jfields.hot_start(LAT, 3, seed=s).astype(jnp.complex64) for s in (85, 86)])
    keys = jnp.stack([jax.random.PRNGKey(1), jax.random.PRNGKey(2)])
    kw = dict(dtau=0.05, md_steps=3, md_precision="mixed")
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.7), staged=False,
                        **kw).step_batched(uj, keys)
    u_t, st_t = THMC(action=tga.wilson_gauge_action(3, 5.7), **kw).step_batched(
        to_torch(np.asarray(uj)), draws=[wilson_jax_draws(keys[i], uj[i]) for i in range(2)])
    assert u_t.dtype == torch.complex64
    for i in range(2):
        assert abs(float(st_j["dH"][i]) - float(st_t["dH"][i])) < 5e-4
        assert bool(st_j["accepted"][i]) == bool(st_t["accepted"][i])
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < 1e-6


def test_mixed_step_batched_clover():
    """Mixed MD with batched complex64 clover chains against per-chain mixed steps (dH at
    the complex64 mixed bar of 5e-4, links 1e-6)."""
    us = _chains((87, 88), dtype=torch.complex64)
    hmc = THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=2,
               fermi_action=TFA(TW(**CLOVER)), md_precision="mixed")
    draws = [Draws.sample(hmc, us[i], torch.Generator().manual_seed(89 + i)) for i in range(2)]
    draws = [Draws(d.mom, d.xi, 0.0) for d in draws]
    u_b, st_b = hmc.step_batched(us, draws=draws)
    assert u_b.dtype == torch.complex64
    for i in range(2):
        u_i, st_i = hmc.step(us[i], draws=draws[i])
        _compare_chain(st_b, u_b, i, st_i, u_i, dh_bar=5e-4, u_bar=1e-6)


def test_step_batched_shape_error():
    hmc = THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2)
    with pytest.raises(ValueError, match="nchain"):
        hmc.step_batched(_chains((1,))[0], generators=[torch.Generator()])


@pytest.mark.parametrize("what", ["staggered-unpackable", "logdet"])
def test_step_batched_refuses_what_has_no_batched_form(what, monkeypatch):
    """NotImplementedError naming the ROADMAP item, raised before any draw or kernel:
    staggered on a lattice with an odd extent (B3c) and an action without batched
    forms, the self-learning log-det action (A12.7b)."""
    lat = (3, 4, 4, 4) if what.endswith("unpackable") else LAT
    if what == "logdet":
        fa, item = _LogdetAsFermiAction(None), "A12.7b"
    else:
        fa, item = TSFA(TS(mass=MASS, lattice=lat), nf=4), "B3c"
    hmc = THMC(action=tga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2, fermi_action=fa)
    us = torch.stack([tfields.hot_start(lat, 3, seed=s, device="cpu") for s in (1, 2)])

    def no_work(*args, **kwargs):
        raise AssertionError("step_batched started work before refusing")

    monkeypatch.setattr(thmc.Draws, "sample", no_work)
    monkeypatch.setattr(thmc.integrators, "run_md", no_work)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        hmc.step_batched(us, generators=[torch.Generator(), torch.Generator()])


# ------------------------------------------------------------- below the trajectory


def _packed_links(seeds, lat=LAT, dtype=torch.complex128):
    """(u_e, u_o) of each chain with the boundary phases, chain axis in front."""
    pairs = [eo_pack.pack_links(apply_boundary_phases(
        tfields.hot_start(lat, 3, seed=s, dtype=dtype, device="cpu")), lat) for s in seeds]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def test_multishift_cg_multi_equals_per_chain():
    """Each chain of the batched multi-shift CG, with its own W, against multishift_cg
    alone; the chains converge at different iterations (one right-hand side is 1e3
    times smaller, so it freezes first under the common |b|^2 floor of 1)."""
    u_e, u_o = _packed_links((5, 6, 7))
    rng = np.random.default_rng(8)
    shape = (3, 2) + LAT[1:] + (3,)
    b = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    b[2] *= 1e-3
    pf = rational.rational_inverse_power(0.5, 0.25 * 0.999, 16.75)
    w = lambda v: sk.staggered_w(u_e, u_o, v, MASS)  # noqa: E731
    log = []
    xs, it, rsq = solvers.multishift_cg_multi(w, b, pf.shifts, eps=1e-22, log=log)
    assert xs.shape == (len(pf.shifts),) + tuple(b.shape)
    assert log[0]["rhs"] == 3 and log[0]["shifts"] == len(pf.shifts)
    its = []
    for i in range(3):
        x1, it1, rsq1 = solvers.multishift_cg(
            lambda v: sk.staggered_w(u_e[i], u_o[i], v, MASS), b[i], pf.shifts, eps=1e-22)
        its.append(it1)
        assert float((xs[:, i] - x1).abs().max()) < 1e-12
        assert abs(float(rsq[i]) - float(rsq1)) <= 1e-12 * max(float(rsq1), 1e-30)
    assert it == max(its) and min(its) < it


@pytest.mark.parametrize("kernel", ["wilson", "staggered"])
def test_hop_functions_take_a_chain_axis(kernel):
    """The autograd Functions with a leading chain axis on the CPU: forward and the
    backward for the links and the field equal to the per-chain calls."""
    u_e, u_o = _packed_links((11, 12))
    site = (4, 3) if kernel == "wilson" else (3,)
    shape = (2, 2) + LAT[1:] + site
    g = torch.Generator().manual_seed(13)
    x, cot = (torch.randn(shape, dtype=torch.complex128, generator=g) for _ in range(2))
    hop = wk.wilson_hop_packed if kernel == "wilson" else sk.staggered_hop_packed
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
        out = hop(*leaves, parity)
        grads = torch.autograd.grad(out, leaves, cot)
        for i in range(2):
            one = [t[i].detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
            out1 = hop(*one, parity)
            grads1 = torch.autograd.grad(out1, one, cot[i])
            assert float((out[i] - out1).detach().abs().max()) < 1e-14
            for a, b in zip(grads, grads1):
                assert float((a[i] - b).abs().max()) < 1e-14
    if kernel == "staggered":  # the W with a chain axis is the per-chain W
        w = sk.staggered_w(u_e, u_o, x, MASS)
        for i in range(2):
            assert torch.equal(w[i], sk.staggered_w(u_e[i], u_o[i], x[i], MASS))


_STAGGERED_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
// the launch function's grid (blocks x chains) and block, one thread at a time
template <typename R, bool AXPY>
void launch(const std::vector<typename Vec<R>::type>& uf,
            const std::vector<typename Vec<R>::type>& ub, const typename Vec<R>::type* psi,
            const typename Vec<R>::type* phi,
            typename Vec<R>::type* out, int x2, int ly, int lz, int lt, int parity, R m2,
            int nchain, long long u_chain, long long psi_chain) {
  const int vol = x2 * ly * lz * lt, threads = 128, blocks = (vol + threads - 1) / threads;
  blockDim = dim3{(unsigned)threads, 1, 1};
  for (int c = 0; c < nchain; ++c)
    for (int b = 0; b < blocks; ++b)
      for (int t = 0; t < threads; ++t) {
        blockIdx = dim3{(unsigned)b, (unsigned)c, 0};
        threadIdx = dim3{(unsigned)t, 0, 0};
        // the launch function's choice: the kernel without the chain offsets for one chain
        auto kernel = nchain == 1 ? staggered_hop_kernel<R, AXPY, false>
                                  : staggered_hop_kernel<R, AXPY, true>;
        kernel(uf.data(), ub.data(), psi, phi, out, x2, ly, lz, lt, parity, m2, u_chain,
               psi_chain);
      }
}
template <typename R>
int run(int x2, int ly, int lz, int lt, int mode, int nchain, double m2) {
  using V = typename Vec<R>::type;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ue(36 * vol * nchain), uo(36 * vol * nchain), phi(3 * vol * nchain),
      d1(3 * vol * nchain), out(3 * vol * nchain);
  for (auto* f : {&ue, &uo, &phi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  std::memset(d1.data(), 0xff, d1.size() * sizeof(V));  // a site never written shows as NaN
  std::memset(out.data(), 0xff, out.size() * sizeof(V));
  if (mode == 0) {  // W: d1 = D_oe phi, then out = m2 phi - D_eo d1
    launch<R, false>(uo, ue, phi.data(), nullptr, d1.data(), x2, ly, lz, lt, 1, R(0), nchain,
                     36 * vol, 3 * vol);
    launch<R, true>(ue, uo, d1.data(), phi.data(), out.data(), x2, ly, lz, lt, 0, R(m2), nchain,
                    36 * vol, 3 * vol);
  } else {  // the hop onto target parity mode - 1
    const int parity = mode - 1;
    launch<R, false>(parity ? uo : ue, parity ? ue : uo, phi.data(), nullptr, out.data(), x2, ly,
                     lz, lt, parity, R(0), nchain, 36 * vol, 3 * vol);
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int mode = atoi(argv[5]), c128 = atoi(argv[6]), nchain = atoi(argv[7]);
  const double m2 = atof(argv[8]);
  return c128 ? run<double>(x2, ly, lz, lt, mode, nchain, m2)
              : run<float>(x2, ly, lz, lt, mode, nchain, m2);
}
"""


@pytest.fixture(scope="module")
def staggered_body_exe(tmp_path_factory):
    """The kernel body of csrc/staggered_w.cu (the file up to its launch functions),
    compiled for the CPU with g++ against test_torch_hop_packed.py's mock runtime."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("staggered")
    (d / "cuda_runtime.h").write_text(_MOCK_RUNTIME + "inline thread_local dim3 blockDim;\n")
    src = open(os.path.join(CSRC, "staggered_w.cu")).read()
    (d / "body.inc").write_text(src[:src.index("// The chain strides of a launch")]
                                + "}  // namespace\n")
    (d / "harness.cpp").write_text(_STAGGERED_HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-I", str(d), "-I", CSRC, str(d / "harness.cpp"),
                    "-o", str(exe)], check=True)
    return str(exe)


@pytest.mark.parametrize("nchain", [1, 2])
@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (2, 4, 2, 6), (8, 6, 10, 4)],
                         ids=["4^4", "x2is1", "y6z10"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_staggered_w_body_on_the_cpu(staggered_body_exe, lat, dtype, nchain):
    """csrc/staggered_w.cu's kernel body, thread by thread: the W of the paths (its
    two launches, d1 through memory) and the hop onto both target parities, one
    chain or two chains with different links in one launch, each chain against
    the plain version."""
    tdt = getattr(torch, dtype)
    u_e, u_o = (f.to(tdt) for f in _packed_links(tuple(sum(lat) + c for c in range(nchain)),
                                                  lat=lat))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn((nchain,) + half + (3,), dtype=tdt, generator=torch.Generator().manual_seed(2))
    refs = [sk.staggered_w_reference(u_e, u_o, x, MASS),
            sk.staggered_hop_packed_reference(u_e, u_o, x, 0),
            sk.staggered_hop_packed_reference(u_o, u_e, x, 1)]
    for mode, ref in enumerate(refs):
        out = subprocess.run(
            [staggered_body_exe, *map(str, half), str(mode), str(int(dtype == "complex128")),
             str(nchain), repr(MASS ** 2)],
            input=b"".join(to_numpy(f).tobytes() for f in (u_e, u_o, x)),
            capture_output=True, check=True)
        got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(x.shape)
        assert float(np.abs(got - to_numpy(ref)).max()) < (1e-12 if dtype == "complex128" else 1e-5)


@pytest.mark.gpu
def test_chain_kernels_on_gpu():
    """The chain-axis kernels on the card against their plain per-chain versions:
    one launch for 3 chains, forward and the link backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_batched.py)")
    dev = torch.device("cuda")
    for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        u_e, u_o = (f.to(dev, dtype) for f in _packed_links((21, 22, 23)))
        g = torch.Generator(device=dev).manual_seed(24)
        for site, hop, ref, mod in (((4, 3), wk.wilson_hop_packed, wk.hop_packed_reference, wk),
                                    ((3,), sk.staggered_hop_packed,
                                     sk.staggered_hop_packed_reference, sk)):
            x = torch.randn((3, 2) + LAT[1:] + site, dtype=dtype, device=dev, generator=g)
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                before = mod.launches
                got = hop(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                assert mod.launches == before + 1
                assert float((got - ref(u_t, u_s, x, parity)).abs().max()) < bar
        x = torch.randn((3, 2) + LAT[1:] + (3,), dtype=dtype, device=dev, generator=g)
        before = sk.w_launches
        got = sk.staggered_w(u_e, u_o, x, MASS)
        torch.cuda.synchronize()
        assert sk.w_launches == before + 1
        assert float((got - sk.staggered_w_reference(u_e, u_o, x, MASS)).abs().max()) < bar
