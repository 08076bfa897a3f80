"""Stout-smeared HMC on the port's process grid, on the CPU.

Two gloo processes on the grid (1, 1, 1, 2) over 4x4x2x4 (test_torch_grid's
start_ranks; the JAX package's trajectory and the single-process references
are computed while the ranks run). The fermion
actions see two stout layers (plaquette staples, rho 0.1) of the links, built
from sharded rolls, and the force's chain rule runs through them by autograd
(the rolls' backward is the opposite sharded roll; the halo hops' link
gradients flow on into the stout graph):

* a stout layer stack's forward and the gradient of Re<W, smear(U)> with
  respect to the bare links, on each block, against the global stack's
  block to 1e-12;
* one trajectory (1 MD step) for each fermion action that runs on the grid:
  Wilson (wilson_hop_packed's halo mode), clover (wilson_window's),
  Hasenbusch at csw = 0 (heavy and light forces), domain wall at L5 = 2 and
  staggered Nf = 4 (staggered_w's), drawn from one seed, against one
  process drawing from the same seed to 1e-12;
* the Wilson trajectory from the JAX package's own draws against one
  process and against the JAX package's HMC.step with its stout_stack to
  dH 1e-8 and links 1e-10 (the bars of tests/test_sharding.py);
* every rank's dH and accept decision bitwise the same.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_ranks  # noqa: E402
from test_torch_grid_staggered import _draws, _trajectory, assert_values_close  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 2, 4)
RHOS = (0.1, 0.1)
BETA, KAPPA, CSW, MU = 5.7, 0.13, 1.5, 0.5
MD = dict(dtau=0.1, md_steps=1)
ACTIONS = ("wilson", "clover", "hasenbusch", "domainwall", "staggered")
SEED, KEY, GEN = 61, 62, 63


def _action(tag, lattice):
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                     HasenbuschWilsonFermiAction,
                                                     StaggeredFermiAction, WilsonFermiAction)

    if tag == "wilson":
        return WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-22)
    if tag == "clover":
        return WilsonFermiAction(WilsonDirac(kappa=KAPPA, csw=CSW), eps_cg=1e-22)
    if tag == "hasenbusch":
        return HasenbuschWilsonFermiAction(WilsonDirac(kappa=KAPPA), mu=MU, eps_cg=1e-22)
    if tag == "domainwall":
        return DomainwallFermiAction(DomainwallDirac(0.3, -1.8, 2), eps_cg=1e-22)
    return StaggeredFermiAction(StaggeredDirac(0.5, tuple(lattice)), nf=4, eps_cg=1e-22)


def _hmc(tag, lattice):
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.updates.hmc import HMC

    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=_action(tag, lattice),
               smearing=stout_stack(RHOS), **MD)


def _links(seed=SEED):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(LAT, 3, seed=seed, device="cpu")  # the block under a grid


def _layers(block):
    """The stack's forward and the bare links' gradient of Re<W, smear(U)>, gathered."""
    from latticeqcd_torch.smearing.stout import stout_stack

    rng = np.random.default_rng(64)
    shape = (4,) + LAT + (3, 3)
    w = torch.from_numpy(block(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
    u = _links(65).clone().requires_grad_(True)
    with torch.enable_grad():
        smeared = stout_stack(RHOS).smear(u)
        (g,) = torch.autograd.grad(torch.sum(torch.real(w.conj() * smeared)), u)
    gather = lambda t: mesh.to_host_global(t.detach(), lead=1)  # noqa: E731
    return {"smeared": gather(smeared), "grad": gather(g)}


def _runs(lattice, block, draws_file):
    out = _layers(block)
    for tag in ACTIONS:
        u_new, values, acc, _ = _trajectory(_hmc(tag, lattice), _links(),
                                            generator=torch.Generator().manual_seed(GEN))
        out.update({f"{tag}_values": values, f"{tag}_accepted": np.asarray(acc),
                    f"{tag}_u": u_new})
    z = dict(np.load(draws_file))
    u_new, values, acc, ncg = _trajectory(_hmc("wilson", lattice), _links(),
                                          draws=_draws(z, "jax"))
    out.update({"jax_values": values, "jax_accepted": np.asarray(acc), "jax_u": u_new,
                "jax_cg": np.asarray(ncg)})
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _case_stout(grid, draws_file):
    return _runs(grid.local, lambda a: grid.block(a, lead=1).copy(), draws_file)


def _rank_main(argv):
    rank_main(argv, {"stout": _case_stout}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def stout_runs(tmp_path_factory):
    """(the rank group's results, the single-process port's, the JAX package's Wilson
    trajectory): the JAX draws are written first, then the ranks start, and the
    references are computed while they run."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA
    from latticeqcd_tpu.smearing import stout_stack as jstout_stack
    from latticeqcd_tpu.updates.hmc import HMC as JHMC
    from test_torch_hmc import jax_draws

    u = jfields.hot_start(LAT, 3, seed=SEED)
    key = jax.random.PRNGKey(KEY)
    dr = jax_draws(key, u, _action("wilson", LAT).noise_shape(_links()))
    base = tmp_path_factory.mktemp("grid_stout")
    draws_file = str(base / "draws.npz")
    np.savez(draws_file, jax_mom_re=dr.mom[0].numpy(), jax_mom_im=dr.mom[1].numpy(),
             jax_xi_re=dr.xi[0].numpy(), jax_xi_im=dr.xi[1].numpy(),
             jax_uniform=np.asarray(dr.uniform))
    os.makedirs(base / "ranks")
    group = start_ranks("test_torch_grid_stout", "stout", PES, base / "ranks", draws_file)
    try:
        u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA),
                            fermi_action=JFA(JW(kappa=KAPPA), eps_cg=1e-22),
                            smearing=jstout_stack(list(RHOS)), staged=False, **MD).step(u, key)
        single = _runs(LAT, lambda a: a, draws_file)
        ranks = group.join()
    finally:
        group.kill()
    return ranks, single, (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("what", ["smeared", "grad"])
def test_stout_layers_match_the_global_stack(stout_runs, what):
    """Two stout layers on the blocks, and the gradient of Re<W, smear(U)> with respect to
    the bare links through their sharded rolls (a face link's gradient lands on the rank
    that holds it), against the global stack to 1e-12."""
    ranks, single, _ = stout_runs
    assert np.abs(ranks[0][what] - single[what]).max() < 1e-12, what
    assert np.abs(single[what]).max() > 0.1


@pytest.mark.parametrize("tag", ACTIONS)
def test_stout_trajectory_matches_single_process(stout_runs, tag):
    """A stout-smeared trajectory drawn from one seed against one process drawing from the
    same seed: the action parts to 1e-12 relative, dH to 1e-12 of the action, the
    decision, links 1e-12."""
    ranks, single, _ = stout_runs
    res = ranks[0]
    assert_values_close(res[f"{tag}_values"], single[f"{tag}_values"], tag)
    assert bool(res[f"{tag}_accepted"]) == bool(single[f"{tag}_accepted"]), tag
    assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-12, tag


def test_stout_wilson_trajectory_matches_jax(stout_runs):
    """The Wilson trajectory from the JAX package's draws: against one process to 1e-12
    with as many solves, and against the JAX package's HMC.step with its stout_stack to
    dH 1e-8 and links 1e-10."""
    ranks, single, (u_j, dh_j, acc_j) = stout_runs
    res = ranks[0]
    assert_values_close(res["jax_values"], single["jax_values"], "jax")
    assert int(res["jax_cg"]) == int(single["jax_cg"]) == MD["md_steps"] + 1
    assert abs(float(res["jax_values"][0]) - dh_j) < 1e-8
    assert bool(res["jax_accepted"]) == acc_j
    assert np.abs(res["jax_u"] - u_j).max() < 1e-10


def test_every_rank_has_the_same_dh_and_decision(stout_runs):
    ranks = stout_runs[0]
    for tag in (*ACTIONS, "jax"):
        for res in ranks[1:]:
            assert res[f"{tag}_values"].tobytes() == ranks[0][f"{tag}_values"].tobytes(), tag
            assert bool(res[f"{tag}_accepted"]) == bool(ranks[0][f"{tag}_accepted"]), tag
