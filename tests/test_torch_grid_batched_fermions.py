"""Batched chains of staggered, clover Hasenbusch and domain-wall HMC on the port's
process grid, on the CPU.

One group of two gloo processes on the grid (1, 1, 1, 2) over 4x4x4x8
(test_torch_grid's start_ranks, one torch thread each), started before
the single-process references are computed here: two complex128 chains
of HMC.step_batched (2 MD steps) each of staggered Nf = 4 (the two halo
launches of the grid W with a chain axis, the faces of d1 between them),
clover Hasenbusch with the Sexton-Weingarten split (the window D's
chain-halo form, the clover term's sharded rolls under vmap) and domain
wall at L5 = 2 (each fifth-dimension slice of both chains one chain-halo
hop), against one process's step_batched: dH 1e-8 and links 1e-10 per
chain, the same decisions, every rank's dH bitwise equal. Wilson on the
grid, the chain split and mixed MD are in test_torch_grid_batched.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_ranks  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 4, 8)
SEEDS = (51, 52)
KINDS = ("staggered", "clover_hasenbusch", "domainwall")


def _hmc(kind, lattice):
    """The HMC of ``kind``; ``lattice`` is what the staggered operator acts on (the block's
    extents under a grid)."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                     HasenbuschWilsonFermiAction,
                                                     StaggeredFermiAction)
    from latticeqcd_torch.updates.hmc import HMC

    sw = kind == "clover_hasenbusch"
    if kind == "staggered":
        fa = StaggeredFermiAction(StaggeredDirac(0.5, lattice), nf=4, eps_cg=1e-22)
    elif sw:
        fa = HasenbuschWilsonFermiAction(WilsonDirac(kappa=0.13625, csw=1.90952), mu=0.5,
                                         eps_cg=1e-22)
    else:
        fa = DomainwallFermiAction(DomainwallDirac(0.3, -1.8, 2), eps_cg=1e-22)
    return HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2, fermi_action=fa,
               sexton_weingarten=sw, nsw=2)


def _run(kind, lattice):
    """(dH, accepted, the links gathered on every rank) of two chains from their
    generators."""
    from latticeqcd_torch.ops import fields

    us = torch.stack([fields.hot_start(LAT, 3, seed=s, device="cpu") for s in SEEDS])
    gens = [torch.Generator().manual_seed(100 + s) for s in SEEDS]
    u, st = _hmc(kind, lattice).step_batched(us, gens)
    return {f"{kind}_dh": st["dH"].numpy(), f"{kind}_accepted": st["accepted"].numpy(),
            f"{kind}_u": mesh.to_host_global(u, lead=2, all_ranks=True)}


def _case_fermions(grid):
    out = {}
    for kind in KINDS:
        out.update(_run(kind, grid.local))
    return out


def _rank_main(argv):
    rank_main(argv, {"fermions": _case_fermions}, lattice=LAT)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_batched_fermions")
    started = start_ranks("test_torch_grid_batched_fermions", "fermions", PES, out)
    yield started
    started.kill()


@pytest.fixture(scope="module")
def references(group):
    """One process's step_batched of each action, computed while the ranks run."""
    out = {}
    for kind in KINDS:
        out.update(_run(kind, LAT))
    return out


@pytest.fixture(scope="module")
def ranks(group, references):
    return group.join()


@pytest.mark.parametrize("kind", KINDS)
def test_lattice_grid_batched_equals_one_process(ranks, references, kind):
    """Two chains on the lattice cut in two along t against one process's step_batched:
    per chain dH 1e-8 and links 1e-10, the same decisions, both ranks' dH bitwise equal."""
    res = ranks[0]
    assert np.abs(res[f"{kind}_dh"] - references[f"{kind}_dh"]).max() < 1e-8
    assert np.array_equal(res[f"{kind}_accepted"], references[f"{kind}_accepted"])
    assert np.abs(res[f"{kind}_u"] - references[f"{kind}_u"]).max() < 1e-10
    assert ranks[1][f"{kind}_dh"].tobytes() == res[f"{kind}_dh"].tobytes()
