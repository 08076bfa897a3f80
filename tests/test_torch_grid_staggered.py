"""Staggered HMC and RHMC on the port's process grid, on the CPU.

Each grid over 4^4 runs as a group of gloo processes (test_torch_grid's
run_ranks): an Nf = 4 HMC and an Nf = 2 RHMC trajectory from the JAX
package's own draws (global arrays; the packed pseudofermion noise keeps
its lattice axes after the pseudofermion axis, so each rank cuts it
there) against the single-process port to 1e-12 and against the JAX
package's HMC.step to dH 1e-8 and links 1e-10 (the bars of
tests/test_sharding.py); an Nf = 4 trajectory from the run's generator
against one process drawing from the same seed; the RHMC spectral guard's
Lanczos range against one process; every rank's dH and accept decision
bitwise the same. Without processes: the KS signs, the parity mask and
the packed signs of every block are the blocks of the global fields.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import GRID_IDS, GRIDS, rank_main, run_ranks  # noqa: E402

LAT = (4, 4, 4, 4)
BETA, MASS = 5.7, 0.5
MD = dict(dtau=0.1, md_steps=2)
# tag -> (Nf, links seed, JAX key seed)
RUNS = {"nf4": (4, 84, 94), "nf2": (2, 82, 92)}


def _hmc(nf, lattice):
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    fa = StaggeredFermiAction(StaggeredDirac(MASS, tuple(lattice)), nf=nf)
    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=fa, **MD)


def _links(seed):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(LAT, 3, seed=seed, device="cpu")  # the block under a grid


def _draws(z, tag):
    from latticeqcd_torch.updates.hmc import Draws

    return Draws((torch.from_numpy(z[f"{tag}_mom_re"]), torch.from_numpy(z[f"{tag}_mom_im"])),
                 (torch.from_numpy(z[f"{tag}_xi_re"]), torch.from_numpy(z[f"{tag}_xi_im"])),
                 float(z[f"{tag}_uniform"]))


def _trajectory(hmc, u, **kw):
    """(U' gathered (None off rank 0), [dH, sg_new, sp_new, sf_new, sf_old], accepted,
    the number of solves)."""
    u_new, st = hmc.step(u, **kw)
    return (mesh.to_host_global(u_new, lead=1),
            np.array([st["dH"], st["sg_new"], st["sp_new"], st["sf_new"], st["sf_old"]]),
            st["accepted"], len(st["cg"]))


def _runs(lattice, draws_file):
    """Every trajectory of the file on the fields of ``lattice`` (the block's under a
    grid), and the spectral guard's range."""
    z = dict(np.load(draws_file))
    out = {}
    for tag, (nf, seed, _) in RUNS.items():
        u_new, values, acc, ncg = _trajectory(_hmc(nf, lattice), _links(seed), draws=_draws(z, tag))
        out.update({f"{tag}_values": values, f"{tag}_accepted": np.asarray(acc),
                    f"{tag}_cg": np.asarray(ncg), f"{tag}_u": u_new})
    u_new, values, acc, _ = _trajectory(_hmc(4, lattice), _links(47),
                                        generator=torch.Generator().manual_seed(48))
    out.update({"generator_values": values, "generator_accepted": np.asarray(acc),
                "generator_u": u_new})
    out["range"] = np.array(_hmc(2, lattice).fermi_action.spectral_range_w(_links(51), m=12))
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _case_staggered(grid, draws_file):
    return _runs(grid.local, draws_file)


def _rank_main(argv):
    rank_main(argv, {"staggered": _case_staggered}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's trajectories and draws, and the single-process port's
    results; the draws are written for the rank groups."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac import staggered as js
    from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction as JSFA
    from latticeqcd_tpu.updates.hmc import HMC as JHMC
    from test_torch_rhmc import jax_draws

    d = tmp_path_factory.mktemp("grid_staggered")
    draws_np, jax_out = {}, {}
    for tag, (nf, seed, kseed) in RUNS.items():
        u = jfields.hot_start(LAT, 3, seed=seed)
        key = jax.random.PRNGKey(kseed)
        fa = JSFA(js.StaggeredDirac(MASS, LAT), nf=nf)
        u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA), fermi_action=fa,
                            staged=False, **MD).step(u, key)
        dr = jax_draws(key, u, _hmc(nf, LAT).fermi_action)
        draws_np.update({f"{tag}_mom_re": dr.mom[0].numpy(), f"{tag}_mom_im": dr.mom[1].numpy(),
                         f"{tag}_xi_re": dr.xi[0].numpy(), f"{tag}_xi_im": dr.xi[1].numpy(),
                         f"{tag}_uniform": np.asarray(dr.uniform)})
        jax_out[tag] = (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))
    draws_file = os.path.join(d, "draws.npz")
    np.savez(draws_file, **draws_np)
    return draws_file, _runs(LAT, draws_file), jax_out


@pytest.fixture(scope="module", params=GRIDS, ids=GRID_IDS)
def staggered_group(request, references, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_staggered_ranks")
    return request.param, run_ranks("test_torch_grid_staggered", "staggered", request.param, out,
                                    references[0])


# ------------------------------------------------------------------- tests


def assert_values_close(got, want, what, rel=1e-12):
    """[dH, action parts...]: each part to ``rel`` of its size, dH to ``rel`` of the
    largest part."""
    scale = np.maximum(np.abs(want), 1.0)
    assert abs(got[0] - want[0]) < rel * scale[1:].max(), (what, got[0], want[0])
    assert (np.abs(got[1:] - want[1:]) < rel * scale[1:]).all(), (what, got, want)


@pytest.mark.parametrize("tag", ["nf4", "nf2", "generator"])
def test_trajectory_matches_single_process(staggered_group, references, tag):
    """The sharded trajectory against the single-process port on the same draws (the
    generator's: the same seed): the evolved action parts to 1e-12 relative, dH to 1e-12
    of the action it is a difference of (the sums over blocks round in another order),
    the accept decision, links 1e-12, as many solves."""
    pes, ranks = staggered_group
    single = references[1]
    res = ranks[0]
    assert_values_close(res[f"{tag}_values"], single[f"{tag}_values"], pes)
    assert bool(res[f"{tag}_accepted"]) == bool(single[f"{tag}_accepted"]), pes
    assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-12, pes
    if tag != "generator":
        assert int(res[f"{tag}_cg"]) == int(single[f"{tag}_cg"]) == MD["md_steps"] + 1


@pytest.mark.parametrize("tag", list(RUNS))
def test_trajectory_matches_jax(staggered_group, references, tag):
    """The sharded trajectory against the JAX package's HMC.step on its own key."""
    pes, ranks = staggered_group
    u_j, dh_j, acc_j = references[2][tag]
    assert abs(float(ranks[0][f"{tag}_values"][0]) - dh_j) < 1e-8, pes
    assert bool(ranks[0][f"{tag}_accepted"]) == acc_j, pes
    assert np.abs(ranks[0][f"{tag}_u"] - u_j).max() < 1e-10, pes


def test_spectral_guard_matches_single_process(staggered_group, references):
    """The RHMC guard's Lanczos range of W (global inner products and
    re-orthogonalisation, a global start vector) on every rank against one process."""
    pes, ranks = staggered_group
    for res in ranks:
        assert np.abs(res["range"] - references[1]["range"]).max() < 1e-12, pes
        assert res["range"].tobytes() == ranks[0]["range"].tobytes(), pes


def test_every_rank_has_the_same_dh_and_decision(staggered_group):
    pes, ranks = staggered_group
    for tag in (*RUNS, "generator"):
        for res in ranks[1:]:
            assert res[f"{tag}_values"].tobytes() == ranks[0][f"{tag}_values"].tobytes(), pes
            assert bool(res[f"{tag}_accepted"]) == bool(ranks[0][f"{tag}_accepted"]), pes


@pytest.mark.parametrize("pes", GRIDS, ids=GRID_IDS)
def test_block_signs_and_parity_are_the_global_blocks(pes):
    """Every block's own KS signs, even-site mask and packed signs of both parities
    (made from the block's extents, as the operator under a grid makes them) are the
    blocks of the global fields: every local origin is even."""
    from latticeqcd_torch.ops.dirac import staggered_kernel
    from latticeqcd_torch.ops.dirac.staggered import ks_phases

    lat = (8, 4, 4, 8)
    eta, even = ks_phases(lat)
    packed = [torch.from_numpy(np.array(staggered_kernel.packed_eta_signs(lat, p)))
              for p in (0, 1)]
    for rank in range(int(np.prod(pes))):
        grid = mesh.ProcessGrid(pes, lat, rank=rank)
        eta_b, even_b = ks_phases(grid.local)
        assert np.array_equal(eta_b, grid.block(torch.from_numpy(eta), lead=1).numpy())
        assert np.array_equal(even_b, grid.block(torch.from_numpy(even)).numpy())
        for p in (0, 1):
            mine = np.array(staggered_kernel.packed_eta_signs(grid.local, p))
            assert np.array_equal(mine, grid.block(packed[p]).numpy()), (rank, p)
