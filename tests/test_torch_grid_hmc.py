"""Quenched and two-flavour Wilson HMC on the port's process grid, on the CPU.

Each grid over 4^4 runs as a group of gloo processes (test_torch_grid's
run_ranks): the plaquette, the gauge force, the Polyakov loop, the clover
charge, the energy density and a 3x3 Wilson loop against the
single-process port to 1e-12; a quenched and a Wilson trajectory from
the JAX package's own draws (global arrays, each rank keeping its block)
against the single-process port and against the JAX package's HMC.step,
to dH 1e-8 and links 1e-10 (the bars of tests/test_sharding.py); a
trajectory from the run's generator against one process drawing from the
same seed; and every rank's dH and accept decision bitwise the same.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import GRID_IDS, GRIDS, rank_main, run_ranks  # noqa: E402

LAT = (4, 4, 4, 4)
BETA, KAPPA = 6.0, 0.141139
QUENCHED = dict(dtau=0.05, md_steps=4)
WILSON = dict(dtau=0.1, md_steps=4)


def _hmc(fermions: bool):
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA)) if fermions else None
    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=fa,
               **(WILSON if fermions else QUENCHED))


def _links(seed):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(LAT, 3, seed=seed, device="cpu")  # the block under a grid


def _draws(z, tag):
    from latticeqcd_torch.updates.hmc import Draws

    xi = (torch.from_numpy(z[f"{tag}_xi_re"]), torch.from_numpy(z[f"{tag}_xi_im"])) \
        if f"{tag}_xi_re" in z else None
    return Draws((torch.from_numpy(z[f"{tag}_mom_re"]), torch.from_numpy(z[f"{tag}_mom_im"])),
                 xi, float(z[f"{tag}_uniform"]))


def _trajectory(hmc, u, **kw):
    """(U' gathered (None off rank 0), [dH, sg_new, sp_new, sf_new, sf_old], accepted,
    the number of CG solves)."""
    u_new, st = hmc.step(u, **kw)
    return (mesh.to_host_global(u_new, lead=1),
            np.array([st["dH"], st["sg_new"], st["sp_new"], st["sf_new"], st["sf_old"]]),
            st["accepted"], len(st["cg"]))


def _observables():
    """Plaquette, gauge force, Polyakov loop, clover charge, energy density and a 3x3
    Wilson loop (longer than a block) on links seed 31."""
    from latticeqcd_torch.measurements import observables
    from latticeqcd_torch.ops import gauge_action as ga

    u = _links(31)
    return {"plaq": np.asarray(float(ga.mean_plaquette(u))),
            "force": mesh.to_host_global(ga.force(ga.wilson_gauge_action(3, BETA), u), lead=1),
            "poly": np.asarray(complex(observables.polyakov_loop(u))),
            "gauge": np.array([float(observables.topological_charge(u, "clover")),
                               float(observables.energy_density(u)),
                               float(observables.wilson_loop_rt(u, 3, 3))])}


def _case_hmc(grid, draws_file):
    z = dict(np.load(draws_file))
    out = {k: v for k, v in _observables().items() if v is not None}
    for tag, fermions, seed in (("quenched", False, 41), ("wilson", True, 43)):
        u_new, values, acc, ncg = _trajectory(_hmc(fermions), _links(seed), draws=_draws(z, tag))
        out.update({f"{tag}_values": values, f"{tag}_accepted": np.asarray(acc),
                    f"{tag}_cg": np.asarray(ncg)})
        if u_new is not None:
            out[f"{tag}_u"] = u_new
    u_new, values, acc, _ = _trajectory(_hmc(False), _links(47),
                                        generator=torch.Generator().manual_seed(48))
    out.update({"generator_values": values, "generator_accepted": np.asarray(acc)})
    if u_new is not None:
        out["generator_u"] = u_new
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _rank_main(argv):
    rank_main(argv, {"hmc": _case_hmc}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's trajectories and draws, and the single-process port's
    results; the draws are written for the rank groups."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA
    from latticeqcd_tpu.updates.hmc import HMC as JHMC
    from test_torch_hmc import jax_draws

    d = tmp_path_factory.mktemp("grid_hmc")
    draws_np, jax_out = {}, {}
    for tag, fermions, seed, kw in (("quenched", False, 41, QUENCHED), ("wilson", True, 43, WILSON)):
        u = jfields.hot_start(LAT, 3, seed=seed)
        key = jax.random.PRNGKey(seed + 1)
        fa = JFA(JW(kappa=KAPPA)) if fermions else None
        u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA), fermi_action=fa,
                            staged=False, **kw).step(u, key)
        pf_shape = _hmc(True).fermi_action.noise_shape(_links(seed)) if fermions else None
        dr = jax_draws(key, u, pf_shape=pf_shape)
        draws_np.update({f"{tag}_mom_re": dr.mom[0].numpy(), f"{tag}_mom_im": dr.mom[1].numpy(),
                         f"{tag}_uniform": np.asarray(dr.uniform)})
        if dr.xi is not None:
            draws_np.update({f"{tag}_xi_re": dr.xi[0].numpy(), f"{tag}_xi_im": dr.xi[1].numpy()})
        jax_out[tag] = (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))
    draws_file = os.path.join(d, "draws.npz")
    np.savez(draws_file, **draws_np)
    single = _observables()
    z = dict(np.load(draws_file))
    for tag, fermions, seed in (("quenched", False, 41), ("wilson", True, 43)):
        u_new, values, acc, ncg = _trajectory(_hmc(fermions), _links(seed), draws=_draws(z, tag))
        single.update({f"{tag}_u": u_new, f"{tag}_values": values, f"{tag}_accepted": acc,
                       f"{tag}_cg": ncg})
    u_new, values, acc, _ = _trajectory(_hmc(False), _links(47),
                                        generator=torch.Generator().manual_seed(48))
    single.update({"generator_u": u_new, "generator_values": values, "generator_accepted": acc})
    return draws_file, single, jax_out


@pytest.fixture(scope="module", params=GRIDS, ids=GRID_IDS)
def hmc_group(request, references, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_hmc_ranks")
    return request.param, run_ranks("test_torch_grid_hmc", "hmc", request.param, out,
                                    references[0])


# ------------------------------------------------------------------- tests


def test_plaquette_force_polyakov_match_single_process(hmc_group, references):
    """The gauge observables under the grid (sharded rolls, global sums and volumes)
    against one process, to 1e-12, on every rank."""
    pes, ranks = hmc_group
    single = references[1]
    for res in ranks:
        assert abs(float(res["plaq"]) - single["plaq"]) < 1e-12, pes
        assert abs(complex(res["poly"]) - complex(single["poly"])) < 1e-12, pes
        assert np.abs(res["gauge"] - single["gauge"]).max() < 1e-12, pes
    assert np.abs(ranks[0]["force"] - single["force"]).max() < 1e-12, pes


@pytest.mark.parametrize("tag", ["quenched", "wilson", "generator"])
def test_trajectory_matches_single_process(hmc_group, references, tag):
    """The sharded trajectory against the single-process port on the same draws: dH
    1e-8 (and the evolved action parts), the accept decision, links 1e-10; a Wilson
    trajectory with as many CG solves."""
    pes, ranks = hmc_group
    single = references[1]
    res = ranks[0]
    assert abs(res[f"{tag}_values"][0] - single[f"{tag}_values"][0]) < 1e-8, pes
    assert np.abs(res[f"{tag}_values"][1:] - single[f"{tag}_values"][1:]).max() < 1e-8, pes
    assert bool(res[f"{tag}_accepted"]) == bool(single[f"{tag}_accepted"]), pes
    assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-10, pes
    if tag == "wilson":
        assert int(res["wilson_cg"]) == single["wilson_cg"] == 5


@pytest.mark.parametrize("tag", ["quenched", "wilson"])
def test_trajectory_matches_jax(hmc_group, references, tag):
    """The sharded trajectory against the JAX package's HMC.step on its own key."""
    pes, ranks = hmc_group
    u_j, dh_j, acc_j = references[2][tag]
    assert abs(float(ranks[0][f"{tag}_values"][0]) - dh_j) < 1e-8, pes
    assert bool(ranks[0][f"{tag}_accepted"]) == acc_j, pes
    assert np.abs(ranks[0][f"{tag}_u"] - u_j).max() < 1e-10, pes


def test_every_rank_has_the_same_dh_and_decision(hmc_group):
    pes, ranks = hmc_group
    for tag in ("quenched", "wilson", "generator"):
        for res in ranks[1:]:
            assert res[f"{tag}_values"].tobytes() == ranks[0][f"{tag}_values"].tobytes(), pes
            assert bool(res[f"{tag}_accepted"]) == bool(ranks[0][f"{tag}_accepted"]), pes
