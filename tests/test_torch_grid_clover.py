"""Clover-improved Wilson HMC and the full Wilson D on the port's process grid, on the CPU.

Each grid over 4^4 runs as a group of gloo processes (test_torch_grid's
run_ranks): the clover term (built from sharded rolls), the full D with
it (wilson_window's halo mode: on the CPU its plain halo version, the
faces exchanged first) and the gradients of Re<g, D psi> with respect to
the links and the spinor, each against the block of the single-process
port's to 1e-12; a clover trajectory from the JAX package's own draws
against the single-process port (to 1e-12) and the JAX package's HMC.step
(dH 1e-8, links 1e-10); every rank's dH and accept decision bitwise the
same. The JAX package compiles the whole trajectory, so it takes one MD
step.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import GRID_IDS, GRIDS, rank_main, run_ranks  # noqa: E402
from test_torch_grid_staggered import assert_values_close  # noqa: E402

LAT = (4, 4, 4, 4)
BETA, KAPPA, CSW = 5.3, 0.13625, 1.90952
MD = dict(dtau=0.1, md_steps=1)
SEED, KEY = 15, 16


def _hmc():
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA, csw=CSW), eps_cg=1e-22)
    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=fa, **MD)


def _operator_pieces(block):
    """The clover term, D psi and the gradients of Re<g, D psi> (links, spinor) on the
    links seed 21, each gathered to the global lattice (``block`` cuts the global
    spinor and cotangent to the fields' lattice)."""
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases

    d = WilsonDirac(kappa=KAPPA, csw=CSW)
    rng = np.random.default_rng(22)
    shape = LAT + (4, 3)
    psi, g = (torch.from_numpy(block(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
              for _ in range(2))
    u = fields.hot_start(LAT, 3, seed=21, device="cpu").requires_grad_(True)
    psi = psi.clone().requires_grad_(True)
    up = apply_boundary_phases(u)
    clover = d.clover_term(up)
    out = d.apply(up, psi, clover)
    gu, gpsi = torch.autograd.grad(torch.real(torch.sum(g.conj() * out)), (u, psi))
    gather = lambda t, lead=0: mesh.to_host_global(t.detach(), lead=lead)  # noqa: E731
    return {"clover": gather(clover), "dpsi": gather(out), "grad_u": gather(gu, 1),
            "grad_psi": gather(gpsi)}


def _runs(block, draws_file):
    from test_torch_grid_staggered import _trajectory

    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.updates.hmc import Draws

    z = dict(np.load(draws_file))
    draws = Draws((torch.from_numpy(z["mom_re"]), torch.from_numpy(z["mom_im"])),
                  (torch.from_numpy(z["xi_re"]), torch.from_numpy(z["xi_im"])), float(z["uniform"]))
    u_new, values, acc, ncg = _trajectory(_hmc(), fields.hot_start(LAT, 3, seed=SEED, device="cpu"),
                                          draws=draws)
    out = {"values": values, "accepted": np.asarray(acc), "cg": np.asarray(ncg), "u": u_new}
    out.update(_operator_pieces(block))
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _case_clover(grid, draws_file):
    return _runs(lambda a: grid.block(a).copy(), draws_file)


def _rank_main(argv):
    rank_main(argv, {"clover": _case_clover}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's clover trajectory and its draws, and the single-process
    port's results; the draws are written for the rank groups."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA
    from latticeqcd_tpu.updates.hmc import HMC as JHMC
    from test_torch_hmc import jax_draws

    from latticeqcd_torch.ops import fields

    u = jfields.hot_start(LAT, 3, seed=SEED)
    key = jax.random.PRNGKey(KEY)
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA),
                        fermi_action=JFA(JW(kappa=KAPPA, csw=CSW), eps_cg=1e-22), staged=False,
                        **MD).step(u, key)
    dr = jax_draws(key, u, pf_shape=_hmc().fermi_action.noise_shape(
        fields.hot_start(LAT, 3, seed=SEED, device="cpu")))
    draws_file = os.path.join(tmp_path_factory.mktemp("grid_clover"), "draws.npz")
    np.savez(draws_file, mom_re=dr.mom[0].numpy(), mom_im=dr.mom[1].numpy(),
             xi_re=dr.xi[0].numpy(), xi_im=dr.xi[1].numpy(), uniform=np.asarray(dr.uniform))
    jax_out = (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))
    return draws_file, _runs(lambda a: a, draws_file), jax_out


@pytest.fixture(scope="module", params=GRIDS, ids=GRID_IDS)
def clover_group(request, references, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_clover_ranks")
    return request.param, run_ranks("test_torch_grid_clover", "clover", request.param, out,
                                    references[0])


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("what", ["clover", "dpsi", "grad_u", "grad_psi"])
def test_operator_matches_single_process(clover_group, references, what):
    """The clover term, the full D with it through the halo mode, and the link and
    spinor gradients (the spinor's through the halo mode again, the links' through the
    sharded rolls), against one process to 1e-12."""
    pes, ranks = clover_group
    assert np.abs(ranks[0][what] - references[1][what]).max() < 1e-12, pes


def test_trajectory_matches_single_process(clover_group, references):
    pes, ranks = clover_group
    res, single = ranks[0], references[1]
    assert_values_close(res["values"], single["values"], pes)
    assert bool(res["accepted"]) == bool(single["accepted"]), pes
    assert np.abs(res["u"] - single["u"]).max() < 1e-12, pes
    assert int(res["cg"]) == int(single["cg"]) == MD["md_steps"] + 1


def test_trajectory_matches_jax(clover_group, references):
    """The sharded clover trajectory against the JAX package's HMC.step on its own key."""
    pes, ranks = clover_group
    u_j, dh_j, acc_j = references[2]
    assert abs(float(ranks[0]["values"][0]) - dh_j) < 1e-8, pes
    assert bool(ranks[0]["accepted"]) == acc_j, pes
    assert np.abs(ranks[0]["u"] - u_j).max() < 1e-10, pes


def test_every_rank_has_the_same_dh_and_decision(clover_group):
    pes, ranks = clover_group
    for res in ranks[1:]:
        assert res["values"].tobytes() == ranks[0]["values"].tobytes(), pes
        assert bool(res["accepted"]) == bool(ranks[0]["accepted"]), pes
