"""Domain-wall fermions on the port's process grid, on the CPU.

Two gloo processes on the grid (1, 1, 1, 2) over 4x4x2x4 at L5 = 4
(test_torch_grid's start_ranks). Every fifth-dimension slice goes through
its kernel's halo mode (on the CPU the plain halo versions, each slice's
faces exchanged first):

* the Schur operator Shat and its adjoint (2 L5 packed hops each) and the
  full 5D D (L5 full Wilson D), with the gradients of Re<g, A psi> with
  respect to the links (each slice's backward moving its backward links'
  gradients across the faces, autograd summing the slices) and the
  spinor, against one process to 1e-12;
* one trajectory from the JAX package's own draws (the noise cut to each
  rank's block after its fifth axis) against one process to 1e-12 and
  against the JAX package's HMC.step to dH 1e-8 and links 1e-10;
* the pseudofermion drawn from a Generator (the global field's normals,
  the block kept) against one process to 1e-12;
* every rank's dH and accept decision bitwise the same;
* scenario 11 of BASELINE.md (M = -1, m = 1, L5 = 4 on 4x4x2x2, cut along x
  so that every local extent stays even; 2 MD steps instead of its 20, from
  a hot start) through run_lqcd_params(grid=...) with the three domain-wall
  measurements, against one process.

One group of ranks runs both grids (the second over the same processes),
started on the JAX package's draws; it runs while the JAX package's
trajectory and the single-process references are computed.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_ranks  # noqa: E402
from test_torch_grid_staggered import _trajectory, assert_values_close  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 2, 4)
L5, MASS, M5 = 4, 0.3, -1.8
BETA = 5.7
MD = dict(dtau=0.1, md_steps=2)
SEED, KEY, GEN = 49, 50, 51


def _dirac():
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac

    return DomainwallDirac(MASS, M5, L5)


def _action():
    from latticeqcd_torch.ops.fermion_action import DomainwallFermiAction

    return DomainwallFermiAction(_dirac(), eps_cg=1e-22)


def _hmc():
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.updates.hmc import HMC

    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=_action(), **MD)


def _links(seed=SEED):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(LAT, 3, seed=seed, device="cpu")  # the block under a grid


def _operator_pieces(block):
    """Shat, Shat^dag and D on links seed 41 and the gradients of Re<g, A psi> (links,
    spinor) of each, gathered; ``block`` cuts a global 5D field to the fields' lattice."""
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    d = _dirac()
    rng = np.random.default_rng(42)
    full = (L5,) + LAT + (4, 3)
    packed = (L5, LAT[0] // 2) + LAT[1:] + (4, 3)
    normal = lambda shape: torch.from_numpy(block(  # noqa: E731
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
    ops = {"schur": (packed, lambda up, v: d.apply_schur(d.packed_links(up), v)),
           "schur_dagger": (packed, lambda up, v: d.apply_schur_dagger(d.packed_links(up), v)),
           "full": (full, lambda up, v: d.apply(up, v))}
    out = {}
    for name, (shape, op) in ops.items():
        psi, g = normal(shape), normal(shape)
        u = _links(41).requires_grad_(True)
        psi = psi.requires_grad_(True)
        y = op(apply_boundary_phases(u), psi)
        gu, gpsi = torch.autograd.grad(torch.real(torch.sum(g.conj() * y)), (u, psi))
        out.update({name: mesh.to_host_global(y.detach(), lead=1),
                    f"{name}_grad_u": mesh.to_host_global(gu, lead=1),
                    f"{name}_grad_psi": mesh.to_host_global(gpsi, lead=1)})
    return out


def _runs(block, draws_file):
    from test_torch_grid_staggered import _draws

    u_new, values, acc, ncg = _trajectory(_hmc(), _links(),
                                          draws=_draws(dict(np.load(draws_file)), "dw"))
    out = {"values": values, "accepted": np.asarray(acc), "cg": np.asarray(ncg), "u": u_new}
    s_old, phi = _action().sample_pseudofermion(_links(43),
                                                generator=torch.Generator().manual_seed(GEN))
    out.update({"s_old": np.asarray(float(s_old)), "phi": mesh.to_host_global(phi, lead=1)})
    out.update(_operator_pieces(block))
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _case_domainwall(grid, draws_file):
    return _runs(lambda a: grid.block(a, lead=1).copy(), draws_file)


SCENARIO11_LAT = (4, 4, 2, 2)
SCENARIO11_PES = (2, 1, 1, 1)


def _scenario11(grid, measuredir):
    """Scenario 11's run (test/test_domainwallhmc.toml's physics, cut in depth) with the
    three domain-wall measurements: the final plaquette, the history's dH, decisions and
    measured numbers, and the pion correlator at itrj 0 from its file (rank 0 writes it)."""
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    fp = {"Dirac_operator": "Domainwall", "Domainwall_m": 1.0, "Domainwall_M": -1.0,
          "Domainwall_L5": 4}
    # the pion correlator's 12 solves every second step: at itrj 0 only, read from its file
    methods = [{"methodname": m, "fermion_parameters": fp, "eps": 1e-18, "Nr": 1, "Neig": 3,
                "Nlanczos": 24, "measure_every": 2 if m == "Pion_correlator" else 1}
               for m in ("Chiral_condensate", "Pion_correlator", "Dirac_spectrum")]
    p = Params(L=SCENARIO11_LAT, NC=3, beta=5.7, update_method="HMC", quench=False,
               Dirac_operator="Domainwall", Domainwall_m=1.0, Domainwall_M=-1.0,
               Domainwall_L5=4, MDsteps=2, dtau=0.05, Nsteps=1, initial="hot", randomseed=111,
               eps=1e-19, verboselevel=0, measurement_methods=methods, measuredir=measuredir)
    history = []
    plaq = run_lqcd_params(p, device="cpu", grid=grid, history=history)
    out = {"scenario11_plaq": np.asarray(plaq),
           "scenario11_dh": np.array([r["dH"] for r in history]),
           "scenario11_accepted": np.array([r["accepted"] for r in history])}
    for name in ("Chiral_condensate", "Dirac_spectrum"):
        out[f"scenario11_{name}"] = np.array([np.hstack(r["measured"][name]) for r in history])
    if grid is None or grid.rank == 0:
        line = open(os.path.join(measuredir, "Pion_correlator.txt")).readline().split()
        assert line[0] == "0"
        out["scenario11_Pion_correlator"] = np.array([float(v) for v in line[1:]])
    return out


def _case_both(grid, draws_file, measuredir):
    """The domain-wall pieces on the grid (1, 1, 1, 2) over LAT, then scenario 11 on a
    grid of the same processes, (2, 1, 1, 1) over its own lattice."""
    out = _case_domainwall(grid, draws_file)
    out.update(_scenario11(mesh.make_process_grid(SCENARIO11_PES, SCENARIO11_LAT, "cpu"),
                           measuredir))
    return out


def _rank_main(argv):
    rank_main(argv, {"domainwall": _case_both}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX package's draws, written for the rank group, and the group started on them
    (the domain-wall pieces and scenario 11 in one group): it runs while the references
    are computed."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from test_torch_hmc import jax_draws

    u = jfields.hot_start(LAT, 3, seed=SEED)
    dr = jax_draws(jax.random.PRNGKey(KEY), u, _action().noise_shape(_links()))
    draws_file = os.path.join(tmp_path_factory.mktemp("grid_domainwall"), "draws.npz")
    np.savez(draws_file, dw_mom_re=dr.mom[0].numpy(), dw_mom_im=dr.mom[1].numpy(),
             dw_xi_re=dr.xi[0].numpy(), dw_xi_im=dr.xi[1].numpy(),
             dw_uniform=np.asarray(dr.uniform))
    group = start_ranks("test_torch_grid_domainwall", "domainwall", PES,
                        tmp_path_factory.mktemp("grid_domainwall_ranks"), draws_file,
                        tmp_path_factory.mktemp("grid_scenario11_measurements"))
    yield draws_file, group
    group.kill()


@pytest.fixture(scope="module")
def references(started, tmp_path_factory):
    """The JAX package's trajectory and the single-process port's results, scenario 11's
    included, computed while the rank group runs."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac as JD
    from latticeqcd_tpu.ops.fermion_action import DomainwallFermiAction as JFA
    from latticeqcd_tpu.updates.hmc import HMC as JHMC

    draws_file = started[0]
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA),
                        fermi_action=JFA(JD(MASS, M5, L5), eps_cg=1e-22), staged=False,
                        **MD).step(jfields.hot_start(LAT, 3, seed=SEED), jax.random.PRNGKey(KEY))
    jax_out = (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))
    single = _runs(lambda a: a, draws_file)
    single.update(_scenario11(None, str(tmp_path_factory.mktemp("grid_scenario11_single"))))
    return draws_file, single, jax_out


@pytest.fixture(scope="module")
def domainwall_group(started, references):
    return started[1].join()


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("what", ["", "_grad_u", "_grad_psi"], ids=["apply", "grad_u", "grad_psi"])
@pytest.mark.parametrize("op", ["schur", "schur_dagger", "full"])
def test_operator_matches_single_process(domainwall_group, references, op, what):
    """Shat, Shat^dag and D slice by slice through the halo modes, and their link and
    spinor gradients, against one process to 1e-12."""
    key = op + what
    got, want = domainwall_group[0][key], references[1][key]
    assert got.shape == want.shape and np.abs(want).max() > 1e-3, key
    assert np.abs(got - want).max() < 1e-12, key


def test_trajectory_matches_single_process(domainwall_group, references):
    """The sharded trajectory against one process on the same draws: the action parts to
    1e-12 relative, dH to 1e-12 of the action, the decision, links 1e-12, and one
    warm-started force solve per MD step with the final action's, as one process has."""
    res, single = domainwall_group[0], references[1]
    assert_values_close(res["values"], single["values"], "domainwall")
    assert bool(res["accepted"]) == bool(single["accepted"])
    assert np.abs(res["u"] - single["u"]).max() < 1e-12
    assert int(res["cg"]) == int(single["cg"]) == MD["md_steps"] + 1


def test_trajectory_matches_jax(domainwall_group, references):
    """The sharded trajectory against the JAX package's HMC.step on its own key."""
    u_j, dh_j, acc_j = references[2]
    res = domainwall_group[0]
    assert abs(float(res["values"][0]) - dh_j) < 1e-8
    assert bool(res["accepted"]) == acc_j
    assert np.abs(res["u"] - u_j).max() < 1e-10


def test_pseudofermion_from_a_generator_matches_single_process(domainwall_group, references):
    """phi = A_PV (A_PV^dag A_PV)^-1 A^dag xi with xi the global field's normals (the
    block kept after the fifth axis), and S_old, against one process to 1e-12."""
    res, single = domainwall_group[0], references[1]
    assert abs(float(res["s_old"]) - float(single["s_old"])) < 1e-12 * float(single["s_old"])
    assert np.abs(res["phi"] - single["phi"]).max() < 1e-12


def test_every_rank_has_the_same_dh_and_decision(domainwall_group):
    for res in domainwall_group[1:]:
        assert res["values"].tobytes() == domainwall_group[0]["values"].tobytes()
        assert bool(res["accepted"]) == bool(domainwall_group[0]["accepted"])
        assert res["s_old"].tobytes() == domainwall_group[0]["s_old"].tobytes()


@pytest.fixture(scope="module")
def scenario11(domainwall_group, references):
    """(one process's run, each rank's run) of scenario 11."""
    return references[1], domainwall_group


@pytest.mark.parametrize("what", ["plaq", "dh", "Chiral_condensate", "Pion_correlator",
                                  "Dirac_spectrum"])
def test_scenario11_run_matches_single_process(scenario11, what):
    """Scenario 11's domain-wall run under the grid (2, 1, 1, 1) through run_lqcd_params:
    the final plaquette and each measurement's numbers to 1e-12 of their size and each
    trajectory's dH to 1e-10 (the action it is a difference of is O(1000) here) against
    one process, the decisions equal, all bitwise the same on every rank."""
    single, ranks = scenario11
    key = f"scenario11_{what}"
    tol = 1e-10 if what == "dh" else 1e-12
    assert np.abs(ranks[0][key] - single[key]).max() <= tol * max(1.0, np.abs(single[key]).max())
    assert np.array_equal(ranks[0]["scenario11_accepted"], single["scenario11_accepted"])
    for res in ranks[1:]:  # the pion correlator's file is rank 0's alone
        assert key not in res or res[key].tobytes() == ranks[0][key].tobytes()
