"""Hasenbusch mass preconditioning on the port's process grid, on the CPU.

Two gloo processes on the grid (1, 1, 1, 2) over 4^4 (test_torch_grid's
start_ranks), at csw = 0 (the packed Schur Dhat: wilson_hop_packed's halo
mode, the heavy solve's shift mu^2 and the i mu g5 term around it) and
with the clover term (the full D: wilson_window's halo mode), each with
and without the Sexton-Weingarten split:

* one trajectory from the JAX package's own draws (global arrays, both
  noises cut to each rank's block after their leading axis) against one
  process to 1e-12 and against the JAX package's HMC.step to dH 1e-8 and
  links 1e-10 (the bars of tests/test_sharding.py), with as many solves
  as one process (the split's heavy and light forces each warm-start
  from their own previous solution);
* the pseudofermion drawn from a Generator, and the heavy and light
  forces on it, against one process to 1e-12;
* every rank's dH and accept decision bitwise the same.

The rank group starts on the JAX package's draws and runs while the
JAX package's trajectories and the single-process references are
computed. The JAX package compiles each trajectory, so only the packed
split takes two MD steps (the light force's warm start); the others
take one.
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
LAT = (4, 4, 4, 4)
BETA, KAPPA, MU = 5.3, 0.13625, 0.5
CSWS = {"packed": 0.0, "clover": 1.90952}
# tag -> (operator, Sexton-Weingarten)
RUNS = {f"{op}_{'sw' if sw else 'plain'}": (op, sw) for op in CSWS for sw in (False, True)}
SEED, KEY, GEN = 15, 16, 17


def _md(op, sw):
    return dict(dtau=0.1, md_steps=2 if sw and op == "packed" else 1, sexton_weingarten=sw,
                nsw=2)


def _action(op):
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import HasenbuschWilsonFermiAction

    return HasenbuschWilsonFermiAction(WilsonDirac(kappa=KAPPA, csw=CSWS[op]), mu=MU,
                                       eps_cg=1e-22)


def _hmc(op, sw):
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.updates.hmc import HMC

    return HMC(action=ga.wilson_gauge_action(3, BETA), fermi_action=_action(op), **_md(op, sw))


def _links():
    from latticeqcd_torch.ops import fields

    return fields.hot_start(LAT, 3, seed=SEED, device="cpu")  # the block under a grid


def _forces(op):
    """The pseudofermion from a Generator, and the heavy and light forces on it."""
    fa = _action(op)
    u = _links()
    s_old, (phi1, phi2) = fa.sample_pseudofermion(u, generator=torch.Generator().manual_seed(GEN))
    gather = mesh.to_host_global
    return {f"{op}_s_old": np.asarray(float(s_old)), f"{op}_phi1": gather(phi1),
            f"{op}_phi2": gather(phi2),
            f"{op}_heavy": gather(fa.force_heavy(u, (phi1, phi2)), lead=1),
            f"{op}_light": gather(fa.force_light(u, (phi1, phi2)), lead=1)}


def _runs(draws_file):
    from test_torch_grid_staggered import _draws

    z = dict(np.load(draws_file))
    out = {}
    for tag, (op, sw) in RUNS.items():
        u_new, values, acc, ncg = _trajectory(_hmc(op, sw), _links(), draws=_draws(z, op))
        out.update({f"{tag}_values": values, f"{tag}_accepted": np.asarray(acc),
                    f"{tag}_cg": np.asarray(ncg), f"{tag}_u": u_new})
    for op in CSWS:
        out.update(_forces(op))
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _case_hasenbusch(grid, draws_file):
    return _runs(draws_file)


def _rank_main(argv):
    rank_main(argv, {"hasenbusch": _case_hasenbusch}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX package's draws, written for the rank group, and the group started on them:
    it runs while the references are computed."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from test_torch_hmc import jax_draws

    u = jfields.hot_start(LAT, 3, seed=SEED)
    key = jax.random.PRNGKey(KEY)
    draws = {}
    for op in CSWS:
        dr = jax_draws(key, u, _action(op).noise_shape(_links()), split_noises=True)
        draws.update({f"{op}_mom_re": dr.mom[0].numpy(), f"{op}_mom_im": dr.mom[1].numpy(),
                      f"{op}_xi_re": dr.xi[0].numpy(), f"{op}_xi_im": dr.xi[1].numpy(),
                      f"{op}_uniform": np.asarray(dr.uniform)})
    draws_file = os.path.join(tmp_path_factory.mktemp("grid_hasenbusch"), "draws.npz")
    np.savez(draws_file, **draws)
    group = start_ranks("test_torch_grid_hasenbusch", "hasenbusch", PES,
                        tmp_path_factory.mktemp("grid_hasenbusch_ranks"), draws_file)
    yield draws_file, group
    group.kill()


@pytest.fixture(scope="module")
def references(started):
    """The JAX package's trajectories and the single-process port's results, computed
    while the rank group runs."""
    import jax

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac as JW
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction as JH
    from latticeqcd_tpu.updates.hmc import HMC as JHMC

    draws_file = started[0]
    u = jfields.hot_start(LAT, 3, seed=SEED)
    key = jax.random.PRNGKey(KEY)
    jax_out = {}
    for tag, (op, sw) in RUNS.items():
        fa = JH(JW(kappa=KAPPA, csw=CSWS[op]), mu=MU, eps_cg=1e-22)
        u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, BETA), fermi_action=fa,
                            staged=False, **_md(op, sw)).step(u, key)
        jax_out[tag] = (np.asarray(u_j), float(st_j["dH"]), bool(st_j["accepted"]))
    return draws_file, _runs(draws_file), jax_out


@pytest.fixture(scope="module")
def hasenbusch_group(started, references):
    return started[1].join()


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("tag", list(RUNS))
def test_trajectory_matches_single_process(hasenbusch_group, references, tag):
    """The sharded trajectory against one process on the same draws: the evolved action
    parts to 1e-12 relative, dH to 1e-12 of the action, the decision, links 1e-12, and as
    many solves: per MD step one light force and nsw heavy ones with the split (each with
    its own warm start), else one total force of two solves; then the final action's two."""
    res, single = hasenbusch_group[0], references[1]
    assert_values_close(res[f"{tag}_values"], single[f"{tag}_values"], tag)
    assert bool(res[f"{tag}_accepted"]) == bool(single[f"{tag}_accepted"]), tag
    assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-12, tag
    op, sw = RUNS[tag]
    per_step = 1 + 2 if sw else 2
    assert int(res[f"{tag}_cg"]) == int(single[f"{tag}_cg"]) == \
        _md(op, sw)["md_steps"] * per_step + 2


@pytest.mark.parametrize("tag", list(RUNS))
def test_trajectory_matches_jax(hasenbusch_group, references, tag):
    """The sharded trajectory against the JAX package's HMC.step on its own key."""
    u_j, dh_j, acc_j = references[2][tag]
    res = hasenbusch_group[0]
    assert abs(float(res[f"{tag}_values"][0]) - dh_j) < 1e-8, tag
    assert bool(res[f"{tag}_accepted"]) == acc_j, tag
    assert np.abs(res[f"{tag}_u"] - u_j).max() < 1e-10, tag


@pytest.mark.parametrize("op", list(CSWS))
def test_pseudofermion_and_split_forces_match_single_process(hasenbusch_group, references, op):
    """phi1 and phi2 from a Generator (the global noises' blocks; phi2 through one heavy
    solve with global sums), S_old, and the heavy and light forces on them, against one
    process to 1e-12."""
    res, single = hasenbusch_group[0], references[1]
    assert abs(float(res[f"{op}_s_old"]) - float(single[f"{op}_s_old"])) < \
        1e-12 * float(single[f"{op}_s_old"])
    for what in ("phi1", "phi2", "heavy", "light"):
        key = f"{op}_{what}"
        assert np.abs(res[key] - single[key]).max() < 1e-12, key
        assert np.abs(single[key]).max() > 1e-3, key


def test_every_rank_has_the_same_dh_and_decision(hasenbusch_group):
    for tag in RUNS:
        for res in hasenbusch_group[1:]:
            assert res[f"{tag}_values"].tobytes() == hasenbusch_group[0][f"{tag}_values"].tobytes()
            assert bool(res[f"{tag}_accepted"]) == bool(hasenbusch_group[0][f"{tag}_accepted"])
