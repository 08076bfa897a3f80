"""The self-learning updaters, the dense log det and Fileloading on the port's process
grid, on the CPU.

Two gloo processes on the grid (1, 1, 1, 2) (test_torch_grid's start_ranks; the JAX
package's and the single-process references are computed while the ranks run):

* SLHMC with two-flavour Wilson fermions on 4x4x2x4, two trajectories from the JAX
  package's own draws (global arrays, each rank's block kept): the second refits
  beta_eff from the loop values, global sums the same on every rank; against one
  process to 1e-12 and against the JAX package's SLHMC.step to dH 1e-8 and links
  1e-10 (the bars of tests/test_sharding.py);
* SLMC, quenched SU(2) on 4x4x2x4 from beta_eff 1.2: two steps of
  sweep_with_coeffs on the JAX package's key schedule (each rank replays it for the
  global field through test_torch_heatbath's JaxUniforms and keeps its block) and
  the Metropolis uniform of its key, against the JAX package's SLMC.step and one
  process; two steps from the run's generator against one process drawing from the
  same seed, with the generator's state; an overrelaxation with coefficients;
* the dense log det on 2x2x2x4 (each rank applies D, or staggered W in two halo
  launches, to its block of every unit vector and the row slabs are gathered once):
  Wilson, clover and staggered against the JAX package's dense_logdet_fermi_action
  to 1e-10 relative and one process to 1e-12, bitwise on every rank;
* IntegratedHMC with the Wilson log det, and IntegratedHB with the staggered one
  through run_lqcd_params(grid=...) (updates/factory.py's _exact_logdet on the global
  lattice), against one process;
* a Fileloading run over NPZ configurations and over a two-record ILDG file, with
  the plaquette, the Polyakov loop and the energy density: every rank's block of
  the last configuration the one-process load's, bit for bit, and rank 0's
  measurement lines against one process's to 1e-12 and the JAX driver's;
* every rank's dH, decision and beta_eff bitwise the same.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_ranks  # noqa: E402
from test_torch_grid_heatbath import _GlobalUniforms  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 2, 4)
DENSE_LAT = (2, 2, 2, 4)
BETA, KAPPA = 5.7, 0.13
SLHMC_KW = dict(dtau=0.02, md_steps=4, beta_eff=5.5, firstlearn=2)
SLMC_KW = dict(beta_eff=1.2, firstlearn=1)
# the dense log dets: tag -> (Dirac operator, its arguments, weight)
DENSE = {"wilson": ("Wilson", dict(kappa=KAPPA), 1.0),
         "clover": ("Wilson", dict(kappa=KAPPA, csw=1.5), 1.0),
         "staggered": ("Staggered", dict(mass=0.5), 0.5)}
# the fermionic measurements on the grid are held in test_torch_grid_measurements*.py
METHODS = [{"methodname": "Plaquette"}, {"methodname": "Polyakov_loop"},
           {"methodname": "Energy_density"}]
MEASURED = ("Plaquette", "Polyakov_loop", "Energy_density")
FILES = {"NPZ": "confs_npz", "ILDG": "confs_ildg"}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _links(lat, nc, seed):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(lat, nc, seed=seed, device="cpu")  # the block under a grid


def _gather(u):
    return mesh.to_host_global(u, lead=1, all_ranks=True)


def _stats(st):
    return np.array([st["dH"], *st.get("beta_eff", ())])


# ------------------------------------------------------------------ SLHMC


def _wilson_action(**kw):
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction

    return WilsonFermiAction(WilsonDirac(**(kw or dict(kappa=KAPPA))), eps_cg=1e-22)


def _slhmc(z):
    """Two SLHMC trajectories from the draws of the file."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.updates.slhmc import SLHMC
    from test_torch_grid_staggered import _draws

    up = SLHMC(ga.wilson_gauge_action(3, BETA), fermi_action=_wilson_action(), **SLHMC_KW)
    u, out = _links(LAT, 3, 71), {}
    for i in range(2):
        u, st = up.step(u, draws=_draws(z, f"slhmc{i}"))
        out.update({f"slhmc{i}_stats": _stats(st), f"slhmc{i}_accepted": np.asarray(st["accepted"]),
                    f"slhmc{i}_u": _gather(u), f"slhmc{i}_cg": np.asarray(len(st["cg"]))})
    return out


# ------------------------------------------------------------------- SLMC


def _slmc(grid):
    """Two SLMC steps on the JAX key schedule, two from a generator, and an
    overrelaxation with coefficients on the last links."""
    jax = _jax()
    from test_torch_heatbath import JaxUniforms

    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.updates.slhmc import SLMC

    act = ga.wilson_gauge_action(2, 1.9)
    up, u, key, out = SLMC(act, **SLMC_KW), _links(LAT, 2, 72), jax.random.PRNGKey(73), {}
    for i in range(2):
        k_sweep, k_acc = jax.random.split(key)
        src = JaxUniforms(k_sweep)
        u, st = up.step(u, uniforms=_GlobalUniforms(src, grid),
                        uniform=float(jax.random.uniform(k_acc, dtype=np.float64)))
        key = src.key
        out.update({f"slmc{i}_stats": _stats(st), f"slmc{i}_accepted": np.asarray(st["accepted"]),
                    f"slmc{i}_u": _gather(u)})
    coeffs = torch.as_tensor(up.beta_eff, dtype=torch.float64)
    out["slmc_or_u"] = _gather(up.hb.overrelax_with_coeffs(u, coeffs))
    up, u, gen = SLMC(act, **SLMC_KW), _links(LAT, 2, 74), torch.Generator().manual_seed(75)
    for i in range(2):
        u, st = up.step(u, gen)
        out.update({f"slmc_gen{i}_stats": _stats(st), f"slmc_gen{i}_u": _gather(u)})
    out["slmc_gen_state"] = gen.get_state().numpy()
    return out


# ----------------------------------------------------------- the dense log det


def _dirac(tag, lattice):
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac

    kind, kw, _ = DENSE[tag]
    return WilsonDirac(**kw) if kind == "Wilson" else StaggeredDirac(lattice=lattice, **kw)


def _psi_shape(tag):
    return DENSE_LAT + ((4, 3) if DENSE[tag][0] == "Wilson" else (3,))


def _dense(grid):
    """The three log dets, IntegratedHMC with the Wilson one and IntegratedHB with the
    staggered one through run_lqcd_params, on DENSE_LAT."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.slhmc import dense_logdet_fermi_action, integrated_hmc

    local = DENSE_LAT if grid is None else grid.local
    u = _links(DENSE_LAT, 3, 76)
    out = {}
    for tag in DENSE:
        sf = dense_logdet_fermi_action(_dirac(tag, local), _psi_shape(tag), DENSE[tag][2])
        out[f"logdet_{tag}"] = np.asarray(float(sf(apply_boundary_phases(u))))
    sf = dense_logdet_fermi_action(_dirac("wilson", local), _psi_shape("wilson"), 1.0)
    up = integrated_hmc(ga.wilson_gauge_action(3, BETA), 0.05, 2,
                        fermi_logdet=lambda uu: sf(apply_boundary_phases(uu)))
    u_new, st = up.step(u, torch.Generator().manual_seed(77))
    out.update({"ihmc_stats": _stats(st), "ihmc_accepted": np.asarray(st["accepted"]),
                "ihmc_u": _gather(u_new),
                "ihmc_sf": np.array([st["sf_old"], st["sf_new"]])})
    history, final = [], {}
    p = Params(L=DENSE_LAT, NC=3, beta=BETA, initial="hot", update_method="IntegratedHB",
               quench=False, Dirac_operator="Staggered", mass=0.5, Nf=4, Nsteps=2,
               randomseed=78, verboselevel=0, measurement_methods=[])
    run_lqcd_params(p, make_dirs=False, device="cpu", grid=grid, history=history, final=final)
    out.update({"ihb_stats": np.array([h["dH"] for h in history]),
                "ihb_accepted": np.array([h["accepted"] for h in history]),
                "ihb_u": _gather(final["u"])})
    return out


def _dense_grid(grid):
    """_dense under a grid of the same PEs over DENSE_LAT."""
    if grid is None:
        return _dense(None)
    dense_grid = mesh.make_process_grid(grid.pes, DENSE_LAT, "cpu")
    with mesh.use_grid(dense_grid):
        return _dense(dense_grid)


# -------------------------------------------------------------- Fileloading


def _fileloading(grid, confdir, workdir):
    """A Fileloading run over each stored set: the measurement lines (rank 0's files)
    and the block of the last configuration."""
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    out = {}
    for fmt, sub in FILES.items():
        measuredir = os.path.join(workdir, fmt)
        final, history = {}, []
        p = Params(L=LAT, NC=3, beta=6.0, update_method="Fileloading", loadU_format=fmt,
                   loadU_dir=os.path.join(confdir, sub), verboselevel=0,
                   measurement_methods=METHODS, measuredir=measuredir)
        run_lqcd_params(p, device="cpu", grid=grid, history=history, final=final)
        out[f"load_{fmt}_steps"] = np.asarray(len(history))
        out[f"load_{fmt}_block"] = final["u"].numpy()
        if grid is not None:
            torch.distributed.barrier()  # rank 0's files are closed
        for name in MEASURED:
            out[f"load_{fmt}_{name}"] = np.array(
                open(os.path.join(measuredir, f"{name}.txt")).read().splitlines())
    return out


def _runs(grid, draws_file, confdir, workdir):
    out = _slhmc(dict(np.load(draws_file)))
    out.update(_slmc(grid))
    out.update(_dense_grid(grid))
    out.update(_fileloading(grid, confdir, workdir))
    return {k: np.asarray(v) for k, v in out.items()}


def _case_selflearning(grid, draws_file, confdir, workdir):
    return _runs(grid, draws_file, confdir, workdir)


def _rank_main(argv):
    rank_main(argv, {"selflearning": _case_selflearning}, lattice=LAT)


# ------------------------------------------------- references, in the parent


def _store(confdir):
    """Three hot configurations as NPZ files, and two of them as one ILDG file."""
    from latticeqcd_torch.io import save_ildg, save_u

    os.makedirs(os.path.join(confdir, FILES["NPZ"]))
    os.makedirs(os.path.join(confdir, FILES["ILDG"]))
    with mesh.use_grid(None):
        us = [_links(LAT, 3, 80 + i).numpy() for i in range(3)]
    for i, u in enumerate(us):
        save_u(os.path.join(confdir, FILES["NPZ"], f"conf_{i + 1:08d}.npz"), u)
    ildg = os.path.join(confdir, FILES["ILDG"], "confs.ildg")
    save_ildg(ildg, us[0])
    save_ildg(ildg, us[1], append=True)


def _jax_references(confdir, workdir):
    """The JAX package's SLHMC and SLMC chains, dense log dets and Fileloading
    measurement lines."""
    jax = _jax()
    import jax.numpy as jnp

    from latticeqcd_tpu.ops.dirac import staggered as js
    from latticeqcd_tpu.ops.dirac import wilson as jw
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction as JFA
    from latticeqcd_tpu.system import lqcd as jlqcd
    from latticeqcd_tpu.system.params import Params as JParams
    from latticeqcd_tpu.updates import slhmc as jsl

    out = {}
    chains = {"slhmc": (jsl.SLHMC(jga.wilson_gauge_action(3, BETA), fermi_action=JFA(
        jw.WilsonDirac(kappa=KAPPA), eps_cg=1e-22), **SLHMC_KW), 3, 71, 79),
        "slmc": (jsl.SLMC(jga.wilson_gauge_action(2, 1.9), **SLMC_KW), 2, 72, 73)}
    for kind, (up, nc, seed, key_seed) in chains.items():
        u, key = jnp.asarray(_links(LAT, nc, seed).numpy()), jax.random.PRNGKey(key_seed)
        for i in range(2):
            u, key, st = up.step(u, key)
            out.update({f"{kind}{i}_u": np.asarray(u), f"{kind}{i}_stats": _stats(st),
                        f"{kind}{i}_accepted": np.asarray(bool(st["accepted"]))})
    up_j = jw.apply_boundary_phases(jnp.asarray(_links(DENSE_LAT, 3, 76).numpy()), (1, 1, 1, -1))
    for tag, (kind, kw, weight) in DENSE.items():
        d = jw.WilsonDirac(**kw) if kind == "Wilson" else js.StaggeredDirac(lattice=DENSE_LAT, **kw)
        out[f"logdet_{tag}"] = np.asarray(float(jsl.dense_logdet_fermi_action(
            d, _psi_shape(tag), weight)(up_j)))
    for fmt, sub in FILES.items():
        measuredir = os.path.join(workdir, fmt)
        jlqcd.run_lqcd_params(JParams(L=LAT, NC=3, beta=6.0, update_method="Fileloading",
                                      loadU_format=fmt, loadU_dir=os.path.join(confdir, sub),
                                      verboselevel=0, measurement_methods=METHODS,
                                      measuredir=measuredir))
        for name in MEASURED:
            out[f"load_{fmt}_{name}"] = open(os.path.join(measuredir, f"{name}.txt")).read(
            ).splitlines()
    return out


def _slhmc_draws(draws_file):
    """The JAX package's draws of the two SLHMC trajectories (its key after a trajectory
    is the first of the four it splits), written for the ranks."""
    jax = _jax()
    import jax.numpy as jnp

    from test_torch_hmc import jax_draws

    u = jnp.asarray(_links(LAT, 3, 71).numpy())
    pf_shape = _wilson_action().noise_shape(_links(LAT, 3, 71))
    key, z = jax.random.PRNGKey(79), {}
    for i in range(2):
        dr = jax_draws(key, u, pf_shape)
        z.update({f"slhmc{i}_mom_re": dr.mom[0].numpy(), f"slhmc{i}_mom_im": dr.mom[1].numpy(),
                  f"slhmc{i}_xi_re": dr.xi[0].numpy(), f"slhmc{i}_xi_im": dr.xi[1].numpy(),
                  f"slhmc{i}_uniform": np.asarray(dr.uniform)})
        key = jax.random.split(key, 4)[0]
    np.savez(draws_file, **z)


@pytest.fixture(scope="module")
def selflearning_runs(tmp_path_factory):
    """(the rank group's results, the single-process port's, the JAX package's): the
    references are computed while the ranks run."""
    base = tmp_path_factory.mktemp("grid_selflearning")
    draws_file, confdir = str(base / "draws.npz"), str(base / "confs")
    _slhmc_draws(draws_file)
    _store(confdir)
    os.makedirs(base / "ranks")
    group = start_ranks("test_torch_grid_selflearning", "selflearning", PES, base / "ranks",
                        draws_file, confdir, str(base / "work"))
    try:
        jax_out = _jax_references(confdir, str(base / "jax"))
        single = _runs(None, draws_file, confdir, str(base / "single"))
        ranks = group.join()
    finally:
        group.kill()
    return ranks, single, jax_out


# ------------------------------------------------------------------- tests


def _close(got, want, what, tol=1e-12):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - np.asarray(want)).max() < tol * scale, (what, got, want)


@pytest.mark.parametrize("kind,i", [("slhmc", 0), ("slhmc", 1), ("slmc", 0), ("slmc", 1)])
def test_self_learning_step_matches_single_process_and_jax(selflearning_runs, kind, i):
    """A step of SLHMC (two-flavour Wilson) or SLMC (quenched SU(2)) on the JAX package's
    draws: dH and beta_eff against one process to 1e-12 and against the JAX package's step
    to 1e-8 (beta_eff to 1e-7 relative, as the single-process parity tests), the
    decision, the links to 1e-12 and 1e-10."""
    ranks, single, jax_out = selflearning_runs
    res, tag = ranks[0], f"{kind}{i}"
    _close(res[f"{tag}_stats"], single[f"{tag}_stats"], tag)
    assert bool(res[f"{tag}_accepted"]) == bool(single[f"{tag}_accepted"]), tag
    assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-12, tag
    u_j, stats_j, acc_j = (jax_out[f"{tag}_{k}"] for k in ("u", "stats", "accepted"))
    assert abs(res[f"{tag}_stats"][0] - stats_j[0]) < 1e-8, tag
    assert np.abs(res[f"{tag}_stats"][1:] - stats_j[1:]).max() < 1e-7 * np.abs(stats_j[1:]).max()
    assert bool(res[f"{tag}_accepted"]) == acc_j, tag
    assert np.abs(res[f"{tag}_u"] - u_j).max() < 1e-10, tag
    if kind == "slhmc":  # one solve a trajectory: the final action (the MD is gluonic)
        assert int(res[f"{tag}_cg"]) == int(single[f"{tag}_cg"]) == 1


def test_self_learning_refits_beta_eff(selflearning_runs):
    """The second SLHMC trajectory and the first SLMC step refit beta_eff: it moved from
    its start, and every rank holds the same couplings bit for bit."""
    ranks = selflearning_runs[0]
    assert ranks[0]["slhmc1_stats"][1] != SLHMC_KW["beta_eff"]
    assert ranks[0]["slmc0_stats"][1] != SLMC_KW["beta_eff"]
    for tag in ("slhmc0", "slhmc1", "slmc0", "slmc1", "slmc_gen0", "slmc_gen1", "ihmc"):
        for res in ranks[1:]:
            assert res[f"{tag}_stats"].tobytes() == ranks[0][f"{tag}_stats"].tobytes(), tag


def test_slmc_from_the_generator_matches_single_process(selflearning_runs):
    """Two SLMC steps drawn from one seed: the links and beta_eff against one process
    drawing from the same seed, and its generator's state on every rank (the sweeps'
    early stop is a global decision)."""
    ranks, single, _ = selflearning_runs
    for res in ranks:
        for i in range(2):
            _close(res[f"slmc_gen{i}_stats"], single[f"slmc_gen{i}_stats"], i)
            assert np.abs(res[f"slmc_gen{i}_u"] - single[f"slmc_gen{i}_u"]).max() < 1e-12
        assert np.array_equal(res["slmc_gen_state"], single["slmc_gen_state"])


def test_overrelax_with_coeffs_matches_single_process(selflearning_runs):
    """An overrelaxation sweep under the learnt couplings (the global colours of the
    plaquette basis) against one process to 1e-12."""
    ranks, single, _ = selflearning_runs
    for res in ranks:
        assert np.abs(res["slmc_or_u"] - single["slmc_or_u"]).max() < 1e-12
    assert np.abs(single["slmc_or_u"] - single["slmc1_u"]).max() > 1e-3


@pytest.mark.parametrize("tag", list(DENSE))
def test_dense_logdet_matches_single_process_and_jax(selflearning_runs, tag):
    """-w log det(D^dag D) from the gathered global matrix: against the JAX package's
    dense_logdet_fermi_action to 1e-10 relative and one process to 1e-12 relative,
    bitwise the same on every rank."""
    ranks, single, jax_out = selflearning_runs
    got, want = float(ranks[0][f"logdet_{tag}"]), float(jax_out[f"logdet_{tag}"])
    assert abs(got - want) < 1e-10 * abs(want) and abs(want) > 1.0, tag
    assert abs(got - float(single[f"logdet_{tag}"])) < 1e-12 * abs(want), tag
    for res in ranks[1:]:
        assert res[f"logdet_{tag}"].tobytes() == ranks[0][f"logdet_{tag}"].tobytes(), tag


@pytest.mark.parametrize("tag", ["ihmc", "ihb"])
def test_integrated_updaters_match_single_process(selflearning_runs, tag):
    """IntegratedHMC (the Wilson log det at both ends of a gluonic trajectory) and two
    IntegratedHB steps through run_lqcd_params (the staggered log det of the global
    lattice): dH, the decisions and the links against one process."""
    ranks, single, _ = selflearning_runs
    for res in ranks:
        _close(res[f"{tag}_stats"], single[f"{tag}_stats"], tag)
        assert np.array_equal(res[f"{tag}_accepted"], single[f"{tag}_accepted"]), tag
        assert np.abs(res[f"{tag}_u"] - single[f"{tag}_u"]).max() < 1e-12, tag
        assert res[f"{tag}_stats"].tobytes() == ranks[0][f"{tag}_stats"].tobytes(), tag
    if tag == "ihmc":
        _close(ranks[0]["ihmc_sf"], single["ihmc_sf"], "sf")


def _numbers(line):
    return [float(x) for x in line.split("#")[0].split()]


@pytest.mark.parametrize("fmt", list(FILES))
def test_fileloading_run_matches_single_process_and_jax(selflearning_runs, fmt):
    """A Fileloading run under the grid takes one step per stored configuration (3 NPZ
    files; 2 records of one ILDG file), every rank's block of the last one is the
    one-process load's block bit for bit, and rank 0's measurement lines are one
    process's to 1e-12 and the JAX driver's."""
    ranks, single, jax_out = selflearning_runs
    grid = lambda r: mesh.ProcessGrid(PES, LAT, rank=r)  # noqa: E731
    steps = 3 if fmt == "NPZ" else 2
    for rank, res in enumerate(ranks):
        assert int(res[f"load_{fmt}_steps"]) == int(single[f"load_{fmt}_steps"]) == steps
        block = grid(rank).block(torch.from_numpy(single[f"load_{fmt}_block"]), lead=1)
        assert res[f"load_{fmt}_block"].tobytes() == block.numpy().tobytes(), rank
    for name in MEASURED:
        got, one, jx = (ranks[0][f"load_{fmt}_{name}"], single[f"load_{fmt}_{name}"],
                        jax_out[f"load_{fmt}_{name}"])
        assert len(got) == len(one) == len(jx), name
        assert sum(not line.startswith("#") for line in got) == steps + 1, name
        for a, b, c in zip(got, one, jx):
            if a.startswith("#"):  # a header line
                assert a == b == c, name
                continue
            assert a.partition("#")[2] == c.partition("#")[2], name
            np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(_numbers(a), _numbers(c), rtol=1e-10, atol=1e-13)
