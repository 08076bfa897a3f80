"""The SU(N) heatbath and overrelaxation on the port's process grid, on the CPU.

Two gloo processes on the grid (1, 1, 1, 2) (test_torch_grid's start_ranks; the Iwasaki
action's group in test_torch_grid_heatbath_iwasaki.py, on this module's machinery):

* a heatbath sweep fed the JAX package's own key schedule (each rank
  replays it through test_torch_heatbath's JaxUniforms for the global
  field and keeps its block) and an overrelaxation sweep, against the JAX
  package's Heatbath.sweep and overrelax to 1e-10 (the bar of
  tests/test_sharding.py) and against one process to 1e-12: SU(2) at
  beta 1.9 (the JAX suite's sharded case) and SU(3) at beta 6.0 with the
  plaquette action on 4x4x4x8, and the SU(2) Iwasaki action on 4x4x4x20,
  whose second block starts at t = 10, not a multiple of the colouring
  modulus 4;
* a sweep drawn from the run's generator (sweep_diag; the plaquette
  action's) against one process drawing from the same seed: the links, the exhausted and attempted
  counts, and the generator's state afterwards on every rank (the early
  stop is a global decision, so every rank draws as many uniforms as one
  process);
* a TOML update_method = "Heatbath" run with overrelaxation through
  run_lqcd_params(grid=...), saved and resumed, against one process: the
  final plaquette and links and the history's energy densities.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_job, start_ranks  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 4, 8)
IWASAKI_LAT = (4, 4, 4, 20)
# Iwasaki at beta_I in the reference's convention: the plaquette at c0 beta_I, the
# rectangles through couplinglist at c1 beta_I
C0, C1, BETA_I = 3.648, -0.331, 2.6
# tag -> (NC, the lattice, the action's Params fields, links seed, JAX key seed, generator seed)
SWEEPS = {
    "su2": (2, LAT, dict(beta=1.9), 65, 9, 71),
    "su3": (3, LAT, dict(beta=6.0), 66, 10, 72),
    "iwasaki": (2, IWASAKI_LAT, dict(beta=C0 * BETA_I, couplinglist=["rectangular"],
                                     couplingcoeff=[C1 * BETA_I]), 67, 11, None),
}
# one rank group per lattice, each in its own module (the Iwasaki action's in
# test_torch_grid_heatbath_iwasaki.py); the TOML run rides on the plaquette group
GROUPS = {"plaquette": ("su2", "su3"), "iwasaki": ("iwasaki",)}
LATTICES = {"plaquette": LAT, "iwasaki": IWASAKI_LAT}
# the generator sweeps: the Iwasaki action's 256 colours make each of its sweeps cost about
# 35 s on two ranks, so it runs the two sweeps that hold its colours to the JAX package
GENERATOR_TAGS = ("su2", "su3")
# a group's join timeout: the Iwasaki group takes about 75 s on an idle CPU host
GROUP_TIMEOUT_S = 240


def _action(tag):
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action

    nc, lat, fields_, *_ = SWEEPS[tag]
    return build_gauge_action(Params(NC=nc, L=lat, **fields_))


class _GlobalUniforms:
    """A Uniforms source asked for the global field's arrays: under a grid the sweep asks
    for its block's shape, and this hands the source the global one (the sweep keeps the
    block of what comes back)."""

    def __init__(self, source, grid):
        self.source, self.grid = source, grid

    def _shape(self, shape):
        return shape if self.grid is None else self.grid.global_shape(shape)

    def tries(self, shape, dtype, device):
        return self.source.tries(self._shape(shape), dtype, device)

    def direction(self, shape, dtype, device):
        return self.source.direction(self._shape(shape), dtype, device)


def _jax_uniforms(key_seed, grid):
    """The JAX package's key schedule for PRNGKey(key_seed), replayed on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from test_torch_heatbath import JaxUniforms

    return _GlobalUniforms(JaxUniforms(jax.random.PRNGKey(key_seed)), grid)


def _sweeps(tag, links, block, grid):
    """The three sweeps of ``tag`` on the global links of ``links`` (cut by ``block``):
    the JAX schedule's heatbath sweep, an overrelaxation, and a generator sweep with its
    counts and the generator's state after it; links gathered on every rank."""
    from latticeqcd_torch.updates.heatbath import Heatbath

    _, _, _, _, key_seed, gen_seed = SWEEPS[tag]
    hb = Heatbath(action=_action(tag))
    gather = lambda u: mesh.to_host_global(u, lead=1, all_ranks=True)  # noqa: E731
    hot = torch.from_numpy(block(links[f"{tag}_hot"]))
    warm = torch.from_numpy(block(links[f"{tag}_warm"]))
    out = {f"{tag}_jax": gather(hb.sweep(hot, uniforms=_jax_uniforms(key_seed, grid))),
           f"{tag}_or": gather(hb.overrelax(warm))}
    if tag in GENERATOR_TAGS:
        gen = torch.Generator().manual_seed(gen_seed)
        u, n_exh, n_att = hb.sweep_diag(hot, gen)
        out.update({f"{tag}_gen": gather(u), f"{tag}_counts": np.array([n_exh, n_att]),
                    f"{tag}_state": gen.get_state().numpy()})
    return out


def _params(workdir, nsteps):
    from latticeqcd_torch.system.params import Params

    os.makedirs(os.path.join(workdir, "s"), exist_ok=True)
    return Params(L=LAT, NC=3, beta=6.0, initial="hot", update_method="Heatbath", quench=True,
                  useOR=True, numOR=2, Nsteps=nsteps, randomseed=19, verboselevel=1,
                  measuredir=os.path.join(workdir, "m"), saveU_format="NPZ",
                  saveU_dir=os.path.join(workdir, "s"), saveU_every=1,
                  measurement_methods=[{"methodname": "Plaquette"},
                                       {"methodname": "Polyakov_loop"},
                                       {"methodname": "Energy_density"}])


def _toml_runs(workdir, grid):
    """The TOML heatbath run: 3 steps straight, and 2 then a third resumed from the
    checkpoint; the final plaquettes and links (gathered), and the history."""
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    out = {}
    for tag, nsteps, resume in (("straight", 3, None), ("first", 2, None),
                                ("resumed", 3, os.path.join(workdir, "first", "s",
                                                            "checkpoint.npz"))):
        final, history = {}, []
        out[f"toml_{tag}_plaq"] = np.asarray(run_lqcd_params(
            _params(os.path.join(workdir, tag), nsteps), device="cpu", grid=grid,
            history=history, resume_checkpoint=resume, final=final))
        out[f"toml_{tag}_u"] = mesh.to_host_global(final["u"], lead=1, all_ranks=True)
        out[f"toml_{tag}_energy"] = np.array([r["measured"]["Energy_density"] for r in history])
        if grid is not None:
            torch.distributed.barrier()
    return out


def _run_group(group, links_file, workdir, grid=None):
    links = dict(np.load(links_file))
    block = (lambda a: a) if grid is None else (lambda a: grid.block(a, lead=1).copy())
    out = {}
    for tag in GROUPS[group]:
        out.update(_sweeps(tag, links, block, grid))
    if group == "plaquette":
        out.update(_toml_runs(workdir, grid))
    return {k: np.asarray(v) for k, v in out.items()}


def _rank_main(argv):
    group = argv[0]
    rank_main(argv, {group: lambda grid, links_file, workdir: _run_group(
        group, links_file, workdir, grid)}, lattice=LATTICES[group])


# ------------------------------------------------- references, in the parent


def _links_file(tmp_path_factory, group):
    """The global links of the group's sweeps (hot, and warm ones for the overrelaxation:
    on Haar-random links an overrelaxation amplifies rounding,
    test_torch_heatbath.warm_links), written for the rank group."""
    from latticeqcd_tpu.ops import fields as jfields
    from test_torch_heatbath import warm_links

    links = {}
    for tag in GROUPS[group]:
        nc, lat, _, seed, _, _ = SWEEPS[tag]
        links.update({f"{tag}_hot": np.asarray(jfields.hot_start(lat, nc, seed=seed)),
                      f"{tag}_warm": warm_links(lat, nc, seed=seed + 100)})
    links_file = os.path.join(tmp_path_factory.mktemp(f"grid_heatbath_{group}"), "links.npz")
    np.savez(links_file, **links)
    return links_file


def _jax_sweeps(outfile, links_file, group, what):
    """The JAX package's heatbath sweeps (``what`` "jax", on its key) or overrelaxations
    ("or") of the group's tags on the links of ``links_file``, saved as the npz
    ``outfile``."""
    import jax
    import jax.numpy as jnp

    from latticeqcd_tpu.system import universe as juniv
    from latticeqcd_tpu.system.params import Params as JParams
    from latticeqcd_tpu.updates import heatbath as jhb

    links, out = dict(np.load(links_file)), {}
    for tag in GROUPS[group]:
        nc, lat, fields_, _, key_seed, _ = SWEEPS[tag]
        hb = jhb.Heatbath(action=juniv.build_gauge_action(JParams(NC=nc, L=lat, **fields_)))
        if what == "jax":
            u = hb.sweep(jnp.asarray(links[f"{tag}_hot"]), jax.random.PRNGKey(key_seed))[0]
        else:
            u = hb.overrelax(jnp.asarray(links[f"{tag}_warm"]), jax.random.PRNGKey(0))[0]
        out[f"{tag}_{what}"] = np.asarray(u)
    np.savez(outfile, **out)


def _single(outfile, group, links_file, workdir):
    """The single-process port's results of the group, saved as the npz ``outfile``."""
    np.savez(outfile, **_run_group(group, links_file, workdir))


def _references(tmp_path_factory, group, links_file):
    """The JAX package's sweeps on the links of ``links_file`` and the single-process
    port's results: the overrelaxations and the port's run each in a process of their
    own, beside the JAX package's heatbath sweeps in this one (the Iwasaki module runs
    last under loadfile, with three cases, so its references go side by side)."""
    d = tmp_path_factory.mktemp(f"grid_heatbath_refs_{group}")
    work = tmp_path_factory.mktemp(f"grid_heatbath_single_{group}")
    jobs = [start_job("test_torch_grid_heatbath", "_jax_sweeps", d / "or.npz", links_file,
                      group, "or", timeout_s=600),
            start_job("test_torch_grid_heatbath", "_single", d / "single.npz", group,
                      links_file, work, timeout_s=600)]
    try:
        _jax_sweeps(d / "sweep.npz", links_file, group, "jax")
        (overrelax,), (single,) = (job.join() for job in jobs)
    finally:
        for job in jobs:
            job.kill()
    return links_file, single, {**dict(np.load(d / "sweep.npz")), **overrelax}


def sweep_tests(module, group):
    """(the fixture that starts the rank group, the references fixture, the fixture that
    joins the group and the sweep test) of a module that runs the sweeps of ``group`` on
    two ranks: one group per module, so that loadfile spreads the lattices over the
    workers. The group starts on the links and runs while the references are computed
    (``_references``)."""

    @pytest.fixture(scope="module")
    def started(tmp_path_factory):
        links_file = _links_file(tmp_path_factory, group)
        res = tmp_path_factory.mktemp(f"grid_heatbath_{group}_ranks")
        work = tmp_path_factory.mktemp(f"grid_heatbath_{group}_work")
        ranks = start_ranks(module, group, PES, res, links_file, work, timeout_s=GROUP_TIMEOUT_S)
        yield links_file, ranks
        ranks.kill()

    @pytest.fixture(scope="module")
    def references(started, tmp_path_factory):
        return _references(tmp_path_factory, group, started[0])

    @pytest.fixture(scope="module")
    def rank_group(started, references):
        return started[1].join()

    @pytest.mark.parametrize("what", ["jax", "or"], ids=["heatbath", "overrelaxation"])
    @pytest.mark.parametrize("tag", GROUPS[group])
    def test_sweep_matches_jax(rank_group, references, tag, what):
        """The sharded sweep (the heatbath on the JAX package's key schedule, the
        overrelaxation on warm links) against the JAX package's to 1e-10 and against one
        process to 1e-12, the same links on every rank."""
        key = f"{tag}_{what}"
        got = rank_group[0][key]
        assert np.abs(got - references[2][key]).max() < 1e-10, key
        assert np.abs(got - references[1][key]).max() < 1e-12, key
        for res in rank_group[1:]:
            assert res[key].tobytes() == got.tobytes(), key

    return started, references, rank_group, test_sweep_matches_jax


started, references, rank_group, test_sweep_matches_jax = sweep_tests(
    "test_torch_grid_heatbath", "plaquette")


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("tag", GENERATOR_TAGS)
def test_generator_sweep_matches_single_process(rank_group, references, tag):
    """A sweep from the run's generator under the grid against one process drawing from
    the same seed: the links bit for bit, the same exhausted and attempted counts (global
    sums), and on every rank the generator's state one process ends with."""
    single = references[1]
    for rank, res in enumerate(rank_group):
        assert res[f"{tag}_gen"].tobytes() == single[f"{tag}_gen"].tobytes(), rank
        assert np.array_equal(res[f"{tag}_counts"], single[f"{tag}_counts"]), rank
        assert np.array_equal(res[f"{tag}_state"], single[f"{tag}_state"]), rank
    nc, lat = SWEEPS[tag][:2]
    masked = 4 * int(np.prod(lat)) * nc * (nc - 1) // 2  # every link once per subgroup
    assert int(single[f"{tag}_counts"][1]) == masked


def test_toml_heatbath_run_matches_single_process(rank_group, references):
    """update_method = "Heatbath" with numOR = 2 through run_lqcd_params(grid=...): the
    final plaquette, links and energy densities of the history against one process, bit
    for bit on every rank; a run of 2 steps resumed for a third ends where 3 straight end."""
    single, ranks = references[1], rank_group
    for rank, res in enumerate(ranks):
        for tag in ("straight", "resumed"):
            for what in ("plaq", "u", "energy"):
                key = f"toml_{tag}_{what}"
                assert np.abs(res[key] - single[key]).max() < 1e-12, (key, rank)
                assert res[key].tobytes() == ranks[0][key].tobytes(), (key, rank)
        assert res["toml_straight_u"].tobytes() == res["toml_resumed_u"].tobytes(), rank
