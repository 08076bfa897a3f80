"""The port's 4D process grid (latticeqcd_torch/parallel/mesh.py) on the CPU.

Each grid runs as a group of gloo processes (one torch thread each,
joined under a timeout so that a hang fails): the sharded roll against
torch.roll of the global field, bit for bit, forward and backward, along
every axis and across several at once; the shard and gather round trip;
the boundary phases; the global sum, bitwise the same on every rank.
Without processes: default_pes pinned to the JAX function, the grid's
local extents and neighbours, odd local extents refused, and every path
outside the slice refusing under a grid (ROADMAP A14b) before any draw
or message.
"""

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
GRIDS = [(1, 1, 1, 2), (1, 1, 2, 2), (2, 1, 1, 2)]
GRID_IDS = ["t2", "z2t2", "x2t2"]
LAT = (4, 4, 4, 8)
JOIN_TIMEOUT_S = 120


# ------------------------------------------------------------- rank groups


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    """Processes started by ``start_ranks`` or ``start_job``, running while the caller
    works; ``join`` waits for them and returns what each saved (its npz as a dict)."""

    def __init__(self, procs, outfiles, what, timeout_s):
        self.procs, self.outfiles, self.what, self.timeout_s = procs, outfiles, what, timeout_s

    def kill(self):
        """End every process still running (the caller failed before its join)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def join(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout_s))
        finally:
            self.kill()
        for rank, (p, (out, err)) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {rank} of {self.what} failed:\n{out}\n{err[-4000:]}"
        return [dict(np.load(f)) for f in self.outfiles]


def _start(code, argvs, outfiles, what, timeout_s) -> RankGroup:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, *map(str, argv)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
                              text=True) for argv in argvs]
    return RankGroup(procs, outfiles, what, timeout_s)


def start_ranks(module: str, case: str, pes, outdir, *args,
                timeout_s: float = JOIN_TIMEOUT_S) -> RankGroup:
    """Start ``module``.``case``(grid, outdir, *args) on one gloo process per block of
    the grid pes over LAT's lattice (as passed in args[0] if given), one torch thread
    each, and return at once: the caller may compute its references meanwhile. The
    group must finish within ``timeout_s`` (JOIN_TIMEOUT_S unless given) of its join."""
    nprocs = int(np.prod(pes))
    port = _free_port()
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; import {module} as m; "
            f"m._rank_main(sys.argv[1:])")
    argvs = [[case, rank, port, ",".join(map(str, pes)), outdir, *args] for rank in range(nprocs)]
    return _start(code, argvs, [os.path.join(outdir, f"rank{r}.npz") for r in range(nprocs)],
                  pes, timeout_s)


def start_job(module: str, func: str, outfile, *args,
              timeout_s: float = JOIN_TIMEOUT_S) -> RankGroup:
    """Start ``module``.``func``(outfile, *args) in a process of its own (one torch thread,
    the JAX package on the CPU in x64, as this suite sets it up) and return at once, so
    that a reference is computed beside the caller's work; func saves its results as the
    npz ``outfile``, which ``join`` returns (as a one-element list)."""
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; import jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            f"import {module} as m; m.{func}(*sys.argv[1:])")
    return _start(code, [[outfile, *args]], [outfile], f"{module}.{func}", timeout_s)


def run_ranks(module: str, case: str, pes, outdir, *args, timeout_s: float = JOIN_TIMEOUT_S):
    """start_ranks and join: each rank's saved npz as a dict. Fails if a rank fails or
    the group does not finish within ``timeout_s`` (JOIN_TIMEOUT_S unless given)."""
    return start_ranks(module, case, pes, outdir, *args, timeout_s=timeout_s).join()


def rank_main(argv, cases, lattice=LAT):
    """A rank of a group: join the gloo group, run cases[case](grid, *args) under
    the grid on the CPU, save what it returns (a dict of arrays) as rank<r>.npz."""
    case, rank, port, pes, outdir, *args = argv
    torch.set_num_threads(1)
    pes = tuple(int(p) for p in pes.split(","))
    mesh.init_process_grid("gloo", f"127.0.0.1:{port}", int(np.prod(pes)), int(rank),
                           timeout_s=JOIN_TIMEOUT_S)
    try:
        grid = mesh.make_process_grid(pes, lattice, "cpu")
        with mesh.use_grid(grid):
            out = cases[case](grid, *args)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        mesh.close_process_grid()


# --------------------------------------------------------------- the cases

SHIFTS = (1, -1, 2, -2)
MULTI = [((1, -2), (0, 3)), ((-1, 1, 2), (1, 2, 3)), ((2, -1), (3, 0)), ((3, 5), (3, 2))]


def _globals():
    rng = np.random.default_rng(5)
    f = rng.standard_normal(LAT + (4, 3)) + 1j * rng.standard_normal(LAT + (4, 3))
    w = rng.standard_normal(LAT + (4, 3))
    packed = rng.standard_normal((LAT[0] // 2,) + LAT[1:] + (4, 3))
    return torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(packed)


def _case_fields(grid):
    from latticeqcd_torch.ops import fields, rolls
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    f, w, packed = _globals()
    out = {}
    for mu in range(4):
        ok_f = ok_b = True
        for s in SHIFTS:
            ok_f &= torch.equal(rolls.roll(grid.block(f), s, mu), grid.block(torch.roll(f, s, mu)))
            x = grid.block(w).clone().requires_grad_(True)
            wb = grid.block(torch.roll(w, 3 * s, 2))  # a cotangent that differs per site
            (g,) = torch.autograd.grad(torch.sum(rolls.roll(x, s, mu) * wb), x)
            ok_b &= torch.equal(g, grid.block(torch.roll(torch.roll(w, 3 * s, 2), -s, mu)))
        out[f"roll{mu}"], out[f"roll_backward{mu}"] = ok_f, ok_b
    out["multi"] = all(torch.equal(rolls.roll(grid.block(f), s, a),
                                   grid.block(torch.roll(f, s, a))) for s, a in MULTI)
    x = grid.block(w).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(rolls.roll(x, (1, -2), (0, 3)) * grid.block(w)), x)
    out["multi_backward"] = torch.equal(g, grid.block(torch.roll(w, (2, -1), (3, 0))))
    out["packed_x"] = all(torch.equal(rolls.roll(grid.block(packed), s, 0),
                                      grid.block(torch.roll(packed, s, 0))) for s in SHIFTS)
    u = fields.hot_start(LAT, 3, seed=9, device="cpu")  # this rank's block
    with mesh.use_grid(None):
        u_global = fields.hot_start(LAT, 3, seed=9, device="cpu")
        phased_global = apply_boundary_phases(u_global)
    out["hot_start_block"] = torch.equal(u, grid.block(u_global, lead=1))
    gathered = mesh.to_host_global(u, lead=1)
    out["gather_rank0"] = (gathered is None) if grid.rank else np.array_equal(gathered,
                                                                              u_global.numpy())
    out["gather_all"] = np.array_equal(mesh.to_host_global(u, lead=1, all_ranks=True),
                                       u_global.numpy())
    out["shard_links"] = torch.equal(mesh.shard_links(u_global), u)
    out["phases"] = torch.equal(apply_boundary_phases(u), grid.block(phased_global, lead=1))
    partial = torch.tensor(0.1 * (grid.rank + 1) + 1e-17 * grid.rank, dtype=torch.float64)
    total = mesh.global_sum(partial)
    out["sum"] = total.numpy()
    out["sum_complex"] = mesh.global_sum(torch.sum(grid.block(f))).numpy()
    return {k: np.asarray(v) for k, v in out.items()}


CASES = {"fields": _case_fields}


def _rank_main(argv):
    rank_main(argv, CASES)


@pytest.fixture(scope="module", params=GRIDS, ids=GRID_IDS)
def fields_group(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_fields")
    return request.param, run_ranks("test_torch_grid", "fields", request.param, out)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("mu", range(4), ids=list("xyzt"))
def test_sharded_roll_is_torch_roll(fields_group, mu):
    """rolls.roll of a block is the block of torch.roll of the global field, bit for bit,
    for shifts +-1 and +-2, and its backward is the opposite roll."""
    pes, ranks = fields_group
    for r, res in enumerate(ranks):
        assert res[f"roll{mu}"], (pes, r)
        assert res[f"roll_backward{mu}"], (pes, r)


def test_sharded_roll_multi_axis_and_packed(fields_group):
    """Multi-axis shifts (axis by axis, a shift longer than a block included) and the
    packed x' axis, bit for bit; the multi-axis backward is the opposite roll."""
    pes, ranks = fields_group
    for res in ranks:
        assert res["multi"] and res["multi_backward"] and res["packed_x"], pes


def test_shard_and_gather_round_trip(fields_group):
    """hot_start under the grid is the block of the global start; gathering the blocks
    gives the global links back bit for bit, on rank 0 and on every rank."""
    pes, ranks = fields_group
    for res in ranks:
        assert res["hot_start_block"] and res["shard_links"], pes
        assert res["gather_rank0"] and res["gather_all"], pes


def test_boundary_phases_match_single_process(fields_group):
    pes, ranks = fields_group
    for res in ranks:
        assert res["phases"], pes


def test_global_sum_is_bitwise_the_same_on_every_rank(fields_group):
    pes, ranks = fields_group
    n = len(ranks)
    want = sum(0.1 * (r + 1) + 1e-17 * r for r in range(n))
    assert abs(float(ranks[0]["sum"]) - want) < 1e-15
    f = _globals()[0]
    assert abs(complex(ranks[0]["sum_complex"]) - complex(torch.sum(f))) < 1e-12
    for res in ranks[1:]:
        assert res["sum"].tobytes() == ranks[0]["sum"].tobytes()
        assert res["sum_complex"].tobytes() == ranks[0]["sum_complex"].tobytes()


@pytest.mark.parametrize("n", range(1, 9))
def test_default_pes_matches_jax(n):
    from latticeqcd_tpu.parallel.mesh import default_pes as jax_default_pes

    assert mesh.default_pes(n) == jax_default_pes(n)


@pytest.mark.parametrize("pes,local,coords,neighbours", [
    ((1, 1, 1, 2), (4, 4, 4, 4), (0, 0, 0, 1), {3: (0, 0)}),
    ((1, 1, 2, 2), (4, 4, 2, 4), (0, 0, 1, 1), {2: (1, 1), 3: (2, 2)}),
    ((2, 1, 1, 2), (2, 4, 4, 4), (1, 0, 0, 1), {0: (1, 1), 3: (2, 2)}),
], ids=GRID_IDS)
def test_local_extents_and_neighbours(pes, local, coords, neighbours):
    """The last rank of each grid over 4x4x4x8: its extents, coordinates (t fastest, as
    the JAX mesh orders its devices), origin and its neighbours (-mu, +mu)."""
    grid = mesh.ProcessGrid(pes, LAT, rank=int(np.prod(pes)) - 1)
    assert grid.local == local and grid.coords == coords
    assert grid.origin == tuple(c * n for c, n in zip(coords, local))
    assert grid.partitioned == tuple(sorted(neighbours))
    for mu, (lo, hi) in neighbours.items():
        assert (grid.neighbour(mu, -1), grid.neighbour(mu, +1)) == (lo, hi)
    assert all(grid.holds_last(mu) for mu in range(4))
    assert mesh.ProcessGrid(pes, LAT, rank=0).holds_last(3) is False


@pytest.mark.parametrize("pes,lattice", [((1, 1, 1, 2), (4, 4, 4, 6)), ((2, 1, 1, 1), (6, 4, 4, 4)),
                                         ((1, 1, 2, 1), (4, 4, 2, 4)), ((1, 1, 1, 3), (4, 4, 4, 8))])
def test_odd_or_ragged_local_extents_refused(pes, lattice):
    with pytest.raises(ValueError, match="even|divide"):
        mesh.ProcessGrid(pes, lattice)


# ----------------------------------------------------------------- refusals


def _refusal_cases():
    """name -> a callable that must raise NotImplementedError naming A14b under a grid."""
    from latticeqcd_torch.measurements.scheduler import MeasurementSet
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import staggered_kernel, wilson_kernel, wilson_window_kernel
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import (HasenbuschWilsonFermiAction,
                                                     StaggeredFermiAction, WilsonFermiAction)
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import check_supported
    from latticeqcd_torch.updates.hmc import HMC
    from latticeqcd_torch.updates.slhmc import SLHMC, dense_logdet_fermi_action

    act = ga.wilson_gauge_action(3, 6.0)
    local = (4, 4, 4, 4)
    gen = torch.Generator().manual_seed(1)
    u = lambda: fields.cold_start(local, 3, device="cpu")  # noqa: E731
    hmc = lambda fa=None, **kw: HMC(action=act, dtau=0.1, md_steps=2, fermi_action=fa, **kw)  # noqa: E731
    wilson = WilsonDirac(kappa=0.12)
    r_half = WilsonDirac(kappa=0.12, r=0.5)
    packed = torch.zeros((1, 2, 4, 4, 4, 4, 3), dtype=torch.complex128)
    r_half_method = {"methodname": "Chiral_condensate", "Nr": 1,
                     "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12, "r": 0.5}}

    def toml(**kw):
        base = dict(L=(4, 4, 4, 8), NC=3, beta=6.0, update_method="HMC", quench=False,
                    Dirac_operator="Wilson")
        base.update(kw)
        return lambda: check_supported(Params(**base), "cpu")

    return {
        "step_batched": lambda: hmc().step_batched(u()[None], [gen]),
        "step_batched Wilson": lambda: hmc(WilsonFermiAction(wilson)).step_batched(u()[None], [gen]),
        "step_batched staggered": lambda: hmc(StaggeredFermiAction(
            StaggeredDirac(0.5, local), nf=4)).step_batched(u()[None], [gen]),
        "staggered_w with a chain axis": lambda: staggered_kernel.staggered_w(
            u()[None, :, :2], u()[None, :, :2],
            torch.zeros((1, 2, 4, 4, 4, 3), dtype=torch.complex128), 0.5),
        "wilson_hop_packed with a chain axis": lambda: wilson_kernel.wilson_hop_packed(
            u()[None, :, :2], u()[None, :, :2], packed, 0),
        "wilson_window with a chain axis": lambda: wilson_window_kernel.wilson_window(
            u()[None], torch.zeros((1,) + local + (4, 3), dtype=torch.complex128), 0.12),
        "wilson_hop full mode": lambda: wilson_kernel.wilson_dslash(
            u(), torch.zeros(local + (4, 3), dtype=torch.complex128), 0.12),
        "Wilson r = 0.5 HMC": lambda: hmc(WilsonFermiAction(r_half)).step(u(), gen),
        "clover r = 0.5 HMC": lambda: hmc(WilsonFermiAction(
            WilsonDirac(kappa=0.12, r=0.5, csw=1.0))).step(u(), gen),
        "Hasenbusch r = 0.5 HMC": lambda: hmc(HasenbuschWilsonFermiAction(r_half, mu=0.5)).step(
            u(), gen),
        "SLHMC Wilson r = 0.5": lambda: SLHMC(act, 0.1, 2, fermi_action=WilsonFermiAction(
            r_half)).step(u(), gen),
        "dense log det r = 0.5": lambda: dense_logdet_fermi_action(r_half, (4, 4, 4, 8, 4, 3),
                                                                   1.0)(u()),
        "Wilson r = 0.5 measurement": lambda: MeasurementSet.from_methods(
            [r_half_method]).measurements[0].measure(u(), 1),
        "TOML Wilson r = 0.5": toml(r=0.5),
        "TOML clover r = 0.5": toml(Dirac_operator="WilsonClover", r=0.5),
        "TOML SLHMC r = 0.5": toml(update_method="SLHMC", r=0.5),
        "TOML IntegratedHB r = 0.5": toml(update_method="IntegratedHB", L=(4, 4, 2, 4), r=0.5),
        "TOML measurement r = 0.5": toml(quench=True, measurement_methods=[r_half_method]),
    }


REFUSALS = [
    "step_batched", "step_batched Wilson", "step_batched staggered",
    "staggered_w with a chain axis", "wilson_hop_packed with a chain axis",
    "wilson_window with a chain axis", "wilson_hop full mode", "Wilson r = 0.5 HMC",
    "clover r = 0.5 HMC", "Hasenbusch r = 0.5 HMC", "SLHMC Wilson r = 0.5",
    "dense log det r = 0.5", "Wilson r = 0.5 measurement", "TOML Wilson r = 0.5",
    "TOML clover r = 0.5", "TOML SLHMC r = 0.5", "TOML IntegratedHB r = 0.5",
    "TOML measurement r = 0.5"]


@pytest.mark.parametrize("what", REFUSALS)
def test_outside_the_slice_refused_under_a_grid(what):
    """Under a two-process grid, each path outside the slice raises NotImplementedError
    naming ROADMAP A14b before any message or draw: no torch.distributed call is made
    (each one raises here) and the generator has drawn nothing."""
    cases = _refusal_cases()
    grid = mesh.ProcessGrid((1, 1, 1, 2), (4, 4, 4, 8), rank=0)
    forbidden = mock.Mock(side_effect=AssertionError("a message before the refusal"))
    with mesh.use_grid(grid), \
            mock.patch.multiple(torch.distributed, batch_isend_irecv=forbidden,
                                all_reduce=forbidden, all_gather=forbidden), \
            mock.patch.object(torch, "randn", side_effect=AssertionError("a draw")), \
            mock.patch.object(torch, "rand", side_effect=AssertionError("a draw")):
        with pytest.raises(NotImplementedError, match="A14b"):
            cases[what]()
    assert set(REFUSALS) == set(cases)
