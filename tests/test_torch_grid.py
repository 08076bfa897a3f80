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
    out.update(_wilson_r_half_trajectory())
    out.update(_hop_messages(u))
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _wilson_r_half_trajectory():
    """One complex128 Wilson HMC trajectory at r = 0.5 from the run's generator (the
    global draws): dH, the accept decision and the links (gathered on rank 0 under a
    grid, None elsewhere)."""
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.05, md_steps=2,
              fermi_action=WilsonFermiAction(WilsonDirac(kappa=0.12, r=0.5), eps_cg=1e-20))
    u_new, st = hmc.step(fields.hot_start(LAT, 3, seed=13, device="cpu"),
                         torch.Generator().manual_seed(14))
    return {"r_half_dh": np.asarray(st["dH"]), "r_half_accepted": np.asarray(st["accepted"]),
            "r_half_u": mesh.to_host_global(u_new, lead=1)}


def _hop_messages(u):
    """The point-to-point messages (their sizes, sorted) of one packed hop at r = 0.5 and
    at r = 1, each on packed links whose faces were exchanged by a first hop."""
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases

    real, sizes = torch.distributed.batch_isend_irecv, []

    def counted(ops):
        sizes.extend(op.tensor.numel() for op in ops)
        return real(ops)

    out = {}
    local = mesh.sharded().local
    x = torch.ones((local[0] // 2,) + tuple(local[1:]) + (4, 3), dtype=torch.complex128)
    for r, tag in ((0.5, "r_half"), (1.0, "r_one")):
        d = WilsonDirac(kappa=0.12, r=r)
        ueo = d.packed_links(apply_boundary_phases(u))
        d.hop_packed(*ueo, x, 0)
        sizes.clear()
        with mock.patch.object(torch.distributed, "batch_isend_irecv", counted):
            d.hop_packed(*ueo, x, 0)
        out[f"{tag}_messages"] = np.array(sorted(sizes))
    return out


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


@pytest.fixture(scope="module")
def r_half_one_process():
    """The groups' Wilson r = 0.5 trajectory in this process, without a grid."""
    return _wilson_r_half_trajectory()


def test_wilson_r_half_trajectory_matches_one_process(fields_group, r_half_one_process):
    """A complex128 Wilson trajectory at r = 0.5 (the packed hop's halo form at r = 0.5,
    its r-generic link gradients moved across the faces) against one process from the
    same seed: dH 1e-8, links 1e-10, the same decision, every rank's dH bitwise."""
    pes, ranks = fields_group
    one = r_half_one_process
    assert abs(float(ranks[0]["r_half_dh"]) - float(one["r_half_dh"])) < 1e-8, pes
    assert bool(ranks[0]["r_half_accepted"]) == bool(one["r_half_accepted"]), pes
    assert np.abs(ranks[0]["r_half_u"] - one["r_half_u"]).max() < 1e-10, pes
    for res in ranks[1:]:
        assert res["r_half_dh"].tobytes() == ranks[0]["r_half_dh"].tobytes(), pes


def test_hop_at_r_half_sends_what_it_sends_at_r_one(fields_group):
    """The gloo audit's count for a packed hop on exchanged links at r = 0.5: two spinor
    face messages per cut axis, each way, the same sizes as at r = 1."""
    pes, ranks = fields_group
    cut = sum(p > 1 for p in pes)
    for res in ranks:
        assert np.array_equal(res["r_half_messages"], res["r_one_messages"]), pes
        assert len(res["r_half_messages"]) == 4 * cut, pes


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
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import staggered_kernel, wilson_kernel, wilson_window_kernel
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    act = ga.wilson_gauge_action(3, 6.0)
    local = (4, 4, 4, 4)
    gen = torch.Generator().manual_seed(1)
    u = lambda: fields.cold_start(local, 3, device="cpu")  # noqa: E731
    hmc = lambda fa=None, **kw: HMC(action=act, dtau=0.1, md_steps=2, fermi_action=fa, **kw)  # noqa: E731
    wilson = WilsonDirac(kappa=0.12)
    packed = torch.zeros((1, 2, 4, 4, 4, 4, 3), dtype=torch.complex128)

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
    }


REFUSALS = [
    "step_batched", "step_batched Wilson", "step_batched staggered",
    "staggered_w with a chain axis", "wilson_hop_packed with a chain axis",
    "wilson_window with a chain axis", "wilson_hop full mode"]


def _no_messages_or_draws(grid):
    """The mock grid (no rank group): every torch.distributed call and every draw fails."""
    from contextlib import ExitStack

    forbidden = mock.Mock(side_effect=AssertionError("a message"))
    stack = ExitStack()
    stack.enter_context(mesh.use_grid(grid))
    stack.enter_context(mock.patch.multiple(torch.distributed, batch_isend_irecv=forbidden,
                                            all_reduce=forbidden, all_gather=forbidden))
    stack.enter_context(mock.patch.object(torch, "randn", side_effect=AssertionError("a draw")))
    stack.enter_context(mock.patch.object(torch, "rand", side_effect=AssertionError("a draw")))
    return stack


@pytest.mark.parametrize("what", REFUSALS)
def test_outside_the_slice_refused_under_a_grid(what):
    """Under a two-process grid, each path outside the slice raises NotImplementedError
    naming ROADMAP A14b before any message or draw: no torch.distributed call is made
    (each one raises here) and the generator has drawn nothing."""
    cases = _refusal_cases()
    grid = mesh.ProcessGrid((1, 1, 1, 2), (4, 4, 4, 8), rank=0)
    with _no_messages_or_draws(grid):
        with pytest.raises(NotImplementedError, match="A14b"):
            cases[what]()
    assert set(REFUSALS) == set(cases)


def _r_half_cases():
    """name -> (its entry's check under the grid, which must pass: a refusal function
    returning None or a builder that no longer raises; the Wilson operator at r = 0.5
    its path applies; that operator's first call: "packed", "full" or "clover")."""
    from latticeqcd_torch.measurements.scheduler import MeasurementSet
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import HasenbuschWilsonFermiAction, WilsonFermiAction
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import (build_fermi_action, check_supported,
                                                  params_grid_refusal)
    from latticeqcd_torch.updates.hmc import HMC, grid_refusal
    from latticeqcd_torch.updates.slhmc import SLHMC, dense_logdet_fermi_action

    act = ga.wilson_gauge_action(3, 6.0)
    r_half = WilsonDirac(kappa=0.12, r=0.5)
    clover = WilsonDirac(kappa=0.12, r=0.5, csw=1.0)
    r_half_method = {"methodname": "Chiral_condensate", "Nr": 1,
                     "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12, "r": 0.5}}

    def action(fa, kind, updater=HMC):
        def check():
            assert grid_refusal(fa) is None
            updater(act, 0.1, 2, fermi_action=fa)  # its own check, in its constructor
            return fa.dirac
        return check, kind

    def toml(kind, **kw):
        base = dict(L=(4, 4, 4, 8), NC=3, beta=6.0, update_method="HMC", quench=False,
                    Dirac_operator="Wilson", hop=0.12, r=0.5)
        base.update(kw)

        def check():
            p = Params(**base)
            assert params_grid_refusal(p) is None
            check_supported(p, "cpu")
            if p.quench:
                return MeasurementSet.from_methods(p.measurement_methods).measurements[0]._dirac(
                    torch.zeros((4, 4, 4, 4, 4, 3, 3)))[1]
            return build_fermi_action(p).dirac
        return check, kind

    def dense():
        dense_logdet_fermi_action(r_half, (4, 4, 4, 8, 4, 3), 1.0)
        return r_half

    def measurement():
        m = MeasurementSet.from_methods([r_half_method]).measurements[0]
        return m._dirac(torch.zeros((4, 4, 4, 4, 4, 3, 3)))[1]

    return {
        "Wilson r = 0.5 HMC": action(WilsonFermiAction(r_half), "packed"),
        "clover r = 0.5 HMC": action(WilsonFermiAction(clover), "clover"),
        "Hasenbusch r = 0.5 HMC": action(HasenbuschWilsonFermiAction(r_half, mu=0.5), "packed"),
        "SLHMC Wilson r = 0.5": action(WilsonFermiAction(r_half), "packed", SLHMC),
        "dense log det r = 0.5": (dense, "full"),
        "Wilson r = 0.5 measurement": (measurement, "packed"),
        "TOML Wilson r = 0.5": toml("packed"),
        "TOML clover r = 0.5": toml("clover", Dirac_operator="WilsonClover",
                                    Clover_coefficient=1.0),
        "TOML SLHMC r = 0.5": toml("packed", update_method="SLHMC"),
        "TOML IntegratedHB r = 0.5": toml("full", update_method="IntegratedHB"),
        "TOML measurement r = 0.5": toml("packed", quench=True,
                                         measurement_methods=[r_half_method]),
    }


R_HALF = [
    "Wilson r = 0.5 HMC", "clover r = 0.5 HMC", "Hasenbusch r = 0.5 HMC",
    "SLHMC Wilson r = 0.5", "dense log det r = 0.5", "Wilson r = 0.5 measurement",
    "TOML Wilson r = 0.5", "TOML clover r = 0.5", "TOML SLHMC r = 0.5",
    "TOML IntegratedHB r = 0.5", "TOML measurement r = 0.5"]


@pytest.mark.parametrize("what", R_HALF)
def test_wilson_r_half_runs_under_a_grid(what):
    """Wilson r = 0.5 under the same two-process mock grid (no rank group: every message
    and draw fails): each path's check passes, and the first operator its path applies
    to this rank's block, through the plain halo form at r = 0.5 with the face
    exchanges cut from the global fields, matches the block of the global plain
    operator (1e-12)."""
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from test_torch_hop_packed import block_faces

    cases = _r_half_cases()
    assert set(R_HALF) == set(cases)
    check, kind = cases[what]
    lat = (4, 4, 4, 8)
    grid = mesh.ProcessGrid((1, 1, 1, 2), lat, rank=0)
    with _no_messages_or_draws(grid):
        dirac = check()
    assert dirac.r == 0.5
    u = apply_boundary_phases(fields.hot_start(lat, 3, seed=11, device="cpu"))
    g = np.random.default_rng(12)
    psi = torch.from_numpy(g.standard_normal(lat + (4, 3)) + 1j * g.standard_normal(lat + (4, 3)))
    if kind == "packed":
        u_t, u_s = eo_pack.pack_links(u, lat)
        psi = psi[:lat[0] // 2].contiguous()
        ref = dirac.hop_packed(u_t, u_s, psi, 0)
        blocks = [grid.block(u_t, 1), grid.block(u_s, 1), grid.block(psi)]
        run = lambda: dirac.hop_packed(*blocks, 0)  # noqa: E731
        plain = "hop_packed_halo_reference"
    else:
        u_t = u_s = u
        term = dirac.clover(u)
        ref = dirac.apply(u, psi, term)
        blocks = [grid.block(u, 1), grid.block(psi)]
        run = lambda: dirac.apply(*blocks, None if term is None else grid.block(term))  # noqa: E731
        plain = "dslash_halo_reference"
    faces, links = block_faces(grid, psi, u_s)
    spy = mock.Mock(wraps=getattr(wk, plain))
    with _no_messages_or_draws(grid), mock.patch.object(wk, plain, spy), \
            mock.patch.object(mesh, "exchange_faces", lambda f, grid: faces), \
            mock.patch.object(wk, "link_faces", lambda u, grid: links):
        got = run()
    assert spy.call_count == 1 and spy.call_args.args[-1] == 0.5
    assert float((got - grid.block(ref)).abs().max()) < 1e-12
