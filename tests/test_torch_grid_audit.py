"""The communication of the port's process grid, counted (the gloo counterpart of
tests/test_collective_audit.py).

A group of 4 gloo processes on the grid (1, 1, 2, 2) over 4x4x4x8 (two cut
axes, z and t) runs with torch.distributed's calls wrapped by a counting
communicator: every point-to-point message (its peer and its number of
elements), every all-reduce, all-gather and gather. The pins:

* a packed Wilson hop sends exactly 2 spinor face messages per cut axis;
  the backward links' faces go once per link tensor (2 per cut axis for a
  Dhat on fresh packed links, none on the next);
* a CG iteration adds 4 hops' face messages and scalar all-reduces only;
* a whole Wilson trajectory sends no message of a field's size and has no
  gather; its all-reduces are scalar;
* a domain-wall Shat^dag Shat exchanges each of its 4 L5 slice hops' faces,
  2 messages per cut axis per hop, and its packed links' faces once;
* a heatbath sweep's all-reduces are its early-stop checks, one integer
  each, one per 4 tries (every rank the same number), and an
  overrelaxation sweep has none;
* Savedata's gather of the links to rank 0 is the only field-sized traffic;
* a stout layer sends one slab of links per cut axis of each sharded roll of
  its staples, and its backward (the opposite rolls) as many of the same
  sizes, with no collective in either; both equal the global layer's
  blocks;
* a dense log det (Wilson D, staggered W) on a grid of the same PEs over
  2x2x4x4 exchanges the faces of each column once per hop (one exchange per
  column for D, two for W) and its links' faces once, and gathers the row
  slabs in one all_gather;
* with a chain axis of 2 (HMC.step_batched on a grid) a packed hop, a
  window D and a staggered W send per cut axis the messages of one chain,
  each with both chains' faces (twice the elements), and a batched CG
  iteration adds to its hops' faces only the two per-chain scalar
  all-reduces;
* a mixed-MD Wilson trajectory sends no message of a field's size and
  all-reduces scalars only, as the plain one;
* the chains split over the 4 ranks (4 chain groups of one process, one
  chain each) make a step that sends no message and no all-reduce;
* both at once (2 chain groups, each a grid (1, 1, 1, 2) over 4x4x4x8):
  each group's messages stay among its own ranks, and 4 Wilson chains, 2
  per group, equal one process's step_batched over the 4 (dH 1e-8, links
  1e-10).
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, run_ranks  # noqa: E402

PES = (1, 1, 2, 2)
LAT = (4, 4, 4, 8)
LOCAL = (4, 4, 2, 4)
NPROCS = 4
DW_L5 = 2
PHASES = ("dhat_fresh", "dhat_again", "cg3", "cg4", "trajectory", "save", "dw_fresh", "dw_again",
          "heatbath", "overrelax", "stout_forward", "stout_backward", "dense_wilson",
          "dense_staggered", "batched_dhat", "batched_window", "batched_w", "cg_multi3",
          "cg_multi4", "mixed_trajectory", "chain_split", "both")
DENSE_LAT = (2, 2, 4, 4)
NCHAIN = 2  # the chain axis of the batched phases
SPLIT_LAT = (4, 4, 4, 4)  # the chain split's lattice, uncut
BOTH_PES = (1, 1, 1, 2)  # each chain group's grid when both are split
BOTH_SEEDS = (81, 82, 83, 84)


class CountingCommunicator:
    """Wraps torch.distributed's calls and records them, per phase."""

    def __init__(self):
        self.phase = "setup"
        self.log = Counter()
        real_batch, real_reduce = dist.batch_isend_irecv, dist.all_reduce
        real_gather, real_allgather = dist.gather, dist.all_gather

        def batch(ops):
            for op in ops:
                kind = "send" if op.op is dist.isend else "recv"
                self._count(f"{kind}:{op.tensor.numel()}:{op.peer}")
            return real_batch(ops)

        def reduce(t, *a, **k):
            self._count(f"all_reduce:{t.numel()}")
            return real_reduce(t, *a, **k)

        def gather(*a, **k):
            self._count("gather")
            return real_gather(*a, **k)

        def all_gather(out, t, *a, **k):
            self._count(f"all_gather:{t.numel()}")
            return real_allgather(out, t, *a, **k)

        dist.batch_isend_irecv, dist.all_reduce = batch, reduce
        dist.gather, dist.all_gather = gather, all_gather

    def _count(self, key):
        self.log[(self.phase, key)] += 1

    def events(self, phase):
        return {k: n for (p, k), n in self.log.items() if p == phase}


def _case_audit(grid, savedir):
    from latticeqcd_torch.ops import fields, solvers
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases
    from latticeqcd_torch.system.lqcd import Savedata
    from latticeqcd_torch.updates.hmc import HMC
    from latticeqcd_torch.utils.logger import VerbosePrint
    from test_torch_grid_hmc import _hmc

    comm = CountingCommunicator()
    d = WilsonDirac(kappa=0.141139)
    u = fields.hot_start(LAT, 3, seed=3, device="cpu")
    ueo = d.packed_links(apply_boundary_phases(u))
    gen = torch.Generator().manual_seed(4)
    shape = (LOCAL[0] // 2,) + LOCAL[1:] + (4, 3)
    x = torch.complex(*(mesh.randn_block(shape, 0, gen, torch.float64, "cpu") for _ in range(2)))
    out = {}
    for phase in ("dhat_fresh", "dhat_again"):
        comm.phase = phase
        d.apply_dhat(ueo, x)
    for n in (3, 4):
        comm.phase = f"cg{n}"
        solvers.cg(lambda v: d.apply_dhat_ddag(ueo, v), x, eps=1e-300, maxiter=n)
    comm.phase = "trajectory"
    hmc = _hmc(True)
    u_new, st = HMC(action=hmc.action, dtau=0.1, md_steps=2,
                    fermi_action=hmc.fermi_action).step(u, gen)
    comm.phase = "save"
    Savedata("NPZ", savedir, 1, "HMC", VerbosePrint(level=0, myid=grid.rank)).save(u_new, 1, gen)
    out.update(_domainwall_and_heatbath(comm, u, gen))
    out.update(_stout_and_dense(comm, u, grid))
    out.update(_batched(comm, u, gen))
    for phase in PHASES:
        events = comm.events(phase)
        out[phase] = np.array(sorted(f"{k}={n}" for k, n in events.items()))
    return out


class _CountingUniforms:
    """The generator's uniforms, counting the tries drawn."""

    def __init__(self, generator):
        from latticeqcd_torch.updates.heatbath import GeneratorUniforms

        self.inner, self.tries_drawn = GeneratorUniforms(generator), 0

    def tries(self, shape, dtype, device):
        for parts in self.inner.tries(shape, dtype, device):
            self.tries_drawn += 1
            yield parts

    def direction(self, shape, dtype, device):
        return self.inner.direction(shape, dtype, device)


def _domainwall_and_heatbath(comm, u, gen):
    """Shat^dag Shat at L5 = DW_L5 on fresh and on the same packed links, a heatbath sweep
    (its tries counted) and an overrelaxation sweep, each its own phase."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.updates.heatbath import Heatbath

    d = DomainwallDirac(0.3, -1.8, DW_L5)
    ueo = d.packed_links(apply_boundary_phases(u))
    shape = (DW_L5, LOCAL[0] // 2) + LOCAL[1:] + (4, 3)
    x = torch.complex(*(mesh.randn_block(shape, 1, gen, torch.float64, "cpu") for _ in range(2)))
    for phase in ("dw_fresh", "dw_again"):
        comm.phase = phase
        d.apply_schur_ddag_d(ueo, x)
    hb = Heatbath(action=ga.wilson_gauge_action(3, 6.0))
    uniforms = _CountingUniforms(gen)
    comm.phase = "heatbath"
    u = hb.sweep(u, uniforms=uniforms)
    comm.phase = "overrelax"
    hb.overrelax(u)
    return {"heatbath_tries": np.asarray(uniforms.tries_drawn)}


def _stout_and_dense(comm, u, grid):
    """A stout layer's forward and the backward of Re tr of its output, each its own
    phase; then the Wilson and the staggered dense log det on a grid of the same PEs
    over DENSE_LAT."""
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.updates.slhmc import dense_logdet_fermi_action

    rng = np.random.default_rng(6)
    shape = (4,) + LAT + (3, 3)
    w_global = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    leaf = u.clone().requires_grad_(True)
    with torch.enable_grad():
        comm.phase = "stout_forward"
        smeared = stout_stack((0.1,)).smear(leaf)
        comm.phase = "stout_backward"
        (grad,) = torch.autograd.grad(
            torch.sum(torch.real(grid.block(w_global, lead=1).conj() * smeared)), leaf)
    comm.phase = "stout_global"
    with mesh.use_grid(None), torch.enable_grad():  # the global stack, in this process
        leaf = fields.hot_start(LAT, 3, seed=3, device="cpu").requires_grad_(True)
        smeared_g = stout_stack((0.1,)).smear(leaf)
        (grad_g,) = torch.autograd.grad(torch.sum(torch.real(w_global.conj() * smeared_g)), leaf)
    errors = [float((t - grid.block(g, lead=1)).abs().max())
              for t, g in ((smeared, smeared_g), (grad, grad_g))]
    dense = mesh.make_process_grid(grid.pes, DENSE_LAT, "cpu")
    with mesh.use_grid(dense):
        v = apply_boundary_phases(fields.hot_start(DENSE_LAT, 3, seed=5, device="cpu"))
        comm.phase = "dense_wilson"
        dense_logdet_fermi_action(WilsonDirac(kappa=0.12), DENSE_LAT + (4, 3), 1.0)(v)
        comm.phase = "dense_staggered"
        dense_logdet_fermi_action(StaggeredDirac(0.5, dense.local), DENSE_LAT + (3,), 0.5)(v)
    comm.phase = "done"
    return {"stout_errors": np.array(errors)}


def _both_hmc():
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    return HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2,
               fermi_action=WilsonFermiAction(WilsonDirac(kappa=0.141139), eps_cg=1e-22))


def _both_chains(lat, seeds):
    from latticeqcd_torch.ops import fields

    return torch.stack([fields.hot_start(lat, 3, seed=s, device="cpu") for s in seeds])


def _batched(comm, u, gen):
    """The batched phases: on the audit's grid a batched Dhat, window D and staggered W
    (NCHAIN chains, on links whose faces were exchanged once before) and 3 and 4
    iterations of a batched CG; a mixed-MD trajectory; then a chain-split step on 4 chain
    groups of one process and the Wilson chains of BOTH_SEEDS on 2 chain groups of a grid
    BOTH_PES each."""
    from latticeqcd_torch.ops import gauge_action as ga, solvers
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases
    from latticeqcd_torch.updates.hmc import HMC
    from test_torch_grid_hmc import _hmc

    d = WilsonDirac(kappa=0.141139)
    us = torch.stack([u, u.conj()])  # two chains with different links
    up = apply_boundary_phases(us)
    ueo = d.packed_links(up)
    rn = lambda shape, lead: torch.complex(*(mesh.randn_block(shape, lead, gen, torch.float64,  # noqa: E731
                                                              "cpu") for _ in range(2)))
    x = rn((NCHAIN, LOCAL[0] // 2) + LOCAL[1:] + (4, 3), 1)
    psi = rn((NCHAIN,) + LOCAL + (4, 3), 1)
    st = StaggeredDirac(0.5, LOCAL)
    seo = torch.func.vmap(st.packed_links)(up)
    chi = rn((NCHAIN, LOCAL[0] // 2) + LOCAL[1:] + (3,), 1)
    for phase, op in (("batched_dhat", lambda: d.apply_dhat(ueo, x)),
                      ("batched_window", lambda: d.apply(up, psi)),
                      ("batched_w", lambda: st.apply_w_packed(seo, chi))):
        comm.phase = "warm"
        op()  # the links' faces exchanged once
        comm.phase = phase
        op()
    for n in (3, 4):
        comm.phase = f"cg_multi{n}"
        solvers.cg_multi(lambda v: d.apply_dhat_ddag(ueo, v), x, eps=1e-300, maxiter=n)
    comm.phase = "mixed_trajectory"
    hmc = _hmc(True)
    HMC(action=hmc.action, dtau=0.1, md_steps=2, fermi_action=hmc.fermi_action,
        md_precision="mixed").step(u, gen)
    comm.phase = "setup"
    split = mesh.make_process_grid((1, 1, 1, 1), SPLIT_LAT, "cpu", chain_groups=NPROCS)
    both = mesh.make_process_grid(BOTH_PES, LAT, "cpu", chain_groups=2)
    with mesh.use_grid(split):
        chains = mesh.chain_share(list(BOTH_SEEDS))
        gens = [torch.Generator().manual_seed(s) for s in BOTH_SEEDS]
        comm.phase = "chain_split"
        HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=3).step_batched(
            _both_chains(SPLIT_LAT, chains), gens)
    with mesh.use_grid(both):
        chains = mesh.chain_share(list(BOTH_SEEDS))
        gens = [torch.Generator().manual_seed(s) for s in BOTH_SEEDS]
        comm.phase = "both"
        u_b, st_b = _both_hmc().step_batched(_both_chains(LAT, chains), gens)
        comm.phase = "done"
        return {"both_group": np.asarray(both.chains.index), "both_dh": st_b["dH"].numpy(),
                "both_accepted": st_b["accepted"].numpy(),
                "both_u": mesh.to_host_global(u_b, lead=2, all_ranks=True)}


def _rank_main(argv):
    rank_main(argv, {"audit": _case_audit})


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_audit")
    save = tmp_path_factory.mktemp("grid_audit_save")
    ranks = run_ranks("test_torch_grid_audit", "audit", PES, out, save)
    parsed = []
    for res in ranks:
        parsed.append({phase: Counter({k: int(n) for k, n in (e.rsplit("=", 1)
                                                              for e in res[phase])})
                       for phase in PHASES})
        parsed[-1]["heatbath_tries"] = int(res["heatbath_tries"])
        parsed[-1]["stout_errors"] = res["stout_errors"]
        parsed[-1].update({k: res[k] for k in ("both_group", "both_dh", "both_accepted",
                                                "both_u")})
    return parsed, save


def _sends(events):
    """{(number of elements, peer): count} of the messages sent."""
    out = Counter()
    for key, n in events.items():
        kind, *rest = key.split(":")
        if kind == "send":
            out[(int(rest[0]), int(rest[1]))] += n
    return out


def _face(mu, site_elems):
    """Elements of a packed face along mu (X/2 local) of a field with site_elems per site."""
    packed = (LOCAL[0] // 2,) + LOCAL[1:]
    return int(np.prod(packed)) // packed[mu] * site_elems


def _neighbours(rank):
    grid = mesh.ProcessGrid(PES, LAT, rank=rank)
    return {mu: (grid.neighbour(mu, -1), grid.neighbour(mu, +1)) for mu in grid.partitioned}


def test_packed_hop_sends_two_spinor_faces_per_cut_axis(audit):
    """A Dhat is two packed hops: 2 spinor face messages per cut axis each (to the +mu
    neighbour its last slab, to the -mu neighbour its first), and on fresh packed links
    one link face per link tensor and cut axis (u_e and u_o), none on the same links again."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        want_again, want_fresh = Counter(), Counter()
        for mu, (lo, hi) in _neighbours(rank).items():
            spinor = _face(mu, 12)
            want_again[(spinor, hi)] += 2  # one per hop
            want_again[(spinor, lo)] += 2
            want_fresh[(_face(mu, 9), hi)] += 2  # u_e's and u_o's link faces
        want_fresh.update(want_again)
        assert _sends(res["dhat_again"]) == want_again, rank
        assert _sends(res["dhat_fresh"]) == want_fresh, rank
        for phase in ("dhat_fresh", "dhat_again"):
            assert not [k for k in res[phase] if not k.startswith(("send", "recv"))], rank


def test_cg_iteration_adds_face_messages_and_scalar_all_reduces(audit):
    """One more CG iteration: 4 hops' face messages (2 per cut axis each) and two scalar
    all-reduces (p.Ap and |r|^2, one complex slot per rank), nothing else."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        extra = res["cg4"] - res["cg3"]
        want = Counter()
        for mu, (lo, hi) in _neighbours(rank).items():
            want[f"send:{_face(mu, 12)}:{hi}"] += 4
            want[f"send:{_face(mu, 12)}:{lo}"] += 4
            want[f"recv:{_face(mu, 12)}:{hi}"] += 4
            want[f"recv:{_face(mu, 12)}:{lo}"] += 4
        want[f"all_reduce:{2 * NPROCS}"] += 2
        assert extra == want, (rank, extra)


def test_trajectory_has_no_field_sized_traffic(audit):
    """A Wilson trajectory: every message at most one slab of a 3x3 link field (the
    sharded rolls of the gauge force, the faces of the hops), no gather, and all-reduces
    of one slot per rank (re and im) only."""
    ranks, _ = audit
    slab = int(np.prod(LOCAL)) // min(LOCAL) * 9
    for rank, res in enumerate(ranks):
        events = res["trajectory"]
        assert events, rank
        for key in events:
            kind, *rest = key.split(":")
            assert kind in ("send", "recv", "all_reduce"), key
            if kind == "all_reduce":
                assert int(rest[0]) <= 2 * NPROCS, key
            else:
                assert int(rest[0]) <= slab, key


def test_savedata_gather_is_the_only_field_traffic(audit):
    """Savedata gathers the links to rank 0: one block-sized message from each other
    rank, and rank 0 writes the file and the checkpoint."""
    ranks, save = audit
    block = 4 * int(np.prod(LOCAL)) * 9
    for rank, res in enumerate(ranks):
        if rank == 0:
            assert res["save"] == Counter({f"recv:{block}:{r}": 1 for r in range(1, NPROCS)})
        else:
            assert res["save"] == Counter({f"send:{block}:0": 1}), rank
    assert sorted(os.listdir(save)) == ["checkpoint.npz", "conf_00000001.npz"]
    assert np.load(os.path.join(save, "conf_00000001.npz"))["u"].shape == (4,) + LAT + (3, 3)


def test_domainwall_schur_normal_operator_exchanges_each_slice(audit):
    """A domain-wall Shat^dag Shat is 4 L5 packed hops, one per slice per hop: 2 spinor face
    messages per cut axis each (8 L5 in all per cut axis), and on fresh packed links the
    link faces of u_e and u_o once per cut axis, none on the same links again."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        want_again, want_fresh = Counter(), Counter()
        for mu, (lo, hi) in _neighbours(rank).items():
            want_again[(_face(mu, 12), hi)] += 4 * DW_L5
            want_again[(_face(mu, 12), lo)] += 4 * DW_L5
            want_fresh[(_face(mu, 9), hi)] += 2
        want_fresh.update(want_again)
        assert _sends(res["dw_again"]) == want_again, rank
        assert _sends(res["dw_fresh"]) == want_fresh, rank
        for phase in ("dw_fresh", "dw_again"):
            assert not [k for k in res[phase] if not k.startswith(("send", "recv"))], rank


def test_heatbath_sweep_all_reduces_are_its_early_stop_checks(audit):
    """A heatbath sweep all-reduces one integer per early-stop check (every 4 tries of each
    (mu, colour, subgroup) update), the same number on every rank as the tries each drew,
    its staples' rolls send at most a slab of links, and an overrelaxation sweep, which
    draws nothing, has no all-reduce."""
    ranks, _ = audit
    slab = int(np.prod(LOCAL)) // min(LOCAL) * 9
    updates = 4 * 2 * 3  # directions x colours x SU(2) subgroups of SU(3)
    tries = ranks[0]["heatbath_tries"]
    assert tries % 4 == 0 and updates * 4 <= tries <= updates * 48
    for rank, res in enumerate(ranks):
        assert res["heatbath_tries"] == tries, rank
        for phase in ("heatbath", "overrelax"):
            for key, n in res[phase].items():
                kind, *rest = key.split(":")
                assert kind in ("send", "recv", "all_reduce"), key
                if kind != "all_reduce":
                    assert int(rest[0]) <= slab, key
        assert {k: n for k, n in res["heatbath"].items() if k.startswith("all_reduce")} == \
            {"all_reduce:1": tries // 4}, rank
        assert not [k for k in res["overrelax"] if k.startswith("all_reduce")], rank


def test_stout_layer_on_two_cut_axes_matches_the_global_layer(audit):
    """A stout layer and the gradient of Re<W, smear(U)> with respect to the bare links on
    the blocks of a grid cut along z and t (staple paths cross both cuts, and a face
    link's gradient lands on the rank that holds it) against the global layer's blocks to
    1e-12."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        assert res["stout_errors"].max() < 1e-12, (rank, res["stout_errors"])


def _stout_rolls(rank):
    """{(number of elements, peer): count} a stout layer's staples send: one slab of links
    per cut axis of every sharded roll of staple_sum (a multi-axis roll moves axis by axis,
    each axis to the neighbour against its shift)."""
    from latticeqcd_torch.ops.wilsonline import make_loops_fromname, path_offsets

    grid = mesh.ProcessGrid(PES, LAT, rank=rank)
    lines = [l for line in make_loops_fromname("plaquette") for l in (line, line.adjoint())]
    want = Counter()
    for mu in range(4):
        for line in lines:
            steps = line.expand()
            offsets = path_offsets(steps)
            for k, (mu_k, sgn_k) in enumerate(steps):
                if mu_k != mu or sgn_k <= 0:
                    continue
                for j in list(range(k + 1, len(steps))) + list(range(k)):
                    at = offsets[j] if steps[j][1] > 0 else offsets[j + 1]
                    for nu in grid.partitioned:
                        shift = -(at[nu] - offsets[k][nu])
                        if shift:
                            slab = int(np.prod(LOCAL)) // LOCAL[nu] * 9
                            want[(slab, grid.neighbour(nu, 1 if shift > 0 else -1))] += 1
    return want


def test_stout_layer_sends_a_link_slab_per_cut_axis_of_each_roll(audit):
    """A stout layer's forward sends one slab of links per cut axis of each sharded roll
    of its staples, and its backward, the opposite rolls, the same number of the same
    sizes to the opposite neighbours; neither all-reduces or gathers."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        fwd, bwd = _sends(res["stout_forward"]), _sends(res["stout_backward"])
        assert fwd == _stout_rolls(rank), rank
        grid = mesh.ProcessGrid(PES, LAT, rank=rank)
        flip = {grid.neighbour(mu, s): grid.neighbour(mu, -s) for mu in grid.partitioned
                for s in (1, -1)}
        assert bwd == Counter({(n, flip[peer]): c for (n, peer), c in fwd.items()}), rank
        for phase in ("stout_forward", "stout_backward"):
            assert not [k for k in res[phase] if not k.startswith(("send", "recv"))], rank


@pytest.mark.parametrize("kind", ["wilson", "staggered"])
def test_dense_logdet_exchanges_each_column_and_gathers_once(audit, kind):
    """The dense log det on DENSE_LAT: per column one exchange of the spinor faces per hop
    (D one hop; staggered W two, the faces of D_oe phi exchanged between them), 2
    messages per cut axis each, the links' faces once (1 per cut axis; u_e and u_o for
    W), and one all_gather of this rank's rows of every column, nothing else."""
    ranks, _ = audit
    local = tuple(n // p for n, p in zip(DENSE_LAT, PES))
    nsite = int(np.prod(local))
    if kind == "wilson":
        per_site, dim, hops, links = 12, int(np.prod(DENSE_LAT)) * 12, 1, 1
        face = lambda mu: nsite // local[mu] * per_site  # noqa: E731
        link = lambda mu: nsite // local[mu] * 9  # noqa: E731
    else:
        per_site, dim, hops, links = 3, int(np.prod(DENSE_LAT)) * 3 // 2, 2, 2
        packed = (local[0] // 2,) + local[1:]
        face = lambda mu: int(np.prod(packed)) // packed[mu] * per_site  # noqa: E731
        link = lambda mu: int(np.prod(packed)) // packed[mu] * 9  # noqa: E731
    rows = dim // NPROCS
    for rank, res in enumerate(ranks):
        grid = mesh.ProcessGrid(PES, DENSE_LAT, rank=rank)
        want = Counter()
        for mu in grid.partitioned:
            lo, hi = grid.neighbour(mu, -1), grid.neighbour(mu, +1)
            want[f"send:{face(mu)}:{hi}"] += hops * dim
            want[f"send:{face(mu)}:{lo}"] += hops * dim
            want[f"recv:{face(mu)}:{hi}"] += hops * dim
            want[f"recv:{face(mu)}:{lo}"] += hops * dim
            want[f"send:{link(mu)}:{hi}"] += links
            want[f"recv:{link(mu)}:{lo}"] += links
        want[f"all_gather:{rows * dim}"] += 1
        assert res[f"dense_{kind}"] == want, (rank, kind)


def _face_of(local, mu, site_elems):
    """Elements of a face along mu of a field on ``local`` sites with site_elems per site."""
    return int(np.prod(local)) // local[mu] * site_elems


@pytest.mark.parametrize("phase,hops,local,site", [
    ("batched_dhat", 2, (LOCAL[0] // 2,) + LOCAL[1:], 12),
    ("batched_window", 1, LOCAL, 12),
    ("batched_w", 2, (LOCAL[0] // 2,) + LOCAL[1:], 3)], ids=["packed_hop", "window", "staggered_w"])
def test_batched_operator_sends_one_chains_messages(audit, phase, hops, local, site):
    """With a chain axis of NCHAIN, on links whose faces were exchanged: each hop sends per
    cut axis the 2 messages of one chain (to the +mu neighbour its last slab, to the -mu
    neighbour its first), each holding every chain's face, NCHAIN times one chain's
    elements, and nothing else."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        want = Counter()
        for mu, (lo, hi) in _neighbours(rank).items():
            face = NCHAIN * _face_of(local, mu, site)
            want[(face, hi)] += hops
            want[(face, lo)] += hops
        assert _sends(res[phase]) == want, (rank, phase)
        assert not [k for k in res[phase] if not k.startswith(("send", "recv"))], rank


def test_batched_cg_iteration_adds_per_chain_scalar_all_reduces(audit):
    """One more iteration of a batched CG over NCHAIN chains: 4 hops' face messages, each
    holding every chain's face, and the two all-reduces of per-chain scalars (p.Ap and
    |r|^2, NCHAIN real slots per rank), nothing else."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        extra = res["cg_multi4"] - res["cg_multi3"]
        want = Counter()
        for mu, (lo, hi) in _neighbours(rank).items():
            face = NCHAIN * _face(mu, 12)
            for peer in (lo, hi):
                want[f"send:{face}:{peer}"] += 4
                want[f"recv:{face}:{peer}"] += 4
        want[f"all_reduce:{NCHAIN * NPROCS}"] += 2
        assert extra == want, (rank, extra)


def test_mixed_trajectory_has_no_field_sized_traffic(audit):
    """A mixed-MD Wilson trajectory on the grid: every message at most one slab of a 3x3
    link field, no gather, and all-reduces of one slot per rank (re and im) only."""
    ranks, _ = audit
    slab = int(np.prod(LOCAL)) // min(LOCAL) * 9
    for rank, res in enumerate(ranks):
        events = res["mixed_trajectory"]
        assert events, rank
        for key in events:
            kind, *rest = key.split(":")
            assert kind in ("send", "recv", "all_reduce"), key
            assert int(rest[0]) <= (2 * NPROCS if kind == "all_reduce" else slab), key


def test_chain_split_step_sends_nothing(audit):
    """The chains split over the 4 ranks (one chain each, the lattice uncut): the step makes
    no message, no all-reduce and no gather."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        assert res["chain_split"] == Counter(), (rank, res["chain_split"])


def test_both_layouts_talk_within_each_chain_group(audit):
    """Two chain groups of a grid (1, 1, 1, 2) each: every message goes to the other rank
    of the sender's own group, every all-reduce is of one group's slots (2 ranks, per-chain
    or scalar values)."""
    ranks, _ = audit
    for rank, res in enumerate(ranks):
        mate = rank ^ 1  # world ranks 2g and 2g + 1 form group g
        assert int(res["both_group"]) == rank // 2, rank
        assert res["both"], rank
        for key in res["both"]:
            kind, *rest = key.split(":")
            assert kind in ("send", "recv", "all_reduce"), key
            if kind == "all_reduce":
                assert int(rest[0]) <= 2 * 2 * NCHAIN, key
            else:
                assert int(rest[1]) == mate, key


def test_both_layouts_equal_one_process(audit):
    """The 4 Wilson chains of BOTH_SEEDS, 2 per chain group, each group's lattice cut along
    t: per chain dH 1e-8, the decisions and links 1e-10 against one process's step_batched
    over the 4 from the same generators; the ranks of a group bitwise equal."""
    ranks, _ = audit
    gens = [torch.Generator().manual_seed(s) for s in BOTH_SEEDS]
    u_ref, st_ref = _both_hmc().step_batched(_both_chains(LAT, BOTH_SEEDS), gens)
    for rank, res in enumerate(ranks):
        sl = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        assert np.abs(res["both_dh"] - st_ref["dH"].numpy()[sl]).max() < 1e-8, rank
        assert np.array_equal(res["both_accepted"], st_ref["accepted"].numpy()[sl]), rank
        assert np.abs(res["both_u"] - u_ref.numpy()[sl]).max() < 1e-10, rank
        assert res["both_dh"].tobytes() == ranks[rank ^ 1]["both_dh"].tobytes(), rank
