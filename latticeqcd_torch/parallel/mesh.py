"""The 4D process grid and its communicator, on torch.distributed.

Counterpart of latticeqcd_tpu/parallel/mesh.py, the reference's MPI
domain decomposition (a 4D process grid ``PEs``; mpimodule.jl,
mpirun.jl). The JAX package shards its arrays over a device mesh and
lets XLA's partitioner turn every roll into halo permutes and every sum
into a psum. PyTorch has no such compiler, so the port writes the
communication out:

* one process per block of the lattice. A ``ProcessGrid`` holds the PEs,
  this rank's grid coordinates, its neighbours along +-mu, the local
  extents and the local origin (x fastest last: rank
  ((cx PY + cy) PZ + cz) PT + ct, the JAX mesh's device order);
* while a grid is active (``use_grid``), every field is this rank's
  block: ops/rolls.py shifts across a partitioned axis by exchanging
  boundary slabs with the neighbours, the kernels (the packed Wilson
  hop, the staggered hop and W, the full Wilson D) read their halos from
  exchanged face buffers (``exchange_faces``), every lattice sum goes
  through ``global_sum``, every random field is the global field's
  draw with this rank's block kept (``randn_block``, ``randint_block``,
  ``rand_block``), a loop that stops once a condition holds on every
  site asks ``global_all``, and a dense matrix whose rows are split over
  the ranks (the dense log det's) is gathered whole on every rank in one
  collective (``gather_blocks``);
* ``global_sum`` all-reduces scalars only (or one per chain). Each rank
  writes its partial sum into its own slot of a vector of nprocs entries,
  the vector is all-reduced (a sum of one value with zeros is exact), and
  every rank adds the slots in rank order: the result is bitwise the same on every
  rank whatever the backend's reduction order, so CG exits and the
  Metropolis decision, which branch on it, agree everywhere;
* the backend is an explicit argument. ``gloo`` stages faces and sums
  through host memory (the CPU tests; several ranks on one card);
  ``nccl`` sends device buffers and needs a card per rank;
* independent chains (HMC.step_batched) may be split over groups of
  ranks: nprocs = (chain groups) x prod(PEs), world rank g prod(PEs) + r
  for grid rank r of chain group g. A ``ProcessGrid`` always means one
  group's lattice grid: it holds the group's own communicator (``group``,
  None for the whole world) and its members' world ranks, every collective
  passes ``group=`` and every message is addressed to a member's world
  rank, so a chain split changes nothing that a lattice-side function
  computes; ``sharded()`` is None exactly when the lattice is not cut. Its
  ``chains`` (a ``ChainGroups``) says how many groups there are, which is
  this rank's and which share of n chains it runs (contiguous, equal);
  ``chain_split()`` returns it while a grid with more than one group is
  active. Chains of different groups never talk: a chain split sends
  nothing;
* a field may lead with a chain axis (``lead``: its lattice axes at
  lead..lead + 3): ``exchange_faces``, ``pass_slabs`` and ``roll_axis``
  carry the faces of all its chains in one message per direction and cut
  axis, and ``global_sum`` of a per-chain vector gives per-chain totals in
  one all-reduce. ``_GlobalSum`` has a vmap rule (moves the batch dimension
  to the front, one all-reduce for all chains), as ops/rolls.py's
  ``ShardedRoll`` has, so that the gauge side that HMC.step_batched maps
  over the chains with torch.func.vmap stays one collective per call.

Every local extent must be even: then every local origin is even and the
even-odd row parity (y + z + t) mod 2 (ops/dirac/eo_pack.py) is the same
in local and global coordinates.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("x", "y", "z", "t")
BACKENDS = ("gloo", "nccl")

_PES: Tuple[int, int, int, int] = (1, 1, 1, 1)


def set_PEs(pes) -> None:
    global _PES
    pes = tuple(int(p) for p in pes)
    if len(pes) != 4:
        raise ValueError(f"PEs must have 4 entries, got {pes}")
    _PES = pes


def get_PEs() -> Tuple[int, int, int, int]:
    return _PES


def default_pes(n_devices: int) -> Tuple[int, int, int, int]:
    """Factor n_devices into a 4D grid, loading the t axis first (time
    is usually the longest lattice extent)."""
    pes = [1, 1, 1, 1]
    rem = n_devices
    for axis in (3, 2, 1, 0):
        f = 1
        for cand in range(rem, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        pes[axis] = f
        rem //= f
        if rem == 1:
            break
    if int(np.prod(pes)) != n_devices:
        raise ValueError(f"cannot factor {n_devices} devices into a 4D grid")
    return tuple(pes)


# ------------------------------------------------------------------ processes


def init_process_grid(backend: str, coordinator: Optional[str] = None,
                      nprocs: Optional[int] = None, procid: Optional[int] = None,
                      timeout_s: float = 600.0) -> None:
    """Join the process group (the MPI_COMM_WORLD analog), idempotent.

    With ``coordinator`` "host:port" the group is nprocs processes of which
    this is procid; without it, the env:// variables that torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). ``backend`` is "gloo" or
    "nccl" and is never chosen for the caller. A collective that waits longer
    than ``timeout_s`` raises instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        if nprocs is None or procid is None:
            raise ValueError("a coordinator needs nprocs and procid")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(nprocs), rank=int(procid), timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)


def close_process_grid() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def get_myrank() -> int:
    """Process index (the reference's get_myrank); 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_nprocs() -> int:
    """Process count (the reference's get_nprocs); 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    """This process's index among those of its host: LOCAL_RANK (torchrun), else the rank."""
    return int(os.environ.get("LOCAL_RANK", get_myrank()))


def is_rank0() -> bool:
    return get_myrank() == 0


def println_rank0(*vals) -> None:
    """Rank-0-gated print (mpi/simpleprint.jl)."""
    if is_rank0():
        print(*vals, flush=True)


# ---------------------------------------------------------------- the grid


@dataclass(frozen=True)
class ChainGroups:
    """How independent chains are split over groups of ranks: ``groups`` groups, this
    rank's ``index``; each runs a contiguous, equal share of the n chains."""

    groups: int = 1
    index: int = 0

    def __post_init__(self):
        if self.groups < 1 or not 0 <= self.index < self.groups:
            raise ValueError(f"chain group {self.index} of {self.groups}")

    def share(self, n: int) -> slice:
        """This group's chains among n: contiguous and equal (n divisible by the groups)."""
        if n % self.groups:
            raise ValueError(f"{n} chains do not split evenly over {self.groups} chain groups")
        k = n // self.groups
        return slice(self.index * k, (self.index + 1) * k)


@dataclass(frozen=True)
class ProcessGrid:
    """This rank's place in a 4D process grid over a global ``lattice``.

    ``backend`` names how its messages travel ("gloo" or "nccl") and
    ``device`` is where this rank's fields live. ``rank`` is the rank within
    the grid; ``group`` is the communicator of the grid's processes (None: the
    whole process group) and ``members`` their world ranks in grid-rank order
    (empty: the grid ranks are the world ranks); ``chains`` is the chain split
    the grid is one group of. Construction checks the geometry only (the
    extents divide, every local extent is even); it sends nothing, so a grid
    can be built for any rank to inspect its layout. ``make_process_grid``
    builds this process's grid from the process group."""

    pes: tuple
    lattice: tuple
    rank: int = 0
    backend: str = "gloo"
    device: torch.device = torch.device("cuda")
    group: Any = field(default=None, compare=False, repr=False)
    members: tuple = ()
    chains: "ChainGroups" = None

    def __post_init__(self):
        pes = tuple(int(p) for p in self.pes)
        lattice = tuple(int(n) for n in self.lattice)
        if len(pes) != 4 or len(lattice) != 4 or min(pes) < 1:
            raise ValueError(f"PEs and the lattice need 4 positive entries, got {pes}, {lattice}")
        for mu in range(4):
            if lattice[mu] % pes[mu]:
                raise ValueError(f"PEs {pes} do not divide the lattice {lattice} along "
                                 f"{AXES[mu]}")
            if (lattice[mu] // pes[mu]) % 2:
                raise ValueError(
                    f"PEs {pes} give the local extent {lattice[mu] // pes[mu]} along {AXES[mu]} "
                    f"of the lattice {lattice}: every local extent must be even, so that the "
                    "even-odd row parity is the same in local and global coordinates")
        if not 0 <= int(self.rank) < math.prod(pes):
            raise ValueError(f"rank {self.rank} outside the grid {pes}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        object.__setattr__(self, "pes", pes)
        object.__setattr__(self, "lattice", lattice)
        object.__setattr__(self, "rank", int(self.rank))
        object.__setattr__(self, "device", torch.device(self.device))
        object.__setattr__(self, "members", tuple(int(m) for m in self.members))
        if self.members and len(self.members) != math.prod(pes):
            raise ValueError(f"a grid of {math.prod(pes)} processes needs as many members, got "
                             f"{self.members}")
        if self.chains is None:
            object.__setattr__(self, "chains", ChainGroups())

    def world_rank(self, rank: int) -> int:
        """The world rank of the grid's process ``rank`` (its peer in a message)."""
        return self.members[rank] if self.members else int(rank)

    @property
    def nprocs(self) -> int:
        return math.prod(self.pes)

    @property
    def coords(self) -> tuple:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.pes))

    @property
    def local(self) -> tuple:
        """The local extents."""
        return tuple(n // p for n, p in zip(self.lattice, self.pes))

    @property
    def origin(self) -> tuple:
        """The global coordinates of this rank's first site."""
        return tuple(c * n for c, n in zip(self.coords, self.local))

    @property
    def partitioned(self) -> tuple:
        """The axes the grid cuts (more than one process along them)."""
        return tuple(mu for mu in range(4) if self.pes[mu] > 1)

    def neighbour(self, mu: int, step: int) -> int:
        """The rank of the block at +-1 along mu (periodic)."""
        c = list(self.coords)
        c[mu] = (c[mu] + step) % self.pes[mu]
        return int(np.ravel_multi_index(c, self.pes))

    def holds_last(self, mu: int) -> bool:
        """Whether this block holds the global last slice along mu."""
        return self.coords[mu] == self.pes[mu] - 1

    def global_shape(self, shape, lead: int = 0) -> tuple:
        """The global shape of a local field whose lattice axes are lead..lead + 3."""
        shape = list(shape)
        for mu in range(4):
            shape[lead + mu] *= self.pes[mu]
        return tuple(shape)

    def block(self, x, lead: int = 0):
        """This rank's block of a global field whose lattice axes are lead..lead + 3
        (a packed field's x axis holds X/2 sites: its block is X/2 / PX of them)."""
        for mu in range(4):
            n = x.shape[lead + mu] // self.pes[mu]
            x = x[(slice(None),) * (lead + mu) + (slice(self.coords[mu] * n,
                                                       (self.coords[mu] + 1) * n),)]
        return x

    @property
    def comm_device(self) -> torch.device:
        """Where message buffers live: host memory under gloo, the card under nccl."""
        return torch.device("cpu") if self.backend == "gloo" else self.device


_SUBGROUPS: dict = {}


def _subgroups(ngroups: int, size: int):
    """The communicators of ngroups groups of ``size`` consecutive world ranks, made once
    per layout (dist.new_group is collective: every rank makes every group, in order)."""
    key = (ngroups, size)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = [dist.new_group(list(range(g * size, (g + 1) * size)))
                           for g in range(ngroups)]
    return _SUBGROUPS[key]


def make_process_grid(pes, lattice, device, backend: Optional[str] = None,
                      chain_groups: int = 1) -> ProcessGrid:
    """This process's grid over the initialised process group. The group's size must be
    chain_groups times the product of the PEs: world rank g prod(PEs) + r is grid rank r
    of chain group g, and each chain group's grid talks on a communicator of its own.
    Under nccl every rank needs its own card."""
    chain_groups = int(chain_groups)
    if chain_groups < 1:
        raise ValueError(f"chain_groups must be >= 1, got {chain_groups}")
    if not dist.is_initialized():
        if math.prod(pes) * chain_groups != 1:
            raise ValueError(f"PEs {tuple(pes)} and {chain_groups} chain groups need a process "
                             f"group of {math.prod(pes) * chain_groups}: call "
                             "init_process_grid first")
        return ProcessGrid(pes, lattice, 0, backend or "gloo", device)
    group_backend = dist.get_backend()
    if backend is not None and backend != group_backend:
        raise ValueError(f"the process group runs {group_backend}, not {backend}")
    size = math.prod(pes)
    if size * chain_groups != dist.get_world_size():
        raise ValueError(f"PEs {tuple(pes)} and {chain_groups} chain groups do not match "
                         f"{dist.get_world_size()} processes")
    world = dist.get_rank()
    if chain_groups == 1:
        grid = ProcessGrid(pes, lattice, world, group_backend, device)
    else:
        index = world // size
        grid = ProcessGrid(pes, lattice, world % size, group_backend, device,
                           group=_subgroups(chain_groups, size)[index],
                           members=tuple(range(index * size, (index + 1) * size)),
                           chains=ChainGroups(chain_groups, index))
    if group_backend == "nccl":
        if grid.device.type != "cuda":
            raise ValueError(f"nccl sends device buffers: the fields must live on a card, "
                             f"not {grid.device}")
        torch.cuda.set_device(grid.device)
        places = [None] * dist.get_world_size()
        dist.all_gather_object(places, (socket.gethostname(), torch.cuda.current_device()))
        if len(set(places)) != len(places):
            raise ValueError(f"nccl needs one card per rank, but ranks share cards: {places}; "
                             "run several ranks on one card with gloo")
    return grid


# The grid the current run's fields are blocks of. The JAX package carries its sharding
# in the arrays; the port carries it here, set for the length of a run by use_grid, so that
# the operators and sums that one process and a grid share keep their signatures.
_ACTIVE: Optional[ProcessGrid] = None


@contextlib.contextmanager
def use_grid(grid: Optional[ProcessGrid]):
    """Make ``grid`` the active grid inside the block (None: no grid); the one before
    it is restored on the way out."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = grid
    try:
        yield grid
    finally:
        _ACTIVE = before


def sharded() -> Optional[ProcessGrid]:
    """The active grid if it cuts the lattice (more than one process), else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.nprocs > 1 else None


def chain_split() -> Optional[ChainGroups]:
    """The active grid's chain split if it has more than one chain group, else None."""
    return _ACTIVE.chains if _ACTIVE is not None and _ACTIVE.chains.groups > 1 else None


def chain_share(chains):
    """This rank's share of the stacked chains (a tensor with a leading chain axis, or a
    list of per-chain items) under the active chain split; all of them without one."""
    split = chain_split()
    return chains if split is None else chains[split.share(len(chains))]


def refuse_under_grid(what: str) -> None:
    """Raise, before any draw, launch or message, for what has no multi-process form."""
    if sharded() is not None:
        raise NotImplementedError(f"{what} under a process grid is not ported yet "
                                  "(ROADMAP A14b)")


# ------------------------------------------------------------ fields and sums


def shard_links(u: torch.Tensor, grid: Optional[ProcessGrid] = None) -> torch.Tensor:
    """This rank's block of global links U[mu, X, Y, Z, T, a, b]."""
    grid = grid or _ACTIVE
    return u if grid is None else grid.block(u, lead=1).contiguous()


def _drawn_block(draw, shape, lead: int) -> torch.Tensor:
    """draw(shape) for a local field of ``shape`` (lattice axes lead..lead + 3): under a
    grid the global field's draw from the run's generator (the same seed on every rank)
    with this rank's block kept, so that a sharded run draws what one process draws."""
    grid = sharded()
    if grid is None:
        return draw(shape)
    return grid.block(draw(grid.global_shape(shape, lead)), lead).contiguous()


def randn_block(shape, lead: int, generator, dtype, device) -> torch.Tensor:
    """Normals for a local field of ``shape`` (lattice axes lead..lead + 3), drawn as
    ``_drawn_block`` says."""
    return _drawn_block(lambda s: torch.randn(s, generator=generator, dtype=dtype,
                                              device=device), shape, lead)


def randint_block(high: int, shape, lead: int, generator, device) -> torch.Tensor:
    """Integers in [0, high) for a local field of ``shape``, drawn as ``_drawn_block``
    says."""
    return _drawn_block(lambda s: torch.randint(0, high, s, generator=generator, device=device),
                        shape, lead)


def rand_block(shape, lead: int, generator, dtype, device) -> torch.Tensor:
    """Uniforms in [0, 1) for a local field of ``shape``, drawn as ``_drawn_block`` says."""
    return _drawn_block(lambda s: torch.rand(s, generator=generator, dtype=dtype,
                                             device=device), shape, lead)


def _staged(t: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    return t.detach().to(grid.comm_device).contiguous()


def _group(grid: ProcessGrid) -> dict:
    """The group= argument of a collective on ``grid`` (none for the whole world)."""
    return {} if grid.group is None else {"group": grid.group}


class _GlobalSum(torch.autograd.Function):
    """The sum over ranks of a small tensor; the gradient of the total with respect to
    each rank's part is the identity. Under torch.func.vmap (the gauge side of
    HMC.step_batched) the batch dimension goes to the front and one all-reduce sums
    every chain's part."""

    @staticmethod
    def forward(x):
        grid = _ACTIVE
        parts = torch.view_as_real(x) if x.is_complex() else x
        flat = _staged(parts, grid).reshape(-1)
        slots = torch.zeros((grid.nprocs, flat.numel()), dtype=flat.dtype, device=flat.device)
        slots[grid.rank] = flat
        dist.all_reduce(slots, **_group(grid))
        total = slots[0]
        for r in range(1, grid.nprocs):  # rank order on every rank: bitwise the same result
            total = total + slots[r]
        total = total.reshape(parts.shape).to(x.device)
        return torch.view_as_complex(total) if x.is_complex() else total

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g

    @staticmethod
    def vmap(info, in_dims, x):
        if in_dims[0] is None:
            return _GlobalSum.apply(x), None
        return _GlobalSum.apply(x.movedim(in_dims[0], 0)), 0


def global_sum(x):
    """The sum of x over the ranks of the active grid, bitwise the same on every rank;
    x itself without a grid. x is a scalar or a few scalars (one per chain), never a
    field."""
    if sharded() is None or not torch.is_tensor(x):
        return x
    return _GlobalSum.apply(x)


def global_all(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the active grid (one all-reduce of one
    integer); ``flag`` itself without a grid."""
    grid = sharded()
    if grid is None:
        return bool(flag)
    t = torch.tensor([0 if flag else 1], dtype=torch.int64, device=grid.comm_device)
    dist.all_reduce(t, **_group(grid))
    return int(t) == 0


def global_volume(local_lattice) -> int:
    """The number of sites of the lattice whose local extents are given."""
    grid = sharded()
    return math.prod(local_lattice) * (1 if grid is None else grid.nprocs)


# --------------------------------------------------------------- messages


def _exchange(grid: ProcessGrid, sends, recv_like):
    """One batch of point-to-point messages: ``sends`` [(peer, tag, tensor)],
    ``recv_like`` [(peer, tag, template)], peers by grid rank; returns the received
    tensors on the templates' device, in order. The order of posting is the same on
    every rank, which pairs the messages under nccl; the tags pair them under gloo."""
    kw = _group(grid)
    ops = [dist.P2POp(dist.isend, _staged(t, grid), grid.world_rank(peer), tag=tag, **kw)
           for peer, tag, t in sends]
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=grid.comm_device) for _, _, t in recv_like]
    ops += [dist.P2POp(dist.irecv, b, grid.world_rank(peer), tag=tag, **kw)
            for (peer, tag, _), b in zip(recv_like, bufs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(t.device) for b, (_, _, t) in zip(bufs, recv_like)]


def pass_slabs(slabs: dict, step: int, grid: ProcessGrid) -> dict:
    """{mu: slab}: each slab goes to the neighbour at ``step`` (+-1) along mu, and the
    one from the neighbour at -step comes back, in one batch (a slab with a chain axis
    carries every chain's in its one message)."""
    mus = sorted(slabs)
    tag = lambda mu: 16 + 2 * mu + (step > 0)  # noqa: E731
    got = _exchange(grid, [(grid.neighbour(mu, step), tag(mu), slabs[mu]) for mu in mus],
                    [(grid.neighbour(mu, -step), tag(mu), slabs[mu]) for mu in mus])
    return dict(zip(mus, got))


def roll_axis(x: torch.Tensor, shift: int, mu: int, grid: ProcessGrid,
              lead: int = 0) -> torch.Tensor:
    """torch.roll of the global field by ``shift`` along lattice axis mu (tensor dim
    lead + mu), on this rank's block: the slabs that leave the block go to the neighbour,
    those that enter come from the other one. A shift longer than the block moves in
    pieces."""
    d = lead + mu
    n = x.shape[d]
    shift = shift % (n * grid.pes[mu])
    if shift > n * grid.pes[mu] // 2:
        shift -= n * grid.pes[mu]
    while shift != 0:
        s = max(-n, min(n, shift))
        if s > 0:  # out[i] = x[i - s]: the first s slabs come from the -mu neighbour
            head = pass_slabs({mu: x.narrow(d, n - s, s)}, +1, grid)[mu]
            x = torch.cat([head, x.narrow(d, 0, n - s)], dim=d)
        else:  # out[i] = x[i + k]: the last k slabs come from the +mu neighbour
            tail = pass_slabs({mu: x.narrow(d, 0, -s)}, -1, grid)[mu]
            x = torch.cat([x.narrow(d, -s, n + s), tail], dim=d)
        shift -= s
    return x


def exchange_faces(f: torch.Tensor, grid: ProcessGrid, lead: int = 0) -> dict:
    """Face buffers of a site field (lattice axes lead..lead + 3) for each partitioned
    axis mu: {mu: (lo, hi)}, lo the -mu neighbour's last slab and hi the +mu neighbour's
    first slab, each contiguous with axis mu removed (so a row along t is contiguous;
    with a chain axis, chain after chain). Two messages per partitioned axis, all in one
    batch, whatever the chains."""
    sends, recvs = [], []
    for mu in grid.partitioned:
        first, last = f.select(lead + mu, 0), f.select(lead + mu, f.shape[lead + mu] - 1)
        sends += [(grid.neighbour(mu, +1), 2 * mu, last), (grid.neighbour(mu, -1), 2 * mu + 1, first)]
        recvs += [(grid.neighbour(mu, -1), 2 * mu, last), (grid.neighbour(mu, +1), 2 * mu + 1, first)]
    got = _exchange(grid, sends, recvs)
    return {mu: (got[2 * i], got[2 * i + 1]) for i, mu in enumerate(grid.partitioned)}


def _assemble(blocks, grid: ProcessGrid, lead: int) -> torch.Tensor:
    """The global field from every rank's block, in rank order."""
    b0 = blocks[0]
    out = torch.empty(grid.global_shape(b0.shape, lead), dtype=b0.dtype, device=b0.device)
    for r, b in enumerate(blocks):
        coords = np.unravel_index(r, grid.pes)
        out[(slice(None),) * lead + tuple(
            slice(c * b.shape[lead + mu], (c + 1) * b.shape[lead + mu])
            for mu, c in enumerate(coords))] = b
    return out


def gather_blocks(x: torch.Tensor, lead: int = 0, grid: Optional[ProcessGrid] = None):
    """The global field whose block on this rank is x (lattice axes lead..lead + 3,
    any axes after them), on every rank and on x's device: one all_gather. Every rank
    must call it. Without a grid, x itself."""
    grid = grid or sharded()
    if grid is None:
        return x
    block = _staged(x, grid)
    blocks = [torch.empty_like(block) for _ in range(grid.nprocs)]
    dist.all_gather(blocks, block, **_group(grid))
    return _assemble(blocks, grid, lead).to(x.device)


def to_host_global(x: torch.Tensor, lead: int = 0, all_ranks: bool = False,
                   grid: Optional[ProcessGrid] = None):
    """Gather the blocks of a field (lattice axes lead..lead + 3) into one numpy array
    of the global shape: on rank 0 (None elsewhere), or on every rank. Every rank
    must call it. Without a grid, the field itself on the host."""
    grid = grid or sharded()
    if grid is None:
        return x.detach().cpu().numpy()
    if all_ranks:
        return gather_blocks(x.detach(), lead, grid).cpu().numpy()
    block = _staged(x, grid)
    if grid.rank != 0:
        _exchange(grid, [(0, 32, block)], [])
        return None
    blocks = [block] + _exchange(grid, [], [(r, 32, block) for r in range(1, grid.nprocs)])
    return _assemble(blocks, grid, lead).cpu().numpy()
