"""Periodic lattice shifts, on one process or across a process grid.

Counterpart of latticeqcd_tpu/ops/rolls.py. Every caller treats tensor
dims 0..3 as the lattice axes (x may be the packed x' of an even-odd
field). Without a process grid, or along an axis the grid does not cut,
this is torch.roll, whose backward is the opposite roll. Along a cut
axis the field is this rank's block, and the roll exchanges the slabs
that cross the block's faces with the neighbours (parallel/mesh.py); it
is an autograd Function whose backward is the opposite sharded roll, as
the JAX package's roll_p pins the transpose of its roll, so that link
gradients at the faces land on the rank that holds the link. Shifts of
any length are allowed (a shift longer than the block moves in pieces),
and a multi-axis shift composes axis by axis.
"""

from __future__ import annotations

import torch

from latticeqcd_torch.parallel import mesh


def _normalise(shift, axis):
    if isinstance(axis, (tuple, list)):
        return tuple(int(s) for s in shift), tuple(int(a) for a in axis)
    return (int(shift),), (int(axis),)


def _check_block(x: torch.Tensor, grid) -> None:
    """A block's y and z extents are the grid's local ones; a leading chain axis would
    move them (batched chains have no form under a grid)."""
    if x.ndim < 4 or tuple(x.shape[1:3]) != grid.local[1:3] or x.shape[0] not in (
            grid.local[0], grid.local[0] // 2):
        raise NotImplementedError(
            f"a field of shape {tuple(x.shape)} is not a block of the grid {grid.pes} (local "
            f"extents {grid.local}); a leading chain axis under a process grid is not ported "
            "yet (ROADMAP A14b)")


def _sharded(x, shifts, axes, grid):
    for s, mu in zip(shifts, axes):
        x = torch.roll(x, s, mu) if grid.pes[mu] == 1 else mesh.roll_axis(x, s, mu, grid)
    return x


class ShardedRoll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shifts, axes, grid):
        ctx.shifts, ctx.axes, ctx.grid = shifts, axes, grid
        return _sharded(x, shifts, axes, grid)

    @staticmethod
    def backward(ctx, g):
        back = tuple(-s for s in reversed(ctx.shifts))
        return ShardedRoll.apply(g, back, tuple(reversed(ctx.axes)), ctx.grid), None, None, None


def roll(x: torch.Tensor, shift, axis) -> torch.Tensor:
    """jnp.roll semantics on the global lattice: an int or a tuple of shifts over the
    given lattice axes (0..3)."""
    grid = mesh.sharded()
    if grid is None:
        return torch.roll(x, shifts=shift, dims=axis)
    shifts, axes = _normalise(shift, axis)
    if all(grid.pes[a] == 1 for a in axes):
        return torch.roll(x, shifts=shift, dims=axis)
    if any(a < 0 or a > 3 for a in axes):
        raise ValueError(f"a sharded roll shifts lattice axes 0..3, got {axes}")
    _check_block(x, grid)
    return ShardedRoll.apply(x, shifts, axes, grid)
