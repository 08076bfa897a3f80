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

A field may lead with a chain axis (``lead``): the lattice axes are then
lead..lead + 3 and every slab carries all chains in one message. Under
torch.func.vmap (HMC.step_batched maps the gauge force, the actions, the
plaquette, the clover term and the stout layers over the chains) the
roll is ``ShardedRoll``'s own vmap rule, chosen over taking the rolls out
of the vmap on the grid path: it moves the batch dimension to the front
and makes one exchange for all chains (a roll with lead + 1), whose
backward, recorded by autograd beneath the vmap, is again one exchange.
"""

from __future__ import annotations

import torch

from latticeqcd_torch.parallel import mesh


def _normalise(shift, axis):
    if isinstance(axis, (tuple, list)):
        return tuple(int(s) for s in shift), tuple(int(a) for a in axis)
    return (int(shift),), (int(axis),)


def _check_block(x: torch.Tensor, grid, lead: int = 0) -> None:
    """A block's y and z extents (tensor dims lead + 1, lead + 2) are the grid's local ones."""
    if x.ndim < lead + 4 or tuple(x.shape[lead + 1:lead + 3]) != grid.local[1:3] or \
            x.shape[lead] not in (grid.local[0], grid.local[0] // 2):
        raise ValueError(
            f"a field of shape {tuple(x.shape)} with its lattice axes from dim {lead} is not a "
            f"block of the grid {grid.pes} (local extents {grid.local})")


def _sharded(x, shifts, axes, grid, lead):
    for s, mu in zip(shifts, axes):
        x = (torch.roll(x, s, lead + mu) if grid.pes[mu] == 1
             else mesh.roll_axis(x, s, mu, grid, lead))
    return x


class ShardedRoll(torch.autograd.Function):
    @staticmethod
    def forward(x, shifts, axes, grid, lead):
        return _sharded(x, shifts, axes, grid, lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.shifts, ctx.axes, ctx.grid, ctx.lead = inputs

    @staticmethod
    def backward(ctx, g):
        back = tuple(-s for s in reversed(ctx.shifts))
        return (ShardedRoll.apply(g, back, tuple(reversed(ctx.axes)), ctx.grid, ctx.lead),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, shifts, axes, grid, lead):
        """One exchange for every chain of the vmapped batch: the batch dimension to the
        front, the lattice axes one further."""
        return ShardedRoll.apply(x.movedim(in_dims[0], 0), shifts, axes, grid, lead + 1), 0


def roll(x: torch.Tensor, shift, axis, lead: int = 0) -> torch.Tensor:
    """jnp.roll semantics on the global lattice: an int or a tuple of shifts over the
    given lattice axes (0..3), the lattice axes at tensor dims lead..lead + 3."""
    grid = mesh.sharded()
    shifts, axes = _normalise(shift, axis)
    if grid is None or all(grid.pes[a] == 1 for a in axes):
        return torch.roll(x, shifts=shifts, dims=tuple(lead + a for a in axes))
    if any(a < 0 or a > 3 for a in axes):
        raise ValueError(f"a sharded roll shifts lattice axes 0..3, got {axes}")
    _check_block(x, grid, lead)
    return ShardedRoll.apply(x, shifts, axes, grid, lead)
