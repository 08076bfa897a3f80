"""Periodic lattice shifts.

The JAX package needs a custom roll primitive so that its transpose
lowers to halo permutes on a sharded mesh (latticeqcd_tpu/ops/rolls.py);
torch.roll is linear with the opposite roll as its backward already.
"""

from __future__ import annotations

import torch


def roll(x: torch.Tensor, shift, axis) -> torch.Tensor:
    """jnp.roll semantics: an int or a tuple of shifts over the given axes."""
    return torch.roll(x, shifts=shift, dims=axis)
