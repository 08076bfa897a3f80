"""Symbolic Wilson lines: the plaquette action's loops and the observables' loops.

Counterpart of latticeqcd_tpu/ops/wilsonline.py: a path is a tuple of
(direction, signed length) segments, evaluated by multiplying rolled
link fields. The plaquette, rectangle and clover loops are here; named
loop sets other than the plaquette, and the generic staple derivative,
wait for the general-action slice (ROADMAP A3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import torch

from latticeqcd_torch.ops import rolls, sun

DIRS = 4


@dataclass(frozen=True)
class Wilsonline:
    """A symbolic path: ((mu, signed_length), ...), mu in 0..3."""

    segments: tuple

    def __init__(self, segments: Iterable[Sequence[int]]):
        segs = tuple((int(m), int(s)) for (m, s) in segments if int(s) != 0)
        object.__setattr__(self, "segments", segs)

    def expand(self):
        """Unit steps [(mu, +-1), ...]."""
        out = []
        for mu, length in self.segments:
            step = 1 if length > 0 else -1
            out.extend([(mu, step)] * abs(length))
        return out

    def adjoint(self) -> "Wilsonline":
        """The reversed path (the loop's dagger)."""
        return Wilsonline([(mu, -length) for mu, length in reversed(self.segments)])


def make_plaq(mu: int, nu: int) -> Wilsonline:
    return Wilsonline([(mu, 1), (nu, 1), (mu, -1), (nu, -1)])


def make_rect(mu: int, nu: int, lmu: int = 2, lnu: int = 1) -> Wilsonline:
    return Wilsonline([(mu, lmu), (nu, lnu), (mu, -lmu), (nu, -lnu)])


def make_cloverloops(mu: int, nu: int):
    """The four plaquettes around a site in the (mu, nu) plane."""
    return [
        Wilsonline([(mu, 1), (nu, 1), (mu, -1), (nu, -1)]),
        Wilsonline([(nu, 1), (mu, -1), (nu, -1), (mu, 1)]),
        Wilsonline([(nu, -1), (mu, 1), (nu, 1), (mu, -1)]),
        Wilsonline([(mu, -1), (nu, -1), (mu, 1), (nu, 1)]),
    ]


def make_loops_fromname(name: str, dim: int = 4):
    if name == "plaquette":
        return [make_plaq(mu, nu) for mu in range(dim) for nu in range(mu + 1, dim)]
    raise NotImplementedError(f"loop set {name!r} is not ported yet (ROADMAP A3)")


def _roll_to(field: torch.Tensor, offset) -> torch.Tensor:
    """g with g[x] = field[x + offset] (site axes 0..3)."""
    axes = [d for d in range(DIRS) if offset[d] != 0]
    if not axes:
        return field
    return rolls.roll(field, tuple(-offset[d] for d in axes), tuple(axes))


def path_offsets(steps):
    """Offsets before each unit step of a path, and the final one."""
    offsets = [[0] * DIRS]
    cur = [0] * DIRS
    for mu, sgn in steps:
        cur = list(cur)
        cur[mu] += sgn
        offsets.append(cur)
    return offsets


def evaluate_line(u: torch.Tensor, line: Wilsonline) -> torch.Tensor:
    """Path-ordered product W(x) starting at every site x: (X,Y,Z,T,NC,NC)."""
    offset = [0] * DIRS
    result = None
    for mu, sgn in line.expand():
        if sgn > 0:
            link = _roll_to(u[mu], offset)
            offset[mu] += 1
        else:
            offset[mu] -= 1
            link = sun.dagger(_roll_to(u[mu], offset))
        result = link if result is None else sun.mul(result, link)
    if result is None:
        nc = u.shape[-1]
        result = torch.eye(nc, dtype=u.dtype, device=u.device).expand(u.shape[1:])
    return result


def evaluate_loop_trace_sum(u: torch.Tensor, lines) -> torch.Tensor:
    """sum_x sum_lines tr W(x) (complex scalar)."""
    total = 0.0
    for line in lines:
        total = total + torch.sum(sun.trace(evaluate_line(u, line)))
    return total
