"""Symbolic Wilson lines: loops, named loop sets and the generic staple.

Counterpart of latticeqcd_tpu/ops/wilsonline.py: a path is a tuple of
(direction, signed length) segments, evaluated by multiplying rolled
link fields. The path derivative of a weighted loop set (``staple_sum``)
is built from the same rolls, in the JAX package's order of products
and sums, and carries every general gauge action, stout layer and
general-action heatbath.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import torch

from latticeqcd_torch.ops import rolls, sun
from latticeqcd_torch.parallel.mesh import global_sum

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


def make_loops_fromname(name: str, dim: int = 4, lattice=None):
    """Named loop sets: plaquette, rectangular (the 12 oriented 2x1
    rectangles), chair and polyakov_<x|y|z|t> (needs ``lattice``)."""
    if name == "plaquette":
        return [make_plaq(mu, nu) for mu in range(dim) for nu in range(mu + 1, dim)]
    if name == "rectangular":
        return [make_rect(mu, nu) for mu in range(dim) for nu in range(dim) if mu != nu]
    if name == "chair":
        return [Wilsonline([(mu, 1), (nu, 1), (rho, 1), (mu, -1), (nu, -1), (rho, -1)])
                for mu in range(dim) for nu in range(dim) for rho in range(dim)
                if len({mu, nu, rho}) == 3]
    if name.startswith("polyakov_"):
        axis = {"x": 0, "y": 1, "z": 2, "t": 3}[name.split("_")[1]]
        if lattice is None:
            raise ValueError("polyakov loops need the lattice extent")
        return [Wilsonline([(axis, lattice[axis])])]
    raise ValueError(f"unknown loop set {name!r}")


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
    """sum_x sum_lines tr W(x) (complex scalar), over the ranks of a process grid."""
    total = 0.0
    for line in lines:
        total = total + torch.sum(sun.trace(evaluate_line(u, line)))
    return global_sum(total)


def _occurrence_staple(u: torch.Tensor, steps, k: int, offsets) -> torch.Tensor:
    """Staple V of the +occurrence at unit step k of a path: with
    W(x) = prod_j L_j(x + o_j) and L_k = U_mu(x + o_k),
    sum_x tr W = sum_y tr(U_mu(y) V(y)),
    V(y) = [prod_{j>k} L_j . prod_{j<k} L_j](x = y - o_k)."""
    base = offsets[k]
    result = None
    for j in list(range(k + 1, len(steps))) + list(range(k)):
        mu_j, sgn_j = steps[j]
        if sgn_j > 0:
            link = _roll_to(u[mu_j], [offsets[j][d] - base[d] for d in range(DIRS)])
        else:  # a backward step's link lives at the offset after the step
            link = sun.dagger(_roll_to(u[mu_j], [offsets[j + 1][d] - base[d] for d in range(DIRS)]))
        result = link if result is None else sun.mul(result, link)
    if result is None:
        nc = u.shape[-1]
        result = torch.eye(nc, dtype=u.dtype, device=u.device).expand(u.shape[1:])
    return result


def staple_sum(u: torch.Tensor, weighted_lines, mu: int) -> torch.Tensor:
    """V_mu(y) summed over every +mu occurrence of ``weighted_lines`` =
    [(coeff, Wilsonline), ...], so that the +mu part of
    sum_i c_i sum_x tr W_i(x) is sum_y tr(U_mu(y) V_mu(y)). For a line set
    closed under the adjoint this is the full staple: the -mu occurrences
    are the +mu occurrences of the adjoint lines."""
    total = None
    for coeff, line in weighted_lines:
        steps = line.expand()
        offsets = path_offsets(steps)
        for k, (mu_k, sgn_k) in enumerate(steps):
            if mu_k != mu or sgn_k <= 0:
                continue
            contrib = coeff * _occurrence_staple(u, steps, k, offsets)
            total = contrib if total is None else total + contrib
    if total is None:
        total = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    return total
