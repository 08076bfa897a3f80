"""Gauge observables: plaquette, Polyakov loop, topological charge, energy
density and Wilson loops.

Counterpart of latticeqcd_tpu/measurements/observables.py with the same
loop sets and normalisations: Q = -(1/32 pi^2) sum eps tr(F F) / num^2
over ordered pairs of the traceless antihermitian loop sums (plaquette,
clover, and the O(a^2)-improved clover-rectangle mix), E over
NV * 6 * NC * 8 from the clover sums, and W(R, T) over NV * 3 * NC,
wrapping through the periodic roll when R or T reaches the extent.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun, wilsonline
from latticeqcd_torch.ops.wilsonline import Wilsonline


def mean_plaquette(u: torch.Tensor) -> torch.Tensor:
    return ga.mean_plaquette(u)


def polyakov_loop(u: torch.Tensor) -> torch.Tensor:
    """Complex <(1/NC) tr prod_t U_4(x, t)> over the spatial sites."""
    nt = u.shape[4]
    nc = u.shape[-1]
    acc = u[3][:, :, :, 0]
    for t in range(1, nt):
        acc = sun.mul(acc, u[3][:, :, :, t])
    return torch.mean(sun.trace(acc)) / nc


# The Levi-Civita symbol in four dimensions.
_EPS4 = np.zeros((4, 4, 4, 4))
for _perm in itertools.permutations(range(4)):
    _sign = 1
    for _i in range(4):
        for _j in range(_i + 1, 4):
            if _perm[_i] > _perm[_j]:
                _sign = -_sign
    _EPS4[_perm] = _sign


def _loopset_munu(name: str):
    """loops[(mu, nu)] over the ordered pairs mu != nu, and the number of
    loops each field-strength sum holds."""
    loops = {}
    pairs = [(mu, nu) for mu in range(4) for nu in range(4) if mu != nu]
    if name == "plaq":
        num = 1
        for mu, nu in pairs:
            loops[(mu, nu)] = [Wilsonline([(mu, 1), (nu, 1), (mu, -1), (nu, -1)])]
    elif name == "clover":
        num = 4
        for mu, nu in pairs:
            loops[(mu, nu)] = wilsonline.make_cloverloops(mu, nu)
    elif name == "rect":
        num = 8
        for mu, nu in pairs:
            ls = []
            for (a, la, b, lb) in [(mu, 2, nu, 1), (mu, 1, nu, 2)]:
                ls += [
                    Wilsonline([(a, la), (b, lb), (a, -la), (b, -lb)]),
                    Wilsonline([(b, lb), (a, -la), (b, -lb), (a, la)]),
                    Wilsonline([(b, -lb), (a, la), (b, lb), (a, -la)]),
                    Wilsonline([(a, -la), (b, -lb), (a, la), (b, lb)]),
                ]
            loops[(mu, nu)] = ls
    else:
        raise ValueError(name)
    return loops, num


def _loop_sum(u, lines):
    acc = 0.0
    for line in lines:
        acc = acc + wilsonline.evaluate_line(u, line)
    return acc


def _field_strength_ta(u, name):
    """The traceless antihermitian loop sums F[(mu, nu)] per ordered pair."""
    loops, num = _loopset_munu(name)
    return {pair: sun.traceless_antihermitian(_loop_sum(u, ls)) for pair, ls in loops.items()}, num


def _q_from_fields(f, num) -> torch.Tensor:
    """Q = -(1/32 pi^2) sum eps_{mu nu rho sigma} tr(F F) / num^2."""
    q = 0.0
    for mu, nu, rho, sig in itertools.product(range(4), repeat=4):
        e = _EPS4[mu, nu, rho, sig]
        if e == 0:
            continue
        s = torch.sum(sun.trace(sun.mul(f[(mu, nu)], f[(rho, sig)])))
        q = q + e * torch.real(s) / num ** 2
    return -q / (32 * math.pi ** 2)


def topological_charge(u: torch.Tensor, kind: str = "clover") -> torch.Tensor:
    """kind in {"plaquette", "clover", "improved"}."""
    if kind in ("plaquette", "plaq"):
        return _q_from_fields(*_field_strength_ta(u, "plaq"))
    if kind == "clover":
        return _q_from_fields(*_field_strength_ta(u, "clover"))
    if kind == "improved":
        qclover = _q_from_fields(*_field_strength_ta(u, "clover"))
        qrect = 2.0 * _q_from_fields(*_field_strength_ta(u, "rect"))
        return (5.0 / 3.0) * qclover - (1.0 / 12.0) * qrect
    raise ValueError(kind)


def energy_density(u: torch.Tensor) -> torch.Tensor:
    """Clover E: W_munu the sum of the 4 leaves, E = Re sum_{mu != nu}
    tr(W W)/4 / (NV 6 NC 8)."""
    nc = u.shape[-1]
    nv = math.prod(u.shape[1:5])
    total = 0.0
    loops, _ = _loopset_munu("clover")
    for ls in loops.values():
        acc = _loop_sum(u, ls)
        total = total + torch.sum(sun.trace(sun.mul(acc, acc))) / 4.0
    return torch.real(total) / nv / 6.0 / nc / 8.0


def wilson_loop_rt(u: torch.Tensor, ls: int, lt: int) -> torch.Tensor:
    """<Re tr W(ls x lt)> over the 3 spatial directions, over NV 3 NC."""
    nc = u.shape[-1]
    nv = math.prod(u.shape[1:5])
    total = 0.0
    for mu in range(3):
        w = wilsonline.evaluate_line(u, Wilsonline([(mu, ls), (3, lt), (mu, -ls), (3, -lt)]))
        total = total + torch.sum(torch.real(sun.trace(w)))
    return total / (nv * 3 * nc)
