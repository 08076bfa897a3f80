"""Gauge observables: plaquette and Polyakov loop.

Counterpart of latticeqcd_tpu/measurements/observables.py; topological
charge, energy density and Wilson loops wait for a later slice
(ROADMAP A11b).
"""

from __future__ import annotations

import torch

from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun


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
