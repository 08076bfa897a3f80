"""Gauge-link fields.

Counterpart of latticeqcd_tpu/ops/fields.py: one tensor
U[mu, x, y, z, t, a, b], made on the card unless the caller names
another device.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.ops import sun

DIRS = 4


def cold_start(lattice, nc: int, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """All links = identity."""
    shape = (DIRS, *lattice, nc, nc)
    return torch.eye(nc, dtype=dtype, device=device).expand(shape).contiguous()


def hot_start(lattice, nc: int, seed: int = 0, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """Random SU(N) links from numpy's default_rng(seed): bit-identical to
    the JAX package's hot_start for the same seed."""
    rng = np.random.default_rng(seed)
    u = sun.random_sun_host(rng, (DIRS, *lattice), nc)
    return torch.from_numpy(u).to(device=device, dtype=dtype)


def initialize_gaugefields(nc, lattice, condition="cold", seed=0, dtype=torch.complex128,
                           device="cuda"):
    if condition == "cold":
        return cold_start(lattice, nc, dtype, device)
    if condition == "hot":
        return hot_start(lattice, nc, seed, dtype, device)
    if condition == "one instanton":
        raise NotImplementedError("the one-instanton start is not ported yet (ROADMAP A2)")
    raise ValueError(f"unknown initial condition {condition!r}")
