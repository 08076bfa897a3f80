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


def one_instanton_start(lattice, nc: int, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """Discretised BPST instanton in singular gauge, centred mid-lattice, with
    rho = min(L)/4, embedded in the upper-left SU(2) block for NC > 2:
    A^a_mu = 2 etabar^a_{mu nu} (x-z)_nu rho^2 / ((x-z)^2 ((x-z)^2 + rho^2))
    at the link midpoints, exponentiated exactly. Built on the host in
    float64, as the JAX package's one_instanton_start."""
    nx, ny, nz, nt = lattice
    rho = min(lattice) / 4.0
    center = np.array([nx / 2 - 0.5, ny / 2 - 0.5, nz / 2 - 0.5, nt / 2 - 0.5])
    # the anti-'t Hooft symbol etabar^a_{mu nu}, a = 1..3, mu, nu = 1..4 (3 = time)
    eta = np.zeros((3, 4, 4))
    for a in range(3):
        for mu in range(3):
            for nu in range(3):
                if len({a, mu, nu}) == 3:
                    eta[a, mu, nu] = float(np.sign((a - mu) * (mu - nu) * (nu - a)))
        eta[a, a, 3] = -1.0
        eta[a, 3, a] = 1.0
    coords = np.stack(np.meshgrid(*(np.arange(n) for n in lattice), indexing="ij"),
                      axis=-1).astype(np.float64)
    sigma = np.array([[[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]],
                     dtype=np.complex128)
    links = np.zeros((DIRS, *lattice, 2, 2), dtype=np.complex128)
    for mu in range(DIRS):
        mid = coords.copy()
        mid[..., mu] += 0.5
        d = mid - center
        x2 = np.sum(d * d, axis=-1)
        amu = 2.0 * np.einsum("an,...n->a...", eta[:, mu, :], d) * rho ** 2 / (x2 * (x2 + rho * rho))
        x = 1j * np.einsum("a...,aij->...ij", amu, sigma)
        # the exact 2x2 exponential of the traceless antihermitian x
        av = np.imag(x[..., 0, 0])
        bv = np.real(x[..., 0, 1])
        cv = np.imag(x[..., 0, 1])
        th = np.sqrt(av * av + bv * bv + cv * cv)
        sinc = np.where(th < 1e-12, 1.0, np.sin(th) / np.where(th < 1e-12, 1.0, th))
        e00 = np.cos(th) + 1j * av * sinc
        e01 = (bv + 1j * cv) * sinc
        links[mu, ..., 0, 0] = e00
        links[mu, ..., 0, 1] = e01
        links[mu, ..., 1, 0] = -np.conj(e01)
        links[mu, ..., 1, 1] = np.conj(e00)
    if nc == 2:
        u = links
    else:
        u = np.zeros((DIRS, *lattice, nc, nc), dtype=np.complex128)
        u[..., :, :] = np.eye(nc)
        u[..., :2, :2] = links
    return torch.from_numpy(u).to(device=device, dtype=dtype)


def initialize_gaugefields(nc, lattice, condition="cold", seed=0, dtype=torch.complex128,
                           device="cuda"):
    if condition == "cold":
        return cold_start(lattice, nc, dtype, device)
    if condition == "hot":
        return hot_start(lattice, nc, seed, dtype, device)
    if condition == "one instanton":
        return one_instanton_start(lattice, nc, dtype, device)
    raise ValueError(f"unknown initial condition {condition!r}")
