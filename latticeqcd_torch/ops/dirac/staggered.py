"""Staggered (Kogut-Susskind) Dirac operator.

Counterpart of latticeqcd_tpu/ops/dirac/staggered.py, same layouts:
links [4, X, Y, Z, T, NC, NC], fields [X, Y, Z, T, NC], packed even-odd
fields with X halved.

    D psi(x) = m psi(x)
      + (1/2) sum_mu eta_mu(x) [ U_mu(x) psi(x+mu) - U_mu(x-mu)^dag psi(x-mu) ]

with eta_1 = 1, eta_mu = (-1)^(x_1+..+x_{mu-1}) and the boundary phases
absorbed into the links. D = m + Dslash with Dslash antihermitian and
even-odd off-diagonal, so the even block W = m^2 - Dslash^2|_ee is what
the solvers and the HMC run on. On packed fields the hop and W go
through the staggered_w kernel (staggered_kernel.py; its plain version
on the CPU). The full-volume ``dslash`` and the masked ``apply_w_even``
are torch ops for the CPU (the tests, and lattices with an odd extent);
a full-volume mode of the kernel is later work (ROADMAP A11), so they
refuse a tensor that is not on the CPU.

``lattice`` is the lattice of the fields the operator acts on: under a
process grid (parallel/mesh.py) the block's extents, every one even. Each
block's origin is then even, so the KS signs, the parity mask and the
packed row offsets made from the block's own coordinates are the blocks
of the global field's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from latticeqcd_torch.ops import rolls
from latticeqcd_torch.ops.dirac import eo_pack, staggered_kernel

DIRS = 4


def ks_phases(lattice):
    """eta_mu(x) as four {-1,+1} site fields, and the parity mask (numpy)."""
    grids = np.meshgrid(*(np.arange(l) for l in lattice), indexing="ij")
    etas = []
    acc = np.zeros(lattice, dtype=np.int64)
    for mu in range(DIRS):
        etas.append(1.0 - 2.0 * (acc % 2))
        acc = acc + grids[mu]
    parity_even = (sum(grids) % 2) == 0
    return np.stack(etas), parity_even


@functools.lru_cache(maxsize=None)
def _site_fields(lattice, dtype, device):
    """(eta [4, X, Y, Z, T] real, even mask [X, Y, Z, T] bool) on ``device``, made once."""
    eta, even = ks_phases(lattice)
    return (torch.as_tensor(eta, dtype=dtype, device=device),
            torch.as_tensor(even, device=device))


def _cpu_only(t: torch.Tensor):
    if t.device.type != "cpu":
        raise NotImplementedError(
            "the full-volume staggered operator runs on the CPU only; on the card the "
            "staggered path needs every lattice extent even (a full-volume mode of the "
            "staggered_w kernel is ROADMAP A11)")


@dataclass(frozen=True)
class StaggeredDirac:
    mass: float
    lattice: tuple
    bc: tuple = (1, 1, 1, -1)

    @property
    def eta(self) -> np.ndarray:
        return ks_phases(self.lattice)[0]

    @property
    def even_mask(self) -> np.ndarray:
        return ks_phases(self.lattice)[1]

    def dslash(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """Antihermitian hopping part (1/2) sum eta_mu (T+ - T-), full volume."""
        _cpu_only(psi)
        eta, _ = _site_fields(tuple(self.lattice), psi.real.dtype, psi.device)
        out = 0.0
        for mu in range(DIRS):
            umu = u[mu]
            fwd = torch.einsum("...ab,...b->...a", umu, rolls.roll(psi, -1, mu))
            bwd = torch.einsum("...ba,...b->...a", rolls.roll(umu, 1, mu).conj(),
                               rolls.roll(psi, 1, mu))
            out = out + 0.5 * eta[mu][..., None] * (fwd - bwd)
        return out

    def apply(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """D psi = m psi + Dslash psi."""
        return self.mass * psi + self.dslash(u, psi)

    def apply_dagger(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return self.mass * psi - self.dslash(u, psi)

    def even_part(self, f: torch.Tensor) -> torch.Tensor:
        """f on the even sites, zero on the odd ones (full-volume [..., NC] fields)."""
        _, even = _site_fields(tuple(self.lattice), f.real.dtype, f.device)
        return torch.where(even[..., None], f, torch.zeros_like(f))

    def apply_w_even(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        """W phi = (m^2 - Dslash^2) phi for even-supported phi (full volume)."""
        _cpu_only(phi)
        phi_e = self.even_part(phi)
        return self.even_part(self.mass ** 2 * phi_e - self.dslash(u, self.dslash(u, phi_e)))

    def apply_ddag_d(self, u, psi):
        """(m^2 - Dslash^2) psi on the full lattice."""
        return self.mass ** 2 * psi - self.dslash(u, self.dslash(u, psi))

    # ------------------------------------------------ packed even-odd layout

    def pack(self, f: torch.Tensor, parity: int) -> torch.Tensor:
        return eo_pack.pack(f, self.lattice, parity)

    def unpack(self, fp: torch.Tensor, parity: int) -> torch.Tensor:
        return eo_pack.unpack(fp, self.lattice, parity)

    def packed_links(self, u: torch.Tensor):
        return eo_pack.pack_links(u, self.lattice)

    def _packed_eta(self, parity: int) -> np.ndarray:
        """eta_mu on packed parity sites, (X/2, Y, Z, T, 4)."""
        return staggered_kernel.packed_eta_signs(self.lattice, parity)

    def _packed_dslash(self, u_t, u_s, psi_s, target_parity: int) -> torch.Tensor:
        """(Dslash psi)(x) on target-parity sites; psi lives on the source
        parity, u_t / u_s are the packed links of the target / source parity."""
        return staggered_kernel.staggered_hop_packed(u_t, u_s, psi_s, target_parity)

    def apply_w_packed(self, u_eo, phi_pe: torch.Tensor) -> torch.Tensor:
        """W phi = (m^2 - D_eo D_oe) phi on packed even fields (X/2,Y,Z,T,NC).

        The fused kernel when nothing asks for a gradient (every solver
        iteration); two differentiable hops and the axpy otherwise (the force)."""
        u_e, u_o = u_eo
        if torch.is_grad_enabled() and any(t.requires_grad for t in (u_e, u_o, phi_pe)):
            d1 = self._packed_dslash(u_o, u_e, phi_pe, target_parity=1)
            d2 = self._packed_dslash(u_e, u_o, d1, target_parity=0)
            return self.mass ** 2 * phi_pe - d2
        return staggered_kernel.staggered_w(u_e, u_o, phi_pe, self.mass)
