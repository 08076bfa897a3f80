"""Wilson Dirac operator (csw = 0).

Counterpart of latticeqcd_tpu/ops/dirac/wilson.py, same layouts:
links [4, X, Y, Z, T, NC, NC], spinors [X, Y, Z, T, 4, NC], packed
even-odd fields with X halved. Hopping form

    D psi(x) = psi(x)
      - kappa sum_mu [ (r - g_mu) U_mu(x) psi(x+mu)
                     + (r + g_mu) U_mu(x-mu)^dag psi(x-mu) ]

with boundary phases absorbed into the links. At r = 1 the full D goes
through the wilson_window kernel (wilson_window_kernel.py) and the
packed hop through the wilson_hop_packed kernel (wilson_kernel.py), each
with its plain version on the CPU. Other r take the generic projector
form on the CPU and raise on any other device, since the kernels hold
r = 1 (ROADMAP A4b). The clover term is later work (ROADMAP A12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from latticeqcd_torch.ops.dirac import eo_pack, gammas, wilson_kernel, wilson_window_kernel
from latticeqcd_torch.ops.dirac.wilson_kernel import gamma5

DIRS = 4


def refuse_r_off_cpu(r: float, device) -> None:
    """Wilson r != 1 has no kernel: raise unless it runs on the CPU."""
    if r != 1.0 and torch.device(device).type != "cpu":
        raise NotImplementedError(f"Wilson r = {r} on {device} is not ported yet "
                                  "(ROADMAP A4b: Wilson r != 1 kernels)")


def apply_boundary_phases(u: torch.Tensor, bc=(1, 1, 1, -1)) -> torch.Tensor:
    """Multiply the last slice of each direction's links by its boundary
    phase, so periodic shifts implement the fermion BCs. Differentiable."""
    if all(phase == 1 for phase in bc):
        return u
    lattice = tuple(u.shape[1:5])
    factor = torch.ones((DIRS,) + lattice, dtype=u.real.dtype, device=u.device)
    for mu, phase in enumerate(bc):
        factor[mu].select(mu, lattice[mu] - 1).fill_(phase)
    return u * factor[..., None, None]


@dataclass(frozen=True)
class WilsonDirac:
    """Static description of a Wilson operator: D(U) psi."""

    kappa: float
    r: float = 1.0
    bc: tuple = (1, 1, 1, -1)
    csw: float = 0.0

    def __post_init__(self):
        if self.csw != 0.0:
            raise NotImplementedError("the clover term is not ported yet (ROADMAP A12)")

    def apply(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """D psi; u must already carry the boundary phases."""
        if self.r == 1.0:
            return wilson_window_kernel.wilson_window(u, psi, self.kappa)
        refuse_r_off_cpu(self.r, psi.device)
        return psi - self.kappa * self._hop_generic(u, psi)

    def _hop_generic(self, u, psi):
        return self._hop_projectors(u, u, psi, wilson_kernel.full_plus, wilson_kernel.full_minus)

    def _hop_projectors(self, u_fwd, u_bwd, psi, gplus, gminus):
        """sum_mu (r - g_mu) U_fwd(x) psi(x+mu) + (r + g_mu) U_bwd(x-mu)^dag psi(x-mu)
        for any r, with the neighbour gathers given."""
        pm, pp = (torch.as_tensor(p, dtype=psi.dtype, device=psi.device)
                  for p in gammas.projectors(self.r))
        hop = 0.0
        for mu in range(DIRS):
            fwd = torch.einsum("...ab,...sb->...sa", u_fwd[mu], gplus(psi, mu))
            bwd = torch.einsum("...ba,...sb->...sa", gminus(u_bwd[mu], mu).conj(), gminus(psi, mu))
            hop = hop + torch.einsum("st,...tc->...sc", pm[mu], fwd)
            hop = hop + torch.einsum("st,...tc->...sc", pp[mu], bwd)
        return hop

    def apply_dagger(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """D^dag psi = g5 D g5 psi (gamma5-hermiticity)."""
        return gamma5(self.apply(u, gamma5(psi)))

    # ------------------------------------------- even-odd preconditioning
    # D = [[1, -kappa H_eo], [-kappa H_oe, 1]], det D = det Dhat with the
    # Schur complement Dhat = 1 - kappa^2 H_eo H_oe on packed even sites.

    def packed_links(self, u: torch.Tensor):
        return eo_pack.pack_links(u, tuple(u.shape[1:5]))

    def hop_packed(self, u_t, u_s, psi_s, target_parity: int) -> torch.Tensor:
        """Hopping term H psi on target-parity sites; psi lives on the
        source parity (packed layout)."""
        if self.r == 1.0:
            return wilson_kernel.wilson_hop_packed(u_t, u_s, psi_s, target_parity)
        refuse_r_off_cpu(self.r, psi_s.device)
        gplus, gminus, _ = wilson_kernel.packed_gathers(psi_s, target_parity)
        return self._hop_projectors(u_t, u_s, psi_s, gplus, gminus)

    def apply_dhat(self, u_eo, x_e: torch.Tensor) -> torch.Tensor:
        """Dhat x = x - kappa^2 H_eo H_oe x on packed even fields."""
        u_e, u_o = u_eo
        d1 = self.hop_packed(u_o, u_e, x_e, target_parity=1)
        d2 = self.hop_packed(u_e, u_o, d1, target_parity=0)
        return x_e - self.kappa ** 2 * d2

    def apply_dhat_dagger(self, u_eo, x_e: torch.Tensor) -> torch.Tensor:
        """Dhat^dag = g5 Dhat g5."""
        return gamma5(self.apply_dhat(u_eo, gamma5(x_e)))

    def apply_dhat_ddag(self, u_eo, x_e: torch.Tensor) -> torch.Tensor:
        return self.apply_dhat(u_eo, self.apply_dhat_dagger(u_eo, x_e))

    def apply_ddag_d(self, u, psi):
        return self.apply_dagger(u, self.apply(u, psi))

    def apply_d_ddag(self, u, psi):
        return self.apply(u, self.apply_dagger(u, psi))


def gaussian_spinor(lattice, nc, nspin=4, dtype=torch.complex128, device="cuda",
                    generator: Optional[torch.Generator] = None, normals=None) -> torch.Tensor:
    """Unit-variance complex Gaussian spinor, E|psi_i|^2 = 1: (re + i im)/sqrt(2)
    from a Generator, or from injected normals (re, im) of that shape."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    if normals is None:
        rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
        re = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    else:
        re, im = normals
    return (torch.complex(re, im) / math.sqrt(2.0)).to(dtype)


def z4_spinor(lattice, nc, nspin=4, dtype=torch.complex128, device="cuda",
              generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
    """Z4 noise: entries i^k, k in {0, 1, 2, 3}, uniform; k from a Generator,
    or the injected integers ``draws`` of that shape (the JAX package's
    ``z4_spinor`` draws k with jax.random.randint, whose stream torch cannot
    reproduce, so a test injects the same integers into both)."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    if draws is None:
        k = torch.randint(0, 4, shape, generator=generator, device=device)
    else:
        k = torch.as_tensor(draws, device=device).reshape(shape)
    vals = torch.tensor([1, 1j, -1, -1j], dtype=dtype, device=k.device)
    return vals[k.long()]


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global <a, b> = sum conj(a) b, in the working dtype."""
    return torch.sum(a.conj() * b)
