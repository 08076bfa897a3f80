"""Two-flavour Wilson pseudofermion action with its exact force.

Counterpart of latticeqcd_tpu/ops/fermion_action.py (``_project_force``
and ``WilsonFermiAction``): S = phi^dag (A A^dag)^-1 phi with A the
even-odd Schur operator Dhat on packed even sites (all-even lattices,
csw = 0) or the full D otherwise. The force solves once (detached, as
jax.lax.stop_gradient does) and differentiates Re<x, A A^dag x> with
respect to the bare links through the boundary phases, the link packing
and the hop's autograd Function. Hasenbusch, staggered and domain-wall
actions wait for later slices (ROADMAP A10, A12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from latticeqcd_torch.ops import solvers, sun
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    gaussian_spinor,
    inner,
)

DIRS = 4


def _project_force(u, grad_c):
    """Hdot = +(1/2) proj_TH(i U g^T) per direction for the gradient g of a
    real scalar c(U), with g in JAX's convention. PyTorch's gradient is
    the complex conjugate of JAX's, so g^T = grad_c^dag here."""
    out = []
    for mu in range(DIRS):
        m = 1j * sun.mul(u[mu], sun.dagger(grad_c[mu]))
        out.append(0.5 * sun.traceless_hermitian(m))
    return torch.stack(out, dim=0)


@dataclass(frozen=True)
class WilsonFermiAction:
    """S = phi^dag (D D^dag)^-1 phi; weight det(D D^dag) = det(D)^2."""

    dirac: WilsonDirac
    eps_cg: float = 1e-19
    max_cg: int = 3000

    def _phased(self, u):
        return apply_boundary_phases(u, self.dirac.bc)

    def _eo(self, lattice) -> bool:
        return self.dirac.csw == 0.0 and eo_pack.packable(lattice)

    def pseudofermion_shape(self, u):
        """Lattice of the noise xi: packed even sites when even-odd applies."""
        lattice = tuple(u.shape[1:5])
        if self._eo(lattice):
            return (lattice[0] // 2,) + lattice[1:]
        return lattice

    @torch.no_grad()
    def sample_pseudofermion(self, u, generator: Optional[torch.Generator] = None, normals=None):
        """(S_old, phi): phi = A xi with unit Gaussian xi (from the
        Generator, or the injected normals (re, im)); S_old = |xi|^2."""
        up = self._phased(u)
        xi = gaussian_spinor(self.pseudofermion_shape(u), u.shape[-1], nspin=4, dtype=u.dtype,
                             device=u.device, generator=generator, normals=normals)
        if self._eo(tuple(u.shape[1:5])):
            phi = self.dirac.apply_dhat(self.dirac.packed_links(up), xi)
        else:
            phi = self.dirac.apply(up, xi)
        return torch.real(inner(xi, xi)), phi

    def _packed(self, up, phi) -> bool:
        return phi.ndim == 6 and 2 * phi.shape[0] == up.shape[1]

    def _solve_normal(self, up, phi, x0=None, log=None):
        """x = (A A^dag)^-1 phi with A = Dhat (packed phi) or D."""
        if self._packed(up, phi):
            ueo = self.dirac.packed_links(up)
            op = lambda v: self.dirac.apply_dhat_ddag(ueo, v)
        else:
            op = lambda v: self.dirac.apply_d_ddag(up, v)
        x, _, _ = solvers.cg(op, phi, x0=x0, eps=self.eps_cg, maxiter=self.max_cg, log=log)
        return x

    @torch.no_grad()
    def action(self, u, phi, log=None):
        x = self._solve_normal(self._phased(u), phi, log=log)
        return torch.real(inner(phi, x))

    def force(self, u, phi, log=None):
        return self.force_with_guess(u, phi, None, log=log)[0]

    def force_with_guess(self, u, phi, x0, log=None):
        """Force with the CG warm-started from x0 (chronological
        inverter); returns (force, x) so the caller can thread x on."""
        with torch.no_grad():
            up = self._phased(u)
            packed = self._packed(up, phi)
            x = self._solve_normal(up, phi, x0=x0, log=log)
        uu = u.detach().requires_grad_(True)
        with torch.enable_grad():
            uup = apply_boundary_phases(uu, self.dirac.bc)
            if packed:
                ueo = self.dirac.packed_links(uup)
                c = torch.real(inner(x, self.dirac.apply_dhat_ddag(ueo, x)))
            else:
                c = torch.real(inner(x, self.dirac.apply_d_ddag(uup, x)))
            (g,) = torch.autograd.grad(c, uu)
        return _project_force(u, g), x
