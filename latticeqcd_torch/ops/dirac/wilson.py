"""Wilson Dirac operator, optionally clover-improved.

Counterpart of latticeqcd_tpu/ops/dirac/wilson.py, same layouts:
links [4, X, Y, Z, T, NC, NC], spinors [X, Y, Z, T, 4, NC], packed
even-odd fields with X halved. Hopping form

    D psi(x) = psi(x)
      - kappa sum_mu [ (r - g_mu) U_mu(x) psi(x+mu)
                     + (r + g_mu) U_mu(x-mu)^dag psi(x-mu) ]

with boundary phases absorbed into the links. The full D goes through
the wilson_window kernel (wilson_window_kernel.py) and the packed hop
through the wilson_hop_packed kernel (wilson_kernel.py), each with its
plain version on the CPU, at any r: r = 1 in the half-spinor form,
other r in each kernel's r mode, which applies (r -+ g_mu) in full (the
plain version's projector form).

With csw != 0 the clover term T psi = -(csw kappa / 2) sum_{mu != nu}
sigma_munu F_munu psi joins D, with F_munu the traceless anti-hermitian
part of the four clover leaves over 4. T is site-local, so it is built
once per link configuration as explicit 12x12 site matrices
(``clover_term``) and applied as a batched site product: every D of a
solve or a force takes the same T (``apply``'s ``clover`` argument),
and the autograd of a force goes through T's construction. The even-odd
Schur complement becomes Dhat = A_ee - kappa^2 H_eo A_oo^-1 H_oe with
A = 1 + T (``clover_packed_blocks``, ``apply_dhat_clover``). The
blocks, their inverse and the site product are plain tensor operations,
as they are in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from latticeqcd_torch.ops import sun
from latticeqcd_torch.ops.dirac import eo_pack, gammas, wilson_kernel, wilson_window_kernel
from latticeqcd_torch.ops.dirac.wilson_kernel import gamma5
from latticeqcd_torch.ops.wilsonline import evaluate_line, make_cloverloops
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.parallel.mesh import global_sum

DIRS = 4
# sigma_munu = [g_mu, g_nu] / 2 on the six planes mu < nu; sigma_numu = -sigma_munu
# and F_numu = -F_munu, so the sum over the 12 ordered pairs is twice the planes' sum
PLANES = [(mu, nu) for mu in range(DIRS) for nu in range(mu + 1, DIRS)]
SIGMA = np.stack([(gammas.GAMMA[mu] @ gammas.GAMMA[nu] - gammas.GAMMA[nu] @ gammas.GAMMA[mu]) / 2.0
                  for mu, nu in PLANES])


def apply_boundary_phases(u: torch.Tensor, bc=(1, 1, 1, -1)) -> torch.Tensor:
    """Multiply the last slice of each direction's links by its boundary
    phase, so periodic shifts implement the fermion BCs. Differentiable; u
    may lead with a chain axis. Under a process grid u is this rank's block,
    and only the block that holds the global last slice along mu takes mu's
    phase."""
    if all(phase == 1 for phase in bc):
        return u
    grid = mesh.sharded()
    lattice = tuple(u.shape[-6:-2])
    factor = torch.ones((DIRS,) + lattice, dtype=u.real.dtype, device=u.device)
    for mu, phase in enumerate(bc):
        if grid is None or grid.holds_last(mu):
            factor[mu].select(mu, lattice[mu] - 1).fill_(phase)
    return u * factor[..., None, None]


@dataclass(frozen=True)
class WilsonDirac:
    """Static description of a Wilson operator: D(U) psi."""

    kappa: float
    r: float = 1.0
    bc: tuple = (1, 1, 1, -1)
    csw: float = 0.0

    def apply(self, u: torch.Tensor, psi: torch.Tensor, clover=None) -> torch.Tensor:
        """D psi; u must already carry the boundary phases. With csw != 0,
        ``clover`` is clover_term(u), built here when not given. Fields may lead
        with a chain axis (u [n, 4, X, Y, Z, T, NC, NC], psi [n, X, Y, Z, T, 4, NC]):
        one launch for all chains. Under a process grid the full D is the
        wilson_window kernel's halo mode and the clover term is built from sharded
        rolls; both are this rank's block."""
        out = wilson_window_kernel.wilson_window(u, psi, self.kappa, self.r)
        if self.csw != 0.0:
            out = out + self.site_apply(self.clover(u) if clover is None else clover, psi)
        return out

    def apply_dagger(self, u: torch.Tensor, psi: torch.Tensor, clover=None) -> torch.Tensor:
        """D^dag psi = g5 D g5 psi (gamma5-hermiticity; sigma_munu commutes
        with gamma5)."""
        return gamma5(self.apply(u, gamma5(psi), clover))

    # ------------------------------------------- even-odd preconditioning
    # D = [[1, -kappa H_eo], [-kappa H_oe, 1]], det D = det Dhat with the
    # Schur complement Dhat = 1 - kappa^2 H_eo H_oe on packed even sites.

    def packed_links(self, u: torch.Tensor):
        """(u_e, u_o), each chain's over a leading chain axis."""
        if u.ndim == 8:
            return torch.func.vmap(self.packed_links)(u)
        return eo_pack.pack_links(u, tuple(u.shape[1:5]))

    def hop_packed(self, u_t, u_s, psi_s, target_parity: int) -> torch.Tensor:
        """Hopping term H psi on target-parity sites; psi lives on the
        source parity (packed layout)."""
        return wilson_kernel.wilson_hop_packed(u_t, u_s, psi_s, target_parity, self.r)

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

    def apply_ddag_d(self, u, psi, clover=None):
        return self.apply_dagger(u, self.apply(u, psi, clover), clover)

    def apply_d_ddag(self, u, psi, clover=None):
        return self.apply(u, self.apply_dagger(u, psi, clover), clover)

    # ----------------------------------------------------------- clover term
    def clover(self, u):
        """clover_term(u) when csw != 0, else None: what ``apply`` takes."""
        return self.clover_term(u) if self.csw != 0.0 else None

    def clover_term(self, u: torch.Tensor) -> torch.Tensor:
        """T[X,Y,Z,T, s,a, t,b] = -(csw kappa / 2) sum_{mu != nu} sigma_munu
        F_munu with F_munu = traceless_antihermitian(sum of the four leaves) / 4,
        in u's dtype; each plane built once and counted twice. Each chain's over a
        leading chain axis."""
        if u.ndim == 8:
            return torch.func.vmap(self.clover_term)(u)
        sigma = torch.as_tensor(SIGMA, dtype=u.dtype, device=u.device)
        t = 0.0
        for i, (mu, nu) in enumerate(PLANES):
            leaves = [evaluate_line(u, line) for line in make_cloverloops(mu, nu)]
            f = sun.traceless_antihermitian(leaves[0] + leaves[1] + leaves[2] + leaves[3]) / 4.0
            t = t + torch.einsum("st,...ab->...satb", sigma[i], f)
        return -(self.csw * self.kappa) * t

    def clover_site_matrix(self, u: torch.Tensor) -> torch.Tensor:
        """A = 1 + T, the parity-diagonal block of the clover operator."""
        nc = u.shape[-1]
        eye = torch.eye(4 * nc, dtype=u.dtype, device=u.device).reshape(4, nc, 4, nc)
        return eye + self.clover_term(u)

    def clover_packed_blocks(self, up: torch.Tensor):
        """(a_e, ainv_o): the even block A_ee and the inverse odd block
        A_oo^-1, packed; the batched 12x12 inverse runs once per link
        configuration."""
        lattice = tuple(up.shape[1:5])
        a = self.clover_site_matrix(up)
        a_e = eo_pack.pack(a, lattice, 0)
        a_o = eo_pack.pack(a, lattice, 1)
        n = a_o.shape[-4] * a_o.shape[-3]
        ainv_o = torch.linalg.inv(a_o.reshape(a_o.shape[:-4] + (n, n))).reshape(a_o.shape)
        return a_e, ainv_o

    @staticmethod
    def site_apply(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y[s,a] = A[s,a,t,b] x[t,b] per site, as a batched 12x12 product (x
        may carry leading batch axes)."""
        n = x.shape[-2] * x.shape[-1]
        y = torch.matmul(a.reshape(a.shape[:-4] + (n, n)), x.reshape(x.shape[:-2] + (n, 1)))
        return y.reshape(x.shape)

    def apply_dhat_clover(self, u_eo, a_e, ainv_o, x_e: torch.Tensor) -> torch.Tensor:
        """Dhat x_e = A_ee x_e - kappa^2 H_eo A_oo^-1 H_oe x_e."""
        u_e, u_o = u_eo
        t = self.hop_packed(u_o, u_e, x_e, target_parity=1)
        t = self.hop_packed(u_e, u_o, self.site_apply(ainv_o, t), target_parity=0)
        return self.site_apply(a_e, x_e) - self.kappa ** 2 * t

    def apply_dhat_clover_dagger(self, u_eo, a_e, ainv_o, x_e: torch.Tensor) -> torch.Tensor:
        """Dhat^dag = g5 Dhat g5: the blocks and the hops are gamma5-hermitian."""
        return gamma5(self.apply_dhat_clover(u_eo, a_e, ainv_o, gamma5(x_e)))


def gaussian_spinor(lattice, nc, nspin=4, dtype=torch.complex128, device="cuda",
                    generator: Optional[torch.Generator] = None, normals=None) -> torch.Tensor:
    """Unit-variance complex Gaussian spinor, E|psi_i|^2 = 1: (re + i im)/sqrt(2)
    from a Generator, or from injected normals (re, im) of that shape. Under a
    process grid ``lattice`` is the block's, and the Generator's normals are the
    global field's with this rank's block kept (mesh.randn_block)."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    if normals is None:
        rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
        re = mesh.randn_block(shape, 0, generator, rdtype, device)
        im = mesh.randn_block(shape, 0, generator, rdtype, device)
    else:
        re, im = normals
    return (torch.complex(re, im) / math.sqrt(2.0)).to(dtype)


def z4_spinor(lattice, nc, nspin=4, dtype=torch.complex128, device="cuda",
              generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
    """Z4 noise: entries i^k, k in {0, 1, 2, 3}, uniform; k from a Generator,
    or the injected integers ``draws`` of that shape (the JAX package's
    ``z4_spinor`` draws k with jax.random.randint, whose stream torch cannot
    reproduce, so a test injects the same integers into both). Under a process
    grid ``lattice`` is the block's, and the Generator's integers are the global
    field's with this rank's block kept (mesh.randint_block)."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    if draws is None:
        k = mesh.randint_block(4, shape, 0, generator, device)
    else:
        k = torch.as_tensor(draws, device=device).reshape(shape)
    vals = torch.tensor([1, 1j, -1, -1j], dtype=dtype, device=k.device)
    return vals[k.long()]


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global <a, b> = sum conj(a) b, in the working dtype (over the ranks of a
    process grid)."""
    return global_sum(torch.sum(a.conj() * b))
