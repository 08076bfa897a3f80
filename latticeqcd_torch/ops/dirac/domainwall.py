"""Standard (Shamir) domain-wall Dirac operator on the Wilson kernels.

Counterpart of latticeqcd_tpu/ops/dirac/domainwall.py, same layouts: full
fields psi[L5, X, Y, Z, T, 4, NC], packed even-odd fields
[L5, X/2, Y, Z, T, 4, NC]. With P+- = (1 +- g5)/2,

    (D psi)_s = [D_w4(M) + 1] psi_s - P- psi_{s+1} - P+ psi_{s-1},

chiral boundaries psi_{L5} -> -m psi_0 and psi_{-1} -> -m psi_{L5-1},
where D_w4(M) = (4r + M) - (1/2) H is the 4D Wilson operator with bare
mass M and H the Wilson hop. On each fifth-dimension slice the 4D pieces
are the port's Wilson operator at kappa = 1/2:

* D_w4(M) psi_s = D_W(1/2) psi_s + (4r + M - 1) psi_s, D_W the full
  Wilson D (the wilson_window kernel at the operator's r, its r mode at
  r != 1; 2 L5 launches per D^dag D);
* the packed hop B psi_s = -(1/2) H psi_s on target-parity sites (the
  wilson_hop_packed kernel at the operator's r, 2 L5 launches per Schur
  operator).

Each slice of a contiguous 5D field is a contiguous, 16-byte aligned
view, so it goes to the kernel's autograd Function as it is and the force
gets the link gradients. The adjoints are gamma5 D_W gamma5 and
gamma5 H gamma5 with the same links and target parity (the L5 couplings
commute with gamma5, so whole operators are conjugated at once). The
4D-site-local block A (the diagonal 4r + M + 1 and the L5 couplings) and
its inverse are pairs of L5 x L5 matrices, one per chirality, built on the
host in float64 and applied along s. On the CPU each slice takes the
Wilson kernels' plain versions (the projector form at r != 1); the
kernels hold NC = 3 and raise on other CUDA fields.

Fields may lead with a chain axis of independent lattices (links [n, 4,
X, Y, Z, T, 3, 3], fields [n, L5, ...], HMC.step_batched): each s slice
of all chains is one launch (a contiguous copy of the slice), so a D_w4
takes L5 launches for any n; the L5 couplings and blocks act along the
axis after the chains.

Under a process grid (parallel/mesh.py) every field is this rank's block
and each slice goes through its kernel's halo mode: one exchange of the
slice's faces per hop (2 L5 per Shat, 4 L5 per Shat^dag Shat), the
backward links' faces once per link tensor, and each slice's link
gradient moved across the faces by its own backward; autograd sums the
slices. The L5 x L5 site blocks act along s only and need no exchange.
With a chain axis there, each slice of all chains is one exchange (every
chain's faces in one message) and one launch of the kernel's chain-halo
mode.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
from latticeqcd_torch.ops.dirac.wilson_kernel import gamma5


def chiral_join(plus: torch.Tensor, minus: torch.Tensor) -> torch.Tensor:
    """P+ plus + P- minus: gamma5 = diag(1, 1, -1, -1), so P+ keeps spins 0, 1
    and P- spins 2, 3 (spin axis -2)."""
    return torch.cat([plus[..., :2, :], minus[..., 2:, :]], dim=-2)


@functools.lru_cache(maxsize=None)
def _l5_matrices(dirac: "DomainwallDirac", inverse: bool, dag: bool, dtype, device):
    """(M+, M-) on ``device``: A+- or their inverses, with A^dag = (A-, A+)."""
    mats = dirac._a_mats()
    if dag:
        mats = mats[::-1]
    if inverse:
        mats = tuple(np.linalg.inv(m) for m in mats)
    return tuple(torch.as_tensor(m, dtype=dtype, device=device) for m in mats)


@dataclass(frozen=True)
class DomainwallDirac:
    """D_dw(m) with height M and extent L5."""

    mass: float  # physical (boundary) mass m
    m5: float  # domain-wall height M (the reference's Domainwall_M)
    l5: int
    r: float = 1.0
    bc: tuple = (1, 1, 1, -1)

    @property
    def _w4(self) -> WilsonDirac:
        """The 4D Wilson operator at kappa = 1/2 that runs each slice."""
        return WilsonDirac(kappa=0.5, r=self.r, bc=self.bc)

    @staticmethod
    def _s_axis(psi) -> int:
        """The fifth axis: 0, or 1 after a leading chain axis."""
        return psi.ndim - 7

    def _slices(self, fn, psi: torch.Tensor, dag: bool) -> torch.Tensor:
        """fn on every s slice (all chains at once), or gamma5 fn gamma5 with dag."""
        src = gamma5(psi) if dag else psi
        ax = self._s_axis(psi)
        out = torch.stack([fn(p.contiguous()) for p in src.unbind(ax)], dim=ax)
        return gamma5(out) if dag else out

    def _wilson4(self, u, psi, dag: bool = False):
        """D_w4(M) psi = (4r + M) psi - (1/2) H psi on each slice (dag: its adjoint)."""
        w = self._w4
        shift = 4.0 * self.r + self.m5 - 1.0
        return self._slices(lambda p: w.apply(u, p), psi, dag) + shift * psi

    def _couplings(self, psi, dag: bool):
        """P- psi_{s+1} + P+ psi_{s-1} with the -m boundaries (dag: the
        chiralities swap shifts, since S+m^T = S-m)."""
        ax, l5 = self._s_axis(psi), self.l5
        up = torch.cat([psi.narrow(ax, 1, l5 - 1), -self.mass * psi.narrow(ax, 0, 1)], dim=ax)
        dn = torch.cat([-self.mass * psi.narrow(ax, l5 - 1, 1), psi.narrow(ax, 0, l5 - 1)],
                       dim=ax)
        return chiral_join(up, dn) if dag else chiral_join(dn, up)

    def apply(self, u: torch.Tensor, psi: torch.Tensor, dag: bool = False) -> torch.Tensor:
        """D_dw(m) psi (dag: D_dw(m)^dag psi); u must carry the boundary phases."""
        return self._wilson4(u, psi, dag) + psi - self._couplings(psi, dag)

    def apply_dagger(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return self.apply(u, psi, dag=True)

    def apply_ddag_d(self, u, psi):
        return self.apply_dagger(u, self.apply(u, psi))

    # ---------------------------------------- even-odd (4D checkerboard) Schur form
    # D = [[A, B_eo], [B_oe, A]] by 4D site parity, det D = det(A) det(Shat) with
    # Shat = A - B_eo A^-1 B_oe on packed even fields; A carries no links.

    def _a_mats(self):
        """(A+, A-) as numpy L5 x L5: A+- = d I - S-+ with the -m corner,
        d = 4r + M + 1."""
        d = 4.0 * self.r + self.m5 + 1.0
        l5 = self.l5
        s_up = np.zeros((l5, l5))  # (S+ psi)_s = psi_{s+1}, corner -m
        s_dn = np.zeros((l5, l5))
        for s in range(l5 - 1):
            s_up[s, s + 1] = 1.0
            s_dn[s + 1, s] = 1.0
        s_up[l5 - 1, 0] = -self.mass
        s_dn[0, l5 - 1] = -self.mass
        return d * np.eye(l5) - s_dn, d * np.eye(l5) - s_up  # P+ couples to s-1, P- to s+1

    def _apply_l5(self, psi, inverse: bool, dag: bool):
        """P+ (M+ along s) psi + P- (M- along s) psi, M = A or A^-1 (dag: A^dag)."""
        m_plus, m_minus = _l5_matrices(self, inverse, dag, psi.dtype, psi.device)
        eq = "lk,nk...->nl..." if self._s_axis(psi) else "lk,k...->l..."
        return torch.cat([torch.einsum(eq, m_plus, psi[..., :2, :]),
                          torch.einsum(eq, m_minus, psi[..., 2:, :])], dim=-2)

    def apply_a(self, psi, dag: bool = False):
        """The 4D-site-local block A of D (any packing); A^dag swaps the chiral
        matrices (A+^T = A-)."""
        return self._apply_l5(psi, inverse=False, dag=dag)

    def apply_a_inv(self, psi, dag: bool = False):
        """A^-1 psi (A^-dag with dag) through the host-inverted L5 x L5 matrices."""
        return self._apply_l5(psi, inverse=True, dag=dag)

    def packed_links(self, up):
        """(U_even, U_odd) of links that carry the boundary phases, each chain's over a
        leading chain axis."""
        if up.ndim == 8:
            return torch.func.vmap(self.packed_links)(up)
        return eo_pack.pack_links(up, tuple(up.shape[1:5]))

    @staticmethod
    def pack5(f, lattice, parity: int):
        """5D field (L5,X,Y,Z,T,...) -> packed (L5,X/2,Y,Z,T,...)."""
        return torch.stack([eo_pack.pack(fs, lattice, parity) for fs in f])

    @staticmethod
    def unpack5(fp, lattice, parity: int):
        return torch.stack([eo_pack.unpack(fs, lattice, parity) for fs in fp])

    def _packed_hop(self, u_t, u_s, psi_p, target_parity: int, dag: bool = False):
        """B psi_p = -(1/2) H psi_p on target-parity sites, psi_p packed on the
        other parity (dag: gamma5 B gamma5, the adjoint block)."""
        w = self._w4
        return -0.5 * self._slices(lambda p: w.hop_packed(u_t, u_s, p, target_parity), psi_p, dag)

    def apply_schur(self, u_eo, phi_e: torch.Tensor, dag: bool = False) -> torch.Tensor:
        """Shat phi = (A - B_eo A^-1 B_oe) phi on packed even fields; with dag
        Shat^dag = A^dag - B_oe^dag A^-dag B_eo^dag."""
        u_e, u_o = u_eo
        t = self._packed_hop(u_o, u_e, phi_e, target_parity=1, dag=dag)
        t = self.apply_a_inv(t, dag=dag)
        t = self._packed_hop(u_e, u_o, t, target_parity=0, dag=dag)
        return self.apply_a(phi_e, dag=dag) - t

    def apply_schur_dagger(self, u_eo, phi_e: torch.Tensor) -> torch.Tensor:
        return self.apply_schur(u_eo, phi_e, dag=True)

    def apply_schur_ddag_d(self, u_eo, phi_e):
        return self.apply_schur_dagger(u_eo, self.apply_schur(u_eo, phi_e))
