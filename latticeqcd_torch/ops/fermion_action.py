"""Pseudofermion actions with their exact forces: two-flavour Wilson
(clover-improved or not, with or without Hasenbusch mass
preconditioning), two-flavour domain-wall with its Pauli-Villars partner,
and staggered Nf = 1..8 (RHMC where needed).

Counterpart of latticeqcd_tpu/ops/fermion_action.py (``_project_force``,
``WilsonFermiAction``, ``HasenbuschWilsonFermiAction``,
``DomainwallFermiAction``, ``StaggeredFermiAction``):

* Wilson Nf=2: S = phi^dag (A A^dag)^-1 phi with A the even-odd Schur
  operator Dhat on packed even sites (all-even lattices, csw = 0) or the
  full D otherwise (with csw != 0 the clover term, its site matrices
  built once per solve and once per force, the force's under autograd);
* Hasenbusch Nf=2: the same determinant split by the twisted heavy
  operator A_mu = A + i mu g5 into S1 = phi1^dag (A A^dag + mu^2)^-1 phi1
  and S2 = phi2^dag A_mu (A A^dag)^-1 A_mu^dag phi2, two noises, with
  the heavy and the light force apart for the Sexton-Weingarten split;
* domain wall Nf=2: S = phi^dag A_PV (A^dag A)^-1 A_PV^dag phi with A the
  5D even-odd Schur operator Shat (all-even lattices) or the full 5D D at
  mass m, and A_PV the same operator at m = 1;
* staggered: S = sum_i phi_i^dag W^-(Nf/4npf) phi_i on even sites with
  W = m^2 - Dslash^2|_ee, one pseudofermion for Nf <= 4 and two for
  Nf in 5..8, rational powers by Gauss-Jacobi partial fractions and the
  multi-shift CG.

Every action but staggered on a lattice with an odd extent also has
batched forms for the independent chains of HMC.step_batched
(``*_batched``): links [n, 4, X, Y, Z, T, NC, NC], one kernel launch per
hop or full D for all chains (per fifth-dimension slice for domain wall),
the solves per chain in one masked batched CG (solvers.cg_multi) or
multi-shift CG (solvers.multishift_cg_multi), per-chain chronological
guesses, and the force the gradient of the sum over chains of each
chain's quadratic form, which is per chain by construction. The packing
of the links, the clover term and the force's projection are mapped over
the chains with torch.func.vmap, and ``smear_fn`` (the smearing mapped
over the chains) is differentiated outside any vmap. The Wilson, Hasenbusch
and domain-wall actions run their single-chain code on stacked links:
what differs is the solver and the per-chain sums, chosen by the links'
chain axis.

Each force solves once (detached, as jax.lax.stop_gradient does) and
differentiates the operator's quadratic form in the solutions with
respect to the bare links through the boundary phases, the link packing
and the hop's autograd Function, and with ``smear_fn`` through the stout
layers, whose graph is built once per force. Every action names the
shape of its Gaussian noise (``noise_shape``), so the HMC can draw it or
replay injected draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from latticeqcd_torch.ops import eigen, rational, solvers, sun
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    gaussian_spinor,
    inner,
)
from latticeqcd_torch.ops.dirac.wilson_kernel import gamma5
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.parallel.mesh import global_sum

DIRS = 4


def _smeared_leaf(u, smear_fn):
    """(leaf, links the operator sees): a detached leaf of the bare links
    that requires grad, and smear_fn of it (built under enable_grad, so
    also inside a no_grad caller), or the leaf itself. The smearing runs
    once per force: the solve takes its detached value."""
    uu = u.detach().requires_grad_(True)
    if smear_fn is None:
        return uu, uu
    with torch.enable_grad():
        return uu, smear_fn(uu)


def _phased_with_clover(dirac: WilsonDirac, us):
    """(links with the boundary phases, the clover term or None) under autograd:
    a force builds the clover term once, the solve takes its detached value and
    the gradient its graph."""
    with torch.enable_grad():
        uup = apply_boundary_phases(us, dirac.bc)
        return uup, dirac.clover(uup)


def _detached(t):
    return None if t is None else t.detach()


def _project_force(u, grad_c):
    """Hdot = +(1/2) proj_TH(i U g^T) per direction for the gradient g of a
    real scalar c(U), with g in JAX's convention. PyTorch's gradient is
    the complex conjugate of JAX's, so g^T = grad_c^dag here."""
    out = []
    for mu in range(DIRS):
        m = 1j * sun.mul(u[mu], sun.dagger(grad_c[mu]))
        out.append(0.5 * sun.traceless_hermitian(m))
    return torch.stack(out, dim=0)


# ---------------------------------------------------- independent chains


def _chain_inner(a, b):
    """Re<a_i, b_i> of each chain of a leading chain axis."""
    return global_sum(torch.real(torch.sum(a.conj() * b, dim=tuple(range(1, a.ndim)))))


def _chain_packed_links(dirac, up):
    """(u_e, u_o) of each chain, each with the chain axis in front."""
    return torch.func.vmap(dirac.packed_links)(up)


def _chain_noise(normals, dtype):
    """Unit complex Gaussian noise (re + i im) / sqrt(2) from stacked normals."""
    return (torch.complex(*normals) / math.sqrt(2.0)).to(dtype)


def _chain_force(us, quadratic, smear_fn=None):
    """_project_force of each chain for the gradient of quadratic(links), a real
    scalar summed over the chains (the solves held fixed), with respect to the
    stacked bare links (through smear_fn if given)."""
    uu, ul = _smeared_leaf(us, smear_fn)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(quadratic(ul), uu)
    return torch.func.vmap(_project_force)(us, g)


def _chained(u) -> bool:
    """Whether the links lead with a chain axis ([n, 4, X, Y, Z, T, NC, NC])."""
    return u.ndim == 8


def _lattice(u):
    return tuple(u.shape[-6:-2])


def _cg(u):
    """The CG of solves on the links u: one masked batched CG over a chain axis."""
    return solvers.cg_multi if _chained(u) else solvers.cg


def _re_inner(u, a, b):
    """Re<a, b>, of each chain over a chain axis of the links u."""
    return _chain_inner(a, b) if _chained(u) else torch.real(inner(a, b))


def _project(u, g):
    """_project_force, of each chain over a chain axis of the links u."""
    return torch.func.vmap(_project_force)(u, g) if _chained(u) else _project_force(u, g)


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

    noise_lead = 0  # the axis where the noise's lattice axes start

    def noise_shape(self, u):
        """Shape of the Gaussian normals of one draw of xi: packed even sites
        when even-odd applies, else the full lattice, then (4, NC)."""
        lattice = tuple(u.shape[1:5])
        if self._eo(lattice):
            lattice = (lattice[0] // 2,) + lattice[1:]
        return lattice + (4, u.shape[-1])

    @torch.no_grad()
    def sample_pseudofermion(self, u, generator: Optional[torch.Generator] = None, normals=None):
        """(S_old, phi): phi = A xi with unit Gaussian xi (from the
        Generator, or the injected normals (re, im)); S_old = |xi|^2. Under a
        process grid the Generator's normals are the global lattice's, this
        rank's block kept (gaussian_spinor). Links with a chain axis take
        stacked normals and give S_old per chain."""
        up = self._phased(u)
        if _chained(u):
            xi = _chain_noise(normals, u.dtype)
        else:
            xi = gaussian_spinor(self.noise_shape(u)[:4], u.shape[-1], nspin=4, dtype=u.dtype,
                                 device=u.device, generator=generator, normals=normals)
        if self._eo(_lattice(u)):
            phi = self.dirac.apply_dhat(self.dirac.packed_links(up), xi)
        else:
            phi = self.dirac.apply(up, xi)
        return _re_inner(u, xi, xi), phi

    def _packed(self, up, phi) -> bool:
        lead = up.ndim - 7
        return phi.ndim == 6 + lead and 2 * phi.shape[lead] == up.shape[lead + 1]

    def _d_ddag(self, up, packed: bool, clover=None):
        """A A^dag on the links ``up``: Dhat Dhat^dag, or D D^dag with the
        clover term ``clover`` (built here once when not given)."""
        if packed:
            ueo = self.dirac.packed_links(up)
            return lambda v: self.dirac.apply_dhat_ddag(ueo, v)
        if clover is None:
            clover = self.dirac.clover(up)
        return lambda v: self.dirac.apply_d_ddag(up, v, clover)

    def _solve_normal(self, up, phi, x0=None, log=None, clover=None):
        """x = (A A^dag)^-1 phi with A = Dhat (packed phi) or D."""
        x, _, _ = _cg(up)(self._d_ddag(up, self._packed(up, phi), clover), phi, x0=x0,
                          eps=self.eps_cg, maxiter=self.max_cg, log=log)
        return x

    @torch.no_grad()
    def action(self, u, phi, log=None):
        x = self._solve_normal(self._phased(u), phi, log=log)
        return _re_inner(u, phi, x)

    def force(self, u, phi, log=None, smear_fn=None):
        return self.force_with_guess(u, phi, None, log=log, smear_fn=smear_fn)[0]

    def force_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """Force with the CG warm-started from x0 (chronological
        inverter); returns (force, x) so the caller can thread x on.
        With smear_fn the solve runs on the smeared links and the
        gradient is taken into the bare links through the smearing."""
        uu, us = _smeared_leaf(u, smear_fn)
        uup, clover = _phased_with_clover(self.dirac, us)
        packed = self._packed(uup, phi)
        with torch.no_grad():
            x = self._solve_normal(uup.detach(), phi, x0=x0, log=log, clover=_detached(clover))
        with torch.enable_grad():
            c = torch.real(inner(x, self._d_ddag(uup, packed, clover)(x)))
            (g,) = torch.autograd.grad(c, uu)
        return _project(u, g), x

    # HMC.step_batched: the same forms on links [n, 4, X, Y, Z, T, NC, NC], phi with the
    # chain axis in front, normals stacked per chain; S and the solves per chain
    def sample_pseudofermion_batched(self, us, normals):
        return self.sample_pseudofermion(us, normals=normals)

    action_batched = action
    force_batched_with_guess = force_with_guess


# ---------------------------------------------------------------------------
# Wilson two-flavour with Hasenbusch mass preconditioning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HasenbuschWilsonFermiAction:
    """det(A A^dag) = det(A A^dag + mu^2) det[A A^dag (A A^dag + mu^2)^-1] with
    A = Dhat (all-even lattices, csw = 0) or D, one pseudofermion per factor:

        S1 = phi1^dag (A A^dag + mu^2)^-1 phi1         (heavy)
        S2 = phi2^dag A_mu (A A^dag)^-1 A_mu^dag phi2   (light ratio)

    with A_mu = A + i mu g5 (A_mu A_mu^dag = A A^dag + mu^2 by
    gamma5-hermiticity). phi1 = A_mu xi1 and phi2 = A_mu^-dag A xi2 (one heavy
    solve), so S_old = |xi1|^2 + |xi2|^2."""

    dirac: WilsonDirac
    mu: float = 0.5
    eps_cg: float = 1e-19
    max_cg: int = 3000

    def _phased(self, u):
        return apply_boundary_phases(u, self.dirac.bc)

    def _eo(self, lattice) -> bool:
        return self.dirac.csw == 0.0 and eo_pack.packable(lattice)

    noise_lead = 1  # after the axis of the two noises

    def noise_shape(self, u):
        """(2,) for the two noises xi1, xi2, then the packed even sites when
        even-odd applies, else the full lattice, then (4, NC)."""
        lattice = tuple(u.shape[1:5])
        if self._eo(lattice):
            lattice = (lattice[0] // 2,) + lattice[1:]
        return (2,) + lattice + (4, u.shape[-1])

    def _ops(self, up, packed: bool, clover=None):
        """(A, A^dag) on the links ``up``: Dhat, or D with the clover term
        ``clover`` (built here once when not given)."""
        d = self.dirac
        if packed:
            ueo = d.packed_links(up)
            return (lambda v: d.apply_dhat(ueo, v)), (lambda v: d.apply_dhat_dagger(ueo, v))
        if clover is None:
            clover = d.clover(up)
        return (lambda v: d.apply(up, v, clover)), (lambda v: d.apply_dagger(up, v, clover))

    def _amu(self, a, x):
        return a(x) + (1j * self.mu) * gamma5(x)

    def _amu_dag(self, a_dag, x):
        return a_dag(x) - (1j * self.mu) * gamma5(x)

    @staticmethod
    def _packed(up, phi) -> bool:
        lead = up.ndim - 7
        return 2 * phi[0].shape[lead] == up.shape[lead + 1]

    @torch.no_grad()
    def sample_pseudofermion(self, u, generator: Optional[torch.Generator] = None, normals=None,
                             log=None):
        """(S_old, (phi1, phi2)) from unit Gaussian xi1, xi2 (from the Generator, or
        the injected normals (re, im) of noise_shape(u), xi_i = normals[.][i]). Under
        a process grid the Generator's normals are the global lattice's, this rank's
        block kept. Links with a chain axis take normals stacked per chain (xi_i =
        normals[.][:, i]) and give S_old per chain."""
        if normals is None:
            normals = tuple(mesh.randn_block(self.noise_shape(u), self.noise_lead, generator,
                                             u.real.dtype, u.device) for _ in range(2))
        xi = (torch.complex(*normals) / math.sqrt(2.0)).to(u.dtype)
        xi1, xi2 = (xi[:, 0].contiguous(), xi[:, 1].contiguous()) if _chained(u) else xi
        a, a_dag = self._ops(self._phased(u), self._eo(_lattice(u)))
        phi1 = self._amu(a, xi1)
        # phi2 = A_mu (A^dag A + mu^2)^-1 A xi2: one well-conditioned heavy solve
        z, _, _ = _cg(u)(lambda v: a_dag(a(v)) + self.mu ** 2 * v, a(xi2), eps=self.eps_cg,
                         maxiter=self.max_cg, log=log)
        s_old = _re_inner(u, xi1, xi1) + _re_inner(u, xi2, xi2)
        return s_old, (phi1, self._amu(a, z))

    def _heavy_solve(self, cg, a, a_dag, phi1, x0=None, log=None):
        """x1 = (A A^dag + mu^2)^-1 phi1 by ``cg``."""
        x1, _, _ = cg(lambda v: a(a_dag(v)) + self.mu ** 2 * v, phi1, x0=x0,
                      eps=self.eps_cg, maxiter=self.max_cg, log=log)
        return x1

    def _light_solve(self, cg, a, a_dag, phi2, x0=None, log=None):
        """(w, x2): w = A_mu^dag phi2, x2 = (A A^dag)^-1 w by ``cg``."""
        w = self._amu_dag(a_dag, phi2)
        x2, _, _ = cg(lambda v: a(a_dag(v)), w, x0=x0, eps=self.eps_cg,
                      maxiter=self.max_cg, log=log)
        return w, x2

    @torch.no_grad()
    def action(self, u, phi, log=None):
        up = self._phased(u)
        a, a_dag = self._ops(up, self._packed(up, phi))
        x1 = self._heavy_solve(_cg(u), a, a_dag, phi[0], log=log)
        w, x2 = self._light_solve(_cg(u), a, a_dag, phi[1], log=log)
        return _re_inner(u, phi[0], x1) + _re_inner(u, w, x2)

    def _force(self, u, phi, heavy: bool, light: bool, x0, log, smear_fn):
        """The force of S1 (heavy), S2 (light) or both, with the solves held fixed:
        c = Re<x1, A A^dag x1> + Re<x2, A A^dag x2> - 2 Re<x2, A_mu^dag phi2>
        (the terms of the parts asked for) and dS = -dc. Returns (force, the
        one solution, or None for both)."""
        uu, us = _smeared_leaf(u, smear_fn)
        uup, clover = _phased_with_clover(self.dirac, us)
        packed = self._packed(uup, phi)
        with torch.no_grad():
            a, a_dag = self._ops(uup.detach(), packed, _detached(clover))
            x1 = self._heavy_solve(_cg(u), a, a_dag, phi[0], x0, log) if heavy else None
            x2 = self._light_solve(_cg(u), a, a_dag, phi[1], x0, log)[1] if light else None
        with torch.enable_grad():
            a, a_dag = self._ops(uup, packed, clover)
            c = 0.0
            if heavy:
                c = c + torch.real(inner(x1, a(a_dag(x1))))
            if light:
                c = (c + torch.real(inner(x2, a(a_dag(x2))))
                     - 2.0 * torch.real(inner(x2, self._amu_dag(a_dag, phi[1]))))
            (g,) = torch.autograd.grad(c, uu)
        solution = None if heavy and light else (x1 if heavy else x2)
        return _project(u, g), solution

    def force(self, u, phi, log=None, smear_fn=None):
        """The total force (both solves from zero: the JAX package threads no
        guess through the unsplit Hasenbusch force)."""
        return self._force(u, phi, True, True, None, log, smear_fn)[0]

    def force_heavy(self, u, phi, log=None, smear_fn=None):
        """The force of S1 alone: the fine scale of a Sexton-Weingarten split."""
        return self._force(u, phi, True, False, None, log, smear_fn)[0]

    def force_heavy_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """The heavy force with its CG warm-started from x0; returns (force, x1)."""
        return self._force(u, phi, True, False, x0, log, smear_fn)

    def force_light(self, u, phi, log=None, smear_fn=None):
        """The force of S2 alone: the coarse scale of a Sexton-Weingarten split."""
        return self._force(u, phi, False, True, None, log, smear_fn)[0]

    def force_light_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """The light force with its CG warm-started from x0; returns (force, x2)."""
        return self._force(u, phi, False, True, x0, log, smear_fn)

    # HMC.step_batched: the same forms on links [n, 4, X, Y, Z, T, NC, NC], phi1 and phi2
    # with the chain axis in front, normals [n, 2, ...]; S and the solves per chain
    def sample_pseudofermion_batched(self, us, normals):
        return self.sample_pseudofermion(us, normals=normals)

    action_batched = action

    def force_batched_with_guess(self, us, phi, x0, log=None, smear_fn=None):
        """The total force of each chain (both solves from zero, as ``force``)."""
        return self._force(us, phi, True, True, None, log, smear_fn)

    force_heavy_batched_with_guess = force_heavy_with_guess
    force_light_batched_with_guess = force_light_with_guess


# ---------------------------------------------------------------------------
# Domain wall (2 flavours, Pauli-Villars regulated)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DomainwallFermiAction:
    """S = phi^dag A_PV (A^dag A)^-1 A_PV^dag phi, weight
    det(A^dag A) / det(A_PV^dag A_PV): A = Shat (the 5D even-odd Schur
    operator on packed even sites, every extent even) or the full 5D D at
    mass m, A_PV the same operator at m = 1. det D = det(A_site) det(Shat)
    with a link-independent site block, so both give the same measure."""

    dirac: DomainwallDirac  # at the physical mass m
    eps_cg: float = 1e-19
    max_cg: int = 3000

    def _pv(self) -> DomainwallDirac:
        return replace(self.dirac, mass=1.0)

    def _phased(self, u):
        return apply_boundary_phases(u, self.dirac.bc)

    noise_lead = 1  # after the fifth axis

    def noise_shape(self, u):
        """(L5,) + the packed even sites (every extent even) or the full
        lattice + (4, NC)."""
        lattice = tuple(u.shape[1:5])
        if eo_pack.packable(lattice):
            lattice = (lattice[0] // 2,) + lattice[1:]
        return (self.dirac.l5,) + lattice + (4, u.shape[-1])

    @staticmethod
    def _packed(up, phi) -> bool:
        lead = up.ndim - 7
        return 2 * phi.shape[lead + 1] == up.shape[lead + 1]

    def _ops(self, up, packed: bool, dirac: DomainwallDirac):
        """(A, A^dag) of ``dirac`` on the links ``up``."""
        if packed:
            ueo = dirac.packed_links(up)
            return (lambda v: dirac.apply_schur(ueo, v),
                    lambda v: dirac.apply_schur_dagger(ueo, v))
        return (lambda v: dirac.apply(up, v)), (lambda v: dirac.apply_dagger(up, v))

    def _solve_normal(self, up, b, x0=None, log=None):
        """x = (A^dag A)^-1 b with A = Shat (packed b) or D."""
        a, a_dag = self._ops(up, self._packed(up, b), self.dirac)
        x, _, _ = _cg(up)(lambda v: a_dag(a(v)), b, x0=x0, eps=self.eps_cg,
                          maxiter=self.max_cg, log=log)
        return x

    @torch.no_grad()
    def sample_pseudofermion(self, u, generator: Optional[torch.Generator] = None, normals=None,
                             log=None):
        """(S_old, phi): phi = A_PV (A_PV^dag A_PV)^-1 A^dag xi with unit Gaussian
        xi (from the Generator, or the injected normals (re, im) of
        noise_shape(u)), so that S(phi) = |xi|^2 = S_old. Under a process grid the
        Generator's normals are the global lattice's, this rank's block kept. Links
        with a chain axis take normals stacked per chain and give S_old per chain."""
        if normals is None:
            normals = tuple(mesh.randn_block(self.noise_shape(u), self.noise_lead, generator,
                                             u.real.dtype, u.device) for _ in range(2))
        xi = (torch.complex(*normals) / math.sqrt(2.0)).to(u.dtype)
        up = self._phased(u)
        packed = eo_pack.packable(_lattice(u))
        _, a_dag = self._ops(up, packed, self.dirac)
        pv, pv_dag = self._ops(up, packed, self._pv())
        w, _, _ = _cg(u)(lambda v: pv_dag(pv(v)), a_dag(xi), eps=self.eps_cg,
                         maxiter=self.max_cg, log=log)
        return _re_inner(u, xi, xi), pv(w)

    @torch.no_grad()
    def action(self, u, phi, log=None):
        up = self._phased(u)
        _, pv_dag = self._ops(up, self._packed(up, phi), self._pv())
        b = pv_dag(phi)
        return _re_inner(u, b, self._solve_normal(up, b, log=log))

    def force(self, u, phi, log=None, smear_fn=None):
        return self.force_with_guess(u, phi, None, log=log, smear_fn=smear_fn)[0]

    def force_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """Force with the CG warm-started from x0 (chronological inverter);
        returns (force, x). dS = 2 Re<phi, dA_PV x> - <x, d(A^dag A) x> with
        x = (A^dag A)^-1 A_PV^dag phi held fixed: c = 2 Re<phi, A_PV x> - |A x|^2
        is differentiated into the bare links (through smear_fn if given), and
        since dc = dS the force is -_project_force."""
        uu, us = _smeared_leaf(u, smear_fn)
        with torch.no_grad():
            up = self._phased(us.detach())
            packed = self._packed(up, phi)
            _, pv_dag = self._ops(up, packed, self._pv())
            x = self._solve_normal(up, pv_dag(phi), x0=x0, log=log)
        with torch.enable_grad():
            uup = apply_boundary_phases(us, self.dirac.bc)
            a, _ = self._ops(uup, packed, self.dirac)
            pv, _ = self._ops(uup, packed, self._pv())
            dx = a(x)
            c = 2.0 * torch.real(inner(phi, pv(x))) - torch.real(inner(dx, dx))
            (g,) = torch.autograd.grad(c, uu)
        return -_project(u, g), x

    # HMC.step_batched: the same forms on links [n, 4, X, Y, Z, T, NC, NC], phi [n, L5, ...],
    # normals stacked per chain; S and the solves per chain
    def sample_pseudofermion_batched(self, us, normals):
        return self.sample_pseudofermion(us, normals=normals)

    action_batched = action
    force_batched_with_guess = force_with_guess


# ---------------------------------------------------------------------------
# Staggered Nf (1..8), RHMC as needed
# ---------------------------------------------------------------------------

# seed of the spectral estimators' start vector (the JAX package's PRNGKey)
SPECTRAL_SEED = 20260820


@dataclass(frozen=True)
class StaggeredFermiAction:
    """det(D)^(Nf/4) via even-site pseudofermions on W = m^2 - Dslash^2."""

    dirac: StaggeredDirac
    nf: int = 4
    eps_cg: float = 1e-19
    max_cg: int = 3000
    rational_tol: float = 1e-10
    # runtime-widened upper spectral bound (see ensure_spectral_bounds);
    # None -> the free-field bound m^2 + 16.5
    hi_override: Optional[float] = None

    def __post_init__(self):
        if not (1 <= self.nf <= 8):
            raise ValueError(f"staggered Nf must be in 1..8, got {self.nf}")

    @property
    def n_pf(self) -> int:
        return 1 if self.nf <= 4 else 2

    @property
    def action_beta(self) -> float:
        return self.nf / (4.0 * self.n_pf)  # in (0, 1]

    @property
    def sample_beta(self) -> float:
        return self.nf / (8.0 * self.n_pf)  # in (0, 1/2]

    def _bounds(self):
        """Spectral window of W used to build the rational approximation:
        lo = 0.999 m^2 is a true lower bound on any configuration
        (-Dslash^2 is positive semi-definite); hi = m^2 + 16.5 is the
        free-field bound ||Dslash|| <= 4 with 3% headroom, which
        ensure_spectral_bounds checks and can widen (hi_override)."""
        m2 = self.dirac.mass ** 2
        hi = m2 + 16.5 if self.hi_override is None else self.hi_override
        return m2 * 0.999, hi

    def _phased(self, u):
        return apply_boundary_phases(u, self.dirac.bc)

    def _packed(self) -> bool:
        """The solvers run on packed even fields whenever every extent is even."""
        return eo_pack.packable(self.dirac.lattice)

    def _w(self, up):
        """The W mat-vec on the links ``up`` (boundary phases applied)."""
        if self._packed():
            ueo = self.dirac.packed_links(up)
            return lambda v: self.dirac.apply_w_packed(ueo, v)
        return lambda v: self.dirac.apply_w_even(up, v)

    # the noise's lattice axes start after its pseudofermion axis
    noise_lead = 1

    def noise_shape(self, u):
        """Shape of the Gaussian normals of one draw: (n_pf,) + the packed
        even sites + (NC,), or the full lattice (masked to even sites)
        when an extent is odd."""
        lattice = tuple(u.shape[1:5])
        if self._packed():
            lattice = (lattice[0] // 2,) + lattice[1:]
        return (self.n_pf,) + lattice + (u.shape[-1],)

    # ---------------------------------------------------- spectral guard
    def _w_matvec_packed_start(self, u, v0=None):
        """(matvec, v0) for spectral estimation: the production W apply and a
        Gaussian start vector from a Generator seeded with SPECTRAL_SEED on
        the links' device (masked to even sites, packed), unless one is given;
        under a process grid the global field's start vector, this rank's block kept."""
        matvec = self._w(self._phased(u))
        if v0 is None:
            g = torch.Generator(device=u.device).manual_seed(SPECTRAL_SEED)
            v0 = self.dirac.even_part(gaussian_spinor(tuple(u.shape[1:5]), u.shape[-1], nspin=1,
                                                      dtype=u.dtype, device=u.device, generator=g))
            if self._packed():
                v0 = self.dirac.pack(v0, 0)
        return matvec, v0

    @torch.no_grad()
    def lambda_max_w(self, u, n_iter: int = 30, v0=None):
        """Power-iteration estimate of lambda_max(W): the Rayleigh quotient
        after n_iter normalized iterations."""
        w, v = self._w_matvec_packed_start(u, v0)
        for _ in range(n_iter):
            wv = w(v)
            v = wv / torch.sqrt(torch.real(inner(wv, wv)))
        return torch.real(inner(v, w(v)))

    @torch.no_grad()
    def spectral_range_w(self, u, m: int = 32, v0=None):
        """Host-level (lambda_min, lambda_max) Ritz estimates of W from an
        m-step Lanczos (ops/eigen.py). lambda_min is a diagnostic; the
        rational window's lower bound stays the exact m^2 bound."""
        matvec, v0 = self._w_matvec_packed_start(u, v0)
        return eigen.extreme_eigs(matvec, v0, m=m)

    def ensure_spectral_bounds(self, u, n_iter: int = 30, safety: float = 1.05,
                               lam: Optional[float] = None, v0=None):
        """Check that the rational window's upper bound covers the measured
        lambda_max(W) on this configuration; if not, return a copy with
        the window widened. Returns (action, lambda_max estimate). ``lam``
        skips the estimate when the caller already has it."""
        if lam is None:
            lam = self.spectral_range_w(u, m=n_iter, v0=v0)[1]
        _, hi = self._bounds()
        if lam * safety > hi:
            return replace(self, hi_override=lam * safety), lam
        return self, lam

    # ------------------------------------------------------------ sample
    @torch.no_grad()
    def sample_pseudofermion(self, u, generator: Optional[torch.Generator] = None, normals=None):
        """(S_old, phi): phi_i = W^(Nf/8npf) xi_i with xi_i unit Gaussian on
        even sites (from the Generator, or the injected normals (re, im) of
        noise_shape(u)), so S_old = sum |xi_i|^2 up to the rational
        tolerance. phi is stacked [n_pf, X, Y, Z, T, NC] on the full lattice.
        Under a process grid the Generator's normals are the global lattice's,
        this rank's block kept."""
        shape = self.noise_shape(u)
        if normals is None:
            normals = tuple(mesh.randn_block(shape, self.noise_lead, generator, u.real.dtype,
                                             u.device) for _ in range(2))
        xi_all = (torch.complex(*normals) / math.sqrt(2.0)).to(u.dtype)
        packed = self._packed()
        if not packed:
            xi_all = self.dirac.even_part(xi_all)
        w = self._w(self._phased(u))
        lo, hi = self._bounds()
        beta = self.sample_beta
        phis = []
        s_old = 0.0
        for xi in xi_all:
            s_old = s_old + torch.real(inner(xi, xi))
            if abs(beta - 1.0) < 1e-14:
                phi = w(xi)
            else:
                pf = rational.rational_power(beta, lo, hi, tol=self.rational_tol)
                ys, _, _ = solvers.multishift_cg(w, xi, pf.shifts, eps=self.eps_cg,
                                                 maxiter=self.max_cg)
                phi = float(pf.const) * xi
                for j, a in enumerate(pf.residues):
                    phi = phi + float(a) * ys[j]
            phis.append(self.dirac.unpack(phi, 0) if packed else phi)
        return s_old, torch.stack(phis)

    # ------------------------------------------------------------ action
    def _pf_action(self):
        lo, hi = self._bounds()
        return rational.rational_inverse_power(self.action_beta, lo, hi, tol=self.rational_tol)

    def _field(self, phi_i):
        """One pseudofermion in the solvers' layout (packed even when packable)."""
        return self.dirac.pack(phi_i, 0) if self._packed() else phi_i

    @torch.no_grad()
    def action(self, u, phi, log=None):
        pf = self._pf_action()
        w = self._w(self._phased(u))
        total = 0.0
        for phi_i in phi:
            p = self._field(phi_i)
            xs, _, _ = solvers.multishift_cg(w, p, pf.shifts, eps=self.eps_cg,
                                             maxiter=self.max_cg, log=log)
            s = pf.const * torch.real(inner(p, p))
            for j, a in enumerate(pf.residues):
                s = s + float(a) * torch.real(inner(p, xs[j]))
            total = total + s
        return total

    # ------------------------------------------------------------- force
    def force(self, u, phi, log=None, smear_fn=None):
        """Exact RHMC force via partial fractions."""
        return self.force_with_guess(u, phi, None, log=log, smear_fn=smear_fn)[0]

    def force_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """Chronological inverter for the single-pole rational (Nf = 4, 8:
        W^-1 exactly): a plain CG warm-started from the previous MD step's
        solutions. Multi-pole RHMC keeps the multi-shift CG, which starts
        from zero (the shifted systems share one Krylov space); there the
        returned solutions are None and the guess thread stays empty.
        With smear_fn the solves run on the smeared links and the gradient
        is taken into the bare links through the smearing.
        Returns (force, solutions or None)."""
        pf = self._pf_action()
        single = self._is_single_pole(pf)
        xs_all = []
        xs_out = [] if single else None
        uu, us = _smeared_leaf(u, smear_fn)
        with torch.no_grad():
            w = self._w(self._phased(us.detach()))
            for i, phi_i in enumerate(phi):
                b = self._field(phi_i)
                if single:
                    x, _, _ = solvers.cg(w, b, x0=None if x0 is None else x0[i],
                                         eps=self.eps_cg, maxiter=self.max_cg, log=log)
                    xs = x[None]
                    xs_out.append(x)
                else:
                    xs, _, _ = solvers.multishift_cg(w, b, pf.shifts, eps=self.eps_cg,
                                                     maxiter=self.max_cg, log=log)
                xs_all.append(xs)
        with torch.enable_grad():
            w_d = self._w(apply_boundary_phases(us, self.dirac.bc))
            c = 0.0
            for xs in xs_all:
                for j, a in enumerate(pf.residues):
                    c = c + float(a) * torch.real(inner(xs[j], w_d(xs[j])))
            (g,) = torch.autograd.grad(c, uu)
        return _project_force(u, g), xs_out

    # HMC.step_batched: an all-even lattice (the packed W); the pseudofermions stay packed
    def batched_refusal(self, lattice) -> Optional[str]:
        """Why the batched forms do not apply on ``lattice``, or None: the full-volume W
        of an odd extent has no chain axis on the card yet (ROADMAP B3c)."""
        if not eo_pack.packable(lattice):
            return (f"staggered fermions on the lattice {lattice}, which cannot be packed "
                    "(ROADMAP B3c)")
        return None

    def _w_chains(self, up):
        ueo = _chain_packed_links(self.dirac, up)
        return lambda v: self.dirac.apply_w_packed(ueo, v)

    @torch.no_grad()
    def sample_pseudofermion_batched(self, us, normals):
        """(S_old per chain, phi [n, n_pf, X/2, Y, Z, T, NC], packed even sites) for
        the chains' links ``us`` from their stacked normals (re, im)."""
        xi_all = _chain_noise(normals, us.dtype)
        w = self._w_chains(self._phased(us))
        lo, hi = self._bounds()
        beta = self.sample_beta
        phis = []
        s_old = 0.0
        for k in range(self.n_pf):
            xi = xi_all[:, k].contiguous()
            s_old = s_old + _chain_inner(xi, xi)
            if abs(beta - 1.0) < 1e-14:
                phi = w(xi)
            else:
                pf = rational.rational_power(beta, lo, hi, tol=self.rational_tol)
                ys, _, _ = solvers.multishift_cg_multi(w, xi, pf.shifts, eps=self.eps_cg,
                                                       maxiter=self.max_cg)
                phi = float(pf.const) * xi
                for j, a in enumerate(pf.residues):
                    phi = phi + float(a) * ys[j]
            phis.append(phi)
        return s_old, torch.stack(phis, dim=1)

    @torch.no_grad()
    def action_batched(self, us, phi, log=None):
        """S of each chain: one batched multi-shift CG per pseudofermion."""
        pf = self._pf_action()
        w = self._w_chains(self._phased(us))
        total = 0.0
        for k in range(phi.shape[1]):
            p = phi[:, k].contiguous()
            xs, _, _ = solvers.multishift_cg_multi(w, p, pf.shifts, eps=self.eps_cg,
                                                   maxiter=self.max_cg, log=log)
            s = pf.const * _chain_inner(p, p)
            for j, a in enumerate(pf.residues):
                s = s + float(a) * _chain_inner(p, xs[j])
            total = total + s
        return total

    def force_batched_with_guess(self, us, phi, x0, log=None, smear_fn=None):
        """The force of each chain: for the single-pole rational a batched CG per
        pseudofermion warm-started from x0 [n_pf, n, ...], else the batched
        multi-shift CG from zero; with smear_fn the solves run on the smeared links.
        Returns (force, solutions or None)."""
        pf = self._pf_action()
        single = self._is_single_pole(pf)
        xs_all = []
        with torch.no_grad():
            w = self._w_chains(self._phased(us if smear_fn is None else smear_fn(us)))
            for k in range(phi.shape[1]):
                b = phi[:, k].contiguous()
                if single:
                    x, _, _ = solvers.cg_multi(w, b, x0=None if x0 is None else x0[k],
                                               eps=self.eps_cg, maxiter=self.max_cg, log=log)
                    xs = x[None]
                else:
                    xs, _, _ = solvers.multishift_cg_multi(w, b, pf.shifts, eps=self.eps_cg,
                                                           maxiter=self.max_cg, log=log)
                xs_all.append(xs)

        def quadratic(uu):
            w_d = self._w_chains(self._phased(uu))
            c = 0.0
            for xs in xs_all:
                for j, a in enumerate(pf.residues):
                    c = c + float(a) * torch.real(inner(xs[j], w_d(xs[j])))
            return c

        force = _chain_force(us, quadratic, smear_fn)
        return force, (torch.stack([xs[0] for xs in xs_all]) if single else None)

    @staticmethod
    def _is_single_pole(pf) -> bool:
        return (len(pf.shifts) == 1 and abs(pf.shifts[0]) < 1e-14
                and abs(pf.residues[0] - 1.0) < 1e-14 and abs(pf.const) < 1e-14)
