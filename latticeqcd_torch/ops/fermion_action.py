"""Pseudofermion actions with their exact forces: two-flavour Wilson and
staggered Nf = 1..8 (RHMC where needed).

Counterpart of latticeqcd_tpu/ops/fermion_action.py (``_project_force``,
``WilsonFermiAction``, ``StaggeredFermiAction``):

* Wilson Nf=2: S = phi^dag (A A^dag)^-1 phi with A the even-odd Schur
  operator Dhat on packed even sites (all-even lattices, csw = 0) or the
  full D otherwise;
* staggered: S = sum_i phi_i^dag W^-(Nf/4npf) phi_i on even sites with
  W = m^2 - Dslash^2|_ee, one pseudofermion for Nf <= 4 and two for
  Nf in 5..8, rational powers by Gauss-Jacobi partial fractions and the
  multi-shift CG.

Each force solves once (detached, as jax.lax.stop_gradient does) and
differentiates the operator's quadratic form in the solutions with
respect to the bare links through the boundary phases, the link packing
and the hop's autograd Function, and with ``smear_fn`` through the stout
layers, whose graph is built once per force. Every action names the
shape of its Gaussian noise (``noise_shape``), so the HMC can draw it or
replay injected draws. Hasenbusch and domain-wall actions wait for a later slice
(ROADMAP A12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from latticeqcd_torch.ops import eigen, rational, solvers, sun
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    gaussian_spinor,
    inner,
)

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
        Generator, or the injected normals (re, im)); S_old = |xi|^2."""
        up = self._phased(u)
        xi = gaussian_spinor(self.noise_shape(u)[:4], u.shape[-1], nspin=4, dtype=u.dtype,
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

    def force(self, u, phi, log=None, smear_fn=None):
        return self.force_with_guess(u, phi, None, log=log, smear_fn=smear_fn)[0]

    def force_with_guess(self, u, phi, x0, log=None, smear_fn=None):
        """Force with the CG warm-started from x0 (chronological
        inverter); returns (force, x) so the caller can thread x on.
        With smear_fn the solve runs on the smeared links and the
        gradient is taken into the bare links through the smearing."""
        uu, us = _smeared_leaf(u, smear_fn)
        with torch.no_grad():
            up = self._phased(us.detach())
            packed = self._packed(up, phi)
            x = self._solve_normal(up, phi, x0=x0, log=log)
        with torch.enable_grad():
            uup = apply_boundary_phases(us, self.dirac.bc)
            if packed:
                ueo = self.dirac.packed_links(uup)
                c = torch.real(inner(x, self.dirac.apply_dhat_ddag(ueo, x)))
            else:
                c = torch.real(inner(x, self.dirac.apply_d_ddag(uup, x)))
            (g,) = torch.autograd.grad(c, uu)
        return _project_force(u, g), x


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
        the links' device (masked to even sites, packed), unless one is given."""
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
        tolerance. phi is stacked [n_pf, X, Y, Z, T, NC] on the full lattice."""
        shape = self.noise_shape(u)
        if normals is None:
            kw = dict(generator=generator, dtype=u.real.dtype, device=u.device)
            normals = (torch.randn(shape, **kw), torch.randn(shape, **kw))
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

    @staticmethod
    def _is_single_pole(pf) -> bool:
        return (len(pf.shifts) == 1 and abs(pf.shifts[0]) < 1e-14
                and abs(pf.residues[0] - 1.0) < 1e-14 and abs(pf.const) < 1e-14)
