"""Fermionic measurements: chiral condensate, pion correlator, low Dirac spectrum.

Counterpart of latticeqcd_tpu/measurements/fermionic.py for the Wilson
(clover-improved or not), staggered and domain-wall operators:

* chiral condensate: Nr Z4 noise vectors r, pbp = <Re <r, D^-1 r>> / V
  times Nf/4 for staggered, 1 for Wilson and domain wall;
* pion correlator: NC * Nspinor point sources at the origin, solved as
  one batch, C_pi(t) = sum over x, source and sink indices of |S|^2;
* low Dirac spectrum: Ritz estimates of the k lowest eigenvalues of the
  packed staggered W (even extents, m != 0) or of D^dag D (Wilson and the
  full-volume 5D domain-wall D^dag D, through the wilson_window kernel on
  the card).

The solves D x = b run in one of four ways (``_solve_dinv_multi``):
the packed even-odd Schur system of clover Wilson (the wilson_hop_packed
kernel between the 12x12 site blocks A_ee and A_oo^-1), of Wilson (the
wilson_hop_packed kernel) or of staggered (the fused W of the
staggered_w kernel) when every extent is even, else full-volume CGNE on
D^dag D (Wilson through wilson_window, with the clover term built once
per call; staggered on the CPU only, as its full-volume operator is). Domain wall
measures the 4D effective propagator of wall sources
(``_dw_effective_propagator_multi``): the packed 5D Schur system on
even lattices (wilson_hop_packed), full-volume 5D CGNE otherwise
(wilson_window). The noise and the Lanczos start vector come from a
``torch.Generator`` or are injected: jax.random streams cannot be
reproduced in torch, so the tests hand both packages the same numbers.
Under a process grid (parallel/mesh.py) every field is this rank's block:
the noise and the start vector are the global fields' draws with the
block kept, every sum is global, and every rank returns the same numbers.
The domain-wall propagator runs on blocks as it is: its wall sources and
the chiral join of its walls act along s, local to a 4D site, and its 5D
packing uses the block's parity, which is the global one (every local
origin is even).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from latticeqcd_torch.ops import eigen, solvers
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac, chiral_join
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    gaussian_spinor,
    z4_spinor,
)
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.parallel.mesh import global_sum

# seed of the Lanczos start vector of dirac_low_spectrum (the JAX package's PRNGKey)
SPECTRUM_SEED = 20260822


def _each(fn, stack):
    """fn applied to every field of a stack (leading RHS axis)."""
    return torch.stack([fn(v) for v in stack])


@torch.no_grad()
def _solve_dinv_multi(dirac, up, b, eps, maxiter, deflate_k: int = 0, log: Optional[list] = None,
                      force_mode: Optional[str] = None):
    """D x_i = b_i for a stack of right-hand sides b (n, *lattice, [spin,] color),
    up the links with the boundary phases applied.

    * staggered, m != 0, every extent even: the even-odd Schur system in the
      packed layout, (m^2 - D_eo D_oe) x_e = m b_e - D_eo b_o and
      x_o = (b_o - D_oe x_e) / m, the CG on W (with an optional low-mode
      deflated guess, deflate_k > 0: one Lanczos sweep of W for the batch);
    * Wilson csw != 0, every extent even: with the clover blocks A,
      Dhat x_e = b_e + kappa H_eo A_oo^-1 b_o, Dhat = A_ee - kappa^2 H_eo A_oo^-1 H_oe,
      and x_o = A_oo^-1 (b_o + kappa H_oe x_e), the CG on Dhat^dag Dhat;
    * Wilson csw = 0, every extent even: Dhat x_e = b_e + kappa H_eo b_o and
      x_o = b_o + kappa H_oe x_e, the CG on Dhat^dag Dhat;
    * otherwise full-volume CGNE on D^dag D.
    The batch goes through solvers.cg_multi_auto (sequential on the CPU,
    batched on the card). ``log`` receives the solver records."""
    lattice = tuple(up.shape[1:5])
    packable = eo_pack.packable(lattice)
    solve = lambda op, rhs, x0=None: solvers.cg_multi_auto(  # noqa: E731
        op, rhs, eps=eps, maxiter=maxiter, force_mode=force_mode, x0=x0, log=log)[0]
    if isinstance(dirac, StaggeredDirac) and dirac.mass != 0.0 and packable:
        d = dirac
        u_e, u_o = d.packed_links(up)
        b_e = _each(lambda f: d.pack(f, 0), b)
        b_o = _each(lambda f: d.pack(f, 1), b)
        rhs_e = d.mass * b_e - _each(lambda v: d._packed_dslash(u_e, u_o, v, 0), b_o)
        w_one = lambda v: d.apply_w_packed((u_e, u_o), v)  # noqa: E731
        x0 = None
        if deflate_k:
            m_lan = max(3 * deflate_k, deflate_k + 16)
            evals, vecs = eigen.ritz_pairs_low(w_one, rhs_e[0], m_lan, deflate_k)
            x0 = eigen.deflation_guess(evals, vecs, rhs_e)
        x_e = solve(w_one, rhs_e, x0)
        x_o = (b_o - _each(lambda v: d._packed_dslash(u_o, u_e, v, 1), x_e)) / d.mass
        return _each(lambda v: d.unpack(v, 0), x_e) + _each(lambda v: d.unpack(v, 1), x_o)
    if isinstance(dirac, WilsonDirac) and dirac.csw != 0.0 and packable:
        d = dirac
        u_eo = d.packed_links(up)
        u_e, u_o = u_eo
        a_e, ainv_o = d.clover_packed_blocks(up)
        b_e = _each(lambda f: eo_pack.pack(f, lattice, 0), b)
        b_o = _each(lambda f: eo_pack.pack(f, lattice, 1), b)
        dhat_dag = lambda v: d.apply_dhat_clover_dagger(u_eo, a_e, ainv_o, v)  # noqa: E731
        hop_eo = _each(lambda v: d.hop_packed(u_e, u_o, d.site_apply(ainv_o, v), 0), b_o)
        rhs_e = _each(dhat_dag, b_e + d.kappa * hop_eo)
        x_e = solve(lambda v: dhat_dag(d.apply_dhat_clover(u_eo, a_e, ainv_o, v)), rhs_e)
        hop_oe = _each(lambda v: d.hop_packed(u_o, u_e, v, 1), x_e)
        x_o = d.site_apply(ainv_o, b_o + d.kappa * hop_oe)
        return (_each(lambda v: eo_pack.unpack(v, lattice, 0), x_e)
                + _each(lambda v: eo_pack.unpack(v, lattice, 1), x_o))
    if isinstance(dirac, WilsonDirac) and dirac.csw == 0.0 and packable:
        d = dirac
        u_eo = d.packed_links(up)
        u_e, u_o = u_eo
        b_e = _each(lambda f: eo_pack.pack(f, lattice, 0), b)
        b_o = _each(lambda f: eo_pack.pack(f, lattice, 1), b)
        rhs_e = _each(lambda v: d.apply_dhat_dagger(u_eo, v),
                      b_e + d.kappa * _each(lambda v: d.hop_packed(u_e, u_o, v, 0), b_o))
        x_e = solve(lambda v: d.apply_dhat_dagger(u_eo, d.apply_dhat(u_eo, v)), rhs_e)
        x_o = b_o + d.kappa * _each(lambda v: d.hop_packed(u_o, u_e, v, 1), x_e)
        return (_each(lambda v: eo_pack.unpack(v, lattice, 0), x_e)
                + _each(lambda v: eo_pack.unpack(v, lattice, 1), x_o))
    d_dag, ddag_d = _full_ops(dirac, up)
    return solve(ddag_d, _each(d_dag, b))


def _full_ops(dirac, up):
    """(D^dag, D^dag D) of a 4D operator on the links ``up``; a clover term is
    built here once for every application."""
    if isinstance(dirac, WilsonDirac):
        clover = dirac.clover(up)
        return ((lambda v: dirac.apply_dagger(up, v, clover)),
                (lambda v: dirac.apply_ddag_d(up, v, clover)))
    return (lambda v: dirac.apply_dagger(up, v)), (lambda v: dirac.apply_ddag_d(up, v))


@torch.no_grad()
def _dw_effective_propagator_multi(dirac: DomainwallDirac, up, b4, eps, maxiter,
                                   log: Optional[list] = None, force_mode: Optional[str] = None):
    """The 4D effective quark propagator of the domain-wall operator on a stack
    of 4D sources b4 (n, X, Y, Z, T, 4, NC): q_i = P- X_0 + P+ X_{L5-1} with
    D_dw(m) X = B, B_0 = P+ b, B_{L5-1} = P- b (the quarks live on the walls).
    Every extent even: the packed 5D Schur system, Shat x_e = b_e - B_eo A^-1 b_o
    by CG on Shat^dag Shat and x_o = A^-1 (b_o - B_oe x_e); otherwise
    full-volume CGNE on D^dag D."""
    lattice = tuple(up.shape[1:5])
    d = dirac
    zero = torch.zeros_like(b4)
    b5 = torch.zeros((b4.shape[0], d.l5) + tuple(b4.shape[1:]), dtype=b4.dtype, device=b4.device)
    b5[:, 0] = chiral_join(b4, zero)
    b5[:, d.l5 - 1] = chiral_join(zero, b4)
    solve = lambda op, rhs: solvers.cg_multi_auto(  # noqa: E731
        op, rhs, eps=eps, maxiter=maxiter, force_mode=force_mode, log=log)[0]
    if eo_pack.packable(lattice):
        ueo = d.packed_links(up)
        u_e, u_o = ueo
        b_e = _each(lambda f: d.pack5(f, lattice, 0), b5)
        b_o = _each(lambda f: d.pack5(f, lattice, 1), b5)
        rhs_e = b_e - _each(lambda v: d._packed_hop(u_e, u_o, d.apply_a_inv(v), 0), b_o)
        x_e = solve(lambda v: d.apply_schur_ddag_d(ueo, v),
                    _each(lambda v: d.apply_schur_dagger(ueo, v), rhs_e))
        x_o = _each(d.apply_a_inv, b_o - _each(lambda v: d._packed_hop(u_o, u_e, v, 1), x_e))
        x5 = (_each(lambda v: d.unpack5(v, lattice, 0), x_e)
              + _each(lambda v: d.unpack5(v, lattice, 1), x_o))
    else:
        x5 = solve(lambda v: d.apply_ddag_d(up, v), _each(lambda f: d.apply_dagger(up, f), b5))
    return chiral_join(x5[:, d.l5 - 1], x5[:, 0])


def _solve_dinv(dirac, up, b, eps, maxiter):
    """Single-RHS D x = b (the batched path with n = 1)."""
    return _solve_dinv_multi(dirac, up, b[None], eps, maxiter)[0]


def _nspin(dirac) -> int:
    return 1 if isinstance(dirac, StaggeredDirac) else 4


def _propagate(dirac, up, b, eps, maxiter, deflate_k, log, force_mode):
    """D^-1 b for a stack of 4D sources: the domain-wall effective propagator,
    or the solve of the 4D operator itself."""
    if isinstance(dirac, DomainwallDirac):
        return _dw_effective_propagator_multi(dirac, up, b, eps, maxiter, log=log,
                                              force_mode=force_mode)
    return _solve_dinv_multi(dirac, up, b, eps, maxiter, deflate_k, log=log, force_mode=force_mode)


def chiral_condensate(u, dirac, generator: Optional[torch.Generator] = None, nr: int = 10,
                      nf_factor: float = 1.0, eps: float = 1e-19, maxiter: int = 3000,
                      deflate_k: int = 0, draws=None, log: Optional[list] = None,
                      force_mode: Optional[str] = None):
    """Returns (pbp, per-noise list). The nr Z4 noise vectors come from
    ``generator``, or from ``draws``: integers 0..3 of shape (nr, *lattice,
    [4,] NC), noise i^k. deflate_k > 0 (staggered even-odd path only) seeds
    the batched CG with a k-lowest-Ritz-mode guess; results are the same
    either way."""
    up = apply_boundary_phases(u, dirac.bc)
    lattice = tuple(u.shape[1:5])
    nv = mesh.global_volume(lattice)
    r = torch.stack([
        z4_spinor(lattice, u.shape[-1], nspin=_nspin(dirac), dtype=u.dtype, device=u.device,
                  generator=generator, draws=None if draws is None else draws[i])
        for i in range(nr)])
    p = _propagate(dirac, up, r, eps, maxiter, deflate_k, log, force_mode)
    per_noise = global_sum(torch.real(torch.sum(r.conj() * p, dim=tuple(range(1, r.ndim)))))
    per_noise = per_noise.double().cpu().numpy()
    vals = [float(v) / nv for v in per_noise]
    pbp = float(np.sum(per_noise)) / nr / nv * nf_factor
    return pbp, vals


@torch.no_grad()
def dirac_low_spectrum(u, dirac, k: int = 8, m: Optional[int] = None, v0=None):
    """Ritz estimates of the k lowest eigenvalues (ascending float64 numpy)
    of the Hermitian positive semi-definite operator behind the measurement
    solves: the packed even-odd W = m^2 - Dslash^2 for staggered with every
    extent even and m != 0, else D^dag D (for domain wall the full-volume 5D
    D^dag D). After m Lanczos steps (default max(6k, 48)) the Ritz values
    approach the spectrum from inside.

    The start vector is a unit Gaussian field on the full lattice (masked
    to even sites and packed for W; for domain wall one 4D field per slice
    s, seeded with SPECTRUM_SEED + s): ``v0`` if given, else drawn from a
    Generator seeded with SPECTRUM_SEED."""
    if m is None:
        m = max(6 * k, 48)
    up = apply_boundary_phases(u, dirac.bc)
    lattice = tuple(u.shape[1:5])
    if v0 is None:
        def start(seed):
            return gaussian_spinor(lattice, u.shape[-1], nspin=_nspin(dirac), dtype=u.dtype,
                                   device=u.device,
                                   generator=torch.Generator(device=u.device).manual_seed(seed))

        if isinstance(dirac, DomainwallDirac):  # one 4D start vector per slice s
            v0 = torch.stack([start(SPECTRUM_SEED + s) for s in range(dirac.l5)])
        else:
            v0 = start(SPECTRUM_SEED)
    if isinstance(dirac, StaggeredDirac) and dirac.mass != 0.0 and eo_pack.packable(lattice):
        ueo = dirac.packed_links(up)
        vals, _ = eigen.ritz_pairs_low(lambda v: dirac.apply_w_packed(ueo, v),
                                       dirac.pack(dirac.even_part(v0), 0), int(m), int(k))
    else:
        vals, _ = eigen.ritz_pairs_low(_full_ops(dirac, up)[1], v0, int(m), int(k))
    return np.sort(vals.cpu().numpy().astype(np.float64))


def pion_correlator(u, dirac, eps: float = 1e-19, maxiter: int = 3000, deflate_k: int = 0,
                    log: Optional[list] = None, force_mode: Optional[str] = None):
    """C_pi(t) (float64 numpy) from the NC * Nspinor point-source
    propagators at the origin, solved as one batch. Under a process grid the
    source is set on the rank that holds the global origin, each rank's block of
    C(t) lands at its global t, and the sum over ranks gives every rank the same
    global C(t)."""
    up = apply_boundary_phases(u, dirac.bc)
    lattice = tuple(u.shape[1:5])
    nc = u.shape[-1]
    nspin = _nspin(dirac)
    grid = mesh.sharded()
    source = grid is None or not any(grid.origin)
    if nspin == 1:
        b = torch.zeros((nc,) + lattice + (nc,), dtype=u.dtype, device=u.device)
        for ic in range(nc if source else 0):
            b[ic, 0, 0, 0, 0, ic] = 1.0
    else:
        b = torch.zeros((nspin * nc,) + lattice + (nspin, nc), dtype=u.dtype, device=u.device)
        for ic in range(nc if source else 0):
            for isp in range(nspin):
                b[ic * nspin + isp, 0, 0, 0, 0, isp, ic] = 1.0
    prop = _propagate(dirac, up, b, eps, maxiter, deflate_k, log, force_mode)
    mag2 = torch.abs(prop) ** 2
    axes = (0, 1, 2, 3) + tuple(range(5, mag2.ndim))
    c = torch.sum(mag2, dim=axes)
    if grid is not None:
        t0, lt = grid.origin[3], lattice[3]
        c = global_sum(torch.cat([c.new_zeros(t0), c, c.new_zeros(grid.lattice[3] - t0 - lt)]))
    return c.double().cpu().numpy()
