"""SU(N) heatbath and overrelaxation through SU(2) subgroups.

Counterpart of latticeqcd_tpu/updates/heatbath.py. Each link is updated
through its N(N-1)/2 SU(2) subgroups: the heatbath draws a0 with the
Kennedy-Pendleton proposal (Creutz's direct inversion where alpha < 2)
and a uniform direction on S^2; the overrelaxation reflects the subgroup
block microcanonically. Sites of one colour share no staple link, so each
(mu, colour, subgroup) update runs over the whole lattice under the
colour's mask: the even-odd checkerboard for the plaquette action on an
even lattice, else a per-axis colouring (one colour per site when a
plaquette-action lattice has an odd extent).

The JAX package's choices are kept: a site whose tries are all rejected
keeps its link (a lazy Gibbs step), the draws are taken in the links'
real type, and at most min(ITERATION_MAX, 48) tries are made. The port
stops the tries once every masked site is done, checking every
_CHECK_EVERY tries; with the same uniforms that gives the fixed loop's a0
exactly, since later tries change nothing.

The uniforms come from a ``Uniforms`` source, consumed per mu, per
colour, per subgroup: the tries' (r1, r2, r3, r4), then (ct, phi) of the
direction. ``GeneratorUniforms`` draws them from a torch.Generator; a test
can inject its own (the JAX package's key schedule replayed, or numpy
draws).

Under a process grid (parallel/mesh.py) the links are this rank's block:
the staples come from sharded rolls, the colours are the global
lattice's masks with the block kept (an improved action's per-axis
modulus divides the global extent, not always the block's origin), the
generator's uniforms are the global field's with the block kept, the
early stop asks whether every site of every rank is done (one
all-reduce per check, so that every rank draws as many uniforms as one
process), and sweep_diag's counts are global. The sweeps with
coefficients (SLMC's) run there the same way, with the global lattice's
colouring for the largest extent over the basis.

With a coupling ``basis`` (a tuple of unit-coupling GaugeActions, as SLMC
gives it), ``sweep_with_coeffs`` and ``overrelax_with_coeffs`` update
under the action sum_i coeffs[i] basis[i]: the staple is
sum_i coeffs[i] staples(basis[i]) and the colouring follows the largest
extent over the basis. Everything else is the plain sweep's.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Protocol, Tuple

import numpy as np
import torch

from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun
from latticeqcd_torch.parallel import mesh

DIRS = 4
# Below this alpha Creutz's inversion replaces the KP proposal per site: both
# keep the per-try acceptance above ~0.3 on their side (the JAX package's
# measured choice).
_KP_CREUTZ_SWITCH = 2.0
_MAX_TRIES = 48
_TINY = 1e-30
_CHECK_EVERY = 4


def _color_moduli_ext(ext: int, lattice) -> tuple:
    """Per-axis colouring modulus: the smallest m > extent with m | L (else L)."""
    if ext == 1:
        return (2, 2, 2, 2) if all(l % 2 == 0 for l in lattice) else tuple(lattice)
    moduli = []
    for l in lattice:
        m = next((c for c in range(ext + 1, l + 1) if l % c == 0), None)
        moduli.append(m if m is not None else l)
    return tuple(moduli)


@functools.lru_cache(maxsize=16)
def _parity_masks(lattice, moduli, plaquette_eo: bool) -> np.ndarray:
    """Boolean site masks [ncolour, X, Y, Z, T]: one masked update per colour."""
    grids = np.meshgrid(*(np.arange(l) for l in lattice), indexing="ij")
    if plaquette_eo:
        par = sum(grids) % 2
        return np.stack([par == p for p in (0, 1)])
    masks = []
    for color in itertools.product(*(range(m) for m in moduli)):
        m = np.ones(lattice, dtype=bool)
        for g, c, mod in zip(grids, color, moduli):
            m &= (g % mod) == c
        masks.append(m)
    return np.stack(masks)


def color_masks_ext(max_ext: int, lattice) -> np.ndarray:
    """The colour masks of a sweep whose loops reach ``max_ext`` sites away:
    the even-odd checkerboard at extent 1 on an even lattice, else the
    per-axis colouring."""
    lattice = tuple(lattice)
    plaq_eo = max_ext == 1 and all(l % 2 == 0 for l in lattice)
    return _parity_masks(lattice, _color_moduli_ext(max_ext, lattice), plaq_eo)


def color_masks(action: ga.GaugeAction, lattice) -> np.ndarray:
    """The colour masks a sweep of ``action`` uses on ``lattice``."""
    return color_masks_ext(action.max_extent(), lattice)


# --------------------------------------------------------------------------
# SU(2) quaternion helpers
# --------------------------------------------------------------------------


def _block(m, i, j):
    """The 2x2 subgroup block [[m_ii, m_ij], [m_ji, m_jj]]."""
    return m[..., i, i], m[..., i, j], m[..., j, i], m[..., j, j]


def _quat_of_block(s11, s12, s21, s22):
    """x with Re tr(V S) = 2 (v0 x0 + v.x) for V = v0 + i v.sigma."""
    x0 = 0.5 * (s11.real + s22.real)
    x1 = -0.5 * (s12.imag + s21.imag)
    x2 = -0.5 * (s12.real - s21.real)
    x3 = -0.5 * (s11.imag - s22.imag)
    return x0, x1, x2, x3


def _su2_from_quat(w0, w1, w2, w3, dtype):
    """V = w0 + i w.sigma as a 2x2 complex matrix (..., 2, 2)."""
    row0 = torch.stack([torch.complex(w0, w3), torch.complex(w2, w1)], dim=-1)
    row1 = torch.stack([torch.complex(-w2, w1), torch.complex(w0, -w3)], dim=-1)
    return torch.stack([row0, row1], dim=-2).to(dtype)


# --------------------------------------------------------------------------
# Uniforms
# --------------------------------------------------------------------------


class Uniforms(Protocol):
    """A sweep's uniforms. ``tries`` starts one (mu, colour, subgroup) update
    and yields its tries' (r1, r2, r3, r4): r1, r3 in [1e-30, 1), r2, r4 in
    [0, 1). ``direction`` then gives its (ct, phi): ct in [-1, 1), phi in
    [0, 2 pi). All of shape ``shape`` in the real type ``dtype``. Under a
    process grid ``shape`` is this rank's block; a source may hand over the
    global field's arrays instead, and the sweep keeps the block of them."""

    def tries(self, shape, dtype, device) -> Iterator[Tuple[torch.Tensor, ...]]: ...

    def direction(self, shape, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]: ...


@dataclass
class GeneratorUniforms:
    """Uniforms from a torch.Generator on the links' device; under a process grid the
    global field's uniforms, this rank's block kept (mesh.rand_block), so that every
    rank draws what one process draws."""

    generator: Optional[torch.Generator]

    def _rand(self, shape, dtype, device):
        return mesh.rand_block(shape, 0, self.generator, dtype, device)

    def tries(self, shape, dtype, device):
        while True:
            yield (self._rand(shape, dtype, device).clamp_min_(_TINY),
                   self._rand(shape, dtype, device),
                   self._rand(shape, dtype, device).clamp_min_(_TINY),
                   self._rand(shape, dtype, device))

    def direction(self, shape, dtype, device):
        ct = self._rand(shape, dtype, device) * 2.0 - 1.0
        phi = self._rand(shape, dtype, device) * (2 * math.pi)
        return ct, phi


@dataclass
class _BlockUniforms:
    """An injected source under a process grid: the global field's arrays it hands
    over are cut to this rank's block (a source that draws blocks already, as
    GeneratorUniforms does, passes through)."""

    source: "Uniforms"
    shape: tuple
    grid: mesh.ProcessGrid

    def _keep(self, t):
        return t if tuple(t.shape) == self.shape else self.grid.block(t).contiguous()

    def tries(self, shape, dtype, device):
        for parts in self.source.tries(shape, dtype, device):
            yield tuple(self._keep(t) for t in parts)

    def direction(self, shape, dtype, device):
        return tuple(self._keep(t) for t in self.source.direction(shape, dtype, device))


def _kp_sample_a0(alpha, mask, iteration_max, tries):
    """a0 in [-1, 1] with density ~ sqrt(1 - a0^2) exp(alpha a0) on the masked
    sites: Kennedy-Pendleton for alpha >= _KP_CREUTZ_SWITCH, Creutz's inversion
    below it, both from the same four uniforms per try. Returns (a0, done);
    a masked site with done False exhausted its tries and must keep its link."""
    alpha = torch.clamp_min(alpha, _TINY)
    small = alpha < _KP_CREUTZ_SWITCH
    em = torch.expm1(-2.0 * alpha)
    done = ~mask
    a0 = torch.ones_like(alpha)
    for it, (r1, r2, r3, r4) in zip(range(int(min(iteration_max, _MAX_TRIES))), tries):
        c = torch.cos(2 * math.pi * r2)
        delta = -(torch.log(r1) + c * c * torch.log(r3)) / alpha
        r44 = r4 * r4
        acc_kp = r44 <= (1.0 - 0.5 * delta)
        a0_c = 1.0 + torch.log1p(r1 * em) / alpha
        acc_c = r44 <= (1.0 - a0_c * a0_c)
        accept = torch.where(small, acc_c, acc_kp)
        a0 = torch.where(accept & ~done, torch.where(small, a0_c, 1.0 - delta), a0)
        done = done | accept
        # under a process grid every rank stops at the same try, so that the ranks
        # draw as many global uniforms as one process
        if (it + 1) % _CHECK_EVERY == 0 and mesh.global_all(bool(done.all())):
            break
    return torch.clamp(a0, -1.0, 1.0), done


def _random_unit3(ct, phi):
    """The point (ct, phi) on S^2 in Cartesian components."""
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    return st * torch.cos(phi), st * torch.sin(phi), ct


def _embed_apply(u_mu, v2, i, j, mask):
    """U' = V_emb U on the masked sites; V_emb is the identity outside rows i, j."""
    row_i = v2[..., 0, 0, None] * u_mu[..., i, :] + v2[..., 0, 1, None] * u_mu[..., j, :]
    row_j = v2[..., 1, 0, None] * u_mu[..., i, :] + v2[..., 1, 1, None] * u_mu[..., j, :]
    m = mask[..., None]
    out = u_mu.clone()
    out[..., i, :] = torch.where(m, row_i, u_mu[..., i, :])
    out[..., j, :] = torch.where(m, row_j, u_mu[..., j, :])
    return out


@dataclass(frozen=True)
class Heatbath:
    """Heatbath updater for a quenched gauge action: ``sweep`` is one heatbath
    sweep, ``overrelax`` one overrelaxation sweep, ``update`` a sweep followed
    by num_or overrelaxations when use_or, and ``step`` the port's updater
    protocol around ``update`` (always accepted). ``basis`` (unit-coupling
    actions) serves the ``*_with_coeffs`` sweeps of SLMC."""

    action: ga.GaugeAction
    iteration_max: int = 10 ** 5
    use_or: bool = False
    num_or: int = 3
    basis: Optional[tuple] = None

    @torch.no_grad()
    def sweep(self, u, generator: Optional[torch.Generator] = None,
              uniforms: Optional[Uniforms] = None):
        return self._sweep_impl(u, uniforms or GeneratorUniforms(generator))[0]

    @torch.no_grad()
    def overrelax(self, u):
        return self._sweep_impl(u, None, or_mode=True)[0]

    @torch.no_grad()
    def sweep_with_coeffs(self, u, coeffs, generator: Optional[torch.Generator] = None,
                          uniforms: Optional[Uniforms] = None):
        """One heatbath sweep under sum_i coeffs[i] basis[i]."""
        return self._sweep_impl(u, uniforms or GeneratorUniforms(generator), coeffs=coeffs)[0]

    @torch.no_grad()
    def overrelax_with_coeffs(self, u, coeffs):
        """One overrelaxation sweep under sum_i coeffs[i] basis[i]."""
        return self._sweep_impl(u, None, or_mode=True, coeffs=coeffs)[0]

    @torch.no_grad()
    def sweep_diag(self, u, generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Uniforms] = None):
        """The sweep, and the counts of exhausted and of attempted masked
        site samples (their ratio is the skip rate)."""
        u, n_exh, n_att = self._sweep_impl(u, uniforms or GeneratorUniforms(generator),
                                           with_diag=True)
        return u, int(n_exh), int(n_att)

    def update(self, u, generator: Optional[torch.Generator] = None):
        u = self.sweep(u, generator)
        if self.use_or:
            for _ in range(self.num_or):
                u = self.overrelax(u)
        return u

    def step(self, u, generator: Optional[torch.Generator] = None):
        """(U, generator) -> (U', stats), as HMC.step; stats holds accepted only."""
        return self.update(u, generator), {"accepted": True}

    def _staple_and_extent(self, coeffs):
        """(mu, U) -> the staple of the sweep's action, and its loops' largest extent."""
        if coeffs is None:
            return (lambda uu, mu: ga.staples(self.action, uu, mu)), self.action.max_extent()
        if self.basis is None:
            raise ValueError("a sweep with coefficients needs the Heatbath's basis")

        def staple_of(uu, mu):
            v = 0.0
            for i, a in enumerate(self.basis):
                v = v + coeffs[i] * ga.staples(a, uu, mu)
            return v

        return staple_of, max(a.max_extent() for a in self.basis)

    def _sweep_impl(self, u, uniforms, or_mode: bool = False, with_diag: bool = False,
                    coeffs=None):
        nc = self.action.nc
        shape = tuple(u.shape[1:5])
        rdt = sun.real_dtype(u.dtype)
        staple_of, max_ext = self._staple_and_extent(coeffs)
        grid = mesh.sharded()
        if grid is None:
            masks = torch.from_numpy(color_masks_ext(max_ext, shape))
        else:
            # the global lattice's colours, this rank's block kept: a block origin need
            # not be a multiple of an improved action's modulus
            masks = grid.block(torch.from_numpy(color_masks_ext(max_ext, grid.lattice)), lead=1)
            if uniforms is not None:
                uniforms = _BlockUniforms(uniforms, shape, grid)
        masks = masks.to(u.device)
        subgroups = [(i, j) for i in range(nc) for j in range(i + 1, nc)]
        n_exh = n_att = torch.zeros((), dtype=torch.int64, device=u.device)
        u = u.clone()
        for mu in range(DIRS):
            for mask in masks:
                # the staple of the current links; weight exp((2/NC) Re tr(U V))
                k_mat = (2.0 / nc) * staple_of(u, mu)
                u_mu = u[mu]
                for i, j in subgroups:
                    x0, x1, x2, x3 = _quat_of_block(*_block(sun.mul(u_mu, k_mat), i, j))
                    xi = torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3)
                    xi_safe = torch.clamp_min(xi, _TINY)
                    xh = [x0 / xi_safe, x1 / xi_safe, x2 / xi_safe, x3 / xi_safe]
                    if or_mode:
                        # the microcanonical reflection A = X^2, X = quaternion(x)/|x|
                        w0 = xh[0] * xh[0] - (xh[1] * xh[1] + xh[2] * xh[2] + xh[3] * xh[3])
                        wv = [2.0 * xh[0] * xh[k] for k in (1, 2, 3)]
                        v2 = _su2_from_quat(w0, *wv, u.dtype)
                        upd = mask
                    else:
                        a0, sampled = _kp_sample_a0(2.0 * xi, mask, self.iteration_max,
                                                    uniforms.tries(shape, rdt, u.device))
                        r = torch.sqrt(torch.clamp_min(1.0 - a0 * a0, 0.0))
                        d1, d2, d3 = _random_unit3(*uniforms.direction(shape, rdt, u.device))
                        v_w = _su2_from_quat(a0, r * d1, r * d2, r * d3, u.dtype)
                        v2 = sun.mul(v_w, _su2_from_quat(*xh, u.dtype))
                        # exhausted sites keep their link (a lazy Gibbs step)
                        upd = mask & sampled
                        if with_diag:
                            n_exh = n_exh + torch.sum(mask & ~sampled)
                            n_att = n_att + torch.sum(mask)
                    u_mu = _embed_apply(u_mu, v2, i, j, upd)
                u[mu] = u_mu
        if with_diag:
            n_exh, n_att = mesh.global_sum(n_exh), mesh.global_sum(n_att)
        return u, n_exh, n_att
