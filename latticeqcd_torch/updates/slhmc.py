"""Self-learning updaters: SLHMC and SLMC, and the integrated-fermion
updaters IntegratedHMC and IntegratedHB.

Counterpart of latticeqcd_tpu/updates/slhmc.py, with the same names and
semantics:

* **SLHMC**: molecular dynamics under a learned effective gauge action
  S_eff(U) = sum_i beta_eff_i l_i(U) over a loop basis; the Metropolis
  test uses the TRUE action (gauge + pseudofermion), so the fermion
  system is solved only at the trajectory's endpoints (the pseudofermion
  and the final action), on the smeared links when a smearing is set.
  The MD under S_eff is reversible and measure-preserving, so the chain
  is exact for any S_eff; learning moves only the acceptance.
* **SLMC**: the proposal is nsweeps heatbath sweeps under S_eff (the
  Heatbath's coupling-basis sweeps), accepted with
  exp[(S_true - S_eff)(old) - (S_true - S_eff)(new)].
* **Learning**: after each step the proposal endpoint's loop values and
  true action are recorded (also when it is rejected; the start point
  once, at the first step) and the couplings refit by least squares with
  an intercept, from step ``firstlearn`` on (``SLMCLearner``).
* **IntegratedHMC / IntegratedHB**: SLHMC and SLMC with learning off and
  the exact fermion action -w log det(D^dag D), built densely
  (``dense_logdet_fermi_action``; small lattices only).

The random numbers: ``SLHMC.step`` takes a ``hmc.Draws`` (momentum
normals, pseudofermion normals, Metropolis uniform: the JAX package's
k_mom, k_ferm, k_acc) or draws one from a torch.Generator in that order;
the integrated action draws no pseudofermion, so its ``Draws.xi`` is
None. ``SLMC.step`` takes the sweeps' ``Uniforms`` and the Metropolis
uniform, or draws them from a torch.Generator: first every sweep's
uniforms, in sweep order, then the Metropolis uniform.

The learner is not in the checkpoint (as in the JAX package): a resumed
self-learning run restarts its fit from the initial beta_eff.

Under a process grid (parallel/mesh.py) the links are this rank's block:
the draws are the global lattice's (``Draws`` and the heatbath's
uniforms, this rank's block kept), the Metropolis uniform and the loop
values (global sums) are the same on every rank, so every rank's learner
fits the same history and beta_eff stays bitwise equal across ranks, and
the dense log det gathers the global matrix once.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from latticeqcd_torch.md import integrators
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
from latticeqcd_torch.ops.wilsonline import Wilsonline, make_loops_fromname
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.updates.heatbath import GeneratorUniforms, Heatbath
from latticeqcd_torch.updates.hmc import Draws, grid_refusal, noise_lead


# ---------------------------------------------------------------------------
# Effective-action loop basis
# ---------------------------------------------------------------------------


class EffectiveGaugeBasis:
    """A basis of unit-coupling gauge actions {l_i}; S_eff = coeffs . l.

    couplinglist names the loop sets (plaquette, rectangular, chair,
    polyakov_<axis>); coupling_loops may give raw paths
    [[(mu, len), ...], ...] instead, one basis element each."""

    def __init__(self, nc: int, couplinglist: Sequence[str] = ("plaquette",),
                 lattice=None, coupling_loops=None):
        self.nc = nc
        loopsets = []
        self.names = []
        if coupling_loops is not None:
            for k, path in enumerate(coupling_loops):
                loopsets.append([Wilsonline([tuple(s) for s in path])])
                self.names.append(f"loops{k}")
        else:
            for name in couplinglist:
                loopsets.append(make_loops_fromname(name, 4, lattice=lattice))
                self.names.append(name)
        # unit coupling: the physical action's beta/2 and adjoint closure, so
        # coeff == beta for a plaquette basis
        self.unit_actions = tuple(ga.general_gauge_action(nc, [1.0], [ls]) for ls in loopsets)

    @property
    def n(self) -> int:
        return len(self.unit_actions)

    def loop_values(self, u: torch.Tensor) -> torch.Tensor:
        """l_i(U) = S of the unit action i, shape (n,)."""
        return torch.stack([ga.action_value(a, u) for a in self.unit_actions])

    def action_value(self, u: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
        return torch.sum(coeffs * self.loop_values(u))

    def force(self, u: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
        """The momentum's time derivative under S_eff."""
        out = 0.0
        for i, a in enumerate(self.unit_actions):
            out = out + coeffs[i] * ga.force(a, u)
        return out


class SLMCLearner:
    """Least-squares fit S_true ~= const + beta_eff . l over the chain's history."""

    # the refit costs O(n nbasis^2) a step; old equilibration samples only
    # dilute the fit, so the history is bounded
    MAX_HISTORY = 8192

    def __init__(self, nbasis: int):
        self.nbasis = nbasis
        self.feats: list = []
        self.targets: list = []

    def record(self, feats, target) -> None:
        self.feats.append(np.asarray(feats, dtype=np.float64))
        self.targets.append(float(target))
        if len(self.targets) > self.MAX_HISTORY:
            del self.feats[0]
            del self.targets[0]

    def fit(self) -> Optional[np.ndarray]:
        """beta_eff (nbasis,), or None while underdetermined or not finite."""
        if len(self.targets) < self.nbasis + 1:
            return None
        a = np.stack(self.feats)
        # with an intercept column the slopes are determined only if the
        # centred features span the basis
        if np.linalg.matrix_rank(a - a.mean(axis=0), tol=1e-10) < self.nbasis:
            return None
        a = np.concatenate([np.ones((a.shape[0], 1)), a], axis=1)
        y = np.asarray(self.targets)
        sol, *_ = np.linalg.lstsq(a, y, rcond=None)
        betas = sol[1:]
        if not np.all(np.isfinite(betas)):
            return None
        return betas


def _initial_beta_eff(action: ga.GaugeAction, n: int, beta_eff) -> np.ndarray:
    """beta_eff padded with zeros to the basis (a scalar sets the first
    element); None takes the true action's leading coupling."""
    init = np.zeros(n)
    if beta_eff is None:
        init[0] = _leading_coupling(action)
    else:
        be = np.atleast_1d(np.asarray(beta_eff, dtype=np.float64))
        init[: be.size] = be
    return init


def _learn(up, feats_start, target_start, feats_new, target_new) -> None:
    """The learning step shared by SLHMC and SLMC (after up.itrj += 1)."""
    if up.itrj == 1:
        up.learner.record(feats_start, target_start)
    up.learner.record(feats_new, target_new)
    if up.itrj >= up.firstlearn:
        betas = up.learner.fit()
        if betas is not None:
            up.beta_eff = betas


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# SLHMC
# ---------------------------------------------------------------------------


class SLHMC:
    """Self-learning HMC: gluonic MD under the learned effective action,
    Metropolis against the true one.

    ``action`` is the TRUE gauge action, ``fermi_action`` (optional) the TRUE
    pseudofermion action; beta_eff the initial effective couplings."""

    def __init__(self, action: ga.GaugeAction, dtau: float, md_steps: int,
                 fermi_action: Optional[Any] = None, smearing: Optional[Any] = None,
                 beta_eff=None, firstlearn: int = 10,
                 couplinglist: Sequence[str] = ("plaquette",), coupling_loops=None,
                 lattice=None, scheme: str = "QPQ", omelyan_lambda: Optional[float] = None,
                 learn: bool = True):
        if scheme not in ("QPQ", "PQP", "Omelyan"):
            raise ValueError(f"unknown MD scheme {scheme!r}")
        self.action = action
        self.dtau = float(dtau)
        self.md_steps = int(md_steps)
        self.fermi_action = fermi_action
        self.smearing = smearing
        self.firstlearn = int(firstlearn)
        self.scheme = scheme
        self.omelyan_lambda = (integrators.OMELYAN_2MN_LAMBDA if omelyan_lambda is None
                               else float(omelyan_lambda))
        self.learn = learn
        self.basis = EffectiveGaugeBasis(action.nc, couplinglist, lattice=lattice,
                                         coupling_loops=coupling_loops)
        self.beta_eff = _initial_beta_eff(action, self.basis.n, beta_eff)
        self.learner = SLMCLearner(self.basis.n)
        self.itrj = 0

    @property
    def quench(self) -> bool:
        return self.fermi_action is None

    def _smear(self, u):
        return u if self.smearing is None else self.smearing.smear(u)

    @torch.no_grad()
    def step(self, u: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None):
        """One trajectory: (U, generator or draws) -> (U', stats)."""
        if not isinstance(self.fermi_action, _LogdetAsFermiAction):
            what = grid_refusal(self.fermi_action)
            if what is not None:
                mesh.refuse_under_grid(what)
        if draws is None:
            draws = Draws.sample(self, u, generator)
        grid = mesh.sharded()
        if grid is not None:
            draws = draws.block(grid, noise_lead(self.fermi_action))
        u0 = u
        h = draws.momentum(u)
        cg_log: list = []

        s_f_old = 0.0
        eta = None
        if not self.quench:
            s_f_old, eta = self.fermi_action.sample_pseudofermion(self._smear(u),
                                                                  normals=draws.xi)
        sp_old, sg_old = sun.kinetic_energy(h), ga.action_value(self.action, u)
        s_old = sp_old + sg_old + s_f_old

        # the couplings in the links' real type, as the JAX package casts them
        coeffs = torch.as_tensor(self.beta_eff, dtype=sun.real_dtype(u.dtype), device=u.device)
        u_new, h_new = integrators.run_md(u, h, lambda uu: self.basis.force(uu, coeffs),
                                          self.dtau, self.md_steps, scheme=self.scheme,
                                          omelyan_lambda=self.omelyan_lambda)

        sp_new, sg_new = sun.kinetic_energy(h_new), ga.action_value(self.action, u_new)
        s_f_new = 0.0
        if not self.quench:
            s_f_new = torch.real(self.fermi_action.action(self._smear(u_new), eta, log=cg_log))
        s_new = sp_new + sg_new + s_f_new

        d_h = s_new - s_old
        accept = bool(torch.exp(-d_h) >= draws.uniform)
        u_out = u_new if accept else u0

        self.itrj += 1
        if self.learn:
            # the PROPOSAL endpoint every trajectory (a rejected one's duplicate
            # would make the regression rank-deficient), the start point once
            feats_start = _host(self.basis.loop_values(u0)) if self.itrj == 1 else None
            _learn(self, feats_start, float(sg_old + s_f_old),
                   _host(self.basis.loop_values(u_new)), float(sg_new + s_f_new))

        stats = {
            "accepted": accept,
            "dH": float(d_h),
            "sg_old": float(sg_old),
            "sg_new": float(sg_new),
            "sp_old": float(sp_old),
            "sp_new": float(sp_new),
            "sf_old": float(s_f_old),
            "sf_new": float(s_f_new),
            "plaq": float(ga.mean_plaquette(u_out)),
            "beta_eff": tuple(float(b) for b in self.beta_eff),
            "cg": cg_log,
        }
        return u_out, stats


# ---------------------------------------------------------------------------
# SLMC
# ---------------------------------------------------------------------------


class SLMC:
    """Self-learning Monte Carlo: heatbath proposals under the learned
    effective action and a reweighting Metropolis test against the true
    action. ``fermi_logdet``, when given, is a callable U -> S_f(U), the
    exact (integrated) fermion action (``dense_logdet_fermi_action``)."""

    def __init__(self, action: ga.GaugeAction, beta_eff=None, firstlearn: int = 10,
                 couplinglist: Sequence[str] = ("plaquette",), coupling_loops=None,
                 lattice=None, fermi_logdet=None, nsweeps: int = 1,
                 iteration_max: int = 10 ** 5, learn: bool = True):
        self.action = action
        self.fermi_logdet = fermi_logdet
        self.nsweeps = int(nsweeps)
        self.firstlearn = int(firstlearn)
        self.learn = learn
        self.basis = EffectiveGaugeBasis(action.nc, couplinglist, lattice=lattice,
                                         coupling_loops=coupling_loops)
        self.beta_eff = _initial_beta_eff(action, self.basis.n, beta_eff)
        self.learner = SLMCLearner(self.basis.n)
        self.itrj = 0
        self.hb = Heatbath(action=self.basis.unit_actions[0], basis=self.basis.unit_actions,
                           iteration_max=iteration_max)

    def _values(self, u, coeffs):
        """(S_g, S_eff, loop values) of U."""
        feats = self.basis.loop_values(u)
        return ga.action_value(self.action, u), torch.sum(coeffs * feats), feats

    def _s_f(self, u):
        return self.fermi_logdet(u) if self.fermi_logdet is not None else 0.0

    @torch.no_grad()
    def step(self, u: torch.Tensor, generator: Optional[torch.Generator] = None,
             uniforms=None, uniform: Optional[float] = None):
        """nsweeps proposal sweeps and the Metropolis test: (U, generator, or
        the sweeps' uniforms and the Metropolis uniform) -> (U', stats)."""
        rdtype = sun.real_dtype(u.dtype)
        coeffs = torch.as_tensor(self.beta_eff, dtype=rdtype, device=u.device)
        sg_old, seff_old, feats_old = self._values(u, coeffs)
        sf_old = self._s_f(u)

        uniforms = uniforms or GeneratorUniforms(generator)
        u_prop = u
        for _ in range(self.nsweeps):
            u_prop = self.hb.sweep_with_coeffs(u_prop, coeffs, uniforms=uniforms)
        sg_new, seff_new, feats_new = self._values(u_prop, coeffs)
        sf_new = self._s_f(u_prop)

        d_s = (sg_new + sf_new - seff_new) - (sg_old + sf_old - seff_old)
        if uniform is None:
            uniform = float(torch.rand((), generator=generator, dtype=rdtype, device=u.device))
        accept = bool(torch.exp(-d_s) >= uniform)
        u_out = u_prop if accept else u

        self.itrj += 1
        if self.learn:
            _learn(self, _host(feats_old), float(sg_old + sf_old), _host(feats_new),
                   float(sg_new + sf_new))

        stats = {
            "accepted": accept,
            "dH": float(d_s),
            "plaq": float(ga.mean_plaquette(u_out)),
            "beta_eff": tuple(float(b) for b in self.beta_eff),
        }
        return u_out, stats


# ---------------------------------------------------------------------------
# The exact fermion action on small lattices
# ---------------------------------------------------------------------------


def _dense(apply, shape, device) -> torch.Tensor:
    """The matrix of the linear map ``apply`` on fields of the global ``shape``,
    column j = apply(e_j), in complex128. The kernels take one field, so the columns
    go one at a time: one launch each on the card. Under a process grid each rank
    applies the map to its block of e_j (one face exchange per column), keeps its
    rows of every column, and the row slabs are gathered once, so that every rank
    holds the same global matrix."""
    dim = math.prod(shape)
    grid = mesh.sharded()
    keep = (lambda f: f) if grid is None else (lambda f: grid.block(f).contiguous())
    eye = torch.eye(dim, dtype=torch.complex128, device=device)
    cols = torch.stack([apply(keep(eye[j].view(shape))) for j in range(dim)], dim=-1)
    return mesh.gather_blocks(cols).reshape(dim, dim)


def dense_logdet_fermi_action(dirac, psi_shape, weight: float):
    """A callable U -> S_f(U) = -weight log det(D^dag D), in complex128
    (links of another type are cast up first), for links that carry the
    boundary phases.

    weight: Nf/8 for staggered det(D)^(Nf/4) = det(D^dag D)^(Nf/8); 1 for
    two-flavour Wilson (det(D)^2 = det(D^dag D) by gamma5-hermiticity).
    Wilson: D^dag D from D's columns (``dirac.apply``, the wilson_window
    kernel at the operator's r, with a clover term built once per log det).
    Staggered with every extent even: D^dag D = m^2 - Dslash^2 is
    block-diagonal over the parities and both blocks have the determinant of
    W_e = m^2 - D_eo D_oe (Sylvester), so S_f = -weight 2 log det W_e, W_e
    from the columns of ``apply_w_packed`` (the staggered_w kernel) at half
    the dimension. Staggered with an odd extent: the
    full-volume D, which runs on the CPU only (ROADMAP A11).

    psi_shape is the global field's. Under a process grid the links are this
    rank's block, the operators run in their halo modes, and every rank takes
    slogdet of the same gathered matrix (``_dense``)."""
    psi_shape = tuple(psi_shape)
    lattice = psi_shape[:4]
    packed_w = isinstance(dirac, StaggeredDirac) and eo_pack.packable(lattice)

    @torch.no_grad()
    def s_f(u):
        u = u.to(torch.complex128)
        if packed_w:
            ueo = dirac.packed_links(u)
            half = (lattice[0] // 2,) + psi_shape[1:]
            w_e = _dense(lambda v: dirac.apply_w_packed(ueo, v), half, u.device)
            return -weight * 2.0 * torch.linalg.slogdet(w_e)[1]
        kw = {"clover": dirac.clover(u)} if isinstance(dirac, WilsonDirac) else {}
        d_mat = _dense(lambda v: dirac.apply(u, v, **kw), psi_shape, u.device)
        return -weight * torch.linalg.slogdet(d_mat.mH @ d_mat)[1]

    return s_f


def integrated_hmc(action: ga.GaugeAction, dtau: float, md_steps: int, fermi_logdet=None,
                   scheme: str = "QPQ", omelyan_lambda: Optional[float] = None) -> SLHMC:
    """IntegratedHMC: gauge-only MD and a Metropolis test on S_g + S_f with
    the exact fermion action (SLHMC with the effective action pinned to the
    gauge action and no learning); fermi_logdet None is the quenched case."""
    up = SLHMC(action, dtau, md_steps, scheme=scheme, omelyan_lambda=omelyan_lambda,
               learn=False)
    if fermi_logdet is not None:
        up.fermi_action = _LogdetAsFermiAction(fermi_logdet)
    return up


def integrated_hb(action: ga.GaugeAction, fermi_logdet=None, beta_eff=None, nsweeps: int = 1,
                  iteration_max: int = 10 ** 5) -> SLMC:
    """IntegratedHB: SLMC without learning, with the exact fermion action."""
    return SLMC(action, beta_eff=beta_eff, fermi_logdet=fermi_logdet, nsweeps=nsweeps,
                iteration_max=iteration_max, learn=False)


class _LogdetAsFermiAction:
    """A deterministic U -> S_f as the fermion action SLHMC.step consumes: no
    pseudofermion (no noise, an empty eta), the action ignores eta."""

    def __init__(self, fermi_logdet):
        self._sf = fermi_logdet

    def noise_shape(self, u):
        return None

    def sample_pseudofermion(self, u, generator=None, normals=None):
        return self._sf(u), ()

    def action(self, u, eta, log=None):
        return self._sf(u)


def _leading_coupling(action: ga.GaugeAction) -> float:
    """The default initial beta_eff: the true action's leading coupling."""
    if action.plaq_coeff:
        return 2.0 * action.plaq_coeff
    if action.terms:
        return 2.0 * action.terms[0][0]
    return 5.7
