"""Hybrid Monte Carlo updater (quenched, two-flavour Wilson, staggered Nf 1..8),
with stout-smeared fermion links and the Sexton-Weingarten integrators.

Counterpart of latticeqcd_tpu/updates/hmc.py with the semantics of its
fused trajectory (``HMC._step_fused``): refresh the momenta and the
pseudofermion, H_old = tr(H^2) + S_g + |xi|^2, integrate, H_new with the
fermion action solved on the evolved links, Metropolis
exp(-dH) >= uniform, keep the old links on reject. The fermion force
CG is warm-started from the previous MD step's solution (chronological
inverter) where the action returns one; a multi-pole staggered action
returns None and its next force starts from zero. With a smearing the
fermion action sees smear(U) wherever it is evaluated (the
pseudofermion, the force through torch.autograd, the final action),
and the gauge action the bare links.

The random numbers of one trajectory are a ``Draws``: the momentum
normals, the pseudofermion normals and the Metropolis uniform, in the
order the JAX package splits its key (k_mom, k_ferm, k_acc). They come
from a torch.Generator, or are injected, so that a test can replay the
JAX package's own draws. The JAX package's staged multi-program path
exists for its TPU runtime and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from latticeqcd_torch.md import integrators
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun


@dataclass(frozen=True)
class Draws:
    """The random numbers of one trajectory.

    mom: (re, im) normals of shape [4, X, Y, Z, T, NC, NC];
    xi: (re, im) normals of the pseudofermion noise, of the fermion
        action's noise_shape(u), or None (quenched);
    uniform: the Metropolis uniform in [0, 1)."""

    mom: tuple
    xi: Optional[tuple]
    uniform: float

    @classmethod
    def sample(cls, hmc: "HMC", u: torch.Tensor, generator: torch.Generator) -> "Draws":
        rdtype = sun.real_dtype(u.dtype)
        kw = dict(generator=generator, dtype=rdtype, device=u.device)
        shape = tuple(u.shape)
        mom = (torch.randn(shape, **kw), torch.randn(shape, **kw))
        xi = None
        if not hmc.quench:
            xshape = hmc.fermi_action.noise_shape(u)
            xi = (torch.randn(xshape, **kw), torch.randn(xshape, **kw))
        uniform = float(torch.rand((), generator=generator, dtype=rdtype, device=u.device))
        return cls(mom, xi, uniform)

    def momentum(self, u: torch.Tensor) -> torch.Tensor:
        return sun.random_hermitian_momentum(u.shape[:-2], u.shape[-1], dtype=u.dtype,
                                             device=u.device, normals=self.mom)


@dataclass(frozen=True)
class HMC:
    """Static configuration of an HMC updater."""

    action: ga.GaugeAction
    dtau: float
    md_steps: int
    scheme: str = "QPQ"
    sexton_weingarten: bool = False
    nsw: int = 2
    omelyan_lambda: float = integrators.OMELYAN_2MN_LAMBDA
    fermi_action: Optional[Any] = None
    smearing: Optional[Any] = None
    md_precision: str = "auto"

    @property
    def quench(self) -> bool:
        return self.fermi_action is None

    def _validate(self) -> None:
        if self.md_steps < 1:
            raise ValueError(f"MDsteps must be >= 1, got {self.md_steps}")
        if self.sexton_weingarten and self.quench:
            raise ValueError("The quench update does not need the SextonWeingarten method")
        if self.sexton_weingarten and self.nsw % 2 != 0:
            raise ValueError(f"Nsw must be even, got {self.nsw}")
        if self.md_precision not in ("auto", "plain", "mixed"):
            raise ValueError(f"md_precision must be auto/plain/mixed, got {self.md_precision!r}")
        if self.scheme not in ("QPQ", "PQP", "Omelyan"):
            raise ValueError(f"unknown MD scheme {self.scheme!r}")
        if self.md_precision == "mixed":
            raise NotImplementedError("mixed-precision MD is not ported yet (ROADMAP A12)")

    def _smear(self, u):
        return u if self.smearing is None else self.smearing.smear(u)

    @torch.no_grad()
    def step(self, u: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None):
        """One trajectory: (U, generator or draws) -> (U', stats).

        stats: accepted, dH and the action parts as Python numbers, the
        plaquette of the outgoing links, and ``cg``: one record per CG
        solve (solvers.cg's log)."""
        self._validate()
        if draws is None:
            draws = Draws.sample(self, u, generator)
        h = draws.momentum(u)
        cg_log: list = []

        force_fermion = None
        s_f_old = 0.0
        if not self.quench:
            fa = self.fermi_action
            s_f_old, eta = fa.sample_pseudofermion(self._smear(u), normals=draws.xi)
            smear_fn = None if self.smearing is None else self.smearing.smear
            guess = {"x": None}

            def force_fermion(uu):
                # the smearing's graph is built under the force's own enable_grad
                f, guess["x"] = fa.force_with_guess(uu, eta, guess["x"], log=cg_log,
                                                    smear_fn=smear_fn)
                return f

        force_gauge = lambda uu: ga.force(self.action, uu)
        sp_old = sun.kinetic_energy(h)
        sg_old = ga.action_value(self.action, u)
        s_old = sp_old + sg_old + s_f_old

        u_new, h_new = integrators.run_md(
            u, h, force_gauge, self.dtau, self.md_steps, force_fermion=force_fermion,
            scheme=self.scheme, sexton_weingarten=self.sexton_weingarten, nsw=self.nsw,
            omelyan_lambda=self.omelyan_lambda,
        )

        sp_new = sun.kinetic_energy(h_new)
        sg_new = ga.action_value(self.action, u_new)
        s_f_new = 0.0
        if not self.quench:
            s_f_new = torch.real(self.fermi_action.action(self._smear(u_new), eta, log=cg_log))
        d_h = sp_new + sg_new + s_f_new - s_old
        accept = bool(torch.exp(-d_h) >= draws.uniform)
        u_out = u_new if accept else u
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
            "cg": cg_log,
        }
        return u_out, stats
