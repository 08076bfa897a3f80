"""Hybrid Monte Carlo updater (quenched, two-flavour Wilson with or without the clover
term and Hasenbusch mass preconditioning, two-flavour domain wall, staggered Nf 1..8),
with stout-smeared fermion links and the Sexton-Weingarten integrators.

Counterpart of latticeqcd_tpu/updates/hmc.py with the semantics of its
fused trajectory (``HMC._step_fused``): refresh the momenta and the
pseudofermion, H_old = tr(H^2) + S_g + |xi|^2, integrate, H_new with the
fermion action solved on the evolved links, Metropolis
exp(-dH) >= uniform, keep the old links on reject. The fermion force
CG is warm-started from the previous MD step's solution (chronological
inverter) where the action returns one; a multi-pole staggered action
returns None and its next force starts from zero, and the unsplit
Hasenbusch force, which has no warm start in the JAX package either,
solves from zero. With Sexton-Weingarten, a Hasenbusch action's light
force kicks on the fermion scale and its heavy force on the fine gauge
scale, each with its own chain of warm starts. With a smearing the
fermion action sees smear(U) wherever it is evaluated (the
pseudofermion, the force through torch.autograd, the final action),
and the gauge action the bare links.

With md_precision = "mixed" the MD state (U, H) is lifted to complex128
(ops/mdpair.py) after the momenta are drawn in the production dtype, so
the trajectory starts from the plain path's H; the kinetic energies are
taken in float64 on the lifted H; every force sees the state lowered to
the production dtype, and each kick adds its increment into the
complex128 H; S_g(U_old), the pseudofermion and both fermion actions stay
in the production dtype, and the lowered U_new (or the old U) goes to the
next trajectory. "auto" and "plain" are plain arithmetic in the links'
dtype.

``step_batched`` runs n independent chains in one call (the JAX
package's vmap of its fused trajectory): links with a leading chain axis,
each chain with its own momenta, pseudofermion, solves and Metropolis
decision, so that chain i evolves as ``step`` would evolve it alone. The
gauge side (forces, action values, kinetic energies, plaquettes) and the
smearing are mapped over the chains with torch.func.vmap (the force's
autograd through the smearing runs outside it); the fermion actions take
the chain axis themselves (``*_batched``), each hop or full D one kernel
launch for all chains, and a Hasenbusch action's Sexton-Weingarten split
runs as in ``step``. What has no batched form yet (staggered on a lattice
with an odd extent, an action without ``*_batched`` forms) raises before
any work (ROADMAP B3c, A12.7b).

The random numbers of one trajectory are a ``Draws``: the momentum
normals, the pseudofermion normals and the Metropolis uniform, in the
order the JAX package splits its key (k_mom, k_ferm, k_acc). They come
from a torch.Generator, or are injected, so that a test can replay the
JAX package's own draws. The JAX package's staged multi-program path
exists for its TPU runtime and has no counterpart here.

Under a process grid (parallel/mesh.py) ``step`` takes this rank's block
of the links. Quenched HMC, two-flavour Wilson HMC (at any r, with or
without the clover term, with or without Hasenbusch and its
Sexton-Weingarten split), two-flavour domain-wall HMC and
staggered HMC/RHMC, each with or without stout smearing (its staples
through the sharded rolls, whose backward carries the force's chain
rule across the faces), run there; every other action raises before any
draw (ROADMAP A14b), and so does ``step_batched``. The draws are those
of the global lattice: every rank draws the global normals from the
run's generator, which has the same seed on every rank, and keeps its
block, so a sharded trajectory draws what one process draws (at 16^3 x
32 complex64 about 44 MB of normals per trajectory on every rank). Injected draws are global arrays, sliced the
same way; the fermion action says where its noise's lattice axes start
(``noise_lead``: after the staggered pseudofermion axis, the Hasenbusch
noises' axis and the domain-wall fifth axis). The Metropolis
uniform, and the dH it is compared with (global sums, bitwise the same
on every rank), agree everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from latticeqcd_torch.md import integrators
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import mdpair, sun
from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                 HasenbuschWilsonFermiAction,
                                                 StaggeredFermiAction, WilsonFermiAction)
from latticeqcd_torch.parallel import mesh


@dataclass(frozen=True)
class Draws:
    """The random numbers of one trajectory.

    mom: (re, im) normals of shape [4, X, Y, Z, T, NC, NC];
    xi: (re, im) normals of the pseudofermion noise, of the fermion
        action's noise_shape(u) (the Hasenbusch action's leading axis
        holds its two noises), or None (quenched, or an action that
        draws none);
    uniform: the Metropolis uniform in [0, 1).
    Under a process grid the normals are the global lattice's."""

    mom: tuple
    xi: Optional[tuple]
    uniform: float

    @classmethod
    def sample(cls, hmc: "HMC", u: torch.Tensor, generator: torch.Generator) -> "Draws":
        rdtype = sun.real_dtype(u.dtype)
        kw = dict(generator=generator, dtype=rdtype, device=u.device)
        grid = mesh.sharded()
        shape = tuple(u.shape) if grid is None else grid.global_shape(u.shape, lead=1)
        mom = (torch.randn(shape, **kw), torch.randn(shape, **kw))
        xi = None
        xshape = None if hmc.quench else hmc.fermi_action.noise_shape(u)
        if xshape is not None:  # None: an action without noise (the integrated log det)
            if grid is not None:
                xshape = grid.global_shape(xshape, lead=noise_lead(hmc.fermi_action))
            xi = (torch.randn(xshape, **kw), torch.randn(xshape, **kw))
        uniform = float(torch.rand((), generator=generator, dtype=rdtype, device=u.device))
        return cls(mom, xi, uniform)

    def momentum(self, u: torch.Tensor) -> torch.Tensor:
        return sun.random_hermitian_momentum(u.shape[:-2], u.shape[-1], dtype=u.dtype,
                                             device=u.device, normals=self.mom)

    def block(self, grid, xi_lead: int = 0) -> "Draws":
        """This rank's block of global draws; the pseudofermion noise's lattice axes
        start at ``xi_lead`` (the fermion action's noise_lead)."""
        return Draws(tuple(grid.block(m, lead=1).contiguous() for m in self.mom),
                     None if self.xi is None else tuple(grid.block(x, lead=xi_lead).contiguous()
                                                        for x in self.xi), self.uniform)


def noise_lead(fermi_action) -> int:
    """Where the lattice axes of the action's noise start (after a pseudofermion or
    fifth axis): the action says, through its noise_lead."""
    return getattr(fermi_action, "noise_lead", 0)


def grid_refusal(fermi_action) -> Optional[str]:
    """What of an HMC has no multi-process form yet (ROADMAP A14b), or None: the slice
    that runs on a process grid is quenched HMC, two-flavour Wilson HMC at any r
    (clover-improved or not, with or without Hasenbusch), two-flavour domain-wall HMC
    and staggered HMC/RHMC, each with or without stout smearing."""
    if fermi_action is None or type(fermi_action) in (
            StaggeredFermiAction, WilsonFermiAction, HasenbuschWilsonFermiAction,
            DomainwallFermiAction):
        return None
    return f"the fermion action {type(fermi_action).__name__}"


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
        what = grid_refusal(self.fermi_action)
        if what is not None:
            mesh.refuse_under_grid(what)

    def _smear(self, u):
        return u if self.smearing is None else self.smearing.smear(u)

    def _md_state(self, u, h):
        """The MD state (U, H): lifted to complex128 in mixed mode."""
        return (mdpair.lift(u), mdpair.lift(h)) if self.md_precision == "mixed" else (u, h)

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
        grid = mesh.sharded()
        if grid is not None:
            draws = draws.block(grid, noise_lead(self.fermi_action))
        h = draws.momentum(u)
        cg_log: list = []
        # every force sees the MD state in the production dtype
        view = lambda uu: uu.to(u.dtype)  # noqa: E731

        force_fermion = force_fine = None
        s_f_old = 0.0
        if not self.quench:
            fa = self.fermi_action
            s_f_old, eta = fa.sample_pseudofermion(self._smear(u), normals=draws.xi)
            smear_fn = None if self.smearing is None else self.smearing.smear

            def chained(force_with_guess):
                """A force whose CG starts from its previous solution (each
                timescale threads its own chain); the smearing's graph is built
                under the force's own enable_grad."""
                guess = {"x": None}

                def force(uu):
                    f, guess["x"] = force_with_guess(view(uu), eta, guess["x"], log=cg_log,
                                                     smear_fn=smear_fn)
                    return f

                return force

            if self.sexton_weingarten and hasattr(fa, "force_heavy"):
                # Hasenbusch split: the light (ratio) force on the coarse scale, the
                # heavy one on the fine gauge scale
                force_fermion = chained(fa.force_light_with_guess)
                force_fine = chained(fa.force_heavy_with_guess)
            elif hasattr(fa, "force_with_guess"):
                force_fermion = chained(fa.force_with_guess)
            else:
                def force_fermion(uu):
                    return fa.force(view(uu), eta, log=cg_log, smear_fn=smear_fn)

        force_gauge = lambda uu: ga.force(self.action, view(uu))  # noqa: E731
        u_md, h_md = self._md_state(u, h)
        sp_old = sun.kinetic_energy(h_md)
        sg_old = ga.action_value(self.action, u)
        s_old = sp_old + sg_old + s_f_old

        u_new, h_new = integrators.run_md(
            u_md, h_md, force_gauge, self.dtau, self.md_steps, force_fermion=force_fermion,
            scheme=self.scheme, sexton_weingarten=self.sexton_weingarten, nsw=self.nsw,
            omelyan_lambda=self.omelyan_lambda, force_fine=force_fine,
        )

        sp_new = sun.kinetic_energy(h_new)
        u_new = view(u_new)
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

    # ------------------------------------------------ independent chains
    def _unbatched(self, lattice) -> Optional[str]:
        """What step_batched has no batched form of yet, or None: a fermion action
        without batched forms (ROADMAP A12.7b), or one whose batched_refusal names
        the lattice (staggered with an odd extent, ROADMAP B3c)."""
        fa = self.fermi_action
        if fa is None:
            return None
        if not hasattr(fa, "sample_pseudofermion_batched"):
            return f"the fermion action {type(fa).__name__} (ROADMAP A12.7b)"
        refusal = getattr(fa, "batched_refusal", None)
        return None if refusal is None else refusal(lattice)

    @torch.no_grad()
    def step_batched(self, us: torch.Tensor, generators=None, draws=None):
        """n independent trajectories in one call: (us [n, 4, X, Y, Z, T, NC, NC],
        n generators or n Draws) -> (us', stats).

        Chain i evolves as step(us[i], generators[i]) would alone, up to the
        rounding of batched sums: the draws of each chain in step's order, its
        own solves (a chain whose residual meets its target is frozen while the
        others run) and its own Metropolis decision. Each entry of stats but
        ``cg`` is a CPU tensor with a leading chain axis; ``cg`` holds one record
        per batched solve, with ``rhs`` the number of chains."""
        mesh.refuse_under_grid("HMC.step_batched")
        self._validate()
        if us.ndim != 8:
            raise ValueError(f"us must be [nchain, 4, X, Y, Z, T, NC, NC], got shape "
                             f"{tuple(us.shape)}")
        what = self._unbatched(tuple(us.shape[2:6]))
        if what is not None:
            raise NotImplementedError(f"step_batched: {what} has no batched form yet; "
                                      "run step per chain")
        n = us.shape[0]
        if draws is None:
            if generators is None or len(generators) != n:
                raise ValueError(f"step_batched needs {n} generators or {n} draws")
            draws = [Draws.sample(self, us[i], generators[i]) for i in range(n)]
        if len(draws) != n:
            raise ValueError(f"step_batched needs {n} draws, got {len(draws)}")
        stack = lambda parts: tuple(torch.stack(p) for p in zip(*parts))  # noqa: E731
        h = sun.random_hermitian_momentum(us.shape[:-2], us.shape[-1], dtype=us.dtype,
                                          device=us.device, normals=stack(d.mom for d in draws))
        cg_log: list = []
        view = lambda uu: uu.to(us.dtype)  # noqa: E731
        chains = torch.func.vmap
        smear_fn = None if self.smearing is None else chains(self.smearing.smear)
        smeared = (lambda uu: uu) if smear_fn is None else smear_fn  # noqa: E731

        force_fermion = force_fine = None
        s_f_old = torch.zeros((n,), dtype=us.real.dtype, device=us.device)
        if not self.quench:
            fa = self.fermi_action
            s_f_old, eta = fa.sample_pseudofermion_batched(smeared(us),
                                                           stack(d.xi for d in draws))

            def chained(force_with_guess):
                """A batched force whose CG starts from its previous solutions."""
                guess = {"x": None}

                def force(uu):
                    f, guess["x"] = force_with_guess(view(uu), eta, guess["x"], log=cg_log,
                                                     smear_fn=smear_fn)
                    return f

                return force

            if self.sexton_weingarten and hasattr(fa, "force_heavy"):
                # the Hasenbusch split, as in step
                force_fermion = chained(fa.force_light_batched_with_guess)
                force_fine = chained(fa.force_heavy_batched_with_guess)
            else:
                force_fermion = chained(fa.force_batched_with_guess)

        gauge_force = chains(lambda u: ga.force(self.action, u))
        action_value = chains(lambda u: ga.action_value(self.action, u))
        kinetic = chains(sun.kinetic_energy)
        force_gauge = lambda uu: gauge_force(view(uu))  # noqa: E731
        u_md, h_md = self._md_state(us, h)
        sp_old = kinetic(h_md)
        sg_old = action_value(us)
        s_old = sp_old + sg_old + s_f_old

        u_new, h_new = integrators.run_md(
            u_md, h_md, force_gauge, self.dtau, self.md_steps, force_fermion=force_fermion,
            scheme=self.scheme, sexton_weingarten=self.sexton_weingarten, nsw=self.nsw,
            omelyan_lambda=self.omelyan_lambda, force_fine=force_fine,
        )

        sp_new = kinetic(h_new)
        u_new = view(u_new)
        sg_new = action_value(u_new)
        s_f_new = torch.zeros_like(s_f_old)
        if not self.quench:
            s_f_new = self.fermi_action.action_batched(smeared(u_new), eta, log=cg_log)
        d_h = sp_new + sg_new + s_f_new - s_old
        uniform = torch.tensor([d.uniform for d in draws], dtype=d_h.dtype, device=d_h.device)
        accept = torch.exp(-d_h) >= uniform
        u_out = torch.where(accept.reshape((n,) + (1,) * 7), u_new, us)
        host = lambda t: t.detach().to("cpu", torch.float64)  # noqa: E731
        stats = {
            "accepted": accept.cpu(),
            "dH": host(d_h),
            "sg_old": host(sg_old),
            "sg_new": host(sg_new),
            "sp_old": host(sp_old),
            "sp_new": host(sp_new),
            "sf_old": host(s_f_old),
            "sf_new": host(s_f_new),
            "plaq": host(chains(ga.mean_plaquette)(u_out)),
            "cg": cg_log,
        }
        return u_out, stats
