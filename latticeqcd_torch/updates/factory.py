"""Updater factory: update_method -> HMC | Heatbath | Fileloading | SLHMC |
SLMC | IntegratedHMC | IntegratedHB.

Counterpart of latticeqcd_tpu/updates/factory.py: every update_method the
JAX package accepts. The integrated updaters and dynamical SLMC build the
fermion determinant densely: they refuse a Dirac matrix of dimension above
_INTEGRATED_MAX_DIM (full volume x spin x colour, as the JAX package counts
it), and any fermion action but two-flavour Wilson (clover included) and
staggered (so Hasenbusch and domain wall), each with the JAX package's
ValueError. Under a process grid every update method runs on this rank's
block; the dense log det's shape is the global lattice's (p.L), and each
log det gathers the global matrix once (updates/slhmc.py).
"""

from __future__ import annotations

import math

from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
from latticeqcd_torch.updates.fileloading import GivenConfigurations
from latticeqcd_torch.updates.heatbath import Heatbath
from latticeqcd_torch.updates.hmc import HMC
from latticeqcd_torch.updates.slhmc import (SLHMC, SLMC, dense_logdet_fermi_action,
                                            integrated_hb, integrated_hmc)


def _md_scheme(p) -> str:
    """The QPQ bool, or the explicit MDscheme ("QPQ" | "PQP" | "Omelyan")."""
    if p.MDscheme:
        if p.MDscheme not in ("QPQ", "PQP", "Omelyan"):
            raise ValueError(f"MDscheme must be 'QPQ', 'PQP' or 'Omelyan', got {p.MDscheme!r}")
        return p.MDscheme
    return "QPQ" if p.QPQ else "PQP"


def updatemethod(p, univ):
    method = p.update_method
    if method == "HMC":
        return HMC(
            action=univ.gauge_action,
            dtau=p.dtau,
            md_steps=p.MDsteps,
            scheme=_md_scheme(p),
            sexton_weingarten=p.SextonWeingargten,
            nsw=p.N_SextonWeingargten,
            omelyan_lambda=p.omelyan_lambda,
            fermi_action=univ.fermi_action,
            smearing=univ.cov_neural_net,
            md_precision=p.MDprecision,
        )
    if method == "Heatbath":
        if not p.quench:
            raise ValueError("Heatbath update is only for quench case!")
        return Heatbath(action=univ.gauge_action, iteration_max=p.ITERATION_MAX,
                        use_or=p.useOR, num_or=p.numOR)
    if method == "Fileloading":
        return GivenConfigurations.from_params(p, p.L, p.NC)
    couplinglist = tuple(p.couplinglist) if p.couplinglist else ("plaquette",)
    if method == "SLHMC":
        return SLHMC(
            action=univ.gauge_action,
            dtau=p.dtau,
            md_steps=p.MDsteps,
            fermi_action=univ.fermi_action,
            smearing=univ.cov_neural_net,
            beta_eff=p.beta_eff,
            firstlearn=p.firstlearn,
            couplinglist=couplinglist,
            lattice=p.L,
            scheme=_md_scheme(p),
            omelyan_lambda=p.omelyan_lambda,
        )
    if method == "SLMC":
        # dynamical SLMC reweights with the exact (dense) fermion action
        return SLMC(
            action=univ.gauge_action,
            beta_eff=p.beta_eff,
            firstlearn=p.firstlearn,
            couplinglist=couplinglist,
            lattice=p.L,
            fermi_logdet=_exact_logdet(p, univ),
            iteration_max=p.ITERATION_MAX,
        )
    if method == "IntegratedHMC":
        return integrated_hmc(
            univ.gauge_action,
            dtau=p.dtau,
            md_steps=p.MDsteps,
            fermi_logdet=_exact_logdet(p, univ),
            scheme=_md_scheme(p),
            omelyan_lambda=p.omelyan_lambda,
        )
    if method == "IntegratedHB":
        return integrated_hb(
            univ.gauge_action,
            fermi_logdet=_exact_logdet(p, univ),
            beta_eff=p.beta_eff,
            iteration_max=p.ITERATION_MAX,
        )
    raise ValueError(f"update_method {method!r} is not supported")


_INTEGRATED_MAX_DIM = 4608  # 4^4 Wilson = 3072; the dense log det is O(dim^3)


def _exact_logdet(p, univ):
    """U -> S_f(U) = -w log det(D^dag D), dense, or None when quenched; the field's shape
    and the cap are the global lattice's under a process grid too."""
    fa = univ.fermi_action
    if fa is None:
        return None
    lat = tuple(p.L)
    if isinstance(fa, StaggeredFermiAction):
        psi_shape = lat + (p.NC,)
        weight = fa.nf / 8.0  # det(D)^(Nf/4) = det(D^dag D)^(Nf/8)
    elif isinstance(fa, WilsonFermiAction):
        psi_shape = lat + (4, p.NC)
        weight = 1.0  # two flavours: det(D)^2 = det(D^dag D)
    else:
        raise ValueError("IntegratedHMC/IntegratedHB support Wilson/Staggered fermions only")
    dim = math.prod(psi_shape)
    if dim > _INTEGRATED_MAX_DIM:
        raise ValueError(
            f"Integrated updaters build the dense Dirac matrix (dim={dim} > "
            f"{_INTEGRATED_MAX_DIM}); use HMC/SLHMC for lattices this large"
        )
    bc = tuple(p.BoundaryCondition)
    sf = dense_logdet_fermi_action(fa.dirac, psi_shape, weight)
    return lambda u: sf(apply_boundary_phases(u, bc))
