"""Simulation state assembly: links, gauge action, fermion action, logger.

Counterpart of latticeqcd_tpu/system/universe.py for the ported slices:
cold, hot, one-instanton or file starts (ILDG, Bridge++ text, JLD or
NPZ), the Wilson plaquette action with any couplinglist/coupling_loops
terms, and no fermions, two-flavour Wilson fermions (clover-improved with
Dirac_operator = "WilsonClover", and with hasenbusch = true split by
Hasenbusch mass preconditioning at hasenbusch_mu), two-flavour
domain-wall fermions with their Pauli-Villars partner, or
staggered fermions with Nf = 1..8, on stout-smeared links if asked,
updated by HMC (with or without Sexton-Weingarten), (quenched) Heatbath,
the self-learning SLHMC and SLMC or the integrated-fermion IntegratedHMC
and IntegratedHB, or loaded by Fileloading, with gradient-flow
measurements. Everything else raises NotImplementedError naming the
ROADMAP item that will port it. Under a process grid (parallel/mesh.py)
the links are this rank's block (a file start reads the global file on
every rank and keeps the block): every update method runs, HMC and
SLHMC quenched, with two-flavour Wilson fermions at any r
(clover-improved or not, with or without Hasenbusch), with domain-wall
fermions or with staggered fermions, each with or without stout
smearing, and the gauge measurements and the fermionic ones on the
Wilson, clover, domain-wall and staggered operators run beside them.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import torch

from latticeqcd_torch.io import load_config
from latticeqcd_torch.measurements.scheduler import build_dirac_from_params
from latticeqcd_torch.ops import fields, gauge_action as ga
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                 HasenbuschWilsonFermiAction,
                                                 StaggeredFermiAction, WilsonFermiAction)
from latticeqcd_torch.ops.wilsonline import Wilsonline, make_loops_fromname
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.smearing.stout import CovNet, stout_stack
from latticeqcd_torch.system.params import Params
from latticeqcd_torch.utils.logger import VerbosePrint


@dataclass
class Univ:
    gauge_action: ga.GaugeAction
    u: torch.Tensor
    fermi_action: Optional[Any]  # None: quenched
    verbose_print: VerbosePrint
    cov_neural_net: Optional[CovNet]  # the fermions' stout stack, or None


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


# the operators that run under a process grid, for HMC and for the fermionic measurements
GRID_OPERATORS = ("Wilson", "WilsonClover", "Domainwall", "Staggered")


def params_grid_refusal(p: Params) -> Optional[str]:
    """What of p has no multi-process form yet (ROADMAP A14b), or None: every update
    method, HMC and SLHMC quenched or with Wilson (at any r, clover-improved or not,
    with or without Hasenbusch), domain-wall or staggered fermions, with or without
    stout smearing, and the fermionic measurements on those operators."""
    if not p.quench and p.Dirac_operator not in GRID_OPERATORS:
        return f"Dirac_operator {p.Dirac_operator!r}"
    return None


def check_supported(p: Params, device="cuda") -> None:
    """Refuse, by name, what the port does not run (on ``device``, under the
    active process grid)."""
    what = params_grid_refusal(p)
    if what is not None:
        mesh.refuse_under_grid(what)
    if (not p.quench and p.Dirac_operator == "Staggered"
            and torch.device(device).type != "cpu" and not eo_pack.packable(p.L)):
        _not_ported(f"staggered fermions on {device} with an odd lattice extent {tuple(p.L)} "
                    "(a full-volume mode of the staggered_w kernel)", "A11")
    for method in p.measurement_methods or ():  # an unknown operator raises before any trajectory
        if "fermion_parameters" in method:
            build_dirac_from_params(method["fermion_parameters"], p.L)


def build_gauge_action(p: Params) -> ga.GaugeAction:
    """The plaquette at beta/2 with adjoints, plus each couplinglist loop
    set at couplingcoeff/2 with adjoints, plus each coupling_loops loop
    (0-based (mu, length) segments) at couplingcoeff/2 with adjoints."""
    if p.use_autogeneratedstaples:
        # the reference's TOML path resets this key to false, so such a TOML runs there
        warnings.warn(
            "use_autogeneratedstaples = true is ignored (as in the reference's "
            "TOML path); use couplinglist/coupling_loops for general actions",
            stacklevel=2,
        )
    act = ga.wilson_gauge_action(p.NC, p.beta)
    if p.couplinglist:
        loopsets = [make_loops_fromname(name, 4, lattice=p.L) for name in p.couplinglist]
        for c, loops in ga.general_gauge_action(p.NC, p.couplingcoeff, loopsets).terms:
            act = act.push(c, loops)
    if p.coupling_loops is not None:
        for coeff, loopspec in zip(p.couplingcoeff, p.coupling_loops):
            loops = [Wilsonline(seg) for seg in loopspec]
            act = act.push(coeff / 2, loops + [l.adjoint() for l in loops])
    return act


def build_smearing(p: Params) -> Optional[CovNet]:
    """The fermions' stout stack: stout_numlayers layers of stout_rho (one
    value for all, or one per layer) over the stout_loops sets."""
    if p.smearing_for_fermion == "nothing":
        return None
    if p.smearing_for_fermion != "stout":
        raise ValueError(f"smearing_for_fermion {p.smearing_for_fermion!r} not supported")
    rhos = list(p.stout_rho or [0.1])
    nlayers = p.stout_numlayers or 1
    if nlayers > 1 and len(rhos) == 1:
        rhos = rhos * nlayers
    return stout_stack(rhos, loop_names=tuple(p.stout_loops or ("plaquette",)))


def build_fermi_action(p: Params):
    if p.quench or p.Dirac_operator is None:
        return None
    bc = tuple(p.BoundaryCondition)
    if p.Dirac_operator == "Staggered":
        # the lattice of the fields it acts on: the block's under a process grid
        grid = mesh.sharded()
        dirac = StaggeredDirac(mass=p.mass, lattice=tuple(p.L) if grid is None else grid.local,
                               bc=bc)
        return StaggeredFermiAction(dirac, nf=p.Nf, eps_cg=p.eps, max_cg=p.MaxCGstep)
    if p.Dirac_operator == "Domainwall":
        dirac = DomainwallDirac(
            mass=p.Domainwall_m if p.Domainwall_m is not None else 1.0,
            m5=p.Domainwall_M if p.Domainwall_M is not None else -1.0,
            l5=p.Domainwall_L5 if p.Domainwall_L5 is not None else 4,
            bc=bc,
        )
        return DomainwallFermiAction(dirac, eps_cg=p.eps, max_cg=p.MaxCGstep)
    if p.Dirac_operator in ("Wilson", "WilsonClover"):
        csw = p.Clover_coefficient if p.Dirac_operator == "WilsonClover" else 0.0
        dirac = WilsonDirac(kappa=p.hop, r=p.r, bc=bc, csw=csw)
        if p.hasenbusch:
            return HasenbuschWilsonFermiAction(dirac, mu=p.hasenbusch_mu, eps_cg=p.eps,
                                               max_cg=p.MaxCGstep)
        return WilsonFermiAction(dirac, eps_cg=p.eps, max_cg=p.MaxCGstep)
    raise ValueError(f"Dirac_operator {p.Dirac_operator!r} is not supported")


def _load_initial(p: Params, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    if p.initial in ("cold", "hot", "one instanton"):
        return fields.initialize_gaugefields(p.NC, p.L, condition=p.initial, seed=p.randomseed,
                                             dtype=dtype, device=device)
    # a file start: every rank reads the file and keeps its block
    return mesh.shard_links(load_config(p.loadU_format, p.initial, p.L, p.NC, dtype, device))


def build_universe(p: Params, dtype=torch.complex128, device="cuda") -> Univ:
    check_supported(p, device)
    u = _load_initial(p, dtype, device)
    logfilename = None
    if p.logfile:
        logdir = p.log_dir or "."
        os.makedirs(logdir, exist_ok=True)
        logfilename = os.path.join(os.getcwd(), logdir, p.logfile)
    vp = VerbosePrint(level=p.verboselevel, myid=mesh.get_myrank(), filename=logfilename)
    if p.initial not in ("cold", "hot", "one instanton"):
        vp.println_verbose_level2(".....  File start")
        vp.println_verbose_level1(f"File name is {p.initial}")
    return Univ(
        gauge_action=build_gauge_action(p),
        u=u,
        fermi_action=build_fermi_action(p),
        verbose_print=vp,
        cov_neural_net=build_smearing(p),
    )
