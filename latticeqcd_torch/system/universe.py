"""Simulation state assembly: links, gauge action, fermion action, logger.

Counterpart of latticeqcd_tpu/system/universe.py for the ported slices:
cold, hot, one-instanton or file starts (ILDG, Bridge++ text, JLD or
NPZ), the Wilson plaquette action, and no fermions, two-flavour Wilson
fermions with csw = 0, or staggered fermions with Nf = 1..8, updated by
HMC or (quenched) Heatbath, or loaded by Fileloading, with gradient-flow
measurements. Everything else raises NotImplementedError naming the
ROADMAP item that will port it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from latticeqcd_torch.io import load_config
from latticeqcd_torch.measurements.scheduler import build_dirac_from_params
from latticeqcd_torch.ops import fields, gauge_action as ga
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, refuse_r_off_cpu
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
from latticeqcd_torch.system.params import Params
from latticeqcd_torch.utils.logger import VerbosePrint


@dataclass
class Univ:
    gauge_action: ga.GaugeAction
    u: torch.Tensor
    fermi_action: Optional[Any]  # None: quenched
    verbose_print: VerbosePrint


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def check_supported(p: Params, device="cuda") -> None:
    """Refuse, by name, what the port does not run (on ``device``)."""
    if p.update_method not in ("HMC", "Heatbath", "Fileloading"):
        _not_ported(f"update_method = {p.update_method!r}", "A12")
    if p.couplinglist or p.coupling_loops is not None:
        _not_ported("general gauge actions", "A3")
    if not p.quench and p.Dirac_operator not in (None, "Wilson", "Staggered"):
        _not_ported(f"Dirac_operator = {p.Dirac_operator!r}", "A12")
    if (not p.quench and p.Dirac_operator == "Staggered"
            and torch.device(device).type != "cpu" and not eo_pack.packable(p.L)):
        _not_ported(f"staggered fermions on {device} with an odd lattice extent {tuple(p.L)} "
                    "(a full-volume mode of the staggered_w kernel)", "A11")
    if not p.quench and p.Dirac_operator == "Wilson":
        refuse_r_off_cpu(p.r, device)
    for method in p.measurement_methods or ():  # refused here, before any trajectory
        if "fermion_parameters" in method:
            build_dirac_from_params(method["fermion_parameters"], p.L, device=device)
    if getattr(p, "hasenbusch", False):
        _not_ported("Hasenbusch mass preconditioning", "A12")
    if p.smearing_for_fermion != "nothing":
        _not_ported("smearing for fermions", "A12")
    if p.SextonWeingargten:
        _not_ported("the Sexton-Weingarten integrator", "A7")
    if p.MDprecision == "mixed":
        _not_ported("mixed-precision MD", "A12")


def build_fermi_action(p: Params):
    if p.quench or p.Dirac_operator is None:
        return None
    bc = tuple(p.BoundaryCondition)
    if p.Dirac_operator == "Staggered":
        dirac = StaggeredDirac(mass=p.mass, lattice=tuple(p.L), bc=bc)
        return StaggeredFermiAction(dirac, nf=p.Nf, eps_cg=p.eps, max_cg=p.MaxCGstep)
    dirac = WilsonDirac(kappa=p.hop, r=p.r, bc=bc)
    return WilsonFermiAction(dirac, eps_cg=p.eps, max_cg=p.MaxCGstep)


def _load_initial(p: Params, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    if p.initial in ("cold", "hot", "one instanton"):
        return fields.initialize_gaugefields(p.NC, p.L, condition=p.initial, seed=p.randomseed,
                                             dtype=dtype, device=device)
    return load_config(p.loadU_format, p.initial, p.L, p.NC, dtype, device)  # file start


def build_universe(p: Params, dtype=torch.complex128, device="cuda") -> Univ:
    check_supported(p, device)
    u = _load_initial(p, dtype, device)
    logfilename = None
    if p.logfile:
        logdir = p.log_dir or "."
        os.makedirs(logdir, exist_ok=True)
        logfilename = os.path.join(os.getcwd(), logdir, p.logfile)
    vp = VerbosePrint(level=p.verboselevel, filename=logfilename)
    if p.initial not in ("cold", "hot", "one instanton"):
        vp.println_verbose_level2(".....  File start")
        vp.println_verbose_level1(f"File name is {p.initial}")
    return Univ(
        gauge_action=ga.wilson_gauge_action(p.NC, p.beta),
        u=u,
        fermi_action=build_fermi_action(p),
        verbose_print=vp,
    )
