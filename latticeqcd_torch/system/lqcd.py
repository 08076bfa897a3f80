"""The simulation run: trajectory loop and measurements.

Counterpart of latticeqcd_tpu/system/lqcd.py for the ported slices: build
the universe and the HMC updater from Params, check a staggered action's
rational window against the spectrum of W (the RHMC guard), run trajectories
initialtrj..Nsteps, print the same verbose lines (dH and accept per
trajectory, acceptance so far) plus the plaquette, measure, and return
the final mean plaquette. The device is explicit (``cuda`` by default);
a run never moves to another one.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import fields as dc_fields
from typing import Optional

import torch

from latticeqcd_torch._version import __version__
from latticeqcd_torch.measurements.scheduler import MeasurementSet
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
from latticeqcd_torch.system.params import Params, construct_params_from_toml
from latticeqcd_torch.system.universe import build_universe
from latticeqcd_torch.updates.hmc import HMC


def _md_scheme(p) -> str:
    if p.MDscheme:
        if p.MDscheme not in ("QPQ", "PQP", "Omelyan"):
            raise ValueError(f"MDscheme must be 'QPQ', 'PQP' or 'Omelyan', got {p.MDscheme!r}")
        return p.MDscheme
    return "QPQ" if p.QPQ else "PQP"


def run_lqcd_file(filename, make_dirs: bool = True, dtype=torch.complex128, device="cuda"):
    """Run from a TOML parameter file (or a Params)."""
    if isinstance(filename, Params):
        parameters = filename
    else:
        ext = os.path.splitext(str(filename))[1]
        if ext not in (".toml", ""):
            raise ValueError(f"{filename} is not supported. use a TOML format.")
        parameters = construct_params_from_toml(filename, make_dirs=make_dirs)
    return run_lqcd_params(parameters, make_dirs=make_dirs, dtype=dtype, device=device)


def run_lqcd_params(p: Params, make_dirs: bool = True, dtype=torch.complex128, device="cuda",
                    history: Optional[list] = None):
    """Run the trajectories of p on ``device``; returns the final mean plaquette.

    A staggered action first has its rational window checked against the
    Lanczos spectrum of W on the starting links (widened if needed).
    history, if given, receives one dict per trajectory: itrj, seconds
    (host clock, ending in a device sync), dH, accepted, plaq and the
    solver records of that trajectory (CG and multi-shift CG alike)."""
    device = torch.device(device)
    univ = build_universe(p, dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(p.randomseed)
    vp = univ.verbose_print

    vp.println_verbose_level1("# ", os.getcwd())
    vp.println_verbose_level1("# ", datetime.datetime.now())
    vp.println_verbose_level1(f"latticeqcd_torch {__version__} (torch {torch.__version__})")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    vp.println_verbose_level1(f"# device={device} ({name}) dtype={dtype}")
    vp.println_verbose_level1("# effective parameters:")
    for f_ in dc_fields(p):
        vp.println_verbose_level1(f"#   {f_.name} = {getattr(p, f_.name)!r}")

    # RHMC guard: check that the rational window covers the measured
    # spectrum of W on the starting configuration; widen it if not
    if isinstance(univ.fermi_action, StaggeredFermiAction):
        lmin, lmax = univ.fermi_action.spectral_range_w(univ.u)
        univ.fermi_action, _ = univ.fermi_action.ensure_spectral_bounds(univ.u, lam=lmax)
        lo_b, hi_b = univ.fermi_action._bounds()
        vp.println_verbose_level2(
            f"# staggered W: spectrum ~ [{lmin:.4g}, {lmax:.4g}] "
            f"(kappa ~ {lmax / max(lmin, 1e-300):.3g}), rational window "
            f"[{lo_b:.4g}, {hi_b:.4g}]")

    updater = HMC(
        action=univ.gauge_action,
        dtau=p.dtau,
        md_steps=p.MDsteps,
        scheme=_md_scheme(p),
        sexton_weingarten=p.SextonWeingargten,
        nsw=p.N_SextonWeingargten,
        omelyan_lambda=p.omelyan_lambda,
        fermi_action=univ.fermi_action,
        md_precision=p.MDprecision,
    )
    measuredir = p.measuredir if (p.measuredir and make_dirs) else None
    measurements = MeasurementSet.from_methods(p.measurement_methods, measuredir=measuredir)

    u = univ.u
    reunit_every = p.reunitarize_every
    if reunit_every < 0:
        reunit_every = 10 if dtype == torch.complex64 else 0
    if reunit_every:
        vp.println_verbose_level1(
            f"# reunitarize links every {reunit_every} trajectories (dtype {dtype}); "
            "pre-projection defect logged")
    measurements.calc_measurement_values(0, u)

    numaccepts = 0
    t_all = time.time()
    for itrj in range(p.initialtrj, p.Nsteps + 1):
        vp.println_verbose_level1(f"# itrj = {itrj}")
        t0 = time.time()
        u, stats = updater.step(u, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.time() - t0
        accepted = stats["accepted"]
        vp.println_verbose_level1(f"Update: Elapsed time {seconds} [s]")
        vp.println_verbose_level2(
            f"Snew - Sold = {stats['dH']}; " + ("Accepted" if accepted else "Rejected"))
        vp.println_verbose_level1(f"# plaquette = {stats['plaq']}")
        if stats["cg"]:
            iters = sum(c["iterations"] for c in stats["cg"])
            vp.println_verbose_level2(f"# CG: {len(stats['cg'])} solves, {iters} iterations")
        if accepted:
            numaccepts += 1
        if reunit_every and itrj % reunit_every == 0:
            defect = float(sun.unitarity_defect(u))
            u = sun.reunitarize(u)
            vp.println_verbose_level1(f"# unitarity defect {defect:.3e} (reprojected)")
        measurements.calc_measurement_values(itrj, u)
        if history is not None:
            history.append({"itrj": itrj, "seconds": seconds, "dH": stats["dH"],
                            "accepted": accepted, "plaq": stats["plaq"], "cg": stats["cg"]})
        vp.println_verbose_level1(
            f"Acceptance {numaccepts}/{itrj} : {round(numaccepts * 100 / itrj)} %")
        vp.flush()

    vp.println_verbose_level1(f"Total Elapsed time {time.time() - t_all} [s]")
    measurements.close()
    plaq = float(ga.mean_plaquette(u))
    vp.close()
    return plaq
