"""The simulation run: trajectory loop, saving and measurements.

Counterpart of latticeqcd_tpu/system/lqcd.py for the ported slices: build
the universe and the updater (HMC, Heatbath, or Fileloading over stored
configurations) from Params, optionally resume from a checkpoint, check a
staggered action's rational window against the spectrum of W (the RHMC
guard), run steps initialtrj..Nsteps (under Fileloading one per stored
configuration), print the same verbose lines (dH and accept per
trajectory, acceptance so far) plus the plaquette, save the links every
saveU_every steps, measure, flow a copy of the links numflow times and
measure after each flow step (the gradientflow_measurements), and return
the final mean plaquette. The device is explicit (``cuda`` by default); a
run never moves to another one.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import fields as dc_fields, replace
from typing import Optional

import torch

from latticeqcd_torch._version import __version__
from latticeqcd_torch.convert import to_numpy
from latticeqcd_torch.io import (load_checkpoint, save_bridge_text, save_checkpoint, save_ildg,
                                 save_jld2, save_u)
from latticeqcd_torch.measurements.scheduler import MeasurementSet
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
from latticeqcd_torch.smearing.gradientflow import gradientflow
from latticeqcd_torch.system.params import Params, construct_params_from_toml
from latticeqcd_torch.system.universe import build_universe
from latticeqcd_torch.updates.factory import updatemethod


# saveU_format -> (file extension, writer)
_SAVERS = {"JLD": ("jld2", save_jld2), "NPZ": ("npz", save_u), "ILDG": ("ildg", save_ildg),
           "BridgeText": ("txt", save_bridge_text)}


class Savedata:
    """saveU_every-gated configuration saving (latticeqcd_tpu/system/lqcd.py:51-99).

    Writes conf_{itrj:08d}.{jld2,npz,ildg,txt} into saveU_dir, and beside it
    checkpoint.npz with the links, the trajectory counter and the run's
    torch.Generator state, from which a run resumes bit for bit. Nothing is
    saved under Fileloading. An unknown format is refused here, before any
    trajectory. Saving from several processes waits for ROADMAP A14."""

    def __init__(self, saveU_format, saveU_dir, saveU_every, update_method, vp):
        self.issaved = saveU_format is not None and update_method != "Fileloading"
        if self.issaved and saveU_format not in _SAVERS:
            raise ValueError(f"saveU_format {saveU_format!r} is not supported")
        self.fmt = saveU_format
        self.dir = saveU_dir
        self.every = saveU_every
        self.vp = vp
        if self.issaved:
            vp.println_verbose_level1(f"save gaugefields U every {saveU_every} trajectory")

    def save(self, u, itrj, generator=None) -> Optional[float]:
        """Save at itrj if due; returns the seconds it took, else None."""
        if not self.issaved or itrj % self.every != 0:
            return None
        t0 = time.time()
        host = to_numpy(u)  # one copy to the host for the file and the checkpoint
        ext, write = _SAVERS[self.fmt]
        write(os.path.join(self.dir, f"conf_{itrj:08d}.{ext}"), host)
        if generator is not None:
            save_checkpoint(os.path.join(self.dir, "checkpoint.npz"), host,
                            rng_state=generator.get_state(), itrj=itrj)
        seconds = time.time() - t0
        self.vp.println_verbose_level1(f"Save ({self.fmt}): Elapsed time {seconds} [s]")
        return seconds


def run_lqcd_file(filename, make_dirs: bool = True, dtype=torch.complex128, device="cuda",
                  resume_checkpoint=None):
    """Run from a TOML parameter file (or a Params)."""
    if isinstance(filename, Params):
        parameters = filename
    else:
        ext = os.path.splitext(str(filename))[1]
        if ext not in (".toml", ""):
            raise ValueError(f"{filename} is not supported. use a TOML format.")
        parameters = construct_params_from_toml(filename, make_dirs=make_dirs)
    return run_lqcd_params(parameters, make_dirs=make_dirs, dtype=dtype, device=device,
                           resume_checkpoint=resume_checkpoint)


def run_lqcd_params(p: Params, make_dirs: bool = True, dtype=torch.complex128, device="cuda",
                    history: Optional[list] = None, resume_checkpoint=None):
    """Run the steps of p on ``device``; returns the final mean plaquette.

    resume_checkpoint: a checkpoint.npz. The run continues from its links and
    trajectory counter (initialtrj = itrj + 1) and, if the port wrote it,
    from its generator state, so that it is bit for bit the run that was
    never stopped. A JAX package's checkpoint has no such state: the draws
    restart from randomseed. The measurement files are appended to, and the
    checkpoint's links, measured by the stopped run, are not measured again.
    A staggered action first has its rational window checked against the
    Lanczos spectrum of W on the starting links (widened if needed).
    history, if given, receives one dict per step: itrj, seconds (host
    clock, ending in a device sync), dH and plaq (None under Heatbath and
    Fileloading), accepted, the solver records of that trajectory (CG and
    multi-shift CG alike), save_seconds (None if nothing was saved) and
    flow_seconds (the flow and its measurements; None without them)."""
    device = torch.device(device)
    univ = build_universe(p, dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(p.randomseed)
    vp = univ.verbose_print
    if resume_checkpoint is not None:
        ck = load_checkpoint(resume_checkpoint, dtype=dtype, device=device)
        univ.u = ck["u"]
        if "torch_rng_state" in ck:
            generator.set_state(ck["torch_rng_state"])
        else:
            vp.println_verbose_level1(
                f"# {resume_checkpoint} holds no torch generator state (a JAX checkpoint's "
                f"jax.random key cannot be continued in torch): the draws restart from "
                f"randomseed = {p.randomseed}")
        if "itrj" in ck:
            p = replace(p, initialtrj=ck["itrj"] + 1)
        vp.println_verbose_level1(f"# resumed from {resume_checkpoint} at itrj {p.initialtrj}")

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

    updater = updatemethod(p, univ)
    nsteps = getattr(updater, "Nsteps", p.Nsteps)  # Fileloading: one step per stored file
    savedata = Savedata(p.saveU_format, p.saveU_dir, p.saveU_every, p.update_method, vp)
    measuredir = p.measuredir if (p.measuredir and make_dirs) else None
    # a resumed run appends to the series the stopped run wrote, which holds the
    # measurements of the checkpoint's links already
    resumed = resume_checkpoint is not None
    measurements = MeasurementSet.from_methods(p.measurement_methods, measuredir=measuredir,
                                               append=resumed)
    measurements_for_flow = MeasurementSet.from_methods(
        p.measurements_for_flow, measuredir=measuredir, suffix="_flow", append=resumed)
    gf = gradientflow(p.NC, nflow=1, eps=p.eps_flow)
    dtau_flow = p.Nflow * p.eps_flow

    u = univ.u
    reunit_every = p.reunitarize_every
    if reunit_every < 0:
        reunit_every = 10 if dtype == torch.complex64 else 0
    if reunit_every:
        vp.println_verbose_level1(
            f"# reunitarize links every {reunit_every} trajectories (dtype {dtype}); "
            "pre-projection defect logged")
    if not resumed:
        measurements.calc_measurement_values(0, u)

    numaccepts = 0
    t_all = time.time()
    for itrj in range(p.initialtrj, nsteps + 1):
        vp.println_verbose_level1(f"# itrj = {itrj}")
        t0 = time.time()
        u, stats = updater.step(u, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.time() - t0
        accepted = stats["accepted"]
        vp.println_verbose_level1(f"Update: Elapsed time {seconds} [s]")
        if "dH" in stats:
            vp.println_verbose_level2(
                f"Snew - Sold = {stats['dH']}; " + ("Accepted" if accepted else "Rejected"))
            vp.println_verbose_level1(f"# plaquette = {stats['plaq']}")
        cg = stats.get("cg", [])
        if cg:
            iters = sum(c["iterations"] for c in cg)
            vp.println_verbose_level2(f"# CG: {len(cg)} solves, {iters} iterations")
        if accepted:
            numaccepts += 1
        if reunit_every and itrj % reunit_every == 0:
            defect = float(sun.unitarity_defect(u))
            u = sun.reunitarize(u)
            vp.println_verbose_level1(f"# unitarity defect {defect:.3e} (reprojected)")
        save_seconds = savedata.save(u, itrj, generator)
        measurements.calc_measurement_values(itrj, u)
        flow_seconds = None
        if measurements_for_flow.measurements and p.numflow > 0:
            t0 = time.time()
            usmr = u
            for istep in range(1, p.numflow + 1):
                for _ in range(p.Nflow):
                    usmr = gf.flow(usmr)
                # itrj appears twice in a flowed line, as in the JAX package
                measurements_for_flow.calc_measurement_values(
                    itrj, usmr, additional_string=f"{itrj} {istep} {istep * dtau_flow} ",
                    step=istep)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            flow_seconds = time.time() - t0
        if history is not None:
            history.append({"itrj": itrj, "seconds": seconds, "dH": stats.get("dH"),
                            "accepted": accepted, "plaq": stats.get("plaq"), "cg": cg,
                            "save_seconds": save_seconds, "flow_seconds": flow_seconds})
        vp.println_verbose_level1(
            f"Acceptance {numaccepts}/{itrj} : {round(numaccepts * 100 / itrj)} %")
        vp.flush()

    vp.println_verbose_level1(f"Total Elapsed time {time.time() - t_all} [s]")
    measurements.close()
    measurements_for_flow.close()
    plaq = float(ga.mean_plaquette(u))
    vp.close()
    return plaq
