"""The simulation run: trajectory loop, saving and measurements.

Counterpart of latticeqcd_tpu/system/lqcd.py for the ported slices: build
the universe and the updater (HMC, Heatbath, SLHMC, SLMC, IntegratedHMC,
IntegratedHB, or Fileloading over stored configurations) from Params, optionally resume from a checkpoint, check a
staggered action's rational window against the spectrum of W (the RHMC
guard), run steps initialtrj..Nsteps (under Fileloading one per stored
configuration), print the same verbose lines (dH and accept per
trajectory, acceptance so far) plus the plaquette, save the links every
saveU_every steps, measure, flow a copy of the links numflow times and
measure after each flow step (the gradientflow_measurements), and return
the final mean plaquette. The self-learning updaters also print their
effective couplings (beta_eff) per step. A legacy ``.jl`` input is converted
to the TOML beside it first. The steps are timed by phase (PhaseTimers, the
report printed after the run) and, given a profile_dir, traced by
torch.profiler. The device is explicit (``cuda`` by default); a run never
moves to another one. Given a process grid (``grid``, the counterpart of
the JAX package's shard_mesh), each process runs the same loop on its
block of the lattice (parallel/mesh.py), whatever the update method:
rank 0 alone prints (the self-learning couplings once), writes the
measurement files and the trace, and saves the gathered configuration;
under Fileloading every rank takes its step count from the same file list.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import fields as dc_fields, replace
from typing import Optional

import numpy as np
import torch

from latticeqcd_torch._version import __version__
from latticeqcd_torch.convert import to_numpy
from latticeqcd_torch.io import (load_checkpoint, save_bridge_text, save_checkpoint, save_ildg,
                                 save_jld2, save_u)
from latticeqcd_torch.measurements.scheduler import MeasurementSet
from latticeqcd_torch.ops import gauge_action as ga
from latticeqcd_torch.ops import sun
from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
from latticeqcd_torch.parallel import mesh
from latticeqcd_torch.smearing.gradientflow import gradientflow
from latticeqcd_torch.system.legacy_input import transform_to_toml
from latticeqcd_torch.system.params import Params, construct_params_from_toml
from latticeqcd_torch.system.universe import build_universe
from latticeqcd_torch.updates.factory import updatemethod
from latticeqcd_torch.utils.timers import TRACE_FILE, PhaseTimers, torch_trace


# saveU_format -> (file extension, writer)
_SAVERS = {"JLD": ("jld2", save_jld2), "NPZ": ("npz", save_u), "ILDG": ("ildg", save_ildg),
           "BridgeText": ("txt", save_bridge_text)}


class Savedata:
    """saveU_every-gated configuration saving (latticeqcd_tpu/system/lqcd.py:51-99).

    Writes conf_{itrj:08d}.{jld2,npz,ildg,txt} into saveU_dir, and beside it
    checkpoint.npz with the links, the trajectory counter and the run's
    torch.Generator state, from which a run resumes bit for bit. Nothing is
    saved under Fileloading. An unknown format is refused here, before any
    trajectory. Under a process grid every rank calls ``save``, the blocks
    are gathered to rank 0 (the run's only gather), and rank 0 writes both
    files."""

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
        # one copy to the host for the file and the checkpoint, the global links on rank 0
        host = to_numpy(u) if mesh.sharded() is None else mesh.to_host_global(u, lead=1)
        if host is None:
            return None
        ext, write = _SAVERS[self.fmt]
        write(os.path.join(self.dir, f"conf_{itrj:08d}.{ext}"), host)
        if generator is not None:
            save_checkpoint(os.path.join(self.dir, "checkpoint.npz"), host,
                            rng_state=generator.get_state(), itrj=itrj)
        seconds = time.time() - t0
        self.vp.println_verbose_level1(f"Save ({self.fmt}): Elapsed time {seconds} [s]")
        return seconds


def run_lqcd_file(filename, make_dirs: bool = True, dtype=torch.complex128, device="cuda",
                  resume_checkpoint=None, profile_dir=None, grid=None, history=None,
                  final=None):
    """Run from a TOML parameter file, a legacy ``.jl`` one (converted first to
    the TOML beside it), or a Params; ``grid``, ``history`` and ``final`` as
    run_lqcd_params takes them."""
    if isinstance(filename, Params):
        parameters = filename
    else:
        ext = os.path.splitext(str(filename))[1]
        if ext == ".jl":
            # legacy pre-1.0 input: convert like the reference (lqcd.jl:51)
            filename = transform_to_toml(str(filename))
            print(f"input file transformed to {filename}")
        elif ext not in (".toml", ""):
            raise ValueError(f"{filename} is not supported. use a TOML format.")
        parameters = construct_params_from_toml(filename, make_dirs=make_dirs)
    return run_lqcd_params(parameters, make_dirs=make_dirs, dtype=dtype, device=device,
                           resume_checkpoint=resume_checkpoint, profile_dir=profile_dir,
                           grid=grid, history=history, final=final)


def run_lqcd_params(p: Params, make_dirs: bool = True, dtype=torch.complex128, device="cuda",
                    history: Optional[list] = None, resume_checkpoint=None, profile_dir=None,
                    grid=None, final: Optional[dict] = None):
    """Run the steps of p on ``device``; returns the final mean plaquette.

    grid: None (one process), a parallel.mesh.ProcessGrid over p.L, or its PEs
    (PE1, PE2, PE3, PE4), built over the initialised process group. Every rank
    calls this with the same p; each runs on its block of the links, draws the
    global normals and keeps its block, and returns the same plaquette. A
    resumed run reads the checkpoint on every rank and keeps its block, so it
    continues bit for bit. final, if given, receives the last links (this rank's
    block) as "u" and the run's torch.Generator, in its state after the last step, as
    "generator" (under a grid the same state on every rank).

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
    multi-shift CG alike), save_seconds (None if nothing was saved),
    flow_seconds (the flow and its measurements; None without them),
    beta_eff (the self-learning updaters' couplings after the step, else None)
    and measured ({method: its numbers} of the step's measurements that keep
    them, the fermionic ones among them; every rank of a grid has them).
    The steps are timed by phase (update, save, measure, gradientflow; each
    phase ends in a device sync on a CUDA device), reported at verboselevel 1
    after the run; profile_dir, if given, receives a torch.profiler trace of
    the steps (utils/timers.py)."""
    device = torch.device(device)
    if grid is not None and not isinstance(grid, mesh.ProcessGrid):
        grid = mesh.make_process_grid(grid, p.L, device)
    if grid is not None and tuple(grid.lattice) != tuple(p.L):
        raise ValueError(f"the process grid is over {grid.lattice}, the run's lattice is {p.L}")
    with mesh.use_grid(grid):
        return _run(p, make_dirs, dtype, device, history, resume_checkpoint, profile_dir, grid,
                    final)


def _numbers(value):
    """A measurement's value as nested lists of Python floats (for a history record)."""
    if isinstance(value, (tuple, list)):
        return [_numbers(v) for v in value]
    return np.asarray(value, dtype=np.float64).tolist()


def _run(p, make_dirs, dtype, device, history, resume_checkpoint, profile_dir, grid, final):
    """run_lqcd_params's loop, under the active process grid."""
    timers = PhaseTimers(
        sync=(lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None)
    univ = build_universe(p, dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(p.randomseed)
    vp = univ.verbose_print
    if resume_checkpoint is not None:
        ck = load_checkpoint(resume_checkpoint, dtype=dtype, device=device)
        univ.u = mesh.shard_links(ck["u"])
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
    if grid is not None:
        vp.println_verbose_level1(
            f"# process grid PEs {grid.pes} ({grid.nprocs} processes, backend {grid.backend}): "
            f"local lattice {grid.local}")
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
    # one trace per run: rank 0's
    with torch_trace(profile_dir if mesh.is_rank0() else None, device):
        for itrj in range(p.initialtrj, nsteps + 1):
            vp.println_verbose_level1(f"# itrj = {itrj}")
            t0 = time.time()
            with timers.phase("update"):  # the phase's sync ends the step's device work
                u, stats = updater.step(u, generator)
            seconds = time.time() - t0
            accepted = stats["accepted"]
            vp.println_verbose_level1(f"Update: Elapsed time {seconds} [s]")
            if "dH" in stats:
                vp.println_verbose_level2(
                    f"Snew - Sold = {stats['dH']}; " + ("Accepted" if accepted else "Rejected"))
                vp.println_verbose_level1(f"# plaquette = {stats['plaq']}")
            if "beta_eff" in stats:  # the self-learning updaters' effective couplings
                vp.println_verbose_level2(f"beta_eff = {stats['beta_eff']}")
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
            with timers.phase("save"):
                save_seconds = savedata.save(u, itrj, generator)
            with timers.phase("measure"):
                measurements.calc_measurement_values(itrj, u)
            flow_seconds = None
            if measurements_for_flow.measurements and p.numflow > 0:
                t0 = time.time()
                with timers.phase("gradientflow"):
                    usmr = u
                    for istep in range(1, p.numflow + 1):
                        for _ in range(p.Nflow):
                            usmr = gf.flow(usmr)
                        # itrj appears twice in a flowed line, as in the JAX package
                        measurements_for_flow.calc_measurement_values(
                            itrj, usmr, additional_string=f"{itrj} {istep} {istep * dtau_flow} ",
                            step=istep)
                flow_seconds = time.time() - t0
            if history is not None:
                measured = {m.name: _numbers(m.value) for m in measurements.measurements
                            if getattr(m, "value", None) is not None
                            and m.interval > 0 and itrj % m.interval == 0}
                history.append({"itrj": itrj, "seconds": seconds, "dH": stats.get("dH"),
                                "accepted": accepted, "plaq": stats.get("plaq"), "cg": cg,
                                "save_seconds": save_seconds, "flow_seconds": flow_seconds,
                                "beta_eff": stats.get("beta_eff"), "measured": measured})
            vp.println_verbose_level1(
                f"Acceptance {numaccepts}/{itrj} : {round(numaccepts * 100 / itrj)} %")
            vp.flush()

    vp.println_verbose_level1(f"Total Elapsed time {time.time() - t_all} [s]")
    vp.println_verbose_level1(timers.report())
    if profile_dir is not None:
        vp.println_verbose_level1(
            f"# profiler trace written to {os.path.join(profile_dir, TRACE_FILE)}")
    measurements.close()
    measurements_for_flow.close()
    plaq = float(ga.mean_plaquette(u))
    vp.close()
    if final is not None:
        final["u"] = u
        final["generator"] = generator
    return plaq
