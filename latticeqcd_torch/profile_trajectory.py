"""Where the device time of one HMC trajectory, or of one fermionic measurement, goes.

    python -m latticeqcd_torch.profile_trajectory [--dirac Staggered|Wilson] [--nf 4 2]
        [--lattice 16 16 16 32] [--repeat N] [--keep-trace DIR]
    python -m latticeqcd_torch.profile_trajectory --measurements [--lattice 16 16 16 32]
        [--repeat N]

For each flavour number given, builds the run of run_lqcd_params (hot
start, seed 3, beta 5.7, mass 0.5 or kappa 0.141139, dtau 0.02 x 10,
eps 1e-12, complex64), runs one untraced trajectory as a warm-up and
N more untraced for their host-clock times (``untraced_s`` is their
median, ``untraced_all_s`` the list), then traces one more with
torch.profiler (CPU and CUDA activity). With --dirac Wilson it also
gives the host's microseconds per packed Wilson hop (``hop_host_us``:
100 calls enqueued back to back, host clock, before the sync; the
median of 5 such batches). With --measurements it does the same for
each fermionic measurement method of chip_smoke.py's measurement path
(Wilson pion correlator, Wilson and staggered chiral condensate with
Nr = 10, Wilson Dirac spectrum, 8 values from 48 Lanczos steps) on the
hot start, complex64, with the traced call's result (``value``). Kernel
events are read from the exported chrome trace (kept in DIR if asked,
else deleted after reading: a trajectory's trace is tens of MB), summed
by kernel name and by class, and set against the traced wall time to
give the device's busy and idle shares. Prints one JSON object per
trajectory or method. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from latticeqcd_torch.measurements.scheduler import MeasurementSet
from latticeqcd_torch.ops import fields
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
from latticeqcd_torch.system.params import Params
from latticeqcd_torch.system.universe import build_universe
from latticeqcd_torch.updates.hmc import HMC

CLASSES = (  # first match wins, on the lower-cased kernel name
    ("staggered_w", ("staggered_hop_kernel",)),
    ("staggered_w_fused (off the paths)", ("staggered_w_fused_kernel",)),
    ("wilson_hop_packed", ("wilson_hop_brick_kernel",)),
    ("wilson_hop", ("wilson_hop_kernel",)),
    ("wilson_window", ("wilson_window_kernel",)),
    ("cuBLAS products", ("gemm", "cublas", "cutlass", "gemv")),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat", "where", "index")),
)


def _class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def _params(dirac: str, nf: int, lattice) -> Params:
    return Params(L=tuple(lattice), NC=3, beta=5.7, initial="hot", update_method="HMC",
                  quench=False, Dirac_operator=dirac, mass=0.5, Nf=nf, hop=0.141139,
                  BoundaryCondition=(1, 1, 1, -1), QPQ=True, dtau=0.02, MDsteps=10, eps=1e-12,
                  MaxCGstep=3000, randomseed=3, verboselevel=1)


def _untraced(fn, repeat: int) -> dict:
    """Host-clock seconds of `repeat` calls of fn, each ending in a device sync."""
    times = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return {"untraced_s": statistics.median(times), "untraced_all_s": times}


def hop_host_us(u, calls: int = 100, batches: int = 5) -> float:
    """Host microseconds per packed Wilson hop (WilsonDirac.hop_packed: the
    wrapper and its launch), `calls` enqueued back to back; the median of
    `batches` such batches."""
    dirac = WilsonDirac(kappa=0.141139)
    u_e, u_o = dirac.packed_links(u)
    x = torch.randn(u_e.shape[1:5] + (4, 3), dtype=u.dtype, device=u.device)
    per_call = []
    with torch.no_grad():
        for _ in range(10):
            dirac.hop_packed(u_o, u_e, x, 1)
        for _ in range(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                dirac.hop_packed(u_o, u_e, x, 1)
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def profile(dirac: str, nf: int, lattice, keep_dir=None, repeat: int = 1) -> dict:
    device = torch.device("cuda")
    p = _params(dirac, nf, lattice)
    univ = build_universe(p, dtype=torch.complex64, device=device)
    fa = univ.fermi_action
    if hasattr(fa, "ensure_spectral_bounds"):
        fa, _ = fa.ensure_spectral_bounds(univ.u)
    hmc = HMC(action=univ.gauge_action, dtau=p.dtau, md_steps=p.MDsteps, fermi_action=fa)
    gen = torch.Generator(device=device).manual_seed(p.randomseed)
    u = univ.u
    u, _ = hmc.step(u, gen)  # warm-up: library loads, kernel builds, allocator
    untraced = _untraced(lambda: hmc.step(u, gen), repeat)

    traced = {}
    breakdown = _traced(lambda: traced.update(stats=hmc.step(u, gen)[1]),
                        f"trace_{dirac.lower()}_nf{nf}.json", keep_dir)
    traced_stats = traced["stats"]
    solves = traced_stats["cg"]
    return {
        "dirac": dirac, "nf": nf, "lattice": list(lattice), "dtype": "complex64",
        "device": torch.cuda.get_device_name(0), **untraced, **breakdown,
        "solves": len(solves), "iterations": sum(c["iterations"] for c in solves),
        "dH": traced_stats["dH"], **({"hop_host_us": hop_host_us(u)} if dirac == "Wilson" else {}),
    }


def _traced(fn, trace_name: str, keep_dir=None) -> dict:
    """Run fn once under torch.profiler; its wall time, the device's busy time
    (the union of kernel intervals), idle share and kernel time by class."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    out_dir = keep_dir or tempfile.mkdtemp(dir=".")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, trace_name)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    if keep_dir is None:
        os.remove(trace)
        os.rmdir(out_dir)
        trace = None
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    by_class: dict = {}
    for name, sec in by_name.items():
        by_class[_class(name)] = by_class.get(_class(name), 0.0) + sec
    # busy time: the union of kernel intervals
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"traced_wall_s": wall, "device_busy_s": busy, "idle_share_traced": 1.0 - busy / wall,
            "kernels": len(events), "by_class_s": by_class, "top_kernels_s": dict(top),
            "trace": trace}


# the fermionic measurements of chip_smoke.py's measurement path
MEASUREMENT_METHODS = [
    {"methodname": "Pion_correlator",
     "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.141139}},
    {"methodname": "Chiral_condensate", "Nr": 10,
     "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.141139}},
    {"methodname": "Chiral_condensate", "Nr": 10,
     "fermion_parameters": {"Dirac_operator": "Staggered", "mass": 0.5, "Nf": 4}},
    {"methodname": "Dirac_spectrum", "Neig": 8, "Nlanczos": 48,
     "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.141139}},
]


def _values(value) -> list:
    """A method's result as a flat list of floats (for the condensate, pbp first)."""
    if isinstance(value, tuple):
        return [float(value[0])] + [float(v) for v in value[1]]
    return [float(v) for v in value]


def profile_measurements(lattice, keep_dir=None, repeat: int = 1) -> list:
    """One record per method: a warm-up call (itrj 0), `repeat` untraced calls
    (itrj 1) for their host-clock times, a traced call (itrj 2)."""
    device = torch.device("cuda")
    u = fields.hot_start(tuple(lattice), 3, seed=3, dtype=torch.complex64, device=device)
    out = []
    for meas in MeasurementSet.from_methods(MEASUREMENT_METHODS).measurements:
        meas.measure(u, 0)
        untraced = _untraced(lambda: meas.measure(u, 1), repeat)
        op = meas.params["fermion_parameters"]["Dirac_operator"]
        breakdown = _traced(lambda: meas.measure(u, 2), f"trace_{meas.name}_{op}.json".lower(),
                            keep_dir)
        out.append({
            "method": meas.name, "dirac": op, "lattice": list(lattice), "dtype": "complex64",
            "device": torch.cuda.get_device_name(0), **untraced, **breakdown,
            "iterations": sum(c["iterations"] for c in meas.solves or []),
            "value": _values(meas.value),
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dirac", default="Staggered", choices=("Staggered", "Wilson"))
    ap.add_argument("--nf", type=int, nargs="+", default=[4, 2])
    ap.add_argument("--lattice", type=int, nargs=4, default=[16, 16, 16, 32])
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="untraced trajectories or calls, timed one by one")
    ap.add_argument("--keep-trace", metavar="DIR", default=None)
    ap.add_argument("--measurements", action="store_true",
                    help="profile the fermionic measurements instead of trajectories")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trajectory needs a CUDA device")
    if args.measurements:
        for rec in profile_measurements(args.lattice, args.keep_trace, args.repeat):
            print(json.dumps(rec), flush=True)
        return 0
    for nf in args.nf:
        print(json.dumps(profile(args.dirac, nf, args.lattice, args.keep_trace, args.repeat)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
