#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against their plain versions.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit code:
  1. environment: torch, CUDA, the card and its power limit (no CUDA device: exit 1);
  2. build: compile every kernel source under latticeqcd_torch/csrc with nvcc, in parallel;
  3. kernels against their plain PyTorch versions on the card, at 4^4, 4x8x2x4 and 16^3x32,
     in complex64 (bar 1e-5) and complex128 (bar 1e-12): wilson_hop full and packed modes and
     the backward of WilsonHopPacked;
  4. timing at 16^3x32 with CUDA events (median of 50 after warm-up): kernel and plain;
  5. one 4^4 complex128 Wilson HMC trajectory through the kernel and through the plain path on
     the card (the wrappers' plain versions swapped in for this run only) from the same injected
     draws, and an MD reversibility check;
  6. the main path: run_lqcd_params at 16^3x32, SU(3), 2-flavour Wilson HMC, complex64, 2
     trajectories, with the kernels' launch counts set to 0 just before and read just after.
Then it prints one JSON line describing each kernel, the card's name and power limit as
nvidia-smi gives them, and, as its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

BARS = {"complex64": 1e-5, "complex128": 1e-12}
LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (16, 16, 16, 32)]
MAIN = (16, 16, 16, 32)
KAPPA = 0.141139

STATE = {"max_err": 0.0, "checks": 0}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check(label: str, err: float, bar: float):
    STATE["max_err"] = max(STATE["max_err"], err)
    STATE["checks"] += 1
    ok = math.isfinite(err) and err < bar
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: max|diff| = {err:.3e} (bar {bar:.0e})", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version: {err} >= {bar}")


def maxdiff(a, b) -> float:
    return float((a - b).abs().max())


# ------------------------------------------------------------------ phases


def phase_env(torch):
    print("== 1. environment", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    STATE["smi"] = nvidia_smi()
    print(f"nvidia-smi: {STATE['smi']}", flush=True)


def phase_build(torch):
    print("== 2. build", flush=True)
    from latticeqcd_torch import _nvcc

    names = sorted(p[:-3] for p in os.listdir(_nvcc.CSRC) if p.endswith(".cu"))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(_nvcc.build, names))
    print(f"built {', '.join(names)} in {time.time() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")


def _fields(torch, lat, dtype, seed):
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases, gaussian_spinor

    dev = torch.device("cuda")
    u = apply_boundary_phases(fields.hot_start(lat, 3, seed=seed, dtype=dtype, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    psi = gaussian_spinor(lat, 3, dtype=dtype, device=dev, generator=g)
    return u, psi, g


def phase_kernels(torch):
    print("== 3. kernels against their plain versions", flush=True)
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor

    for lat in LATTICES:
        for dtype in (torch.complex64, torch.complex128):
            bar = BARS[str(dtype).split(".")[1]]
            tag = f"{'x'.join(map(str, lat))} {str(dtype).split('.')[1]}"
            u, psi, g = _fields(torch, lat, dtype, seed=sum(lat))
            out = wk.wilson_dslash(u, psi, KAPPA)
            torch.cuda.synchronize()
            check(f"full D {tag}", maxdiff(out, wk.dslash_reference(u, psi, KAPPA)), bar)

            u_e, u_o = eo_pack.pack_links(u, lat)
            half = (lat[0] // 2,) + lat[1:]
            x = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            cot = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                got = wk.wilson_hop_packed(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                ref = wk.hop_packed_reference(u_t, u_s, x, parity)
                check(f"packed hop p={parity} {tag}", maxdiff(got, ref), bar)

                leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
                grads_k = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
                grads_p = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity), leaves, cot)
                torch.cuda.synchronize()
                for name, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
                    check(f"packed backward d{name} p={parity} {tag}", maxdiff(a, b), bar)


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _time_eager(torch, fn, n=50, warm=5) -> float:
    """Median milliseconds of one eager call, CUDA events around each call:
    what a caller such as the CG loop sees, host overhead included."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start, end = _events(torch)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_device(torch, fn, reps=10, n=20) -> float:
    """Median device milliseconds of one call: `reps` calls captured in a
    CUDA graph, the graph replayed `n` times between CUDA events, so the
    host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = _events(torch)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def phase_timing(torch):
    print("== 4. timing at 16^3x32", flush=True)
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, gaussian_spinor

    lat = MAIN
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    card = STATE["smi"]
    dirac = WilsonDirac(kappa=KAPPA)
    rows = {}
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            bytes_per_site = 480 * (2 if dtype == torch.complex128 else 1)
            u, psi, g = _fields(torch, lat, dtype, seed=7)
            u_e, u_o = eo_pack.pack_links(u, lat)
            x = gaussian_spinor((lat[0] // 2,) + lat[1:], 3, dtype=dtype, device=u.device, generator=g)

            def plain_dhat(v):
                d1 = wk.hop_packed_reference(u_o, u_e, v, 1)
                return v - KAPPA ** 2 * wk.hop_packed_reference(u_e, u_o, d1, 0)

            cases = {
                "full D": (lambda: wk.wilson_dslash(u, psi, KAPPA),
                           lambda: wk.dslash_reference(u, psi, KAPPA), vol),
                "packed hop": (lambda: wk.wilson_hop_packed(u_e, u_o, x, 0),
                               lambda: wk.hop_packed_reference(u_e, u_o, x, 0), vol // 2),
                "packed DhatDhat^dag": (
                    lambda: dirac.apply_dhat_ddag((u_e, u_o), x),
                    lambda: plain_dhat(wk.gamma5(plain_dhat(wk.gamma5(x)))), 2 * vol),
            }
            for case, (kern, plain, sites) in cases.items():
                t_k, t_p = _time_device(torch, kern), _time_device(torch, plain)
                e_k, e_p = _time_eager(torch, kern), _time_eager(torch, plain)
                gbs = bytes_per_site * sites / (t_k * 1e-3) / 1e9
                rows[(case, name)] = (t_k, t_p)
                print(f"  {case:20s} {name:10s} device: kernel {t_k * 1e3:8.1f} us  plain "
                      f"{t_p * 1e3:9.1f} us  ({gbs:6.1f} GB/s at {bytes_per_site} B/site); "
                      f"eager call: kernel {e_k * 1e3:8.1f} us  plain {e_p * 1e3:9.1f} us  [{card}]",
                      flush=True)
    STATE["timing"] = rows


def phase_trajectory_agreement(torch):
    print("== 5. 4^4 complex128 trajectory: kernel path against plain path", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    dtype = torch.complex128
    u = fields.hot_start(lat, 3, seed=11, dtype=dtype, device=dev)
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10, fermi_action=fa)
    # uniform 0: both trajectories are accepted, so U' compares the evolved links
    drawn = Draws.sample(hmc, u, torch.Generator(device=dev).manual_seed(12))
    draws = Draws(drawn.mom, drawn.xi, 0.0)

    before = wk.launches
    u_k, st_k = hmc.step(u, draws=draws)
    launched = wk.launches - before
    with mock.patch.object(wk, "_dslash", wk.dslash_reference), \
            mock.patch.object(wk, "_hop_packed", wk.hop_packed_reference):
        u_p, st_p = hmc.step(u, draws=draws)
    if wk.launches != before + launched:
        fail("the plain-path trajectory launched the kernel")
    d_dh = abs(st_k["dH"] - st_p["dH"])
    d_u = maxdiff(u_k, u_p)
    print(f"  kernel dH {st_k['dH']:.12f} accepted {st_k['accepted']} ({launched} launches); "
          f"plain dH {st_p['dH']:.12f} accepted {st_p['accepted']}")
    if launched == 0:
        fail("the kernel path of the trajectory launched no kernel")
    check("trajectory |ddH|", d_dh, 1e-9)
    check("trajectory max|dU|", d_u, 1e-10)
    if st_k["accepted"] != st_p["accepted"]:
        fail("kernel and plain trajectories disagree on accept")

    # reversibility: integrate forward, flip the momenta, integrate back
    h0 = draws.momentum(u)
    _, phi = fa.sample_pseudofermion(u, normals=draws.xi)
    guess = {"x": None}

    def force_f(uu):
        f, guess["x"] = fa.force_with_guess(uu, phi, guess["x"])
        return f

    force_g = lambda uu: ga.force(hmc.action, uu)
    u1, h1 = integrators.leapfrog_qpq(u, h0, force_g, 0.1, 10, force_f)
    guess["x"] = None
    u2, _ = integrators.leapfrog_qpq(u1, -h1, force_g, 0.1, 10, force_f)
    check("MD reversibility max|dU|", maxdiff(u2, u), 1e-8)


def phase_main_path(torch):
    print("== 6. main path: run_lqcd_params, 16^3x32 Wilson HMC, complex64", flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=2,
        measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
    )
    # randomseed 3: its hot start has plaquette +1.66e-4, so the (0, 1) check
    # holds even when both trajectories are rejected, as a dH of O(20) from a
    # hot start at this volume and dtau makes likely
    history = []
    torch.cuda.synchronize()
    wk.launches = 0
    plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda", history=history)
    torch.cuda.synchronize()
    launched = wk.launches
    STATE["launches"] = {"wilson_hop": launched}
    for rec in history:
        cg_iters = sum(c["iterations"] for c in rec["cg"])
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations {cg_iters} "
              f"in {len(rec['cg'])} solves  dH {rec['dH']:.6f}  accepted {rec['accepted']}  "
              f"plaquette {rec['plaq']:.8f}  worst verified residual/target {worst:.3g}  "
              f"[{STATE['smi']}]", flush=True)
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if worst > 1.0:
            fail("a CG returned a verified residual above its target")
    print(f"  final plaquette {plaq:.8f}; wilson_hop launches on the main path: {launched}")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    if launched == 0:
        fail("the main path launched wilson_hop no time")
    STATE["history"] = history


PHASES = [phase_env, phase_build, phase_kernels, phase_timing,
          phase_trajectory_agreement, phase_main_path]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import latticeqcd_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the latticeqcd_torch package is not beside this script: {exc}")
    t0 = time.time()
    for phase in PHASES:
        phase(torch)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "latticeqcd_tpu"))
    if leaked:
        fail(f"the port imported the JAX side: {leaked}")
    t_k, t_p = STATE["timing"][("packed hop", "complex64")]
    kernels = [{
        "name": "wilson_hop",
        "route": "cuda",
        "source": "latticeqcd_torch/csrc/wilson_hop.cu",
        "replaces": "latticeqcd_tpu/ops/dirac/wilson_pallas.py:414",
        "launches": STATE["launches"]["wilson_hop"],
        "max_abs_err": STATE["max_err"],
        "ms": t_k,
        "plain_ms": t_p,
    }]
    print(f"kernels: wilson_hop ({STATE['checks']} checks against the plain version); "
          f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
