#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against their plain versions.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit code:
  1. environment: torch, CUDA, the card and its power limit (no CUDA device: exit 1);
  2. build: compile every kernel source under latticeqcd_torch/csrc with nvcc, in parallel;
  3. kernels against their plain PyTorch versions on the card, at 4^4, 4x8x2x4, 2x4x2x6
     (X/2 = 1), 4x2x6x2 (extent-2 y and T), 8x6x10x4 and 16^3x32, in complex64 (bar 1e-5) and
     complex128 (bar 1e-12): wilson_hop_packed for both target parities and the backward of
     WilsonHopPacked through it; wilson_hop's full mode and its packed mode (the yardstick);
  4. timing at 16^3x32 (CUDA graphs between CUDA events): kernel and plain, each beside its
     bound, the least time the card could take (bytes over 3.35 TB/s, operations over the peak);
     the kernel cold (three input sets taken in turn, beyond the L2) and warm (one set);
     wilson_hop_packed and wilson_hop's packed mode also in turns (site, brick, brick, site);
  5. one 4^4 complex128 Wilson HMC trajectory through the kernel and through the plain path on
     the card (the wrappers' plain versions swapped in for this run only) from the same injected
     draws, and an MD reversibility check;
  6. the Wilson main path: run_lqcd_params at 16^3x32, SU(3), 2-flavour Wilson HMC, complex64,
     2 trajectories, with the Wilson kernels' launch counts set to 0 just before and read just
     after: wilson_hop_packed must have run, wilson_hop's packed mode never;
  7. staggered_w against its plain version at 4^4, 4x8x2x2, 2x4x2x6 and 16^3x32 in both types:
     the packed hop for both target parities, W, and the backward of StaggeredHopPacked;
  8. timing of staggered_w (W and one hop) at 16^3x32, as phase 4;
  9. 4^4 complex128 staggered trajectories (Nf=2 RHMC, Nf=4 HMC), kernel path against plain
     path as in phase 5, and Nf=2 MD reversibility;
 10. the staggered main path: run_lqcd_params at 16^3x32, SU(3), staggered mass 0.5,
     complex64, 2 trajectories at Nf=4 and 2 at Nf=2, with staggered_w's launch counts set to
     0 just before and read just after;
 11. wilson_window against its plain version at 4^4, 4x8x2x4, 4x8x2x2 (T=2), 3x5x2x6 (odd
     extents) and 16^3x32 in both types, forward and the backward for psi and U, and against
     wilson_hop's full mode;
 12. timing of wilson_window at 16^3x32, as phase 4, beside wilson_hop's full D;
 13. the fermionic measurements at 4^4 complex128 (Wilson pion correlator, Wilson and
     staggered condensates per noise from the same Z4 draws, Wilson low spectrum from the same
     start vector, a CGNE pion correlator on 3x5x2x6), kernel path against plain path;
 14. the measurement path: run_lqcd_params at 16^3x32, the phase-6 Wilson action, complex64,
     1 trajectory, with the pion correlator, the Wilson and staggered condensates (Nr=10) and
     the Wilson Dirac spectrum at itrj 0 and 1; every kernel's launch count set to 0 just
     before and read just after (wilson_hop's packed mode must stay at 0), each method's
     seconds, iterations and launches printed.
Then it prints one JSON line describing each kernel (its launches summed over the main paths
that run it), the card's name and power limit as nvidia-smi gives them, and, as its last
line, {"ok": true, "device": {...}}.
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
# wilson_hop_packed: its brick (1 x 2 rows with t whole up to 32 sites at complex64, 2 x 1 rows
# with t segments of at most 16 at complex128) wraps onto itself in x (X/2 = 1), y, z or t
# (extent 2), and the complex128 segments cut T = 32 and T = 6 unevenly
LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4), (16, 16, 16, 32)]
# wilson_window: the tile (2 x 4 x 16 sites at complex64, 2 x 4 x 8 at complex128) exceeds,
# does not divide, or wraps onto itself in every direction of one of these
WINDOW_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (4, 8, 2, 2), (3, 5, 2, 6), (16, 16, 16, 32)]
STAGGERED_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 2), (2, 4, 2, 6), (16, 16, 16, 32)]
MAIN = (16, 16, 16, 32)
KAPPA = 0.141139
MASS = 0.5

# The H100 SXM's published rates (NVIDIA data sheet): HBM3 bandwidth, and the peak outside
# the tensor cores for the real type of each complex type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"complex64": 67e12, "complex128": 34e12}

STATE = {"err": {"wilson_hop_packed": 0.0, "wilson_hop": 0.0, "staggered_w": 0.0,
                 "wilson_window": 0.0}, "checks": 0,
         "timing": {}, "launches": {}}


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


def check(label: str, err: float, bar: float, kernel: str = None):
    """Fail unless err < bar; a kernel-vs-plain check also counts toward that kernel's max error."""
    if kernel is not None:
        STATE["err"][kernel] = max(STATE["err"][kernel], err)
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
    print("== 3. wilson_hop_packed and wilson_hop against their plain version", flush=True)
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
            check(f"full D {tag}", maxdiff(out, wk.dslash_reference(u, psi, KAPPA)), bar,
                  "wilson_hop")

            u_e, u_o = eo_pack.pack_links(u, lat)
            half = (lat[0] // 2,) + lat[1:]
            x = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            cot = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                before = wk.launches
                got = wk.wilson_hop_packed(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                if wk.launches != before + 1:
                    fail("wilson_hop_packed did not launch")
                ref = wk.hop_packed_reference(u_t, u_s, x, parity)
                check(f"packed hop p={parity} {tag}", maxdiff(got, ref), bar, "wilson_hop_packed")
                site = wk.hop_packed_site(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                check(f"site kernel packed hop p={parity} {tag}", maxdiff(site, ref), bar,
                      "wilson_hop")

                leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
                grads_k = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
                grads_p = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity), leaves, cot)
                torch.cuda.synchronize()
                for name, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
                    check(f"packed backward d{name} p={parity} {tag}", maxdiff(a, b), bar,
                          "wilson_hop_packed")


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


def _time_device(torch, fn, reps=12, n=20) -> float:
    """Median device milliseconds of one call: `reps` calls captured in a
    CUDA graph, the graph replayed `n` times between CUDA events, so the
    host's launch overhead is not in the number. `fn` may be a list of
    calls on distinct inputs, taken in turn, so that no call finds its
    inputs in the 50 MB L2 cache where the previous one left them."""
    fns = fn if isinstance(fn, list) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
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


def _time_case(torch, label, dtype_name, kerns, plain, nbytes, flops):
    """Device and eager times of a kernel and its plain version, beside the bound: the larger
    of the least bytes the function must move over the HBM rate and its operations over the
    peak rate for its type. `kerns` are the kernel's call on three input sets: the cold time
    takes them in turn (113 MB or more, so the inputs come from HBM), the warm time repeats
    the first (its links may stay in L2). The line's time is the cold one."""
    t_k, t_w, t_p = _time_device(torch, kerns), _time_device(torch, kerns[0]), _time_device(torch, plain)
    e_k, e_p = _time_eager(torch, kerns[0]), _time_eager(torch, plain)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"  {label:20s} {dtype_name:10s} device: kernel {t_k * 1e3:8.1f} us cold "
          f"({t_w * 1e3:8.1f} us warm)  plain {t_p * 1e3:9.1f} us  bound {bound * 1e3:6.1f} us "
          f"({by}; {nbytes / 1e6:.1f} MB, {nbytes / (t_k * 1e-3) / 1e9:6.1f} GB/s cold, "
          f"{100 * bound / t_k:5.1f}% of bound); eager call: kernel {e_k * 1e3:8.1f} us  plain "
          f"{e_p * 1e3:9.1f} us  [{STATE['smi']}]", flush=True)
    STATE["timing"][(label, dtype_name)] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                                            "bound_by": by}


def phase_timing(torch):
    print("== 4. wilson_hop_packed and wilson_hop timing at 16^3x32", flush=True)
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, gaussian_spinor

    lat = MAIN
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    dirac = WilsonDirac(kappa=KAPPA)
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = []
            for seed in (7, 8, 9):
                u, psi, g = _fields(torch, lat, dtype, seed=seed)
                x = gaussian_spinor((lat[0] // 2,) + lat[1:], 3, dtype=dtype, device=u.device,
                                    generator=g)
                sets.append((u, psi, eo_pack.pack_links(u, lat), x))
            u, psi, (u_e, u_o), x = sets[0]

            def plain_dhat(v):
                d1 = wk.hop_packed_reference(u_o, u_e, v, 1)
                return v - KAPPA ** 2 * wk.hop_packed_reference(u_e, u_o, d1, 0)

            # least bytes at complex64: the full D reads each link and spinor once and writes
            # the output (480 B/site); a packed hop reads the links of both parities (576 B per
            # target site), its source field and writes its output (768 B per target site);
            # the packed D^D^dag is charged four hops and its two axpys (3 x 96 B each)
            cases = {
                "full D": ([lambda s=s: wk.wilson_dslash(s[0], s[1], KAPPA) for s in sets],
                           lambda: wk.dslash_reference(u, psi, KAPPA), 480 * vol, 1320 * vol),
                "packed hop": ([lambda s=s: wk.wilson_hop_packed(*s[2], s[3], 0) for s in sets],
                               lambda: wk.hop_packed_reference(u_e, u_o, x, 0),
                               768 * vol // 2, 1320 * vol // 2),
                "packed hop, site": ([lambda s=s: wk.hop_packed_site(*s[2], s[3], 0) for s in sets],
                                     lambda: wk.hop_packed_reference(u_e, u_o, x, 0),
                                     768 * vol // 2, 1320 * vol // 2),
                "packed DhatDhat^dag": (
                    [lambda s=s: dirac.apply_dhat_ddag(s[2], s[3]) for s in sets],
                    lambda: plain_dhat(wk.gamma5(plain_dhat(wk.gamma5(x)))),
                    (4 * 768 + 6 * 96) * vol // 2, (4 * 1320 + 2 * 48) * vol // 2),
            }
            for case, (kern, plain, nbytes, flops) in cases.items():
                _time_case(torch, case, name, kern, plain, f * nbytes, flops)
            # the redesigned packed hop against wilson_hop's packed mode, cold, in turns
            turns = {"site": [], "brick": []}
            for label in ("site", "brick", "brick", "site"):
                kerns = cases["packed hop" if label == "brick" else "packed hop, site"][0]
                turns[label].append(_time_device(torch, kerns))
            bound = STATE["timing"][("packed hop", name)]["bound_ms"]
            print(f"  packed hop {name} in turns (site, brick, brick, site), cold: brick "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['brick'])} us, site "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['site'])} us, bound "
                  f"{bound * 1e3:.1f} us: brick {100 * bound / statistics.mean(turns['brick']):.1f}%"
                  f", site {100 * bound / statistics.mean(turns['site']):.1f}% of bound "
                  f"[{STATE['smi']}]", flush=True)
            if statistics.mean(turns["brick"]) > statistics.mean(turns["site"]):
                fail(f"wilson_hop_packed is slower than wilson_hop's packed mode at {name}")


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

    before, site_before = wk.launches, dict(wk.site_launches)
    u_k, st_k = hmc.step(u, draws=draws)
    launched = wk.launches - before
    if wk.site_launches != site_before:
        fail("the kernel-path trajectory launched wilson_hop")
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
    print("== 6. Wilson main path: run_lqcd_params, 16^3x32 Wilson HMC, complex64", flush=True)
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
    wk.site_launches.update(full=0, packed=0)
    plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda", history=history)
    torch.cuda.synchronize()
    launched, site = wk.launches, dict(wk.site_launches)
    STATE["launches"].setdefault("wilson_hop_packed", {})["Wilson main path"] = launched
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
    print(f"  final plaquette {plaq:.8f}; launches on the main path: wilson_hop_packed {launched}, "
          f"wilson_hop {site}")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    if launched == 0:
        fail("the main path launched wilson_hop_packed no time")
    if site["packed"]:
        fail("the main path launched wilson_hop's packed mode")


def _packed_links(torch, lat, dtype, seed):
    from latticeqcd_torch.ops.dirac import eo_pack

    u, _, g = _fields(torch, lat, dtype, seed)
    return eo_pack.pack_links(u, lat), g


def phase_staggered_kernels(torch):
    print("== 7. staggered_w against its plain version", flush=True)
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk

    for lat in STAGGERED_LATTICES:
        half = (lat[0] // 2,) + lat[1:] + (3,)
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            bar = BARS[name]
            tag = f"{'x'.join(map(str, lat))} {name}"
            (u_e, u_o), g = _packed_links(torch, lat, dtype, seed=sum(lat) + 1)
            x = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            cot = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            got = sk.staggered_w(u_e, u_o, x, MASS)
            torch.cuda.synchronize()
            check(f"W {tag}", maxdiff(got, sk.staggered_w_reference(u_e, u_o, x, MASS)), bar,
                  "staggered_w")
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                got = sk.staggered_hop_packed(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                ref = sk.staggered_hop_packed_reference(u_t, u_s, x, parity)
                check(f"hop p={parity} {tag}", maxdiff(got, ref), bar, "staggered_w")
                leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
                grads_k = torch.autograd.grad(sk.staggered_hop_packed(*leaves, parity), leaves, cot)
                grads_p = torch.autograd.grad(sk.staggered_hop_packed_reference(*leaves, parity),
                                              leaves, cot)
                torch.cuda.synchronize()
                for gname, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
                    check(f"hop backward d{gname} p={parity} {tag}", maxdiff(a, b), bar,
                          "staggered_w")


def phase_staggered_timing(torch):
    print("== 8. staggered_w timing at 16^3x32", flush=True)
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk

    lat = MAIN
    sites = lat[0] * lat[1] * lat[2] * lat[3] // 2
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = []
            for seed in (8, 9, 10):
                (u_e, u_o), g = _packed_links(torch, lat, dtype, seed=seed)
                sets.append((u_e, u_o, torch.randn((lat[0] // 2,) + lat[1:] + (3,), dtype=dtype,
                                                   device=u_e.device, generator=g)))
            u_e, u_o, x = sets[0]
            # least bytes at complex64, per even or target site: the links of both parities
            # once (576 B), the input field once (24 B), the output once (24 B); about 570 flop
            # per target site for one hop, 1150 for W
            _time_case(torch, "staggered W", name,
                       [lambda s=s: sk.staggered_w(*s, MASS) for s in sets],
                       lambda: sk.staggered_w_reference(u_e, u_o, x, MASS),
                       f * 624 * sites, 1150 * sites)
            _time_case(torch, "staggered hop", name,
                       [lambda s=s: sk.staggered_hop_packed(*s, 0) for s in sets],
                       lambda: sk.staggered_hop_packed_reference(u_e, u_o, x, 0),
                       f * 624 * sites, 570 * sites)


def phase_staggered_trajectory_agreement(torch):
    print("== 9. 4^4 complex128 staggered trajectories: kernel path against plain path", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=13, dtype=torch.complex128, device=dev)
    for nf in (2, 4):
        fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=nf, eps_cg=1e-19)
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10, fermi_action=fa)
        # uniform 0: both trajectories are accepted, so U' compares the evolved links
        drawn = Draws.sample(hmc, u, torch.Generator(device=dev).manual_seed(14 + nf))
        draws = Draws(drawn.mom, drawn.xi, 0.0)
        before = sk.launches
        u_k, st_k = hmc.step(u, draws=draws)
        launched = sk.launches - before
        with mock.patch.object(sk, "_w", sk.staggered_w_reference), \
                mock.patch.object(sk, "_hop_packed", sk.staggered_hop_packed_reference):
            u_p, st_p = hmc.step(u, draws=draws)
        if sk.launches != before + launched:
            fail("the plain-path staggered trajectory launched the kernel")
        print(f"  Nf={nf}: kernel dH {st_k['dH']:.12f} accepted {st_k['accepted']} ({launched} "
              f"launches); plain dH {st_p['dH']:.12f} accepted {st_p['accepted']}")
        if launched == 0:
            fail("the kernel path of the staggered trajectory launched no kernel")
        check(f"Nf={nf} trajectory |ddH|", abs(st_k["dH"] - st_p["dH"]), 1e-9)
        check(f"Nf={nf} trajectory max|dU|", maxdiff(u_k, u_p), 1e-10)
        if st_k["accepted"] != st_p["accepted"]:
            fail(f"Nf={nf}: kernel and plain trajectories disagree on accept")

    # Nf=2 reversibility: integrate forward, flip the momenta, integrate back
    fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=2, eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10, fermi_action=fa)
    draws = Draws.sample(hmc, u, torch.Generator(device=dev).manual_seed(15))
    _, phi = fa.sample_pseudofermion(u, normals=draws.xi)
    force_f = lambda uu: fa.force(uu, phi)
    force_g = lambda uu: ga.force(hmc.action, uu)
    u1, h1 = integrators.leapfrog_qpq(u, draws.momentum(u), force_g, 0.1, 10, force_f)
    u2, _ = integrators.leapfrog_qpq(u1, -h1, force_g, 0.1, 10, force_f)
    check("Nf=2 MD reversibility max|dU|", maxdiff(u2, u), 1e-8)


def phase_staggered_main_path(torch):
    print("== 10. staggered main path: run_lqcd_params, 16^3x32 staggered Nf=4 HMC and Nf=2 "
          "RHMC, complex64", flush=True)
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.hmc import HMC

    step = HMC.step
    per_trajectory = []

    def counted_step(self, *args, **kwargs):
        w0 = sk.w_launches
        out = step(self, *args, **kwargs)
        per_trajectory.append(sk.w_launches - w0)
        return out

    torch.cuda.synchronize()
    sk.launches = sk.w_launches = 0
    for nf in (4, 2):
        p = Params(
            L=MAIN, NC=3, beta=5.7, initial="hot", update_method="HMC", quench=False,
            Dirac_operator="Staggered", mass=MASS, Nf=nf, BoundaryCondition=(1, 1, 1, -1),
            QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
            randomseed=3, verboselevel=2,
            measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
        )
        history = []
        per_trajectory.clear()
        with mock.patch.object(HMC, "step", counted_step):
            plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                                   history=history)
        torch.cuda.synchronize()
        for rec, w_count in zip(history, per_trajectory):
            cg = [c for c in rec["cg"] if "shifts" not in c]
            ms = [c for c in rec["cg"] if "shifts" in c]
            poles = max((c["shifts"] for c in ms), default=0)
            print(f"  Nf={nf} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations "
                  f"{sum(c['iterations'] for c in cg)} in {len(cg)} solves  multi-shift iterations "
                  f"{sum(c['iterations'] for c in ms)} in {len(ms)} solves of {poles} poles  "
                  f"dH {rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  "
                  f"staggered_w launches {w_count}  [{STATE['smi']}]", flush=True)
            if not math.isfinite(rec["dH"]):
                fail(f"non-finite dH {rec['dH']}")
            if any(c["iterations"] >= p.MaxCGstep for c in rec["cg"]):
                fail(f"a staggered solve stopped at maxiter {p.MaxCGstep}")
        if len(per_trajectory) != len(history) or not history:
            fail("the staggered main path ran no trajectory")
        print(f"  Nf={nf} final plaquette {plaq:.8f}")
        if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
            fail(f"plaquette {plaq} outside (0, 1)")
    torch.cuda.synchronize()
    STATE["launches"].setdefault("staggered_w", {})["staggered main path"] = sk.launches
    print(f"  staggered_w launches on the main path: {sk.launches} ({sk.w_launches} of the fused "
          f"W, {sk.launches - sk.w_launches} of the hop)")
    if sk.w_launches == 0 or sk.launches == sk.w_launches:
        fail("the staggered main path did not launch both staggered_w entry points")


def phase_window(torch):
    print("== 11. wilson_window against its plain version and against wilson_hop's full mode",
          flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    for lat in WINDOW_LATTICES:
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            bar = BARS[name]
            tag = f"{'x'.join(map(str, lat))} {name}"
            u, psi, g = _fields(torch, lat, dtype, seed=sum(lat) + 2)
            got = ww.wilson_window(u, psi, KAPPA)
            torch.cuda.synchronize()
            check(f"window D {tag}", maxdiff(got, wk.dslash_reference(u, psi, KAPPA)), bar,
                  "wilson_window")
            check(f"window D against wilson_hop full {tag}",
                  maxdiff(got, wk.wilson_dslash(u, psi, KAPPA)), bar)
            cot = torch.randn(psi.shape, dtype=dtype, device=psi.device, generator=g)
            leaves = [t.detach().clone().requires_grad_(True) for t in (u, psi)]
            grads_k = torch.autograd.grad(ww.wilson_window(*leaves, KAPPA), leaves, cot)
            grads_p = torch.autograd.grad(wk.dslash_reference(*leaves, KAPPA), leaves, cot)
            torch.cuda.synchronize()
            for gname, a, b in zip(("u", "psi"), grads_k, grads_p):
                check(f"window backward d{gname} {tag}", maxdiff(a, b), bar, "wilson_window")


def phase_window_timing(torch):
    print("== 12. wilson_window timing at 16^3x32, beside wilson_hop's full mode", flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    lat = MAIN
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = [_fields(torch, lat, dtype, seed=seed)[:2] for seed in (7, 8, 9)]
            u, psi = sets[0]
            # least bytes at complex64: each link and spinor read once, the output written
            # once (480 B/site); 1320 flop per site
            _time_case(torch, "window D", name,
                       [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in sets],
                       lambda: wk.dslash_reference(u, psi, KAPPA), f * 480 * vol, 1320 * vol)
            full = STATE["timing"].get(("full D", name))
            if full is not None:
                win = STATE["timing"][("window D", name)]
                print(f"  {name}: window D {win['ms'] * 1e3:.1f} us against wilson_hop full D "
                      f"{full['ms'] * 1e3:.1f} us (phase 4), bound {win['bound_ms'] * 1e3:.1f} us "
                      f"[{STATE['smi']}]", flush=True)


def _plain_kernels():
    """Swap every kernel wrapper's launch for its plain version (this run only)."""
    from contextlib import ExitStack

    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    stack = ExitStack()
    for mod, name, plain in ((wk, "_dslash", wk.dslash_reference),
                             (wk, "_hop_packed", wk.hop_packed_reference),
                             (ww, "_dslash", wk.dslash_reference),
                             (sk, "_w", sk.staggered_w_reference),
                             (sk, "_hop_packed", sk.staggered_hop_packed_reference)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def _launch_counts():
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    return {"wilson_window": ww.launches, "wilson_hop_packed": wk.launches,
            "staggered_w": sk.launches}


def phase_measurement_agreement(torch):
    print("== 13. 4^4 complex128 measurements: kernel path against plain path", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import fermionic
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, gaussian_spinor

    dev = torch.device("cuda")
    dtype = torch.complex128
    rng = np.random.default_rng(16)
    # relative |r|^2 1e-24: both paths' solutions within ~1e-12 of the exact one, so the
    # 1e-9 bar compares the kernels and not the solver's stopping point
    tight = 1e-24
    wilson = WilsonDirac(kappa=KAPPA)

    def both(label, fn, rtol=1e-9):
        before = _launch_counts()
        got = np.asarray(fn(), dtype=np.float64)
        launched = {k: v - before[k] for k, v in _launch_counts().items() if v > before[k]}
        with _plain_kernels():
            ref = np.asarray(fn(), dtype=np.float64)
        if _launch_counts() != {k: before[k] + launched.get(k, 0) for k in before}:
            fail(f"{label}: the plain path launched a kernel")
        if not launched:
            fail(f"{label}: the kernel path launched no kernel")
        err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))
        print(f"  {label}: {launched} launches", flush=True)
        check(f"{label} max relative diff", err, rtol)

    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=17, dtype=dtype, device=dev)
    both("Wilson pion correlator", lambda: fermionic.pion_correlator(u, wilson, eps=tight))
    draws = rng.integers(0, 4, (3,) + lat + (4, 3))
    both("Wilson pbp per noise",
         lambda: fermionic.chiral_condensate(u, wilson, nr=3, draws=draws, eps=tight)[1])
    stag = StaggeredDirac(mass=MASS, lattice=lat)
    draws = rng.integers(0, 4, (3,) + lat + (3,))
    both("staggered pbp per noise",
         lambda: fermionic.chiral_condensate(u, stag, nr=3, nf_factor=0.5, draws=draws,
                                             eps=tight)[1])
    v0 = gaussian_spinor(lat, 3, dtype=dtype, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(18))
    both("Wilson low spectrum", lambda: fermionic.dirac_low_spectrum(u, wilson, k=4, m=32, v0=v0))
    odd = (3, 5, 2, 6)
    u_odd = fields.hot_start(odd, 3, seed=19, dtype=dtype, device=dev)
    both(f"CGNE pion correlator {'x'.join(map(str, odd))}",
         lambda: fermionic.pion_correlator(u_odd, wilson, eps=tight))


def phase_measurement_path(torch):
    print("== 14. measurement path: run_lqcd_params, 16^3x32 Wilson HMC, complex64, with the "
          "fermionic measurements at itrj 0 and 1", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    maxcg = 3000
    wilson = {"Dirac_operator": "Wilson", "hop": KAPPA}
    methods = [
        {"methodname": "Pion_correlator", "fermion_parameters": wilson, "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "fermion_parameters": wilson, "Nr": 10,
         "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "Nr": 10, "MaxCGstep": maxcg,
         "fermion_parameters": {"Dirac_operator": "Staggered", "mass": MASS, "Nf": 4}},
        {"methodname": "Dirac_spectrum", "fermion_parameters": wilson, "Neig": 8,
         "Nlanczos": 48},
    ]
    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=1, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=1,
        measurement_methods=[{**m, "measure_every": 1} for m in methods],
    )
    records = []

    def timed(cls):
        measure = cls.measure

        def wrapper(self, u, itrj):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.time()
            line = measure(self, u, itrj)
            torch.cuda.synchronize()
            records.append({
                "method": self.name,
                "operator": self.params["fermion_parameters"]["Dirac_operator"], "itrj": itrj, "seconds": time.time() - t0, "value": self.value,
                "solves": self.solves,
                "launches": {k: v - before[k] for k, v in _launch_counts().items()}})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    torch.cuda.synchronize()
    ww.launches = wk.launches = sk.launches = sk.w_launches = 0
    wk.site_launches.update(full=0, packed=0)
    with timed(scheduler.PionCorrelatorMeasurement), \
            timed(scheduler.ChiralCondensateMeasurement), \
            timed(scheduler.DiracSpectrumMeasurement):
        t0 = time.time()
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda")
    torch.cuda.synchronize()
    total = time.time() - t0
    counts = _launch_counts()
    for name, n in counts.items():
        STATE["launches"].setdefault(name, {})["measurement path"] = n
    for rec in records:
        value = rec["value"]
        solves = rec["solves"] or []
        iters = sum(c["iterations"] for c in solves)
        if rec["method"] == "Dirac_spectrum":
            shown = " ".join(f"{v:.6g}" for v in value)
            work = f"{len(value)} Ritz values from 48 Lanczos steps"
        elif rec["method"] == "Chiral_condensate":
            shown = f"pbp {value[0]:.8g}"
            value = [value[0]] + list(value[1])
        else:
            shown = "C(t) " + " ".join(f"{v:.4g}" for v in value[:4]) + " ..."
        if rec["method"] != "Dirac_spectrum":
            work = f"CG iterations {iters} in {len(solves)} solve(s) of " \
                   f"{sum(c.get('rhs', 1) for c in solves)} RHS"
        print(f"  itrj {rec['itrj']} {rec['method']} ({rec['operator']}): {rec['seconds']:.3f} s  "
              f"{work}  launches {rec['launches']}  {shown}  [{STATE['smi']}]", flush=True)
        if not np.all(np.isfinite(np.asarray(value, dtype=np.float64))):
            fail(f"{rec['method']} gave a value that is not finite")
        if any(c["iterations"] >= maxcg for c in solves):
            fail(f"a {rec['method']} solve stopped at MaxCGstep {maxcg}")
        if rec["method"] == "Pion_correlator" and not np.all(np.asarray(value) > 0):
            fail("the pion correlator is not positive")
        if rec["method"] == "Dirac_spectrum" and not (
                np.all(np.diff(value) >= 0) and np.all(np.asarray(value) > 0)):
            fail("the Wilson low eigenvalues are not ascending and positive")
    if sorted({(r["method"], r["operator"], r["itrj"]) for r in records}) != sorted(
            {(m["methodname"], m["fermion_parameters"]["Dirac_operator"], i)
             for m in methods for i in (0, 1)}):
        fail("the measurement path did not run every method at itrj 0 and 1")
    print(f"  run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}; launches on the "
          f"measurement path (trajectory included): {counts}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"the measurement path launched {name} no time")
    if wk.site_launches["packed"]:
        fail(f"the measurement path launched wilson_hop's packed mode {wk.site_launches}")


PHASES = [phase_env, phase_build, phase_kernels, phase_timing,
          phase_trajectory_agreement, phase_main_path, phase_staggered_kernels,
          phase_staggered_timing, phase_staggered_trajectory_agreement, phase_staggered_main_path,
          phase_window, phase_window_timing, phase_measurement_agreement, phase_measurement_path]

KERNELS = [
    # name, source, the TPU kernel it replaces, the timing row of its line
    ("wilson_hop_packed", "latticeqcd_torch/csrc/wilson_hop_packed.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:414", ("packed hop", "complex64")),
    ("staggered_w", "latticeqcd_torch/csrc/staggered_w.cu",
     "latticeqcd_tpu/ops/dirac/staggered_pallas.py:274", ("staggered W", "complex64")),
    ("wilson_window", "latticeqcd_torch/csrc/wilson_window.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:349", ("window D", "complex64")),
]


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
    kernels = []
    for name, source, replaces, row in KERNELS:
        timing = STATE["timing"][row]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # launches summed over the main paths that run the kernel (printed per path)
            "launches": sum(STATE["launches"][name].values()), "max_abs_err": STATE["err"][name],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            # no single PyTorch call computes a Wilson or a staggered hop
            "library_ms": None,
        })
    print(f"kernels: {', '.join(k[0] for k in KERNELS)} ({STATE['checks']} checks; the yardstick "
          f"wilson_hop's largest error {STATE['err']['wilson_hop']:.3e}); "
          f"launches per main path {STATE['launches']}; total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
