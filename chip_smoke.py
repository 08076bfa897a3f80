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
  7. staggered_w against its plain version at 4^4, 4x8x2x2, 2x4x2x6, 4x2x6x2 (extent-2 y and
     T), 8x6x10x4 (extents the fused W's tile does not divide), 12^3x8 and 16^3x32 in both
     types at mass 0.5 on hot links, and on phase 16's inputs (the links of pbp56_ckpt.npz
     with the boundary phases, m = 0.025): the packed hop for both target parities, the
     two-launch W of the paths, the backward of StaggeredHopPacked, and the one-launch W
     (staggered_w_fused, thread-block clusters);
  8. timing of staggered_w (W and one hop) and of staggered_w_fused at 16^3x32, as phase 4,
     beside the W's bound; the one-launch and the two-launch W also in turns (fused,
     two-launch, two-launch, fused);
  9. 4^4 complex128 staggered trajectories (Nf=2 RHMC, Nf=4 HMC), kernel path against plain
     path as in phase 5, and Nf=2 MD reversibility;
 10. the staggered main path: run_lqcd_params at 16^3x32, SU(3), staggered mass 0.5,
     complex64, 2 trajectories at Nf=4 and 2 at Nf=2, with staggered_w's launch counts set to
     0 just before and read just after (the W's launches printed per trajectory;
     staggered_w_fused must stay at 0);
 11. wilson_window against its plain version at 4^4, 4x8x2x4, 4x8x2x2 (T=2), 3x5x2x6 (odd
     extents), 2x1x9x3 (extent 1), 5x6x9x30 and 16^3x32 in both types, forward and the
     backward for psi and U, and against wilson_hop's full mode;
 12. timing of wilson_window at 16^3x32, as phase 4, and in turns with wilson_hop's full D
     (window, full, full, window), which it must beat;
 13. the fermionic measurements at 4^4 complex128 (Wilson pion correlator, Wilson and
     staggered condensates per noise from the same Z4 draws, Wilson low spectrum from the same
     start vector, a CGNE pion correlator on 3x5x2x6), kernel path against plain path;
 14. the measurement path: run_lqcd_params at 16^3x32, the phase-6 Wilson action, complex64,
     1 trajectory, with the pion correlator, the Wilson and staggered condensates (Nr=10) and
     the Wilson Dirac spectrum at itrj 0 and 1; every kernel's launch count set to 0 just
     before and read just after (wilson_hop's packed mode and staggered_w_fused must stay at
     0), each method's
     seconds, iterations and launches printed;
 15. configurations on disk at 16^3x32 complex64, the phase-6 Wilson action from a cold start:
     run_lqcd_params for 2 trajectories saving ILDG, and again saving NPZ; every saved file
     (and checkpoint.npz) loads back bit for bit equal to the links the run held; BridgeText
     round-trips through io on the same links, and JLD too if h5py imports (else its clear
     error is checked); a Fileloading run over the ILDG files measures Plaquette (bit for bit
     the HMC run's lines) and a Wilson Chiral_condensate; 4 trajectories straight against the
     NPZ run resumed from its checkpoint for 2 more, bit for bit (links, dH, the saved file
     and the Plaquette series the resumed run appends to); save and load seconds per
     format and the file sizes printed; wilson_hop_packed's launches counted per run;
 16. the pbp anchor, short: an NPZ file start from PERF_CAPTURE/pbp56_ckpt.npz (the JAX chain's
     thermalised beta = 5.6 state, 12^3x8), Nf=4 staggered at m = 0.025 with 35 MD steps of
     1/35, complex64, 2 trajectories and Chiral_condensate (Nr=2) at itrj 0 and 2; it fails if
     a solve hits its limit, dH is not finite, a plaquette lies outside 0.575-0.589 or a pbp
     outside 0.1239-0.1467; seconds per trajectory, CG iterations per solve and staggered_w
     launches printed;
 17. the quenched pieces at 4^4 complex128, the card against the CPU (bar 1e-12): one
     overrelaxation sweep for NC = 2, 3, 4 (the total action also conserved to 1e-8 relative),
     one heatbath sweep from the same uniforms drawn on the host with numpy for NC = 2, 3,
     5 gradient-flow steps of 0.02, the topological charge (plaquette, clover, improved), the
     energy density and the Wilson loops W(R, T), R, T <= 4;
 18. the quenched path: run_lqcd_params at 16^3x32, SU(3), beta = 6.0, Heatbath with 3
     overrelaxations, complex64, cold start, 4 steps; Plaquette, Polyakov_loop,
     Topological_charge, Energy_density, Wilson_loop (Rmax = Tmax = 4) and a Wilson
     Pion_correlator at kappa = 0.12 at itrj 0, 2 and 4; 20 flow steps of 0.02 after each step
     with Energy_density and Topological_charge every 5; wilson_hop_packed's launch count set to
     0 just before and read just after; it fails if a plaquette after a step leaves 0.55-1.0,
     the unitarity defect after the run exceeds 1e-4, a Q or E is not finite, the flowed E does
     not move toward its unit-link value 1 from one measured flow step to the next, a pion CG
     reaches its limit or wilson_hop_packed did not run; seconds per heatbath and per
     overrelaxation sweep, per measurement method and per flow step printed;
 19. the 12^4 plaquette anchor, short: validation_plaq's chain at beta = 6.0 (complex64, cold
     start, heatbath without overrelaxation) for 60 sweeps; the mean plaquette of sweeps 31-60
     must lie within 0.593745 +- 0.0025 (the JAX chain's 12^4 value); seconds per sweep printed.
 20. the improved-action pieces at 4^4 complex128: the generic staples and force of the Iwasaki,
     chair, polyakov_t and a coupling_loops action, a 2-layer stout smear, card against CPU (bar
     1e-12); the generic plaquette staple against the fused one; the stout-smeared Wilson and
     staggered (Nf = 4, 2) forces kernel path against plain path (1e-10 relative); one
     trajectory each of scenario 7's action (Wilson, beta 5.7, kappa 0.141139, QPQ with
     Sexton-Weingarten nsw 10, 20 steps of 0.05), phase 21's action and staggered Nf = 2 RHMC on
     one stout layer with QPQ-SW, kernel path against plain path (dH 1e-9, links 1e-10); MD
     reversibility of phase 21's action (1e-8); a plaquette + rectangle action's overrelaxation
     (the action conserved to 1e-8 relative) and heatbath sweep from host uniforms for NC = 2,
     3, card against CPU;
 21. the improved-action path: run_lqcd_params at 16^3x32, SU(3), complex64, hot start, 2
     trajectories of the Iwasaki action at beta_I = 2.6 with 2-flavour Wilson fermions at kappa
     0.12 on 2 plaquette stout layers of rho 0.1, Omelyan with Sexton-Weingarten nsw 4, 5
     steps of 0.04; the Wilson kernels' launch counts set to 0 just before and read just after
     (wilson_hop_packed must have run, wilson_hop's packed mode never); it fails if dH is not
     finite, a solve reaches MaxCGstep or fails its verification, the unitarity defect after the
     run exceeds 1e-4 or a plaquette leaves (0, 1); seconds per trajectory, CG iterations per
     solve, launches per trajectory and torch.cuda.max_memory_allocated printed, and, on the
     run's links, one Iwasaki force, one Wilson force and one stout forward + backward timed.
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
# wilson_window: its tile (1 x 2 rows with t whole up to 32 sites at complex64, one row over t
# segments of at most 16 at complex128, marching along x over chunks) wraps onto itself in y
# (extent 1) or z (extent 2), does not divide z (extent 9) or x into equal chunks, and
# its complex128 segments cut T = 30 and T = 32
WINDOW_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (4, 8, 2, 2), (3, 5, 2, 6), (2, 1, 9, 3),
                   (5, 6, 9, 30), (16, 16, 16, 32)]
# staggered_w_fused: its 8 x 4 x 4-row cluster tile (2 x 2 x 2 rows a block) wraps onto itself
# or does not divide x', y or z in all but the last, and cuts T = 32 at complex128; 12^3x8 is
# the pbp anchor's lattice (phase 16)
STAGGERED_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 2), (2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4),
                      (12, 12, 12, 8), (16, 16, 16, 32)]
MAIN = (16, 16, 16, 32)
KAPPA = 0.141139
MASS = 0.5

# The H100 SXM's published rates (NVIDIA data sheet): HBM3 bandwidth, and the peak outside
# the tensor cores for the real type of each complex type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"complex64": 67e12, "complex128": 34e12}

STATE = {"err": {"wilson_hop_packed": 0.0, "wilson_hop": 0.0, "staggered_w": 0.0,
                 "staggered_w_fused": 0.0,
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


def _staggered_checks(torch, sk, u_e, u_o, x, cot, mass, tag, bar):
    """The two-launch W, the one-launch W and the packed hop of both target parities with
    its backward, each against its plain version on the same inputs."""
    ref = sk.staggered_w_reference(u_e, u_o, x, mass)
    got = sk.staggered_w(u_e, u_o, x, mass)
    torch.cuda.synchronize()
    check(f"W {tag}", maxdiff(got, ref), bar, "staggered_w")
    before = sk.fused_launches
    got = sk.staggered_w_fused(u_e, u_o, x, mass)
    torch.cuda.synchronize()
    if sk.fused_launches != before + 1:
        fail("staggered_w_fused did not launch")
    check(f"one-launch W {tag}", maxdiff(got, ref), bar, "staggered_w_fused")
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
            check(f"hop backward d{gname} p={parity} {tag}", maxdiff(a, b), bar, "staggered_w")


def phase_staggered_kernels(torch):
    print("== 7. staggered_w against its plain version", flush=True)
    from latticeqcd_torch import validation_pbp
    from latticeqcd_torch.io import load_u
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    for lat in STAGGERED_LATTICES:
        half = (lat[0] // 2,) + lat[1:] + (3,)
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            (u_e, u_o), g = _packed_links(torch, lat, dtype, seed=sum(lat) + 1)
            x = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            cot = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            tag = f"{'x'.join(map(str, lat))} {name}"
            _staggered_checks(torch, sk, u_e, u_o, x, cot, MASS, tag, BARS[name])
    # the pbp anchor's inputs (phase 16): the JAX chain's thermalised beta = 5.6 links with the
    # staggered boundary phases, m = 0.025
    lat = validation_pbp.LAT
    half = (lat[0] // 2,) + lat[1:] + (3,)
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        u = apply_boundary_phases(load_u(validation_pbp.checkpoint_path(5.6), dtype, "cuda"))
        u_e, u_o = eo_pack.pack_links(u, lat)
        g = torch.Generator(device=u.device).manual_seed(56)
        x = torch.randn(half, dtype=dtype, device=u.device, generator=g)
        cot = torch.randn(half, dtype=dtype, device=u.device, generator=g)
        _staggered_checks(torch, sk, u_e, u_o, x, cot, validation_pbp.MASS,
                          f"pbp56_ckpt.npz m={validation_pbp.MASS} {name}", BARS[name])


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
            fused = [lambda s=s: sk.staggered_w_fused(*s, MASS) for s in sets]
            _time_case(torch, "staggered W, one launch", name, fused,
                       lambda: sk.staggered_w_reference(u_e, u_o, x, MASS),
                       f * 624 * sites, 1150 * sites)
            # the one-launch W against the paths' two-launch W, cold, in turns
            two = [lambda s=s: sk.staggered_w(*s, MASS) for s in sets]
            turns = {"fused": [], "two": []}
            for label in ("fused", "two", "two", "fused"):
                turns[label].append(_time_device(torch, fused if label == "fused" else two))
            bound = STATE["timing"][("staggered W", name)]["bound_ms"]
            print(f"  staggered W {name} in turns (fused, two-launch, two-launch, fused), cold: "
                  f"one launch {' '.join(f'{t * 1e3:.1f}' for t in turns['fused'])} us, two "
                  f"launches {' '.join(f'{t * 1e3:.1f}' for t in turns['two'])} us, bound "
                  f"{bound * 1e3:.1f} us (aim, 50% of the bound: {bound * 2e3:.1f} us): one launch "
                  f"{100 * bound / statistics.mean(turns['fused']):.1f}%, two launches "
                  f"{100 * bound / statistics.mean(turns['two']):.1f}% of bound [{STATE['smi']}]",
                  flush=True)


def phase_staggered_trajectory_agreement(torch):
    print("== 9. 4^4 complex128 staggered trajectories: kernel path against plain path", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=13, dtype=torch.complex128, device=dev)
    for nf in (2, 4):
        fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=nf, eps_cg=1e-19)
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10, fermi_action=fa)
        _trajectory_pair(torch, f"Nf={nf}", hmc, u, 14 + nf)

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
        w0, f0 = sk.w_launches, sk.fused_launches
        out = step(self, *args, **kwargs)
        per_trajectory.append((sk.w_launches - w0, sk.fused_launches - f0))
        return out

    torch.cuda.synchronize()
    sk.launches = sk.w_launches = sk.fused_launches = 0
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
        for rec, (w_count, fused_count) in zip(history, per_trajectory):
            cg = [c for c in rec["cg"] if "shifts" not in c]
            ms = [c for c in rec["cg"] if "shifts" in c]
            poles = max((c["shifts"] for c in ms), default=0)
            print(f"  Nf={nf} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations "
                  f"{sum(c['iterations'] for c in cg)} in {len(cg)} solves  multi-shift iterations "
                  f"{sum(c['iterations'] for c in ms)} in {len(ms)} solves of {poles} poles  "
                  f"dH {rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  "
                  f"W launches: two-launch {w_count}, one-launch {fused_count}  "
                  f"[{STATE['smi']}]", flush=True)
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
    print(f"  staggered_w launches on the main path: {sk.launches} ({sk.w_launches} of the "
          f"two-launch W, {sk.launches - sk.w_launches} of the hop); staggered_w_fused "
          f"{sk.fused_launches}")
    if sk.w_launches == 0 or sk.launches == sk.w_launches:
        fail("the staggered main path did not launch both staggered_w entry points")
    if sk.fused_launches:
        fail("the staggered main path launched staggered_w_fused, which no path calls")


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
            # the redesigned window D against wilson_hop's full D, cold, in turns
            full = [lambda s=s: wk.wilson_dslash(s[0], s[1], KAPPA) for s in sets]
            window = [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in sets]
            turns = {"window": [], "full": []}
            for label in ("window", "full", "full", "window"):
                turns[label].append(_time_device(torch, window if label == "window" else full))
            bound = STATE["timing"][("window D", name)]["bound_ms"]
            print(f"  window D {name} in turns (window, full, full, window), cold: window "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['window'])} us, wilson_hop full D "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['full'])} us, bound "
                  f"{bound * 1e3:.1f} us: window "
                  f"{100 * bound / statistics.mean(turns['window']):.1f}%, full "
                  f"{100 * bound / statistics.mean(turns['full']):.1f}% of bound [{STATE['smi']}]",
                  flush=True)
            if statistics.mean(turns["window"]) > statistics.mean(turns["full"]):
                fail(f"wilson_window is slower than wilson_hop's full D at {name}")


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


def _trajectory_pair(torch, label, hmc, u, seed):
    """One trajectory through the kernels and one through their plain versions from the same
    draws (uniform 0: both accepted, so U' compares the evolved links)."""
    from latticeqcd_torch.updates.hmc import Draws

    drawn = Draws.sample(hmc, u, torch.Generator(device=u.device).manual_seed(seed))
    draws = Draws(drawn.mom, drawn.xi, 0.0)
    before = _launch_counts()
    u_k, st_k = hmc.step(u, draws=draws)
    after = _launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    with _plain_kernels():
        u_p, st_p = hmc.step(u, draws=draws)
    if _launch_counts() != after:
        fail(f"{label}: the plain-path trajectory launched a kernel")
    print(f"  {label}: kernel dH {st_k['dH']:.12f} ({launched} launches, "
          f"{sum(c['iterations'] for c in st_k['cg'])} CG iterations); plain dH "
          f"{st_p['dH']:.12f}", flush=True)
    if not launched:
        fail(f"{label}: the kernel path of the trajectory launched no kernel")
    check(f"{label} trajectory |ddH|", abs(st_k["dH"] - st_p["dH"]), 1e-9)
    check(f"{label} trajectory max|dU|", maxdiff(u_k, u_p), 1e-10)
    if st_k["accepted"] != st_p["accepted"]:
        fail(f"{label}: kernel and plain trajectories disagree on accept")


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

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({
                "method": self.name,
                "operator": self.params["fermion_parameters"]["Dirac_operator"], "itrj": itrj, "seconds": time.time() - t0, "value": self.value,
                "solves": self.solves,
                "launches": {k: v - before[k] for k, v in _launch_counts().items()}})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    torch.cuda.synchronize()
    ww.launches = wk.launches = sk.launches = sk.w_launches = sk.fused_launches = 0
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
    print(f"  staggered_w's two-launch W {sk.w_launches}, staggered_w_fused {sk.fused_launches}")
    if sk.fused_launches:
        fail("the measurement path launched staggered_w_fused, which no path calls")


def _bits(t):
    """A complex tensor's bits as integers of its real type's width."""
    import torch

    return torch.view_as_real(t).view(torch.int32 if t.dtype == torch.complex64 else torch.int64)


def check_same(label: str, a, b):
    """Fail unless two link tensors are equal bit for bit."""
    import torch

    STATE["checks"] += 1
    ok = a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: {'bit for bit equal' if ok else 'NOT equal'}",
          flush=True)
    if not ok:
        fail(f"{label}: not bit for bit equal")


def _disk_params(**kw):
    from latticeqcd_torch.system.params import Params

    base = dict(
        L=MAIN, NC=3, beta=6.0, initial="cold", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=1,
        measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
    )
    base.update(kw)
    return Params(**base)


def _mb(path) -> str:
    return f"{os.path.getsize(path) / 1e6:.1f} MB"


def phase_disk(torch):
    print("== 15. configurations on disk: run_lqcd_params at 16^3x32 Wilson HMC, complex64, cold "
          "start, saving ILDG and NPZ; Fileloading; resume", flush=True)
    import shutil
    import tempfile

    import numpy as np

    from latticeqcd_torch import io
    from latticeqcd_torch.io import jld2
    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system import lqcd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    save = lqcd.Savedata.save
    held, label = {}, [None]

    def holding(self, u, itrj, generator=None):
        seconds = save(self, u, itrj, generator)
        if seconds is not None:
            held[(label[0], itrj)] = u.clone()
        return seconds

    launches = {}

    def run(name, p, **kw):
        """run_lqcd_params with wilson_hop_packed's count set to 0 just before and read just
        after; the links of every save are kept under name."""
        label[0] = name
        history = []
        torch.cuda.synchronize()
        wk.launches = 0
        wk.site_launches.update(full=0, packed=0)
        with mock.patch.object(lqcd.Savedata, "save", holding):
            plaq = lqcd.run_lqcd_params(p, make_dirs=True, dtype=torch.complex64, device="cuda",
                                        history=history, **kw)
        torch.cuda.synchronize()
        launches[name] = wk.launches
        for rec in history:
            dh = "" if rec["dH"] is None else f"dH {rec['dH']:.6f}  accepted {rec['accepted']}  "
            saved = "" if rec["save_seconds"] is None else f"  saved in {rec['save_seconds']:.3f} s"
            print(f"  {name} itrj {rec['itrj']}: {rec['seconds']:.3f} s  {dh}CG iterations "
                  f"{sum(c['iterations'] for c in rec['cg'])}{saved}  [{STATE['smi']}]",
                  flush=True)
            if rec["dH"] is not None and not math.isfinite(rec["dH"]):
                fail(f"{name}: non-finite dH {rec['dH']}")
            if any(c["iterations"] >= p.MaxCGstep for c in rec["cg"]):
                fail(f"{name}: a CG stopped at MaxCGstep")
        if wk.launches == 0 or wk.site_launches["packed"]:
            fail(f"{name}: wilson_hop_packed launched {wk.launches} times, wilson_hop's packed "
                 f"mode {wk.site_launches['packed']}")
        return plaq, history

    def timed_load(fn, loader):
        torch.cuda.synchronize()
        t0 = time.time()
        u = loader(fn)
        torch.cuda.synchronize()
        return u, time.time() - t0

    try:
        lat, c64 = MAIN, dict(dtype=torch.complex64, device="cuda")
        loaders = {"ILDG": lambda fn: io.load_ildg(fn, lat, 3, **c64),
                   "NPZ": lambda fn: io.load_u(fn, **c64)}
        runs = {}
        for fmt, ext in (("ILDG", "ildg"), ("NPZ", "npz")):
            d = os.path.join(tmp, fmt)
            os.makedirs(d)
            p = _disk_params(saveU_format=fmt, saveU_dir=d, saveU_every=1,
                             measuredir=os.path.join(d, "measure"))
            runs[fmt] = run(fmt, p)
            if sum(r["accepted"] for r in runs[fmt][1]) == 0:
                fail(f"{fmt}: no trajectory accepted from the cold start, the links never moved")
            for itrj in (1, 2):
                fn = os.path.join(d, f"conf_{itrj:08d}.{ext}")
                u, seconds = timed_load(fn, loaders[fmt])
                print(f"  {fmt} conf_{itrj:08d}.{ext}: {_mb(fn)}, saved in "
                      f"{runs[fmt][1][itrj - 1]['save_seconds']:.3f} s (with checkpoint.npz), "
                      f"loaded in {seconds:.3f} s", flush=True)
                check_same(f"{fmt} conf_{itrj:08d} loaded against the links the run held", u,
                           held[(fmt, itrj)])
            ck = io.load_checkpoint(os.path.join(d, "checkpoint.npz"), **c64)
            print(f"  {fmt} checkpoint.npz: {_mb(os.path.join(d, 'checkpoint.npz'))}, itrj "
                  f"{ck['itrj']}, generator state {tuple(ck['torch_rng_state'].shape)}")
            if ck["itrj"] != 2 or "torch_rng_state" not in ck:
                fail(f"{fmt}: checkpoint.npz lacks itrj 2 or the generator state")
            check_same(f"{fmt} checkpoint.npz links", ck["u"], held[(fmt, 2)])
        check_same("the ILDG and the NPZ runs' links at itrj 2 (the same run twice)",
                   held[("ILDG", 2)], held[("NPZ", 2)])

        u = held[("ILDG", 2)]
        round_trips = [("BridgeText", "txt", io.save_bridge_text,
                        lambda fn: io.load_bridge_text(fn, lat, 3, **c64))]
        if jld2.h5py is not None:
            round_trips.append(("JLD", "jld2", io.save_jld2,
                                lambda fn: io.load_jld2(fn, lat, 3, **c64)))
        else:
            STATE["checks"] += 1
            try:
                io.load_jld2(os.path.join(tmp, "conf.jld2"), lat, 3, **c64)
                fail("load_jld2 without h5py did not raise ImportError")
            except ImportError as exc:
                print(f"  JLD: h5py does not import here; the clear error is raised: {exc}")
                if "JLD2 I/O needs h5py" not in str(exc):
                    fail("the JLD error without h5py does not say what it needs")
        for fmt, ext, saver, loader in round_trips:
            fn = os.path.join(tmp, f"conf.{ext}")
            t0 = time.time()
            saver(fn, u)
            seconds = time.time() - t0
            back, load_s = timed_load(fn, loader)
            print(f"  {fmt} round trip through io{' (h5py imports)' if fmt == 'JLD' else ''}: "
                  f"{_mb(fn)}, saved in {seconds:.3f} s, loaded in {load_s:.3f} s", flush=True)
            check_same(f"{fmt} loaded against the links saved", back, u)

        # Fileloading over the ILDG files: Plaquette and a Wilson Chiral_condensate
        wilson = {"Dirac_operator": "Wilson", "hop": KAPPA}
        maxcg = 3000
        records = []
        measure = scheduler.ChiralCondensateMeasurement.measure

        def recorded(self, uu, itrj, additional_string=""):
            line = measure(self, uu, itrj, additional_string)
            records.append((itrj, self.value[0], list(self.solves)))
            return line

        fl = os.path.join(tmp, "fileloading")
        p = _disk_params(update_method="Fileloading", loadU_format="ILDG",
                         loadU_dir=os.path.join(tmp, "ILDG"), measuredir=fl,
                         measurement_methods=[
                             {"methodname": "Plaquette", "measure_every": 1},
                             {"methodname": "Chiral_condensate", "measure_every": 1, "Nr": 2,
                              "MaxCGstep": maxcg, "fermion_parameters": wilson}])
        with mock.patch.object(scheduler.ChiralCondensateMeasurement, "measure", recorded):
            _, fl_history = run("Fileloading", p)
        if [r["itrj"] for r in fl_history] != [1, 2]:
            fail(f"Fileloading ran {len(fl_history)} steps over 2 ILDG files")
        for itrj, pbp, solves in records:
            iters = [c["iterations"] for c in solves]
            print(f"  Fileloading itrj {itrj}: Wilson pbp {pbp:.8g}, CG iterations {iters}")
            if not math.isfinite(pbp) or any(i >= maxcg for i in iters):
                fail("the Fileloading Chiral_condensate is not finite or hit MaxCGstep")
        hmc_lines = open(os.path.join(tmp, "ILDG", "measure", "Plaquette.txt")).read()
        fl_lines = open(os.path.join(fl, "Plaquette.txt")).read()
        STATE["checks"] += 1
        print(f"  Fileloading Plaquette.txt against the HMC run's: {fl_lines.splitlines()}")
        if fl_lines != hmc_lines:
            fail(f"the Fileloading plaquettes differ from the HMC run's:\n{hmc_lines}")

        # resume: 4 trajectories straight against the NPZ run resumed for 2 more
        for name, kw, d in (("straight", {}, os.path.join(tmp, "straight")),
                            ("resumed", {"resume_checkpoint": os.path.join(tmp, "NPZ",
                                                                           "checkpoint.npz")},
                             os.path.join(tmp, "NPZ"))):
            os.makedirs(d, exist_ok=True)
            # the resumed run appends to the series of the NPZ run it continues
            p = _disk_params(Nsteps=4, saveU_format="NPZ", saveU_dir=d, saveU_every=2,
                             measuredir=os.path.join(d, "measure"))
            runs[name] = run(name, p, **kw)
        if [r["itrj"] for r in runs["resumed"][1]] != [3, 4]:
            fail("the resumed run did not continue at itrj 3")
        dh_straight = [r["dH"] for r in runs["straight"][1]]
        dh_resumed = [r["dH"] for r in runs["NPZ"][1] + runs["resumed"][1]]
        print(f"  dH straight {dh_straight}; 2 + resumed 2 {dh_resumed}")
        STATE["checks"] += 1
        if dh_straight != dh_resumed:
            fail("the resumed trajectories' dH differ from the straight run's")
        check_same("links at itrj 4: 4 straight against 2 + resume 2", held[("resumed", 4)],
                   held[("straight", 4)])
        check_same("conf_00000004.npz: straight against resumed",
                   io.load_u(os.path.join(tmp, "straight", "conf_00000004.npz"), **c64),
                   io.load_u(os.path.join(tmp, "NPZ", "conf_00000004.npz"), **c64))
        series = {n: open(os.path.join(tmp, n, "measure", "Plaquette.txt")).read()
                  for n in ("straight", "NPZ")}
        print(f"  Plaquette.txt of 2 + resumed 2: {series['NPZ'].splitlines()}")
        STATE["checks"] += 1
        if series["NPZ"] != series["straight"]:
            fail(f"the resumed Plaquette series differs from the straight run's:\n"
                 f"{series['straight']}")
        STATE["launches"].setdefault("wilson_hop_packed", {})["configurations on disk"] = \
            sum(launches.values())
        print(f"  wilson_hop_packed launches per run: {launches}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_anchor(torch):
    print("== 16. the Nf=4 staggered pbp anchor, short: 12^3x8 from pbp56_ckpt.npz, m = 0.025, "
          "2 trajectories", flush=True)
    import shutil
    import tempfile

    from latticeqcd_torch import validation_pbp
    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_anchor_")
    records = []
    measure = scheduler.ChiralCondensateMeasurement.measure

    def recorded(self, u, itrj, additional_string=""):
        line = measure(self, u, itrj, additional_string)
        records.append((itrj, self.value[0], list(self.solves)))
        return line

    try:
        p = validation_pbp.anchor_params(5.6, 2, tmp)
        history = []
        torch.cuda.synchronize()
        sk.launches = sk.w_launches = sk.fused_launches = 0
        with mock.patch.object(scheduler.ChiralCondensateMeasurement, "measure", recorded):
            run_lqcd_params(p, make_dirs=True, dtype=torch.complex64, device="cuda",
                            history=history)
        torch.cuda.synchronize()
        counts = (sk.launches, sk.w_launches, sk.fused_launches)
        plaq_lines = open(os.path.join(tmp, "Plaquette.txt")).read().split("\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    STATE["launches"].setdefault("staggered_w", {})["pbp anchor"] = counts[0]
    for rec in history:
        iters = [c["iterations"] for c in rec["cg"]]
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  dH {rec['dH']:.6f}  accepted "
              f"{rec['accepted']}  plaquette {rec['plaq']:.8f}  CG {sum(iters)} iterations in "
              f"{len(iters)} solves ({sum(iters) / max(len(iters), 1):.1f} per solve, most "
              f"{max(iters, default=0)})  [{STATE['smi']}]", flush=True)
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if any(i >= p.MaxCGstep for i in iters):
            fail(f"an HMC solve stopped at MaxCGstep {p.MaxCGstep}")
    plaqs = [float(line.split()[1]) for line in plaq_lines if line.strip()]
    for itrj, pbp, solves in records:
        iters = [c["iterations"] for c in solves]
        print(f"  itrj {itrj}: pbp {pbp:.8f} (Nr=2; CG iterations {iters})", flush=True)
        if any(i >= 4000 for i in iters):
            fail("a Chiral_condensate solve stopped at MaxCGstep 4000")
        STATE["checks"] += 1
        if not 0.1239 <= pbp <= 0.1467:
            fail(f"pbp {pbp} outside 0.1239-0.1467 (the JAX series' mean +- 5 std)")
    print(f"  plaquettes {plaqs}; staggered_w launches {counts[0]} ({counts[1]} of the two-launch "
          f"W), staggered_w_fused {counts[2]}")
    STATE["checks"] += 1
    if len(history) != 2 or len(records) != 2 or len(plaqs) != 3:
        fail("the anchor did not run 2 trajectories with measurements at itrj 0 and 2")
    if not all(0.575 <= x <= 0.589 for x in plaqs + [r["plaq"] for r in history]):
        fail(f"a plaquette lies outside 0.575-0.589: {plaqs}")
    if counts[1] == 0 or counts[2]:
        fail("the anchor did not run the two-launch staggered W, or ran the one-launch W")


def _warm_links(torch, lat, nc, seed, device, eps=0.3):
    """exp(i eps H), H traceless hermitian from numpy's default_rng(seed): a plaquette of
    0.7-0.8. An overrelaxation sweep on Haar-random links amplifies rounding by up to 1e6
    (NC = 4), so the 1e-12 comparison of two devices runs on ordered links."""
    import numpy as np

    from latticeqcd_torch.ops import sun

    rng = np.random.default_rng(seed)
    shape = (4, *lat, nc, nc)
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    h = 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))
    h -= np.trace(h, axis1=-2, axis2=-1)[..., None, None] * np.eye(nc) / nc
    return sun.expi_hermitian(torch.from_numpy(h), eps).to(device)


class _HostUniforms:
    """A heatbath sweep's uniforms drawn on the host with numpy, each try's and each
    direction's from its own seed (seed, update, try), so that two devices get the same
    numbers whatever number of tries each makes."""

    def __init__(self, torch, seed):
        self.torch, self.seed, self.update = torch, seed, 0

    def _draw(self, key, n, shape, dtype, device):
        import numpy as np

        r = np.random.default_rng([self.seed, self.update, key]).random((n, *shape))
        return [self.torch.from_numpy(x).to(dtype=dtype, device=device) for x in r]

    def tries(self, shape, dtype, device):
        self.update += 1
        k = 0
        while True:
            k += 1
            r1, r2, r3, r4 = self._draw(k, 4, shape, dtype, device)
            yield r1.clamp_min(1e-30), r2, r3.clamp_min(1e-30), r4

    def direction(self, shape, dtype, device):
        ct, phi = self._draw(0, 2, shape, dtype, device)
        return 2.0 * ct - 1.0, (2 * math.pi) * phi


def phase_quenched_agreement(torch):
    print("== 17. 4^4 complex128 quenched pieces: the card against the CPU", flush=True)
    from latticeqcd_torch.measurements import observables
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.smearing.gradientflow import gradientflow
    from latticeqcd_torch.updates.heatbath import Heatbath

    lat = (4, 4, 4, 4)
    bar = BARS["complex128"]
    for nc in (2, 3, 4):
        act = ga.wilson_gauge_action(nc, 5.7)
        hb = Heatbath(action=act)
        u = _warm_links(torch, lat, nc, 30 + nc, "cpu")
        cpu, gpu = hb.overrelax(u), hb.overrelax(u.cuda())
        check(f"overrelaxation sweep SU({nc}), card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
        s0, s1 = float(ga.action_value(act, u.cuda())), float(ga.action_value(act, gpu))
        check(f"overrelaxation SU({nc}) total action, relative change",
              abs(s1 - s0) / max(1.0, abs(s0)), 1e-8)
    for nc, beta in ((2, 2.2), (3, 5.7)):
        hb = Heatbath(action=ga.wilson_gauge_action(nc, beta))
        u = _warm_links(torch, lat, nc, 40 + nc, "cpu")
        cpu = hb.sweep(u, uniforms=_HostUniforms(torch, 7))
        gpu = hb.sweep(u.cuda(), uniforms=_HostUniforms(torch, 7))
        check(f"heatbath sweep SU({nc}) from host uniforms, card vs CPU", maxdiff(gpu.cpu(), cpu),
              bar)
    u = fields.hot_start(lat, 3, seed=44, dtype=torch.complex128, device="cpu")
    gf = gradientflow(3, nflow=5, eps=0.02)
    cpu, gpu = gf.flow(u), gf.flow(u.cuda())
    check("5 flow steps of 0.02, card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
    ug = u.cuda()
    for kind in ("plaquette", "clover", "improved"):
        check(f"topological charge ({kind}), card vs CPU",
              abs(float(observables.topological_charge(ug, kind))
                  - float(observables.topological_charge(u, kind))), bar)
    check("energy density, card vs CPU",
          abs(float(observables.energy_density(ug)) - float(observables.energy_density(u))), bar)
    err = max(abs(float(observables.wilson_loop_rt(ug, r, t))
                  - float(observables.wilson_loop_rt(u, r, t)))
              for r in range(1, 5) for t in range(1, 5))
    check("Wilson loops W(R, T), R, T <= 4, card vs CPU", err, bar)


def phase_quenched_path(torch):
    print("== 18. quenched path: run_lqcd_params, 16^3x32 SU(3) heatbath with overrelaxation, "
          "complex64, 4 steps, gauge observables, a Wilson pion correlator and the flow",
          flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.smearing.gradientflow import GradientFlow
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.heatbath import Heatbath

    maxcg = 3000
    methods = [
        {"methodname": "Plaquette"},
        {"methodname": "Polyakov_loop"},
        {"methodname": "Topological_charge",
         "kinds_of_topological_charge": ["plaquette", "clover"]},
        {"methodname": "Energy_density"},
        {"methodname": "Wilson_loop", "Rmax": 4, "Tmax": 4},
        {"methodname": "Pion_correlator", "MaxCGstep": maxcg,
         "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12}},
    ]
    flowed = [{"methodname": "Energy_density", "measure_every": 5},
              {"methodname": "Topological_charge", "measure_every": 5}]
    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="cold", update_method="Heatbath", quench=True,
        useOR=True, numOR=3, Nsteps=4, randomseed=5, verboselevel=1,
        measurement_methods=[{**m, "measure_every": 2} for m in methods],
        hasgradientflow=True, numflow=20, Nflow=1, eps_flow=0.02, measurements_for_flow=flowed,
    )
    times = {"heatbath sweep": [], "overrelaxation sweep": [], "flow step": []}
    records, plaqs, last = [], [], {}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.time() - t0)
            return out
        return wrapper

    def stepped(self, u, generator=None):
        out = step(self, u, generator)
        plaqs.append(float(ga.mean_plaquette(out[0])))
        last["u"] = out[0]
        return out

    def measured(cls):
        measure = cls.measure

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({"method": self.name, "itrj": itrj, "flow": additional_string,
                            "seconds": time.time() - t0, "line": line,
                            "solves": getattr(self, "solves", None)})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    step = Heatbath.step
    patches = [mock.patch.object(Heatbath, "sweep", timed(Heatbath.sweep, "heatbath sweep")),
               mock.patch.object(Heatbath, "overrelax",
                                 timed(Heatbath.overrelax, "overrelaxation sweep")),
               mock.patch.object(Heatbath, "step", stepped),
               mock.patch.object(GradientFlow, "flow", timed(GradientFlow.flow, "flow step"))]
    patches += [measured(c) for c in (scheduler.PlaquetteMeasurement,
                                      scheduler.PolyakovMeasurement,
                                      scheduler.TopologicalChargeMeasurement,
                                      scheduler.EnergyDensityMeasurement,
                                      scheduler.WilsonLoopMeasurement,
                                      scheduler.PionCorrelatorMeasurement)]
    from contextlib import ExitStack

    history = []
    with ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        torch.cuda.synchronize()
        wk.launches = 0
        t0 = time.time()
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                               history=history)
        torch.cuda.synchronize()
        total = time.time() - t0
        launched = wk.launches
    STATE["launches"].setdefault("wilson_hop_packed", {})["quenched"] = launched
    defect = float(sun.unitarity_defect(last["u"]))
    for key, ts in times.items():
        print(f"  {key}: {len(ts)} calls, median {statistics.median(ts):.4f} s, mean "
              f"{statistics.mean(ts):.4f} s  [{STATE['smi']}]", flush=True)
    for rec in history:
        print(f"  step {rec['itrj']}: {rec['seconds']:.3f} s (sweep + 3 overrelaxations), flow and "
              f"its measurements {rec['flow_seconds']:.3f} s, plaquette {plaqs[rec['itrj'] - 1]:.8f}",
              flush=True)
    per_method = {}
    for rec in records:
        kind = rec["method"] + (" (flowed)" if rec["flow"] else "")
        per_method.setdefault(kind, []).append(rec["seconds"])
        values = [float(x) for line in rec["line"].splitlines() for x in line.split("#")[0].split()]
        if not rec["flow"] or int(rec["flow"].split()[1]) % 10 == 0:
            print(f"  itrj {rec['itrj']} {rec['flow']}{rec['method']}: {rec['seconds']:.4f} s  "
                  f"{rec['line'].splitlines()[-1][:110]}", flush=True)
        if not all(math.isfinite(v) for v in values):
            fail(f"{kind} gave a value that is not finite: {rec['line']}")
        if rec["method"] == "Pion_correlator":
            iters = [c["iterations"] for c in rec["solves"]]
            print(f"    pion CG iterations {sum(iters)} in {len(iters)} solves (most "
                  f"{max(iters)})", flush=True)
            if max(iters) >= maxcg:
                fail(f"a pion correlator solve stopped at MaxCGstep {maxcg}")
    for kind, ts in sorted(per_method.items()):
        print(f"  {kind}: {len(ts)} calls, median {statistics.median(ts):.4f} s  "
              f"[{STATE['smi']}]", flush=True)
    print(f"  run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}, unitarity defect "
          f"{defect:.3e}; wilson_hop_packed launches {launched}", flush=True)
    STATE["checks"] += 1
    if len(plaqs) != 4 or not all(0.55 <= x <= 1.0 for x in plaqs):
        fail(f"a plaquette after a step lies outside 0.55-1.0: {plaqs}")
    STATE["checks"] += 1
    if defect > 1e-4:
        fail(f"unitarity defect {defect} after the run exceeds 1e-4")
    want = {(m["methodname"], i) for m in methods for i in (0, 2, 4)}
    if {(r["method"], r["itrj"]) for r in records if not r["flow"]} != want:
        fail("the quenched path did not measure every method at itrj 0, 2 and 4")
    flows = {}
    for rec in records:
        if rec["flow"] and rec["method"] == "Energy_density":
            flows.setdefault(rec["itrj"], []).append(
                float(rec["line"].split("#")[0].split()[-1]))
    STATE["checks"] += 1
    if sorted(flows) != [1, 2, 3, 4] or any(len(e) != 4 for e in flows.values()):
        fail(f"the flow did not measure E at flow steps 5, 10, 15 and 20 of every step: {flows}")
    # E is Re tr(W W) of the untraced clover sums over NV 6 NC 8, 1 on unit links: as the
    # flow smooths the links the field-strength part 1 - E falls
    for itrj, es in flows.items():
        print(f"  step {itrj}: flowed E at flow steps 5, 10, 15, 20: {es}", flush=True)
        if not all(1.0 - b < 1.0 - a for a, b in zip(es, es[1:])):
            fail(f"the flowed E of step {itrj} does not move toward 1: {es}")
    STATE["checks"] += 1
    if launched == 0:
        fail("the quenched path launched wilson_hop_packed no time")


def phase_plaquette_anchor(torch):
    print("== 19. the 12^4 plaquette anchor, short: beta = 6.0, complex64, cold start, 60 heatbath "
          "sweeps", flush=True)
    import shutil
    import tempfile

    import numpy as np

    from latticeqcd_torch import validation_plaq
    from latticeqcd_torch.analysis import read_measurement_series
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plaq_")
    history = []
    try:
        run_lqcd_params(validation_plaq.anchor_params(6.0, 60, tmp), make_dirs=True,
                        dtype=torch.complex64, device="cuda", history=history)
        itrj, plaq = read_measurement_series(os.path.join(tmp, "Plaquette.txt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = [r["seconds"] for r in history]
    window = plaq[itrj > 30, 0]
    mean = float(np.mean(window))
    ref = validation_plaq.JAX_CHAIN[6.0]["plaq"]
    print(f"  {len(history)} sweeps, {statistics.median(seconds):.4f} s per sweep (median; mean "
          f"{statistics.mean(seconds):.4f})  [{STATE['smi']}]", flush=True)
    print(f"  plaquette after sweeps 10, 20, 30: {plaq[itrj == 10, 0]}, {plaq[itrj == 20, 0]}, "
          f"{plaq[itrj == 30, 0]}; mean of sweeps 31-60 {mean:.6f} (JAX 12^4 chain {ref})",
          flush=True)
    STATE["checks"] += 1
    if len(window) != 30 or abs(mean - ref) > 0.0025:
        fail(f"the mean plaquette of sweeps 31-60, {mean}, is not within {ref} +- 0.0025")


# The improved action of phases 20 and 21: Iwasaki at beta_I = 2.6 in the reference's
# convention (the plaquette at c0 beta_I, the 1x2 rectangles through couplinglist at
# c1 beta_I, c0 = 3.648, c1 = -0.331), Wilson fermions at kappa 0.12 (< 1/8: D stays
# diagonally dominant on any unitary links) on 2 plaquette stout layers of rho 0.1,
# Omelyan with Sexton-Weingarten nsw 4, 5 steps of 0.04
IWASAKI = dict(beta=3.648 * 2.6, couplinglist=["rectangular"], couplingcoeff=[-0.331 * 2.6])
IMPROVED = dict(**IWASAKI, Dirac_operator="Wilson", hop=0.12, smearing_for_fermion="stout",
                stout_numlayers=2, stout_rho=[0.1], stout_loops=["plaquette"], MDscheme="Omelyan",
                SextonWeingargten=True, N_SextonWeingargten=4, MDsteps=5, dtau=0.04)


def phase_improved_agreement(torch):
    print("== 20. 4^4 complex128 improved actions: general gauge actions, stout smearing and the "
          "Sexton-Weingarten integrators, card against CPU and kernel path against plain path",
          flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga, wilsonline
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action
    from latticeqcd_torch.updates.heatbath import Heatbath
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    bar = BARS["complex128"]
    u = fields.hot_start(lat, 3, seed=60, dtype=torch.complex128, device="cpu")
    ug = u.to(dev)
    actions = {
        "Iwasaki": IWASAKI,
        "chair": dict(beta=5.5, couplinglist=["chair"], couplingcoeff=[-0.1]),
        "polyakov_t": dict(beta=5.5, couplinglist=["polyakov_t"], couplingcoeff=[0.2]),
        "coupling_loops": dict(beta=5.5, couplingcoeff=[0.3],
                               coupling_loops=[[[(0, 1), (1, 2), (0, -1), (1, -2)]]]),
    }
    for name, kw in actions.items():
        act = build_gauge_action(Params(L=lat, **kw))
        check(f"{name} staples, card vs CPU",
              max(maxdiff(ga.staples(act, ug, mu).cpu(), ga.staples(act, u, mu)) for mu in range(4)),
              bar)
        check(f"{name} force, card vs CPU", maxdiff(ga.force(act, ug).cpu(), ga.force(act, u)), bar)
    wilson = ga.wilson_gauge_action(3, 5.7)
    generic = ga.GaugeAction(3, wilson.terms)  # plaq_coeff 0: the generic path derivative
    check("generic plaquette staple vs the fused _plaquette_staple, card",
          max(maxdiff(ga.staples(generic, ug, mu), ga.staples(wilson, ug, mu)) for mu in range(4)),
          bar)
    net = stout_stack([0.1, 0.1], loop_names=("plaquette",))
    check("2-layer stout smear, card vs CPU", maxdiff(net.smear(ug).cpu(), net.smear(u)), bar)

    gen = torch.Generator(device=dev).manual_seed(61)
    forces = [("Wilson", WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-22))]
    forces += [(f"staggered Nf={nf}", StaggeredFermiAction(
        StaggeredDirac(mass=MASS, lattice=lat), nf=nf, eps_cg=1e-22)) for nf in (4, 2)]
    for name, fa in forces:
        _, phi = fa.sample_pseudofermion(net.smear(ug), generator=gen)
        before = _launch_counts()
        f_k = fa.force(ug, phi, smear_fn=net.smear)
        launched = _launch_counts() != before
        with _plain_kernels():
            f_p = fa.force(ug, phi, smear_fn=net.smear)
        if not launched:
            fail(f"the smeared {name} force launched no kernel")
        check(f"smeared {name} force, kernel vs plain (relative)",
              maxdiff(f_k, f_p) / float(f_p.abs().max()), 1e-10)

    # trajectories: scenario 7's action, the phase-21 action, staggered Nf=2 with stout + QPQ-SW
    scenario7 = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=20,
                    sexton_weingarten=True, nsw=10,
                    fermi_action=WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19))
    _trajectory_pair(torch, "scenario 7 (Wilson, QPQ-SW nsw 10)", scenario7, ug, 62)
    iwasaki = build_gauge_action(Params(L=lat, **IWASAKI))
    fa = WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-19)
    improved = HMC(action=iwasaki, dtau=0.04, md_steps=5, scheme="Omelyan",
                   sexton_weingarten=True, nsw=4, fermi_action=fa, smearing=net)
    _trajectory_pair(torch, "Iwasaki + 2 stout + Omelyan-SW", improved, ug, 63)
    stag = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10,
               sexton_weingarten=True, nsw=2, smearing=stout_stack([0.1]),
               fermi_action=StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=2,
                                                 eps_cg=1e-19))
    _trajectory_pair(torch, "staggered Nf=2 + 1 stout + QPQ-SW", stag, ug, 64)

    # reversibility of the phase-21 action: integrate, flip the momenta, integrate back
    draws = Draws.sample(improved, ug, torch.Generator(device=dev).manual_seed(65))
    _, phi = fa.sample_pseudofermion(net.smear(ug), normals=draws.xi)
    kw = dict(force_fermion=lambda uu: fa.force(uu, phi, smear_fn=net.smear), scheme="Omelyan",
              sexton_weingarten=True, nsw=4)
    force_g = lambda uu: ga.force(iwasaki, uu)
    u1, h1 = integrators.run_md(ug, draws.momentum(ug), force_g, 0.04, 5, **kw)
    u2, _ = integrators.run_md(u1, -h1, force_g, 0.04, 5, **kw)
    check("Iwasaki + 2 stout + Omelyan-SW MD reversibility max|dU|", maxdiff(u2, ug), 1e-8)

    # a plaquette + rectangle action's overrelaxation and heatbath: 4^4 colours of one site
    for nc, beta in ((2, 1.9), (3, 5.7)):
        act = ga.general_gauge_action(nc, [beta, -beta / 20.0],
                                      [wilsonline.make_loops_fromname("plaquette"),
                                       wilsonline.make_loops_fromname("rectangular")])
        hb = Heatbath(action=act)
        w = _warm_links(torch, lat, nc, 66 + nc, "cpu")
        cpu, gpu = hb.overrelax(w), hb.overrelax(w.to(dev))
        check(f"rectangle-action overrelaxation SU({nc}), card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
        s0, s1 = float(ga.action_value(act, w.to(dev))), float(ga.action_value(act, gpu))
        check(f"rectangle-action overrelaxation SU({nc}) total action, relative change",
              abs(s1 - s0) / max(1.0, abs(s0)), 1e-8)
        cpu = hb.sweep(w, uniforms=_HostUniforms(torch, 8))
        gpu = hb.sweep(w.to(dev), uniforms=_HostUniforms(torch, 8))
        check(f"rectangle-action heatbath sweep SU({nc}) from host uniforms, card vs CPU",
              maxdiff(gpu.cpu(), cpu), bar)


def phase_improved_path(torch):
    print("== 21. improved-action path: run_lqcd_params, 16^3x32 Iwasaki + 2-flavour Wilson on 2 "
          "stout layers, Omelyan with Sexton-Weingarten, complex64, 2 trajectories", flush=True)
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action, build_smearing
    from latticeqcd_torch.updates.hmc import HMC

    maxcg = 3000
    p = Params(L=MAIN, NC=3, initial="hot", update_method="HMC", quench=False, r=1.0,
               BoundaryCondition=(1, 1, 1, -1), Nsteps=2, eps=1e-12, MaxCGstep=maxcg,
               randomseed=3, verboselevel=2,
               measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}], **IMPROVED)
    last = {}
    step = HMC.step

    def stepped(self, u, generator=None, draws=None):
        out = step(self, u, generator, draws)
        last["u"] = out[0]
        return out

    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.launches = 0
    wk.site_launches.update(full=0, packed=0)
    with mock.patch.object(HMC, "step", stepped):
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                               history=history)
    torch.cuda.synchronize()
    launched, site = wk.launches, dict(wk.site_launches)
    peak = torch.cuda.max_memory_allocated()
    STATE["launches"].setdefault("wilson_hop_packed", {})["improved-action path"] = launched
    for rec in history:
        iters = [c["iterations"] for c in rec["cg"]]
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  {len(iters)} solves, CG "
              f"iterations per solve {statistics.mean(iters):.1f} (most {max(iters)})  dH "
              f"{rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  worst "
              f"verified residual/target {worst:.3g}  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if worst > 1.0 or max(iters) >= maxcg:
            fail("a CG reached MaxCGstep or returned a verified residual above its target")
        if not 0.0 < rec["plaq"] < 1.0:
            fail(f"plaquette {rec['plaq']} outside (0, 1)")
    defect = float(sun.unitarity_defect(last["u"]))
    print(f"  final plaquette {plaq:.8f}, unitarity defect {defect:.3e}; launches on the path: "
          f"wilson_hop_packed {launched} ({launched / len(history):.0f} per trajectory), "
          f"wilson_hop {site}; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    STATE["checks"] += 1
    if defect > 1e-4:
        fail(f"unitarity defect {defect} after the run exceeds 1e-4")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    if launched == 0:
        fail("the improved-action path launched wilson_hop_packed no time")
    if site["packed"]:
        fail("the improved-action path launched wilson_hop's packed mode")

    # B4's inputs on the run's links: the generic (Iwasaki) force against the fused (Wilson)
    # one, and one smearing forward + backward (a vector-Jacobian product, as in the force)
    u = last["u"]
    iwasaki, wilson = build_gauge_action(p), ga.wilson_gauge_action(3, p.beta)
    net = build_smearing(p)
    cot = sun.random_hermitian_momentum(u.shape[:-2], 3, dtype=u.dtype, device=u.device,
                                        generator=torch.Generator(device=u.device).manual_seed(4))

    def smear_vjp():
        uu = u.detach().requires_grad_(True)
        with torch.enable_grad():
            torch.autograd.grad(net.smear(uu), uu, grad_outputs=cot)

    ms = {name: _time_eager(torch, fn, n=10, warm=2) for name, fn in (
        ("Iwasaki force", lambda: ga.force(iwasaki, u)),
        ("Wilson force", lambda: ga.force(wilson, u)),
        ("stout smear forward + backward", smear_vjp))}
    print(f"  16^3x32 complex64, median of 10 eager calls between CUDA events: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" (Iwasaki/Wilson {ms['Iwasaki force'] / ms['Wilson force']:.2f}x)  [{STATE['smi']}]",
          flush=True)


PHASES = [phase_env, phase_build, phase_kernels, phase_timing,
          phase_trajectory_agreement, phase_main_path, phase_staggered_kernels,
          phase_staggered_timing, phase_staggered_trajectory_agreement, phase_staggered_main_path,
          phase_window, phase_window_timing, phase_measurement_agreement, phase_measurement_path,
          phase_disk, phase_anchor, phase_quenched_agreement, phase_quenched_path,
          phase_plaquette_anchor, phase_improved_agreement, phase_improved_path]

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
    print(f"kernels: {', '.join(k[0] for k in KERNELS)} ({STATE['checks']} checks; largest error "
          f"off the paths: the yardstick wilson_hop {STATE['err']['wilson_hop']:.3e}, the one-launch "
          f"staggered W {STATE['err']['staggered_w_fused']:.3e}); "
          f"launches per main path {STATE['launches']}; total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
