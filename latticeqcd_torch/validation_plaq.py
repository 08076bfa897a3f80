"""Physics anchor: the SU(3) Wilson-action plaquette on 12^4 from the heatbath.

The port's counterpart of scripts/plaq12_fv.py, which ran the JAX
package's heatbath on 12^4 (complex64 storage, cold start, 200 sweeps to
thermalise, then 400 measured, one per sweep) and reproduced the
published infinite-volume plaquette to within 1.3e-4
(PERF_CAPTURE/plaq12_fv.jsonl). This module runs the same chain through
the port's own ``run_lqcd_params``: update_method Heatbath without
overrelaxation, Plaquette measured every sweep, never reprojected (as
the JAX chain never was; the unitarity defect is logged at the end). It
reads the measurement file back, drops the trajectory-0 line and the
thermalisation sweeps, and prints one JSON line per beta: the mean with
its Wolff tau_int error, tau_int, n_meas, the seconds per sweep (host
clock ending in a device sync), the JAX chain's value and the combined
sigma from it, and the card's name and power limit. The draws come from
a torch.Generator seeded with --seed.

Usage: python -m latticeqcd_torch.validation_plaq 6.0 [5.7] [--therm N] [--meas N]
           [--seed S] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import torch

from latticeqcd_torch.analysis import autocorrelation, read_measurement_series
from latticeqcd_torch.io import load_u
from latticeqcd_torch.ops import sun
from latticeqcd_torch.system.lqcd import run_lqcd_params
from latticeqcd_torch.system.params import Params
from latticeqcd_torch.validation_pbp import card

LAT = (12, 12, 12, 12)
# The JAX package's chains (PERF_CAPTURE/plaq12_fv.jsonl: mean, Wolff error, tau_int) and
# the published infinite-volume values (scripts/plaq12_fv.py:33).
JAX_CHAIN = {6.0: {"plaq": 0.593745, "err": 9e-05, "tau_int": 2.07},
             5.7: {"plaq": 0.549062, "err": 0.000201, "tau_int": 5.65}}
PUBLISHED = {5.7: 0.549195, 6.0: 0.593679}


def anchor_params(beta: float, nsweeps: int, outdir: str, seed: int = 17) -> Params:
    """The anchor's run: 12^4 SU(3) at beta, cold start, nsweeps heatbath sweeps,
    the plaquette after each, the last links saved (NPZ), the log in outdir."""
    return Params(
        L=LAT, NC=3, beta=beta, initial="cold", update_method="Heatbath", quench=True,
        useOR=False, Nsteps=nsweeps, randomseed=seed, reunitarize_every=0, verboselevel=1,
        saveU_format="NPZ", saveU_dir=outdir, saveU_every=max(nsweeps, 1),
        log_dir=outdir, logfile="run.log", measuredir=outdir,
        measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
    )


def run_point(beta: float, n_therm: int, n_meas: int, outdir: str, seed: int = 17,
              device="cuda") -> dict:
    os.makedirs(outdir, exist_ok=True)
    history: list = []
    t0 = time.time()
    run_lqcd_params(anchor_params(beta, n_therm + n_meas, outdir, seed), make_dirs=True,
                    dtype=torch.complex64, device=device, history=history)
    wall = time.time() - t0
    itrj, plaq = read_measurement_series(os.path.join(outdir, "Plaquette.txt"))
    series = plaq[itrj > n_therm, 0]
    mean, err, tau, _ = autocorrelation(series)
    final = load_u(os.path.join(outdir, f"conf_{n_therm + n_meas:08d}.npz"), torch.complex64,
                   device)
    seconds = [r["seconds"] for r in history]
    ref = JAX_CHAIN.get(beta)
    out = {
        "beta": beta, "plaq": mean, "err": err, "tau_int": tau, "n_meas": len(series),
        "n_therm": n_therm, "jax": ref, "published": PUBLISHED.get(beta),
        "s_per_sweep_median": statistics.median(seconds) if seconds else None,
        "s_per_sweep_mean": statistics.mean(seconds) if seconds else None,
        "unitarity_defect_end": float(sun.unitarity_defect(final)),
        "lattice": "x".join(map(str, LAT)), "seed": seed, "wall_s": wall,
        "device": card() if torch.device(device).type == "cuda" else "cpu",
    }
    if ref is not None:
        out["combined_sigma"] = (mean - ref["plaq"]) / math.hypot(err, ref["err"])
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--therm": "200", "--meas": "400", "--seed": "17", "--out": "validation_plaq_out",
            "--device": "cuda"}
    betas = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        elif a.startswith("--"):
            print(f"unknown flag {a!r}")
            return 2
        else:
            betas.append(float(a))
    for beta in betas or [6.0]:
        out = run_point(beta, int(opts["--therm"]), int(opts["--meas"]),
                        os.path.join(opts["--out"], f"beta{beta:g}"), seed=int(opts["--seed"]),
                        device=opts["--device"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
