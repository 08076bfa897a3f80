"""Physics anchor: continue the thermalised Nf=4 staggered chains and measure <pbp>.

The port's counterpart of scripts/validation_pbp_beta.py:61-140. That
script ran the JAX package's chains on 12^3x8 at m = 0.025 (the MT(c)
collaboration's lattice and mass, fig. 2b of 10.1016/0370-2693(89)90447-4)
and committed their states after thermalisation as
PERF_CAPTURE/pbp{56,53}_ckpt.npz (key ``u``, complex64). This module
continues such a chain through the port's own ``run_lqcd_params``,
with an NPZ file start and the JAX run's action: Wilson gauge action at
beta, Nf=4 staggered fermions at m = 0.025, QPQ leapfrog with 35 MD steps
of 1/35, eps_cg 1e-10, MaxCGstep 4000, complex64, never reprojected
(reunitarize_every = 0, as the JAX chain never was; the unitarity defect
is logged at the end). It measures Chiral_condensate with Nr=2 every 2
trajectories (eps 1e-9, MaxCGstep 4000), the trajectory-0 measurement on
the starting state included, reads the measurement file back and prints
one JSON line per beta: the mean with its Wolff tau_int error, tau_int,
n_meas, acceptance, the mean dH and <exp(-dH)>, seconds and CG
iterations per trajectory, the JAX chain's value, and the card's name
and power limit. Nothing is
discarded: the starting state is thermalised. The draws come from a
torch.Generator seeded with --seed, since the JAX chain's jax.random
stream cannot be continued in torch.

Usage: python -m latticeqcd_torch.validation_pbp 5.6 [5.3] --traj N
           [--seed S] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from latticeqcd_torch.analysis import autocorrelation, read_measurement_series
from latticeqcd_torch.io import load_u
from latticeqcd_torch.ops import sun
from latticeqcd_torch.system.lqcd import run_lqcd_params
from latticeqcd_torch.system.params import Params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAT = (12, 12, 12, 8)
MASS = 0.025
NF = 4
MD_STEPS = 35
# The JAX package's chains (PERF_CAPTURE/pbp_beta.jsonl lines 5 and 6: mean, Wolff error,
# tau_int, acceptance) and the published curve (scripts/validation_pbp_beta.py:44-52).
JAX_CHAIN = {5.6: {"pbp": 0.13531, "err": 0.00052, "tau_int": 2.56, "acceptance": 0.4},
             5.3: {"pbp": 0.19862, "err": 0.002, "tau_int": 3.52, "acceptance": 0.141}}
PUBLISHED = {5.6: 0.13783581497147912, 5.3: 0.2109864936891166}


def checkpoint_path(beta: float) -> str:
    """The committed state of the JAX chain at beta (pbp56_ckpt.npz for 5.6)."""
    return os.path.join(ROOT, "PERF_CAPTURE", f"pbp{beta:g}".replace(".", "") + "_ckpt.npz")


def anchor_params(beta: float, ntraj: int, outdir: str, seed: int = 11) -> Params:
    """The anchor's run: an NPZ file start from the JAX chain's state at beta,
    ntraj trajectories, the links and a checkpoint saved after the last one,
    measurements and the log in outdir."""
    staggered = {"Dirac_operator": "Staggered", "mass": MASS, "Nf": NF}
    return Params(
        L=LAT, NC=3, beta=beta, initial=checkpoint_path(beta), loadU_format="NPZ",
        update_method="HMC", quench=False, Dirac_operator="Staggered", mass=MASS, Nf=NF,
        QPQ=True, dtau=1.0 / MD_STEPS, MDsteps=MD_STEPS, eps=1e-10, MaxCGstep=4000,
        Nsteps=ntraj, randomseed=seed, reunitarize_every=0, verboselevel=1,
        saveU_format="NPZ", saveU_dir=outdir, saveU_every=max(ntraj, 1),
        log_dir=outdir, logfile="run.log", measuredir=outdir,
        measurement_methods=[
            {"methodname": "Plaquette", "measure_every": 1},
            {"methodname": "Chiral_condensate", "measure_every": 2, "Nr": 2, "eps": 1e-9,
             "MaxCGstep": 4000, "fermion_parameters": staggered},
        ],
    )


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except OSError:
        return "not measured (no nvidia-smi)"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def run_point(beta: float, ntraj: int, outdir: str, seed: int = 11, device="cuda") -> dict:
    os.makedirs(outdir, exist_ok=True)
    history: list = []
    t0 = time.time()
    run_lqcd_params(anchor_params(beta, ntraj, outdir, seed), make_dirs=True,
                    dtype=torch.complex64, device=device, history=history)
    wall = time.time() - t0
    _, pbp = read_measurement_series(os.path.join(outdir, "Chiral_condensate.txt"))
    _, plaq = read_measurement_series(os.path.join(outdir, "Plaquette.txt"))
    mean, err, tau, _ = autocorrelation(pbp[:, 0])
    last = os.path.join(outdir, f"conf_{ntraj:08d}.npz") if ntraj else checkpoint_path(beta)
    final = load_u(last, torch.complex64, device)
    seconds = [r["seconds"] for r in history]
    iters = [sum(c["iterations"] for c in r["cg"]) for r in history]
    dh = [r["dH"] for r in history]
    ref = JAX_CHAIN.get(beta)
    out = {
        "beta": beta, "pbp": mean, "err": err, "tau_int": tau, "n_meas": len(pbp),
        "acceptance": sum(r["accepted"] for r in history) / max(len(history), 1),
        "n_traj": len(history),
        # Creutz's equality <exp(-dH)> = 1 holds for an area-preserving, reversible MD
        "dH_mean": statistics.mean(dh) if dh else None,
        "exp_minus_dH_mean": statistics.mean(math.exp(-x) for x in dh) if dh else None,
        "s_per_traj_median": statistics.median(seconds) if seconds else None,
        "s_per_traj_mean": statistics.mean(seconds) if seconds else None,
        "cg_iters_per_traj": statistics.mean(iters) if iters else None,
        "cg_solves_per_traj": statistics.mean(len(r["cg"]) for r in history) if history else None,
        "max_cg_iters": max((c["iterations"] for r in history for c in r["cg"]), default=0),
        "plaq_min": float(plaq[:, 0].min()), "plaq_max": float(plaq[:, 0].max()),
        "unitarity_defect_end": float(sun.unitarity_defect(final)),
        "jax": ref, "published": PUBLISHED.get(beta),
        "lattice": "x".join(map(str, LAT)), "mass": MASS, "nf": NF, "seed": seed,
        "wall_s": wall, "device": card() if torch.device(device).type == "cuda" else "cpu",
    }
    if ref is not None:
        out["combined_sigma"] = (mean - ref["pbp"]) / math.hypot(err, ref["err"])
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--traj": "100", "--seed": "11", "--out": "validation_pbp_out", "--device": "cuda"}
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
    for beta in betas or [5.6]:
        out = run_point(beta, int(opts["--traj"]), os.path.join(opts["--out"], f"beta{beta:g}"),
                        seed=int(opts["--seed"]), device=opts["--device"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
