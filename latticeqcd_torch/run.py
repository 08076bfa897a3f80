"""CLI entry: python -m latticeqcd_torch.run parameters.toml [--f32|--f64] [--device DEV]
[--resume checkpoint.npz] [--profile tracedir]

Counterpart of latticeqcd_tpu/run.py. Runs on ``--device`` (default
``cuda``); there is no fall-back to another device. The parameter file is a
TOML file or a legacy ``.jl`` one (converted to the TOML beside it).
``--resume`` continues from the checkpoint.npz that a run with saveU_format
wrote, appending to its measurement files. ``--profile`` writes a
torch.profiler trace of the trajectories into tracedir/trace.json.
"""

import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    usage = ("usage: python -m latticeqcd_torch.run <parameters.toml> [--f64|--f32] "
             "[--device cuda] [--resume checkpoint.npz] [--profile tracedir]")
    dtype_name = "complex128"
    device = "cuda"
    resume = None
    profile_dir = None
    args = []
    it = iter(argv)
    for a in it:
        if a == "--f32":
            dtype_name = "complex64"
        elif a == "--f64":
            dtype_name = "complex128"
        elif a == "--device":
            device = next(it, None)
            if device is None:
                print(usage)
                return 2
        elif a == "--resume":
            resume = next(it, None)
            if resume is None:
                print(usage)
                return 2
        elif a == "--profile":
            profile_dir = next(it, None)
            if profile_dir is None:
                print(usage)
                return 2
        elif a.startswith("--"):
            print(f"unknown flag {a!r}")
            return 2
        else:
            args.append(a)
    if len(args) != 1:
        print(usage)
        return 2

    import torch

    from latticeqcd_torch.system.lqcd import run_lqcd_file

    t0 = time.time()
    plaq = run_lqcd_file(args[0], dtype=getattr(torch, dtype_name), device=device,
                         resume_checkpoint=resume, profile_dir=profile_dir)
    print(f"final plaquette = {plaq}")
    print(f"elapsed {time.time() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
