"""Multi-process entry:

    python -m latticeqcd_torch.multirun params.toml [PE1 PE2 PE3 PE4]
        [--coordinator host:port --nprocs N --procid I] [--backend gloo|nccl]
        [--device DEV] [--f32|--f64] [--report DIR]

Counterpart of latticeqcd_tpu/multirun.py and of the reference's
mpirun.jl: one process per block of a 4D process grid PE1 x PE2 x PE3 x
PE4 (parallel/mesh.py; default_pes of the process count when not
given), each running the same run loop on its block
(system/lqcd.py ``run_lqcd_file(..., grid=...)``). Launch one copy per
rank with --coordinator/--nprocs/--procid, or under torchrun, which sets
the env:// variables. With more than one process the backend is named:
gloo (messages through host memory; the CPU, or several ranks on one
card) or nccl (one card per rank). The device is ``cuda:<local rank>``
unless --device names one (``cpu`` for a CPU run). Only rank 0 prints
the run's output and writes files; it prints the grid, the backend and
the process count, then the final plaquette and the elapsed time. With
--report DIR every rank writes DIR/rank<r>.json (its grid place, its
trajectories' seconds, dH, accept decisions and solver records, the final
plaquette, the SHA-256 of the run's generator state after the last step, and
its launches of the packed Wilson hop, the staggered hop and W and the full
Wilson D, each kernel's halo mode apart) and DIR/rank<r>_u.npy (its block of
the final links).
"""

import json
import os
import sys
import time

USAGE = ("usage: python -m latticeqcd_torch.multirun <params.toml> [PE1 PE2 PE3 PE4] "
         "[--coordinator host:port --nprocs N --procid I] [--backend gloo|nccl] "
         "[--device DEV] [--f32|--f64] [--report DIR]")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = {"coordinator": None, "nprocs": None, "procid": None, "backend": None,
            "device": None, "report": None}
    dtype_name = "complex128"
    pos = []
    it = iter(argv)
    for a in it:
        if a in ("--f32", "--f64"):
            dtype_name = "complex64" if a == "--f32" else "complex128"
        elif a.startswith("--") and a[2:] in opts:
            opts[a[2:]] = next(it, None)
            if opts[a[2:]] is None:
                print(USAGE)
                return 2
        elif a.startswith("--"):
            print(f"unknown flag {a!r}")
            return 2
        else:
            pos.append(a)
    if len(pos) not in (1, 5):
        print(USAGE)
        return 2

    import torch

    from latticeqcd_torch.parallel import mesh
    from latticeqcd_torch.system.lqcd import run_lqcd_file

    launched = opts["coordinator"] is not None or "WORLD_SIZE" in os.environ
    nprocs = int(opts["nprocs"] or os.environ.get("WORLD_SIZE", 1))
    if launched and nprocs > 1:
        if opts["backend"] is None:
            print("more than one process: name the backend with --backend gloo|nccl")
            return 2
        mesh.init_process_grid(opts["backend"], opts["coordinator"], opts["nprocs"],
                               opts["procid"])
    pes = tuple(int(x) for x in pos[1:5]) if len(pos) == 5 else mesh.default_pes(nprocs)
    if len(pes) != 4 or pes[0] * pes[1] * pes[2] * pes[3] != nprocs:
        print(f"PEs {pes} do not multiply to the {nprocs} process(es)")
        mesh.close_process_grid()
        return 2
    mesh.set_PEs(pes)
    device = opts["device"] or f"cuda:{mesh.get_local_rank()}"
    backend = opts["backend"] if nprocs > 1 else "none (one process)"
    mesh.println_rank0(f"# process grid {pes} over {nprocs} process(es), backend {backend}, "
                       f"device {device}")
    try:
        t0 = time.time()
        history, final = [], {}
        plaq = run_lqcd_file(pos[0], dtype=getattr(torch, dtype_name), device=device,
                             grid=pes if nprocs > 1 else None, history=history, final=final)
        mesh.println_rank0(f"final plaquette = {plaq}")
        mesh.println_rank0(f"elapsed {time.time() - t0:.2f} s")
        if opts["report"] is not None:
            _report(opts["report"], pes, device, plaq, history, final)
    finally:
        mesh.close_process_grid()
    return 0


def _report(outdir, pes, device, plaq, history, final):
    import hashlib

    import numpy as np

    from latticeqcd_torch.convert import to_numpy
    from latticeqcd_torch.ops.dirac import staggered_kernel, wilson_kernel, wilson_window_kernel
    from latticeqcd_torch.parallel import mesh

    rank = mesh.get_myrank()
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "nprocs": mesh.get_nprocs(), "pes": list(pes),
                   "device": str(device), "plaquette": plaq, "history": history,
                   "generator_sha256": hashlib.sha256(
                       final["generator"].get_state().numpy().tobytes()).hexdigest(),
                   "launches": {"wilson_hop_packed": wilson_kernel.launches,
                                "wilson_hop_packed_halo": wilson_kernel.halo_launches,
                                "staggered_w": staggered_kernel.launches,
                                "staggered_w_halo": staggered_kernel.halo_launches,
                                "wilson_window": wilson_window_kernel.launches,
                                "wilson_window_halo": wilson_window_kernel.halo_launches}}, f)
    np.save(os.path.join(outdir, f"rank{rank}_u.npy"), to_numpy(final["u"]))


if __name__ == "__main__":
    raise SystemExit(main())
