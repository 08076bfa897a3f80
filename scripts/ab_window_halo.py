"""Time wilson_window's halo mode against its mask-0 kernel, from one or more source trees, on one card.

    python3 scripts/ab_window_halo.py TREE [TREE ...] [--turns N] [--r R]

Builds each TREE's latticeqcd_torch/csrc/wilson_window.cu with the port's nvcc flags into its
own library and times, at complex64 and complex128, its halo entry point
(wilson_window_halo_c64/_c128) on block 0 of 16^3x32 cut in two along x and along t, beside
its mask-0 entry point (wilson_window_c64/_c128) on a block of the same shape: warm medians
of chip_smoke._time_device (12 calls in a CUDA graph, 20 replays), the trees in turns, N
turns (default 3). Prints every time, the medians and each tree's halo/mask-0 ratio, with the
card's name and power limit. With --r R the same for the r mode's entry points
(wilson_window_halo_r_* and wilson_window_r_*) at Wilson r = R.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KAPPA = 0.13


def build(tree, out_dir, tag):
    from latticeqcd_torch import _nvcc

    src = os.path.join(tree, "latticeqcd_torch", "csrc", "wilson_window.cu")
    lib = os.path.join(out_dir, f"libwilson_window_{tag}.so")
    proc = subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I",
                           os.path.join(tree, "latticeqcd_torch", "csrc"), "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "spill" in line or "registers" in line:
            print(f"  {tag} ptxas: {line.strip()}")
    return ctypes.CDLL(lib)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    turns, r = 3, None
    if "--turns" in argv:
        i = argv.index("--turns")
        turns = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "--r" in argv:
        i = argv.index("--r")
        r = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__)
        return 2
    import torch

    import chip_smoke
    from latticeqcd_torch.parallel import mesh

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 1
    smi = chip_smoke.nvidia_smi()
    lat = chip_smoke.MAIN
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # the r mode's entry points take r after kappa
    mode, r_args, r_type = ("_r", (r,), [cd]) if r is not None else ("", (), [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for i, tree in enumerate(argv):
            tag = f"{i}:{os.path.basename(os.path.abspath(tree))}"
            libs[tag] = build(tree, tmp, str(i))
        for dtype, suffix in ((torch.complex64, "c64"), (torch.complex128, "c128")):
            u, psi, g = chip_smoke._fields(torch, lat, dtype, seed=51)
            for cut, pes in (("x", (2, 1, 1, 1)), ("t", (1, 1, 1, 2))):
                grid = mesh.ProcessGrid(pes, lat, rank=0, device=u.device)
                u_b, psi_b = grid.block(u, 1).contiguous(), grid.block(psi).contiguous()
                faces, links = chip_smoke._block_faces(grid, psi, u)
                mu = pes.index(2)
                ptrs = [None] * 12
                ptrs[mu], ptrs[4 + mu], ptrs[8 + mu] = (faces[mu][0].data_ptr(),
                                                        faces[mu][1].data_ptr(),
                                                        links[mu].data_ptr())
                ptr_array = (ctypes.c_void_p * 12)(*ptrs)
                out = torch.empty_like(psi_b)
                stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731  (a graph's)
                times = {(tag, mode): [] for tag in libs for mode in ("halo", "mask 0")}
                outs = {}
                calls = {}
                for tag, lib in libs.items():
                    halo = getattr(lib, f"wilson_window_halo{mode}_{suffix}")
                    halo.argtypes = [vp, vp, vp, ci, ci, ci, ci, cd] + r_type + [ci, vp, vp]
                    plain = getattr(lib, f"wilson_window{mode}_{suffix}")
                    plain.argtypes = [vp, vp, vp, ci, ci, ci, ci, cd] + r_type + [vp]
                    calls[(tag, "halo")] = lambda h=halo: h(
                        u_b.data_ptr(), psi_b.data_ptr(), out.data_ptr(), *psi_b.shape[:4], KAPPA,
                        *r_args, 1 << mu, ptr_array, stream())
                    calls[(tag, "mask 0")] = lambda p=plain: p(
                        u_b.data_ptr(), psi_b.data_ptr(), out.data_ptr(), *psi_b.shape[:4], KAPPA,
                        *r_args, stream())
                    calls[(tag, "halo")]()
                    torch.cuda.synchronize()
                    outs[tag] = out.clone()
                order = list(calls)
                for turn in range(turns):
                    for key in (order if turn % 2 == 0 else order[::-1]):
                        times[key].append(chip_smoke._time_device(torch, calls[key]))
                same = all(torch.equal(o, outs[next(iter(outs))]) for o in outs.values())
                for tag in libs:
                    h = statistics.median(times[(tag, "halo")])
                    p = statistics.median(times[(tag, "mask 0")])
                    print(f"{suffix}{mode} cut {cut} block {tuple(psi_b.shape[:4])} tree {tag}: "
                          f"halo {[round(t * 1e3, 2) for t in times[(tag, 'halo')]]} us (median "
                          f"{h * 1e3:.2f}), mask 0 {[round(t * 1e3, 2) for t in times[(tag, 'mask 0')]]}"
                          f" us (median {p * 1e3:.2f}), halo/mask 0 {h / p:.3f} [{smi}]",
                          flush=True)
                print(f"{suffix} cut {cut}: the trees' halo outputs bitwise equal: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
