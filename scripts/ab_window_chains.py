"""Time wilson_window's chain axis from one or more source trees, on one card.

    python3 scripts/ab_window_chains.py TREE [TREE ...] [--turns N] [--r R]

Builds each TREE's latticeqcd_torch/csrc/wilson_window.cu with the port's nvcc flags into its
own library (printing what ptxas says of registers and spills) and times, at complex64 and
complex128, its chains entry point (wilson_window_chains_c64/_c128) on 16 chains at 8^4 and 4^4
and on 2 chains at 16^3x32: cold medians of chip_smoke._time_device (12 calls in a CUDA graph
taking three input sets in turn, 20 replays), the trees in turns, N turns (default 3), each
beside the least-bytes bound (480 B a site at complex64, 960 at complex128, over 3.35 TB/s).
Prints every time, the medians, the share of the bound and whether the trees' outputs are
bitwise equal, with the card's name and power limit. With --r R the r mode's entry points
(wilson_window_chains_r_*) at Wilson r = R.
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
SHAPES = [((8, 8, 8, 8), 16), ((4, 4, 4, 4), 16), ((16, 16, 16, 32), 2)]


def build(tree, out_dir, tag):
    from latticeqcd_torch import _nvcc

    src = os.path.join(tree, "latticeqcd_torch", "csrc", "wilson_window.cu")
    lib = os.path.join(out_dir, f"libwilson_window_{tag}.so")
    proc = subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I",
                           os.path.join(tree, "latticeqcd_torch", "csrc"), "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        # the chain instantiations: the kernel's last template argument (CHAINS) true
        if "Compiling entry function" in line and "ELb1EEEv" in line:
            print(f"  {tag} ptxas: {line.strip()}")
            for nxt in lines[i + 1:i + 3]:
                print(f"  {tag} ptxas:   {nxt.strip()}")
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
    from latticeqcd_torch.ops import fields

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 1
    smi = chip_smoke.nvidia_smi()
    vp, ci, ll, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    mode, r_args, r_type = ("_r", (r,), [cd]) if r is not None else ("", (), [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for i, tree in enumerate(argv):
            tag = f"{i}:{os.path.basename(os.path.abspath(tree))}"
            libs[tag] = build(tree, tmp, str(i))
        for dtype, suffix in ((torch.complex64, "c64"), (torch.complex128, "c128")):
            for lat, n in SHAPES:
                vol = n * lat[0] * lat[1] * lat[2] * lat[3]
                bound = (2 if dtype == torch.complex128 else 1) * 480 * vol / 3.35e12 * 1e3
                sets = []
                for seed in (1, 2, 3):
                    u = chip_smoke._window_chain_links(
                        torch, fields.hot_start(lat, 3, seed=seed, device="cuda"), dtype, n)
                    g = torch.Generator(device="cuda").manual_seed(seed)
                    psi = torch.randn((n,) + lat + (4, 3), dtype=dtype, device="cuda",
                                      generator=g)
                    sets.append((u, psi, torch.empty_like(psi)))
                stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731  (a graph's)
                calls, outs = {}, {}
                for tag, lib in libs.items():
                    fn = getattr(lib, f"wilson_window_chains{mode}_{suffix}")
                    fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ll, ll, cd] + r_type + [vp]
                    calls[tag] = [lambda s=s, f=fn: f(
                        s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(), *lat, n, s[0][0].numel(),
                        s[1][0].numel(), KAPPA, *r_args, stream()) for s in sets]
                    err = calls[tag][0]()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{tag} wilson_window_chains{mode}_{suffix}: error {err}")
                    outs[tag] = sets[0][2].clone()
                times = {tag: [] for tag in libs}
                order = list(libs)
                for turn in range(turns):
                    for tag in (order if turn % 2 == 0 else order[::-1]):
                        times[tag].append(chip_smoke._time_device(torch, calls[tag]))
                same = all(torch.equal(o, outs[order[0]]) for o in outs.values())
                for tag in libs:
                    t = statistics.median(times[tag])
                    print(f"{suffix}{mode} {n} chains {'x'.join(map(str, lat))} tree {tag}: "
                          f"{[round(x * 1e3, 2) for x in times[tag]]} us (median {t * 1e3:.2f}), "
                          f"bound {bound * 1e3:.2f} us ({100 * bound / t:.1f}%) [{smi}]", flush=True)
                print(f"{suffix}{mode} {n} chains {'x'.join(map(str, lat))}: the trees' outputs "
                      f"bitwise equal: {same}", flush=True)
                del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
