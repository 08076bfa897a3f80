"""Time wilson_hop_packed's kernel without the halo mode from two source trees, in turns, on one card.

    python3 scripts/ab_hop_packed.py PARENT_TREE [--turns N]

Builds PARENT_TREE's and this tree's latticeqcd_torch/csrc/wilson_hop_packed.cu with the
port's nvcc flags into two libraries, and times their entry points wilson_hop_brick_c64 and
wilson_hop_brick_c128 (one chain; the same C signature in both trees) at 16^3x32, target
parity 0, cold: three input sets taken in turn inside a CUDA graph (chip_smoke._time_device),
in the order parent, change, change, parent, N turns. Prints each side's times, their medians
and the change's ratio to the parent, with the card's name and power limit.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(tree, out_dir, tag):
    from latticeqcd_torch import _nvcc

    src = os.path.join(tree, "latticeqcd_torch", "csrc", "wilson_hop_packed.cu")
    lib = os.path.join(out_dir, f"libwilson_hop_packed_{tag}.so")
    proc = subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-o", lib, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(lib)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    parent, turns = argv[0], 4
    if "--turns" in argv:
        turns = int(argv[argv.index("--turns") + 1])
    import torch

    import chip_smoke
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 1
    smi = chip_smoke.nvidia_smi()
    lat = chip_smoke.MAIN
    half = (lat[0] // 2,) + lat[1:]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"parent": build(parent, tmp, "parent"), "change": build(ROOT, tmp, "change")}
        for dtype, suffix in ((torch.complex64, "c64"), (torch.complex128, "c128")):
            sets = []
            for seed in (7, 8, 9):
                u, _, g = chip_smoke._fields(torch, lat, dtype, seed)
                x = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
                sets.append((*eo_pack.pack_links(u, lat), x))
            calls = {}
            for side, lib in libs.items():
                fn = getattr(lib, f"wilson_hop_brick_{suffix}")
                fn.argtypes = wk._ENTRY_POINTS["wilson_hop_packed"]["wilson_hop_brick"]
                fn.restype = ctypes.c_int

                def call(s, fn=fn):
                    out = torch.empty_like(s[2])
                    err = fn(s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(), out.data_ptr(),
                             *s[2].shape[:4], 0, 1, 0, 0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    return out

                calls[side] = [lambda s=s, call=call: call(s) for s in sets]
            a = calls["parent"][0]()
            b = calls["change"][0]()
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise RuntimeError("the two trees' kernels disagree")
            times = {"parent": [], "change": []}
            for _ in range(turns):
                for side in ("parent", "change", "change", "parent"):
                    times[side].append(chip_smoke._time_device(torch, calls[side]) * 1e3)
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"{suffix}: parent {' '.join(f'{t:.2f}' for t in times['parent'])} us, change "
                  f"{' '.join(f'{t:.2f}' for t in times['change'])} us; medians {med['parent']:.2f} "
                  f"and {med['change']:.2f} us, change / parent {med['change'] / med['parent']:.4f}"
                  f"; outputs bitwise equal [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
