"""The wilson_hop_packed kernel body (csrc/wilson_hop_packed.cu), run on the CPU.

The CUDA kernel cannot run here, so its body is compiled with the host
C++ compiler against mock headers: one std::thread per CUDA thread, the
bulk copies a memcpy, the mbarrier wait and __syncthreads a
std::barrier over the block's threads. Blocks run one after another.
The result is held against the plain packed hop (hop_packed_reference)
at shapes where the brick wraps onto itself or does not divide the
lattice: X/2 = 1, extent-2 y and T (and every extent 2 at once),
extents 6 and 10, t cut into segments. On the card the kernel itself is
checked by the ``gpu`` test in test_torch_wilson.py and by chip_smoke.py.
"""

import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack, wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")

_MOCK_RUNTIME = """#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
using std::min;
"""
_MOCK_TMA = """#pragma once
#include <cuda_runtime.h>
inline void mbar_init(uint64_t*) {}
inline void mbar_arrive_expect_tx(uint64_t*, unsigned) {}
inline void bulk_copy_g2s(void* d, const void* s, unsigned n, uint64_t*) { std::memcpy(d, s, n); }
inline void mbar_wait(uint64_t*, unsigned) { block_barrier->arrive_and_wait(); }
"""
# run<R, BY, BZ, TSMAX, MINB>: the launch function's grid and block, one block at a time
_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB>
int run(int x2, int ly, int lz, int lt, int parity) {
  using V = typename Vec<R>::type;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ut(36 * vol), us(36 * vol), psi(12 * vol), out(12 * vol);
  for (auto* f : {&ut, &us, &psi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int blocks = x2 * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * ((lt + ts - 1) / ts);
  const int threads = 3 * BY * BZ * ts;
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    block_barrier = &bar;
    std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
    std::vector<std::thread> th;
    for (int tid = 0; tid < threads; ++tid)
      th.emplace_back([&, tid] {
        threadIdx = dim3{(unsigned)tid, 1, 1};
        blockIdx = dim3{(unsigned)b, 1, 1};
        wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB>(
            ut.data(), us.data(), psi.data(), out.data(), x2, ly, lz, lt, ts, parity);
      });
    for (auto& t : th) t.join();
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int parity = atoi(argv[5]), c128 = atoi(argv[6]), brick = atoi(argv[7]);
  if (brick == 0)  // the bricks of the C entry points
    return c128 ? run<double, WILSON_BRICK_C128>(x2, ly, lz, lt, parity)
                : run<float, WILSON_BRICK_C64>(x2, ly, lz, lt, parity);
  // 4 x 4 bricks and t segments of at most 4 sites
  return c128 ? run<double, 4, 4, 4, 1>(x2, ly, lz, lt, parity)
              : run<float, 4, 4, 4, 1>(x2, ly, lz, lt, parity);
}
"""
BRICKS = ["entry", "ragged"]


@pytest.fixture(scope="module")
def brick_body_exe(tmp_path_factory):
    """The kernel body of csrc/wilson_hop_packed.cu (the file up to its launch
    function), compiled for the CPU with g++ against the mock headers."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("brick")
    (d / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    (d / "tma.h").write_text(_MOCK_TMA)
    src = open(os.path.join(CSRC, "wilson_hop_packed.cu")).read()
    (d / "body.inc").write_text(src[:src.index("// Launch on a grid")] + "}  // namespace\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I", str(d),
                    "-I", CSRC, str(d / "harness.cpp"), "-o", str(exe)], check=True)
    return str(exe)


@pytest.mark.parametrize("brick", BRICKS)
@pytest.mark.parametrize("lat", [(2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4), (2, 2, 2, 2)],
                         ids=["x2is1", "y2T2", "y6z10", "all2"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_on_the_cpu(brick_body_exe, lat, dtype, brick):
    """The CUDA kernel's own body, thread by thread, against the plain packed
    hop, both target parities: with the bricks of the C entry points, and
    with 4 x 4 bricks over t segments of at most 4 sites, which exceed or do
    not divide y and z and cut t into ragged segments."""
    tdt = getattr(torch, dtype)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=sum(lat)))))
    u_e, u_o = (f.to(tdt) for f in eo_pack.pack_links(u, lat))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn(half + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(len(half)))
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        out = subprocess.run(
            [brick_body_exe, *map(str, half), str(parity), str(int(dtype == "complex128")),
             str(BRICKS.index(brick))],
            input=b"".join(to_numpy(f).tobytes() for f in (u_t, u_s, x)),
            capture_output=True, check=True)
        got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(x.shape)
        ref = to_numpy(wk.hop_packed_reference(u_t, u_s, x, parity))
        assert float(np.abs(got - ref).max()) < (1e-12 if dtype == "complex128" else 1e-5)
