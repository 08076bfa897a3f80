"""The staggered_w_fused kernel body (csrc/staggered_w_fused.cu), run on the CPU.

The CUDA kernel cannot run here, so its body is compiled with the host
C++ compiler against mock headers: the CUDA runtime mock of
test_torch_hop_packed.py, and a cluster mock in which all blocks of a
cluster run at once (one std::thread per CUDA thread), cluster.sync() is
a std::barrier over all of their threads and map_shared_rank points
into the peer block's shared-memory array. Clusters run one after
another. The result is held against the plain W (staggered_w_reference)
at shapes where the tile wraps onto itself or does not divide the
lattice: X/2 = 1, extent-2 y, z and T (and every extent 2 at once),
extents 6 and 10, t cut into segments; with the tiles of the C entry
points, a one-block cluster of a ragged block and a 12-block cluster of
ragged blocks. On the card the kernel itself is checked by the ``gpu``
test in test_torch_staggered.py and by chip_smoke.py.
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
from latticeqcd_torch.ops.dirac import eo_pack, staggered_kernel as sk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from test_torch_hop_packed import _MOCK_RUNTIME  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")
MASS = 0.5

_MOCK_CLUSTER = """#pragma once
#include <barrier>
#include <cuda_runtime.h>
inline thread_local unsigned char* mock_smem = nullptr;  // this block's shared memory
inline thread_local unsigned mock_rank = 0;              // this block's rank in its cluster
inline unsigned char** mock_cluster_smem = nullptr;      // every block's, by rank
inline std::barrier<>* mock_cluster_barrier = nullptr;   // over all threads of the cluster
inline unsigned char* dynamic_smem() { return mock_smem; }
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return mock_rank; }
  void sync() const { mock_cluster_barrier->arrive_and_wait(); }
  template <typename T>
  T* map_shared_rank(T* p, int r) const {
    return reinterpret_cast<T*>(mock_cluster_smem[r] +
                                (reinterpret_cast<unsigned char*>(p) - mock_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""
# run<R, BX, BY, BZ, CX, CY, CZ, TSMAX, MINB>: the launch function's grid, one cluster at a time
_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include "body.inc"
template <typename R, int BX, int BY, int BZ, int CX, int CY, int CZ, int TSMAX, int MINB>
int run(int x2, int ly, int lz, int lt, double m2) {
  using V = typename Vec<R>::type;
  constexpr int C = CX * CY * CZ, ROWS = BX * BY * BZ;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ue(36 * vol), uo(36 * vol), phi(3 * vol), out(3 * vol);
  for (auto* f : {&ue, &uo, &phi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int nh = 2 * ts * (BY * BZ + BX * BZ + BX * BY) + 2 * ROWS;
  const size_t n = 18 * ROWS * ts + 3 * nh;
  const int clusters = ((x2 + CX * BX - 1) / (CX * BX)) * ((ly + CY * BY - 1) / (CY * BY)) *
                       ((lz + CZ * BZ - 1) / (CZ * BZ)) * ((lt + ts - 1) / ts);
  const int threads = 3 * ROWS * ts;
  std::vector<std::vector<V>> smem(C, std::vector<V>(n));
  std::vector<unsigned char*> bases(C);
  for (int r = 0; r < C; ++r) bases[r] = reinterpret_cast<unsigned char*>(smem[r].data());
  for (int k = 0; k < clusters; ++k) {
    for (auto& s : smem)  // a slot read before it is written shows as NaN
      std::memset(s.data(), 0xff, n * sizeof(V));
    std::barrier<> bar(C * threads);
    mock_cluster_barrier = &bar;
    mock_cluster_smem = bases.data();
    std::vector<std::thread> th;
    for (int r = 0; r < C; ++r)
      for (int tid = 0; tid < threads; ++tid)
        th.emplace_back([&, r, tid] {
          threadIdx = dim3{(unsigned)tid, 1, 1};
          blockIdx = dim3{(unsigned)(k * C + r), 1, 1};
          mock_smem = bases[r];
          mock_rank = r;
          staggered_w_fused_kernel<R, BX, BY, BZ, CX, CY, CZ, TSMAX, MINB>(
              ue.data(), uo.data(), phi.data(), out.data(), x2, ly, lz, lt, ts, (R)m2);
        });
    for (auto& t : th) t.join();
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int c128 = atoi(argv[5]), tile = atoi(argv[6]);
  const double m2 = atof(argv[7]);
  if (tile == 0)  // the tiles of the C entry points
    return c128 ? run<double, STAGGERED_W_TILE_C128>(x2, ly, lz, lt, m2)
                : run<float, STAGGERED_W_TILE_C64>(x2, ly, lz, lt, m2);
  if (tile == 1)  // one 1 x 2 x 3-row block, t segments of at most 4 sites
    return c128 ? run<double, 1, 2, 3, 1, 1, 1, 4, 1>(x2, ly, lz, lt, m2)
                : run<float, 1, 2, 3, 1, 1, 1, 4, 1>(x2, ly, lz, lt, m2);
  // 12-block clusters of 1 x 1 x 2-row blocks (2 x 3 x 4 rows), t segments of at most 4
  return c128 ? run<double, 1, 1, 2, 2, 3, 2, 4, 1>(x2, ly, lz, lt, m2)
              : run<float, 1, 1, 2, 2, 3, 2, 4, 1>(x2, ly, lz, lt, m2);
}
"""
TILES = ["entry", "block", "cluster"]


@pytest.fixture(scope="module")
def fused_body_exe(tmp_path_factory):
    """The kernel body of csrc/staggered_w_fused.cu (the file up to its launch
    function), compiled for the CPU with g++ against the mock headers."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("fused")
    (d / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    (d / "cluster.h").write_text(_MOCK_CLUSTER)
    src = open(os.path.join(CSRC, "staggered_w_fused.cu")).read()
    (d / "body.inc").write_text(src[:src.index("// Launch on a grid")] + "}  // namespace\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I", str(d),
                    "-I", CSRC, str(d / "harness.cpp"), "-o", str(exe)], check=True)
    return str(exe)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("lat", [(2, 4, 2, 6), (4, 2, 6, 2), (2, 2, 2, 2), (8, 6, 10, 4),
                                 (4, 8, 2, 2)],
                         ids=["x2is1", "y2T2", "all2", "y6z10", "z2T2"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_fused_w_body_on_the_cpu(fused_body_exe, lat, dtype, tile):
    """The CUDA kernel's own body, thread by thread and cluster by cluster,
    against the plain W: with the tiles of the C entry points (a 16-block
    cluster), with one ragged block, and with 12-block clusters of ragged
    blocks, which exceed or do not divide the lattice and cut t."""
    tdt = getattr(torch, dtype)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=sum(lat)))))
    u_e, u_o = (f.to(tdt) for f in eo_pack.pack_links(u, lat))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn(half + (3,), dtype=tdt, generator=torch.Generator().manual_seed(len(lat)))
    out = subprocess.run(
        [fused_body_exe, *map(str, half), str(int(dtype == "complex128")),
         str(TILES.index(tile)), repr(MASS ** 2)],
        input=b"".join(to_numpy(f).tobytes() for f in (u_e, u_o, x)),
        capture_output=True, check=True)
    got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(x.shape)
    ref = to_numpy(sk.staggered_w_reference(u_e, u_o, x, MASS))
    assert float(np.abs(got - ref).max()) < (1e-12 if dtype == "complex128" else 1e-5)
