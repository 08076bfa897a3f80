"""The wilson_hop_packed kernel body (csrc/wilson_hop_packed.cu), run on the CPU.

The CUDA kernel cannot run here, so its body is compiled with the host
C++ compiler against mock headers: the block's CUDA threads as
cooperative contexts on one OS thread (ucontext; each runs until it
waits at a barrier), the bulk copies a memcpy, the mbarrier wait and
__syncthreads a barrier over the block's threads. Blocks run one after
another.
The result is held against the plain packed hop (hop_packed_reference)
at shapes where the brick wraps onto itself or does not divide the
lattice: X/2 = 1, extent-2 y and T (and every extent 2 at once),
extents 6 and 10, t cut into segments; and with a chain axis of two
lattices with different links (the grid's y axis), each chain against its
own plain hop; and in its halo mode (a block of a process grid): a global
lattice cut in two along each axis (and along x and t at once), each
block's hop with the face buffers built from the global field against
the block of the global plain hop and against the plain halo hop. On the
card the kernel itself is checked by the ``gpu`` tests in
test_torch_wilson.py and test_torch_grid_hmc.py and by chip_smoke.py.
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
using std::min;
#include <ucontext.h>
#include <functional>
#include <memory>
#include <vector>
// A block's CUDA threads as cooperative contexts on one OS thread (run_block): each runs until
// it waits at a barrier, then the next one resumes; a barrier opens once every thread it counts
// has arrived. Each context keeps its own threadIdx and blockIdx.
namespace mock {
struct Ctx {
  ucontext_t uc;
  dim3 tid, bid;
  bool done = false;
};
inline ucontext_t sched;
inline std::vector<Ctx>* ctxs = nullptr;
inline int cur = -1;
inline const std::function<void(int)>* body = nullptr;
inline void yield() {
  Ctx& c = (*ctxs)[cur];
  c.tid = threadIdx;
  c.bid = blockIdx;
  swapcontext(&c.uc, &sched);
}
inline void entry() {
  (*body)(cur);
  (*ctxs)[cur].done = true;
}
}  // namespace mock
struct MockBarrier {
  int expected, count = 0;
  unsigned phase = 0;
  explicit MockBarrier(int n) : expected(n) {}
  void arrive_and_wait() {
    const unsigned ph = phase;
    if (++count == expected) {
      count = 0;
      ++phase;
      return;
    }
    while (phase == ph) mock::yield();
  }
};
inline MockBarrier* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// body(tid) for tid in [0, n), as the n threads of one block
inline void run_block(int n, const std::function<void(int)>& body) {
  constexpr size_t STACK = 1 << 16;
  std::vector<mock::Ctx> ctxs(n);
  std::unique_ptr<char[]> stacks(new char[STACK * n]);
  mock::ctxs = &ctxs;
  mock::body = &body;
  for (int i = 0; i < n; ++i) {
    getcontext(&ctxs[i].uc);
    ctxs[i].uc.uc_stack.ss_sp = stacks.get() + STACK * i;
    ctxs[i].uc.uc_stack.ss_size = STACK;
    ctxs[i].uc.uc_link = &mock::sched;
    makecontext(&ctxs[i].uc, mock::entry, 0);
    ctxs[i].tid = dim3{(unsigned)i, 1, 1};
    ctxs[i].bid = blockIdx;
  }
  for (int left = n; left > 0;)
    for (int i = 0; i < n; ++i) {
      if (ctxs[i].done) continue;
      mock::cur = i;
      threadIdx = ctxs[i].tid;
      blockIdx = ctxs[i].bid;
      swapcontext(&mock::sched, &ctxs[i].uc);
      left -= ctxs[i].done;
    }
}
"""
_MOCK_TMA = """#pragma once
#include <cuda_runtime.h>
inline void mbar_init(uint64_t*) {}
inline void mbar_arrive_expect_tx(uint64_t*, unsigned) {}
inline void bulk_copy_g2s(void* d, const void* s, unsigned n, uint64_t*) { std::memcpy(d, s, n); }
inline void mbar_wait(uint64_t*, unsigned) { block_barrier->arrive_and_wait(); }
inline void prefetch_l2(const void*, unsigned) {}
"""
# run<R, BY, BZ, TSMAX, MINB, GENERIC_R>: the launch function's grid and block for nchain
# chains, one block at a time; with a partition mask, the halo mode of one lattice block, its
# face buffers read after the fields (lo, hi and link of each cut axis in turn); at r != 1 the
# r mode
_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool GENERIC_R>
int run(int x2, int ly, int lz, int lt, int parity, int nchain, int mask, double r) {
  using V = typename Vec<R>::type;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ut(36 * vol * nchain), us(36 * vol * nchain), psi(12 * vol * nchain),
      out(12 * vol * nchain);
  for (auto* f : {&ut, &us, &psi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  const int ext[4] = {x2, ly, lz, lt};
  std::vector<V> faces[12];
  Halo<V> halo{mask, {}, {}, {}};
  for (int mu = 0; mu < 4; ++mu) {
    if (!(mask >> mu & 1)) continue;
    for (int k = 0; k < 3; ++k) {
      auto& f = faces[4 * k + mu];
      f.resize((k == 2 ? 9 : 12) * vol / ext[mu]);
      if (fread(f.data(), sizeof(V), f.size(), stdin) != f.size()) return 1;
    }
    halo.lo[mu] = faces[mu].data();
    halo.hi[mu] = faces[4 + mu].data();
    halo.link[mu] = faces[8 + mu].data();
  }
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int blocks = x2 * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * ((lt + ts - 1) / ts);
  const int threads = 3 * BY * BZ * ts;
  for (int c = 0; c < nchain; ++c)
  for (int b = 0; b < blocks; ++b) {
    MockBarrier bar(threads);
    block_barrier = &bar;
    std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
    run_block(threads, [&](int tid) {
      threadIdx = dim3{(unsigned)tid, 1, 1};
      blockIdx = dim3{(unsigned)b, (unsigned)c, 0};
      // the launch function's choice: the halo mode for a mask, else the kernel without the
      // chain offsets for one chain
      auto kernel =
          mask ? wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, false, true, GENERIC_R>
          : nchain == 1 ? wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, false, false, GENERIC_R>
                        : wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, true, false, GENERIC_R>;
      kernel(ut.data(), us.data(), psi.data(), out.data(), x2, ly, lz, lt, ts, parity, 36 * vol,
             12 * vol, halo, (R)r);
    });
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
template <typename R, int BY, int BZ, int TSMAX, int MINB>
int run_at(int x2, int ly, int lz, int lt, int parity, int nchain, int mask, double r) {
  return r == 1.0 ? run<R, BY, BZ, TSMAX, MINB, false>(x2, ly, lz, lt, parity, nchain, mask, r)
                  : run<R, BY, BZ, TSMAX, MINB, true>(x2, ly, lz, lt, parity, nchain, mask, r);
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int parity = atoi(argv[5]), c128 = atoi(argv[6]), brick = atoi(argv[7]);
  const int nchain = atoi(argv[8]), mask = argc > 9 ? atoi(argv[9]) : 0;
  const double r = argc > 10 ? atof(argv[10]) : 1.0;
  if (brick == 0)  // the bricks of the C entry points
    return c128 ? run_at<double, WILSON_BRICK_C128>(x2, ly, lz, lt, parity, nchain, mask, r)
                : run_at<float, WILSON_BRICK_C64>(x2, ly, lz, lt, parity, nchain, mask, r);
  // 4 x 4 bricks and t segments of at most 4 sites
  return c128 ? run_at<double, 4, 4, 4, 1>(x2, ly, lz, lt, parity, nchain, mask, r)
              : run_at<float, 4, 4, 4, 1>(x2, ly, lz, lt, parity, nchain, mask, r);
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


BODY_LATTICES = pytest.mark.parametrize(
    "lat", [(2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4), (2, 2, 2, 2)],
    ids=["x2is1", "y2T2", "y6z10", "all2"])
CHAIN_LATTICES = pytest.mark.parametrize("lat", [(2, 4, 2, 6), (8, 6, 10, 4)],
                                         ids=["x2is1", "y6z10"])
# the r mode's r, and the bars of tests/test_pallas.py
R_MODE = 0.5
BODY_BARS = {"complex128": 1e-12, "complex64": 1e-5}


def _brick_body(exe, lat, dtype, brick, r):
    tdt = getattr(torch, dtype)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=sum(lat)))))
    u_e, u_o = (f.to(tdt) for f in eo_pack.pack_links(u, lat))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn(half + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(len(half)))
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        out = subprocess.run(
            [exe, *map(str, half), str(parity), str(int(dtype == "complex128")),
             str(BRICKS.index(brick)), "1", "0", repr(r)],
            input=b"".join(to_numpy(f).tobytes() for f in (u_t, u_s, x)),
            capture_output=True, check=True)
        got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(x.shape)
        ref = to_numpy(wk.hop_packed_reference(u_t, u_s, x, parity, r))
        assert float(np.abs(got - ref).max()) < BODY_BARS[dtype]


@pytest.mark.parametrize("brick", BRICKS)
@BODY_LATTICES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_on_the_cpu(brick_body_exe, lat, dtype, brick):
    """The CUDA kernel's own body, thread by thread, against the plain packed
    hop, both target parities: with the bricks of the C entry points, and
    with 4 x 4 bricks over t segments of at most 4 sites, which exceed or do
    not divide y and z and cut t into ragged segments."""
    _brick_body(brick_body_exe, lat, dtype, brick, 1.0)


@pytest.mark.parametrize("brick", BRICKS)
@BODY_LATTICES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_r_mode(brick_body_exe, lat, dtype, brick):
    """The same in the r mode at r = 0.5 (GENERIC_R: (r -+ g_mu) applied to the four
    spins of U psi) against the plain packed hop's projector form at r = 0.5."""
    _brick_body(brick_body_exe, lat, dtype, brick, R_MODE)


def _chain_body(exe, lat, dtype, brick, r):
    tdt = getattr(torch, dtype)
    half = (lat[0] // 2,) + lat[1:]
    packed = [[f.to(tdt) for f in eo_pack.pack_links(tw.apply_boundary_phases(to_torch(
        np.asarray(jfields.hot_start(lat, 3, seed=sum(lat) + c)))), lat)] for c in range(2)]
    x = torch.randn((2,) + half + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(3))
    for parity in (0, 1):
        u_t = torch.stack([p[parity] for p in packed])
        u_s = torch.stack([p[1 - parity] for p in packed])
        out = subprocess.run(
            [exe, *map(str, half), str(parity), str(int(dtype == "complex128")),
             str(BRICKS.index(brick)), "2", "0", repr(r)],
            input=b"".join(to_numpy(f).tobytes() for f in (u_t, u_s, x)),
            capture_output=True, check=True)
        got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(x.shape)
        for c in range(2):
            ref = to_numpy(wk.hop_packed_reference(u_t[c], u_s[c], x[c], parity, r))
            assert float(np.abs(got[c] - ref).max()) < BODY_BARS[dtype]
        # the chain-axis plain version is the per-chain one
        assert np.array_equal(to_numpy(wk.hop_packed_reference(u_t, u_s, x, parity, r))[1],
                              to_numpy(wk.hop_packed_reference(u_t[1], u_s[1], x[1], parity, r)))


@pytest.mark.parametrize("brick", BRICKS)
@CHAIN_LATTICES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_with_a_chain_axis(brick_body_exe, lat, dtype, brick):
    """Two chains with different links and spinors in one launch (the chain on the
    grid's y axis, offset by the links' and the spinors' chain strides), each
    chain against its own plain hop, both target parities."""
    _chain_body(brick_body_exe, lat, dtype, brick, 1.0)


@pytest.mark.parametrize("brick", BRICKS)
@CHAIN_LATTICES
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_with_a_chain_axis_r_mode(brick_body_exe, lat, dtype, brick):
    """The same in the r mode at r = 0.5."""
    _chain_body(brick_body_exe, lat, dtype, brick, R_MODE)


# global lattices cut in two along each axis: every local extent even; (4, 8, 12, 4) gives X/2 = 1
# and local z = 6 (not a multiple of the ragged brick's 4) when cut along x or z
HALO_LATTICES = [(8, 4, 4, 8), (4, 8, 12, 4)]
HALO_CUTS = {"x": (2, 1, 1, 1), "y": (1, 2, 1, 1), "z": (1, 1, 2, 1), "t": (1, 1, 1, 2),
             "xt": (2, 1, 1, 2)}


def block_faces(grid, psi, u_s):
    """A block's face buffers, built from the global packed field psi and links u_s as
    the exchange builds them: {mu: (lo, hi)} (the -mu neighbour's last and the +mu
    neighbour's first slab of psi, axis mu removed) and {mu: the -mu neighbour's last
    slab of u_s[mu]}."""
    local = [n // p for n, p in zip(psi.shape[:4], grid.pes)]

    def cut(f, mu, at):  # the slab at global index `at` along mu, the block's along the others
        return f[tuple(at if d == mu else slice(c * n, (c + 1) * n)
                       for d, (c, n) in enumerate(zip(grid.coords, local)))].contiguous()

    faces, links = {}, {}
    for mu in grid.partitioned:
        lo = (grid.coords[mu] * local[mu] - 1) % psi.shape[mu]
        hi = ((grid.coords[mu] + 1) * local[mu]) % psi.shape[mu]
        faces[mu] = (cut(psi, mu, lo), cut(psi, mu, hi))
        links[mu] = cut(u_s[mu], mu, lo)
    return faces, links


@pytest.mark.parametrize("brick", BRICKS)
@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=["8x4x4x8", "4x8x12x4"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_halo_mode(brick_body_exe, lat, dtype, cut, brick):
    """The kernel's halo mode, thread by thread, on every block of a global lattice cut
    along one axis (or x and t), both target parities: each block's output against the
    block of the plain hop of the global field and against the plain halo hop."""
    _halo_body(brick_body_exe, lat, dtype, cut, brick, 1.0)


@pytest.mark.parametrize("brick", BRICKS)
@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=["8x4x4x8", "4x8x12x4"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_brick_kernel_body_halo_mode_r_mode(brick_body_exe, lat, dtype, cut, brick):
    """The halo mode's r form at r = 0.5 on the same blocks, against the plain hops'
    projector form at r = 0.5."""
    _halo_body(brick_body_exe, lat, dtype, cut, brick, R_MODE)


def _halo_body(exe, lat, dtype, cut, brick, r):
    from latticeqcd_torch.parallel import mesh

    tdt = getattr(torch, dtype)
    bar = BODY_BARS[dtype]
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=sum(lat)))))
    u_e, u_o = (f.to(tdt) for f in eo_pack.pack_links(u, lat))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn(half + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(7))
    pes = HALO_CUTS[cut]
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        ref = wk.hop_packed_reference(u_t, u_s, x, parity, r)
        for rank in range(int(np.prod(pes))):
            grid = mesh.ProcessGrid(pes, lat, rank=rank)
            faces, links = block_faces(grid, x, u_s)
            mask = sum(1 << mu for mu in faces)
            blocks = [grid.block(f, lead=1).contiguous() for f in (u_t, u_s)] + [
                grid.block(x).contiguous()]
            data = [to_numpy(f).tobytes() for f in blocks]
            for mu in sorted(faces):
                data += [to_numpy(f).tobytes() for f in (*faces[mu], links[mu])]
            out = subprocess.run(
                [exe, *map(str, blocks[2].shape[:4]), str(parity),
                 str(int(dtype == "complex128")), str(BRICKS.index(brick)), "1", str(mask),
                 repr(r)],
                input=b"".join(data), capture_output=True, check=True)
            got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(blocks[2].shape)
            want = to_numpy(grid.block(ref))
            assert float(np.abs(got - want).max()) < bar, (cut, rank, parity)
            plain = wk.hop_packed_halo_reference(*blocks, parity, faces, links, r)
            assert float(np.abs(got - to_numpy(plain)).max()) < bar, (cut, rank, parity)


@pytest.mark.gpu
def test_halo_mode_on_gpu():
    """On the card: the halo mode of wilson_hop_packed (one launch per call) on every block
    of 8x4x4x8 and 4x8x12x4 cut along each axis and along x and t, both parities, both
    types, against the block of the global kernel's output and the plain halo hop."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_hop_packed.py)")
    from latticeqcd_torch.parallel import mesh

    dev = torch.device("cuda")
    for lat in HALO_LATTICES:
        for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=5)),
                                                  device=dev, dtype=dtype))
            u_e, u_o = eo_pack.pack_links(u, lat)
            half = (lat[0] // 2,) + lat[1:]
            x = torch.randn(half + (4, 3), dtype=dtype, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(3))
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                ref = wk.wilson_hop_packed(u_t, u_s, x, parity)
                for pes in HALO_CUTS.values():
                    for rank in range(int(np.prod(pes))):
                        grid = mesh.ProcessGrid(pes, lat, rank=rank, device=dev)
                        faces, links = block_faces(grid, x, u_s)
                        blocks = [grid.block(f, lead=1).contiguous() for f in (u_t, u_s)] + [
                            grid.block(x).contiguous()]
                        before = wk.halo_launches
                        got = wk.hop_packed_halo(*blocks, parity, faces, links)
                        torch.cuda.synchronize()
                        assert wk.halo_launches == before + 1
                        assert float((got - grid.block(ref)).abs().max()) < bar, (pes, rank)
                        plain = wk.hop_packed_halo_reference(*blocks, parity, faces, links)
                        assert float((got - plain).abs().max()) < bar, (pes, rank)
