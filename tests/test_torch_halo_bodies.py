"""The halo modes of csrc/staggered_w.cu and csrc/wilson_window.cu, kernel bodies on the CPU.

Each kernel body compiles with g++ against test_torch_hop_packed.py's mock
headers (bulk copies a memcpy, the mbarrier wait and __syncthreads a
barrier, wilson_window's block run as cooperative contexts on one thread;
staggered_w's threads one at a time) and runs the halo mode on every block
of a global lattice cut in two along x, y, z or t, or along x and t, its
face buffers built from the global fields as the exchange builds them
(test_torch_hop_packed.block_faces). Each block's output is held against
the block of the plain operator on the global field and against the plain
halo version, at 1e-12 (complex128) and 1e-5 (complex64):

* staggered_w: the hop onto both target parities, and the W of a grid,
  m^2 phi - D_eo d1 with the faces of d1 (the halo mode's axpy launch);
  4x8x12x4 cut along x gives the packed local extent X/2 = 1;
* wilson_window: the full D at the tiles of the C entry points and at a
  ragged 2 x 2-row tile over t segments of at most 4 sites, x cut into
  chunks; at r = 1 and in the r mode at r = 0.5.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered_kernel as sk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_hop_packed import (HALO_CUTS, HALO_LATTICES, _MOCK_RUNTIME, _MOCK_TMA,  # noqa: E402
                                   block_faces)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")
MASS = 0.3
KAPPA = 0.13
LAT_IDS = ["8x4x4x8", "4x8x12x4"]


def _compile(tmp_path_factory, name, body_end, harness, extra=""):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(_MOCK_RUNTIME + extra)
    (d / "tma.h").write_text(_MOCK_TMA)
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    (d / "body.inc").write_text(src[:src.index(body_end)] + "}  // namespace\n")
    (d / "harness.cpp").write_text(harness)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-I", str(d),
                    "-I", CSRC, str(d / "harness.cpp"), "-o", str(exe)], check=True)
    return str(exe)


def _links(lat, dtype):
    u = fields.hot_start(lat, 3, seed=sum(lat), device="cpu")
    return tw.apply_boundary_phases(u).to(dtype)


def _face_bytes(faces, links):
    """The face buffers in the harnesses' order: lo, hi and link of each cut axis."""
    return [to_numpy(f).tobytes() for mu in sorted(faces) for f in (*faces[mu], links[mu])]


# ---------------------------------------------------------------- staggered_w

# mode 0, 1: the halo hop onto target parity mode; mode 2: m2 phi - D psi onto the even sites
# (W's second launch); the threads one at a time, 128 to a block, as the launch function
_STAGGERED_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
template <typename R>
int run(int x2, int ly, int lz, int lt, int mode, int mask, double m2) {
  using V = typename Vec<R>::type;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ut(36 * vol), us(36 * vol), psi(3 * vol), phi(3 * vol), out(3 * vol);
  for (auto* f : {&ut, &us, &psi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  if (mode == 2 && fread(phi.data(), sizeof(V), phi.size(), stdin) != phi.size()) return 1;
  const int ext[4] = {x2, ly, lz, lt};
  std::vector<V> faces[12];
  Halo<V> halo{mask, {}, {}, {}};
  for (int mu = 0; mu < 4; ++mu) {
    if (!(mask >> mu & 1)) continue;
    for (int k = 0; k < 3; ++k) {
      auto& f = faces[4 * k + mu];
      f.resize((k == 2 ? 9 : 3) * vol / ext[mu]);
      if (fread(f.data(), sizeof(V), f.size(), stdin) != f.size()) return 1;
    }
    halo.lo[mu] = faces[mu].data();
    halo.hi[mu] = faces[4 + mu].data();
    halo.link[mu] = faces[8 + mu].data();
  }
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int threads = 128, blocks = (vol + threads - 1) / threads;
  blockDim = dim3{(unsigned)threads, 1, 1};
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx = dim3{(unsigned)b, 0, 0};
      threadIdx = dim3{(unsigned)t, 0, 0};
      if (mode == 2)
        staggered_hop_halo_kernel<R, true>(ut.data(), us.data(), psi.data(), phi.data(),
                                           out.data(), x2, ly, lz, lt, 0, R(m2), halo);
      else
        staggered_hop_halo_kernel<R, false>(ut.data(), us.data(), psi.data(), nullptr, out.data(),
                                            x2, ly, lz, lt, mode, R(0), halo);
    }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int mode = atoi(argv[5]), c128 = atoi(argv[6]), mask = atoi(argv[7]);
  const double m2 = atof(argv[8]);
  return c128 ? run<double>(x2, ly, lz, lt, mode, mask, m2)
              : run<float>(x2, ly, lz, lt, mode, mask, m2);
}
"""


@pytest.fixture(scope="module")
def staggered_halo_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "staggered_w", "// The chain strides of a launch",
                    _STAGGERED_HARNESS, "inline thread_local dim3 blockDim;\n")


@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=LAT_IDS)
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_staggered_halo_body_on_the_cpu(staggered_halo_exe, lat, dtype, cut):
    """staggered_w.cu's halo mode on every block: the hop onto both target parities and
    the grid W's axpy launch on the faces of d1, against the blocks of the plain global
    hop and W and against the plain halo hop."""
    tdt = getattr(torch, dtype)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    u_e, u_o = eo_pack.pack_links(_links(lat, tdt), lat)
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn(half + (3,), dtype=tdt, generator=torch.Generator().manual_seed(7))
    d1 = sk.staggered_hop_packed_reference(u_o, u_e, x, 1)
    w = sk.staggered_w_reference(u_e, u_o, x, MASS)
    pes = HALO_CUTS[cut]
    # (mode, forward links, backward links, source, global result)
    runs = [(0, u_e, u_o, x, sk.staggered_hop_packed_reference(u_e, u_o, x, 0)),
            (1, u_o, u_e, x, d1), (2, u_e, u_o, d1, w)]
    for mode, u_t, u_s, src, ref in runs:
        for rank in range(int(np.prod(pes))):
            grid = mesh.ProcessGrid(pes, lat, rank=rank)
            faces, links = block_faces(grid, src, u_s)
            blocks = [grid.block(f, lead=1).contiguous() for f in (u_t, u_s)] + [
                grid.block(src).contiguous()]
            data = [to_numpy(f).tobytes() for f in blocks]
            if mode == 2:
                data.append(to_numpy(grid.block(x).contiguous()).tobytes())
            out = subprocess.run(
                [staggered_halo_exe, *map(str, blocks[2].shape[:4]), str(mode),
                 str(int(dtype == "complex128")), str(sum(1 << mu for mu in faces)),
                 repr(MASS ** 2)],
                input=b"".join(data + _face_bytes(faces, links)), capture_output=True, check=True)
            got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(blocks[2].shape)
            assert float(np.abs(got - to_numpy(grid.block(ref))).max()) < bar, (cut, rank, mode)
            plain = sk.hop_packed_halo_reference(*blocks, mode % 2, faces, links)
            if mode == 2:
                plain = MASS ** 2 * grid.block(x) - plain
            assert float(np.abs(got - to_numpy(plain)).max()) < bar, (cut, rank, mode)


# -------------------------------------------------------------- wilson_window

_WINDOW_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool GENERIC_R>
int run(int lx, int ly, int lz, int lt, int chunk, double kappa, int mask, double r) {
  using V = typename Vec<R>::type;
  const long vol = (long)lx * ly * lz * lt;
  std::vector<V> u(36 * vol), psi(12 * vol), out(12 * vol);
  if (fread(u.data(), sizeof(V), u.size(), stdin) != u.size()) return 1;
  if (fread(psi.data(), sizeof(V), psi.size(), stdin) != psi.size()) return 1;
  const int ext[4] = {lx, ly, lz, lt};
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
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = (lt + nts - 1) / nts;
  const int blocks = ((lx + chunk - 1) / chunk) * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * nts;
  const int threads = 3 * BY * BZ * ts;
  for (int b = 0; b < blocks; ++b) {
    MockBarrier bar(threads);
    block_barrier = &bar;
    std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
    run_block(threads, [&](int tid) {
      threadIdx = dim3{(unsigned)tid, 1, 1};
      blockIdx = dim3{(unsigned)b, 1, 1};
      wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, true, GENERIC_R>(
          u.data(), psi.data(), out.data(), lx, ly, lz, lt, ts, chunk, (R)kappa, halo, (R)r);
    });
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
// at r != 1 the r mode
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH>
int run_at(const int (&l)[5], double kappa, int mask, double r) {
  return r == 1.0
             ? run<R, BY, BZ, TSMAX, MINB, PREFETCH, false>(l[0], l[1], l[2], l[3], l[4], kappa,
                                                            mask, r)
             : run<R, BY, BZ, TSMAX, MINB, PREFETCH, true>(l[0], l[1], l[2], l[3], l[4], kappa,
                                                           mask, r);
}
int main(int argc, char** argv) {
  int l[5];
  for (int i = 0; i < 5; ++i) l[i] = atoi(argv[i + 1]);
  const double kappa = atof(argv[6]);
  const int c128 = atoi(argv[7]), tile = atoi(argv[8]), mask = atoi(argv[9]);
  const double r = argc > 10 ? atof(argv[10]) : 1.0;
  if (tile == 0)  // the tiles of the C entry points
    return c128 ? run_at<double, WILSON_WINDOW_TILE_C128>(l, kappa, mask, r)
                : run_at<float, WILSON_WINDOW_TILE_C64>(l, kappa, mask, r);
  // 2 x 2 rows over t segments of at most 4 sites
  return c128 ? run_at<double, 2, 2, 4, 1, true>(l, kappa, mask, r)
              : run_at<float, 2, 2, 4, 1, true>(l, kappa, mask, r);
}
"""


@pytest.fixture(scope="module")
def window_halo_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "wilson_window", "// Launch one wave", _WINDOW_HARNESS)


@pytest.mark.parametrize("tile", ["entry", "ragged"])
@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=LAT_IDS)
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_halo_body_on_the_cpu(window_halo_exe, lat, dtype, cut, tile):
    """wilson_window.cu's halo mode on every block, x cut into chunks of 3 (the carry of
    a chunk at x = 0 from the x face, an uneven last chunk), against the block of the
    plain global D and against the plain halo D."""
    _window_halo_body(window_halo_exe, lat, dtype, cut, tile, 1.0)


@pytest.mark.parametrize("tile", ["entry", "ragged"])
@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=LAT_IDS)
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_halo_body_r_mode(window_halo_exe, lat, dtype, cut, tile):
    """The halo mode's r form at r = 0.5 (the four-spin carry across chunks and faces)
    on the same blocks, against the plain D's projector form at r = 0.5."""
    _window_halo_body(window_halo_exe, lat, dtype, cut, tile, 0.5)


def _window_halo_body(exe, lat, dtype, cut, tile, r):
    tdt = getattr(torch, dtype)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    u = _links(lat, tdt)
    psi = torch.randn(lat + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(3))
    ref = wk.dslash_reference(u, psi, KAPPA, r)
    pes = HALO_CUTS[cut]
    for rank in range(int(np.prod(pes))):
        grid = mesh.ProcessGrid(pes, lat, rank=rank)
        faces, links = block_faces(grid, psi, u)
        u_b, psi_b = grid.block(u, lead=1).contiguous(), grid.block(psi).contiguous()
        out = subprocess.run(
            [exe, *map(str, psi_b.shape[:4]), "3", repr(KAPPA),
             str(int(dtype == "complex128")), str(["entry", "ragged"].index(tile)),
             str(sum(1 << mu for mu in faces)), repr(r)],
            input=b"".join([to_numpy(u_b).tobytes(), to_numpy(psi_b).tobytes()]
                           + _face_bytes(faces, links)), capture_output=True, check=True)
        got = np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(psi_b.shape)
        assert float(np.abs(got - to_numpy(grid.block(ref))).max()) < bar, (cut, rank)
        plain = wk.dslash_halo_reference(u_b, psi_b, KAPPA, faces, links, r)
        assert float(np.abs(got - to_numpy(plain)).max()) < bar, (cut, rank)


@pytest.mark.gpu
def test_halo_modes_on_gpu():
    """On the card: the halo modes of staggered_w (hop, both parities, and the grid W's axpy
    launch) and of wilson_window on every block of 8x4x4x8 and 4x8x12x4 cut along each axis
    and along x and t, one launch per call, against the block of the global kernel's output
    and the plain halo versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_halo_bodies.py)")
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    dev = torch.device("cuda")
    for lat in HALO_LATTICES:
        for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            u = _links(lat, dtype).to(dev)
            u_e, u_o = eo_pack.pack_links(u, lat)
            g = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((lat[0] // 2,) + lat[1:] + (3,), dtype=dtype, device=dev, generator=g)
            psi = torch.randn(lat + (4, 3), dtype=dtype, device=dev, generator=g)
            d1 = sk.staggered_hop_packed(u_o, u_e, x, 1)
            for pes in HALO_CUTS.values():
                for rank in range(int(np.prod(pes))):
                    grid = mesh.ProcessGrid(pes, lat, rank=rank, device=dev)
                    blk = lambda f, lead=0: grid.block(f, lead).contiguous()  # noqa: E731
                    for p, (u_t, u_s, src) in enumerate(((u_e, u_o, x), (u_o, u_e, x))):
                        faces, links = block_faces(grid, src, u_s)
                        before = sk.halo_launches
                        got = sk.hop_packed_halo(blk(u_t, 1), blk(u_s, 1), blk(src), p, faces, links)
                        torch.cuda.synchronize()
                        assert sk.halo_launches == before + 1
                        want = grid.block(sk.staggered_hop_packed(u_t, u_s, src, p))
                        assert float((got - want).abs().max()) < bar, (pes, rank, p)
                        plain = sk.hop_packed_halo_reference(blk(u_t, 1), blk(u_s, 1), blk(src), p,
                                                             faces, links)
                        assert float((got - plain).abs().max()) < bar, (pes, rank, p)
                    faces, links = block_faces(grid, d1, u_o)
                    got = sk.hop_packed_halo(blk(u_e, 1), blk(u_o, 1), blk(d1), 0, faces, links,
                                             phi=blk(x), mass=MASS)
                    want = grid.block(sk.staggered_w(u_e, u_o, x, MASS))
                    assert float((got - want).abs().max()) < bar, (pes, rank, "W")
                    faces, links = block_faces(grid, psi, u)
                    before = ww.halo_launches
                    got = ww.dslash_halo(blk(u, 1), blk(psi), KAPPA, faces, links)
                    torch.cuda.synchronize()
                    assert ww.halo_launches == before + 1
                    want = grid.block(ww.wilson_window(u, psi, KAPPA))
                    assert float((got - want).abs().max()) < bar, (pes, rank, "window")
                    plain = wk.dslash_halo_reference(blk(u, 1), blk(psi), KAPPA, faces, links)
                    assert float((got - plain).abs().max()) < bar, (pes, rank, "window")
