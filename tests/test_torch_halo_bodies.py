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

Each halo mode's chain form (the chain-halo mode) runs the same blocks as
two chains with different links and fields in one launch, compiled into
the same executable, its face buffers holding both chains' faces chain
after chain: each chain against the plain halo version and bit for bit
against the one-chain halo mode on that chain's block and faces.
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
# (W's second launch); the threads one at a time, 128 to a block, as the launch function, over
# n chains (its last argument, 1 unless given)
_STAGGERED_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
// the launch function's choice: for more than one chain the chain-halo mode (chain blockIdx.y)
template <typename R, bool AXPY>
void site(int n, const typename Vec<R>::type* ut, const typename Vec<R>::type* us,
          const typename Vec<R>::type* psi, const typename Vec<R>::type* phi,
          typename Vec<R>::type* out, int x2, int ly, int lz, int lt, int parity, R m2,
          const Halo<typename Vec<R>::type>& halo, long long u_chain, long long psi_chain,
          const FaceChains& fc) {
  if (n == 1)
    staggered_hop_halo_kernel<R, AXPY>(ut, us, psi, phi, out, x2, ly, lz, lt, parity, m2, halo);
  else
    staggered_hop_halo_kernel<R, AXPY, true>(ut, us, psi, phi, out, x2, ly, lz, lt, parity, m2,
                                             halo, u_chain, psi_chain, fc);
}
template <typename R>
int run(int x2, int ly, int lz, int lt, int mode, int mask, double m2, int n) {
  using V = typename Vec<R>::type;
  const long vol = (long)x2 * ly * lz * lt;
  std::vector<V> ut(36 * vol * n), us(36 * vol * n), psi(3 * vol * n), phi(3 * vol * n),
      out(3 * vol * n);
  for (auto* f : {&ut, &us, &psi})
    if (fread(f->data(), sizeof(V), f->size(), stdin) != f->size()) return 1;
  if (mode == 2 && fread(phi.data(), sizeof(V), phi.size(), stdin) != phi.size()) return 1;
  const int ext[4] = {x2, ly, lz, lt};
  std::vector<V> faces[12];
  Halo<V> halo{mask, {}, {}, {}};
  FaceChains fc{};
  for (int mu = 0; mu < 4; ++mu) {
    if (!(mask >> mu & 1)) continue;
    for (int k = 0; k < 3; ++k) {
      auto& f = faces[4 * k + mu];
      f.resize((k == 2 ? 9 : 3) * vol / ext[mu] * n);
      if (fread(f.data(), sizeof(V), f.size(), stdin) != f.size()) return 1;
    }
    halo.lo[mu] = faces[mu].data();
    halo.hi[mu] = faces[4 + mu].data();
    halo.link[mu] = faces[8 + mu].data();
    fc.lo[mu] = fc.hi[mu] = 3 * vol / ext[mu];
    fc.link[mu] = 9 * vol / ext[mu];
  }
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int threads = 128, blocks = (vol + threads - 1) / threads;
  blockDim = dim3{(unsigned)threads, 1, 1};
  for (int c = 0; c < n; ++c)
    for (int b = 0; b < blocks; ++b)
      for (int t = 0; t < threads; ++t) {
        blockIdx = dim3{(unsigned)b, (unsigned)c, 0};
        threadIdx = dim3{(unsigned)t, 0, 0};
        if (mode == 2)
          site<R, true>(n, ut.data(), us.data(), psi.data(), phi.data(), out.data(), x2, ly, lz,
                        lt, 0, R(m2), halo, 36 * vol, 3 * vol, fc);
        else
          site<R, false>(n, ut.data(), us.data(), psi.data(), nullptr, out.data(), x2, ly, lz,
                         lt, mode, R(0), halo, 36 * vol, 3 * vol, fc);
      }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
int main(int argc, char** argv) {
  const int x2 = atoi(argv[1]), ly = atoi(argv[2]), lz = atoi(argv[3]), lt = atoi(argv[4]);
  const int mode = atoi(argv[5]), c128 = atoi(argv[6]), mask = atoi(argv[7]);
  const double m2 = atof(argv[8]);
  const int n = argc > 9 ? atoi(argv[9]) : 1;
  return c128 ? run<double>(x2, ly, lz, lt, mode, mask, m2, n)
              : run<float>(x2, ly, lz, lt, mode, mask, m2, n);
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


def _chain_faces(grid, fields, links):
    """block_faces of each chain (fields[c], links[c]), stacked chain after chain, and each
    chain's own."""
    per = [block_faces(grid, f, u) for f, u in zip(fields, links)]
    faces = {mu: tuple(torch.stack([p[0][mu][k] for p in per]) for k in (0, 1))
             for mu in per[0][0]}
    return faces, {mu: torch.stack([p[1][mu] for p in per]) for mu in per[0][1]}, per


def _chain_links(lat, dtype):
    """Two chains' links with different hot starts."""
    return torch.stack([tw.apply_boundary_phases(fields.hot_start(
        lat, 3, seed=sum(lat) + c, device="cpu")).to(dtype) for c in range(2)])


@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=LAT_IDS)
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_staggered_chain_halo_body_on_the_cpu(staggered_halo_exe, lat, dtype, cut):
    """staggered_w.cu's chain-halo mode on two chains of every block: the hop onto both
    target parities and the grid W's axpy launch, each chain against the plain halo
    version and bit for bit against the one-chain halo mode."""
    tdt = getattr(torch, dtype)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    u_e, u_o = torch.func.vmap(lambda v: eo_pack.pack_links(v, lat))(_chain_links(lat, tdt))
    half = (lat[0] // 2,) + lat[1:]
    x = torch.randn((2,) + half + (3,), dtype=tdt, generator=torch.Generator().manual_seed(8))
    d1 = sk.staggered_hop_packed_reference(u_o, u_e, x, 1)
    pes = HALO_CUTS[cut]

    def body(blocks, faces, links, mode, n, phi=None):
        data = [to_numpy(f).tobytes() for f in blocks] + (
            [] if phi is None else [to_numpy(phi).tobytes()])
        out = subprocess.run(
            [staggered_halo_exe, *map(str, blocks[2].shape[-5:-1]), str(mode),
             str(int(dtype == "complex128")), str(sum(1 << mu for mu in faces)),
             repr(MASS ** 2), str(n)],
            input=b"".join(data + _face_bytes(faces, links)), capture_output=True, check=True)
        return np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(blocks[2].shape)

    for mode, u_t, u_s, src in ((0, u_e, u_o, x), (1, u_o, u_e, x), (2, u_e, u_o, d1)):
        for rank in range(int(np.prod(pes))):
            grid = mesh.ProcessGrid(pes, lat, rank=rank)
            faces, links, per = _chain_faces(grid, src, u_s)
            blocks = [grid.block(f, lead=2).contiguous() for f in (u_t, u_s)] + [
                grid.block(src, lead=1).contiguous()]
            phi = grid.block(x, lead=1).contiguous() if mode == 2 else None
            got = body(blocks, faces, links, mode, 2, phi)
            plain = sk.hop_packed_halo_reference(*blocks, mode % 2, faces, links)
            if mode == 2:
                plain = MASS ** 2 * phi - plain
            assert float(np.abs(got - to_numpy(plain)).max()) < bar, (cut, rank, mode)
            for c in range(2):
                one = body([b[c] for b in blocks], *per[c], mode, 1,
                           None if phi is None else phi[c])
                assert np.array_equal(got[c], one), (cut, rank, mode, c)


# -------------------------------------------------------------- wilson_window

_WINDOW_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool GENERIC_R>
int run(int lx, int ly, int lz, int lt, int chunk, double kappa, int mask, double r, int n) {
  using V = typename Vec<R>::type;
  const long vol = (long)lx * ly * lz * lt;
  std::vector<V> u(36 * vol * n), psi(12 * vol * n), out(12 * vol * n);
  if (fread(u.data(), sizeof(V), u.size(), stdin) != u.size()) return 1;
  if (fread(psi.data(), sizeof(V), psi.size(), stdin) != psi.size()) return 1;
  const int ext[4] = {lx, ly, lz, lt};
  std::vector<V> faces[12];
  Halo<V> halo{mask, {}, {}, {}};
  FaceChains fc{};
  for (int mu = 0; mu < 4; ++mu) {
    if (!(mask >> mu & 1)) continue;
    for (int k = 0; k < 3; ++k) {
      auto& f = faces[4 * k + mu];
      f.resize((k == 2 ? 9 : 12) * vol / ext[mu] * n);
      if (fread(f.data(), sizeof(V), f.size(), stdin) != f.size()) return 1;
    }
    halo.lo[mu] = faces[mu].data();
    halo.hi[mu] = faces[4 + mu].data();
    halo.link[mu] = faces[8 + mu].data();
    fc.lo[mu] = fc.hi[mu] = 12 * vol / ext[mu];
    fc.link[mu] = 9 * vol / ext[mu];
  }
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = (lt + nts - 1) / nts;
  const int blocks = ((lx + chunk - 1) / chunk) * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * nts;
  const int threads = 3 * BY * BZ * ts;
  for (int c = 0; c < n; ++c)
  for (int b = 0; b < blocks; ++b) {
    MockBarrier bar(threads);
    block_barrier = &bar;
    std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
    run_block(threads, [&](int tid) {
      threadIdx = dim3{(unsigned)tid, 1, 1};
      blockIdx = dim3{(unsigned)b, (unsigned)c, 1};
      // the launch function's choice: the chain-halo mode for more than one chain
      if (n == 1)
        wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, true, GENERIC_R>(
            u.data(), psi.data(), out.data(), lx, ly, lz, lt, ts, chunk, (R)kappa, halo, (R)r);
      else
        wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, true, GENERIC_R, true>(
            u.data(), psi.data(), out.data(), lx, ly, lz, lt, ts, chunk, (R)kappa, halo, (R)r,
            36 * vol, 12 * vol, fc);
    });
  }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
// at r != 1 the r mode
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH>
int run_at(const int (&l)[5], double kappa, int mask, double r, int n) {
  return r == 1.0
             ? run<R, BY, BZ, TSMAX, MINB, PREFETCH, false>(l[0], l[1], l[2], l[3], l[4], kappa,
                                                            mask, r, n)
             : run<R, BY, BZ, TSMAX, MINB, PREFETCH, true>(l[0], l[1], l[2], l[3], l[4], kappa,
                                                           mask, r, n);
}
int main(int argc, char** argv) {
  int l[5];
  for (int i = 0; i < 5; ++i) l[i] = atoi(argv[i + 1]);
  const double kappa = atof(argv[6]);
  const int c128 = atoi(argv[7]), tile = atoi(argv[8]), mask = atoi(argv[9]);
  const double r = argc > 10 ? atof(argv[10]) : 1.0;
  const int n = argc > 11 ? atoi(argv[11]) : 1;  // chains
  if (tile == 0)  // the tiles of the C entry points
    return c128 ? run_at<double, WILSON_WINDOW_TILE_C128>(l, kappa, mask, r, n)
                : run_at<float, WILSON_WINDOW_TILE_C64>(l, kappa, mask, r, n);
  // 2 x 2 rows over t segments of at most 4 sites
  return c128 ? run_at<double, 2, 2, 4, 1, true>(l, kappa, mask, r, n)
              : run_at<float, 2, 2, 4, 1, true>(l, kappa, mask, r, n);
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


@pytest.mark.parametrize("r", [1.0, 0.5], ids=["r1", "r_mode"])
@pytest.mark.parametrize("tile", ["entry", "ragged"])
@pytest.mark.parametrize("cut", list(HALO_CUTS))
@pytest.mark.parametrize("lat", HALO_LATTICES, ids=LAT_IDS)
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_chain_halo_body_on_the_cpu(window_halo_exe, lat, dtype, cut, tile, r):
    """wilson_window.cu's chain-halo mode on two chains of every block (x cut into chunks
    of 3), each chain against the plain halo D and bit for bit against the one-chain
    halo mode on that chain's block and faces."""
    tdt = getattr(torch, dtype)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    u = _chain_links(lat, tdt)
    psi = torch.randn((2,) + lat + (4, 3), dtype=tdt, generator=torch.Generator().manual_seed(4))
    pes = HALO_CUTS[cut]

    def body(u_b, psi_b, faces, links, n):
        out = subprocess.run(
            [window_halo_exe, *map(str, psi_b.shape[-6:-2]), "3", repr(KAPPA),
             str(int(dtype == "complex128")), str(["entry", "ragged"].index(tile)),
             str(sum(1 << mu for mu in faces)), repr(r), str(n)],
            input=b"".join([to_numpy(u_b).tobytes(), to_numpy(psi_b).tobytes()]
                           + _face_bytes(faces, links)), capture_output=True, check=True)
        return np.frombuffer(out.stdout, dtype=np.dtype(dtype)).reshape(psi_b.shape)

    for rank in range(int(np.prod(pes))):
        grid = mesh.ProcessGrid(pes, lat, rank=rank)
        faces, links, per = _chain_faces(grid, psi, u)
        u_b, psi_b = grid.block(u, lead=2).contiguous(), grid.block(psi, lead=1).contiguous()
        got = body(u_b, psi_b, faces, links, 2)
        plain = wk.dslash_halo_reference(u_b, psi_b, KAPPA, faces, links, r)
        assert float(np.abs(got - to_numpy(plain)).max()) < bar, (cut, rank)
        for c in range(2):
            assert np.array_equal(got[c], body(u_b[c], psi_b[c], *per[c], 1)), (cut, rank, c)


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
