// wilson_window: the full Wilson D at r = 1 with each field read from device memory once,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dslash_planes_window
// (latticeqcd_tpu/ops/dirac/wilson_pallas.py, _make_window_kernel), which computes
//
//   D psi(x) = psi(x) - kappa sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu)
//                                    + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]
//
// on the full lattice (csw = 0, fermion boundary phases already in U) by streaming
// t-slices of psi and U through a rotating VMEM window, so that every slice is read from
// HBM once: the 480 B/site minimum at complex64 (12 + 36 link + 12 out complex values).
//
// What bounds it: memory traffic, 1320 flop against 480 B per site (2.75 flop/B), far under
// the H100's compute-to-bandwidth line. The port's layout is [X, Y, Z, T, 4, 3] with t
// fastest (site s = ((x Y + y) Z + z) T + t), so streaming t-slices does not carry over.
// The design is 2.5-D blocking:
//   * a block owns a BY x BZ x BT tile of the (y, z, t) slice, one thread per site with t
//     fastest, and marches along x over a chunk of slices;
//   * x, the marching axis, stays in registers: each thread reads its +x neighbour's spinor
//     one step ahead (and stores it into shared memory when that slice becomes current),
//     and carries the -x term to the next step as the half spinor
//     U_0(x)^dag (1 + g_0) psi(x) (6 complex values), so psi and U_0 are read once;
//   * y, z, t: the current slice's spinors on the tile and on a one-site halo (the six
//     faces; edges and corners are never read) are staged in shared memory, the halo by
//     cp.async; each forward link U_mu(x) is read by its owner thread, used for its forward
//     hop and written to shared memory, where the site x + mu reads it as its backward
//     link; the tile's lower face in mu comes in by cp.async.
// What is read again: the halo faces (from L2 when the neighbouring tile's block has just
// read them) and, per x chunk, the slice before it (psi and U_0 for the carried term) and
// the look-ahead slice after it. Extents smaller than the tile, extents that the tile does
// not divide, odd extents and T = 2 (t + 1 and t - 1 the same slice) need no special case:
// every box slot holds the field at its wrapped coordinate, and only threads whose site lies
// inside the lattice write. The spin rule is wilson_dir.h, shared with wilson_hop.
#include <cuda_pipeline.h>

#include "wilson_dir.h"

namespace {

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

template <typename V>
__device__ __forceinline__ void async_copy(V* dst_shared, const V* src) {
  __pipeline_memcpy_async(dst_shared, src, sizeof(V));
}

struct Geo {
  int ly, lz, lt;  // slice extents
  int y0, z0, t0;  // tile origin
};

// The six halo faces of the spinor box (BY+2) x (BZ+2) x (BT+2) of slice `psi_slice`.
template <int BY, int BZ, int BT, typename V>
__device__ __forceinline__ void load_psi_halo(V* spsi, const V* __restrict__ psi_slice,
                                              const Geo& g, int tid) {
  constexpr int EX = BT + 2, EZ = BZ + 2;
  constexpr int FY = BZ * BT, FZ = BY * BT, FT = BY * BZ;
  constexpr int N = 2 * (FY + FZ + FT) * 12;
  for (int i = tid; i < N; i += BY * BZ * BT) {
    const int k = i % 12;
    int f = i / 12;
    int iy, iz, it;
    if (f < 2 * FY) {
      iy = f < FY ? 0 : BY + 1;
      f %= FY;
      iz = f / BT + 1;
      it = f % BT + 1;
    } else if ((f -= 2 * FY) < 2 * FZ) {
      iz = f < FZ ? 0 : BZ + 1;
      f %= FZ;
      iy = f / BT + 1;
      it = f % BT + 1;
    } else {
      f -= 2 * FZ;
      it = f < FT ? 0 : BT + 1;
      f %= FT;
      iy = f / BZ + 1;
      iz = f % BZ + 1;
    }
    const int y = wrap(g.y0 - 1 + iy, g.ly), z = wrap(g.z0 - 1 + iz, g.lz),
              t = wrap(g.t0 - 1 + it, g.lt);
    async_copy(spsi + 12 * ((iy * EZ + iz) * EX + it) + k,
               psi_slice + 12 * ((y * g.lz + z) * g.lt + t) + k);
  }
}

// The lower face in direction MU (1 = y, 2 = z, 3 = t) of the link box
// (BY+1) x (BZ+1) x (BT+1): the backward links of the tile's first row in MU.
template <int MU, int BY, int BZ, int BT, typename V>
__device__ __forceinline__ void load_link_face(V* slink, const V* __restrict__ u_slice,
                                               const Geo& g, int tid) {
  constexpr int LX = BT + 1, LZ = BZ + 1;
  constexpr int NB = MU == 3 ? BZ : BT;
  constexpr int N = (MU == 1 ? BZ * BT : MU == 2 ? BY * BT : BY * BZ) * 9;
  for (int i = tid; i < N; i += BY * BZ * BT) {
    const int k = i % 9, f = i / 9;
    const int a = f / NB + 1, b = f % NB + 1;
    const int iy = MU == 1 ? 0 : a;
    const int iz = MU == 1 ? a : MU == 2 ? 0 : b;
    const int it = MU == 3 ? 0 : b;
    const int y = wrap(g.y0 - 1 + iy, g.ly), z = wrap(g.z0 - 1 + iz, g.lz),
              t = wrap(g.t0 - 1 + it, g.lt);
    async_copy(slink + 9 * ((iy * LZ + iz) * LX + it) + k,
               u_slice + 9 * ((y * g.lz + z) * g.lt + t) + k);
  }
}

// acc += both hops of direction MU in {1, 2, 3} for this thread's site: the forward link from
// device memory (the owner's one read), the backward link from the link box.
template <int MU, int BY, int BZ, int BT, typename V>
__device__ __forceinline__ void tile_dir(V (&acc)[4][3], const V* spsi, V* slink,
                                         const V* __restrict__ u_slice, int me, int mel, int s3,
                                         const Geo& g, int tid) {
  constexpr int PS = MU == 1 ? (BZ + 2) * (BT + 2) : MU == 2 ? BT + 2 : 1;
  constexpr int LS = MU == 1 ? (BZ + 1) * (BT + 1) : MU == 2 ? BT + 1 : 1;
  V uu[9];
  load_link(u_slice + 9 * s3, uu);
  hop_one<MU, false>(acc, spsi + 12 * (me + PS), uu);
  __syncthreads();  // every thread is done with the previous direction's link box
#pragma unroll
  for (int i = 0; i < 9; ++i) slink[9 * mel + i] = uu[i];
  load_link_face<MU, BY, BZ, BT>(slink, u_slice, g, tid);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  load_link(slink + 9 * (mel - LS), uu);
  hop_one<MU, true>(acc, spsi + 12 * (me - PS), uu);
}

template <typename R, int BY, int BZ, int BT>
__global__ void __launch_bounds__(BY * BZ * BT)
    wilson_window_kernel(const typename Vec<R>::type* __restrict__ u,
                         const typename Vec<R>::type* __restrict__ psi,
                         typename Vec<R>::type* __restrict__ out, int lx, int ly, int lz, int lt,
                         int chunk, R kappa) {
  using V = typename Vec<R>::type;
  constexpr int EX = BT + 2, EZ = BZ + 2, EY = BY + 2;  // spinor box, halo on both sides
  constexpr int LX = BT + 1, LZ = BZ + 1;               // link box, lower halo only
  extern __shared__ __align__(16) unsigned char smem[];
  V* spsi = reinterpret_cast<V*>(smem);
  V* slink = spsi + 12 * EY * EZ * EX;

  const int tt = threadIdx.x, tz = threadIdx.y, ty = threadIdx.z;
  const int tid = (ty * BZ + tz) * BT + tt;
  const int ntt = (lt + BT - 1) / BT, ntz = (lz + BZ - 1) / BZ;
  const Geo g{ly, lz, lt, static_cast<int>(blockIdx.x) / (ntt * ntz) * BY,
              static_cast<int>(blockIdx.x) / ntt % ntz * BZ,
              static_cast<int>(blockIdx.x) % ntt * BT};
  const int xs = blockIdx.y * chunk;
  const int xe = min(xs + chunk, lx);
  const bool valid = g.y0 + ty < ly && g.z0 + tz < lz && g.t0 + tt < lt;
  const int s3 = (wrap(g.y0 + ty, ly) * lz + wrap(g.z0 + tz, lz)) * lt + wrap(g.t0 + tt, lt);
  const int slice = ly * lz * lt, vol = lx * slice;
  const int me = ((ty + 1) * EZ + tz + 1) * EX + tt + 1;   // own slot in the spinor box
  const int mel = ((ty + 1) * LZ + tz + 1) * LX + tt + 1;  // own slot in the link box
  V* own = spsi + 12 * me;

  // the -x term of the chunk's first slice: U_0(x-1)^dag (1 + g_0) psi(x-1), in half-spinor form
  V carry[2][3];
  {
    const int xm = wrap(xs - 1, lx);
    V uu[9], half[2][3];
    load_link(u + 9 * (xm * slice + s3), uu);
    project<0, true>(psi + 12 * (xm * slice + s3), half);
    mul_udag(uu, half, carry);
  }
  V nxt[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) nxt[i] = psi[12 * (xs * slice + s3) + i];

  for (int x = xs; x < xe; ++x) {
    __syncthreads();  // every thread is done with the previous slice's boxes
#pragma unroll
    for (int i = 0; i < 12; ++i) own[i] = nxt[i];
    load_psi_halo<BY, BZ, BT>(spsi, psi + 12 * x * slice, g, tid);
    __pipeline_commit();
    const int xn = wrap(x + 1, lx);
#pragma unroll
    for (int i = 0; i < 12; ++i) nxt[i] = psi[12 * (xn * slice + s3) + i];

    V acc[4][3];
#pragma unroll
    for (int sp = 0; sp < 4; ++sp)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[sp][c] = V{R(0), R(0)};
    rebuild<0, true>(acc, carry);
    {
      V uu[9], half[2][3];
      load_link(u + 9 * (x * slice + s3), uu);
      hop_one<0, false>(acc, nxt, uu);
      project<0, true>(own, half);
      mul_udag(uu, half, carry);
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    tile_dir<1, BY, BZ, BT>(acc, spsi, slink, u + 9 * (vol + x * slice), me, mel, s3, g, tid);
    tile_dir<2, BY, BZ, BT>(acc, spsi, slink, u + 9 * (2 * vol + x * slice), me, mel, s3, g, tid);
    tile_dir<3, BY, BZ, BT>(acc, spsi, slink, u + 9 * (3 * vol + x * slice), me, mel, s3, g, tid);

    if (valid) {
      V* o = out + 12 * (x * slice + s3);
#pragma unroll
      for (int sp = 0; sp < 4; ++sp)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const V v = own[3 * sp + c];
          o[3 * sp + c] = V{v.x - kappa * acc[sp][c].x, v.y - kappa * acc[sp][c].y};
        }
    }
  }
}

// Launch on a grid of (y, z, t) tiles times x chunks: the x extent is cut into chunks until
// there are about two blocks per SM, where the slices allow it.
template <typename R, int BY, int BZ, int BT>
int launch(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
           double kappa, void* stream) {
  using V = typename Vec<R>::type;
  constexpr int smem =
      sizeof(V) * (12 * (BY + 2) * (BZ + 2) * (BT + 2) + 9 * (BY + 1) * (BZ + 1) * (BT + 1));
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(wilson_window_kernel<R, BY, BZ, BT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * ((lt + BT - 1) / BT);
  int nchunk = (2 * sms + tiles - 1) / tiles;
  nchunk = nchunk < 1 ? 1 : nchunk > lx ? lx : nchunk;
  const int chunk = (lx + nchunk - 1) / nchunk;
  nchunk = (lx + chunk - 1) / chunk;
  const dim3 grid(tiles, nchunk), block(BT, BZ, BY);
  wilson_window_kernel<R, BY, BZ, BT><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(u), static_cast<const V*>(psi), static_cast<V*>(out), lx, ly, lz, lt,
      chunk, static_cast<R>(kappa));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError() after the launch.
// Tiles: 2 x 4 x 16 sites (128 threads, 60 KB of shared memory) at complex64; 2 x 4 x 8
// (64 threads, 65 KB) at complex128, whose spinor box with its halo is twice as large.
extern "C" {

int wilson_window_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                      double kappa, void* stream) {
  return launch<float, 2, 4, 16>(u, psi, out, lx, ly, lz, lt, kappa, stream);
}

int wilson_window_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                       double kappa, void* stream) {
  return launch<double, 2, 4, 8>(u, psi, out, lx, ly, lz, lt, kappa, stream);
}

}  // extern "C"
