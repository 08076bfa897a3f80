// wilson_hop: the Wilson hopping stencil at r = 1, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dslash_planes
// (latticeqcd_tpu/ops/dirac/wilson_pallas.py, _make_kernel -> _dslash_body):
//
//   H psi(x) = sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]
//
// with csw = 0 and the fermion boundary phases already multiplied into U.
// Two modes share one device function for the hop of a site:
//   * full:   out = psi - kappa * H psi on [X, Y, Z, T, 4, 3] (what dslash_planes computes);
//   * packed: out = H psi_s on the target-parity sites of the even-odd packed layout
//             [X/2, Y, Z, T, 4, 3] (ops/dirac/eo_pack.py: full x = 2x' + s_t(y, z, t)),
//             forward links u_t from the target parity, backward links u_s from the
//             source parity: WilsonDirac.hop_packed at r = 1.
//
// What bounds it: memory traffic. 1320 flop per site against at least 480 B per site at
// complex64 (2.75 flop/B), far under the H100's compute-to-bandwidth line. The design
// therefore spends nothing on arithmetic tricks: one thread per target site; the spin
// projection to a half spinor uses the compile-time (0, +-1, +-i) coefficients of
// wilson_spin.h, so it is adds and re/im swaps; the 3x3 colour product acts on two spin
// components; the sums stay in registers. Fields are read in the framework's interleaved
// complex layout (float2 / double2), so no planar copy is made per apply. It reads
// neighbour spinors and backward links again for every site that needs them (through L2);
// the full D with each field read once is wilson_window.cu. The per-direction hop is
// shared with that kernel (wilson_dir.h).
#include "wilson_dir.h"

namespace {

// One thread per output site. Site index s = ((x * ly + y) * lz + z) * lt + t, with lx the
// x extent of the output layout (X, or X/2 when packed). Links are [4, vol, 3, 3].
template <typename R, bool PACKED>
__global__ void __launch_bounds__(128)
    wilson_hop_kernel(const typename Vec<R>::type* __restrict__ u_fwd,
                      const typename Vec<R>::type* __restrict__ u_bwd,
                      const typename Vec<R>::type* __restrict__ psi,
                      typename Vec<R>::type* __restrict__ out, int lx, int ly, int lz, int lt,
                      int parity, R kappa) {
  using V = typename Vec<R>::type;
  const int vol = lx * ly * lz * lt;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= vol) return;
  const SiteNeighbours n = site_neighbours<PACKED>(s, lx, ly, lz, lt, parity);
  const int(&fw)[4] = n.fw;
  const int(&bw)[4] = n.bw;

  V acc[4][3];
#pragma unroll
  for (int sp = 0; sp < 4; ++sp)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[sp][c] = V{R(0), R(0)};

  hop_dir<0>(acc, psi + 12 * fw[0], u_fwd + 9 * s, psi + 12 * bw[0], u_bwd + 9 * bw[0]);
  hop_dir<1>(acc, psi + 12 * fw[1], u_fwd + 9 * (vol + s), psi + 12 * bw[1],
             u_bwd + 9 * (vol + bw[1]));
  hop_dir<2>(acc, psi + 12 * fw[2], u_fwd + 9 * (2 * vol + s), psi + 12 * bw[2],
             u_bwd + 9 * (2 * vol + bw[2]));
  hop_dir<3>(acc, psi + 12 * fw[3], u_fwd + 9 * (3 * vol + s), psi + 12 * bw[3],
             u_bwd + 9 * (3 * vol + bw[3]));

  V* o = out + 12 * s;
  if (PACKED) {
#pragma unroll
    for (int sp = 0; sp < 4; ++sp)
#pragma unroll
      for (int c = 0; c < 3; ++c) o[3 * sp + c] = acc[sp][c];
  } else {
    const V* p = psi + 12 * s;
#pragma unroll
    for (int sp = 0; sp < 4; ++sp)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const V v = p[3 * sp + c];
        o[3 * sp + c] = V{v.x - kappa * acc[sp][c].x, v.y - kappa * acc[sp][c].y};
      }
  }
}

template <typename R, bool PACKED>
int launch(const void* u_fwd, const void* u_bwd, const void* psi, void* out, int lx, int ly,
           int lz, int lt, int parity, double kappa, void* stream) {
  using V = typename Vec<R>::type;
  const int vol = lx * ly * lz * lt;
  const int threads = 128;
  const int blocks = (vol + threads - 1) / threads;
  wilson_hop_kernel<R, PACKED><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(u_fwd), static_cast<const V*>(u_bwd), static_cast<const V*>(psi),
      static_cast<V*>(out), lx, ly, lz, lt, parity, static_cast<R>(kappa));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError() after the launch.
extern "C" {

int wilson_hop_full_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                        double kappa, void* stream) {
  return launch<float, false>(u, u, psi, out, lx, ly, lz, lt, 0, kappa, stream);
}

int wilson_hop_full_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                         int lt, double kappa, void* stream) {
  return launch<double, false>(u, u, psi, out, lx, ly, lz, lt, 0, kappa, stream);
}

int wilson_hop_packed_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                          int ly, int lz, int lt, int target_parity, void* stream) {
  return launch<float, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity, 0.0, stream);
}

int wilson_hop_packed_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                           int ly, int lz, int lt, int target_parity, void* stream) {
  return launch<double, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity, 0.0, stream);
}

}  // extern "C"
