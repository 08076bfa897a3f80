// staggered_w: the even-odd packed staggered operator, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel w_planes_window
// (latticeqcd_tpu/ops/dirac/staggered_pallas.py, _make_w_kernel -> geom, dslash_slice,
// kernel), which computes on packed even sites
//
//   W phi_e = m^2 phi_e - D_eo D_oe phi_e,
//   D psi(x) = 1/2 sum_mu eta_mu(x) [ U_mu(x) psi(x+mu) - U_mu(x-mu)^dag psi(x-mu) ],
//
// with the fermion boundary phases already multiplied into U and the Kogut-Susskind signs
// eta_1 = 1, eta_mu = (-1)^(x_1 + ... + x_{mu-1}). Fields use the even-odd packed layout
// [X/2, Y, Z, T, 3] of ops/dirac/eo_pack.py; links are packed by parity, [4, X/2, Y, Z, T, 3, 3].
// Two entry points:
//   * hop: out = D psi_s on the target-parity sites (StaggeredDirac._packed_dslash), forward
//     links u_t from the target parity, backward links u_s from the source parity;
//   * w:   W phi_e = m^2 phi_e - hop(target 0, hop(target 1, phi_e)) (apply_w_packed).
//
// What bounds it: memory traffic. One hop does about 570 flop per target site against at
// least 624 B (all 576 B of links of both parities once, 24 B in, 24 B out, complex64), and W
// about 1150 flop per even site against the same 624 B: under 2 flop/B, far below the H100's
// compute-to-bandwidth line. The design is the simple one: one thread per target site, the
// packed row offset and the KS signs computed from the thread's coordinates (with
// x = 2x' + off: eta_2 = (-1)^off, eta_3 = (-1)^(off+y), eta_4 = (-1)^(off+y+z)) and applied
// as a negation, the colour sums kept in registers, interleaved complex loads of the
// framework layout. W is two launches of the hop: the odd intermediate d1 = D_oe phi_e goes
// through device memory (a buffer the caller allocates) and the m^2 axpy is fused into the
// second launch. That moves about twice the minimum traffic (the links are read once per
// launch, though at complex64 the 37.7 MB of links at 16^3x32 may stay in the 50 MB L2
// between the two). The Pallas kernel keeps d1 on chip in a sliding t-window; the one-launch
// version with a halo of d1 in shared memory is later work.
//
// Chains: a leading chain axis of independent lattices (HMC.step_batched) is the grid's y axis,
// as jax.vmap adds a leading grid axis to the Pallas call: block (b, c) offsets its links by
// c * u_chain and its fields (d1 too) by c * psi_chain elements. Each launch serves every chain.
// One chain launches the kernel compiled without the offsets (CHAINS false). With them a single
// lattice's W took 31.3-31.7 us against the W's 30.3-30.6 before the chain axis; without them
// 29.9-30.2 against 30.1-30.5 (chip_smoke.py phase 8, cold, 16^3 x 32 complex64, each pair of
// versions in turns on one NVIDIA H100 80GB HBM3 at 700 W).
//
// Halo mode (a block of a process grid, parallel/mesh.py): for each axis mu whose bit is set in
// the partition mask, a neighbour outside the block is read from a face buffer instead of
// wrapping inside the block: a forward neighbour past the block's end from hi[mu] (the +mu
// neighbour's first source-parity slab), a backward one before its start from lo[mu] (the -mu
// neighbour's last slab), and its backward link U_mu(x - mu) from link[mu] (the -mu neighbour's
// last slab of u_bwd[mu]); each face is the packed slab with axis mu removed, indexed by the
// site's other coordinates. Along x the packed cut is per site: a target site at x' = X/2 - 1
// with off = 1 has its x + 1 neighbour at x' = 0 of the +x block, one at x' = 0 with off = 0
// its x - 1 neighbour at x' = X/2 - 1 of the -x block. Every local extent of a grid is even, so
// every block's origin is even: the row offset off and the KS signs computed from the block's
// own coordinates are the global ones, and the kernel takes no origin. The site's work is one
// function (hop_site): mask 0 launches it without the halo branch (HALO false,
// staggered_hop_kernel, as before the halo mode), the halo mode with it
// (staggered_hop_halo_kernel). Under a grid W is two halo launches with the faces of d1
// exchanged between them (staggered_kernel.py).
// Chain-halo mode (staggered_hop_halo_kernel with CHAINS, the halo_chains entry points): a
// leading chain axis on a block of a process grid (HMC.step_batched on a grid), in both of the
// grid W's launches. Chain c = blockIdx.y offsets its links and fields as the chain form does
// and each face pointer by c times that face's chain stride (the exchange sends every chain's
// faces in one message, chain after chain); chain c then computes what the one-chain halo mode
// computes on its fields and faces. One chain launches the one-chain halo mode.
#include "lattice_site.h"

namespace {

// The face buffers of the halo mode: lo, hi and link per axis mu, used where mask bit mu is set.
template <typename V>
struct Halo {
  int mask;
  const V* lo[4];
  const V* hi[4];
  const V* link[4];
};

// The chain strides of the face buffers, in elements (the chain-halo mode).
struct FaceChains {
  long long lo[4], hi[4], link[4];
};

// One thread per target site of the packed layout (lx = X/2) of chain blockIdx.y. AXPY:
// out = m2 phi - D psi, else out = D psi. HALO: the halo mode of one block, its faces in
// `halo` (already offset to the chain's).
template <typename R, bool AXPY, bool CHAINS, bool HALO>
__device__ __forceinline__ void hop_site(const typename Vec<R>::type* __restrict__ u_fwd,
                                         const typename Vec<R>::type* __restrict__ u_bwd,
                                         const typename Vec<R>::type* __restrict__ psi,
                                         const typename Vec<R>::type* __restrict__ phi,
                                         typename Vec<R>::type* __restrict__ out, int lx, int ly,
                                         int lz, int lt, int parity, R m2, long long u_chain,
                                         long long psi_chain,
                                         const Halo<typename Vec<R>::type>& halo) {
  using V = typename Vec<R>::type;
  const int vol = lx * ly * lz * lt;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= vol) return;
  if (CHAINS) {
    const long long chain = blockIdx.y;
    u_fwd += chain * u_chain;
    u_bwd += chain * u_chain;
    psi += chain * psi_chain;
    out += chain * psi_chain;
    if (AXPY) phi += chain * psi_chain;
  }
  const SiteNeighbours n = site_neighbours<true>(s, lx, ly, lz, lt, parity);
  const bool neg[4] = {false, (n.off & 1) != 0, ((n.off + n.y) & 1) != 0,
                       ((n.off + n.y + n.z) & 1) != 0};

  V acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = V{R(0), R(0)};

#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    const V* uf = u_fwd + 9 * (mu * vol + s);
    const V* ub = u_bwd + 9 * (mu * vol + n.bw[mu]);
    const V* pf = psi + 3 * n.fw[mu];
    const V* pb = psi + 3 * n.bw[mu];
    if (HALO && (halo.mask >> mu & 1)) {
      // the site's index in a face of axis mu: its coordinates with axis mu removed
      const int c[4] = {n.x, n.y, n.z, n.t}, e[4] = {lx, ly, lz, lt};
      int fi = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d != mu) fi = fi * e[d] + c[d];
      if (mu == 0 ? n.x + n.off == lx : c[mu] + 1 == e[mu]) pf = halo.hi[mu] + 3 * fi;
      if (mu == 0 ? n.x + n.off == 0 : c[mu] == 0) {
        pb = halo.lo[mu] + 3 * fi;
        ub = halo.link[mu] + 9 * fi;
      }
    }
    V f[3], b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[c] = pf[c];
      b[c] = pb[c];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // U_mu(x) psi(x+mu) - U_mu(x-mu)^dag psi(x-mu), colour row a
      V d = cmul(uf[3 * a], f[0]);
      d = cadd(d, cmul(uf[3 * a + 1], f[1]));
      d = cadd(d, cmul(uf[3 * a + 2], f[2]));
      d = csub(d, cmulc(ub[a], b[0]));
      d = csub(d, cmulc(ub[3 + a], b[1]));
      d = csub(d, cmulc(ub[6 + a], b[2]));
      acc[a] = neg[mu] ? csub(acc[a], d) : cadd(acc[a], d);
    }
  }

  V* o = out + 3 * s;
  if (AXPY) {
    const V* p = phi + 3 * s;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const V v = p[c];
      o[c] = V{m2 * v.x - R(0.5) * acc[c].x, m2 * v.y - R(0.5) * acc[c].y};
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = V{R(0.5) * acc[c].x, R(0.5) * acc[c].y};
  }
}

// The kernel of one process (mask 0), with or without the chain offsets.
template <typename R, bool AXPY, bool CHAINS>
__global__ void __launch_bounds__(128)
    staggered_hop_kernel(const typename Vec<R>::type* __restrict__ u_fwd,
                         const typename Vec<R>::type* __restrict__ u_bwd,
                         const typename Vec<R>::type* __restrict__ psi,
                         const typename Vec<R>::type* __restrict__ phi,
                         typename Vec<R>::type* __restrict__ out, int lx, int ly, int lz, int lt,
                         int parity, R m2, long long u_chain, long long psi_chain) {
  hop_site<R, AXPY, CHAINS, false>(u_fwd, u_bwd, psi, phi, out, lx, ly, lz, lt, parity, m2,
                                   u_chain, psi_chain, Halo<typename Vec<R>::type>{});
}

// The halo mode: one block of a process grid, its faces in `halo`; with CHAINS chain
// blockIdx.y of a leading chain axis, its faces face_chain strides after the previous chain's.
template <typename R, bool AXPY, bool CHAINS = false>
__global__ void __launch_bounds__(128)
    staggered_hop_halo_kernel(const typename Vec<R>::type* __restrict__ u_fwd,
                              const typename Vec<R>::type* __restrict__ u_bwd,
                              const typename Vec<R>::type* __restrict__ psi,
                              const typename Vec<R>::type* __restrict__ phi,
                              typename Vec<R>::type* __restrict__ out, int lx, int ly, int lz,
                              int lt, int parity, R m2, Halo<typename Vec<R>::type> halo,
                              long long u_chain = 0, long long psi_chain = 0,
                              FaceChains face_chain = {}) {
  if (CHAINS) {
    const long long chain = blockIdx.y;
#pragma unroll
    for (int mu = 0; mu < 4; ++mu)
      if (halo.mask >> mu & 1) {
        halo.lo[mu] += chain * face_chain.lo[mu];
        halo.hi[mu] += chain * face_chain.hi[mu];
        halo.link[mu] += chain * face_chain.link[mu];
      }
  }
  hop_site<R, AXPY, CHAINS, true>(u_fwd, u_bwd, psi, phi, out, lx, ly, lz, lt, parity, m2,
                                  u_chain, psi_chain, halo);
}

// The chain strides of a launch: nchain lattices, their links u_chain and their fields
// psi_chain elements apart.
struct Chains {
  int n;
  long long u, psi;
};

template <typename R, bool AXPY>
int launch(const void* u_fwd, const void* u_bwd, const void* psi, const void* phi, void* out,
           int x2, int ly, int lz, int lt, int parity, double m2, Chains ch, void* stream) {
  using V = typename Vec<R>::type;
  const int vol = x2 * ly * lz * lt;
  const int threads = 128;
  const int blocks = (vol + threads - 1) / threads;
  auto kernel =
      ch.n == 1 ? staggered_hop_kernel<R, AXPY, false> : staggered_hop_kernel<R, AXPY, true>;
  kernel<<<dim3(blocks, ch.n), threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(u_fwd), static_cast<const V*>(u_bwd), static_cast<const V*>(psi),
          static_cast<const V*>(phi), static_cast<V*>(out), x2, ly, lz, lt, parity,
          static_cast<R>(m2), ch.u, ch.psi);
  return static_cast<int>(cudaGetLastError());
}

// The halo mode of one block: faces[mu], faces[4 + mu] and faces[8 + mu] are lo[mu], hi[mu]
// and link[mu]; with phi the m^2 axpy of W's second launch. More than one chain launches the
// chain-halo mode, face_chain[mu], face_chain[4 + mu] and face_chain[8 + mu] the faces' chain
// strides.
template <typename R>
int launch_halo(const void* u_fwd, const void* u_bwd, const void* psi, const void* phi, void* out,
                int x2, int ly, int lz, int lt, int parity, double m2, int mask,
                const void* const* faces, void* stream, Chains ch = Chains{1, 0, 0},
                const long long* face_chain = nullptr) {
  using V = typename Vec<R>::type;
  const int vol = x2 * ly * lz * lt;
  const int threads = 128;
  const int blocks = (vol + threads - 1) / threads;
  Halo<V> halo{mask, {}, {}, {}};
  FaceChains fc{};
  for (int mu = 0; mu < 4; ++mu) {
    halo.lo[mu] = static_cast<const V*>(faces[mu]);
    halo.hi[mu] = static_cast<const V*>(faces[4 + mu]);
    halo.link[mu] = static_cast<const V*>(faces[8 + mu]);
    if (face_chain) {
      fc.lo[mu] = face_chain[mu];
      fc.hi[mu] = face_chain[4 + mu];
      fc.link[mu] = face_chain[8 + mu];
    }
  }
  auto kernel = ch.n == 1 ? (phi ? staggered_hop_halo_kernel<R, true, false>
                                 : staggered_hop_halo_kernel<R, false, false>)
                          : (phi ? staggered_hop_halo_kernel<R, true, true>
                                 : staggered_hop_halo_kernel<R, false, true>);
  kernel<<<dim3(blocks, ch.n), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(u_fwd), static_cast<const V*>(u_bwd), static_cast<const V*>(psi),
      static_cast<const V*>(phi), static_cast<V*>(out), x2, ly, lz, lt, parity, static_cast<R>(m2),
      halo, ch.u, ch.psi, fc);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int apply_w(const void* u_e, const void* u_o, const void* phi, void* d1, void* out, int x2, int ly,
            int lz, int lt, double m2, Chains ch, void* stream) {
  // d1 = D_oe phi on odd sites: odd links forward, even links backward
  const int err = launch<R, false>(u_o, u_e, phi, nullptr, d1, x2, ly, lz, lt, 1, 0.0, ch, stream);
  if (err != 0) return err;
  // out = m^2 phi - D_eo d1 on even sites
  return launch<R, true>(u_e, u_o, d1, phi, out, x2, ly, lz, lt, 0, m2, ch, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes), each ending in the chain count and the chain
// strides of the links and of the fields, in elements. Each returns cudaGetLastError() after its
// launches.
extern "C" {

int staggered_hop_packed_c64(const void* u_t, const void* u_s, const void* psi_s, void* out,
                             int x2, int ly, int lz, int lt, int target_parity, int nchain,
                             long long u_chain, long long psi_chain, void* stream) {
  return launch<float, false>(u_t, u_s, psi_s, nullptr, out, x2, ly, lz, lt, target_parity, 0.0,
                              Chains{nchain, u_chain, psi_chain}, stream);
}

int staggered_hop_packed_c128(const void* u_t, const void* u_s, const void* psi_s, void* out,
                              int x2, int ly, int lz, int lt, int target_parity, int nchain,
                              long long u_chain, long long psi_chain, void* stream) {
  return launch<double, false>(u_t, u_s, psi_s, nullptr, out, x2, ly, lz, lt, target_parity, 0.0,
                               Chains{nchain, u_chain, psi_chain}, stream);
}

int staggered_w_c64(const void* u_e, const void* u_o, const void* phi, void* d1, void* out, int x2,
                    int ly, int lz, int lt, double m2, int nchain, long long u_chain,
                    long long psi_chain, void* stream) {
  return apply_w<float>(u_e, u_o, phi, d1, out, x2, ly, lz, lt, m2,
                        Chains{nchain, u_chain, psi_chain}, stream);
}

int staggered_w_c128(const void* u_e, const void* u_o, const void* phi, void* d1, void* out,
                     int x2, int ly, int lz, int lt, double m2, int nchain, long long u_chain,
                     long long psi_chain, void* stream) {
  return apply_w<double>(u_e, u_o, phi, d1, out, x2, ly, lz, lt, m2,
                         Chains{nchain, u_chain, psi_chain}, stream);
}

// The halo mode (one block of a process grid, one chain): the hop's arguments, then phi (null:
// out = D psi; else out = m2 phi - D psi, W's second launch), m2, the partition mask (bit mu:
// axis mu is cut) and an array of 12 face pointers (lo[0..3], hi[0..3], link[0..3]; those of
// uncut axes are not read).
int staggered_hop_halo_c64(const void* u_t, const void* u_s, const void* psi_s, const void* phi,
                           void* out, int x2, int ly, int lz, int lt, int target_parity, double m2,
                           int mask, const void* const* faces, void* stream) {
  return launch_halo<float>(u_t, u_s, psi_s, phi, out, x2, ly, lz, lt, target_parity, m2, mask,
                            faces, stream);
}

int staggered_hop_halo_c128(const void* u_t, const void* u_s, const void* psi_s, const void* phi,
                            void* out, int x2, int ly, int lz, int lt, int target_parity,
                            double m2, int mask, const void* const* faces, void* stream) {
  return launch_halo<double>(u_t, u_s, psi_s, phi, out, x2, ly, lz, lt, target_parity, m2, mask,
                             faces, stream);
}

// The chain-halo mode: the halo mode's arguments with, after the extents and the parity, the
// chain count, the chain strides of the links and of the fields, and an array of the 12 faces'
// chain strides (in elements, in the order of the face pointers).
int staggered_hop_halo_chains_c64(const void* u_t, const void* u_s, const void* psi_s,
                                  const void* phi, void* out, int x2, int ly, int lz, int lt,
                                  int target_parity, int nchain, long long u_chain,
                                  long long psi_chain, const long long* face_chain, double m2,
                                  int mask, const void* const* faces, void* stream) {
  return launch_halo<float>(u_t, u_s, psi_s, phi, out, x2, ly, lz, lt, target_parity, m2, mask,
                            faces, stream, Chains{nchain, u_chain, psi_chain}, face_chain);
}

int staggered_hop_halo_chains_c128(const void* u_t, const void* u_s, const void* psi_s,
                                   const void* phi, void* out, int x2, int ly, int lz, int lt,
                                   int target_parity, int nchain, long long u_chain,
                                   long long psi_chain, const long long* face_chain, double m2,
                                   int mask, const void* const* faces, void* stream) {
  return launch_halo<double>(u_t, u_s, psi_s, phi, out, x2, ly, lz, lt, target_parity, m2, mask,
                             faces, stream, Chains{nchain, u_chain, psi_chain}, face_chain);
}

}  // extern "C"
