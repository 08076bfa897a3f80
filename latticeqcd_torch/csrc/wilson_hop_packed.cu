// wilson_hop_packed: the packed even-odd Wilson hop, redesigned for Hopper (sm_90a), at r = 1 and
// in an r mode at any Wilson r.
//
// Replaces, on every packed hop of the HMC, force and measurement paths, the Pallas TPU
// kernel dslash_planes (latticeqcd_tpu/ops/dirac/wilson_pallas.py) in the form the port
// needs: out = H psi_s on the target-parity sites of the packed layout [X/2, Y, Z, T, 4, 3]
// (ops/dirac/eo_pack.py: full x = 2x' + off, off = (y + z + t + parity) mod 2), forward
// links u_t from the target parity, backward links u_s from the source parity, both
// [4, X/2, Y, Z, T, 3, 3]; the same function as wilson_hop.cu's packed mode, which stays
// built beside it as the yardstick, and its C signature with a chain axis added.
//
// What bounds it on this card: device memory, at the rate the card reaches on this traffic.
// The least traffic is 768 B per target site at complex64 (576 B of links, 96 B in, 96 B out):
// 50.3 MB, 15.0 us at 3.35 TB/s on 16^3 x 32, but a plain device copy of as many bytes takes
// 19.3 us there (2.60 TB/s; 36.2 us at complex128). The one-thread-per-site kernel of
// wilson_hop.cu took 30-32 us: each thread issued ~168 loads of 8 bytes at 72- and 96-byte
// strides (a warp's load touching 18-24 lines), fetched each source spinor 8 times, and ran
// ~15 warps per SM at 80-180 registers. The design, and what each step did (cold, 16^3 x 32,
// NVIDIA H100 80GB HBM3 at 700 W; site kernel 30.2-31.9 us at complex64, 56.2-57.8 us at
// complex128, in the same calls):
//   1. three lanes per target site, one per colour row a of the output. A lane needs only row
//      a of the forward link and column a of the backward link (3 of 9 values), keeps a 4-spin
//      accumulator of its colour and writes its own 4 outputs, so no reduction between lanes
//      is needed and a warp's load spans 10.7 sites. Alone: 24.4-25.2 us (46.4-47.7 at c128);
//   2. a block owns a brick of target sites: BY x BZ whole (y, z) rows at one x', t cut into
//      segments of at most TSMAX sites. Thread 0 copies every source spinor row the brick reads
//      into shared memory with one bulk copy (cp.async.bulk) per row, completing on an
//      mbarrier: its own rows at x', the x' - 1 and x' + 1 rows (which one a site reads
//      depends on off), and the y and z halo rows. So each source spinor enters the SM once
//      per block (6 rows per brick row at 1 x 2), not 8 times per site; the 8 neighbour
//      spinors come from shared memory as 16-byte loads, t +- 1 wrapping inside the row, and
//      only a t neighbour outside a cut segment is read from device memory. The links are
//      read straight from device memory, the first direction's before the wait on the copies.
//      First brick (2 x 2, 384 threads, 56 registers and a spill): 28.8-30.6 us; the bricks
//      of the entry points (below, no spill): 22.6-24 us at complex64 (62-66% of the bound,
//      80-85% of the copy's rate), 44.9-47 us at complex128 (64-67%), over runs on several
//      machines;
//   3. the link rows through shared memory as well was slower, 26.9-38.8 us (c128
//      49.9-71.8): every block then waits for ~40 KB of copies before any arithmetic, and the
//      links gain nothing from reuse. So the links stay in device memory.
// Warm times (one input set, 50.3 MB, about the L2's size) stay within 0.3-1.5 us of cold.
// Bricks of the entry points: 1 x 2 rows, t whole up to 32 sites, at complex64 (192 threads,
// 36 KB of shared memory, 80 registers, 4 blocks per SM); 2 x 1 rows over t segments of at
// most 16 sites at complex128 (96 threads, 36 KB, 128 registers, 5 blocks per SM).
// Chains: a leading chain axis of independent lattices (HMC.step_batched) is the grid's y axis,
// as jax.vmap adds a leading grid axis to the Pallas call. Block (b, c) offsets its links by
// c * u_chain and its spinors by c * psi_chain elements before the copies; a chain of packed
// spinors is X/2 Y Z T 96 bytes at complex64, so every chain's rows keep the 16-byte alignment
// of the bulk copies. One chain launches the kernel compiled without the offsets (CHAINS false).
// With them a single lattice took 23.6-23.7 us against the kernel's 22.7-23.1 before the chain
// axis; without them 22.8-23.2 against 22.9-23.1 (chip_smoke.py phase 4, cold, 16^3 x 32
// complex64, each pair of versions in turns on one NVIDIA H100 80GB HBM3 at 700 W).
// Shapes: every row slot holds the row at its wrapped coordinate, so X/2 = 1 (x' +- 1 onto
// x'), an extent 2 in y or z (the halo onto the brick), T = 2 (t + 1 and t - 1 one site)
// and extents that the brick does not divide need no special case; lanes whose site lies
// outside the lattice compute on wrapped coordinates and do not write.
// Halo mode (a block of a process grid, parallel/mesh.py): for each axis mu whose bit is set
// in the partition mask, a neighbour outside the block is read from a face buffer instead of
// wrapping inside the block. A row slot whose coordinate leaves the block along mu copies its
// row from the face lo[mu] (the -mu neighbour's last source-parity slab) or hi[mu] (the +mu
// neighbour's first), each the packed slab with axis mu removed, so that its rows along t are
// contiguous and 16-byte aligned like psi's; a t neighbour outside the block reads lo[3] or
// hi[3] per site, as the out-of-segment t neighbours read psi; a backward link at x - mu
// outside the block reads link[mu], the -mu neighbour's last slab of u_s[mu]. A slot that
// leaves the block along two axes is read only by lanes that write nothing. No chain axis.
// Mask 0 is the kernel without the halo branches (HALO false), as before the halo mode.
// r mode (GENERIC_R, the _r entry points): the hop (r - g_mu) U psi + (r + g_mu) U^dag psi at
// any r, where (r -+ g_mu) is not a projector and the half-spinor form does not hold: each
// lane takes its colour of U psi for all four spins (4 colour products per neighbour, not 2)
// and applies the 4 x 4 spin matrix (wilson_dir.h, lane_hop_r), about 2690 flop per target
// site against 1320. The bytes are the same, so the bound is too: the r mode stays bound by
// them (at 16^3 x 32 about 2.6 us of FP32 and 5.2 us of FP64 issue against 15.0 and 30.0 us
// of bytes). Every mode, the chain axis and the halo mode among them, has its r form; the r = 1
// instantiations (GENERIC_R false) are the kernel as before.
#include "tma.h"
#include "wilson_dir.h"

// The bricks of the C entry points: BY, BZ (the brick's y and z rows), TSMAX (its longest t
// segment, even), MINB (blocks per SM for __launch_bounds__).
#define WILSON_BRICK_C64 1, 2, 32, 4
#define WILSON_BRICK_C128 2, 1, 16, 5

namespace {

// The face buffers of the halo mode: lo, hi and link per axis mu, used where mask bit mu is set.
template <typename V>
struct Halo {
  int mask;
  const V* lo[4];
  const V* hi[4];
  const V* link[4];
};

// Row slots of a BY x BZ brick in shared memory, each holding one t segment of a source row:
// the x' + dx rows (dx = -1, 0, +1) of the brick's (y, z) rows, then the y halo rows
// (y0 - 1 and y0 + BY, per z of the brick), then the z halo rows (z0 - 1 and z0 + BZ, per y).
template <int BY, int BZ>
struct Slots {
  static constexpr int OWN = BY * BZ;
  static constexpr int ROWS = 3 * OWN + 2 * BZ + 2 * BY;
  __device__ static int xrow(int dx, int iy, int iz) { return (dx + 1) * OWN + iy * BZ + iz; }
  __device__ static int yhalo(int side, int iz) { return 3 * OWN + side * BZ + iz; }
  __device__ static int zhalo(int side, int iy) { return 3 * OWN + 2 * BZ + side * BY + iy; }
  // The (x', y, z) row held by slot i, for the brick at (x, y0, z0), wrapped into the lattice
  // (WRAP) or as it is (the halo mode, where a coordinate outside the block names a face).
  template <bool WRAP>
  __device__ static void row(int i, int x, int y0, int z0, int x2, int ly, int lz, int& rx,
                             int& ry, int& rz) {
    auto w = [](int a, int n) { return WRAP ? wrap(a, n) : a; };
    if (i < 3 * OWN) {
      rx = w(x + i / OWN - 1, x2);
      ry = w(y0 + i % OWN / BZ, ly);
      rz = w(z0 + i % BZ, lz);
    } else if (i < 3 * OWN + 2 * BZ) {
      const int j = i - 3 * OWN;
      rx = x;
      ry = w(y0 - 1 + j / BZ * (BY + 1), ly);
      rz = w(z0 + j % BZ, lz);
    } else {
      const int j = i - 3 * OWN - 2 * BZ;
      rx = x;
      ry = w(y0 + j % BY, ly);
      rz = w(z0 - 1 + j / BY * (BZ + 1), lz);
    }
  }
};

// The halo mode's source of the t segment [t0, ...) of the unwrapped row (rx, ry, rz): a face
// buffer when the row leaves the block along a cut axis, else psi at the wrapped coordinates.
template <typename V>
__device__ __forceinline__ const V* halo_row_source(int rx, int ry, int rz, int x2, int ly, int lz,
                                                    int lt, int t0, const V* psi,
                                                    const Halo<V>& h) {
  const int wx = wrap(rx, x2), wy = wrap(ry, ly), wz = wrap(rz, lz);
  if ((h.mask & 1) && (rx < 0 || rx >= x2))
    return (rx < 0 ? h.lo[0] : h.hi[0]) + 12 * ((wy * lz + wz) * lt + t0);
  if ((h.mask & 2) && (ry < 0 || ry >= ly))
    return (ry < 0 ? h.lo[1] : h.hi[1]) + 12 * ((wx * lz + wz) * lt + t0);
  if ((h.mask & 4) && (rz < 0 || rz >= lz))
    return (rz < 0 ? h.lo[2] : h.hi[2]) + 12 * ((wx * ly + wy) * lt + t0);
  return psi + 12 * (((wx * ly + wy) * lz + wz) * lt + t0);
}

// One block per brick: (x', BY y rows from y0, BZ z rows from z0, t segment [t0, t0 + ts)).
// Thread tid is colour a = tid % 3 of brick site tid / 3, t fastest. Thread 0 first copies
// the brick's source spinor rows into shared memory.
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool CHAINS, bool HALO,
          bool GENERIC_R = false>
__global__ void __launch_bounds__(3 * BY * BZ * TSMAX, MINB)
    wilson_hop_brick_kernel(const typename Vec<R>::type* __restrict__ u_t,
                            const typename Vec<R>::type* __restrict__ u_s,
                            const typename Vec<R>::type* __restrict__ psi,
                            typename Vec<R>::type* __restrict__ out, int x2, int ly, int lz, int lt,
                            int ts, int parity, long long u_chain, long long psi_chain,
                            Halo<typename Vec<R>::type> halo, R r = R(1)) {
  using V = typename Vec<R>::type;
  using S = Slots<BY, BZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  const V* rows = reinterpret_cast<const V*>(smem);
  if (CHAINS) {
    const long long chain = blockIdx.y;
    u_t += chain * u_chain;
    u_s += chain * u_chain;
    psi += chain * psi_chain;
    out += chain * psi_chain;
  }

  const int nts = (lt + ts - 1) / ts, nzb = (lz + BZ - 1) / BZ, nyb = (ly + BY - 1) / BY;
  int b = blockIdx.x;
  const int t0 = b % nts * ts;
  b /= nts;
  const int z0 = b % nzb * BZ;
  b /= nzb;
  const int y0 = b % nyb * BY;
  const int x = b / nyb;
  const int cnt = min(ts, lt - t0);  // sites of this t segment inside the lattice
  const int sy = lz * lt, sx = ly * sy, vol = x2 * sx;

  const int tid = threadIdx.x;
  if (tid == 0) mbar_init(&bar);
  __syncthreads();
  if (tid == 0) {
    const unsigned row_bytes = cnt * 12 * sizeof(V);
    mbar_arrive_expect_tx(&bar, S::ROWS * row_bytes);
    for (int i = 0; i < S::ROWS; ++i) {
      int rx, ry, rz;
      S::template row<!HALO>(i, x, y0, z0, x2, ly, lz, rx, ry, rz);
      bulk_copy_g2s(smem + i * ts * 12 * sizeof(V),
                    HALO ? halo_row_source(rx, ry, rz, x2, ly, lz, lt, t0, psi, halo)
                         : psi + 12 * (rx * sx + ry * sy + rz * lt + t0),
                    row_bytes, &bar);
    }
  }

  const int a = tid % 3, it = tid / 3 % ts, iz = tid / (3 * ts) % BZ, iy = tid / (3 * ts * BZ);
  const bool valid = y0 + iy < ly && z0 + iz < lz && it < cnt;
  const int y = wrap(y0 + iy, ly), z = wrap(z0 + iz, lz), t = wrap(t0 + it, lt);
  const int off = ((y + z + t) & 1) ^ parity;
  const int s = x * sx + y * sy + z * lt + t;
  // source-parity sites of the backward neighbours: x' - (1 - off), y - 1, z - 1
  const int bx = off ? s : s + (x == 0 ? x2 - 1 : -1) * sx;
  const int by = s + (y == 0 ? ly - 1 : -1) * sy, bz = s + (z == 0 ? lz - 1 : -1) * lt;
  const int tf = t + 1 == lt ? 0 : t + 1, tb = t == 0 ? lt - 1 : t - 1;
  // the neighbour spinor held at index i of row slot `slot`
  auto nb = [&](int slot, int i) { return rows + 12 * (slot * ts + i); };

  // in the halo mode, a backward link outside the block comes from the link face of its axis
  // (`out` tells whether the link x - mu leaves the block, `i` is its index in the face)
  auto ubw = [&](int mu, const V* inside, bool out, int i) {
    return HALO && (halo.mask >> mu & 1) && out ? halo.link[mu] + 9 * i : inside;
  };

  V uf[3], ub[3];  // the first links' loads overlap the wait for the copies
  load_link_line<false>(u_t + 9 * s, a, uf);
  load_link_line<true>(ubw(0, u_s + 9 * bx, !off && x == 0, (y * lz + z) * lt + t), a, ub);

  V acc[4];
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) acc[sp] = V{R(0), R(0)};

  mbar_wait(&bar, 0);

  // x: the x' + off (forward) and x' - (1 - off) (backward) rows, same t
  lane_hop_any<0, false, GENERIC_R>(acc, nb(S::xrow(off, iy, iz), it), uf, r);
  lane_hop_any<0, true, GENERIC_R>(acc, nb(S::xrow(off - 1, iy, iz), it), ub, r);
  // y: a row of the brick or a halo row
  load_link_line<false>(u_t + 9 * (vol + s), a, uf);
  load_link_line<true>(ubw(1, u_s + 9 * (vol + by), y == 0, (x * lz + z) * lt + t), a, ub);
  lane_hop_any<1, false, GENERIC_R>(
      acc, nb(iy + 1 < BY ? S::xrow(0, iy + 1, iz) : S::yhalo(1, iz), it), uf, r);
  lane_hop_any<1, true, GENERIC_R>(
      acc, nb(iy > 0 ? S::xrow(0, iy - 1, iz) : S::yhalo(0, iz), it), ub, r);
  // z
  load_link_line<false>(u_t + 9 * (2 * vol + s), a, uf);
  load_link_line<true>(ubw(2, u_s + 9 * (2 * vol + bz), z == 0, (x * ly + y) * lt + t), a, ub);
  lane_hop_any<2, false, GENERIC_R>(
      acc, nb(iz + 1 < BZ ? S::xrow(0, iy, iz + 1) : S::zhalo(1, iy), it), uf, r);
  lane_hop_any<2, true, GENERIC_R>(
      acc, nb(iz > 0 ? S::xrow(0, iy, iz - 1) : S::zhalo(0, iy), it), ub, r);
  // t: in the own row's segment (which wraps when it is the whole row), else device memory;
  // in the halo mode a t neighbour outside the block (`out`) is in a t face
  const bool fin = tf - t0 >= 0 && tf - t0 < cnt, bin = tb - t0 >= 0 && tb - t0 < cnt;
  auto tnb = [&](bool in, int tt, bool out, const V* face) {
    return HALO && (halo.mask & 8) && out ? face + 12 * ((x * ly + y) * lz + z)
           : in                           ? nb(S::xrow(0, iy, iz), tt - t0)
                                          : psi + 12 * (s - t + tt);
  };
  load_link_line<false>(u_t + 9 * (3 * vol + s), a, uf);
  load_link_line<true>(ubw(3, u_s + 9 * (3 * vol + s - t + tb), t == 0, (x * ly + y) * lz + z),
                       a, ub);
  lane_hop_any<3, false, GENERIC_R>(acc, tnb(fin, tf, t + 1 == lt, halo.hi[3]), uf, r);
  lane_hop_any<3, true, GENERIC_R>(acc, tnb(bin, tb, t == 0, halo.lo[3]), ub, r);

  if (valid) {
    V* o = out + 12 * s + a;
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) o[3 * sp] = acc[sp];
  }
}

// Launch on a grid of bricks times chains: t is cut into the fewest segments of at most TSMAX
// sites, of even length (so that a segment of spinors is a whole number of 16-byte units).
// A non-zero mask launches the halo mode (one chain) with faces[mu], faces[4 + mu] and
// faces[8 + mu] as lo[mu], hi[mu] and link[mu]. GENERIC_R: the r mode at Wilson parameter r.
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool GENERIC_R = false>
int launch(const void* u_t, const void* u_s, const void* psi, void* out, int x2, int ly, int lz,
           int lt, int parity, int nchain, long long u_chain, long long psi_chain, int mask,
           const void* const* faces, void* stream, double r = 1.0) {
  using V = typename Vec<R>::type;
  using S = Slots<BY, BZ>;
  static_assert(TSMAX % 2 == 0, "t segments are of even length");
  static_assert(S::ROWS * 12 * TSMAX * sizeof(V) <= 48 * 1024,
                "the brick's rows fit the shared memory a launch gets without opting in");
  const int nts = (lt + TSMAX - 1) / TSMAX;
  const int ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int bytes = S::ROWS * 12 * ts * static_cast<int>(sizeof(V));
  const int blocks = x2 * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * ((lt + ts - 1) / ts);
  Halo<V> halo{mask, {}, {}, {}};
  for (int mu = 0; mask && mu < 4; ++mu) {
    halo.lo[mu] = static_cast<const V*>(faces[mu]);
    halo.hi[mu] = static_cast<const V*>(faces[4 + mu]);
    halo.link[mu] = static_cast<const V*>(faces[8 + mu]);
  }
  auto kernel =
      mask ? wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, false, true, GENERIC_R>
      : nchain == 1 ? wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, false, false, GENERIC_R>
                    : wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB, true, false, GENERIC_R>;
  kernel<<<dim3(blocks, nchain), 3 * BY * BZ * ts, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(u_t), static_cast<const V*>(u_s), static_cast<const V*>(psi),
          static_cast<V*>(out), x2, ly, lz, lt, ts, parity, u_chain, psi_chain, halo,
          static_cast<R>(r));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes): wilson_hop.cu's packed mode followed by the chain
// count and the chain strides of the links and of the spinors, in elements; the halo mode's
// (one chain) by the partition mask (bit mu: axis mu is cut) and an array of 12 face pointers
// (lo[0..3], hi[0..3], link[0..3]; those of uncut axes are not read). The _r entry points are
// the r mode: the same arguments followed by the Wilson r. Each returns cudaGetLastError()
// after the launch. psi_s and the spinor faces must be 16-byte aligned.
extern "C" {

int wilson_hop_brick_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                         int ly, int lz, int lt, int target_parity, int nchain, long long u_chain,
                         long long psi_chain, void* stream) {
  return launch<float, WILSON_BRICK_C64>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity,
                                         nchain, u_chain, psi_chain, 0, nullptr, stream);
}

int wilson_hop_brick_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                          int ly, int lz, int lt, int target_parity, int nchain, long long u_chain,
                          long long psi_chain, void* stream) {
  return launch<double, WILSON_BRICK_C128>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity,
                                           nchain, u_chain, psi_chain, 0, nullptr, stream);
}

int wilson_hop_halo_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                        int ly, int lz, int lt, int target_parity, int mask,
                        const void* const* faces, void* stream) {
  return launch<float, WILSON_BRICK_C64>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity, 1,
                                         0, 0, mask, faces, stream);
}

int wilson_hop_halo_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                         int ly, int lz, int lt, int target_parity, int mask,
                         const void* const* faces, void* stream) {
  return launch<double, WILSON_BRICK_C128>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity,
                                           1, 0, 0, mask, faces, stream);
}

int wilson_hop_brick_r_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                           int ly, int lz, int lt, int target_parity, int nchain,
                           long long u_chain, long long psi_chain, void* stream, double r) {
  return launch<float, WILSON_BRICK_C64, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt,
                                               target_parity, nchain, u_chain, psi_chain, 0,
                                               nullptr, stream, r);
}

int wilson_hop_brick_r_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                            int ly, int lz, int lt, int target_parity, int nchain,
                            long long u_chain, long long psi_chain, void* stream, double r) {
  return launch<double, WILSON_BRICK_C128, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt,
                                                 target_parity, nchain, u_chain, psi_chain, 0,
                                                 nullptr, stream, r);
}

int wilson_hop_halo_r_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                          int ly, int lz, int lt, int target_parity, int mask,
                          const void* const* faces, void* stream, double r) {
  return launch<float, WILSON_BRICK_C64, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt,
                                               target_parity, 1, 0, 0, mask, faces, stream, r);
}

int wilson_hop_halo_r_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                           int ly, int lz, int lt, int target_parity, int mask,
                           const void* const* faces, void* stream, double r) {
  return launch<double, WILSON_BRICK_C128, true>(u_t, u_s, psi_s, out, x2, ly, lz, lt,
                                                 target_parity, 1, 0, 0, mask, faces, stream, r);
}

}  // extern "C"
