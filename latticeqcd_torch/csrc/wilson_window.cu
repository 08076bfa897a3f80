// wilson_window: the full Wilson D with each field read from device memory once, redesigned for
// Hopper (sm_90a), at r = 1 and in an r mode at any Wilson r.
//
// Replaces the Pallas TPU kernel dslash_planes_window
// (latticeqcd_tpu/ops/dirac/wilson_pallas.py, _make_window_kernel), which computes
//
//   D psi(x) = psi(x) - kappa sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu)
//                                    + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]
//
// on the full lattice [X, Y, Z, T, 4, 3] (csw = 0, fermion boundary phases already in U) by
// streaming t-slices of psi and U through a rotating VMEM window, so that every slice is read
// from HBM once: the 480 B/site minimum at complex64 (12 + 36 link + 12 out complex values).
//
// What bounds it: memory traffic, 1320 flop against 480 B per site (2.75 flop/B), far under
// the H100's compute-to-bandwidth line. The port's layout has t fastest (site
// s = ((x Y + y) Z + z) T + t), so the design marches along x instead:
//   * three lanes per site, one per colour row a of the output (as wilson_hop_packed.cu): a
//     lane reads row a of each forward link and column a of each backward link, keeps a 4-spin
//     accumulator of its colour and writes its own 4 outputs, no reduction between lanes;
//   * a block owns BY x BZ whole (y, z) rows, t whole up to TSMAX sites (else cut into
//     segments), and marches along x over a chunk of slices. Each slice's own rows and its
//     y and z halo rows are contiguous runs of spinors, staged in shared memory by one bulk
//     copy (cp.async.bulk, tma.h) per row on an mbarrier. The own rows sit in a ring of three
//     slices (x, the x + 1 neighbour, x + 2 in flight), the halo rows in a ring of two, so
//     one step issues the next step's copies, waits once and passes one __syncthreads;
//   * x stays in the march: psi(x + 1) is the next slice's own row, and the -x term is
//     carried from the previous step as colour a of U_0(x - 1)^dag (1 + g_0) psi(x - 1) (two
//     complex values a lane), so psi and U_0 are read once per chunk;
//   * links are read straight from device memory, not staged: each forward link by its
//     owner, the backward links U_mu(x - mu) for mu = y, z, t from L2 or L1, where the
//     neighbouring row's owner read them a moment earlier;
//   * the grid is sized for one wave: x is cut into the fewest chunks that give every block
//     the card holds at once (blocks per SM from the occupancy calculator) a chunk.
// What each step did (cold, 16^3 x 32, NVIDIA H100 80GB HBM3 at 700 W, beside this file's
// earlier design, one thread per site over a 2 x 4 x 16 tile with a one-site halo copied in
// 8-byte pieces and 8 barriers per x step, 66.5-68.2 us at complex64 and 101.8-104.0 at
// complex128, and wilson_hop.cu's full D, 49.9-50.7 and 98.8-99.9, in the same calls):
//   1. this design at 1 x 2 rows x 32, 4 blocks per SM (80 registers, a 16-byte spill) and
//      2 x 1 rows x 16, 4 per SM, at complex128 (166 registers): 33.3 us and 72.4-73.1 us;
//   2. tiles: at complex64 1 x 2 rows at 3 blocks per SM (96 registers, no spill) 29.8-30.8
//      us, 2 x 2 rows at 2 (a spill) 31.8-32.3, 1 x 1 at 6 (96 registers) 32.1-32.6, t cut
//      at 16 slower (34.8-35.0); at complex128 one row over t segments of 16 at 6 per SM
//      (166 registers) 68.1-69.7 us, 1 x 2 or 2 x 1 rows 71.4-73.9, 2 x 2 rows 69.7-71.0;
//   3. all seven link loads issued before the wait: within the runs' spread (29.8-30.4 us,
//      68.3-69.5; 1 x 1 rows at 4-5 per SM, 118-120 registers, 29.8-30.2), so the links are
//      loaded one direction at a time;
//   4. psi(x + 1) kept in registers for the next step's carry and output: 46.9-48.0 us at
//      1 x 2 rows (a stack frame under the 96-register cap), 30.3-30.4 at 1 x 1 rows, 4 per SM
//      (148 registers), 89.7-89.9 us at complex128 (a stack frame);
//   5. the tile's forward link rows of a slice prefetched into L2 (cp.async.bulk.prefetch) with
//      the copies a step ahead: complex128 66.0-66.6 us against 68.1-68.7 in the same calls,
//      where 9 warps per SM cannot hide the links' latency (kept there); complex64 30.4-31.1
//      against 30.0-30.7 (not used there); two steps ahead slower in both (33.8-34.5, 69.8-70.4).
// A device copy of as many bytes (62.9 MB at complex64) takes 23.2-23.8 us there: the landed
// tiles run at 77-79% of a copy's rate, 61-63% of the least-bytes bound (complex128: 43.9-44.7
// us, 66-67%; 56-57%). Tiles of the entry points: 1 x 2 rows, t whole up to 32 sites, at
// complex64 (192 threads, 55 KB of shared memory, 96 registers, 3 blocks per SM, x cut into
// chunks of 6 at 16^3 x 32); one row over t segments of at most 16 sites, with the prefetch,
// at complex128 (48 threads, 34 KB, 166 registers, 6 blocks per SM, x whole).
// Shapes: every row slot holds the row at its wrapped coordinate, so X = 1 or 2, extents
// smaller than the tile, extents that the tile does not divide, odd extents and T = 2 (t + 1
// and t - 1 one site) need no special case; lanes whose site lies outside the lattice
// compute on wrapped coordinates and do not write. A t neighbour outside a cut segment is
// read from device memory. The spin rule is wilson_dir.h, shared with wilson_hop and
// wilson_hop_packed.
// Halo mode (a block of a process grid, parallel/mesh.py), woven into the same march: for each
// axis mu whose bit is set in the partition mask, a neighbour outside the block is read from a
// face buffer instead of wrapping inside the block. lo[mu] is the -mu neighbour's last slab of
// psi and hi[mu] the +mu neighbour's first, each with axis mu removed, so that a face row along
// t is T contiguous spinors and the bulk copies stage it as they stage psi's rows; link[mu] is
// the -mu neighbour's last slab of U_mu, the backward links U_mu(x - mu) of the block's first
// slab. Under an x cut the carry of the chunk at x = 0 comes from lo[0] and link[0], and the
// own row of slice X (psi(x + 1) at the last slice) from hi[0]; a y or z row slot outside the
// block copies its row from the y or z face; a t neighbour past the row's end reads lo[3] or
// hi[3] per site, as the out-of-segment t neighbours read psi. A slot that leaves the block
// along two axes is read only by lanes that write nothing. Mask 0 is the kernel without the
// halo branches (HALO false), as before the halo mode.
// r mode (GENERIC_R, the _r entry points): D with (r - g_mu) and (r + g_mu) in place of the
// projectors, at any r. The half-spinor form does not hold there, so each lane takes its colour
// of U psi for all four spins and applies the 4 x 4 spin matrix (wilson_dir.h, lane_hop_r), and
// the -x carry holds four spins, not two. About 2750 flop per site against 1320, the same
// bytes: at 16^3 x 32 about 5.7 us of FP32 and 11 us of FP64 issue against 18.8 and 37.6 us of
// bytes, so the r mode stays bound by bytes. Its global and halo modes take the r = 1 tile at
// complex64 and one block per SM fewer at complex128 (below); the r = 1 instantiations
// (GENERIC_R false) are the kernel as before.
// Chains (CHAINS, the chains entry points): a leading chain axis of independent lattices
// (HMC.step_batched), as jax.vmap adds a leading grid axis to the Pallas call, at r = 1 and in
// the r mode. The chain is the grid's y axis; each block offsets its links and spinors by
// chain * u_chain and chain * psi_chain elements before its copies, and the wave is sized over
// the tiles of all chains, so that many chains cut x into fewer chunks (fewer carry prologues
// per march). At complex64 the chain form runs one block per SM fewer (below). One chain
// launches the kernel without the offsets (CHAINS false). No halo mode.
#include <atomic>

#include "tma.h"
#include "wilson_dir.h"

// The tiles of the C entry points: BY, BZ (the block's y and z rows), TSMAX (its longest t
// segment), MINB (blocks per SM for __launch_bounds__), PREFETCH (the link rows of each slice
// prefetched into L2 a step ahead). The r mode at complex128 has its own, one block per SM
// fewer: at 6 (5 in the halo mode) its halo mode spilled 20 bytes and took 46.4-46.6 us on
// the x and the t cut's blocks, against 43.1-43.4 at 5 (4), with its global mode unchanged
// (39.0-40.2 against 39.3-39.9 us; scripts/ab_window_halo.py --r 0.5, warm, NVIDIA H100 80GB
// HBM3 at 700 W).
#define WILSON_WINDOW_TILE_C64 1, 2, 32, 3, false
#define WILSON_WINDOW_TILE_C128 1, 1, 16, 6, true
#define WILSON_WINDOW_TILE_C128_R 1, 1, 16, 5, true

namespace {

// The face buffers of the halo mode: lo, hi and link per axis mu, used where mask bit mu is set.
template <typename V>
struct Halo {
  int mask;
  const V* lo[4];
  const V* hi[4];
  const V* link[4];
};

// The halo mode's source of the t segment [t0, ...) of the unwrapped row (rx, ry, rz): a face
// buffer when the row leaves the block along a cut axis, else psi at the wrapped coordinates.
template <typename V>
__device__ __forceinline__ const V* halo_row_source(int rx, int ry, int rz, int lx, int ly, int lz,
                                                    int lt, int t0, const V* psi,
                                                    const Halo<V>& h) {
  const int wx = wrap(rx, lx), wy = wrap(ry, ly), wz = wrap(rz, lz);
  if ((h.mask & 1) && (rx < 0 || rx >= lx))
    return (rx < 0 ? h.lo[0] : h.hi[0]) + 12 * ((wy * lz + wz) * lt + t0);
  if ((h.mask & 2) && (ry < 0 || ry >= ly))
    return (ry < 0 ? h.lo[1] : h.hi[1]) + 12 * ((wx * lz + wz) * lt + t0);
  if ((h.mask & 4) && (rz < 0 || rz >= lz))
    return (rz < 0 ? h.lo[2] : h.hi[2]) + 12 * ((wx * ly + wy) * lt + t0);
  return psi + 12 * (((wx * ly + wy) * lz + wz) * lt + t0);
}

// Row slots of a BY x BZ tile in shared memory, each holding one t segment of a spinor row:
// a ring of three slices of the tile's own rows, then a ring of two slices of its halo rows
// (y0 - 1 and y0 + BY per z of the tile, then z0 - 1 and z0 + BZ per y).
template <int BY, int BZ>
struct Ring {
  static constexpr int OWN = BY * BZ, HALO = 2 * BZ + 2 * BY;
  static constexpr int ROWS = 3 * OWN + 2 * HALO;
  __device__ static int own(int k, int iy, int iz) { return k * OWN + iy * BZ + iz; }
  __device__ static int yhalo(int k, int side, int iz) {
    return 3 * OWN + k * HALO + side * BZ + iz;
  }
  __device__ static int zhalo(int k, int side, int iy) {
    return 3 * OWN + k * HALO + 2 * BZ + side * BY + iy;
  }
};

// One block per (x chunk, BY y rows from y0, BZ z rows from z0, t segment [t0, t0 + ts)).
// Thread tid is colour a = tid % 3 of tile site tid / 3, t fastest. Step i of the march
// computes slice xs + i; copy group i (own rows of slice xs + i + 1 and halo rows of slice
// xs + i, and at i = 0 the own rows of slice xs) completes on bar[i % 2]: thread 0 issues
// group 0 before the march and group i + 1 in step i, after the barrier that frees its slots,
// and with PREFETCH the tile's forward link rows of slice xs + i into L2 with group i.
// HALO: the halo mode of one block of a process grid, bounded at one block per SM fewer where
// MINB is above 2: at complex64's 3 (96 registers) its selects spill 28 bytes, and the halo
// mode took 16.7 us on the x cut's 8x16x16x32 block and 22.1 on the t cut's 16^3x16 against
// 15.0 and 20.9 at 2 (155 registers, no spill; scripts/ab_window_halo.py, warm, NVIDIA H100
// 80GB HBM3 at 700 W).
// CHAINS: chain blockIdx.y of a leading chain axis, its links and spinors u_chain and psi_chain
// elements after the previous chain's (no halo mode); at complex64 one block per SM fewer as
// well: at 3 the r = 1 form spilled 36 bytes (96 registers), and 16 chains at 8^4 took 25.0
// us, 2 at 16^3x32 62.0 us, against 22.1 and 55.0 at 2 (the r mode 24.9 and 59.6 against 23.8
// and 56.9; scripts/ab_window_chains.py, cold, NVIDIA H100 80GB HBM3 at 700 W). complex128
// spills nothing there and keeps its bound.
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool HALO = false,
          bool GENERIC_R = false, bool CHAINS = false>
__global__ void __launch_bounds__(3 * BY * BZ * TSMAX,
                                  (HALO && MINB > 2) || (CHAINS && sizeof(R) == 4) ? MINB - 1
                                                                                   : MINB)
    wilson_window_kernel(const typename Vec<R>::type* __restrict__ u,
                         const typename Vec<R>::type* __restrict__ psi,
                         typename Vec<R>::type* __restrict__ out, int lx, int ly, int lz, int lt,
                         int ts, int chunk, R kappa, Halo<typename Vec<R>::type> halo = {},
                         R r = R(1), long long u_chain = 0, long long psi_chain = 0) {
  using V = typename Vec<R>::type;
  using S = Ring<BY, BZ>;
  static_assert(!(CHAINS && HALO), "the halo mode holds one chain");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar[2];
  const V* rows = reinterpret_cast<const V*>(smem);
  if (CHAINS) {
    const long long chain = blockIdx.y;
    u += chain * u_chain;
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
  const int xs = b / nyb * chunk;
  const int steps = min(chunk, lx - xs);
  const int cnt = min(ts, lt - t0);  // sites of this t segment inside the lattice
  const int sy = lz * lt, slice = ly * sy, vol = lx * slice;
  const unsigned row_bytes = cnt * 12 * sizeof(V);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();

  // thread 0: the copies of group i into the ring slots of steps i (halo) and i + 1 (own)
  auto issue = [&](int i) {
    // in the halo mode x + 1 stays unwrapped: past the block's end it names the x face
    const int x = xs + i, xn = HALO ? x + 1 : x + 1 == lx ? 0 : x + 1;
    uint64_t* bi = &bar[i & 1];
    mbar_arrive_expect_tx(bi, ((i == 0 ? 2 : 1) * S::OWN + S::HALO) * row_bytes);
    auto copy = [&](int slot, int rx, int ry, int rz) {
      bulk_copy_g2s(smem + slot * ts * 12 * sizeof(V),
                    HALO ? halo_row_source(rx, ry, rz, lx, ly, lz, lt, t0, psi, halo)
                         : psi + 12 * (rx * slice + wrap(ry, ly) * sy + wrap(rz, lz) * lt + t0),
                    row_bytes, bi);
    };
    for (int iy = 0; iy < BY; ++iy)
      for (int iz = 0; iz < BZ; ++iz) {
        if (i == 0) copy(S::own(0, iy, iz), x, y0 + iy, z0 + iz);
        copy(S::own((i + 1) % 3, iy, iz), xn, y0 + iy, z0 + iz);
      }
    if (PREFETCH)  // the 16-byte aligned part of each row
      for (int mu = 0; mu < 4; ++mu)
        for (int iy = 0; iy < BY; ++iy)
          for (int iz = 0; iz < BZ; ++iz) {
            const size_t p = reinterpret_cast<size_t>(
                u + 9 * (mu * vol + x * slice + wrap(y0 + iy, ly) * sy + wrap(z0 + iz, lz) * lt +
                         t0));
            const size_t lo = p & ~size_t(15), hi = (p + cnt * 9 * sizeof(V)) & ~size_t(15);
            if (hi > lo) prefetch_l2(reinterpret_cast<const void*>(lo), hi - lo);
          }
    for (int side = 0; side < 2; ++side) {
      for (int iz = 0; iz < BZ; ++iz)
        copy(S::yhalo(i & 1, side, iz), x, y0 - 1 + side * (BY + 1), z0 + iz);
      for (int iy = 0; iy < BY; ++iy)
        copy(S::zhalo(i & 1, side, iy), x, y0 + iy, z0 - 1 + side * (BZ + 1));
    }
  };
  if (tid == 0) issue(0);

  const int a = tid % 3, it = tid / 3 % ts, iz = tid / (3 * ts) % BZ, iy = tid / (3 * ts * BZ);
  const bool valid = y0 + iy < ly && z0 + iz < lz && it < cnt;
  const int y = wrap(y0 + iy, ly), z = wrap(z0 + iz, lz), t = wrap(t0 + it, lt);
  const int s3 = y * sy + z * lt + t;  // the site within its slice
  const int by = s3 + (y == 0 ? ly - 1 : -1) * sy, bz = s3 + (z == 0 ? lz - 1 : -1) * lt;
  const int tf = t + 1 == lt ? 0 : t + 1, tb = t == 0 ? lt - 1 : t - 1;
  const bool fin = tf - t0 >= 0 && tf - t0 < cnt, bin = tb - t0 >= 0 && tb - t0 < cnt;
  // the spinor held at index j of row slot `slot`
  auto nb = [&](int slot, int j) { return rows + 12 * (slot * ts + j); };
  // in the halo mode, a backward link or a t neighbour outside the block comes from a face of
  // its axis (`out` tells whether it leaves the block, `i` is its index in the face)
  auto cut = [&](int mu, bool out) { return HALO && (halo.mask >> mu & 1) && out; };
  auto ubw = [&](int mu, const V* inside, bool out, int i) {
    return cut(mu, out) ? halo.link[mu] + 9 * i : inside;
  };

  // the -x term of the chunk's first slice, colour a of U_0(x-1)^dag (1 + g_0) psi(x-1) (its
  // two half-spinor values; in the r mode colour a of U_0(x-1)^dag psi(x-1), four spins)
  V carry[GENERIC_R ? 4 : 2];
  {
    const int xm = xs == 0 ? lx - 1 : xs - 1;
    V site[12], ul[3];
    load_link_line<true>(ubw(0, u + 9 * (xm * slice + s3), xs == 0, s3), a, ul);
    load_site(cut(0, xs == 0) ? halo.lo[0] + 12 * s3 : psi + 12 * (xm * slice + s3), site);
    lane_carry<0>(site, ul, carry);
  }

  for (int i = 0; i < steps; ++i) {
    const int x = xs + i, o = x * slice + s3;
    if (i > 0) __syncthreads();  // every thread is done with step i - 1's slots
    if (tid == 0 && i + 1 < steps) issue(i + 1);
    V uf[3], ub[3];  // the x links' loads overlap the wait for the copies
    load_link_line<false>(u + 9 * o, a, uf);
    load_link_line<true>(u + 9 * o, a, ub);
    V acc[4];
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) acc[sp] = V{R(0), R(0)};
    lane_rebuild_any<0, true>(acc, carry, r);
    mbar_wait(&bar[i & 1], (i >> 1) & 1);

    const int cur = S::own(i % 3, iy, iz);
    // x: psi(x + 1) from the next slice's own row; the carry for step i + 1 from psi(x)
    lane_hop_any<0, false, GENERIC_R>(acc, nb(S::own((i + 1) % 3, iy, iz), it), uf, r);
    {
      V site[12];
      load_site(nb(cur, it), site);
      lane_carry<0>(site, ub, carry);
    }
    // y: a row of the tile or a halo row
    load_link_line<false>(u + 9 * (vol + o), a, uf);
    load_link_line<true>(ubw(1, u + 9 * (vol + x * slice + by), y == 0, (x * lz + z) * lt + t), a,
                         ub);
    lane_hop_any<1, false, GENERIC_R>(
        acc, nb(iy + 1 < BY ? S::own(i % 3, iy + 1, iz) : S::yhalo(i & 1, 1, iz), it), uf, r);
    lane_hop_any<1, true, GENERIC_R>(
        acc, nb(iy > 0 ? S::own(i % 3, iy - 1, iz) : S::yhalo(i & 1, 0, iz), it), ub, r);
    // z
    load_link_line<false>(u + 9 * (2 * vol + o), a, uf);
    load_link_line<true>(ubw(2, u + 9 * (2 * vol + x * slice + bz), z == 0, (x * ly + y) * lt + t),
                         a, ub);
    lane_hop_any<2, false, GENERIC_R>(
        acc, nb(iz + 1 < BZ ? S::own(i % 3, iy, iz + 1) : S::zhalo(i & 1, 1, iy), it), uf, r);
    lane_hop_any<2, true, GENERIC_R>(
        acc, nb(iz > 0 ? S::own(i % 3, iy, iz - 1) : S::zhalo(i & 1, 0, iy), it), ub, r);
    // t: in the own row's segment (which wraps when it is the whole row), else device memory;
    // in the halo mode a t neighbour outside the block is in a t face
    const int ft = (x * ly + y) * lz + z;  // the site's index in a t face
    load_link_line<false>(u + 9 * (3 * vol + o), a, uf);
    load_link_line<true>(ubw(3, u + 9 * (3 * vol + o - t + tb), t == 0, ft), a, ub);
    lane_hop_any<3, false, GENERIC_R>(acc, cut(3, t + 1 == lt) ? halo.hi[3] + 12 * ft
                                           : fin               ? nb(cur, tf - t0)
                                                               : psi + 12 * (o - t + tf),
                                      uf, r);
    lane_hop_any<3, true, GENERIC_R>(acc, cut(3, t == 0) ? halo.lo[3] + 12 * ft
                                          : bin          ? nb(cur, tb - t0)
                                                         : psi + 12 * (o - t + tb),
                                     ub, r);

    if (valid) {
      const V* p = nb(cur, it) + a;
      V* q = out + 12 * o + a;
#pragma unroll
      for (int sp = 0; sp < 4; ++sp) {
        const V v = p[3 * sp];
        q[3 * sp] = V{v.x - kappa * acc[sp].x, v.y - kappa * acc[sp].y};
      }
    }
  }
}

// Launch one wave: t is cut into the fewest segments of at most TSMAX sites, and x into the
// fewest chunks that give every block the card holds at once a chunk, over the tiles of all
// nchain chains (the grid's y axis). HALO: the halo mode (one chain), with faces[mu],
// faces[4 + mu] and faces[8 + mu] as lo[mu], hi[mu] and link[mu]. GENERIC_R: the r mode at
// Wilson parameter r. CHAINS: the kernel with the chain offsets, for nchain > 1; each
// instantiation reads its own occupancy.
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool HALO = false,
          bool GENERIC_R = false, bool CHAINS = false>
int launch(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
           double kappa, void* stream, int mask = 0, const void* const* faces = nullptr,
           double r = 1.0, int nchain = 1, long long u_chain = 0, long long psi_chain = 0) {
  using V = typename Vec<R>::type;
  constexpr int smem_max = Ring<BY, BZ>::ROWS * 12 * TSMAX * sizeof(V);
  auto* kernel = wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, HALO, GENERIC_R, CHAINS>;
  Halo<V> halo{mask, {}, {}, {}};
  for (int mu = 0; HALO && mu < 4; ++mu) {
    halo.lo[mu] = static_cast<const V*>(faces[mu]);
    halo.hi[mu] = static_cast<const V*>(faces[4 + mu]);
    halo.link[mu] = static_cast<const V*>(faces[8 + mu]);
  }
  // once per device: opt in to the shared memory and read how many blocks the card holds at
  // once (threads that race here set and read the same values twice, which is harmless)
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int held = dev < MAX_DEVICES ? resident[dev].load(std::memory_order_acquire) : 0;
  if (held == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 3 * BY * BZ * TSMAX,
                                                          smem_max);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm == 0) return -1;
    held = sms * per_sm;
    if (dev < MAX_DEVICES) resident[dev].store(held, std::memory_order_release);
  }
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = (lt + nts - 1) / nts;
  const int tiles = ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * nts;
  int nchunk = held / (tiles * nchain);
  nchunk = nchunk < 1 ? 1 : nchunk > lx ? lx : nchunk;
  const int chunk = (lx + nchunk - 1) / nchunk;
  nchunk = (lx + chunk - 1) / chunk;
  const int smem = Ring<BY, BZ>::ROWS * 12 * ts * static_cast<int>(sizeof(V));
  kernel<<<dim3(tiles * nchunk, nchain), 3 * BY * BZ * ts, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(u), static_cast<const V*>(psi), static_cast<V*>(out), lx, ly, lz, lt,
      ts, chunk, static_cast<R>(kappa), halo, static_cast<R>(r), u_chain, psi_chain);
  return static_cast<int>(cudaGetLastError());
}

// The global mode over nchain chains: one chain launches the kernel without the offsets.
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool GENERIC_R>
int launch_chains(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                  int nchain, long long u_chain, long long psi_chain, double kappa, double r,
                  void* stream) {
  return nchain == 1
             ? launch<R, BY, BZ, TSMAX, MINB, PREFETCH, false, GENERIC_R, false>(
                   u, psi, out, lx, ly, lz, lt, kappa, stream, 0, nullptr, r)
             : launch<R, BY, BZ, TSMAX, MINB, PREFETCH, false, GENERIC_R, true>(
                   u, psi, out, lx, ly, lz, lt, kappa, stream, 0, nullptr, r, nchain, u_chain,
                   psi_chain);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError() after the launch,
// a CUDA error if the set-up failed, or -1 if no block of the tile fits on the device. psi
// and the spinor faces must be 16-byte aligned. The halo mode's (one block of a process grid)
// end in the partition mask (bit mu: axis mu is cut) and an array of 12 face pointers (lo[0..3],
// hi[0..3], link[0..3]; those of uncut axes are not read). The chains entry points take, after
// the lattice extents, the chain count and the chain strides of the links and of the spinors
// in elements (a chain of spinors is X Y Z T 96 bytes at complex64, so every chain's rows keep
// the bulk copies' 16-byte alignment). The _r entry points are the r mode: the Wilson r
// follows kappa.
extern "C" {

int wilson_window_chains_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                             int lt, int nchain, long long u_chain, long long psi_chain,
                             double kappa, void* stream) {
  return launch_chains<float, WILSON_WINDOW_TILE_C64, false>(u, psi, out, lx, ly, lz, lt, nchain,
                                                            u_chain, psi_chain, kappa, 1.0, stream);
}

int wilson_window_chains_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                              int lt, int nchain, long long u_chain, long long psi_chain,
                              double kappa, void* stream) {
  return launch_chains<double, WILSON_WINDOW_TILE_C128, false>(
      u, psi, out, lx, ly, lz, lt, nchain, u_chain, psi_chain, kappa, 1.0, stream);
}

int wilson_window_chains_r_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                               int lt, int nchain, long long u_chain, long long psi_chain,
                               double kappa, double r, void* stream) {
  return launch_chains<float, WILSON_WINDOW_TILE_C64, true>(u, psi, out, lx, ly, lz, lt, nchain,
                                                           u_chain, psi_chain, kappa, r, stream);
}

int wilson_window_chains_r_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                                int lt, int nchain, long long u_chain, long long psi_chain,
                                double kappa, double r, void* stream) {
  return launch_chains<double, WILSON_WINDOW_TILE_C128_R, true>(
      u, psi, out, lx, ly, lz, lt, nchain, u_chain, psi_chain, kappa, r, stream);
}

int wilson_window_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                      double kappa, void* stream) {
  return launch<float, WILSON_WINDOW_TILE_C64>(u, psi, out, lx, ly, lz, lt, kappa, stream);
}

int wilson_window_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                       double kappa, void* stream) {
  return launch<double, WILSON_WINDOW_TILE_C128>(u, psi, out, lx, ly, lz, lt, kappa, stream);
}

int wilson_window_halo_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                           int lt, double kappa, int mask, const void* const* faces,
                           void* stream) {
  return launch<float, WILSON_WINDOW_TILE_C64, true>(u, psi, out, lx, ly, lz, lt, kappa, stream,
                                                     mask, faces);
}

int wilson_window_halo_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                            int lt, double kappa, int mask, const void* const* faces,
                            void* stream) {
  return launch<double, WILSON_WINDOW_TILE_C128, true>(u, psi, out, lx, ly, lz, lt, kappa,
                                                       stream, mask, faces);
}

int wilson_window_r_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz, int lt,
                        double kappa, double r, void* stream) {
  return launch<float, WILSON_WINDOW_TILE_C64, false, true>(u, psi, out, lx, ly, lz, lt, kappa,
                                                            stream, 0, nullptr, r);
}

int wilson_window_r_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                         int lt, double kappa, double r, void* stream) {
  return launch<double, WILSON_WINDOW_TILE_C128_R, false, true>(u, psi, out, lx, ly, lz, lt,
                                                                kappa, stream, 0, nullptr, r);
}

int wilson_window_halo_r_c64(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                             int lt, double kappa, double r, int mask, const void* const* faces,
                             void* stream) {
  return launch<float, WILSON_WINDOW_TILE_C64, true, true>(u, psi, out, lx, ly, lz, lt, kappa,
                                                           stream, mask, faces, r);
}

int wilson_window_halo_r_c128(const void* u, const void* psi, void* out, int lx, int ly, int lz,
                              int lt, double kappa, double r, int mask, const void* const* faces,
                              void* stream) {
  return launch<double, WILSON_WINDOW_TILE_C128_R, true, true>(u, psi, out, lx, ly, lz, lt,
                                                               kappa, stream, mask, faces, r);
}

}  // extern "C"
