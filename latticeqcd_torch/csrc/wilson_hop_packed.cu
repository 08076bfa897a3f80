// wilson_hop_packed: the packed even-odd Wilson hop at r = 1, redesigned for Hopper (sm_90a).
//
// Replaces, on every packed hop of the HMC, force and measurement paths, the Pallas TPU
// kernel dslash_planes (latticeqcd_tpu/ops/dirac/wilson_pallas.py) in the form the port
// needs: out = H psi_s on the target-parity sites of the packed layout [X/2, Y, Z, T, 4, 3]
// (ops/dirac/eo_pack.py: full x = 2x' + off, off = (y + z + t + parity) mod 2), forward
// links u_t from the target parity, backward links u_s from the source parity, both
// [4, X/2, Y, Z, T, 3, 3]; the same function and C signature as wilson_hop.cu's packed
// mode, which stays built beside it as the yardstick.
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
// Shapes: every row slot holds the row at its wrapped coordinate, so X/2 = 1 (x' +- 1 onto
// x'), an extent 2 in y or z (the halo onto the brick), T = 2 (t + 1 and t - 1 one site)
// and extents that the brick does not divide need no special case; lanes whose site lies
// outside the lattice compute on wrapped coordinates and do not write.
#include "tma.h"
#include "wilson_dir.h"

// The bricks of the C entry points: BY, BZ (the brick's y and z rows), TSMAX (its longest t
// segment, even), MINB (blocks per SM for __launch_bounds__).
#define WILSON_BRICK_C64 1, 2, 32, 4
#define WILSON_BRICK_C128 2, 1, 16, 5

namespace {

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

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
  // The (x', y, z) row held by slot i, for the brick at (x, y0, z0), wrapped into the lattice.
  __device__ static void row(int i, int x, int y0, int z0, int x2, int ly, int lz, int& rx,
                             int& ry, int& rz) {
    if (i < 3 * OWN) {
      rx = wrap(x + i / OWN - 1, x2);
      ry = wrap(y0 + i % OWN / BZ, ly);
      rz = wrap(z0 + i % BZ, lz);
    } else if (i < 3 * OWN + 2 * BZ) {
      const int j = i - 3 * OWN;
      rx = x;
      ry = wrap(y0 - 1 + j / BZ * (BY + 1), ly);
      rz = wrap(z0 + j % BZ, lz);
    } else {
      const int j = i - 3 * OWN - 2 * BZ;
      rx = x;
      ry = wrap(y0 + j % BY, ly);
      rz = wrap(z0 - 1 + j / BY * (BZ + 1), lz);
    }
  }
};

// The 12 complex values of one spinor site, as 16-byte loads.
__device__ __forceinline__ void load_site(const float2* __restrict__ p, float2 (&v)[12]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float4 f = q[i];
    v[2 * i] = float2{f.x, f.y};
    v[2 * i + 1] = float2{f.z, f.w};
  }
}

__device__ __forceinline__ void load_site(const double2* __restrict__ p, double2 (&v)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = p[i];
}

// acc[sp] += colour a of (1 - g_mu) U psi (forward, ul = row a of U) or of
// (1 + g_mu) U^dag psi (backward, ul = column a of U) for the neighbour spinor at nb.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void lane_hop(V (&acc)[4], const V* __restrict__ nb, const V (&ul)[3]) {
  V site[12], half[2][3];
  load_site(nb, site);
  project<MU, BWD>(site, half);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    V phi;
    if (BWD)
      phi = cadd(cadd(cmulc(ul[0], half[h][0]), cmulc(ul[1], half[h][1])),
                 cmulc(ul[2], half[h][2]));
    else
      phi = cadd(cadd(cmul(ul[0], half[h][0]), cmul(ul[1], half[h][1])), cmul(ul[2], half[h][2]));
    acc[h] = cadd(acc[h], phi);
    acc[w_j(MU, h)] = cadd(acc[w_j(MU, h)], ipow(w_k(MU, h) + (BWD ? 2 : 0), phi));
  }
}

// Row a (forward) or column a (backward) of the 3 x 3 link at u.
template <bool BWD, typename V>
__device__ __forceinline__ void load_link_line(const V* __restrict__ u, int a, V (&ul)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) ul[b] = BWD ? u[3 * b + a] : u[3 * a + b];
}

// One block per brick: (x', BY y rows from y0, BZ z rows from z0, t segment [t0, t0 + ts)).
// Thread tid is colour a = tid % 3 of brick site tid / 3, t fastest. Thread 0 first copies
// the brick's source spinor rows into shared memory.
template <typename R, int BY, int BZ, int TSMAX, int MINB>
__global__ void __launch_bounds__(3 * BY * BZ * TSMAX, MINB)
    wilson_hop_brick_kernel(const typename Vec<R>::type* __restrict__ u_t,
                            const typename Vec<R>::type* __restrict__ u_s,
                            const typename Vec<R>::type* __restrict__ psi,
                            typename Vec<R>::type* __restrict__ out, int x2, int ly, int lz, int lt,
                            int ts, int parity) {
  using V = typename Vec<R>::type;
  using S = Slots<BY, BZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  const V* rows = reinterpret_cast<const V*>(smem);

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
      S::row(i, x, y0, z0, x2, ly, lz, rx, ry, rz);
      bulk_copy_g2s(smem + i * ts * 12 * sizeof(V), psi + 12 * (rx * sx + ry * sy + rz * lt + t0),
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

  V uf[3], ub[3];  // the first links' loads overlap the wait for the copies
  load_link_line<false>(u_t + 9 * s, a, uf);
  load_link_line<true>(u_s + 9 * bx, a, ub);

  V acc[4];
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) acc[sp] = V{R(0), R(0)};

  mbar_wait(&bar, 0);

  // x: the x' + off (forward) and x' - (1 - off) (backward) rows, same t
  lane_hop<0, false>(acc, nb(S::xrow(off, iy, iz), it), uf);
  lane_hop<0, true>(acc, nb(S::xrow(off - 1, iy, iz), it), ub);
  // y: a row of the brick or a halo row
  load_link_line<false>(u_t + 9 * (vol + s), a, uf);
  load_link_line<true>(u_s + 9 * (vol + by), a, ub);
  lane_hop<1, false>(acc, nb(iy + 1 < BY ? S::xrow(0, iy + 1, iz) : S::yhalo(1, iz), it), uf);
  lane_hop<1, true>(acc, nb(iy > 0 ? S::xrow(0, iy - 1, iz) : S::yhalo(0, iz), it), ub);
  // z
  load_link_line<false>(u_t + 9 * (2 * vol + s), a, uf);
  load_link_line<true>(u_s + 9 * (2 * vol + bz), a, ub);
  lane_hop<2, false>(acc, nb(iz + 1 < BZ ? S::xrow(0, iy, iz + 1) : S::zhalo(1, iy), it), uf);
  lane_hop<2, true>(acc, nb(iz > 0 ? S::xrow(0, iy, iz - 1) : S::zhalo(0, iy), it), ub);
  // t: in the own row's segment (which wraps when it is the whole row), else device memory
  const bool fin = tf - t0 >= 0 && tf - t0 < cnt, bin = tb - t0 >= 0 && tb - t0 < cnt;
  load_link_line<false>(u_t + 9 * (3 * vol + s), a, uf);
  load_link_line<true>(u_s + 9 * (3 * vol + s - t + tb), a, ub);
  lane_hop<3, false>(acc, fin ? nb(S::xrow(0, iy, iz), tf - t0) : psi + 12 * (s - t + tf), uf);
  lane_hop<3, true>(acc, bin ? nb(S::xrow(0, iy, iz), tb - t0) : psi + 12 * (s - t + tb), ub);

  if (valid) {
    V* o = out + 12 * s + a;
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) o[3 * sp] = acc[sp];
  }
}

// Launch on a grid of bricks: t is cut into the fewest segments of at most TSMAX sites, of
// even length (so that a segment of spinors is a whole number of 16-byte units).
template <typename R, int BY, int BZ, int TSMAX, int MINB>
int launch(const void* u_t, const void* u_s, const void* psi, void* out, int x2, int ly, int lz,
           int lt, int parity, void* stream) {
  using V = typename Vec<R>::type;
  using S = Slots<BY, BZ>;
  static_assert(TSMAX % 2 == 0, "t segments are of even length");
  static_assert(S::ROWS * 12 * TSMAX * sizeof(V) <= 48 * 1024,
                "the brick's rows fit the shared memory a launch gets without opting in");
  const int nts = (lt + TSMAX - 1) / TSMAX;
  const int ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int bytes = S::ROWS * 12 * ts * static_cast<int>(sizeof(V));
  const int blocks = x2 * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * ((lt + ts - 1) / ts);
  wilson_hop_brick_kernel<R, BY, BZ, TSMAX, MINB>
      <<<blocks, 3 * BY * BZ * ts, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(u_t), static_cast<const V*>(u_s), static_cast<const V*>(psi),
          static_cast<V*>(out), x2, ly, lz, lt, ts, parity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), with the signature of wilson_hop.cu's packed
// mode. Each returns cudaGetLastError() after the launch. psi_s must be 16-byte aligned.
extern "C" {

int wilson_hop_brick_c64(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                         int ly, int lz, int lt, int target_parity, void* stream) {
  return launch<float, WILSON_BRICK_C64>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity,
                                         stream);
}

int wilson_hop_brick_c128(const void* u_t, const void* u_s, const void* psi_s, void* out, int x2,
                          int ly, int lz, int lt, int target_parity, void* stream) {
  return launch<double, WILSON_BRICK_C128>(u_t, u_s, psi_s, out, x2, ly, lz, lt, target_parity,
                                           stream);
}

}  // extern "C"
