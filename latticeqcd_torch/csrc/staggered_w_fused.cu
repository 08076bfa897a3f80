// staggered_w_fused: the even-odd staggered W in one launch, written for Hopper (sm_90a).
//
// Computes what the Pallas TPU kernel w_planes_window (latticeqcd_tpu/ops/dirac/
// staggered_pallas.py) computes, on packed even sites
//
//   W phi_e = m^2 phi_e - D_eo D_oe phi_e,
//   D psi(x) = 1/2 sum_mu eta_mu(x) [ U_mu(x) psi(x+mu) - U_mu(x-mu)^dag psi(x-mu) ],
//
// and, like it, keeps the odd intermediate d1 = D_oe phi_e on chip. Layout as staggered_w.cu:
// fields [X/2, Y, Z, T, 3], links [4, X/2, Y, Z, T, 3, 3] per parity, boundary phases in the
// links, KS signs from the coordinates (x = 2x' + off: eta_2 = (-1)^off, eta_3 = (-1)^(off+y),
// eta_4 = (-1)^(off+y+z)), every extent even. It is the redesign of staggered_w.cu's W (two
// launches of the hop kernel, d1 through device memory), which it does not beat on the H100:
// the paths keep the two-launch W, and this kernel stays built and checked beside it.
//
// What bounds it: device memory. W does about 1150 flop per even site against at least 624 B
// at complex64 (the 576 B of links of both parities once, 24 B in, 24 B out): 40.9 MB, 12.2 us
// at 3.35 TB/s on 16^3 x 32 (24.4 us at complex128). The two-launch W reads every link twice.
//
// The design. A block owns a tile of BX x BY x BZ packed (x', y, z) rows over a t segment,
// three lanes per site (one per colour a, as in wilson_hop_packed.cu), and each position holds
// an even and an odd site. A cluster of CX x CY x CZ blocks (cudaLaunchKernelEx with a cluster
// dimension) makes one larger tile; its blocks read each other's shared memory
// (map_shared_rank). Half-hop pushes let each site's links serve both halves of W:
//   0. even site e: p_mu(e) = U_mu(e)^dag phi(e) into shared memory;       cluster.sync()
//   1. odd site o: d1(o) = 1/2 sum eta [U_mu(o) phi(o+mu) - p_mu(o-mu)], with phi and p from
//      the cluster's shared memory. The block also computes d1 on the odd sites just outside
//      the cluster that its edge sites need (the outer halo), its links read through L2;
//                                                                          cluster.sync()
//      q_mu(o) = U_mu(o)^dag d1(o) into shared memory (over p);            cluster.sync()
//   2. even site e: W = m^2 phi(e) - 1/2 sum eta [U_mu(e) d1(e+mu) - q_mu(e-mu)], d1 and q from
//      the cluster's shared memory, or from the halo (q there from the halo's d1 and its link).
// d1 never leaves the chip. Each phase reads the row or column of its own site's links that it
// needs from device memory, so the L1 may serve a link's second read. What the halo costs: a
// tile of EX x EY x EZ rows over t segments of length L computes d1 on
//   r = 1 + 1/EX + 2/EY + 2/EZ (+ 2/L where t is cut)
// odd sites per even site (a term is 0 where the tile spans the extent whole), each reading
// 8 links: 576 r B of links per even site against 1152 B for the two-launch W. One block of
// 2 x 2 x 2 rows alone has r = 3.5; a cluster of 16 such blocks (8 x 4 x 4 rows at 16^3) has
// r = 2.0, no less traffic than two launches, its halo links coming from L2 at best.
//
// What each step measured (cold, 16^3 x 32, NVIDIA H100 80GB HBM3 at 700 W, the two-launch W
// 30.2-31.3 us at complex64 and 69.5-72.8 us at complex128 in the same calls; timed by a
// variant timer since removed with the steps' switches, so these rows cannot be re-run):
//   1. links kept in registers across the barriers (row a of U(e), column a of U(o)): 768-thread
//      blocks spilled (80 registers, 164 B) and took 90-111 us at complex64 for clusters of 1,
//      8 and 16 blocks (c128 204-248 us); reading the link rows again instead, 79 us (124);
//   2. the block's own links staged in shared memory by bulk copies (147 KB a block): 76-94 us
//      (130-145); the per-block phase clocks showed three waves of blocks (seven 16-block
//      clusters fit on the card at once), each block 27 us long, of which ~10 us were the halo
//      (its sites taking four times an own site's time: 8-byte loads of scattered links
//      through L1) and ~6 us the wait for the bulk copies at the memory's rate;
//   3. the halo spread evenly over the lanes and its hop computed from coordinates: the
//      landed kernel (no staging, no links held) 70.1-70.8 us at complex64, 123.4-123.7 at
//      complex128, with 16-block clusters of 2 x 2 x 2 rows (8 x 4 x 4 at 16^3); clusters of 1
//      and 8, t segments of 16 with two blocks per SM, and a 4 x 4 x 8 tile: 82-91 us (124-130).
// So the one-launch W stays 2.3x (c64) and 1.8x (c128) slower than two launches: r >= 2 and
// the halo's scattered loads cost at least the second pass that they replace, and the
// barriers and cluster waves serialise memory and compute that two launches overlap.
// Tiles of the entry points: 2 x 2 x 2-row blocks in 4 x 2 x 2-block clusters, t whole up to
// 32 at complex64 (768 threads, 80 registers, 56 KB of shared memory, one block per SM) and
// cut into segments of at most 16 at complex128 (384 threads, 168 registers, 56 KB).
//
// Shapes: every position holds the row at its wrapped coordinate and a neighbour is looked up
// by its wrapped distance from the cluster's origin, so X/2 = 1, extent-2 y, z or T, tiles that
// wrap onto themselves and extents that the tile does not divide need no special case (a
// lattice smaller than one tile runs as one cluster); lanes outside the lattice compute on
// wrapped coordinates and do not write. Indexing is 32-bit (the wrapper's volume limit).
#include "cluster.h"
#include "lattice_site.h"

#include <atomic>

// The tiles of the C entry points, one per type: BX, BY, BZ (a block's packed x', y, z rows),
// CX, CY, CZ (blocks of a cluster along x', y, z), TSMAX (the longest t segment), MINB (blocks
// per SM).
#define STAGGERED_W_TILE_C64 2, 2, 2, 4, 2, 2, 32, 1
#define STAGGERED_W_TILE_C128 2, 2, 2, 4, 2, 2, 16, 1
namespace {

namespace cg = cooperative_groups;

// Component a of U^dag v, for the 3 x 3 link at u: sum_b conj(U[b][a]) v[b].
template <typename V>
__device__ __forceinline__ V udag_lane(const V* __restrict__ u, int a, const V* v) {
  return cadd(cadd(cmulc(u[a], v[0]), cmulc(u[3 + a], v[1])), cmulc(u[6 + a], v[2]));
}

// Component a of U v: sum_b U[a][b] v[b], with row a of U given.
template <typename V>
__device__ __forceinline__ V u_lane(const V (&row)[3], const V* v) {
  return cadd(cadd(cmul(row[0], v[0]), cmul(row[1], v[1])), cmul(row[2], v[2]));
}

// acc +- d, by the KS sign
template <typename V>
__device__ __forceinline__ V signed_add(V acc, V d, bool neg) {
  return neg ? csub(acc, d) : cadd(acc, d);
}

// Component a of D psi at the site (x, y, z, t) of parity `parity`, links and field read
// from device memory (the outer halo of the cluster).
template <typename V>
__device__ V hop_lane(const V* __restrict__ u_fwd, const V* __restrict__ u_bwd,
                      const V* __restrict__ psi, int x, int y, int z, int t, int x2, int ly,
                      int lz, int lt, int parity, int a) {
  using R = decltype(V{}.x);
  const int sz = lt, sy = lz * lt, sx = ly * sy, vol = x2 * sx;
  const int s = x * sx + y * sy + z * sz + t, off = ((y + z + t) & 1) ^ parity;
  const int xf = x + off == x2 ? 0 : x + off, xb = x - 1 + off < 0 ? x2 - 1 : x - 1 + off;
  const int fw[4] = {s + (xf - x) * sx, s + (y + 1 == ly ? 1 - ly : 1) * sy,
                     s + (z + 1 == lz ? 1 - lz : 1) * sz, s + (t + 1 == lt ? 1 - lt : 1)};
  const int bw[4] = {s + (xb - x) * sx, s + (y == 0 ? ly - 1 : -1) * sy,
                     s + (z == 0 ? lz - 1 : -1) * sz, s + (t == 0 ? lt - 1 : -1)};
  const bool neg[4] = {false, off != 0, ((off + y) & 1) != 0, ((off + y + z) & 1) != 0};
  V acc{R(0), R(0)};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    const V* uf = u_fwd + 9 * (mu * vol + s);
    const V row[3] = {uf[3 * a], uf[3 * a + 1], uf[3 * a + 2]};
    const V d = csub(u_lane(row, psi + 3 * fw[mu]),
                     udag_lane(u_bwd + 9 * (mu * vol + bw[mu]), a, psi + 3 * bw[mu]));
    acc = signed_add(acc, d, neg[mu]);
  }
  return V{R(0.5) * acc.x, R(0.5) * acc.y};
}

// A neighbour of a tile site: its packed site index s and, inside the cluster, the block
// (rank) and the position (slot) that hold it; outside (rank < 0), slot indexes the halo.
struct Nb {
  int s, rank, slot;
};

// One block per BX x BY x BZ rows over a t segment of ts sites, 3 * BX * BY * BZ * ts threads:
// thread tid is colour a = tid % 3 of position tid / 3 (t fastest, then z, y, x').
// Shared memory, in complex values: phi [ns][3], p then q [4][ns][3], d1 [ns][3], the halo's
// d1 [nh][3] (ns = BX BY BZ ts positions; halo faces x', y, z of ts sites per row, then t).
template <typename R, int BX, int BY, int BZ, int CX, int CY, int CZ, int TSMAX, int MINB>
__global__ void __launch_bounds__(3 * BX * BY * BZ * TSMAX, MINB)
    staggered_w_fused_kernel(const typename Vec<R>::type* __restrict__ u_e,
                             const typename Vec<R>::type* __restrict__ u_o,
                             const typename Vec<R>::type* __restrict__ phi,
                             typename Vec<R>::type* __restrict__ out, int x2, int ly, int lz,
                             int lt, int ts, R m2) {
  using V = typename Vec<R>::type;
  constexpr int C = CX * CY * CZ, EX = CX * BX, EY = CY * BY, EZ = CZ * BZ;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = BX * BY * BZ * ts;
  const int hy = 2 * BY * BZ * ts, hz = hy + 2 * BX * BZ * ts, ht = hz + 2 * BX * BY * ts;
  const int nh = ht + 2 * BX * BY * BZ;
  V* const sm = reinterpret_cast<V*>(dynamic_smem());
  V* const s_pq = sm + 3 * ns;
  V* const s_d1 = sm + 15 * ns;
  V* const s_halo = sm + 18 * ns;
  // the shared memory of block r of the cluster
  auto block_smem = [&](int r) { return r == rank ? sm : cluster.map_shared_rank(sm, r); };

  // the cluster's origin (cx0, cy0, cz0, t0) and this block's place (rx, ry, rz) in it
  const int ncy = (ly + EY - 1) / EY, ncz = (lz + EZ - 1) / EZ, nts = (lt + ts - 1) / ts;
  int k = blockIdx.x / C;
  const int t0 = k % nts * ts;
  k /= nts;
  const int cz0 = k % ncz * EZ;
  k /= ncz;
  const int cy0 = k % ncy * EY;
  const int cx0 = k / ncy * EX;
  const int rz = rank % CZ, ry = rank / CZ % CY, rx = rank / (CY * CZ);

  const int tid = threadIdx.x, a = tid % 3, slot = tid / 3;
  const int it = slot % ts, iz = slot / ts % BZ, iy = slot / (ts * BZ) % BY,
            ix = slot / (ts * BZ * BY);
  const int px = rx * BX + ix, py = ry * BY + iy, pz = rz * BZ + iz;  // in the cluster
  const bool valid = cx0 + px < x2 && cy0 + py < ly && cz0 + pz < lz && t0 + it < lt;
  const int x = (cx0 + px) % x2, y = (cy0 + py) % ly, z = (cz0 + pz) % lz, t = (t0 + it) % lt;
  const int sz = lt, sy = lz * lt, sx = ly * sy, vol = x2 * sx;
  const int s = x * sx + y * sy + z * sz + t;
  const int off_e = (y + z + t) & 1, off_o = off_e ^ 1;
  const bool neg_e[4] = {false, off_e != 0, ((off_e + y) & 1) != 0, ((off_e + y + z) & 1) != 0};
  const bool neg_o[4] = {false, off_o != 0, ((off_o + y) & 1) != 0, ((off_o + y + z) & 1) != 0};

  // The neighbour of this position along mu (forward or backward) for a target of row
  // offset `off`: in the cluster, or a slot of the halo face on that side.
  auto find = [&](int mu, bool fwd, int off) -> Nb {
    if (mu == 0) {
      const int dx = fwd ? off : off - 1;
      if (dx == 0) return Nb{s, rank, slot};
      int nx = x + dx;
      nx = nx < 0 ? nx + x2 : (nx >= x2 ? nx - x2 : nx);
      const int ns_ = s + (nx - x) * sx;
      int rel = nx - cx0;
      rel = rel < 0 ? rel + x2 : rel;
      if (rel < EX)
        return Nb{ns_, ((rel / BX) * CY + ry) * CZ + rz, (((rel % BX) * BY + iy) * BZ + iz) * ts + it};
      return Nb{ns_, -1, ((fwd * BY + iy) * BZ + iz) * ts + it};
    }
    if (mu == 1) {
      int ny = y + (fwd ? 1 : -1);
      ny = ny < 0 ? ny + ly : (ny >= ly ? ny - ly : ny);
      const int ns_ = s + (ny - y) * sy;
      int rel = ny - cy0;
      rel = rel < 0 ? rel + ly : rel;
      if (rel < EY)
        return Nb{ns_, (rx * CY + rel / BY) * CZ + rz, ((ix * BY + rel % BY) * BZ + iz) * ts + it};
      return Nb{ns_, -1, hy + ((fwd * BX + ix) * BZ + iz) * ts + it};
    }
    if (mu == 2) {
      int nz = z + (fwd ? 1 : -1);
      nz = nz < 0 ? nz + lz : (nz >= lz ? nz - lz : nz);
      const int ns_ = s + (nz - z) * sz;
      int rel = nz - cz0;
      rel = rel < 0 ? rel + lz : rel;
      if (rel < EZ)
        return Nb{ns_, (rx * CY + ry) * CZ + rel / BZ, ((ix * BY + iy) * BZ + rel % BZ) * ts + it};
      return Nb{ns_, -1, hz + ((fwd * BX + ix) * BY + iy) * ts + it};
    }
    int nt = t + (fwd ? 1 : -1);
    nt = nt < 0 ? nt + lt : (nt >= lt ? nt - lt : nt);
    const int ns_ = s + nt - t;
    int rel = nt - t0;
    rel = rel < 0 ? rel + lt : rel;
    if (rel < ts) return Nb{ns_, rank, slot - it + rel};
    return Nb{ns_, -1, ht + fwd * BX * BY * BZ + (ix * BY + iy) * BZ + iz};
  };

  // this position's link of parity par (0 even, 1 odd) in direction mu; each phase reads the
  // row or column that it needs, and the L1 may keep the link from one phase to the next
  auto link = [&](int par, int mu) { return (par ? u_o : u_e) + 9 * (mu * vol + s); };

  // 0. p_mu(e) = U_mu(e)^dag phi(e)
  const V ph[3] = {phi[3 * s], phi[3 * s + 1], phi[3 * s + 2]}, ph_a = phi[3 * s + a];
  sm[3 * slot + a] = ph_a;
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) s_pq[3 * (mu * ns + slot) + a] = udag_lane(link(0, mu), a, ph);
  cluster.sync();

  // 1. d1(o) = 1/2 sum eta [U_mu(o) phi(o+mu) - p_mu(o-mu)]
  V acc{R(0), R(0)};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    const V* u = link(1, mu);
    const V row[3] = {u[3 * a], u[3 * a + 1], u[3 * a + 2]};
    const Nb f = find(mu, true, off_o), bk = find(mu, false, off_o);
    V d = u_lane(row, f.rank >= 0 ? block_smem(f.rank) + 3 * f.slot : phi + 3 * f.s);
    d = csub(d, bk.rank >= 0 ? block_smem(bk.rank)[3 * ns + 3 * (mu * ns + bk.slot) + a]
                             : udag_lane(u_e + 9 * (mu * vol + bk.s), a, phi + 3 * bk.s));
    acc = signed_add(acc, d, neg_o[mu]);
  }
  s_d1[3 * slot + a] = V{R(0.5) * acc.x, R(0.5) * acc.y};

  // the outer halo: d1 on the odd sites beside this block's faces that lie outside the
  // cluster; of an x' face only the half that an edge site's off sends there. The active
  // faces' sites are numbered in one range, spread over all lanes.
  {
    const int ext[4] = {x2, ly, lz, lt}, org[4] = {cx0, cy0, cz0, t0};
    const int tile[4] = {EX, EY, EZ, ts}, base[4] = {0, hy, hz, ht};
    const int first[4] = {cx0 + rx * BX, cy0 + ry * BY, cz0 + rz * BZ, t0};
    const int width[4] = {BX, BY, BZ, ts};
    const int size[4] = {BY * BZ * ts / 2, BX * BZ * ts, BX * BY * ts, BX * BY * BZ};
    int end[8], na = 0;  // face k = 2 axis + side ends at end[k] in the numbering
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ax = k >> 1, side = k & 1;
      const int c = (first[ax] + (side ? width[ax] : ext[ax] - 1)) % ext[ax];
      if ((c - org[ax] + ext[ax]) % ext[ax] >= tile[ax]) na += size[ax];
      end[k] = na;
    }
    for (int i = tid; i < 3 * na; i += 3 * ns) {
      int h = i / 3, k = 0;
      while (h >= end[k]) ++k;
      h -= k ? end[k - 1] : 0;
      const int ax = k >> 1, side = k & 1;
      int j[4];  // the edge site's place in the block: x', y, z, t
      if (ax == 0) {
        j[3] = 2 * (h % (ts / 2)), h /= ts / 2, j[2] = h % BZ, j[1] = h / BZ;
      } else if (ax == 1) {
        j[3] = h % ts, h /= ts, j[2] = h % BZ, j[0] = h / BZ;
      } else if (ax == 2) {
        j[3] = h % ts, h /= ts, j[1] = h % BY, j[0] = h / BY;
      } else {
        j[2] = h % BZ, h /= BZ, j[1] = h % BY, j[0] = h / BY;
      }
      j[ax] = side ? width[ax] - 1 : 0;
      int c[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) c[m] = (first[m] + j[m]) % ext[m];
      // an x' face holds the sites of the edge whose off (the even site's) equals the side
      if (ax == 0 && ((c[1] + c[2] + c[3]) & 1) != side) c[3] = (c[3] + 1) % lt, ++j[3];
      c[ax] = (c[ax] + (side ? 1 : ext[ax] - 1)) % ext[ax];
      const int pos = ax == 0 ? ((side * BY + j[1]) * BZ + j[2]) * ts + j[3]
                    : ax == 1 ? ((side * BX + j[0]) * BZ + j[2]) * ts + j[3]
                    : ax == 2 ? ((side * BX + j[0]) * BY + j[1]) * ts + j[3]
                              : side * BX * BY * BZ + (j[0] * BY + j[1]) * BZ + j[2];
      s_halo[3 * (base[ax] + pos) + i % 3] =
          hop_lane(u_o, u_e, phi, c[0], c[1], c[2], c[3], x2, ly, lz, lt, 1, i % 3);
    }
  }
  cluster.sync();

  // q_mu(o) = U_mu(o)^dag d1(o), over p
  const V d1o[3] = {s_d1[3 * slot], s_d1[3 * slot + 1], s_d1[3 * slot + 2]};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) s_pq[3 * (mu * ns + slot) + a] = udag_lane(link(1, mu), a, d1o);
  cluster.sync();

  // 2. W = m^2 phi(e) - 1/2 sum eta [U_mu(e) d1(e+mu) - q_mu(e-mu)]
  acc = V{R(0), R(0)};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    const V* u = link(0, mu);
    const V row[3] = {u[3 * a], u[3 * a + 1], u[3 * a + 2]};
    const Nb f = find(mu, true, off_e), bk = find(mu, false, off_e);
    V d = u_lane(row, f.rank >= 0 ? block_smem(f.rank) + 15 * ns + 3 * f.slot
                                     : s_halo + 3 * f.slot);
    d = csub(d, bk.rank >= 0 ? block_smem(bk.rank)[3 * ns + 3 * (mu * ns + bk.slot) + a]
                             : udag_lane(u_o + 9 * (mu * vol + bk.s), a, s_halo + 3 * bk.slot));
    acc = signed_add(acc, d, neg_e[mu]);
  }
  if (valid) out[3 * s + a] = V{m2 * ph_a.x - R(0.5) * acc.x, m2 * ph_a.y - R(0.5) * acc.y};
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

// Launch on a grid of clusters: t is cut into the fewest segments of at most TSMAX sites.
template <typename R, int BX, int BY, int BZ, int CX, int CY, int CZ, int TSMAX, int MINB>
int launch(const void* u_e, const void* u_o, const void* phi, void* out, int x2, int ly, int lz,
           int lt, double m2, void* stream) {
  using V = typename Vec<R>::type;
  constexpr int C = CX * CY * CZ, ROWS = BX * BY * BZ;
  static_assert(3 * ROWS * TSMAX <= 1024, "a block has at most 1024 threads");
  auto* kernel = staggered_w_fused_kernel<R, BX, BY, BZ, CX, CY, CZ, TSMAX, MINB>;
  auto smem_bytes = [](int ts) {
    const int nh = 2 * ts * (BY * BZ + BX * BZ + BX * BY) + 2 * ROWS;
    return static_cast<size_t>(18 * ROWS * ts + 3 * nh) * sizeof(V);
  };
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = static_cast<cudaStream_t>(stream);

  // once per device: opt in to the shared memory and the cluster size, and make sure a
  // cluster fits (threads that race here set the same attributes twice, which is harmless)
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(TSMAX)));
    if (err == cudaSuccess && C > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(3 * ROWS * TSMAX);
    cfg.dynamicSmemBytes = smem_bytes(TSMAX);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return -1;
    if (dev < MAX_DEVICES) ready[dev].store(true, std::memory_order_release);
  }
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = ((lt + nts - 1) / nts + 1) / 2 * 2;
  const int grid = ((x2 + CX * BX - 1) / (CX * BX)) * ((ly + CY * BY - 1) / (CY * BY)) *
                   ((lz + CZ * BZ - 1) / (CZ * BZ)) * ((lt + ts - 1) / ts);
  cfg.gridDim = dim3(grid * C);
  cfg.blockDim = dim3(3 * ROWS * ts);
  cfg.dynamicSmemBytes = smem_bytes(ts);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const V*>(u_e), static_cast<const V*>(u_o),
                           static_cast<const V*>(phi), static_cast<V*>(out), x2, ly, lz, lt, ts,
                           static_cast<R>(m2));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), with the arguments of staggered_w.cu's two-launch
// W less its d1 buffer. Each returns cudaGetLastError() after its one launch, a CUDA error if
// the launch was refused, or -1 if no cluster of the tile fits on the device.
extern "C" {

int staggered_w_fused_c64(const void* u_e, const void* u_o, const void* phi, void* out, int x2,
                          int ly, int lz, int lt, double m2, void* stream) {
  return launch<float, STAGGERED_W_TILE_C64>(u_e, u_o, phi, out, x2, ly, lz, lt, m2, stream);
}

int staggered_w_fused_c128(const void* u_e, const void* u_o, const void* phi, void* out, int x2,
                           int ly, int lz, int lt, double m2, void* stream) {
  return launch<double, STAGGERED_W_TILE_C128>(u_e, u_o, phi, out, x2, ly, lz, lt, m2, stream);
}

}  // extern "C"
