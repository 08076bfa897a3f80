// The per-direction Wilson hop at r = 1 in half-spinor form, shared by the wilson_hop,
// wilson_hop_packed and wilson_window kernels so that all use one spin rule (the tables of
// wilson_spin.h), and its form at any r (lane_hop_r, below):
//
//   forward:  (1 - g_mu) U psi      = W_- (U (W_-^dag psi)),
//   backward: (1 + g_mu) U^dag psi  = W_+ (U^dag (W_+^dag psi)),
//
// with W's column h equal to e_h + i^k e_j (j = w_j(mu, h), k = w_k(mu, h), plus 2 for the
// backward sign). project() forms the two spin components of W^dag psi, mul_u / mul_udag
// apply the colour matrix to them, rebuild() adds W times the result to an accumulator.
// Spinors are 12 complex values (spin-major, colour fastest), links 9 (row-major 3x3).
#pragma once

#include "lattice_site.h"
#include "wilson_spin.h"

// i^k * a; k is a compile-time constant once the loops are unrolled.
template <typename V>
__device__ __forceinline__ V ipow(int k, V a) {
  switch (k & 3) {
    case 0:
      return a;
    case 1:
      return V{-a.y, a.x};
    case 2:
      return V{-a.x, -a.y};
    default:
      return V{a.y, -a.x};
  }
}

// half = W^dag psi for direction MU, forward (BWD false) or backward projector.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void project(const V* __restrict__ psi, V (&half)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = w_j(MU, h);
    const int k = w_k(MU, h) + (BWD ? 2 : 0);
#pragma unroll
    for (int c = 0; c < 3; ++c) half[h][c] = cadd(psi[3 * h + c], ipow(4 - k, psi[3 * j + c]));
  }
}

// out = U half (per spin component).
template <typename V>
__device__ __forceinline__ void mul_u(const V (&u)[9], const V (&half)[2][3], V (&out)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      out[h][a] = cadd(cadd(cmul(u[3 * a], half[h][0]), cmul(u[3 * a + 1], half[h][1])),
                       cmul(u[3 * a + 2], half[h][2]));
}

// out = U^dag half (per spin component).
template <typename V>
__device__ __forceinline__ void mul_udag(const V (&u)[9], const V (&half)[2][3], V (&out)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      out[h][a] = cadd(cadd(cmulc(u[a], half[h][0]), cmulc(u[3 + a], half[h][1])),
                       cmulc(u[6 + a], half[h][2]));
}

// acc += W phi for direction MU and the projector's sign.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void rebuild(V (&acc)[4][3], const V (&phi)[2][3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = w_j(MU, h);
    const int k = w_k(MU, h) + (BWD ? 2 : 0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[h][a] = cadd(acc[h][a], phi[h][a]);
      acc[j][a] = cadd(acc[j][a], ipow(k, phi[h][a]));
    }
  }
}

template <typename V>
__device__ __forceinline__ void load_link(const V* __restrict__ src, V (&u)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) u[i] = src[i];
}

// acc += (1 - g_mu) U psi (forward) or (1 + g_mu) U^dag psi (backward) for one neighbour.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void hop_one(V (&acc)[4][3], const V* __restrict__ psi,
                                        const V (&u)[9]) {
  V half[2][3], phi[2][3];
  project<MU, BWD>(psi, half);
  if (BWD)
    mul_udag(u, half, phi);
  else
    mul_u(u, half, phi);
  rebuild<MU, BWD>(acc, phi);
}

// acc += (1 - g_mu) U psi_f + (1 + g_mu) Ub^dag psi_b for one site and direction.
template <int MU, typename V>
__device__ __forceinline__ void hop_dir(V (&acc)[4][3], const V* __restrict__ psi_f,
                                        const V* __restrict__ u_f, const V* __restrict__ psi_b,
                                        const V* __restrict__ u_b) {
  V u[9];
  load_link(u_f, u);
  hop_one<MU, false>(acc, psi_f, u);
  load_link(u_b, u);
  hop_one<MU, true>(acc, psi_b, u);
}

// The per-lane forms, for kernels that give each site three lanes, one per colour row a of
// the output (wilson_hop_packed, wilson_window): a lane needs row a of a forward link and
// column a of a backward one, keeps a 4-spin accumulator of its colour and writes its own
// 4 outputs, so no reduction between lanes is needed.

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

// phi[h] = colour a of U half[h] (forward, ul = row a of U) or of U^dag half[h] (backward,
// ul = column a of U).
template <bool BWD, typename V>
__device__ __forceinline__ void lane_mul(const V (&ul)[3], const V (&half)[2][3], V (&phi)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (BWD)
      phi[h] = cadd(cadd(cmulc(ul[0], half[h][0]), cmulc(ul[1], half[h][1])),
                    cmulc(ul[2], half[h][2]));
    else
      phi[h] = cadd(cadd(cmul(ul[0], half[h][0]), cmul(ul[1], half[h][1])),
                    cmul(ul[2], half[h][2]));
}

// acc += W phi for one colour: rebuild() of a single lane.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void lane_rebuild(V (&acc)[4], const V (&phi)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc[h] = cadd(acc[h], phi[h]);
    acc[w_j(MU, h)] = cadd(acc[w_j(MU, h)], ipow(w_k(MU, h) + (BWD ? 2 : 0), phi[h]));
  }
}

// acc[sp] += colour a of (1 - g_mu) U psi (forward, ul = row a of U) or of
// (1 + g_mu) U^dag psi (backward, ul = column a of U) for the neighbour spinor at nb.
template <int MU, bool BWD, typename V>
__device__ __forceinline__ void lane_hop(V (&acc)[4], const V* __restrict__ nb, const V (&ul)[3]) {
  V site[12], half[2][3], phi[2];
  load_site(nb, site);
  project<MU, BWD>(site, half);
  lane_mul<BWD>(ul, half, phi);
  lane_rebuild<MU, BWD>(acc, phi);
}

// The same hop at any Wilson r, acc[sp] += colour a of (r - g_mu) U psi (forward) or of
// (r + g_mu) U^dag psi (backward). At r != 1, (r -+ g_mu) is not a projector, so the
// half-spinor form above does not hold; the tables of wilson_spin.h give -+g_mu instead: with
// k = w_k(mu, h) (plus 2 for the backward sign) and j = w_j(mu, h),
//   (-+g_mu phi)_j = i^k phi_h,   (-+g_mu phi)_h = i^(4 - k) phi_j,
// since (1 -+ g_mu) = W W^dag = 1 + sum_h (i^k e_j e_h^dag + i^-k e_h e_j^dag). A lane forms
// colour a of phi = U psi (or U^dag psi) for all four spins, 4 colour products where the
// half-spinor form needs 2, and adds r phi_s plus the two off-diagonal terms per h.

// phi[sp] = colour a of U psi_sp (forward, ul = row a of U) or of U^dag psi_sp (backward,
// ul = column a of U), for the 12 values of a spinor site.
template <bool BWD, typename V>
__device__ __forceinline__ void lane_mul_r(const V (&ul)[3], const V (&site)[12], V (&phi)[4]) {
#pragma unroll
  for (int sp = 0; sp < 4; ++sp)
    if (BWD)
      phi[sp] = cadd(cadd(cmulc(ul[0], site[3 * sp]), cmulc(ul[1], site[3 * sp + 1])),
                     cmulc(ul[2], site[3 * sp + 2]));
    else
      phi[sp] = cadd(cadd(cmul(ul[0], site[3 * sp]), cmul(ul[1], site[3 * sp + 1])),
                     cmul(ul[2], site[3 * sp + 2]));
}

// acc += (r -+ g_mu) phi for one colour.
template <int MU, bool BWD, typename V, typename R>
__device__ __forceinline__ void lane_rebuild_r(V (&acc)[4], const V (&phi)[4], R r) {
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) acc[sp] = cadd(acc[sp], V{r * phi[sp].x, r * phi[sp].y});
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = w_j(MU, h), k = w_k(MU, h) + (BWD ? 2 : 0);
    acc[j] = cadd(acc[j], ipow(k, phi[h]));
    acc[h] = cadd(acc[h], ipow(4 - k, phi[j]));
  }
}

// lane_hop at any r, for the neighbour spinor at nb.
template <int MU, bool BWD, typename V, typename R>
__device__ __forceinline__ void lane_hop_r(V (&acc)[4], const V* __restrict__ nb, const V (&ul)[3],
                                           R r) {
  V site[12], phi[4];
  load_site(nb, site);
  lane_mul_r<BWD>(ul, site, phi);
  lane_rebuild_r<MU, BWD>(acc, phi, r);
}

// The kernels' switch between the two forms: lane_hop at r = 1 (GENERIC_R false, r unused),
// lane_hop_r at any r.
template <int MU, bool BWD, bool GENERIC_R, typename V, typename R>
__device__ __forceinline__ void lane_hop_any(V (&acc)[4], const V* __restrict__ nb,
                                             const V (&ul)[3], R r) {
  if constexpr (GENERIC_R)
    lane_hop_r<MU, BWD>(acc, nb, ul, r);
  else
    lane_hop<MU, BWD>(acc, nb, ul);
}

// A backward term carried from one x slice to the next (wilson_window): colour a of
// U^dag psi as the two half-spinor values of (1 + g_MU) at r = 1 (N = 2), or for all four
// spins at any r (N = 4); lane_rebuild_any adds it to the accumulator in the same form.
template <int MU, typename V, int N>
__device__ __forceinline__ void lane_carry(const V (&site)[12], const V (&ul)[3], V (&carry)[N]) {
  if constexpr (N == 4) {
    lane_mul_r<true>(ul, site, carry);
  } else {
    V half[2][3];
    project<MU, true>(site, half);
    lane_mul<true>(ul, half, carry);
  }
}

template <int MU, bool BWD, typename V, int N, typename R>
__device__ __forceinline__ void lane_rebuild_any(V (&acc)[4], const V (&phi)[N], R r) {
  if constexpr (N == 4)
    lane_rebuild_r<MU, BWD>(acc, phi, r);
  else
    lane_rebuild<MU, BWD>(acc, phi);
}

// Row a (forward) or column a (backward) of the 3 x 3 link at u.
template <bool BWD, typename V>
__device__ __forceinline__ void load_link_line(const V* __restrict__ u, int a, V (&ul)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) ul[b] = BWD ? u[3 * b + a] : u[3 * a + b];
}
