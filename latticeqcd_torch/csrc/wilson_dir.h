// The per-direction Wilson hop at r = 1 in half-spinor form, shared by the wilson_hop and
// wilson_window kernels so that both use one spin rule (the tables of wilson_spin.h):
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
