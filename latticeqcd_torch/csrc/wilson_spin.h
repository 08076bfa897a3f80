// Spin structure of the Wilson hop at r = 1, shared by the CUDA kernel and
// by a host-side check in the tests (which compile this header with g++).
//
// In the DeGrand-Rossi basis of ops/dirac/gammas.py every gamma_mu is block
// off-diagonal, so (1 -+ gamma_mu) = W W^dag with a 4x2 matrix W whose column
// h (h = 0, 1) is e_h + c e_j: one spin row j in {2, 3} and a coefficient
// c = i^k, a fourth root of unity. For (1 - gamma_mu) k = w_k(mu, h); for
// (1 + gamma_mu) the coefficient flips sign, k + 2. These are the tables that
// the Pallas kernel builds as _w_tables (latticeqcd_tpu/ops/dirac/wilson_pallas.py).
// The same tables give -+gamma_mu itself, which the hop at any r needs (wilson_dir.h,
// lane_hop_r): (-+gamma_mu phi)_j = i^k phi_h and (-+gamma_mu phi)_h = i^(4-k) phi_j.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

__host__ __device__ constexpr int w_j(int mu, int h) { return mu < 2 ? 3 - h : 2 + h; }

__host__ __device__ constexpr int w_k(int mu, int h) {
  return mu == 0 ? 1 : mu == 1 ? 2 * h : mu == 2 ? 1 + 2 * h : 2;
}
