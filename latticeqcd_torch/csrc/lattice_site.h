// Shared by the port's CUDA stencils: interleaved complex arithmetic on float2 / double2
// and the neighbour indices of a site in the full and the even-odd packed layouts.
#pragma once

#include <cuda_runtime.h>

template <typename R>
struct Vec;
template <>
struct Vec<float> {
  using type = float2;
};
template <>
struct Vec<double> {
  using type = double2;
};

template <typename V>
__device__ __forceinline__ V cadd(V a, V b) {
  return V{a.x + b.x, a.y + b.y};
}

template <typename V>
__device__ __forceinline__ V csub(V a, V b) {
  return V{a.x - b.x, a.y - b.y};
}

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return V{a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}

// conj(a) * b
template <typename V>
__device__ __forceinline__ V cmulc(V a, V b) {
  return V{a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x};
}

// a mod n in [0, n), for a coordinate one tile or halo away from the lattice
__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// Site s = ((x * ly + y) * lz + z) * lt + t of a layout with x extent lx, its coordinates,
// and the site indices of its neighbours fw[mu] (x + mu) and bw[mu] (x - mu), periodic.
// In the even-odd packed layout (PACKED, lx = X/2) a site of parity `parity` sits at the
// full x = 2x' + off with the row offset off = (y + z + t + parity) mod 2
// (ops/dirac/eo_pack.py); its x neighbours on the other parity are x' + off forward and
// x' - (1 - off) backward (eo_pack.gather_plus / gather_minus), the other directions keep x'.
struct SiteNeighbours {
  int x, y, z, t, off;
  int fw[4], bw[4];
};

template <bool PACKED>
__device__ __forceinline__ SiteNeighbours site_neighbours(int s, int lx, int ly, int lz, int lt,
                                                          int parity) {
  SiteNeighbours n;
  n.t = s % lt;
  n.z = (s / lt) % lz;
  n.y = (s / (lt * lz)) % ly;
  n.x = s / (lt * lz * ly);
  n.off = ((n.y + n.z + n.t) & 1) ^ parity;
  const int sz = lt, sy = lz * lt, sx = ly * lz * lt;
  int xf = n.x + 1, xb = n.x - 1;
  if (PACKED) {
    xf = n.x + n.off;
    xb = n.x - (1 - n.off);
  }
  xf = xf >= lx ? xf - lx : xf;
  xb = xb < 0 ? xb + lx : xb;
  n.fw[0] = s + (xf - n.x) * sx;
  n.fw[1] = s + (n.y + 1 == ly ? 1 - ly : 1) * sy;
  n.fw[2] = s + (n.z + 1 == lz ? 1 - lz : 1) * sz;
  n.fw[3] = s + (n.t + 1 == lt ? 1 - lt : 1);
  n.bw[0] = s + (xb - n.x) * sx;
  n.bw[1] = s + (n.y == 0 ? ly - 1 : -1) * sy;
  n.bw[2] = s + (n.z == 0 ? lz - 1 : -1) * sz;
  n.bw[3] = s + (n.t == 0 ? lt - 1 : -1);
  return n;
}
