// Shared device code of the deplex_tpu_torch kernels: warp- and block-wide
// reductions and the 3x3 smallest-eigenvector plane fit.
//
// The fit mirrors ops/eigh3x3.py:eigh3x3_min + ops/growing.py:fit_plane
// operation for operation (Cardano's eigenvalues with a real atan2, the
// best-conditioned cross-product eigenvector, d >= 0 orientation), so the
// merge kernel refits planes as the plain PyTorch twin does. As there,
// atan2, cos and sin are taken in double and rounded to float, which gives
// the same bits as the twin on the card and on the CPU (sqrtf is correctly
// rounded, as the twin's double sqrt rounded to float is). The library is
// built with -fmad=false so that no multiply-add contraction changes the
// rounding against the twin.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace dplx {

constexpr unsigned kFullMask = 0xffffffffu;

// (value, index) pair order for "largest value, first index on ties".
__device__ __forceinline__ bool better_max(int v, int i, int v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// (value, index) pair order for "smallest value, first index on ties".
__device__ __forceinline__ bool better_min(float v, int i, float v2, int i2) {
  return v < v2 || (v == v2 && i < i2);
}

// Block-wide (value, index) reduction; every thread returns the winner.
// blockDim.x must be a multiple of 32. sv/si hold >= 32 entries.
template <bool kMax, typename T>
__device__ void block_arg_reduce(T& v, int& i, T* sv, int* si, T identity) {
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_down_sync(kFullMask, v, off);
    int i2 = __shfl_down_sync(kFullMask, i, off);
    bool take = kMax ? better_max((int)v2, i2, (int)v, i)
                     : better_min((float)v2, i2, (float)v, i);
    if (take) { v = v2; i = i2; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : identity;
    i = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      T v2 = __shfl_down_sync(kFullMask, v, off);
      int i2 = __shfl_down_sync(kFullMask, i, off);
      bool take = kMax ? better_max((int)v2, i2, (int)v, i)
                       : better_min((float)v2, i2, (float)v, i);
      if (take) { v = v2; i = i2; }
    }
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

// Warp-wide sum by an xor butterfly: float addition commutes exactly, so
// every lane ends with the same bits, in the same order on every run.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Block-wide sums of K floats in a fixed order (warp trees, then warps in
// order), so a run gives the same bits every time. red holds 32*K floats.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(kFullMask, v[k], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
  const int nw = blockDim.x >> 5;
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * K + k];
    v[k] = s;
  }
  __syncthreads();
}

// Smallest eigenpair of a symmetric 3x3 matrix from its six distinct entries
// (ops/eigh3x3.py:eigh3x3_min_soa): the ascending eigenvalues w0 <= w1 <= w2,
// multiplied back by the matrix's scale, and the unit eigenvector (vx, vy,
// vz) of w0.
struct Eig3 {
  float w0, w1, w2, vx, vy, vz;
};

__device__ inline Eig3 eigh3x3_min(float xx, float xy, float xz, float yy, float yz,
                                   float zz) {
  float scale = fmaxf(fmaxf(fmaxf(fabsf(xx), fabsf(yy)), fmaxf(fabsf(zz), fabsf(xy))),
                      fmaxf(fabsf(yz), fabsf(xz)));
  if (!(scale > 0.f)) scale = 1.f;
  const float inv = 1.f / scale;
  const float a = xx * inv, b = yy * inv, c = zz * inv;
  const float dd = xy * inv, e = yz * inv, f = xz * inv;

  // Cardano eigenvalues (ops/eigh3x3.py:_eigvals_soa).
  const float de = dd * e;
  const float d2 = dd * dd;
  const float ee = e * e;
  const float ff = f * f;
  const float m = a + b + c;
  const float c1 = (a * b + a * c + b * c) - (d2 + ee + ff);
  const float c0 = c * d2 + a * ee + b * ff - a * b * c - 2.f * f * de;
  const float p = m * m - 3.f * c1;
  const float q = m * (p - 1.5f * c1) - 13.5f * c0;
  const float sqrt_p = sqrtf(fabsf(p));
  float phi = 27.f * (0.25f * c1 * c1 * (p - c1) + c0 * (q + 6.75f * c0));
  phi = (1.f / 3.f) * (float)atan2((double)sqrtf(fabsf(phi)), (double)q);
  const float cphi = sqrt_p * (float)cos((double)phi);
  const float sphi = 0.57735026918962576f * sqrt_p * (float)sin((double)phi);
  const float wc = (1.f / 3.f) * (m - cphi);
  const float w0 = wc + cphi, w1 = wc - sphi, w2 = wc + sphi;
  const float lo = fminf(fminf(w0, w1), w2);
  const float hi = fmaxf(fmaxf(w0, w1), w2);
  // Median by the twin's min/max network: always one of the three roots.
  const float mid = fmaxf(fminf(w0, w1), fminf(fmaxf(w0, w1), w2));

  // Eigenvector of lo (ops/eigh3x3.py:_eigvec_min_soa).
  const float c0x = a - lo, c0y = dd, c0z = f;
  const float c1x = dd, c1y = b - lo, c1z = e;
  const float c2x = f, c2y = e, c2z = c - lo;
  const float v01x = c0y * c1z - c0z * c1y, v01y = c0z * c1x - c0x * c1z,
              v01z = c0x * c1y - c0y * c1x;
  const float v12x = c1y * c2z - c1z * c2y, v12y = c1z * c2x - c1x * c2z,
              v12z = c1x * c2y - c1y * c2x;
  const float v20x = c2y * c0z - c2z * c0y, v20y = c2z * c0x - c2x * c0z,
              v20z = c2x * c0y - c2y * c0x;
  const float n01 = v01x * v01x + v01y * v01y + v01z * v01z;
  const float n12 = v12x * v12x + v12y * v12y + v12z * v12z;
  const float n20 = v20x * v20x + v20y * v20y + v20z * v20z;
  const bool use12 = n12 > fmaxf(n01, n20);
  const bool use01 = !use12 && n01 >= n20;
  float vx = use12 ? v12x : (use01 ? v01x : v20x);
  float vy = use12 ? v12y : (use01 ? v01y : v20y);
  float vz = use12 ? v12z : (use01 ? v01z : v20z);
  const float nrm = sqrtf(vx * vx + vy * vy + vz * vz);
  if (nrm > 0.f) {
    const float s = 1.f / nrm;
    vx *= s; vy *= s; vz *= s;
  } else {
    vx = 0.f; vy = 0.f; vz = 1.f;
  }
  return Eig3{lo * scale, mid * scale, hi * scale, vx, vy, vz};
}

// Plane fit of a segment: scatter entries (xx, xy, xz, yy, yz, zz), coordinate
// sums and point count n (>= 1) -> unit normal (oriented so d >= 0) and d.
__device__ inline void fit_normal_d(float xx, float xy, float xz, float yy,
                                    float yz, float zz, float sx, float sy,
                                    float sz, float n, float* nx, float* ny,
                                    float* nz, float* d) {
  const Eig3 e = eigh3x3_min(xx, xy, xz, yy, yz, zz);
  // Orientation and offset (ops/growing.py:fit_plane).
  const float mx = sx / n, my = sy / n, mz = sz / n;
  const float d_raw = -(mx * e.vx + my * e.vy + mz * e.vz);
  const float sgn = d_raw > 0.f ? 1.f : -1.f;
  *nx = sgn * e.vx;
  *ny = sgn * e.vy;
  *nz = sgn * e.vz;
  *d = fabsf(d_raw);
}

}  // namespace dplx
