// Stage-1 kernel: per-cell moments of a depth frame or an organized cloud.
//
// Replaces the TPU kernel deplex_tpu/ops/pallas_cellstats.py:_kernel (K1),
// which back-projected depth in VMEM and reduced cells with one-hot MXU
// matmuls. What it computes for each P x P cell, into 13 (B, gh, gw) planes:
// valid-pixel count; sums of x, y, z; six second moments taken about the
// cell's first pixel with the centering folded in (S(ab) - Sa*Sb/n), or the
// plainly centered form where `anchored` is 0; the mid-row and mid-column
// depth-discontinuity walks; the first-to-last pixel distance.
//
// Bound on the H100 by bytes: it reads 2 bytes of depth (or 12 of points)
// per pixel and writes 52 bytes per cell, with a few dozen flops per pixel.
// Design: one thread per cell walks its P x P pixels and keeps every sum in
// registers, so the cloud is never written and each pixel is read once
// (twice in the centered form); a 128-thread block covers 128 consecutive
// cells of one frame, grid = (cell blocks, frames). Sums run down each
// in-cell column, then across the column sums: the order of the plain twin
// (ops/cellstats.py), and close to the reference's row-then-column segment
// matmuls in rounding. x and y are formed as ((col - cx) / fx) * z with a
// true division, as the reference's back-projection does. Any P >= 1 and
// any grid are taken; for odd P the mid-row walk follows linear in-cell
// indices and wraps into the next row.
#include "common.cuh"

namespace {

struct DepthSource {
  const uint16_t* depth;  // (B, H, W)
  int H, W;
  float fx, fy, cx, cy;
  __device__ __forceinline__ float z_at(int b, int r, int c) const {
    return (float)depth[((size_t)b * H + r) * W + c];
  }
  __device__ __forceinline__ void load(int b, int r, int c, float& x, float& y,
                                       float& z) const {
    z = z_at(b, r, c);
    x = (((float)c - cx) / fx) * z;
    y = (((float)r - cy) / fy) * z;
  }
};

struct PointSource {
  const float* pts;  // (B, H, W, 3)
  int H, W;
  __device__ __forceinline__ float z_at(int b, int r, int c) const {
    return pts[(((size_t)b * H + r) * W + c) * 3 + 2];
  }
  __device__ __forceinline__ void load(int b, int r, int c, float& x, float& y,
                                       float& z) const {
    const float* p = pts + (((size_t)b * H + r) * W + c) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
  }
};

// Carried-prev discontinuity walk over linear in-cell indices
// start, start + step, ... (P steps).
template <class Src>
__device__ float discontinuities(const Src& src, int b, int r0, int c0, int P,
                                 int start, int step, float thr) {
  float prev = src.z_at(b, r0 + start / P, c0 + start % P);
  float disc = 0.f;
  for (int t = 0; t < P; ++t) {
    const int i = start + t * step;
    const float curr = src.z_at(b, r0 + i / P, c0 + i % P);
    const bool pos = curr > 0.f;
    const bool cont = pos && fabsf(curr - prev) < thr;
    if (cont) prev = curr;
    if (pos && !cont) disc += 1.f;
  }
  return disc;
}

template <class Src>
__global__ void __launch_bounds__(128)
cell_moments_kernel(Src src, int gh, int gw, int P, float thr, int anchored,
                    float* __restrict__ out) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  if (cell >= gh * gw) return;
  const int ci = cell / gw, cj = cell - ci * gw;
  const int r0 = ci * P, c0 = cj * P;
  const float n = (float)(P * P);

  float ax, ay, az;
  src.load(b, r0, c0, ax, ay, az);
  // Sums in the twin's order: down each in-cell column, then across the
  // column sums. [0] count, [1..3] x y z, [4..6] anchored x y z,
  // [7..12] anchored products xx xy xz yy yz zz.
  float tot[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) tot[k] = 0.f;
  for (int j = 0; j < P; ++j) {
    float col[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) col[k] = 0.f;
    for (int i = 0; i < P; ++i) {
      float x, y, z;
      src.load(b, r0 + i, c0 + j, x, y, z);
      col[0] += z > 0.f ? 1.f : 0.f;
      col[1] += x;
      col[2] += y;
      col[3] += z;
      if (anchored) {
        const float xs = x - ax, ys = y - ay, zs = z - az;
        col[4] += xs;
        col[5] += ys;
        col[6] += zs;
        col[7] += xs * xs;
        col[8] += xs * ys;
        col[9] += xs * zs;
        col[10] += ys * ys;
        col[11] += ys * zs;
        col[12] += zs * zs;
      }
    }
#pragma unroll
    for (int k = 0; k < 13; ++k) tot[k] += col[k];
  }
  const float cnt = tot[0], sx = tot[1], sy = tot[2], sz = tot[3];
  float sxx, sxy, sxz, syy, syz, szz;
  if (anchored) {
    const float ux = tot[4], uy = tot[5], uz = tot[6];
    sxx = tot[7] - ux * (ux / n);
    sxy = tot[8] - ux * (uy / n);
    sxz = tot[9] - ux * (uz / n);
    syy = tot[10] - uy * (uy / n);
    syz = tot[11] - uy * (uz / n);
    szz = tot[12] - uz * (uz / n);
  } else {
    // Plainly centered second pass, summed in the same order.
    const float mx = sx / n, my = sy / n, mz = sz / n;
    float q[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < P; ++j) {
      float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < P; ++i) {
        float x, y, z;
        src.load(b, r0 + i, c0 + j, x, y, z);
        const float dx = x - mx, dy = y - my, dz = z - mz;
        c[0] += dx * dx;
        c[1] += dx * dy;
        c[2] += dx * dz;
        c[3] += dy * dy;
        c[4] += dy * dz;
        c[5] += dz * dz;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) q[k] += c[k];
    }
    sxx = q[0];
    sxy = q[1];
    sxz = q[2];
    syy = q[3];
    syz = q[4];
    szz = q[5];
  }

  const float disc_h = discontinuities(src, b, r0, c0, P, P * P / 2, 1, thr);
  const float disc_v = discontinuities(src, b, r0, c0, P, P / 2, P, thr);

  float lx, ly, lz;
  src.load(b, r0 + P - 1, c0 + P - 1, lx, ly, lz);
  const float dx = ax - lx, dy = ay - ly, dz = az - lz;
  const float diam = sqrtf(dx * dx + dy * dy + dz * dz);

  const size_t plane = (size_t)B * gh * gw;
  float* o = out + (size_t)b * gh * gw + cell;
  const float vals[13] = {cnt, disc_h, disc_v, sx, sy, sz, sxx,
                          sxy, sxz, syy, syz, szz, diam};
#pragma unroll
  for (int k = 0; k < 13; ++k) o[k * plane] = vals[k];
}

template <class Src>
int launch(const Src& src, int B, int gh, int gw, int P, float thr,
           int anchored, float* out, cudaStream_t stream) {
  const int cells = gh * gw;
  if (B <= 0 || cells <= 0) return (int)cudaSuccess;
  const dim3 block(128);
  const dim3 grid((cells + 127) / 128, B);
  cell_moments_kernel<Src><<<grid, block, 0, stream>>>(src, gh, gw, P, thr,
                                                       anchored, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// depth: (B, H, W) uint16; out: (13, B, H/P, W/P) float32.
int dplx_cell_moments_depth(const void* depth, int B, int H, int W, int P,
                            float fx, float fy, float cx, float cy, float thr,
                            int anchored, void* out, void* stream) {
  DepthSource src{static_cast<const uint16_t*>(depth), H, W, fx, fy, cx, cy};
  return launch(src, B, H / P, W / P, P, thr, anchored,
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// pts: (B, H, W, 3) float32; out: (13, B, H/P, W/P) float32.
int dplx_cell_moments_points(const void* pts, int B, int H, int W, int P,
                             float thr, int anchored, void* out, void* stream) {
  PointSource src{static_cast<const float*>(pts), H, W};
  return launch(src, B, H / P, W / P, P, thr, anchored,
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

const char* dplx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
