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
// What bounds it on the H100: its bytes (2 of depth or 12 of points a
// pixel in, 52 a cell out: 39 MB in and 10 MB out at TUM B=64, 15 us at
// 3.35 TB/s), closely followed by its float work: about 24 operations a
// pixel, none fused (-fmad=false keeps the twin's rounding), 0.47 G at
// TUM B=64. So the pixels are read once, coalesced:
//   * A block takes a band of P image rows across S cells (up to 64, as
//     many as fit 48 KB) and stages it in shared memory with coalesced
//     16-byte loads (a scalar path where the row pitch, the span or the
//     pointer is not 16-byte aligned). The back-projection factors
//     (c - cx) / fx and (r - cy) / fy are taken once a block with the same
//     IEEE operations, so x = u * z and y = v * z round as the twin's do.
//   * Then one thread a cell sums its pixels from shared memory into 13
//     registers, each sum in the twin's order (down each in-cell column,
//     then across the column sums, j = 0..P-1), so the 13 planes are
//     bit-equal to ops/cellstats.py:cell_moments_reference with true
//     division and -fmad=false; the card's labels equal the CPU's on ICL at
//     P=4 only so. The common patch sizes (4, 8, 10, 16) unroll the rows.
//     (Two threads a cell, one for the sums and one for the products, ran
//     slower: both read and back-project every pixel.)
//   * The walks follow linear in-cell indices, so for odd P the mid-row walk
//     wraps into the next row; grids without the reference's band plan take
//     the plainly centered second pass instead of the fold.
// Where not even one cell's band fits (very large P), one thread a cell
// reads global memory instead, with the same arithmetic in the same order.
#include "common.cuh"

namespace {

struct DepthSource {
  const uint16_t* depth;  // (B, H, W)
  int H, W;
  float fx, fy, cx, cy;
  static constexpr int kChannels = 1;
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
  static constexpr int kChannels = 3;
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

// Carried-prev discontinuity walk over P pixels of a cell from (r, c):
// along the row, wrapping into the next one (linear in-cell indices), or
// down the column.
template <class Px>
__device__ float walk(const Px& px, int P, int r, int c, bool along_row, float thr) {
  float prev = px.z(r, c);
  float disc = 0.f;
  for (int t = 0; t < P; ++t) {
    const float curr = px.z(r, c);
    const bool pos = curr > 0.f;
    const bool cont = pos && fabsf(curr - prev) < thr;
    if (cont) prev = curr;
    if (pos && !cont) disc += 1.f;
    if (!along_row) ++r;
    else if (++c == P) { c = 0; ++r; }
  }
  return disc;
}

// ---- one cell ---------------------------------------------------------------

// The 13 moment planes of one cell, in kernel order: count, disc_h, disc_v,
// sx, sy, sz, sxx, sxy, sxz, syy, syz, szz, diam. px.load(i, j, x, y, z)
// gives the cell's pixel (i, j), px.z(i, j) its depth. Every sum runs down
// each in-cell column, then across the column sums (j = 0..P-1), as
// ops/cellstats.py:cell_moments_reference adds them. A constant kP unrolls
// the rows.
template <int kP, class Px>
__device__ void moments_of_cell(const Px& px, int patch, float thr, int anchored,
                                float (&v)[13]) {
  const int P = kP > 0 ? kP : patch;
  const float n = (float)(P * P);
  float ax, ay, az;
  px.load(0, 0, ax, ay, az);
  // [0] count, [1..3] x y z, [4..6] anchored x y z, [7..12] anchored
  // products xx xy xz yy yz zz.
  float tot[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) tot[k] = 0.f;
#pragma unroll 1
  for (int j = 0; j < P; ++j) {
    float col[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) col[k] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float x, y, z;
      px.load(i, j, x, y, z);
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
  float q[6];
  if (anchored) {
    // Folded centering: S(ab) - Sa * (Sb / n) about the first pixel.
    const float ux = tot[4], uy = tot[5], uz = tot[6];
    q[0] = tot[7] - ux * (ux / n);
    q[1] = tot[8] - ux * (uy / n);
    q[2] = tot[9] - ux * (uz / n);
    q[3] = tot[10] - uy * (uy / n);
    q[4] = tot[11] - uy * (uz / n);
    q[5] = tot[12] - uz * (uz / n);
  } else {
    // Plainly centered second pass, summed in the same order.
    const float mx = tot[1] / n, my = tot[2] / n, mz = tot[3] / n;
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = 0.f;
#pragma unroll 1
    for (int j = 0; j < P; ++j) {
      float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float x, y, z;
        px.load(i, j, x, y, z);
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
  }
  float lx, ly, lz;
  px.load(P - 1, P - 1, lx, ly, lz);
  const float dx = ax - lx, dy = ay - ly, dz = az - lz;
  const int mid = P * P / 2;
  v[0] = tot[0];
  v[1] = walk(px, P, mid / P, mid % P, true, thr);
  v[2] = walk(px, P, 0, P / 2, false, thr);
  v[3] = tot[1];
  v[4] = tot[2];
  v[5] = tot[3];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[6 + k] = q[k];
  v[12] = sqrtf(dx * dx + dy * dy + dz * dz);
}

// A cell read from global memory.
template <class Src>
struct GlobalCell {
  const Src& src;
  int b, r0, c0;
  __device__ void load(int i, int j, float& x, float& y, float& z) const {
    src.load(b, r0 + i, c0 + j, x, y, z);
  }
  __device__ float z(int i, int j) const { return src.z_at(b, r0 + i, c0 + j); }
};

// A cell of a depth band staged in shared memory: tile row pitch `cols`,
// the cell's first column `a`, back-projection factors uf (by column) and
// vf (by row).
struct BandDepthCell {
  const uint16_t* tile;
  const float *uf, *vf;
  int cols, a;
  __device__ void load(int i, int j, float& x, float& y, float& z) const {
    z = (float)tile[i * cols + a + j];
    x = uf[a + j] * z;
    y = vf[i] * z;
  }
  __device__ float z(int i, int j) const { return (float)tile[i * cols + a + j]; }
};

// A cell of a point band staged in shared memory (x, y, z interleaved).
struct BandPointCell {
  const float* tile;
  int cols, a;
  __device__ void load(int i, int j, float& x, float& y, float& z) const {
    const float* p = tile + (i * cols + a + j) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
  }
  __device__ float z(int i, int j) const { return tile[(i * cols + a + j) * 3 + 2]; }
};

// ---- the band kernel ---------------------------------------------------------

constexpr int kBandCells = 64;              // cells (and threads) of a block
constexpr size_t kBandSmem = 48 * 1024;

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~size_t(15); }

// Cells a block takes: up to 64, as many as fit 48 KB, a multiple of 8
// columns where one is near. 0 where not even one cell fits.
__host__ __device__ inline int band_cells(int P, int channels) {
  const size_t px = channels == 1 ? 2 : 12;
  const size_t per_cell = (size_t)P * P * px + (size_t)P * 4;
  const size_t fit = (kBandSmem - (size_t)P * 4 - 64) / per_cell;
  const int S = fit < (size_t)kBandCells ? (int)fit : kBandCells;
  for (int s = S; s > 0 && s > S / 2; --s)
    if ((s * P) % 8 == 0) return s;
  return S;
}

// Shared memory of a block: the band, then uf and vf.
struct BandLayout {
  size_t uf, vf, total;
  __host__ __device__ BandLayout(int P, int S, int channels) {
    const size_t px = channels == 1 ? 2 : 12;
    uf = round16((size_t)P * S * P * px);
    vf = uf + round16((size_t)S * P * 4);
    total = vf + round16((size_t)P * 4);
  }
};

// A band of P image rows x S cells a block: the band is staged in shared
// memory with coalesced 16-byte loads, then each thread takes a cell.
template <class Src, int kP>
__global__ void __launch_bounds__(kBandCells)
cell_moments_band(Src src, int gh, int gw, int P, int S, float thr, int anchored,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = blockIdx.x, ci = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x;
  const int s_n = min(S, gw - span * S), width = s_n * P, cols = S * P;
  const int r0 = ci * P, c0 = span * cols;
  const BandLayout L(P, S, Src::kChannels);
  float* uf = reinterpret_cast<float*>(smem + L.uf);
  float* vf = reinterpret_cast<float*>(smem + L.vf);
  if constexpr (Src::kChannels == 1) {
    uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
    const uint16_t* base = src.depth + ((size_t)b * src.H + r0) * src.W + c0;
    const bool vec = src.W % 8 == 0 && cols % 8 == 0 && width % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(src.depth) & 15) == 0;
    if (vec) {
      const int per_row = width / 8, total = P * per_row;
      for (int q0 = tid; q0 < total; q0 += 4 * kBandCells) {   // 4 loads in flight
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kBandCells, i = q / per_row;
          if (q < total)
            v[u] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)i * src.W +
                                                         (q - i * per_row) * 8));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kBandCells, i = q / per_row;
          if (q < total)
            *reinterpret_cast<uint4*>(tile + (size_t)i * cols + (q - i * per_row) * 8) = v[u];
        }
      }
    } else {
      for (int i = 0; i < P; ++i)
        for (int x = tid; x < width; x += kBandCells)
          tile[(size_t)i * cols + x] = base[(size_t)i * src.W + x];
    }
    for (int x = tid; x < width; x += kBandCells) uf[x] = ((float)(c0 + x) - src.cx) / src.fx;
    for (int i = tid; i < P; i += kBandCells) vf[i] = ((float)(r0 + i) - src.cy) / src.fy;
  } else {
    float* tile = reinterpret_cast<float*>(smem);
    const float* base = src.pts + (((size_t)b * src.H + r0) * src.W + c0) * 3;
    const bool vec = src.W % 4 == 0 && cols % 8 == 0 && width % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(src.pts) & 15) == 0;
    if (vec) {
      const int per_row = width * 3 / 4, total = P * per_row;
      for (int q0 = tid; q0 < total; q0 += 4 * kBandCells) {   // 4 loads in flight
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kBandCells, i = q / per_row;
          if (q < total)
            v[u] = __ldg(reinterpret_cast<const float4*>(base + (size_t)i * src.W * 3 +
                                                          (q - i * per_row) * 4));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kBandCells, i = q / per_row;
          if (q < total)
            *reinterpret_cast<float4*>(tile + (size_t)i * cols * 3 + (q - i * per_row) * 4) = v[u];
        }
      }
    } else {
      for (int i = 0; i < P; ++i)
        for (int x = tid; x < width * 3; x += kBandCells)
          tile[(size_t)i * cols * 3 + x] = base[(size_t)i * src.W * 3 + x];
    }
  }
  __syncthreads();

  if (tid >= s_n) return;
  float v[13];
  if constexpr (Src::kChannels == 1) {
    const BandDepthCell px{reinterpret_cast<const uint16_t*>(smem), uf, vf, cols, tid * P};
    moments_of_cell<kP>(px, P, thr, anchored, v);
  } else {
    const BandPointCell px{reinterpret_cast<const float*>(smem), cols, tid * P};
    moments_of_cell<kP>(px, P, thr, anchored, v);
  }
  const size_t plane = (size_t)B * gh * gw;
  float* o = out + ((size_t)b * gh + ci) * gw + span * S + tid;
#pragma unroll
  for (int k = 0; k < 13; ++k) o[k * plane] = v[k];
}

// Cells whose band does not fit in shared memory: one thread a cell, read
// from global memory.
template <class Src>
__global__ void __launch_bounds__(128)
cell_moments_per_cell(Src src, int gh, int gw, int P, float thr, int anchored,
                      float* __restrict__ out) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  if (cell >= gh * gw) return;
  const int ci = cell / gw, cj = cell - ci * gw;
  const GlobalCell<Src> px{src, b, ci * P, cj * P};
  float v[13];
  moments_of_cell<0>(px, P, thr, anchored, v);
  const size_t plane = (size_t)B * gh * gw;
  float* o = out + (size_t)b * gh * gw + cell;
#pragma unroll
  for (int k = 0; k < 13; ++k) o[k * plane] = v[k];
}

template <class Src>
int launch(const Src& src, int B, int gh, int gw, int P, float thr,
           int anchored, float* out, cudaStream_t stream) {
  if (B <= 0 || gh <= 0 || gw <= 0) return (int)cudaSuccess;
  const int S = band_cells(P, Src::kChannels);
  if (S > 0 && gh <= 65535 && B <= 65535) {
    // The common patch sizes get their rows unrolled.
    auto kernel = P == 4 ? cell_moments_band<Src, 4>
                : P == 8 ? cell_moments_band<Src, 8>
                : P == 10 ? cell_moments_band<Src, 10>
                : P == 16 ? cell_moments_band<Src, 16> : cell_moments_band<Src, 0>;
    const dim3 grid((gw + S - 1) / S, gh, B);
    kernel<<<grid, kBandCells, BandLayout(P, S, Src::kChannels).total, stream>>>(
        src, gh, gw, P, S, thr, anchored, out);
  } else {
    const dim3 grid((gh * gw + 127) / 128, B);
    cell_moments_per_cell<Src><<<grid, 128, 0, stream>>>(src, gh, gw, P, thr, anchored,
                                                         out);
  }
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
