// Stage-5 kernel: the pixel labels, written once in their final dtype.
//
// Replaces what the JAX package leaves to XLA: deplex_tpu/ops/merge.py:156
// rasterize_labels (the label LUT and the patch expansion as two one-hot
// matmuls), the uint8 cast of extract_depth_batch_jit and, with stage 6,
// the final inlier pass of deplex_tpu/ops/ransac.py:325-332; none of them
// has a pallas_call. What it computes is ops/merge.py:pixel_labels_reference:
// pixel (r, c) of frame b inside the gh*P x gw*P crop gets
// lut[cells[b, r/P, c/P]], lut[0] = 0 and lut[k] = merge_labels[b, k-1] + 1
// (a cell label outside 0..M writes 0), every pixel past the crop 0; with
// stage 6 a labelled pixel keeps its label iff
// |((x*n0 + y*n1) + z*n2) + d| < thr for its plane's winning model
// hyp[b, L-1, best_k[b, L-1]] = (n0, n1, n2, d), in float32 in that order
// (the library is built with -fmad=false, so nothing is contracted), else
// it gets 0; uint8 output keeps the low 8 bits, as the twin's cast does.
// (The twin takes the winners gathered, best = hyp at best_k; the kernel
// reads them from the hypotheses itself, so the path has no gather op.)
//
// What bounds it on the H100: bytes. At TUM B=64 it writes 19.66 MB of
// uint8 and reads 0.79 MB of cell labels (6.1 us at 3.35 TB/s); with
// stage 6 it also reads the labelled pixels' points (at most 29.5 MB at
// TUM B=8).
//
// The design, a simple one that is right at every H, W and P. All P rows of
// a cell row carry the same labels, so a block takes one band of a frame:
// the P image rows of one cell row (or the rows past gh*P, all 0). It
// writes the band's row of W labels once into shared memory (a column's
// cell looked up and LUT'd: merge_labels is read there, in global memory,
// once per column), then streams that row out P times: a thread moves one
// 16-byte vector a step (16 uint8 or 4 int32 labels), one shared-memory
// read and one store, consecutive threads on consecutive vectors. Where a
// row is no multiple of 16 bytes (W = 9, say) the band's rows do not start
// on a vector, and the block writes it label by label instead. With stage
// 6 the row holds the int32 labels; a vector that holds a labelled pixel
// reads its pixels' points (float4s on the vector path) and drops the
// outliers before the store; the others read no point. The frame's M
// winners are staged in shared memory once a block (1 KB at M = 64), read
// from the hypotheses at the loop's best_k.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// The shared memory a block may take (the H100's 227 KB): the row of W
// labels in the output dtype, or int32 with stage 6 and then the M winners.
constexpr int kMaxSharedBytes = 232448;

struct Args {
  const int* cells;       // (B, gh, gw)
  const int* merge;       // (B, M)
  const float* points;    // (B, H*W, 3), or null without stage 6
  const float4* hyp;      // (B, M, n_hyp): (n0, n1, n2, d)
  const long long* best_k;  // (B, M): each plane's winner in hyp
  int n_hyp;
  float thr;
  int gh, gw, H, W, P, M;
};

// lut[k] of frame `merge`: merge[k-1] + 1, 0 for k = 0 and outside 0..M.
__device__ __forceinline__ int lut(const int* merge, int M, int k) {
  return k <= 0 || k > M ? 0 : merge[k - 1] + 1;
}

// Stage 6's test of one labelled pixel: is it an inlier of its plane's
// winner, |((x*n0 + y*n1) + z*n2) + d| < thr, in the twin's order.
__device__ __forceinline__ bool inlier(const Args& a, const float4* best, int label, float x,
                                       float y, float z) {
  int m = label - 1;
  m = m > a.M - 1 ? a.M - 1 : m;
  const float4 w = best[m];
  float err = x * w.x;
  err = err + y * w.y;
  err = err + z * w.z;
  err = err + w.w;
  return fabsf(err) < a.thr;
}

template <typename T, bool kRefine>
__global__ void __launch_bounds__(kThreads) pixel_labels_kernel(Args a, T* __restrict__ out) {
  using Row = typename std::conditional<kRefine, int, T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Row* row = reinterpret_cast<Row*>(smem);
  // Stage 6: the frame's winners, after the row.
  float4* best = reinterpret_cast<float4*>(smem + ((size_t)a.W * sizeof(Row) + 15) / 16 * 16);
  const int b = blockIdx.y, band = blockIdx.x;
  const bool cell_band = band < a.gh;
  const int r0 = band * a.P;
  const int rows = cell_band ? a.P : a.H - r0;
  const int* merge = a.merge + (long long)b * a.M;
  const int* cells = a.cells + ((long long)b * a.gh + band) * a.gw;

  // The band's row of labels: column c lies in cell c / P, 0 past gw*P.
  for (int c = threadIdx.x; c < a.W; c += kThreads) {
    const int gc = c / a.P;
    row[c] = static_cast<Row>(cell_band && gc < a.gw ? lut(merge, a.M, cells[gc]) : 0);
  }
  if constexpr (kRefine) {
    for (int m = threadIdx.x; m < a.M; m += kThreads) {
      long long k = a.best_k[(long long)b * a.M + m];
      k = k < 0 ? 0 : k > a.n_hyp - 1 ? a.n_hyp - 1 : k;
      best[m] = a.hyp[((long long)b * a.M + m) * a.n_hyp + k];
    }
  }
  __syncthreads();

  const long long o = ((long long)b * a.H + r0) * a.W;   // the band's first label
  const int n = rows * a.W;
  if ((a.W * (int)sizeof(T)) % 16 == 0) {
    constexpr int V = 16 / sizeof(T);
    for (int e = threadIdx.x * V; e < n; e += kThreads * V) {
      const int col = e % a.W;                           // a vector holds one row's labels
      if constexpr (!kRefine) {
        *reinterpret_cast<uint4*>(out + o + e) = *reinterpret_cast<const uint4*>(row + col);
      } else {
        int lab[V];
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const int4 l = *reinterpret_cast<const int4*>(row + col + 4 * q);
          lab[4 * q] = l.x; lab[4 * q + 1] = l.y; lab[4 * q + 2] = l.z; lab[4 * q + 3] = l.w;
        }
        bool any = false;
#pragma unroll
        for (int i = 0; i < V; ++i) any |= lab[i] > 0;
        if (any) {
          float p[3 * V];
          const float4* src = reinterpret_cast<const float4*>(a.points + (o + e) * 3);
#pragma unroll
          for (int q = 0; q < 3 * V / 4; ++q) {
            const float4 f = src[q];
            p[4 * q] = f.x; p[4 * q + 1] = f.y; p[4 * q + 2] = f.z; p[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (lab[i] > 0 && !inlier(a, best, lab[i], p[3 * i], p[3 * i + 1], p[3 * i + 2]))
              lab[i] = 0;
        }
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (sizeof(T) == 1)
            w[q] = (uint32_t)(lab[4 * q] & 0xff) | (uint32_t)(lab[4 * q + 1] & 0xff) << 8 |
                   (uint32_t)(lab[4 * q + 2] & 0xff) << 16 |
                   (uint32_t)(lab[4 * q + 3] & 0xff) << 24;
          else
            w[q] = (uint32_t)lab[q];
        }
        *reinterpret_cast<uint4*>(out + o + e) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      int label = row[e % a.W];
      if constexpr (kRefine) {
        if (label > 0) {
          const float* pt = a.points + (o + e) * 3;
          if (!inlier(a, best, label, pt[0], pt[1], pt[2])) label = 0;
        }
      }
      out[o + e] = static_cast<T>(label);
    }
  }
}

template <typename T, bool kRefine>
int launch_kernel(const Args& a, int B, T* out, cudaStream_t stream) {
  using Row = typename std::conditional<kRefine, int, T>::type;
  const size_t smem =
      ((size_t)a.W * sizeof(Row) + 15) / 16 * 16 + (kRefine ? (size_t)a.M * 16 : 0);
  if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  auto kernel = pixel_labels_kernel<T, kRefine>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // A band a block: gh cell rows, and the rows past gh*P if there are any.
  const dim3 grid(a.gh + (a.H > a.gh * a.P ? 1 : 0), B);
  kernel<<<grid, kThreads, smem, stream>>>(a, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int B, T* out, cudaStream_t stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  return a.points ? launch_kernel<T, true>(a, B, out, stream)
                  : launch_kernel<T, false>(a, B, out, stream);
}

}  // namespace

extern "C" {

// cells (B, gh, gw) int32 cell labels; merge_labels (B, M) int32; for
// stage 6's final pass points (B, H*W, 3) float32, hyp (B, M, n_hyp, 4)
// float32 (n0, n1, n2, d) and best_k (B, M) int64 (each plane's winner,
// clamped into 0..n_hyp-1), all null without it; points and hyp 16-byte
// aligned. A cell label outside 0..M writes 0.
// out: (B, H*W) uint8 (out_bytes 1) or int32 (out_bytes 4), 16-byte aligned.
int dplx_pixel_labels(const void* cells, const void* merge_labels, const void* points,
                      const void* hyp, const void* best_k, int n_hyp, float thr, int B, int gh,
                      int gw, int H, int W, int P, int M, int out_bytes, void* out,
                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (P <= 0 || M < 0 || gh < 0 || gw < 0 || (long long)gh * P > H || (long long)gw * P > W)
    return (int)cudaErrorInvalidValue;
  // Stage 6's pass needs all three; without planes (M = 0) every label is 0
  // anyway.
  const bool refine = points != nullptr && hyp != nullptr && best_k != nullptr && M > 0;
  if (refine && n_hyp <= 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(cells), static_cast<const int*>(merge_labels),
         refine ? static_cast<const float*>(points) : nullptr, static_cast<const float4*>(hyp),
         static_cast<const long long*>(best_k), n_hyp, thr, gh, gw, H, W, P, M};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 1) return launch(a, B, static_cast<uint8_t*>(out), s);
  if (out_bytes == 4) return launch(a, B, static_cast<int32_t*>(out), s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
