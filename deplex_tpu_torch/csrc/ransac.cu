// Stage-6 kernel: per-plane outlier counts of one chunk of RANSAC hypotheses.
//
// Replaces the XLA fusion that deplex_tpu/ops/ransac.py:chunk_losses becomes
// inside the JAX package's while_loop (no pallas_call of its own). What it
// computes, for chunk s of Kc hypotheses: for every frame b, plane p and
// hypothesis k of the chunk, the pixels of p's cells (inside the gh*P x gw*P
// crop; a pixel is scored against its own cell's plane only, cells labelled
// 0 count nothing) with !(|((x*n0 + y*n1) + z*n2) + d| < thr), as
// ops/ransac.py:_outliers forms it, under the library's -fmad=false. The
// counts are integers added with integer atomics, so they equal the twin's
// (ops/ransac.py:chunk_outliers_reference) on any launch order.
//
// The early exit on the card: a frame whose planes have all reached their
// target is `done`, and its blocks return at once (its counts stay 0; the
// loop keeps its winners frozen). So the loop runs a fixed number of chunks,
// which a CUDA graph records, and a finished frame costs one empty block a
// cell. The block of cell 0 adds 1 to scored[b] for a frame it scores: the
// chunks each frame really scored.
//
// What bounds it on the H100: operations, 6 float32 operations a pixel and
// hypothesis (3 multiplies, 3 adds): 1.89 GFLOP for one chunk of 128 at TUM
// B=8, 28 us at 67 TFLOP/s, against 29.5 MB of points (8.8 us at 3.35 TB/s).
// The design is the simple one: a block a (frame, cell) stages the cell's
// P x P points in shared memory (in tiles of 1024 pixels for large P), a
// thread a hypothesis keeps its count in a register over the staged pixels
// (read as broadcasts), and one atomicAdd a (tile, hypothesis) lands it in
// its plane's row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTilePixels = 1024;

__global__ void __launch_bounds__(kThreads)
ransac_outliers(const float* __restrict__ pts, const int* __restrict__ cells,
                const float* __restrict__ n_tab, const float* __restrict__ d_tab,
                const unsigned char* __restrict__ done, int* __restrict__ scored, int H,
                int W, int gh, int gw, int P, int maxp, int hyp, int s, int kc, float thr,
                int* __restrict__ out) {
  __shared__ float sx[kTilePixels], sy[kTilePixels], sz[kTilePixels];
  const int cell = blockIdx.x, b = blockIdx.y;
  if (done[b]) return;
  if (cell == 0 && threadIdx.x == 0) scored[b] += 1;
  const int label = cells[(size_t)b * gh * gw + cell];
  if (label < 1 || label > maxp) return;
  const int ci = cell / gw, cj = cell - ci * gw;
  const int PP = P * P;
  const size_t plane = (size_t)b * maxp + (label - 1);
  const float* frame = pts + (size_t)b * H * W * 3;
  const float* n_row = n_tab + (plane * hyp + (size_t)s * kc) * 3;
  const float* d_row = d_tab + plane * hyp + (size_t)s * kc;
  int* o = out + plane * kc;
  for (int t0 = 0; t0 < PP; t0 += kTilePixels) {
    const int np = min(kTilePixels, PP - t0);
    __syncthreads();                       // the previous tile is read
    for (int q = threadIdx.x; q < np * 3; q += blockDim.x) {
      const int t = t0 + q / 3, c = q - (q / 3) * 3;
      const int r = ci * P + t / P, col = cj * P + t % P;
      const float v = frame[((size_t)r * W + col) * 3 + c];
      (c == 0 ? sx : c == 1 ? sy : sz)[t - t0] = v;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kc; k += blockDim.x) {
      const float n0 = n_row[3 * k], n1 = n_row[3 * k + 1], n2 = n_row[3 * k + 2];
      const float d = d_row[k];
      int count = 0;
      for (int t = 0; t < np; ++t) {
        float e = sx[t] * n0;
        e = e + sy[t] * n1;
        e = e + sz[t] * n2;
        e = e + d;
        count += !(fabsf(e) < thr);
      }
      if (count) atomicAdd(o + k, count);
    }
  }
}

}  // namespace

extern "C" {

// pts: (B, H, W, 3) float32; cells: (B, gh, gw) int32 plane ids (0 = none);
// n_tab: (B, maxp, hyp, 3) and d_tab: (B, maxp, hyp) float32, hyp = S * kc;
// done: (B,) bool; scored: (B,) int32, += 1 for each frame scored;
// out: (B, maxp, kc) int32, zero on entry (the wrapper fills it).
int dplx_ransac_outliers(const void* pts, const void* cells, const void* n_tab,
                         const void* d_tab, const void* done, void* scored, int B, int H,
                         int W, int gh, int gw, int P, int maxp, int hyp, int s, int kc,
                         float thr, void* out, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0 || kc <= 0) return (int)cudaSuccess;
  const dim3 grid(gh * gw, B);
  ransac_outliers<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(cells),
      static_cast<const float*>(n_tab), static_cast<const float*>(d_tab),
      static_cast<const unsigned char*>(done), static_cast<int*>(scored), H, W, gh, gw, P,
      maxp, hyp, s, kc, thr, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
