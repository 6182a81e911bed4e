// Stage-6 kernel: one chunk step of RANSAC refinement. It scores chunk s of
// every plane's hypotheses and applies the reference's early-exit update, in
// one launch.
//
// Replaces the XLA fusion that deplex_tpu/ops/ransac.py:chunk_losses becomes
// inside the JAX package's while_loop, and that loop's body around it (the
// running best, the first hypothesis to reach the target, the best of the
// prefix, the frozen planes); neither has a pallas_call. What it computes is
// ops/ransac.py:chunk_step_reference: for frame b, plane p and hypothesis k
// of the chunk, the pixels of p's cells (inside the gh*P x gw*P crop; a pixel
// is scored against its own cell's plane only, cells labelled 0 count
// nothing) with !(|((x*n0 + y*n1) + z*n2) + d| < thr), under the library's
// -fmad=false; then ops/ransac.py:_apply_chunk on those counts in its float32
// arithmetic. The counts are integers added with integer atomics, so they
// equal the twin's on any launch order, and no float atomic decides anything.
//
// The early exit on the card: a frame whose planes have all reached their
// target is `done`, and its blocks return at once (its state stays frozen).
// So the loop runs a fixed number of launches, which a CUDA graph records.
//
// What bounds it on the H100: operations. A pixel and hypothesis take 6
// float32 instructions (3 multiplies, 3 adds: -fmad=false fuses none, and the
// counts must round as the twin's do), plus a compare and a predicated add:
// 0.81 G float32 instructions a chunk of 128 at TUM B=8 (1.06 M labelled
// pixels), 24 us at 132 SMs x 128 lanes x 1.98 GHz, against 12.7 MB of their
// points (3.8 us at 3.35 TB/s). Tensor cores are out: a TF32 product rounds
// otherwise and moves pixels across the threshold.
//
// The design, against what held the first kernel (a block a cell, a thread a
// hypothesis, three shared-memory reads a pixel and hypothesis, an atomic a
// cell and hypothesis, 28 small ops of glue a chunk):
//  - A block takes a run of `run_cells` consecutive cells of the frame's
//    plane-sorted order (cell_order, bounds: ops/ransac.py:sample_hypotheses),
//    about 1,500 pixels, and walks the one or few plane segments it holds.
//    The grid is fixed (B x ceil(G / run_cells)), so a graph serves any
//    labelling; blocks past the labelled cells only take their ticket.
//  - Each lane keeps KPL of the segment's Kc hypotheses (lane, lane + 32,
//    ...) and their counts in registers. Pixels are staged as float4 (x, y,
//    z, -) and read back as one 16-byte broadcast: one shared-memory read
//    feeds KPL x 8 instructions (the count is a compare and a predicated add,
//    written out in PTX). The run's rows are copied in two or more tiles by
//    16-byte cp.async.cg, and the next tile's copies fly while the warps
//    score the current one.
//  - The warps' counts meet in shared memory at the end of a segment and one
//    integer atomicAdd goes to each (segment, hypothesis): about 10^5 a chunk
//    at TUM B=8, where a block a cell took 1.36 M.
//  - The chunk's glue is gone: each block fences its atomics and takes a
//    ticket on its frame's counter; the block with the frame's last ticket
//    stages the frame's final counts from L2 in shared memory and runs the
//    update for all MAXP planes, four lanes a plane (the running best needs
//    no scan: the inliers are exact integers), then sets done[b] for the next
//    chunk, adds 1 to scored[b] and zeroes the counts and the ticket.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePixels = 1536;   // a tile of pixels as float4: 24 KB
constexpr int kRawFloats = 6144;    // the rows of the next tile as copied: 24 KB
constexpr int kMaxPerLane = 8;      // Kc <= 256 (kernels/ransac.py:MAX_CHUNK)
constexpr int kPlaneLanes = 4;      // lanes of the finisher a plane

struct StepArgs {
  const float* pts;              // (B, H*W, 3)
  const float4* hyp;             // (B, maxp, n_hyp) packed (n0, n1, n2, d)
  const long long* order;        // (B, G) cells sorted by plane id
  const long long* bounds;       // (B, maxp + 2) first position of each id
  const float* n_pts;            // (B, maxp)
  const float* target;           // (B, maxp)
  unsigned char* reached;        // (B, maxp)
  float* run_best;               // (B, maxp)
  float* best_loss;              // (B, maxp)
  long long* best_k;             // (B, maxp)
  unsigned char* done;           // (B,)
  int* scored;                   // (B,)
  int* counts;                   // (B, maxp, kc), 0 on entry and exit
  int* tickets;                  // (B,), 0 on entry and exit
  int* losses;                   // (B, maxp, kc) or null
  int H, W, gh, gw, P, maxp, n_hyp, s, kc, run_cells;
  float thr;
};

// A pixel row as copied: 3P floats from a 16-byte boundary, at most 3 floats
// after it, in a slot of row_stride(P) floats; a tile is the rows whose
// pixels and copies both fit.
__host__ __device__ __forceinline__ int row_stride(int P) { return (3 * P + 6) & ~3; }
__host__ __device__ __forceinline__ int tile_rows(int P) {
  return min(kTilePixels / P, kRawFloats / row_stride(P));
}

// The block's shared memory: a tile of pixels as float4, the rows of the
// next tile as they are copied (both reused by the finisher), the frame's
// bounds, the source offsets of the run's cells, each copied row's start in
// its slot, and the warps' counts.
struct Smem {
  float4* pix;
  float* raw;
  long long* bnd;
  int* base;
  int* off;
  int* cnt;
};

__device__ __forceinline__ Smem carve(const StepArgs& a, float4* smem) {
  Smem m;
  m.pix = smem;
  m.raw = reinterpret_cast<float*>(m.pix + kTilePixels);
  m.bnd = reinterpret_cast<long long*>(m.raw + kRawFloats);
  m.base = reinterpret_cast<int*>(m.bnd + a.maxp + 2);
  m.off = m.base + a.run_cells;
  m.cnt = m.off + tile_rows(a.P);
  return m;
}

// The finisher's rows of counts in shared memory: kc ints padded to a 16-byte
// multiple plus 4, so that the lanes of a warp read distinct banks; and how
// many planes it takes at once: as many rows as fit in the pixel and row
// buffers, kPlaneLanes threads a plane.
__host__ __device__ __forceinline__ int count_stride(int kc) { return ((kc + 3) & ~3) + 4; }
__host__ __device__ __forceinline__ int finish_planes(int kc) {
  return min(kThreads / kPlaneLanes, (kTilePixels * 4 + kRawFloats) / count_stride(kc));
}

size_t smem_bytes(int kc, int maxp, int run_cells, int P) {
  return (size_t)kTilePixels * sizeof(float4) + (size_t)kRawFloats * sizeof(float) +
         (size_t)(maxp + 2) * sizeof(long long) +
         (size_t)(run_cells + tile_rows(P) + kc) * sizeof(int);
}

#ifdef DPLX_PROFILE
// DPLX_PROFILE builds write each block's timeline to `losses` instead of the
// counts: kProfileSlots int64 a block (blockIdx.y * gridDim.x + blockIdx.x),
// the global timer in ns at its start, after its setup, once its first
// tile's pixels are in place, after its scoring, after its ticket and at its
// end, then flags (1: it scored cells, 2: it finished its frame) and its SM.
constexpr int kProfileSlots = 8;
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(const StepArgs& a, int slot, long long v) {
  if (threadIdx.x == 0)
    reinterpret_cast<long long*>(a.losses)[(blockIdx.y * gridDim.x + blockIdx.x) * kProfileSlots +
                                          slot] = v;
}
#endif

// The plane id of sorted position c: the m with bnd[m] <= c < bnd[m + 1].
__device__ __forceinline__ int label_at(const long long* bnd, int maxp, int c) {
  int lo = 1, hi = maxp;                       // bnd[1] <= c < bnd[maxp + 1]
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bnd[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Starts the 16-byte cp.async.cg copies of the run's pixel rows [r0, r0 +
// nrows) (row r: row r % P of the run's cell r / P, whose first pixel is at
// float base[r / P] of frame b) into the row slots, from the 16-byte
// boundary at or before each row, a row's copies to a few of a warp's
// lanes; off[r - r0] is where the row starts in its slot. A copy that would
// reach outside the points is made float by float.
__device__ __forceinline__ void copy_rows(const StepArgs& a, int b, int r0, int nrows,
                                          const Smem& m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = a.P, rs = row_stride(P), chunks = rs / 4;
  const int per_pass = max(1, 32 / chunks);    // rows a warp takes at once
  const int sub = lane / chunks, step = chunks > 32 ? 32 : chunks;
  if (sub >= per_pass) return;
  const float* frame = a.pts + (size_t)b * a.H * a.W * 3;
  const float* end = a.pts + (size_t)gridDim.y * a.H * a.W * 3;
  for (int r = warp * per_pass + sub; r < nrows; r += kWarps * per_pass) {
    const int q = (r0 + r) / P, rr = r0 + r - q * P;
    const float* g = frame + m.base[q] + rr * a.W * 3;
    const float* g0 = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(g) & ~15ull);
    const int first = lane - sub * chunks;
    if (first == 0) m.off[r] = (int)(g - g0);
    for (int ch = first; ch < chunks; ch += step) {
      float* d = m.raw + r * rs + 4 * ch;
      const float* e = g0 + 4 * ch;
      if (e >= a.pts && e + 4 <= end) {
        const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd), "l"(e));
      } else {
        for (int u = 0; u < 4; ++u)
          if (e + u >= a.pts && e + u < end) d[u] = e[u];
      }
    }
  }
}

// The copied rows (nrows of them) unpacked into the pixel tile as float4.
__device__ __forceinline__ void unpack_rows(const StepArgs& a, int nrows, const Smem& m) {
  const int P = a.P, rs = row_stride(P);
  for (int t = threadIdx.x; t < nrows * P; t += kThreads) {
    const int r = t / P;
    const float* v = m.raw + r * rs + m.off[r] + 3 * (t - r * P);
    m.pix[t] = make_float4(v[0], v[1], v[2], 0.f);
  }
}

// cnt += !(|e| < thr) as one compare and one predicated add (a NaN counts);
// written out because nvcc turns the plain form into an add and a select.
__device__ __forceinline__ void count_outlier(int& cnt, float e, float thr) {
  asm("{\n\t.reg .pred p;\n\tsetp.geu.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(fabsf(e)), "f"(thr));
}

// Lane l's hypotheses l, l + 32, ... of chunk s of plane `label` into
// registers, and their counts zeroed.
template <int KPL>
__device__ __forceinline__ void load_hyps(const StepArgs& a, int b, int label, float (&n0)[KPL],
                                          float (&n1)[KPL], float (&n2)[KPL], float (&d)[KPL],
                                          int (&cnt)[KPL]) {
  const int lane = threadIdx.x & 31;
  const float4* h = a.hyp + ((size_t)b * a.maxp + (label - 1)) * a.n_hyp + (size_t)a.s * a.kc;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + 32 * i;
    const float4 v = k < a.kc ? __ldg(h + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    n0[i] = v.x; n1[i] = v.y; n2[i] = v.z; d[i] = v.w;
    cnt[i] = 0;
  }
}

// Scores the run of sorted positions [c0, c1) (m.base holds their cells'
// source offsets) against chunk s of each of its planes' hypotheses and adds
// the counts to a.counts, one atomic a (segment, hypothesis). The run is
// scored in tiles of rows; the next tile's rows are copied while the warps
// score the current one.
template <int KPL>
__device__ __forceinline__ void score_run(const StepArgs& a, int b, int c0, int c1,
                                          const Smem& m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = a.P, run_rows = (c1 - c0) * P;
  const int tiles = max(min(2, run_rows), (run_rows + tile_rows(P) - 1) / tile_rows(P));
  const int tile = (run_rows + tiles - 1) / tiles;
  for (int k = threadIdx.x; k < a.kc; k += kThreads) m.cnt[k] = 0;

  // The segment being scored (the same in every thread): plane `label`,
  // rows [seg_start, seg_end) of the run.
  int label = label_at(m.bnd, a.maxp, c0);
  int seg_start = 0, seg_end = (min((int)m.bnd[label + 1], c1) - c0) * P;
  float n0[KPL], n1[KPL], n2[KPL], d[KPL];
  int cnt[KPL];
  copy_rows(a, b, 0, min(tile, run_rows), m);
  __pipeline_commit();
  load_hyps<KPL>(a, b, label, n0, n1, n2, d, cnt);

  for (int r0 = 0; r0 < run_rows; r0 += tile) {
    const int r1 = min(run_rows, r0 + tile);
    __pipeline_wait_prior(0);
    __syncthreads();                           // the rows have landed; the tile before is read
    unpack_rows(a, r1 - r0, m);
    __syncthreads();                           // the pixels are in place; the rows are free
#ifdef DPLX_PROFILE
    if (r0 == 0) stamp(a, 2, global_ns());
#endif
    if (r1 < run_rows) {
      copy_rows(a, b, r1, min(tile, run_rows - r1), m);
      __pipeline_commit();
    }
    for (int r = r0; r < r1;) {
      const int stop = min(seg_end, r1);
      const int t1 = (stop - r0) * P;
#pragma unroll 4
      for (int t = (r - r0) * P + warp; t < t1; t += kWarps) {
        const float4 v = m.pix[t];
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          float e = v.x * n0[i];
          e = e + v.y * n1[i];
          e = e + v.z * n2[i];
          e = e + d[i];
          count_outlier(cnt[i], e, a.thr);
        }
      }
      r = stop;
      if (r == seg_end) {                      // the segment ends: its counts out
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int k = lane + 32 * i;
          if (k < a.kc && cnt[i]) atomicAdd(m.cnt + k, cnt[i]);
        }
        __syncthreads();
        int* o = a.counts + ((size_t)b * a.maxp + (label - 1)) * a.kc;
        for (int k = threadIdx.x; k < a.kc; k += kThreads) {
          const int c = m.cnt[k];
          if (c) {
            atomicAdd(o + k, c);
            m.cnt[k] = 0;
          }
        }
        if (r < run_rows) {                    // the next segment
          label = label_at(m.bnd, a.maxp, c0 + r / P);
          seg_start = r;
          seg_end = (min((int)m.bnd[label + 1], c1) - c0) * P;
          load_hyps<KPL>(a, b, label, n0, n1, n2, d, cnt);
        }
        __syncthreads();
      }
    }
  }
}

// The early-exit update of frame b's planes on the chunk's final counts
// (ops/ransac.py:_apply_chunk), kPlaneLanes lanes a plane. The counts are
// integers and the inliers np - c exact, so the running best needs no scan:
// the first hypothesis to reach the target is the first with np - c >=
// target (0 if run_best already does), and the running best after the chunk
// is max(run_best, np - the least count). Each round stages as many planes'
// counts as fit in `scratch` (the pixel and row buffers, read by now), zeroes
// them in global memory and copies them to losses; then done[b], scored[b]
// and the ticket.
__device__ __forceinline__ void finish_frame(const StepArgs& a, int b, int* scratch) {
  __shared__ int s_all;                        // every plane reached
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x % kPlaneLanes, kc = a.kc, cs = count_stride(kc);
  const int per_lane = (kc + kPlaneLanes - 1) / kPlaneLanes;
  const size_t b0 = (size_t)b * a.maxp;
  const bool vec = kc % 4 == 0;
  if (threadIdx.x == 0) s_all = 1;
  for (int p0 = 0; p0 < a.maxp; p0 += finish_planes(kc)) {
    const int n = min(finish_planes(kc), a.maxp - p0);
    const int* src = a.counts + (b0 + p0) * kc;
    if (vec) {
      for (int i = threadIdx.x; i < n * kc / 4; i += kThreads) {
        const int row = 4 * i / kc, col = 4 * i - row * kc;
        const unsigned sd =
            static_cast<unsigned>(__cvta_generic_to_shared(scratch + row * cs + col));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd), "l"(src + 4 * i));
      }
    } else {
      for (int i = threadIdx.x; i < n * kc; i += kThreads)
        scratch[(i / kc) * cs + i % kc] = __ldcg(src + i);
    }
    // The plane's state, kPlaneLanes lanes a plane, while the counts land.
    const int p = p0 + threadIdx.x / kPlaneLanes;
    const bool mine = threadIdx.x / kPlaneLanes < n;
    const size_t bp = b0 + p;
    float np = 0.f, tg = 0.f, rb = 0.f, bl = 0.f;
    bool was = true;
    if (mine) {
      np = __ldcg(a.n_pts + bp);
      tg = __ldcg(a.target + bp);
      rb = __ldcg(a.run_best + bp);
      bl = __ldcg(a.best_loss + bp);
      was = __ldcg(a.reached + bp);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    int* dst = a.counts + (b0 + p0) * kc;
    for (int i = threadIdx.x; i < n * kc; i += kThreads) {
      const int row = i / kc, col = i - row * kc;
      __stcg(dst + i, 0);
#ifndef DPLX_PROFILE
      if (a.losses) a.losses[(b0 + p0) * kc + i] = scratch[row * cs + col];
#endif
    }
    // Each lane scans its share of the plane's hypotheses, starting at a
    // rotated place so that the lanes of a warp read distinct banks.
    const int* row = scratch + (threadIdx.x / kPlaneLanes) * cs;
    const int k0 = min(kc, sub * per_lane), k1 = min(kc, k0 + per_lane), len = k1 - k0;
    const int rot = len > 0 ? (lane / kPlaneLanes) % len : 0;
    int least = INT_MAX, first = INT_MAX;
    for (int i = 0; mine && i < len; ++i) {
      int k = k0 + i + rot;
      if (k >= k1) k -= len;
      const int c = row[k];
      least = min(least, c);
      if (np - (float)c >= tg) first = min(first, k);
    }
    for (int off = 1; off < kPlaneLanes; off <<= 1) {
      least = min(least, __shfl_xor_sync(dplx::kFullMask, least, off));
      first = min(first, __shfl_xor_sync(dplx::kFullMask, first, off));
    }
    if (rb >= tg) first = 0;
    const bool any_hit = first != INT_MAX;
    const int stop = any_hit ? first : kc - 1;
    int best = INT_MAX, j = INT_MAX;           // the least count of [0, stop], first on ties
    for (int i = 0; mine && i < len; ++i) {
      int k = k0 + i + rot;
      if (k >= k1) k -= len;
      const int c = row[k];
      if (k <= stop && (c < best || (c == best && k < j))) {
        best = c;
        j = k;
      }
    }
    for (int off = 1; off < kPlaneLanes; off <<= 1) {
      const int b2 = __shfl_xor_sync(dplx::kFullMask, best, off);
      const int j2 = __shfl_xor_sync(dplx::kFullMask, j, off);
      if (b2 < best || (b2 == best && j2 < j)) {
        best = b2;
        j = j2;
      }
    }
    if (mine && sub == 0) {
      const bool reached = was || any_hit;
      if (!was && (float)best < bl) {
        a.best_loss[bp] = (float)best;
        a.best_k[bp] = (long long)a.s * kc + j;
      }
      a.reached[bp] = reached;
      a.run_best[bp] = fmaxf(rb, np - (float)least);
      if (!reached) s_all = 0;
    }
    __syncthreads();                           // the rows are read
  }
  if (threadIdx.x == 0) {
    a.done[b] = (unsigned char)s_all;
    a.scored[b] += 1;
    a.tickets[b] = 0;
  }
}

template <int KPL>
__global__ void __launch_bounds__(kThreads) ransac_chunk_step(StepArgs a) {
  extern __shared__ float4 smem[];
  __shared__ int s_flag;
  const Smem m = carve(a, smem);
  const int b = blockIdx.y, G = a.gh * a.gw;
#ifdef DPLX_PROFILE
  const long long t_start = global_ns();
#endif
  const int q0 = blockIdx.x * a.run_cells, q1 = min(G, q0 + a.run_cells);
  // Everything the run needs that depends on no other load, at once: the
  // done flag, the frame's bounds and the run's cells' source offsets.
  const bool done = a.done[b];
  const long long* bnd = a.bounds + (size_t)b * (a.maxp + 2);
  for (int i = threadIdx.x; i < a.maxp + 2; i += kThreads) m.bnd[i] = bnd[i];
  const long long* ord = a.order + (size_t)b * G;
  for (int q = q0 + threadIdx.x; q < q1; q += kThreads) {
    const int cell = (int)ord[q], ci = cell / a.gw, cj = cell - ci * a.gw;
    m.base[q - q0] = (ci * a.P * a.W + cj * a.P) * 3;
  }
  if (done) return;
  __syncthreads();
#ifdef DPLX_PROFILE
  stamp(a, 0, t_start);
  stamp(a, 1, global_ns());
  stamp(a, 2, global_ns());
#endif
  // Block j scores the labelled cells of sorted positions [j R, (j + 1) R).
  const int c0 = max(q0, (int)m.bnd[1]), c1 = min(q1, (int)m.bnd[a.maxp + 1]);
  if (c0 < c1) {
    Smem mr = m;
    mr.base += c0 - q0;
    score_run<KPL>(a, b, c0, c1, mr);
  }
#ifdef DPLX_PROFILE
  stamp(a, 3, global_ns());
#endif

  // The frame's last block to finish applies the update.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_flag = atomicAdd(a.tickets + b, 1) == (int)gridDim.x - 1;
  __syncthreads();
#ifdef DPLX_PROFILE
  stamp(a, 4, global_ns());
  stamp(a, 6, (c0 < c1) | (s_flag ? 2 : 0));
  unsigned sm;
  asm("mov.u32 %0, %%smid;" : "=r"(sm));
  stamp(a, 7, sm);
  if (!s_flag) stamp(a, 5, global_ns());
#endif
  if (!s_flag) return;
  __threadfence();
  finish_frame(a, b, reinterpret_cast<int*>(smem));
#ifdef DPLX_PROFILE
  stamp(a, 5, global_ns());
#endif
}

template <int KPL>
cudaError_t launch(const StepArgs& a, int B, cudaStream_t stream) {
  const int G = a.gh * a.gw;
  const dim3 grid((G + a.run_cells - 1) / a.run_cells, B);
  const size_t smem = smem_bytes(a.kc, a.maxp, a.run_cells, a.P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ransac_chunk_step<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ransac_chunk_step<KPL><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts: (B, H, W, 3) float32; hyp: (B, maxp, n_hyp, 4) float32, n_hyp = S *
// kc; order: (B, gh*gw) int64 and bounds: (B, maxp + 2) int64
// (ops/ransac.py:sample_hypotheses); the state (ops/ransac.py:ChunkState):
// n_pts, target, run_best, best_loss (B, maxp) float32, reached (B, maxp)
// bool, best_k (B, maxp) int64, done (B,) bool, scored (B,) int32, counts
// (B, maxp, kc) int32 and tickets (B,) int32, both zero; losses: (B, maxp,
// kc) int32 or null. kc <= 256, 1 <= P <= 1536, run_cells >= 1, the
// shared memory of (kc, maxp, run_cells) at most 227 KB.
int dplx_ransac_chunk_step(const void* pts, const void* hyp, const void* order,
                           const void* bounds, const void* n_pts, const void* target,
                           void* reached, void* run_best, void* best_loss, void* best_k,
                           void* done, void* scored, void* counts, void* tickets, void* losses,
                           int B, int H, int W, int gh, int gw, int P, int maxp, int n_hyp, int s,
                           int kc, int run_cells, float thr, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0 || maxp <= 0) return (int)cudaSuccess;
  if (kc <= 0 || kc > 32 * kMaxPerLane || P < 1 || tile_rows(P) < 1 || run_cells < 1 ||
      smem_bytes(kc, maxp, run_cells, P) > 232448 || finish_planes(kc) < 1)
    return (int)cudaErrorInvalidValue;
  StepArgs a{static_cast<const float*>(pts), static_cast<const float4*>(hyp),
             static_cast<const long long*>(order), static_cast<const long long*>(bounds),
             static_cast<const float*>(n_pts), static_cast<const float*>(target),
             static_cast<unsigned char*>(reached), static_cast<float*>(run_best),
             static_cast<float*>(best_loss), static_cast<long long*>(best_k),
             static_cast<unsigned char*>(done), static_cast<int*>(scored),
             static_cast<int*>(counts), static_cast<int*>(tickets), static_cast<int*>(losses),
             H, W, gh, gw, P, maxp, n_hyp, s, kc, run_cells, thr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kc <= 32) return (int)launch<1>(a, B, st);
  if (kc <= 64) return (int)launch<2>(a, B, st);
  if (kc <= 128) return (int)launch<4>(a, B, st);
  return (int)launch<8>(a, B, st);
}

}  // extern "C"
