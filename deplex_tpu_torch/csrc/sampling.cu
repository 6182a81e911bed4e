// Stage-6 sampling kernel: every plane's K three-point hypotheses, and what
// the early-exit loop starts from, in one launch.
//
// Replaces what the JAX package leaves to XLA inside refine_labels: the
// cell-grid sampling of deplex_tpu/ops/ransac.py:105-135 (a stable argsort
// of the cell labels, the planes' bounds by binary search, three distinct
// ranks a hypothesis, the gathers and the fit) and pad_hyp (:173-189); none
// of them has a pallas_call. What it computes is
// ops/ransac.py:sample_stage_reference, bit for bit:
//   - the merged cell labels, lut[labels_map] with lut[0] = 0 and lut[k] =
//     merge_labels[k-1] + 1 (ops/merge.py:apply_label_lut; without merge
//     labels lut[k] = k); a cell label outside 0..M, or a merged id outside
//     it, is taken as 0 (the pipeline's are inside);
//   - cell_order, each frame's cells in a stable order of merged id (ties
//     in raster order, as torch.argsort(stable=True) gives them), bounds[m]
//     the number of cells with an id below m (m = 0..M+1), and the pixels a
//     plane, counts[p] = (bounds[p+2] - bounds[p+1]) * P*P;
//   - hypothesis k of plane p: ranks u = raw mod max(cnt, 1) (or the
//     caller's ranks), the de-duplicating shift of _distinct, then for each
//     of the three: crank = floor(idx / P*P), t = idx mod P*P (floor
//     semantics: torch's int64 // and %), the cell at clamp(bounds[p+1] +
//     crank, 0, G-1) of the order, its pixel, its point; the plane through
//     the three (_fit_3pt_plane: the cross product spelled out, the norm's
//     sqrt in double rounded to float, true divisions, d summed left to
//     right; the library is built with -fmad=false, so nothing contracts),
//     a non-finite one sanitized to (0, 0, 0, 1e30), and so is every padded
//     slot k in [K, S*Kc);
//   - the ChunkState before chunk 0 (new_chunk_state): n_pts = counts,
//     target = ratio * n_pts, reached 0, run_best -inf, best_loss +inf,
//     best_k 0, done 0, scored 0 and the chunk step's counts and tickets 0.
//
// Integer widths: raw numbers are below 2^31 and a plane's pixel count at
// most G*P*P; where both operands of a division lie in [0, 2^32) the
// kernel divides in 32 bits, which is exact there; every other case (a
// caller's negative or huge ranks) takes the 64-bit floor division.
// Sums that may wrap (rank + 1, bounds + crank) wrap as torch's int64 do.
//
// What bounds it on the H100: bytes. At the shipped RANSAC ini, B=8 (TUM,
// M=64, K=1000 in 8 chunks of 128) it writes 8.4 MB of hypotheses, reads
// 1.5 MB of raw numbers and the points of the pixels the draws reach (at
// most 18.4 MB), and moves ~0.6 MB of labels, order and state.
//
// The design, a simple one that is right. The grid is (slices of the M *
// S*Kc hypothesis slots, B), about one wave of blocks over the batch (two
// blocks an SM): one block a frame would leave most of the card idle, and
// more blocks than fit at once would only repeat the sort. Each block
// rebuilds its frame's sort in shared memory, which is cheap at these
// grids (3,072 cells at TUM): it loads the merged ids once (uint16), its
// loads unrolled so they are in flight together, then each warp walks its
// own span of cells in raster
// order, 32 at a time, and ranks each lane among the equal ids of its warp
// with __match_any_sync. Pass one counts each warp's cells by id (the
// leader of each group adds the group's size: no atomics, no order that
// depends on timing); exclusive scans over warps and over ids give each
// warp's first position for each id; pass two writes each cell at its
// warp's position plus its rank. Then each thread takes slots of its
// slice, two at a time (the raw numbers of both, then the six points, then
// the two fits, so the two chains of dependent loads overlap): consecutive
// threads take consecutive k, so the raw numbers are read and the 16-byte
// hypotheses written coalesced. Block (0, b) alone
// writes the frame's merged labels, order, bounds, counts and state.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Hypothesis slots a thread has in flight at once (their loads overlap).
constexpr int kSlots = 2;
// Blocks an SM holds (__launch_bounds__: at most 64 registers a thread).
constexpr int kBlocksPerSM = 2;
constexpr unsigned kFullMask = 0xffffffffu;
// The shared memory a block may take (the H100's 227 KB).
constexpr int kMaxSharedBytes = 232448;

struct Args {
  const int* labels_map;   // (B, G) round finalize's cell labels
  const int* merge;        // (B, M) K3's merge labels, or null: merged already
  const float* points;     // (B, N, 3)
  const long long* draws;  // (M, K, 3) or, with batched, (B, M, K, 3)
  int raw;                 // draws are raw numbers (ranks = raw mod max(cnt, 1))
  int batched;             // draws has a frame axis
  long long N;             // points a frame
  int G, gw, P, W, M, K, n_hyp, Kc;
  int per_block;           // hypothesis slots a block fits: a multiple of kThreads * kSlots
  float ratio;
  int* cells;              // (B, G) merged cell labels
  long long* order;        // (B, G)
  long long* bounds;       // (B, M+2)
  long long* counts;       // (B, M)
  float4* hyp;             // (B, M, n_hyp): (n0, n1, n2, d)
  // The ChunkState (ops/ransac.py), in its field order.
  float* n_pts;
  float* target;
  uint8_t* reached;
  float* run_best;
  float* best_loss;
  long long* best_k;
  uint8_t* done;
  int* scored;
  int* step_counts;        // (B, M, Kc)
  int* tickets;
};

// The dynamic shared memory of a block: the ids' first positions (M+2),
// the LUT (M+1), each warp's counts by id (kWarps x (M+1)), the order (G
// ints) and the merged ids (G uint16). kernels/sampling.py:shared_bytes
// computes the same, to raise before a launch that would be refused.
__host__ __device__ inline size_t shared_bytes(int G, int M) {
  const size_t ints = (size_t)(M + 2) + (M + 1) + (size_t)kWarps * (M + 1) + G;
  return (4 * ints + 2 * (size_t)G + 15) / 16 * 16;
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ bool small(long long a) {
  return (unsigned long long)a <= 0xffffffffull;     // 0 <= a < 2^32
}

// a mod c in [0, c) for c >= 1, torch's int64 % (the sign of the divisor).
__device__ __forceinline__ long long floor_mod(long long a, long long c) {
  if (small(a) && small(c)) return (long long)((unsigned)a % (unsigned)c);
  const long long r = a % c;
  return r < 0 ? r + c : r;
}

// floor(a / c) for c >= 1, torch's int64 //.
__device__ __forceinline__ long long floor_div(long long a, long long c) {
  if (small(a) && small(c)) return (long long)((unsigned)a / (unsigned)c);
  const long long q = a / c;
  return (a % c != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) sample_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  const int M = a.M, G = a.G, PP = a.P * a.P;
  int* start = smem;                          // M+2
  int* lut = start + (M + 2);                 // M+1
  int* hist = lut + (M + 1);                  // kWarps x (M+1)
  int* order = hist + kWarps * (M + 1);       // G
  uint16_t* ids = reinterpret_cast<uint16_t*>(order + G);   // G
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool writer = blockIdx.x == 0;

  // The LUT and the frame's merged ids.
  for (int k = tid; k <= M; k += kThreads) {
    int v = k;
    if (a.merge != nullptr) v = k == 0 ? 0 : a.merge[(long long)b * M + k - 1] + 1;
    lut[k] = v < 0 || v > M ? 0 : v;
  }
  for (int i = tid; i < kWarps * (M + 1); i += kThreads) hist[i] = 0;
  __syncthreads();
  // No global store in this loop, so the unrolled loads are in flight together.
  const int* labels = a.labels_map + (long long)b * G;
#pragma unroll 8
  for (int c = tid; c < G; c += kThreads) {
    const int k = labels[c];
    ids[c] = (uint16_t)(k < 0 || k > M ? 0 : lut[k]);
  }
  __syncthreads();

  // Pass one: each warp counts its span's cells by id.
  const int span = ((G + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = min(G, warp * span), hi = min(G, lo + span);
  int* mine = hist + warp * (M + 1);
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const int id = c < hi ? (int)ids[c] : -1;
    const unsigned peers = __match_any_sync(kFullMask, id);
    if (id >= 0 && lane == __ffs(peers) - 1) mine[id] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Exclusive scan over warps for each id; the id's total into start.
  for (int id = tid; id <= M; id += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = hist[w * (M + 1) + id];
      hist[w * (M + 1) + id] = run;
      run += n;
    }
    start[id] = run;
  }
  __syncthreads();
  // Exclusive scan over ids (warp 0, 32 ids a step); start[M+1] = G.
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base <= M; base += 32) {
      const int i = base + lane;
      const int v = i <= M ? start[i] : 0;
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += n;
      }
      if (i <= M) start[i] = carry + incl - v;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) start[M + 1] = carry;
  }
  __syncthreads();
  for (int i = tid; i < kWarps * (M + 1); i += kThreads) hist[i] += start[i % (M + 1)];
  __syncthreads();
  // Pass two: each cell at its warp's first position for its id plus its
  // rank among the equal ids before it in the warp's step.
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const int id = c < hi ? (int)ids[c] : -1;
    const unsigned peers = __match_any_sync(kFullMask, id);
    if (id >= 0) order[mine[id] + __popc(peers & ((1u << lane) - 1u))] = c;
    __syncwarp();
    if (id >= 0 && lane == __ffs(peers) - 1) mine[id] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  if (writer) {
    for (int i = tid; i < G; i += kThreads) {
      a.cells[(long long)b * G + i] = ids[i];
      a.order[(long long)b * G + i] = order[i];
    }
    for (int m = tid; m <= M + 1; m += kThreads) a.bounds[(long long)b * (M + 2) + m] = start[m];
    for (int p = tid; p < M; p += kThreads) {
      const long long o = (long long)b * M + p;
      const long long cnt = (long long)(start[p + 2] - start[p + 1]) * PP;
      const float n = (float)cnt;
      a.counts[o] = cnt;
      a.n_pts[o] = n;
      a.target[o] = a.ratio * n;
      a.reached[o] = 0;
      a.run_best[o] = -INFINITY;
      a.best_loss[o] = INFINITY;
      a.best_k[o] = 0;
    }
    for (int i = tid; i < M * a.Kc; i += kThreads) a.step_counts[(long long)b * M * a.Kc + i] = 0;
    if (tid == 0) {
      a.done[b] = 0;
      a.scored[b] = 0;
      a.tickets[b] = 0;
    }
  }

  // The hypotheses of this block's slice, kSlots a thread at a time: every
  // slot's raw numbers are loaded, then every slot's three points, then the
  // fits, so the loads of a thread's slots overlap. A slot past the slice
  // or past K computes on rank 0 of a valid plane (its loads stay inside
  // the arrays) and writes the padding, or nothing.
  const int total = M * a.n_hyp;
  const int h0 = blockIdx.x * a.per_block;
  const int h1 = min(total, h0 + a.per_block);
  const float* pts = a.points + (long long)b * a.N * 3;
  const long long* draws = a.draws + (a.batched ? (long long)b * M * a.K * 3 : 0);
  for (int h = h0 + tid; h < h1; h += kSlots * kThreads) {
    long long u[kSlots][3];
    int plane[kSlots];
    bool real[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int hs = h + s * kThreads;
      const int p = min(hs / a.n_hyp, M - 1), k = hs - p * a.n_hyp;
      plane[s] = p;
      real[s] = hs < h1 && k < a.K;
      const long long* r = draws + ((long long)p * a.K + (real[s] ? k : 0)) * 3;
      u[s][0] = real[s] ? r[0] : 0;
      u[s][1] = real[s] ? r[1] : 0;
      u[s][2] = real[s] ? r[2] : 0;
    }
    float q[kSlots][3][3];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int p = plane[s];
      const long long first = start[p + 1];
      const long long c = max((long long)(start[p + 2] - start[p + 1]) * PP, 1ll);
      long long u0 = u[s][0], u1 = u[s][1], u2 = u[s][2];
      if (a.raw) {
        u0 = floor_mod(u0, c);
        u1 = floor_mod(u1, c);
        u2 = floor_mod(u2, c);
      }
      // _distinct: the shift of the reference package, on the raw ranks.
      const long long v1 = wrap_add(u1, u1 == u0);
      const long long v2 = wrap_add(wrap_add(u2, u2 == u0), u2 == v1);
      const long long idx[3] = {u0, floor_mod(v1, c), floor_mod(v2, c)};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const long long crank = floor_div(idx[j], PP);
        // idx - crank * PP in [0, PP): exact modulo 2^64.
        const int t = (int)((unsigned long long)idx[j] -
                            (unsigned long long)crank * (unsigned long long)PP);
        long long pos = wrap_add(first, crank);
        pos = pos < 0 ? 0 : pos > G - 1 ? G - 1 : pos;
        const int cell = order[pos];
        const int row = cell / a.gw, col = cell - row * a.gw;
        const int tr = t / a.P, tc = t - tr * a.P;
        const long long pix = (long long)(row * a.P + tr) * a.W + (col * a.P + tc);
        q[s][j][0] = pts[pix * 3];
        q[s][j][1] = pts[pix * 3 + 1];
        q[s][j][2] = pts[pix * 3 + 2];
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int hs = h + s * kThreads;
      if (hs >= h1) break;
      float4 out = make_float4(0.f, 0.f, 0.f, 1e30f);
      if (real[s]) {
        // _fit_3pt_plane, operation by operation.
        const float a0 = q[s][1][0] - q[s][0][0], a1 = q[s][1][1] - q[s][0][1];
        const float a2 = q[s][1][2] - q[s][0][2];
        const float b0 = q[s][2][0] - q[s][0][0], b1 = q[s][2][1] - q[s][0][1];
        const float b2 = q[s][2][2] - q[s][0][2];
        const float n0 = a1 * b2 - a2 * b1;
        const float n1 = a2 * b0 - a0 * b2;
        const float n2 = a0 * b1 - a1 * b0;
        const float nrm = (float)sqrt((double)(n0 * n0 + n1 * n1 + n2 * n2));
        const float m0 = n0 / nrm, m1 = n1 / nrm, m2 = n2 / nrm;
        const float d = -(m0 * q[s][0][0] + m1 * q[s][0][1] + m2 * q[s][0][2]);
        if (isfinite(d) && isfinite(m0) && isfinite(m1) && isfinite(m2))
          out = make_float4(m0, m1, m2, d);
      }
      a.hyp[(long long)b * total + hs] = out;
    }
  }
}

}  // namespace

extern "C" {

// labels_map (B, gh, gw) int32; merge_labels (B, M) int32 or null (the
// labels are merged already); points (B, H*W, 3) float32; draws int64: raw
// numbers (raw = 1) of shape (M, K, 3), or ranks of shape (M, K, 3) or,
// with batched = 1, (B, M, K, 3). Outputs, all contiguous on the card:
// cells (B, gh, gw) int32, order (B, gh*gw) int64, bounds (B, M+2) int64,
// counts (B, M) int64, hyp (B, M, n_hyp, 4) float32 (16-byte aligned,
// n_hyp = S*Kc >= K), and the ChunkState: n_pts, target, run_best,
// best_loss (B, M) float32, reached (B, M) bool, best_k (B, M) int64, done
// (B,) bool, scored (B,) int32, step_counts (B, M, Kc) int32, tickets (B,)
// int32.
int dplx_ransac_sample(const void* labels_map, const void* merge_labels, const void* points,
                       const void* draws, int raw, int batched, int B, int H, int W, int gh,
                       int gw, int P, int M, int K, int n_hyp, int Kc, float ratio, void* cells,
                       void* order, void* bounds, void* counts, void* hyp, void* n_pts,
                       void* target, void* reached, void* run_best, void* best_loss,
                       void* best_k, void* done, void* scored, void* step_counts, void* tickets,
                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const long long G = (long long)gh * gw;
  if (B > 65535 || P <= 0 || M < 0 || M > 65535 || K < 0 || n_hyp < K || Kc < 0 ||
      G <= 0 || G > (1 << 30) || (long long)gh * P > H || (long long)gw * P > W ||
      (long long)M * n_hyp > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes((int)G, M);
  if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{static_cast<const int*>(labels_map), static_cast<const int*>(merge_labels),
         static_cast<const float*>(points), static_cast<const long long*>(draws), raw,
         batched, (long long)H * W, (int)G, gw, P, W, M, K, n_hyp, Kc, 0, ratio,
         static_cast<int*>(cells), static_cast<long long*>(order),
         static_cast<long long*>(bounds), static_cast<long long*>(counts),
         static_cast<float4*>(hyp), static_cast<float*>(n_pts), static_cast<float*>(target),
         static_cast<uint8_t*>(reached), static_cast<float*>(run_best),
         static_cast<float*>(best_loss), static_cast<long long*>(best_k),
         static_cast<uint8_t*>(done), static_cast<int*>(scored), static_cast<int*>(step_counts),
         static_cast<int*>(tickets)};
  // One wave: about kBlocksPerSM blocks an SM over the batch (each block
  // sorts its frame again, so more blocks than fit at once only repeat
  // that), each block at least kThreads * kSlots slots.
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long step = kThreads * kSlots;
  const long long total = (long long)M * n_hyp;
  const long long wave = ((long long)sms * kBlocksPerSM + B - 1) / B;
  const long long most = (total + step - 1) / step;
  const long long blocks = max(1ll, min(wave, most));
  a.per_block = (int)(((total + blocks - 1) / blocks + step - 1) / step * step);
  const dim3 grid((unsigned)(a.per_block > 0 ? (total + a.per_block - 1) / a.per_block : 1),
                  B);
  sample_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
