// Stage-3 kernel: the region-growing rounds loop of every frame.
//
// Replaces the TPU kernel deplex_tpu/ops/pallas_growing.py:_kernel_batched
// (K2). Each round of a frame: (1) pick the dominant normal-histogram bin,
// first max wins; (2) seed at the candidate cell of that bin with the least
// MSE, first cell in row-major order wins (cell 0 if there is none); (3)
// grow the region as directed reachability from the seed over the four edge
// masks inside the unassigned planar cells; (4) consume it. The loop stops
// when the peak bin count is below min_cand (that round still counts and
// records its seed), when no planar cell is left, or at r_max rounds.
// Outputs follow ops/growing.py:grow_rounds_loop: round_map, seeds (gh*gw
// for rounds that never ran) and nr_rounds.
//
// Bound on the H100 by latency: 40-100 dependent rounds per frame, each a
// handful of block-wide steps. Design: one 1024-thread block per frame, so
// frames retire on their own and run on separate SMs. The histogram is exact
// and lives in shared memory as int counts (integer atomics are
// order-free); the unassigned set is a shared-memory bitmask. The fill is a
// breadth-first frontier: a cell joins by clearing its bit with atomicAnd,
// and whoever clears it appends it to a per-frame list in global memory
// (scratch from the caller). Each cell is appended once per frame, so a
// round's region is one contiguous slice of that list, and the work of all
// fills of a frame is O(cells). The region found does not depend on the
// order of the frontier. bins, mse and the packed edge bytes stay in global
// memory, where L2 holds them.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// Bits of the packed edge byte (ops/growing.py:pack_edges).
constexpr uint8_t kFromUp = 1, kFromDown = 2, kFromLeft = 4, kFromRight = 8,
                  kPlanar = 16;

__device__ __forceinline__ void try_claim(unsigned* avail, int t, bool ok,
                                          int* tail, int* list) {
  if (!ok) return;
  const unsigned bit = 1u << (t & 31);
  if (!(((volatile unsigned*)avail)[t >> 5] & bit)) return;
  if (atomicAnd(&avail[t >> 5], ~bit) & bit) list[atomicAdd(tail, 1)] = t;
}

__global__ void __launch_bounds__(kThreads)
grow_rounds_kernel(const int* __restrict__ bins, const float* __restrict__ mse,
                   const uint8_t* __restrict__ edges, int gh, int gw, int nb2,
                   int r_max, int min_cand, int* __restrict__ round_map,
                   int* __restrict__ seeds, int* __restrict__ nr_rounds,
                   int* __restrict__ list) {
  extern __shared__ unsigned smem[];
  int* hist = reinterpret_cast<int*>(smem);
  unsigned* avail = smem + nb2;
  __shared__ int red_i[32], red_v[32];
  __shared__ float red_f[32];
  __shared__ int s_tail, s_remaining;

  const int N = gh * gw;
  const int words = (N + 31) >> 5;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  bins += (size_t)b * N;
  mse += (size_t)b * N;
  edges += (size_t)b * N;
  round_map += (size_t)b * N;
  seeds += (size_t)b * r_max;
  list += (size_t)b * N;

  for (int i = tid; i < nb2; i += T) hist[i] = 0;
  for (int w = tid; w < words; w += T) avail[w] = 0u;
  for (int r = tid; r < r_max; r += T) seeds[r] = N;
  if (tid == 0) {
    s_tail = 0;
    s_remaining = 0;
  }
  __syncthreads();
  int planar = 0;
  for (int c = tid; c < N; c += T) {
    round_map[c] = -1;
    if (edges[c] & kPlanar) {
      atomicOr(&avail[c >> 5], 1u << (c & 31));
      ++planar;
      const int bn = bins[c];
      if (bn >= 0 && bn < nb2) atomicAdd(&hist[bn], 1);
    }
  }
  atomicAdd(&s_remaining, planar);
  __syncthreads();

  int round = 0;
  while (s_remaining > 0 && round < r_max) {
    // 1. Dominant bin (largest count, first bin on ties).
    int bv = INT_MIN, bi = INT_MAX;
    for (int i = tid; i < nb2; i += T) {
      const int v = hist[i];
      if (v > bv) { bv = v; bi = i; }
    }
    dplx::block_arg_reduce<true, int>(bv, bi, red_v, red_i, INT_MIN);
    const int mf = bi;
    const bool stop = bv < min_cand;

    // 2. Seed: least-MSE live cell of that bin, first cell on ties.
    float mv = INFINITY;
    int mi = INT_MAX;
    for (int c = tid; c < N; c += T) {
      const bool cand = ((avail[c >> 5] >> (c & 31)) & 1u) && bins[c] == mf;
      const float v = cand ? mse[c] : INFINITY;
      if (dplx::better_min(v, c, mv, mi)) { mv = v; mi = c; }
    }
    dplx::block_arg_reduce<false, float>(mv, mi, red_f, red_i, INFINITY);
    const int seed = mi;
    if (tid == 0) seeds[round] = seed;
    if (stop) {
      ++round;
      break;
    }

    // 3. Breadth-first fill from the seed over the directed edges.
    const int start = s_tail;
    __syncthreads();
    if (tid == 0) {
      const unsigned bit = 1u << (seed & 31);
      if (avail[seed >> 5] & bit) {
        avail[seed >> 5] &= ~bit;
        list[start] = seed;
        s_tail = start + 1;
      }
    }
    __syncthreads();
    int lo = start, hi = s_tail;
    while (lo < hi) {
      for (int k = lo + tid; k < hi; k += T) {
        const int c = list[k];
        const int r = c / gw, col = c - r * gw;
        if (r + 1 < gh) try_claim(avail, c + gw, edges[c + gw] & kFromUp, &s_tail, list);
        if (r > 0) try_claim(avail, c - gw, edges[c - gw] & kFromDown, &s_tail, list);
        if (col + 1 < gw) try_claim(avail, c + 1, edges[c + 1] & kFromLeft, &s_tail, list);
        if (col > 0) try_claim(avail, c - 1, edges[c - 1] & kFromRight, &s_tail, list);
      }
      __syncthreads();
      lo = hi;
      hi = s_tail;
      __syncthreads();
    }

    // 4. Consume the region: list[start, hi).
    for (int k = start + tid; k < hi; k += T) {
      const int c = list[k];
      round_map[c] = round;
      const int bn = bins[c];
      if (bn >= 0 && bn < nb2) atomicSub(&hist[bn], 1);
    }
    if (tid == 0) s_remaining -= hi - start;
    ++round;
    __syncthreads();
  }
  if (tid == 0) nr_rounds[b] = round;
}

}  // namespace

extern "C" {

// bins (B, gh*gw) int32; mse (B, gh*gw) float32; edges (B, gh*gw) uint8
// packed as ops/growing.py:pack_edges; round_map (B, gh*gw) int32;
// seeds (B, r_max) int32; nr_rounds (B,) int32; list (B, gh*gw) int32 scratch.
int dplx_grow_rounds(const void* bins, const void* mse, const void* edges,
                     int B, int gh, int gw, int nb2, int r_max, int min_cand,
                     void* round_map, void* seeds, void* nr_rounds, void* list,
                     void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = ((size_t)nb2 + (size_t)(gh * gw + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grow_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  grow_rounds_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<const float*>(mse),
      static_cast<const uint8_t*>(edges), gh, gw, nb2, r_max, min_cand,
      static_cast<int*>(round_map), static_cast<int*>(seeds),
      static_cast<int*>(nr_rounds), static_cast<int*>(list));
  return (int)cudaGetLastError();
}

}  // extern "C"
