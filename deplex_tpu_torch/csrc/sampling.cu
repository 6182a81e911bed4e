// Stage-6 sampling kernels: every plane's K three-point hypotheses, and what
// the early-exit loop starts from, in two launches (a sort, then the fits).
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
//     sqrt correctly rounded in float, which is the twin's sqrt in double
//     rounded to float, true divisions, d summed left to right; the library
//     is built with -fmad=false, so nothing contracts), a non-finite one
//     sanitized to (0, 0, 0, 1e30), and so is every padded slot k in
//     [K, S*Kc);
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
// 1.5 MB of raw numbers and the points of the pixels the draws reach, and
// moves ~0.8 MB of labels, order and state (4.46 us at 3.35 TB/s). What
// holds it back is latency (the sort, then each slot's chain of dependent
// loads: raw numbers, the order, three points, and its fit) and each SM's
// rate of scattered point loads, which needs every SM and loads that stay
// near one another (one plane's pixels).
//
// The design, from a clock64 profile (kernel_bench --sampling-profile): a
// frame's sort runs once, on a thread-block cluster; its slots run on the
// whole card. One launch of clusters cannot do both: a frame's work would be
// held to one cluster (at most 16 blocks, and the card places only 7
// clusters of 16 at once), so B=8 would fit its slots on 64 SMs and B=1 on
// 16, where the slots' scattered loads want all 132.
//   Launch 1, sort_kernel: a cluster of C = 1, 2, 4, 8 or 16 blocks a frame
//   (kernels/sampling.py:launch_plan).
//   1. Block j of the cluster owns the span of `span` cells from j * span,
//      and each of its 16 warps a sub-span, walked 32 cells a step in raster
//      order (the first kCacheSteps steps' ids kept in registers, later ones
//      read again). Pass one LUTs the labels, writes the merged labels, and
//      counts the warp's cells by id: a lane's group of equal ids comes from
//      __match_any_sync and the group's leader adds its size (no atomics, no
//      order that depends on timing). A scan over the warps (a half-warp an
//      id, shuffles) gives each warp's first position within the block and
//      the block's totals.
//   2. After a cluster barrier each block reads every block's totals through
//      distributed shared memory: the ids' first positions (a scan over the
//      ids: bounds) and its own offset (the totals of the blocks before it).
//   3. Pass two writes each cell at its warp's running position for its id
//      plus its rank in the step, to the order. No block holds more than its
//      tables (the LUT and the counts by id), so any grid runs.
//   4. The state (bounds, counts, the ChunkState, the chunk step's zeroed
//      counts) is written by the cluster's threads, the part that needs no
//      count between the halves of the cluster barrier (arrive, then wait);
//      the merged labels in pass two, so that the barrier's release waits
//      for no global store.
//   Launch 2, fit_kernel: a grid of (slots / kFitSlots, B) small blocks,
//   launched as a programmatic dependent of the sort (its blocks start as the
//   sort's blocks run and load their raw numbers, then wait for the sort
//   with griddepcontrol.wait).
//   5. A block takes kFitSlots consecutive slots (one plane's, so its point
//      loads stay near one another), kSlots a thread, consecutive threads on
//      consecutive slots (the raw numbers read and the 16-byte hypotheses
//      written coalesced). Padding slots (k >= K) and, with raw numbers,
//      every slot of a plane with no cell (three equal ranks: one pixel
//      thrice, no plane) are the padding and load nothing, so their blocks
//      end early and the card's scheduler fills their SMs with others. A
//      point is a float2 and a float (8-byte aligned either way round), not
//      three scalar loads: an SM's scattered loads cost it about a cycle a
//      lane each (the profile's point phase follows their count). The three
//      rounds of dependent loads (the plane's bounds, the order, the points)
//      are each issued together, and the quotients take a double reciprocal
//      and one correction, not an integer division.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;               // the sort's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kFitThreads = 256;            // the fits' blocks
// Hypothesis slots a fit thread has in flight at once (their loads overlap),
// and the slots a fit block takes.
constexpr int kSlots = 2;
constexpr int kFitSlots = kFitThreads * kSlots;
// Steps of 32 cells whose ids a lane keeps between the two passes.
constexpr int kCacheSteps = 4;
constexpr int kMaxCluster = 16;
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
  int B;                   // frames
  int G, gw, P, W, M, K, n_hyp, Kc;
  int C;                   // sort blocks a frame (the cluster)
  int span;                // cells a sort block owns
  double inv_PP, inv_P, inv_gw;   // 1/(P*P), 1/P, 1/gw rounded to doubles
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

// The ints of a sort block's tables: the LUT, each warp's counts by id,
// every block's totals by id (C x (M+1), pushed by the cluster), its offsets
// (the totals of the blocks before it), each id's count in the frame, and
// each id's first position (M+2).
__host__ __device__ inline size_t table_ints(int M, int C) {
  return (size_t)(kWarps + C + 3) * (M + 1) + (M + 2);
}

// The sort block's dynamic shared memory: its tables.
// kernels/sampling.py:shared_bytes computes the same.
__host__ __device__ inline size_t shared_bytes(int M, int C) {
  return (4 * table_ints(M, C) + 15) / 16 * 16;
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

// floor(a / c) for 0 <= a < 2^32 and 1 <= c < 2^32 from inv, 1/c rounded to
// a double: a * inv is within 2^-19 of a / c, so the truncated product is the
// quotient or one off it, and one step fixes that. (No integer division: an
// SM issues the fits' few dozen of them a slot slowly.)
__device__ __forceinline__ long long quot_small(long long a, long long c, double inv) {
  const long long q = (long long)((double)a * inv);
  const long long r = a - q * c;
  return r < 0 ? q - 1 : r >= c ? q + 1 : q;
}

// DPLX_PROFILE builds: thread 0's clock64 cycles by phase in each block
// (kPhases): the sort's blocks first (the LUT and id load, pass one, the
// scans with the cluster barrier and the exchange, pass two, the writer's
// stores, the last cluster wait), then the fits' blocks (the raw loads, the
// wait for the sort, the point loads, the fits, the stores), kept in a
// device buffer that dplx_ransac_sample_profile copies out; and each block's
// global-timer nanoseconds at its start and its end (slots 10 and 11).
constexpr int kPhases = 12;
constexpr int kProfileBlocks = 8192;
#ifdef DPLX_PROFILE
__device__ long long g_profile[kProfileBlocks * kPhases];
__device__ int g_profile_blocks;
#define SP_ADD(slot)                                                     \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      prof[slot] += now - mark;                                          \
      mark = now;                                                        \
    }                                                                    \
  } while (0)
// Wait for a loaded value before the next mark: a volatile shared store of
// it (clock64 is not moved across memory operations).
#define SP_USE(v)                                                        \
  do {                                                                   \
    if (threadIdx.x == 0) sp_sink = __float_as_int(v);                   \
  } while (0)
#define SP_USE64(v)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0) sp_sink = (int)((v) ^ ((v) >> 32));            \
  } while (0)
#else
#define SP_ADD(slot) do {} while (0)
#define SP_USE(v) do {} while (0)
#define SP_USE64(v) do {} while (0)
#endif

// Pass one's step of 32 cells of a warp: the lanes' ids (-1 past the
// sub-span), the groups of equal ids, and the group's leader adding its
// size to the warp's count.
__device__ __forceinline__ void count_step(int* mine, int id, int lane) {
  const unsigned peers = __match_any_sync(kFullMask, id);
  if (id >= 0 && lane == __ffs(peers) - 1) mine[id] += __popc(peers);
  __syncwarp();
}

// The cluster barrier in two halves: arrive (release: this thread's writes,
// shared and global, are visible to the cluster after the wait) and wait
// (acquire); work between them overlaps the other blocks' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Point e of the whole (B*N, 3) array in two loads and no branch: e*12 is
// 8-byte aligned for an even e, so (x, y) is a float2 and z a float; for an
// odd e, x is a float and (y, z) a float2. Zeros, and no load, unless `use`.
// (A float4 where the point lies in one aligned 16 bytes, a float2 and a
// float elsewhere, is fewer loads but diverges, and was slower.)
__device__ __forceinline__ void load_point(const float* all, long long e, bool use, float& x,
                                           float& y, float& z) {
  const float* p = all + e * 3;
  const bool even = (e & 1) == 0;
  const float2 v = use ? *reinterpret_cast<const float2*>(p + (even ? 0 : 1))
                       : make_float2(0.f, 0.f);
  const float w = use ? p[even ? 2 : 0] : 0.f;
  x = even ? v.x : w;
  y = even ? v.y : v.x;
  z = even ? w : v.y;
}

__global__ void __launch_bounds__(kThreads) sort_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  // The fits' blocks may start now: they load their raw numbers, then wait
  // for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // Every block of the cluster has started before any stores into another's
  // shared memory (the wait is before the push).
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int M = a.M, G = a.G, PP = a.P * a.P;
  int* lut = smem;                            // M+1
  int* hist = lut + (M + 1);                  // kWarps x (M+1)
  int* all = hist + kWarps * (M + 1);         // C x (M+1), written by the cluster
  int* pre = all + C * (M + 1);               // M+1
  int* count = pre + (M + 1);                 // M+1
  int* start = count + (M + 1);               // M+2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
#ifdef DPLX_PROFILE
  __shared__ volatile int sp_sink;
  long long prof[kPhases] = {};
  long long mark = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prof[10]));
#endif

  // This block's span and its warp's sub-span.
  const int c_lo = (int)min((long long)G, (long long)rank * a.span);
  const int c_hi = min(G, c_lo + a.span);
  const int sub = ((c_hi - c_lo + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = min(c_hi, c_lo + warp * sub), hi = min(c_hi, lo + sub);
  const int* labels = a.labels_map + (long long)b * G;
  int* cells = a.cells + (long long)b * G;
  long long* order = a.order + (long long)b * G;
  int cache[kCacheSteps];
#pragma unroll
  for (int i = 0; i < kCacheSteps; ++i) {        // in flight with the LUT's loads
    const int c = lo + i * 32 + lane;
    cache[i] = c < hi ? labels[c] : 0;
  }
  for (int k = tid; k <= M; k += kThreads) {
    int v = k;
    if (a.merge != nullptr) v = k == 0 ? 0 : a.merge[(long long)b * M + k - 1] + 1;
    lut[k] = v < 0 || v > M ? 0 : v;
  }
  for (int i = tid; i < kWarps * (M + 1); i += kThreads) hist[i] = 0;
  __syncthreads();
  SP_USE((float)cache[0]);
  SP_ADD(0);

  // Pass one: each warp counts its sub-span's cells by id. (No global
  // store before the cluster barrier, whose release would wait for it.)
  int* mine = hist + warp * (M + 1);
  auto merged = [&](int k) { return k < 0 || k > M ? 0 : lut[k]; };
#pragma unroll
  for (int i = 0; i < kCacheSteps; ++i) {
    if (lo + i * 32 < hi) {                      // the same for the whole warp
      const int c = lo + i * 32 + lane;
      cache[i] = c < hi ? merged(cache[i]) : -1;
      count_step(mine, cache[i], lane);
    }
  }
  for (int c0 = lo + kCacheSteps * 32; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    count_step(mine, c < hi ? merged(labels[c]) : -1, lane);
  }
  __syncthreads();
  SP_ADD(1);

  // Exclusive scan over the warps for each id, a half-warp an id (lane w
  // holds warp w's count): the warps' first positions in the block; the
  // block's totals are pushed into every block's table `all` (distributed
  // shared memory stores), so that after the barrier each block reads them
  // in its own shared memory and no block reads another's.
  cluster_wait();
  for (int id0 = 2 * warp; id0 <= M; id0 += 2 * kWarps) {
    const int id = id0 + (lane >> 4), w = lane & 15;
    const int v = id <= M ? hist[w * (M + 1) + id] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int n = __shfl_up_sync(kFullMask, incl, off, 16);
      if (w >= off) incl += n;
    }
    if (id <= M) {
      hist[w * (M + 1) + id] = incl - v;
      if (w == 15)
        for (int j = 0; j < C; ++j) cluster.map_shared_rank(all, j)[rank * (M + 1) + id] = incl;
    }
  }
  SP_ADD(5);                      // sort blocks: the scan over the warps and the push
  cluster_arrive();
  cluster_wait();
  SP_ADD(6);                      // sort blocks: the cluster barrier
  // Each id's count in the frame and the counts of the blocks before this
  // one (pre), from the pushed totals.
  for (int id = tid; id <= M; id += kThreads) {
    int total = 0, before = 0;
    for (int j = 0; j < C; ++j) {
      const int v = all[j * (M + 1) + id];
      before += j < rank ? v : 0;
      total += v;
    }
    count[id] = total;
    pre[id] = before;
  }
  __syncthreads();
  SP_ADD(7);                      // sort blocks: the exchange
  // Each warp scans the ids itself (32 a step; exclusive: the ids' first
  // positions) and moves its own row of counts to its first positions;
  // warp 0 writes the first positions back (start[M+1] = G).
  {
    int carry = 0;
    for (int base = 0; base <= M; base += 32) {
      const int i = base + lane;
      const int v = i <= M ? count[i] : 0;
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += n;
      }
      if (i <= M) mine[i] += carry + incl - v + pre[i];
      if (warp == 0 && i <= M) start[i] = carry + incl - v;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (warp == 0 && lane == 0) start[M + 1] = carry;
  }
  SP_ADD(2);

  // Pass two: the merged labels, and each cell at its warp's running
  // position for its id plus its rank among the equal ids before it in the
  // step.
  auto place = [&](int c, int id) {
    const unsigned peers = __match_any_sync(kFullMask, id);
    if (id >= 0) {
      cells[c] = id;
      order[mine[id] + __popc(peers & lanes_below)] = c;
    }
    __syncwarp();
    if (id >= 0 && lane == __ffs(peers) - 1) mine[id] += __popc(peers);
    __syncwarp();
  };
#pragma unroll
  for (int i = 0; i < kCacheSteps; ++i)
    if (lo + i * 32 < hi) place(lo + i * 32 + lane, cache[i]);
  for (int c0 = lo + kCacheSteps * 32; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    place(c, c < hi ? merged(labels[c]) : -1);
  }
  SP_ADD(3);

  // The bounds and the state, spread over the cluster's threads.
  __syncthreads();                // warp 0's first positions
  const int gt = rank * kThreads + tid, gstride = C * kThreads;
  for (int m = gt; m <= M + 1; m += gstride) a.bounds[(long long)b * (M + 2) + m] = start[m];
  for (int p = gt; p < M; p += gstride) {
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
  const long long zeros = (long long)M * a.Kc;
  for (long long i = gt; i < zeros; i += gstride) a.step_counts[(long long)b * zeros + i] = 0;
  if (gt == 0) {
    a.done[b] = 0;
    a.scored[b] = 0;
    a.tickets[b] = 0;
  }
  SP_ADD(4);
#ifdef DPLX_PROFILE
  if (tid == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prof[11]));
  if (tid == 0 && blockIdx.x < kProfileBlocks) {
    for (int i = 0; i < kPhases; ++i) g_profile[blockIdx.x * kPhases + i] = prof[i];
  }
#endif
}

__global__ void __launch_bounds__(kFitThreads) fit_kernel(Args a) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int M = a.M, G = a.G, PP = a.P * a.P;
#ifdef DPLX_PROFILE
  __shared__ volatile int sp_sink;
  long long prof[kPhases] = {};
  long long mark = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prof[10]));
#endif
  // This block's slots: kFitSlots from h0, slot h0 + tid + s * kFitThreads
  // for thread tid.
  const long long total = (long long)M * a.n_hyp;
  const long long h0 = (long long)blockIdx.x * kFitSlots;
  const long long* draws = a.draws + (a.batched ? (long long)b * M * a.K * 3 : 0);
  long long u[kSlots][3];
  int plane[kSlots];
  bool real[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const long long hs = h0 + tid + s * kFitThreads;
    const int p = (int)min(hs / a.n_hyp, (long long)max(M - 1, 0));
    const int k = (int)(hs - (long long)p * a.n_hyp);
    plane[s] = p;
    real[s] = hs < total && k < a.K;
    const long long* r = draws + ((long long)p * a.K + (real[s] ? k : 0)) * 3;
    u[s][0] = real[s] ? r[0] : 0;
    u[s][1] = real[s] ? r[1] : 0;
    u[s][2] = real[s] ? r[2] : 0;
  }
#ifdef DPLX_PROFILE
#pragma unroll
  for (int s = 0; s < kSlots; ++s) SP_USE64(u[s][0] ^ u[s][1] ^ u[s][2]);
#endif
  SP_ADD(5);
  // The sort's grid has ended and its writes are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  SP_ADD(9);

  const long long* bounds = a.bounds + (long long)b * (M + 2);
  const long long* order = a.order + (long long)b * G;
  const long long frame_point = (long long)b * a.N;
  // Three rounds of loads, each in flight together, no branch between them:
  // the planes' bounds; the 3 * kSlots cells of the order; their points (a
  // slot that needs none loads none: predicated).
  long long first[kSlots], cells_p[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    first[s] = M > 0 ? bounds[plane[s] + 1] : 0;
    cells_p[s] = M > 0 ? bounds[plane[s] + 2] - first[s] : 0;
  }
  bool need[kSlots];
  int cell[kSlots][3], t[kSlots][3];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    need[s] = real[s] && (!a.raw || cells_p[s] > 0);
#pragma unroll
    for (int j = 0; j < 3; ++j) cell[s][j] = t[s][j] = 0;
    if (!need[s]) continue;
    const long long c = max(cells_p[s] * PP, 1ll);
    const double inv_c = __drcp_rn((double)c);
    auto mod_c = [&](long long x) {
      return small(x) && small(c) ? x - quot_small(x, c, inv_c) * c : floor_mod(x, c);
    };
    long long u0 = u[s][0], u1 = u[s][1], u2 = u[s][2];
    if (a.raw) {
      u0 = mod_c(u0);
      u1 = mod_c(u1);
      u2 = mod_c(u2);
    }
    // _distinct: the shift of the reference package, on the raw ranks.
    const long long v1 = wrap_add(u1, u1 == u0);
    const long long v2 = wrap_add(wrap_add(u2, u2 == u0), u2 == v1);
    const long long idx[3] = {u0, mod_c(v1), mod_c(v2)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const long long crank =
          small(idx[j]) ? quot_small(idx[j], PP, a.inv_PP) : floor_div(idx[j], PP);
      // idx - crank * PP in [0, PP): exact modulo 2^64.
      t[s][j] = (int)((unsigned long long)idx[j] -
                      (unsigned long long)crank * (unsigned long long)PP);
      long long pos = wrap_add(first[s], crank);
      pos = pos < 0 ? 0 : pos > G - 1 ? G - 1 : pos;
      cell[s][j] = (int)order[pos];
    }
  }
  float q[kSlots][3][3];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int row = (int)quot_small(cell[s][j], a.gw, a.inv_gw);
      const int col = cell[s][j] - row * a.gw;
      const int tr = (int)quot_small(t[s][j], a.P, a.inv_P), tc = t[s][j] - tr * a.P;
      const long long e = frame_point + (long long)(row * a.P + tr) * a.W + (col * a.P + tc);
      load_point(a.points, e, need[s], q[s][j][0], q[s][j][1], q[s][j][2]);
    }
#ifdef DPLX_PROFILE
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int j = 0; j < 3; ++j) SP_USE(q[s][j][0] + q[s][j][1] + q[s][j][2]);
#endif
  SP_ADD(6);
  float4 res[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float4 out = make_float4(0.f, 0.f, 0.f, 1e30f);
    if (need[s]) {
      // _fit_3pt_plane, operation by operation. The norm: sqrt in double
      // rounded to float is the correctly rounded float sqrt (53 >= 2*24 + 2
      // bits), which __fsqrt_rn gives.
      const float a0 = q[s][1][0] - q[s][0][0], a1 = q[s][1][1] - q[s][0][1];
      const float a2 = q[s][1][2] - q[s][0][2];
      const float b0 = q[s][2][0] - q[s][0][0], b1 = q[s][2][1] - q[s][0][1];
      const float b2 = q[s][2][2] - q[s][0][2];
      const float n0 = a1 * b2 - a2 * b1;
      const float n1 = a2 * b0 - a0 * b2;
      const float n2 = a0 * b1 - a1 * b0;
      const float nrm = __fsqrt_rn(n0 * n0 + n1 * n1 + n2 * n2);
      const float m0 = n0 / nrm, m1 = n1 / nrm, m2 = n2 / nrm;
      const float d = -(m0 * q[s][0][0] + m1 * q[s][0][1] + m2 * q[s][0][2]);
      if (isfinite(d) && isfinite(m0) && isfinite(m1) && isfinite(m2))
        out = make_float4(m0, m1, m2, d);
    }
    res[s] = out;
  }
#ifdef DPLX_PROFILE
#pragma unroll
  for (int s = 0; s < kSlots; ++s) SP_USE(res[s].x + res[s].w);
#endif
  SP_ADD(7);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const long long hs = h0 + tid + s * kFitThreads;
    if (hs < total) a.hyp[(long long)b * total + hs] = res[s];
  }
  SP_ADD(8);
#ifdef DPLX_PROFILE
  const long long blk = (long long)a.B * a.C + (long long)b * gridDim.x + blockIdx.x;
  if (tid == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prof[11]));
  if (tid == 0 && blk < kProfileBlocks)
    for (int i = 0; i < kPhases; ++i) g_profile[blk * kPhases + i] = prof[i];
  if (tid == 0 && blockIdx.x == 0 && b == 0)
    g_profile_blocks = (int)min((long long)kProfileBlocks,
                                (long long)a.B * a.C + (long long)gridDim.x * gridDim.y);
#endif
}

// The sort's launch configuration, C blocks a frame; sets the kernel's
// shared memory and cluster attributes first.
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int frames, int C,
                      size_t smem) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(sort_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)frames * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

bool cluster_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a sort block takes for M planes and C
// blocks a frame (any number of cells).
long long dplx_ransac_sample_shared_bytes(int M, int C) {
  return M < 0 || !cluster_ok(C) ? -1 : (long long)shared_bytes(M, C);
}

// Hypothesis slots a fit block takes (kFitSlots).
int dplx_ransac_sample_fit_slots() { return kFitSlots; }

// Clusters of C sort blocks (1, 2, 4, 8 or 16) the card runs at once
// (cudaOccupancyMaxActiveClusters) at M planes, 0 where the tables of C
// blocks' totals do not fit; a negative CUDA error code where it cannot say.
int dplx_ransac_sample_max_clusters(int M, int C) {
  if (M < 0 || !cluster_ok(C)) return -(int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(M, C);
  if (smem > (size_t)kMaxSharedBytes) return 0;           // its tables do not fit
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(cfg, attr, 1, C, smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, sort_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Fit blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a negative CUDA error code where it cannot say.
int dplx_ransac_sample_fit_blocks_per_sm() {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fit_kernel, kFitThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

// labels_map (B, gh, gw) int32; merge_labels (B, M) int32 or null (the
// labels are merged already); points (B, H*W, 3) float32, 8-byte
// aligned; draws int64: raw numbers (raw = 1) of shape (M, K, 3), or ranks
// of shape (M, K, 3) or, with batched = 1, (B, M, K, 3); C sort blocks a
// frame (a thread-block cluster: 1, 2, 4, 8 or 16). Outputs, all
// contiguous on the card: cells (B, gh, gw) int32, order (B, gh*gw) int64,
// bounds (B, M+2) int64, counts (B, M) int64, hyp (B, M, n_hyp, 4) float32
// (16-byte aligned, n_hyp = S*Kc >= K), and the ChunkState: n_pts, target,
// run_best, best_loss (B, M) float32, reached (B, M) bool, best_k (B, M)
// int64, done (B,) bool, scored (B,) int32, step_counts (B, M, Kc) int32,
// tickets (B,) int32. Two launches on `stream`: the sort, then the fits as
// its programmatic dependent. A cluster the card cannot place returns its
// error; nothing falls back to fewer blocks.
int dplx_ransac_sample(const void* labels_map, const void* merge_labels, const void* points,
                       const void* draws, int raw, int batched, int B, int H, int W, int gh,
                       int gw, int P, int M, int K, int n_hyp, int Kc, int C, float ratio,
                       void* cells, void* order, void* bounds, void* counts, void* hyp,
                       void* n_pts, void* target, void* reached, void* run_best,
                       void* best_loss, void* best_k, void* done, void* scored,
                       void* step_counts, void* tickets, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const long long G = (long long)gh * gw;
  if (P <= 0 || M < 0 || K < 0 || n_hyp < K || Kc < 0 || G <= 0 || G > (1 << 30) ||
      (long long)gh * P > H || (long long)gw * P > W || (long long)H * W >= (1ll << 31) ||
      (long long)M * n_hyp > (1 << 30) || !cluster_ok(C) || (long long)B * C > 0x7fffffffLL ||
      B > 65535 || reinterpret_cast<uintptr_t>(points) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(M, C);
  if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const int span = (int)(((G + C - 1) / C + 31) / 32 * 32);
  const Args args{static_cast<const int*>(labels_map), static_cast<const int*>(merge_labels),
                  static_cast<const float*>(points), static_cast<const long long*>(draws), raw,
                  batched, (long long)H * W, B, (int)G, gw, P, W, M, K, n_hyp, Kc, C, span,
                  1.0 / ((double)P * P), 1.0 / P, 1.0 / gw, ratio, static_cast<int*>(cells),
                  static_cast<long long*>(order), static_cast<long long*>(bounds),
                  static_cast<long long*>(counts), static_cast<float4*>(hyp),
                  static_cast<float*>(n_pts),
                  static_cast<float*>(target), static_cast<uint8_t*>(reached),
                  static_cast<float*>(run_best), static_cast<float*>(best_loss),
                  static_cast<long long*>(best_k), static_cast<uint8_t*>(done),
                  static_cast<int*>(scored), static_cast<int*>(step_counts),
                  static_cast<int*>(tickets)};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(cfg, attr, B, C, smem);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, sort_kernel, args);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * n_hyp;
  if (total == 0) return (int)cudaGetLastError();
  cudaLaunchConfig_t fit = {};
  fit.gridDim = dim3((unsigned)((total + kFitSlots - 1) / kFitSlots), (unsigned)B);
  fit.blockDim = dim3(kFitThreads);
  fit.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  fit.attrs = dep;
  fit.numAttrs = 1;
  err = cudaLaunchKernelEx(&fit, fit_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// DPLX_PROFILE builds: copies the last call's cycles by phase, kPhases a
// block for up to max_blocks blocks (the sort's B*C blocks, then the fits'
// blocks, frame by frame), to host memory `dst`; returns the blocks copied
// (0 in other builds), or a negative CUDA error code.
int dplx_ransac_sample_profile(void* dst, int max_blocks) {
#ifdef DPLX_PROFILE
  cudaError_t err = cudaDeviceSynchronize();
  int n = 0;
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&n, g_profile_blocks, sizeof(int));
  n = min(n, max_blocks);
  if (err == cudaSuccess && n > 0)
    err = cudaMemcpyFromSymbol(dst, g_profile, (size_t)n * kPhases * sizeof(long long));
  return err == cudaSuccess ? n : -(int)err;
#else
  (void)dst;
  (void)max_blocks;
  return 0;
#endif
}

}  // extern "C"
