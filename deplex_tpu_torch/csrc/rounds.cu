// Stage-3 epilogue kernel: every growing round's sums, its plane fit, the
// size and planarity gates, the plane slots in accept order, the cell labels
// and the slot tables.
//
// Replaces the XLA fusions of deplex_tpu/ops/growing.py:region_sums and
// :finalize_rounds (no pallas_call there; the Pallas path calls them after
// its kernel, deplex_tpu/ops/pallas_growing.py:452-453). Its plain twin is
// ops/growing.py:region_sums, then ops/growing.py:finalize_rounds.
//
// The sums' order is fixed, and the twin keeps the same one: per round, the
// frame's cells are summed in raster order as a pairwise tree over aligned
// power-of-two blocks (the root spans 2^ceil(log2 N) cells), non-members
// counting as +0.0. A member's term is w * x + 0.0 (w = 2 for the round's
// seed, 1 otherwise; the + 0.0 turns a -0.0 into +0.0), so no partial sum
// is ever -0.0 and a node with one empty child is its other child's sum
// exactly: the kernel skips empty subtrees and still gives the twin's bits,
// however it cuts the frame into aligned power-of-two spans. No float atomic
// is used (the repo's numerics rule); the planarity gate reads these sums.
//
// How: a thread-block cluster of C blocks a frame (C = 1, 2, 4 or 8, chosen
// by the wrapper from the batch and the card's occupancy); block j owns the
// aligned span of S = 2^k >= 32 cells starting at j * S (spans past the
// frame are empty), and every block takes every C-th round for the fits.
//   1. Levels 0-4 in registers: a warp takes 32 cells, stages their inputs
//      through shared memory (coalesced loads), and each lane adds the value
//      of a lane of its round in the sibling half (__match_any_sync,
//      __shfl_sync), five times; the round's first lane in the warp then
//      holds the warp's sum (a head).
//   2. Levels 5 to k-1 in the block, on the heads only: the heads are
//      compacted in raster order, one warp links each to the next head of
//      its round (walking them backwards 32 at a time), and at each level a
//      head whose node is a left child adds the next head of its round if
//      that head's node is the right sibling. A round's first head ends
//      with the span's sum.
//   3. The top log2(C) levels across the cluster: after cluster.sync() every
//      block reads the C spans' sums of every round through distributed
//      shared memory and combines them pairwise (redundantly: the means are
//      needed by every block), so the second moments about the round mean
//      run through 1-3 with one barrier on each side of that read.
//   4. The fits (dplx::eigh3x3_min, as K3's refits) only for rounds that a
//      gate can accept (r < nr_rounds, size >= min_cells), each by its owner
//      block, so that the cluster's SMs share them; the owner pushes the
//      accept flag to every block; after the third cluster barrier each
//      block assigns the slots by ballot (one warp) and writes its span's
//      labels and its rounds' sums rows and slots.
// A block's per-round tables and span arrays live in shared memory where
// they fit (TUM's 48 x 64 cells at 256 rounds at every C; ICL's 120 x 160 at
// C = 8); else the span arrays, and past about 1,330 rounds the tables too,
// in a global workspace the caller allocates
// (dplx_round_finalize_scratch_bytes). Any number of rounds is taken, 0
// included.
//
// What bounds it on the H100: latency. Its bytes (64 a cell in, 4 out, and
// 64 a round) take ~4 us at TUM B=64; the time is the dependent chain of two
// warp passes, ~2 x 6 block levels, three cluster barriers and the fits'
// eigensolve, on B x C blocks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// Inputs a warp stages for 32 cells: coord_sum or mean (96 floats), then
// scatter (288).
constexpr int kStage = 32 * 9;
constexpr int kStaticSmem = kWarps * kStage * 4 + 8;            // stage, s_heads, s_taken
constexpr int kSmemLimit = 227 * 1024 - kStaticSmem;              // dynamic part

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The cells a block owns: the least power of two >= 32 with C spans
// covering the frame's N cells.
__host__ __device__ inline int span_cells(int N, int C) {
  const int per = (N + C - 1) / C;
  int S = 32;
  while (S < per) S <<= 1;
  return S;
}

// A block's arrays. Per round: seed, local count, first head in the span,
// cluster count, accept flag, label (ints); the span's records that the
// other blocks read (float4s: the count's bits and the three coordinate
// sums; the six moment sums, the count's bits and 0), n_tot and the three
// coordinate sums, the round mean, the fit (normal, mean, d, mse, score)
// and the round's six moment sums (floats).
// Per span cell: round, link, working link, head list, head flag, the six
// float lanes (structure of arrays); per warp of 32 cells its head mask and
// first head.
struct Layout {
  size_t seed, lc, fh, cnt, acc, lut, rec3, rec6, rs, mu, fit, sct, tables_end;
  size_t rm, nx0, nx, hl, v, chm, off, live, cells;
  __host__ __device__ Layout(int S, int R) {
    const size_t r4 = align16((size_t)R * 4);
    seed = 0;
    lc = seed + r4;
    fh = lc + r4;
    cnt = fh + r4;
    acc = cnt + r4;
    lut = acc + r4;
    rec3 = lut + r4;
    rec6 = rec3 + 4 * r4;
    rs = rec6 + 8 * r4;
    mu = rs + 4 * r4;
    fit = mu + 3 * r4;
    sct = fit + 9 * r4;
    tables_end = sct + 6 * r4;
    const size_t s4 = align16((size_t)S * 4), w4 = align16((size_t)(S / 32 + 1) * 4);
    rm = 0;
    nx0 = rm + s4;
    nx = nx0 + s4;
    hl = nx + s4;
    v = hl + s4;
    chm = v + 6 * s4;
    off = chm + w4;
    live = off + w4;
    cells = live + align16((size_t)S);
  }
  __host__ __device__ bool tables_fit() const { return tables_end <= (size_t)kSmemLimit; }
  __host__ __device__ bool cells_fit() const {
    return tables_end + cells <= (size_t)kSmemLimit;
  }
  // Dynamic shared memory of a block, and global workspace of a block.
  __host__ __device__ size_t smem_bytes() const {
    return cells_fit() ? tables_end + cells : tables_fit() ? tables_end : 0;
  }
  __host__ __device__ size_t scratch_bytes() const {
    return cells_fit() ? 0 : tables_fit() ? cells : tables_end + cells;
  }
};

// DPLX_PROFILE builds: each block's clock64 cycles by phase, written after
// the workspace (dplx_round_finalize_scratch_bytes counts them): counts (the
// round ids, counts and the coordinate pass's warp levels), links (the head
// list and its links), coord_tree (the coordinate pass's block levels),
// means (the first cluster barrier and the
// cluster's combine), moment_tree (the moment pass), fits (the second and
// third cluster barriers around the fits), slots, labels_tables.
constexpr int kProfileSlots = 8;
#ifdef DPLX_PROFILE
constexpr bool kProfile = true;
#define RF_MARK(slot)                                                    \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      prof[slot] = now - mark;                                           \
      mark = now;                                                        \
    }                                                                    \
  } while (0)
#else
constexpr bool kProfile = false;
#define RF_MARK(slot) do {} while (0)
#endif

struct Args {
  const int* round_map;     // (B, N)
  const int* seeds;         // (B, R)
  const int* nr_rounds;     // (B,)
  const float* nr_pts;      // ()
  const float* coord_sum;   // (B, N, 3)
  const float* mean;        // (B, N, 3)
  const float* scatter;     // (B, N, 3, 3)
  int N, R, maxp, C, S, span_levels;
  float min_cells, min_score;
  float* sums;              // (B, R, 16)
  int* labels_map;          // (B, N)
  int* nr_planes;           // (B,)
  float *seg_n, *seg_cs, *seg_sc, *seg_normal, *seg_mean, *seg_d, *seg_mse, *seg_score;
  unsigned char* scratch;   // B x C blocks' arrays that do not fit in shared memory
  long long* profile;       // (B x C, kProfileSlots), DPLX_PROFILE builds
};

// The lanes of the other half of this lane's node at warp level l.
__device__ __forceinline__ unsigned sibling_lanes(int lane, int l) {
  return ((1u << (1 << l)) - 1u) << (((lane >> l) ^ 1) << l);
}

// Warp levels 0-4 of K float lanes: afterwards every member lane holds the
// sum of its round over the warp's 32 cells (`same`: the lanes of its round).
template <int K>
__device__ __forceinline__ void warp_levels(float (&x)[K], unsigned same, int lane) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const unsigned cand = same & sibling_lanes(lane, l);
    const int src = cand ? __ffs(cand) - 1 : lane;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float o = __shfl_sync(dplx::kFullMask, x[c], src);
      if (cand) x[c] = __fadd_rn(x[c], o);
    }
  }
}

// Block levels 5 .. span_levels-1 of K lanes over the span's H heads (hl):
// a left child's head adds the next head of its round if that head's node
// is the right sibling, and takes over its link.
template <int K>
__device__ void block_levels(int S, int span_levels, int H, const int* hl, float* v, int* nx,
                             uint8_t* live) {
  for (int lv = 5; lv < span_levels; ++lv) {
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const int p = hl[i];
      if (!live[p] || ((p >> lv) & 1)) continue;
      const int q = nx[p];
      if (q < 0 || (q >> lv) != (p >> lv) + 1) continue;
#pragma unroll
      for (int c = 0; c < K; ++c) v[c * S + p] = __fadd_rn(v[c * S + p], v[c * S + q]);
      nx[p] = nx[q];
      live[q] = 0;
    }
    __syncthreads();
  }
}

// The top levels: the pairwise tree over the cluster's C span sums of a
// round (x[j], present where has bit j), empty spans skipped.
template <int K>
__device__ __forceinline__ void cluster_levels(float (&x)[kMaxCluster][K], unsigned has, int C) {
#pragma unroll
  for (int step = 1; step < kMaxCluster; step <<= 1) {
#pragma unroll
    for (int j = 0; j + step < kMaxCluster; j += 2 * step) {
      if (step >= C || !((has >> (j + step)) & 1)) continue;
#pragma unroll
      for (int c = 0; c < K; ++c)
        x[j][c] = ((has >> j) & 1) ? __fadd_rn(x[j][c], x[j + step][c]) : x[j + step][c];
      has |= 1u << j;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) round_finalize_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float stage[kWarps][kStage];
  __shared__ int s_heads, s_taken;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, S = a.S, N = a.N, R = a.R;
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const Layout L(S, R);
  const bool tables_shared = L.tables_fit();
  unsigned char* work =
      a.scratch ? a.scratch + ((size_t)b * C + rank) * L.scratch_bytes() : nullptr;
  unsigned char* tables = tables_shared ? smem : work;
  unsigned char* cells = L.cells_fit() ? smem + L.tables_end
                         : tables_shared ? work : work + L.tables_end;
  // Block j's tables: distributed shared memory, or its workspace.
  auto tables_of = [&](int j) -> unsigned char* {
    return tables_shared ? cluster.map_shared_rank(static_cast<unsigned char*>(smem), j)
                         : a.scratch + ((size_t)b * C + j) * L.scratch_bytes();
  };
  int* seed = reinterpret_cast<int*>(tables + L.seed);
  int* lc = reinterpret_cast<int*>(tables + L.lc);
  int* fh = reinterpret_cast<int*>(tables + L.fh);
  int* cnt = reinterpret_cast<int*>(tables + L.cnt);
  int* acc = reinterpret_cast<int*>(tables + L.acc);
  int* lut = reinterpret_cast<int*>(tables + L.lut);
  float4* rec3 = reinterpret_cast<float4*>(tables + L.rec3);
  float4* rec6 = reinterpret_cast<float4*>(tables + L.rec6);
  float* rs = reinterpret_cast<float*>(tables + L.rs);
  float* mu = reinterpret_cast<float*>(tables + L.mu);
  float* fit = reinterpret_cast<float*>(tables + L.fit);
  float* sct = reinterpret_cast<float*>(tables + L.sct);
  int* rm = reinterpret_cast<int*>(cells + L.rm);
  int* nx0 = reinterpret_cast<int*>(cells + L.nx0);
  int* nx = reinterpret_cast<int*>(cells + L.nx);
  int* hl = reinterpret_cast<int*>(cells + L.hl);
  float* v = reinterpret_cast<float*>(cells + L.v);
  unsigned* chm = reinterpret_cast<unsigned*>(cells + L.chm);
  int* off = reinterpret_cast<int*>(cells + L.off);
  uint8_t* live = reinterpret_cast<uint8_t*>(cells + L.live);
  float* st = stage[warp];
  const float nr_pts = *a.nr_pts;
  const int nr = a.nr_rounds[b];
  const size_t cell0 = (size_t)b * N;
  const int p0 = rank * S;                              // the span's first cell
  const int ns = max(0, min(S, N - p0));                // its cells in the frame
  const int nchunks = (ns + 31) >> 5;
#ifdef DPLX_PROFILE
  long long* prof = a.profile + (size_t)blockIdx.x * kProfileSlots;
  long long mark = clock64();
#endif

  for (int r = tid; r < R; r += kThreads) {
    seed[r] = a.seeds[(size_t)b * R + r];
    lc[r] = 0;
    fh[r] = -1;
  }
  __syncthreads();

  // 1. Round ids, counts, the coordinate terms and their warp levels. A
  // warp's next 32 cells are loaded (coalesced) while it works on these.
  const int* rm_in = a.round_map + cell0 + p0;
  const float* cs_in = a.coord_sum + (cell0 + p0) * 3;
  int rid = -1;
  float pre[3];
  auto load1 = [&](int k) {
    if (k >= nchunks) return;
    const int n = 3 * min(32, ns - k * 32);
    rid = k * 32 + lane < ns ? rm_in[k * 32 + lane] : -1;
#pragma unroll
    for (int j = 0; j < 3; ++j) pre[j] = lane + 32 * j < n ? cs_in[k * 96 + lane + 32 * j] : 0.f;
  };
  load1(warp);
  for (int k = warp; k < nchunks; k += kWarps) {
    const int p = k * 32 + lane;
    const int r = rid < 0 || rid >= R ? -1 : rid;
#pragma unroll
    for (int j = 0; j < 3; ++j) st[lane + 32 * j] = pre[j];
    load1(k + kWarps);
    rm[p] = r;
    const unsigned same = __match_any_sync(dplx::kFullMask, r);
    const bool head = r >= 0 && (same & lanes_below) == 0;
    const unsigned heads = __ballot_sync(dplx::kFullMask, head);
    if (head) atomicAdd(&lc[r], __popc(same));     // integer counts: any order gives them
    if (lane == 0) chm[k] = heads;
    __syncwarp();
    float x[3];
    const float w = r >= 0 && seed[r] == p0 + p ? 2.f : 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[c] = r >= 0 ? __fadd_rn(__fmul_rn(w, st[3 * lane + c]), 0.f) : 0.f;
    __syncwarp();
    warp_levels<3>(x, same, lane);
    if (head) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c * S + p] = x[c];
    }
  }
  __syncthreads();
  RF_MARK(0);

  // 2. The heads in raster order, and each head's link to the next head of
  // its round (one warp; a round's first head in the span goes to fh).
  if (warp == 0) {
    int total = 0;
    for (int k0 = 0; k0 < nchunks; k0 += 32) {
      const int k = k0 + lane;
      const int h = k < nchunks ? __popc(chm[k]) : 0;
      int incl = h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(dplx::kFullMask, incl, o);
        if (lane >= o) incl += t;
      }
      if (k < nchunks) off[k] = total + incl - h;
      total += __shfl_sync(dplx::kFullMask, incl, 31);
    }
    if (lane == 0) s_heads = total;
  }
  __syncthreads();
  const int H = s_heads;
  for (int k = warp; k < nchunks; k += kWarps) {
    const unsigned heads = chm[k];
    if ((heads >> lane) & 1) hl[off[k] + __popc(heads & lanes_below)] = k * 32 + lane;
  }
  __syncthreads();
  if (warp == 0) {
    for (int base = ((H - 1) >> 5) << 5; base >= 0; base -= 32) {
      const int i = base + lane;
      const int p = i < H ? hl[i] : -1;
      const int r = p >= 0 ? rm[p] : -1;
      const unsigned same = __match_any_sync(dplx::kFullMask, r);
      const unsigned later = same & ~(lanes_below | (1u << lane));
      int link = -1;
      if (r >= 0) link = later ? hl[base + __ffs(later) - 1] : fh[r];
      __syncwarp();
      if (r >= 0 && (same & lanes_below) == 0) fh[r] = p;
      __syncwarp();
      if (p >= 0) {
        nx0[p] = link;
        nx[p] = link;
        live[p] = 1;
      }
    }
  }
  __syncthreads();
  RF_MARK(1);

  // 3. The coordinate sums' block levels; the span's sums of each round.
  block_levels<3>(S, a.span_levels, H, hl, v, nx, live);
  for (int r = tid; r < R; r += kThreads) {
    const int f = fh[r];
    rec3[r] = f >= 0 ? make_float4(__int_as_float(lc[r]), v[f], v[S + f], v[2 * S + f])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  RF_MARK(2);
  if (!tables_shared) __threadfence();
  cluster.sync();

  // 4. The top levels of the coordinate sums, counts and means of every round
  // (each block, from every block's span sums).
  for (int r = tid; r < R; r += kThreads) {
    float4 q[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)       // every block's record in flight at once
      if (j < C) q[j] = reinterpret_cast<const float4*>(tables_of(j) + L.rec3)[r];
    float x[kMaxCluster][3];
    unsigned has = 0;
    int total = 0;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j >= C) continue;
      const int n = __float_as_int(q[j].x);
      total += n;
      has |= (n > 0 ? 1u : 0u) << j;
      x[j][0] = q[j].y;
      x[j][1] = q[j].z;
      x[j][2] = q[j].w;
    }
    cluster_levels<3>(x, has, C);
    const int s = seed[r];
    const int seedm = s >= 0 && s < N && a.round_map[cell0 + s] == r;
    const float n_tot = (float)(total + seedm) * nr_pts;
    const float nc = n_tot < 1.f ? 1.f : n_tot;
    cnt[r] = total;
    rs[4 * r] = n_tot;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sum = has ? x[0][c] : 0.f;
      rs[4 * r + 1 + c] = sum;
      mu[3 * r + c] = sum / nc;
    }
  }
  __syncthreads();
  RF_MARK(3);

  // 5. The second moments about the round mean, through the same levels;
  // the next 32 cells' mean and scatter in flight as before.
  const float* mean_in = a.mean + (cell0 + p0) * 3;
  const float* sc_in = a.scatter + (cell0 + p0) * 9;
  float pre2[12];
  auto load2 = [&](int k) {
    if (k >= nchunks) return;
    const int n = min(32, ns - k * 32);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      pre2[j] = lane + 32 * j < 3 * n ? mean_in[k * 96 + lane + 32 * j] : 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j)
      pre2[3 + j] = lane + 32 * j < 9 * n ? sc_in[k * 288 + lane + 32 * j] : 0.f;
  };
  load2(warp);
  for (int k = warp; k < nchunks; k += kWarps) {
    const int p = k * 32 + lane;
    const int r = rm[p];
#pragma unroll
    for (int j = 0; j < 3; ++j) st[lane + 32 * j] = pre2[j];
    const unsigned same = __match_any_sync(dplx::kFullMask, r);
    __syncwarp();
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (r >= 0) {
      d0 = st[3 * lane] - mu[3 * r];
      d1 = st[3 * lane + 1] - mu[3 * r + 1];
      d2 = st[3 * lane + 2] - mu[3 * r + 2];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 9; ++j) st[lane + 32 * j] = pre2[3 + j];
    load2(k + kWarps);
    __syncwarp();
    float x[6];
    if (r >= 0) {
      const float w = seed[r] == p0 + p ? 2.f : 1.f;
      const float* q = st + 9 * lane;
      const float feat[6] = {q[0] + nr_pts * d0 * d0, q[1] + nr_pts * d0 * d1,
                             q[2] + nr_pts * d0 * d2, q[4] + nr_pts * d1 * d1,
                             q[5] + nr_pts * d1 * d2, q[8] + nr_pts * d2 * d2};
#pragma unroll
      for (int c = 0; c < 6; ++c) x[c] = __fadd_rn(__fmul_rn(w, feat[c]), 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < 6; ++c) x[c] = 0.f;
    }
    __syncwarp();
    warp_levels<6>(x, same, lane);
    if (r >= 0 && (same & lanes_below) == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) v[c * S + p] = x[c];
    }
  }
  for (int i = tid; i < H; i += kThreads) {
    const int p = hl[i];
    nx[p] = nx0[p];
    live[p] = 1;
  }
  __syncthreads();
  block_levels<6>(S, a.span_levels, H, hl, v, nx, live);
  for (int r = tid; r < R; r += kThreads) {
    const int f = fh[r];
    rec6[2 * r] = f >= 0 ? make_float4(v[f], v[S + f], v[2 * S + f], v[3 * S + f])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    rec6[2 * r + 1] = f >= 0 ? make_float4(v[4 * S + f], v[5 * S + f], __int_as_float(lc[r]), 0.f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  RF_MARK(4);
  if (!tables_shared) __threadfence();
  cluster.sync();

  // 6. Each block's rounds (r = rank mod C): the moment sums' top levels, the
  // sums row, and the fit and gates (ops/growing.py:fit_plane,
  // finalize_rounds) where a gate can accept; the accept flag to every block.
  for (int r = rank + C * tid; r < R; r += C * kThreads) {
    float4 q[kMaxCluster][2];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {     // every block's record in flight at once
      if (j >= C) continue;
      const float4* t = reinterpret_cast<const float4*>(tables_of(j) + L.rec6) + 2 * r;
      q[j][0] = t[0];
      q[j][1] = t[1];
    }
    float x[kMaxCluster][6];
    unsigned has = 0;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j >= C) continue;
      has |= (__float_as_int(q[j][1].z) > 0 ? 1u : 0u) << j;
      x[j][0] = q[j][0].x;
      x[j][1] = q[j][0].y;
      x[j][2] = q[j][0].z;
      x[j][3] = q[j][0].w;
      x[j][4] = q[j][1].x;
      x[j][5] = q[j][1].y;
    }
    cluster_levels<6>(x, has, C);
    float sc[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) sc[c] = has ? x[0][c] : 0.f;
    const float n_tot = rs[4 * r];
    const float size = (float)cnt[r];
    float4* row = reinterpret_cast<float4*>(a.sums + ((size_t)b * R + r) * 16);
    row[0] = make_float4(n_tot, rs[4 * r + 1], rs[4 * r + 2], rs[4 * r + 3]);
    row[1] = make_float4(sc[0], sc[1], sc[2], sc[3]);
    row[2] = make_float4(sc[4], sc[5], size, 0.f);
    row[3] = make_float4(0.f, 0.f, 0.f, 0.f);

    int ok = 0;
    if (r < nr && size >= a.min_cells) {
      const float n = n_tot < 1.f ? 1.f : n_tot;
      const dplx::Eig3 e = dplx::eigh3x3_min(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]);
      const float mx = rs[4 * r + 1] / n, my = rs[4 * r + 2] / n, mz = rs[4 * r + 3] / n;
      const float d_raw = -(mx * e.vx + my * e.vy + mz * e.vz);
      const bool keep = d_raw > 0.f;
      const float wsum = e.w0 + e.w1 + e.w2;
      const float score = wsum != 0.f ? e.w2 / wsum : 0.f;
      float* ft = fit + 9 * r;
      ft[0] = keep ? e.vx : -e.vx;
      ft[1] = keep ? e.vy : -e.vy;
      ft[2] = keep ? e.vz : -e.vz;
      ft[3] = mx;
      ft[4] = my;
      ft[5] = mz;
      ft[6] = fabsf(d_raw);
      ft[7] = e.w0 / n;
      ft[8] = score;
#pragma unroll
      for (int c = 0; c < 6; ++c) sct[6 * r + c] = sc[c];
      ok = score > a.min_score;
    }
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j >= C) break;
      reinterpret_cast<int*>(tables_of(j) + L.acc)[r] = ok;
    }
  }
  if (!tables_shared) __threadfence();
  cluster.sync();
  RF_MARK(5);

  // 7. Slots in accept order, the first maxp accepted rounds (every block).
  if (warp == 0) {
    int taken = 0;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      const bool ok = r < R && acc[r];
      const unsigned bal = __ballot_sync(dplx::kFullMask, ok);
      const int slot = taken + __popc(bal & lanes_below);
      if (r < R) lut[r] = ok && slot < a.maxp ? slot + 1 : 0;
      taken += __popc(bal);
    }
    if (lane == 0) {
      s_taken = min(taken, a.maxp);
      if (rank == 0) a.nr_planes[b] = s_taken;
    }
  }
  __syncthreads();
  RF_MARK(6);

  // 8. The span's labels; this block's rounds' slots; its share of the
  // empty slots.
  for (int p = tid; p < ns; p += kThreads) {
    const int r = rm[p];
    a.labels_map[cell0 + p0 + p] = r >= 0 ? lut[r] : 0;
  }
  const size_t slot0 = (size_t)b * a.maxp;
  for (int r = rank + C * tid; r < R; r += C * kThreads) {
    if (lut[r] == 0) continue;
    const size_t k = slot0 + lut[r] - 1;
    const float* ft = fit + 9 * r;
    const float* sc = sct + 6 * r;
    a.seg_n[k] = rs[4 * r];
    for (int c = 0; c < 3; ++c) {
      a.seg_cs[3 * k + c] = rs[4 * r + 1 + c];
      a.seg_normal[3 * k + c] = ft[c];
      a.seg_mean[3 * k + c] = ft[3 + c];
    }
    float* s9 = a.seg_sc + 9 * k;
    s9[0] = sc[0]; s9[1] = sc[1]; s9[2] = sc[2];
    s9[3] = sc[1]; s9[4] = sc[3]; s9[5] = sc[4];
    s9[6] = sc[2]; s9[7] = sc[4]; s9[8] = sc[5];
    a.seg_d[k] = ft[6];
    a.seg_mse[k] = ft[7];
    a.seg_score[k] = ft[8];
  }
  for (int k = s_taken + rank + C * tid; k < a.maxp; k += C * kThreads) {
    const size_t s = slot0 + k;
    a.seg_n[s] = 0.f;
    a.seg_d[s] = 0.f;
    a.seg_mse[s] = 0.f;
    a.seg_score[s] = 0.f;
    for (int c = 0; c < 3; ++c) {
      a.seg_cs[3 * s + c] = 0.f;
      a.seg_normal[3 * s + c] = 0.f;
      a.seg_mean[3 * s + c] = 0.f;
    }
    for (int c = 0; c < 9; ++c) a.seg_sc[9 * s + c] = 0.f;
  }
#ifdef DPLX_PROFILE
  __syncthreads();
  RF_MARK(7);
#endif
}

}  // namespace

extern "C" {

// Bytes of global workspace dplx_round_finalize needs for B frames of N
// cells and R rounds on C blocks a frame: 0 where a block's arrays fit in
// shared memory (DPLX_PROFILE builds add the cycles' slots).
long long dplx_round_finalize_scratch_bytes(int B, int N, int R, int C) {
  if (C < 1) return 0;
  const long long work =
      (long long)B * C * (long long)Layout(span_cells(N, C), R).scratch_bytes();
  return kProfile ? (long long)align16(work) + (long long)B * C * kProfileSlots * 8 : work;
}

// Clusters of C blocks the card runs at once (cudaOccupancyMaxActiveClusters)
// at N cells and R rounds; a negative CUDA error code where it cannot say.
int dplx_round_finalize_max_clusters(int N, int R, int C) {
  if (N <= 0 || R < 0 || (C != 1 && C != 2 && C != 4 && C != 8)) return -(int)cudaErrorInvalidValue;
  const Layout L(span_cells(N, C), R);
  const size_t smem = L.smem_bytes();
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        round_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, round_finalize_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// round_map (B, N), seeds (B, R), nr_rounds (B,) int32 (the growing
// kernel's outputs); nr_pts 0-d, coord_sum and mean (B, N, 3), scatter
// (B, N, 3, 3) float32 (CellStats); C blocks a frame (1, 2, 4 or 8: a
// thread-block cluster). Outputs: sums (B, R, 16) float32 in the
// RoundData.sums layout; labels_map (B, N) and nr_planes (B,) int32; the
// PlaneSegments tables n (B, maxp), coord_sum (B, maxp, 3), scatter
// (B, maxp, 3, 3), normal and mean (B, maxp, 3), d, mse and score
// (B, maxp), float32. scratch: the bytes dplx_round_finalize_scratch_bytes
// asks for (may be null when it asks none). A cluster the card cannot
// place returns its error (cudaErrorClusterOutOfResources); nothing falls
// back to fewer blocks.
int dplx_round_finalize(const void* round_map, const void* seeds, const void* nr_rounds,
                        const void* nr_pts, const void* coord_sum, const void* mean,
                        const void* scatter, int B, int N, int R, int maxp, int C,
                        float min_cells, float min_score, void* sums, void* labels_map,
                        void* nr_planes, void* seg_n, void* seg_cs, void* seg_sc,
                        void* seg_normal, void* seg_mean, void* seg_d, void* seg_mse,
                        void* seg_score, void* scratch, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N <= 0 || R < 0 || maxp <= 0) return (int)cudaErrorInvalidValue;
  if (C != 1 && C != 2 && C != 4 && C != 8) return (int)cudaErrorInvalidValue;
  if ((long long)B * C > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int S = span_cells(N, C);
  int span_levels = 0;
  while ((1 << span_levels) < S) ++span_levels;
  const Layout L(S, R);
  const long long work = (long long)B * C * (long long)L.scratch_bytes();
  if ((kProfile || work) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = L.smem_bytes();
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        round_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* ws = static_cast<unsigned char*>(scratch);
  const Args args{static_cast<const int*>(round_map), static_cast<const int*>(seeds),
                  static_cast<const int*>(nr_rounds), static_cast<const float*>(nr_pts),
                  static_cast<const float*>(coord_sum), static_cast<const float*>(mean),
                  static_cast<const float*>(scatter), N, R, maxp, C, S, span_levels,
                  min_cells, min_score, static_cast<float*>(sums),
                  static_cast<int*>(labels_map), static_cast<int*>(nr_planes),
                  static_cast<float*>(seg_n), static_cast<float*>(seg_cs),
                  static_cast<float*>(seg_sc), static_cast<float*>(seg_normal),
                  static_cast<float*>(seg_mean), static_cast<float*>(seg_d),
                  static_cast<float*>(seg_mse), static_cast<float*>(seg_score), ws,
                  kProfile ? reinterpret_cast<long long*>(ws + align16(work)) : nullptr};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, round_finalize_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
