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
// exactly: the kernel skips empty subtrees and still gives the twin's bits.
// No float atomic is used (the repo's numerics rule); the planarity gate
// reads these sums.
//
// How: one block a frame.
//   1. Each cell's next member of the same round in raster order: every warp
//      walks its segment of the frame backwards 32 cells at a time
//      (__match_any_sync), keeping the first member of each round seen;
//      a segment's last member of a round links to the next segment's first.
//   2. The tree, level by level: a node's sum sits at its first member (its
//      head). At level l a head whose level-l node is a left child adds the
//      sum of the next head of its round if that head's node is the right
//      sibling, and takes over its link. After ceil(log2 N) levels a round's
//      first member holds the root. The coordinate sums run first; their
//      means recentre the second moments (sc + nr_pts * dmu * dmu), which
//      run through the same tree.
//   3. A thread a round: the fit (dplx::eigh3x3_min, as K3's refits), the
//      gates; one warp assigns the slots by ballot; then the labels and the
//      tables.
// A frame's per-round tables and cell arrays live in shared memory where
// they fit (TUM's 48 x 64 cells at 256 rounds); else the cell arrays, and
// past about 1,500 rounds the tables too, in a global workspace the caller
// allocates (dplx_round_finalize_scratch_bytes). Any number of rounds is
// taken, 0 included.
//
// What bounds it on the H100: latency. Its bytes (64 a cell in, 4 out, and
// 64 a round) take ~4 us at TUM B=64; the time is the ~2 x 12 dependent
// levels of the trees and the block's barriers between them, on B blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// A frame's arrays. Per round (always in shared memory): counts, first
// member, seed, seed-is-member, label, accept flag (ints); n_tot and the
// three coordinate sums, the round mean, the fit (normal, mean, d, mse,
// score) (floats); each warp's first member of every round in its segment.
// Per cell (shared or global): round, link, working link, head flag and
// the tree's six float lanes (structure of arrays).
struct Layout {
  size_t cnt, first, seed, seedm, lut, acc, rsum, mu, fit, seg, rounds_end;
  size_t rm, nxt0, nxt, v, head, cells;
  __host__ __device__ Layout(int N, int R) {
    const size_t r4 = align16((size_t)R * 4);
    cnt = 0;
    first = cnt + r4;
    seed = first + r4;
    seedm = seed + r4;
    lut = seedm + r4;
    acc = lut + r4;
    rsum = acc + r4;
    mu = rsum + align16((size_t)R * 16);
    fit = mu + align16((size_t)R * 12);
    seg = fit + align16((size_t)R * 36);
    rounds_end = seg + align16((size_t)kWarps * R * 4);
    const size_t n4 = align16((size_t)N * 4);
    rm = 0;
    nxt0 = rm + n4;
    nxt = nxt0 + n4;
    v = nxt + n4;
    head = v + 6 * n4;
    cells = head + align16((size_t)N);
  }
  __host__ __device__ bool rounds_fit() const { return rounds_end <= (size_t)kSmemLimit; }
  __host__ __device__ bool cells_fit() const { return rounds_end + cells <= (size_t)kSmemLimit; }
  // Dynamic shared memory of a block, and global workspace of a frame.
  __host__ __device__ size_t smem_bytes() const {
    return cells_fit() ? rounds_end + cells : rounds_fit() ? rounds_end : 0;
  }
  __host__ __device__ size_t scratch_bytes() const {
    return cells_fit() ? 0 : rounds_fit() ? cells : rounds_end + cells;
  }
};

struct Args {
  const int* round_map;     // (B, N)
  const int* seeds;         // (B, R)
  const int* nr_rounds;     // (B,)
  const float* nr_pts;      // ()
  const float* coord_sum;   // (B, N, 3)
  const float* mean;        // (B, N, 3)
  const float* scatter;     // (B, N, 3, 3)
  int N, R, maxp, levels;
  float min_cells, min_score;
  float* sums;              // (B, R, 16)
  int* labels_map;          // (B, N)
  int* nr_planes;           // (B,)
  float *seg_n, *seg_cs, *seg_sc, *seg_normal, *seg_mean, *seg_d, *seg_mse, *seg_score;
  unsigned char* scratch;   // B frames' arrays that do not fit in shared memory
};

// The trees' levels: sum each round's values v[c * N + p] (c < C) into its
// first member, merging right siblings into left ones level by level.
template <int C>
__device__ void tree_levels(int N, int levels, float* v, int* nxt, uint8_t* head) {
  for (int lv = 0; lv < levels; ++lv) {
    for (int p = threadIdx.x; p < N; p += kThreads) {
      if (!head[p] || ((p >> lv) & 1)) continue;
      const int q = nxt[p];
      if (q < 0 || (q >> lv) != (p >> lv) + 1) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c * N + p] = v[c * N + p] + v[c * N + q];
      nxt[p] = nxt[q];
      head[q] = 0;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) round_finalize_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R;
  const Layout L(N, R);
  unsigned char* work = a.scratch ? a.scratch + (size_t)b * L.scratch_bytes() : nullptr;
  unsigned char* tables = L.rounds_fit() ? smem : work;
  unsigned char* cells = L.cells_fit() ? smem + L.rounds_end
                         : L.rounds_fit() ? work : work + L.rounds_end;
  int* cnt = reinterpret_cast<int*>(tables + L.cnt);
  int* first = reinterpret_cast<int*>(tables + L.first);
  int* seed = reinterpret_cast<int*>(tables + L.seed);
  int* seedm = reinterpret_cast<int*>(tables + L.seedm);
  int* lut = reinterpret_cast<int*>(tables + L.lut);
  int* acc = reinterpret_cast<int*>(tables + L.acc);
  float* rsum = reinterpret_cast<float*>(tables + L.rsum);
  float* mu = reinterpret_cast<float*>(tables + L.mu);
  float* fit = reinterpret_cast<float*>(tables + L.fit);
  int* seg = reinterpret_cast<int*>(tables + L.seg);
  int* rm = reinterpret_cast<int*>(cells + L.rm);
  int* nxt0 = reinterpret_cast<int*>(cells + L.nxt0);
  int* nxt = reinterpret_cast<int*>(cells + L.nxt);
  float* v = reinterpret_cast<float*>(cells + L.v);
  uint8_t* head = reinterpret_cast<uint8_t*>(cells + L.head);
  const float nr_pts = *a.nr_pts;
  const int nr = a.nr_rounds[b];
  const size_t cell0 = (size_t)b * N;

  for (int r = tid; r < R; r += kThreads) {
    cnt[r] = 0;
    seed[r] = a.seeds[(size_t)b * R + r];
  }
  for (int k = tid; k < kWarps * R; k += kThreads) seg[k] = -1;
  __syncthreads();
  for (int p = tid; p < N; p += kThreads) {
    int r = a.round_map[cell0 + p];
    if (r < 0 || r >= R) r = -1;
    rm[p] = r;
    if (r >= 0) atomicAdd(&cnt[r], 1);   // an integer count: any order gives it
  }
  __syncthreads();

  // 1. Links to the next member of the same round, segment by segment.
  const int seg_len = ((N + kWarps - 1) / kWarps + 31) & ~31;
  {
    const int s0 = warp * seg_len, s1 = min(N, s0 + seg_len);
    int* seen = seg + warp * R;
    for (int base = s0 + ((s1 - s0 - 1) >> 5) * 32; s0 < s1 && base >= s0; base -= 32) {
      const int p = base + lane;
      const int r = p < s1 ? rm[p] : -1;
      const unsigned same = __match_any_sync(dplx::kFullMask, r);
      const unsigned later = lane == 31 ? 0u : same & (~0u << (lane + 1));
      int link = -1;
      if (r >= 0) link = later ? base + __ffs(later) - 1 : seen[r];
      __syncwarp();
      if (r >= 0 && (same & ((1u << lane) - 1)) == 0) seen[r] = p;
      __syncwarp();
      if (p < s1) nxt0[p] = link;
    }
  }
  __syncthreads();
  for (int p = tid; p < N; p += kThreads) {
    const int r = rm[p];
    if (r < 0 || nxt0[p] >= 0) continue;
    for (int w = p / seg_len + 1; w < kWarps; ++w) {
      const int q = seg[w * R + r];
      if (q >= 0) {
        nxt0[p] = q;
        break;
      }
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    int f = -1;
    for (int w = 0; w < kWarps && f < 0; ++w) f = seg[w * R + r];
    first[r] = f;
    const int s = seed[r];
    seedm[r] = s >= 0 && s < N && rm[s] == r;
  }
  __syncthreads();

  // 2a. The coordinate sums.
  for (int p = tid; p < N; p += kThreads) {
    const int r = rm[p];
    head[p] = r >= 0;
    nxt[p] = nxt0[p];
    if (r < 0) continue;
    const float w = seed[r] == p ? 2.f : 1.f;
    const float* cs = a.coord_sum + (cell0 + p) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c * N + p] = __fadd_rn(__fmul_rn(w, cs[c]), 0.f);
  }
  __syncthreads();
  tree_levels<3>(N, a.levels, v, nxt, head);
  for (int r = tid; r < R; r += kThreads) {
    const int f = first[r];
    const float n_tot = (float)(cnt[r] + seedm[r]) * nr_pts;
    const float nc = n_tot < 1.f ? 1.f : n_tot;
    rsum[4 * r] = n_tot;
    for (int c = 0; c < 3; ++c) {
      const float s = f >= 0 ? v[c * N + f] : 0.f;
      rsum[4 * r + 1 + c] = s;
      mu[3 * r + c] = s / nc;
    }
  }
  __syncthreads();

  // 2b. The second moments about the round mean.
  for (int p = tid; p < N; p += kThreads) {
    const int r = rm[p];
    head[p] = r >= 0;
    nxt[p] = nxt0[p];
    if (r < 0) continue;
    const float w = seed[r] == p ? 2.f : 1.f;
    const float* mp = a.mean + (cell0 + p) * 3;
    const float* sp = a.scatter + (cell0 + p) * 9;
    const float d0 = mp[0] - mu[3 * r], d1 = mp[1] - mu[3 * r + 1], d2 = mp[2] - mu[3 * r + 2];
    const float feat[6] = {sp[0] + nr_pts * d0 * d0, sp[1] + nr_pts * d0 * d1,
                           sp[2] + nr_pts * d0 * d2, sp[4] + nr_pts * d1 * d1,
                           sp[5] + nr_pts * d1 * d2, sp[8] + nr_pts * d2 * d2};
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c * N + p] = __fadd_rn(__fmul_rn(w, feat[c]), 0.f);
  }
  __syncthreads();
  tree_levels<6>(N, a.levels, v, nxt, head);

  // 3. Sums rows, fits and gates (ops/growing.py:fit_plane, finalize_rounds).
  for (int r = tid; r < R; r += kThreads) {
    const int f = first[r];
    float sc[6];
    for (int c = 0; c < 6; ++c) sc[c] = f >= 0 ? v[c * N + f] : 0.f;
    const float n_tot = rsum[4 * r];
    float* row = a.sums + ((size_t)b * R + r) * 16;
    row[0] = n_tot;
    for (int c = 0; c < 3; ++c) row[1 + c] = rsum[4 * r + 1 + c];
    for (int c = 0; c < 6; ++c) row[4 + c] = sc[c];
    const float size = (float)cnt[r];
    row[10] = size;
    for (int c = 11; c < 16; ++c) row[c] = 0.f;

    const float n = n_tot < 1.f ? 1.f : n_tot;
    const dplx::Eig3 e = dplx::eigh3x3_min(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]);
    const float mx = rsum[4 * r + 1] / n, my = rsum[4 * r + 2] / n, mz = rsum[4 * r + 3] / n;
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
    acc[r] = r < nr && size >= a.min_cells && score > a.min_score;
  }
  __syncthreads();

  // Slots in accept order, the first maxp accepted rounds.
  if (warp == 0) {
    int taken = 0;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      const bool ok = r < R && acc[r];
      const unsigned bal = __ballot_sync(dplx::kFullMask, ok);
      const int slot = taken + __popc(bal & ((1u << lane) - 1));
      if (r < R) lut[r] = ok && slot < a.maxp ? slot + 1 : 0;
      taken += __popc(bal);
    }
    if (lane == 0) a.nr_planes[b] = min(taken, a.maxp);
  }
  __syncthreads();

  for (int p = tid; p < N; p += kThreads) {
    const int r = rm[p];
    a.labels_map[cell0 + p] = r >= 0 ? lut[r] : 0;
  }
  const size_t slot0 = (size_t)b * a.maxp;
  for (int r = tid; r < R; r += kThreads) {
    if (lut[r] == 0) continue;
    const size_t k = slot0 + lut[r] - 1;
    const float* ft = fit + 9 * r;
    const int f = first[r];
    float sc[6];
    for (int c = 0; c < 6; ++c) sc[c] = f >= 0 ? v[c * N + f] : 0.f;
    a.seg_n[k] = rsum[4 * r];
    for (int c = 0; c < 3; ++c) {
      a.seg_cs[3 * k + c] = rsum[4 * r + 1 + c];
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
  // Slots past nr_planes are zero.
  const int filled = min(a.nr_planes[b], a.maxp);
  for (int k = filled + tid; k < a.maxp; k += kThreads) {
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
}

}  // namespace

extern "C" {

// Bytes of global workspace dplx_round_finalize needs for B frames of N
// cells and R rounds: 0 where a frame's arrays fit in shared memory.
long long dplx_round_finalize_scratch_bytes(int B, int N, int R) {
  return (long long)B * (long long)Layout(N, R).scratch_bytes();
}

// round_map (B, N), seeds (B, R), nr_rounds (B,) int32 (the growing
// kernel's outputs); nr_pts 0-d, coord_sum and mean (B, N, 3), scatter
// (B, N, 3, 3) float32 (CellStats). Outputs: sums (B, R, 16) float32 in the
// RoundData.sums layout; labels_map (B, N) and nr_planes (B,) int32; the
// PlaneSegments tables n (B, maxp), coord_sum (B, maxp, 3), scatter
// (B, maxp, 3, 3), normal and mean (B, maxp, 3), d, mse and score
// (B, maxp), float32. scratch: the bytes dplx_round_finalize_scratch_bytes
// asks for (may be null when it asks none).
int dplx_round_finalize(const void* round_map, const void* seeds, const void* nr_rounds,
                        const void* nr_pts, const void* coord_sum, const void* mean,
                        const void* scatter, int B, int N, int R, int maxp, float min_cells,
                        float min_score, void* sums, void* labels_map, void* nr_planes,
                        void* seg_n, void* seg_cs, void* seg_sc, void* seg_normal,
                        void* seg_mean, void* seg_d, void* seg_mse, void* seg_score,
                        void* scratch, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N <= 0 || R < 0 || maxp <= 0) return (int)cudaErrorInvalidValue;
  int levels = 0;
  while (((long long)1 << levels) < N) ++levels;
  const Layout L(N, R);
  if (L.scratch_bytes() && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = L.smem_bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        round_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Args args{static_cast<const int*>(round_map), static_cast<const int*>(seeds),
                  static_cast<const int*>(nr_rounds), static_cast<const float*>(nr_pts),
                  static_cast<const float*>(coord_sum), static_cast<const float*>(mean),
                  static_cast<const float*>(scatter), N, R, maxp, levels, min_cells,
                  min_score, static_cast<float*>(sums), static_cast<int*>(labels_map),
                  static_cast<int*>(nr_planes), static_cast<float*>(seg_n),
                  static_cast<float*>(seg_cs), static_cast<float*>(seg_sc),
                  static_cast<float*>(seg_normal), static_cast<float*>(seg_mean),
                  static_cast<float*>(seg_d), static_cast<float*>(seg_mse),
                  static_cast<float*>(seg_score), static_cast<unsigned char*>(scratch)};
  round_finalize_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
