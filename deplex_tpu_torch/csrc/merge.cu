// Stage-4 kernel: plane adjacency and the greedy merge, in one launch.
//
// Replaces the TPU kernel deplex_tpu/ops/pallas_merge.py:158 _merge_kernel
// (K3) together with the adjacency the JAX package feeds it from XLA
// (pallas_merge.py:304, deplex_tpu/ops/merge.py:42 plane_adjacency).
// Adjacency: every cell (i, j) with i < gh-1 and j < gw-1 pairs with its right
// and down neighbours when both labels lie in 1..M and differ (the
// reference's stencil, so the last row and column contribute nothing); the
// pairs go into shared memory as bit masks, one 64-bit word per slot for M <=
// 64 and ceil(M/64) beyond, set with 32-bit integer atomicOr on their halves
// (order-free, so the result is deterministic). Merge: for each row r < nr_planes, in order: pid =
// merge_labels[r]; every column c > r adjacent to r whose normal and mean are
// compatible with pid's (cos > min_cos, dist^2 < max_dist) joins pid. The
// joining columns' counts, sums and scatters are combined into pid about the
// new mean (Chan's formula), pid's mean is updated, and its normal and d are
// refit by the smallest-eigenvector fit of common.cuh. Candidate columns carry
// their pre-merge stats and the representative is refit at the end of the
// row, as in ops/merge.py:merge_planes_from_adjacency.
//
// Bound on the H100 by latency, not bytes: the rows form a chain in which a
// row may read the refit of any earlier one, and a frame's labels (12 KB at
// TUM VGA) are far too few bytes to matter. Design for M <= 64 (every
// shipped config): one block of 16 warps per frame. Each lane walks down a
// column of labels, eight rows of coalesced loads in flight at a time; a
// cell inside a segment costs two compares, and only a pair the lane has not
// just set takes a shared-memory read and, if it is new, an atomic. (A key
// match across the warp to elect one lane a pair cost more than the atomics
// it saved.) Then one warp runs the
// rows with no block barrier while the others copy the tables to the
// outputs. A row's candidates (its mask above r) do not depend on the merge,
// and a row that nothing absorbed before it is its own representative with
// its stats as loaded (only representatives change, and they are slots below
// the row), tested against candidates as loaded: its joins are known up
// front. So each lane finds the joins of its two rows in parallel, and the
// walk visits only rows that join something and absorbed rows with
// candidates; every other row costs nothing. An absorbed row tests its
// candidates on their owning lanes (lane l holds slots l and l+32 in
// registers) against pid's normal and d, which a shuffle brings from its
// lane; a ballot with no bit set ends the row. Only a row that merges pays
// for the sums (xor-butterfly shuffles, the same fixed order on every lane,
// so runs are deterministic) and the refit, which every lane computes alike
// so no broadcast is needed. At the end the row warp writes the merge labels
// and only the slots a merge changed. M > 64 takes the block version: one
// thread per slot, tables in shared memory, block sums, reading the
// multi-word masks.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kStageThreads = 512;   // M <= 64: 16 warps read the labels, warp 0 runs the rows
constexpr int kProfileSlots = 9;
constexpr int kBlockBytes = 232448;  // shared memory a block may use on the H100
constexpr int kWarpStaticBytes = 64 * 8 + 64 * 6 * 4;   // merge_warp_kernel's own arrays
constexpr int kBlockStaticBytes = 32 * 12 * 4;          // merge_block_kernel's block sums

// Sets bit (b-1) of row a-1 and bit (a-1) of row b-1 of the masks, as 32-bit
// halves (shared-memory OR is native at 32 bits); a plain read first skips
// the atomic for a pair already seen (long borders repeat one pair).
__device__ __forceinline__ void set_pair(unsigned long long* adj, int words, int a, int b) {
  unsigned* half = reinterpret_cast<unsigned*>(adj);
  volatile unsigned* seen = half;
  const size_t wa = (size_t)(a - 1) * words * 2 + (b - 1) / 32;
  const size_t wb = (size_t)(b - 1) * words * 2 + (a - 1) / 32;
  const unsigned ba = 1u << ((b - 1) % 32), ab = 1u << ((a - 1) % 32);
  if (!(seen[wa] & ba)) atomicOr(half + wa, ba);
  if (!(seen[wb] & ab)) atomicOr(half + wb, ab);
}

// Copies n labels from global to shared memory with cp.async, 16 bytes a
// copy where both ends allow it, and waits for them: every copy of the block
// is in flight at once, and none holds a register.
__device__ void stage_labels(int* dst, const int* src, int n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      n % 4 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) __pipeline_memcpy_async(dst + i, src + i, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The adjacency of one frame's (gh, gw) labels into `adj` (zeroed), by every
// warp of the block, through `band` (band_cells >= 2 * gw ints of shared
// memory): bands of rows are staged there, then a warp takes a strip of 32
// anchor columns over a chunk of the band's anchor rows and each lane walks
// down its column, eight rows of neighbours at a time, carrying the lower
// one to the next row. The pair tests are predicated; a pair that is not
// the one the lane set last in its direction (a border repeats one pair)
// takes the one branch, to a shared-memory read and, if new, an atomic.
__device__ void build_adjacency(const int* __restrict__ lm, int gh, int gw, int M, int words,
                                unsigned long long* adj, int* band, int band_cells) {
  constexpr int kRows = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int per_band = band_cells / gw - 1, strips = (gw - 1 + 31) / 32;
  const int chunks = max(1, warps / max(strips, 1));
  for (int b0 = 0; b0 < gh - 1; b0 += per_band) {
    const int anchors = min(per_band, gh - 1 - b0);
    stage_labels(band, lm + (size_t)b0 * gw, (anchors + 1) * gw);
    const int rows_per = (anchors + chunks - 1) / chunks;
    for (int item = warp; item < strips * chunks; item += warps) {
      const int j = (item % strips) * 32 + lane;
      const int r0 = (item / strips) * rows_per, r1 = min(anchors, r0 + rows_per);
      const bool col = j < gw - 1;                // an anchor column
      int a = col && r0 < r1 ? band[r0 * gw + j] : 0;
      unsigned last_right = ~0u, last_down = ~0u;   // keys of valid pairs are < 2^20
      for (int r = r0; r < r1; r += kRows) {
        int right[kRows], down[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const bool ok = col && r + u < r1;
          right[u] = ok ? band[(r + u) * gw + j + 1] : 0;
          down[u] = ok ? band[(r + u + 1) * gw + j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const bool slot = (unsigned)(a - 1) < (unsigned)M;
          const unsigned kr = (unsigned)(a - 1) * 1024u + (unsigned)(right[u] - 1),
                         kd = (unsigned)(a - 1) * 1024u + (unsigned)(down[u] - 1);
          const bool new_r = slot & ((unsigned)(right[u] - 1) < (unsigned)M) &
                             (right[u] != a) & (kr != last_right);
          const bool new_d = slot & ((unsigned)(down[u] - 1) < (unsigned)M) &
                             (down[u] != a) & (kd != last_down);
          if (new_r | new_d) {
            if (new_r) set_pair(adj, words, a, right[u]);
            if (new_d) set_pair(adj, words, a, down[u]);
          }
          last_right = new_r ? kr : last_right;
          last_down = new_d ? kd : last_down;
          a = down[u];
        }
      }
    }
    __syncthreads();   // the band is read before the next one overwrites it
  }
}

struct Tables {
  const int* labels;
  const int* nr_planes;
  const float* in[6];    // n, coord_sum, scatter, normal, mean, d
  float* out[6];
  int* merge_labels;
  long long* profile;    // (B, kProfileSlots) cycles and counts, DPLX_PROFILE builds
};

// Frame b's tables in -> out unchanged, by the threads from `first` on.
__device__ __forceinline__ void copy_tables(const Tables& t, size_t b, int M, int first) {
  constexpr int kWidth[6] = {1, 3, 9, 3, 3, 1};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const size_t base = b * M * kWidth[k];
    for (int i = threadIdx.x - first; i < M * kWidth[k]; i += blockDim.x - first)
      t.out[k][base + i] = t.in[k][base + i];
  }
}

// Mask of the slots above r (r < 64).
__device__ __forceinline__ unsigned long long above(int r) {
  return r >= 63 ? 0ull : (~0ull << (r + 1));
}

// One slot of the row warp's state, in registers.
struct Slot {
  float n, cs[3], sc[6], nrm[3], mean[3], d;
  int ml;
};

// The value of slot `hi ? 32 + src : src`'s field, on every lane.
#define DPLX_FROM_SLOT(field, hi, src) \
  __shfl_sync(dplx::kFullMask, (hi) ? s[1].field : s[0].field, (src))

// M <= 64: one block a frame; all warps build the masks, then warp 0 runs the
// rows while the others copy the tables to the outputs.
__global__ void __launch_bounds__(kStageThreads)
merge_warp_kernel(Tables t, int gh, int gw, int M, int band_cells, float min_cos,
                  float max_dist) {
  extern __shared__ int4 dyn4[];    // band_cells labels
  __shared__ unsigned long long adj[64];
  __shared__ float loaded[64][6];   // each slot's normal and mean as loaded
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)b * M;
#ifdef DPLX_PROFILE
  long long prof[kProfileSlots] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long mark = clock64();
#define DPLX_LAP(slot)                 \
  do {                                 \
    const long long now = clock64();   \
    prof[slot] += now - mark;          \
    mark = now;                        \
  } while (0)
#else
#define DPLX_LAP(slot) \
  do {                 \
  } while (0)
#endif

  // The row warp's slots and row count, loaded first so that the loads
  // overlap the adjacency.
  Slot s[2];
  int rows = 0;
  if (warp == 0) {
    constexpr int kSym[6] = {0, 1, 2, 4, 5, 8};
    rows = max(0, min(t.nr_planes[b], M));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const bool ok = c < M;
      const size_t g = base + (ok ? c : 0);
      s[h].n = ok ? t.in[0][g] : 0.f;
      s[h].d = ok ? t.in[5][g] : 0.f;
      s[h].ml = c;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[h].cs[k] = ok ? t.in[1][g * 3 + k] : 0.f;
        s[h].nrm[k] = ok ? t.in[3][g * 3 + k] : 0.f;
        s[h].mean[k] = ok ? t.in[4][g * 3 + k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) s[h].sc[k] = ok ? t.in[2][g * 9 + kSym[k]] : 0.f;
    }
  }
  if (threadIdx.x < 64) adj[threadIdx.x] = 0ull;
  __syncthreads();
  build_adjacency(t.labels + (size_t)b * gh * gw, gh, gw, M, 1, adj,
                  reinterpret_cast<int*>(dyn4), band_cells);
  __syncthreads();

  unsigned long long dirty = 0ull;
  if (warp != 0) {
    copy_tables(t, b, M, 32);
  } else {
    DPLX_LAP(0);
    // Rows with candidates: r < rows and a mask bit above r.
    unsigned long long cand[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      cand[h] = r < rows ? adj[r] & above(r) : 0ull;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        loaded[r][k] = s[h].nrm[k];
        loaded[r][3 + k] = s[h].mean[k];
      }
    }
    __syncwarp();
    // A row that nothing absorbed before it has itself as representative,
    // with its stats as loaded (only representatives change, and they are
    // slots below the row), against candidates as loaded: its joins are
    // known up front. Each lane finds those of its two rows.
    unsigned long long joins[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      joins[h] = 0ull;
      for (unsigned long long m = cand[h]; m; m &= m - 1) {
        const float* q = loaded[__ffsll((long long)m) - 1];
        const float cosv = q[0] * s[h].nrm[0] + q[1] * s[h].nrm[1] + q[2] * s[h].nrm[2];
        const float off = q[3] * s[h].nrm[0] + q[4] * s[h].nrm[1] + q[5] * s[h].nrm[2] + s[h].d;
        if (cosv > min_cos && off * off < max_dist) joins[h] |= m & (~m + 1);
      }
    }
    const unsigned long long with_cand =
        (unsigned long long)__ballot_sync(dplx::kFullMask, cand[0] != 0ull) |
        ((unsigned long long)__ballot_sync(dplx::kFullMask, cand[1] != 0ull) << 32);
    const unsigned long long joining =
        (unsigned long long)__ballot_sync(dplx::kFullMask, joins[0] != 0ull) |
        ((unsigned long long)__ballot_sync(dplx::kFullMask, joins[1] != 0ull) << 32);
    DPLX_LAP(1);

    // The walk, in row order: rows that join something as their own
    // representative, and absorbed rows with candidates, which test them
    // against their representative's current stats.
    unsigned long long left = with_cand, absorbed = 0ull;
    int visited = 0;
    while (const unsigned long long live = left & (joining | absorbed)) {
      const int r = __ffsll((long long)live) - 1;
      left &= above(r);
      ++visited;
      const bool rhi = r >= 32;
      int pid = r;
      unsigned long long joined;
      if (!((absorbed >> r) & 1ull)) {
        joined = __shfl_sync(dplx::kFullMask, rhi ? joins[1] : joins[0], r & 31);
      } else {
        pid = DPLX_FROM_SLOT(ml, rhi, r & 31);
        const bool phi = pid >= 32;
        const int src = pid & 31;
        const float px = DPLX_FROM_SLOT(nrm[0], phi, src),
                    py = DPLX_FROM_SLOT(nrm[1], phi, src),
                    pz = DPLX_FROM_SLOT(nrm[2], phi, src), dp = DPLX_FROM_SLOT(d, phi, src);
        const unsigned long long cr = __shfl_sync(dplx::kFullMask, rhi ? cand[1] : cand[0],
                                                  r & 31);
        bool pass[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // every lane tests; the mask bit selects
          const float cosv = s[h].nrm[0] * px + s[h].nrm[1] * py + s[h].nrm[2] * pz;
          const float off = s[h].mean[0] * px + s[h].mean[1] * py + s[h].mean[2] * pz + dp;
          pass[h] = (((cr >> (lane + 32 * h)) & 1ull) != 0ull) & (cosv > min_cos) &
                    (off * off < max_dist);
        }
        joined = (unsigned long long)__ballot_sync(dplx::kFullMask, pass[0]) |
                 ((unsigned long long)__ballot_sync(dplx::kFullMask, pass[1]) << 32);
        if (!joined) {
          DPLX_LAP(2);
          continue;
        }
      }
      const bool phi = pid >= 32;
      const int src = pid & 31;
      const bool pass[2] = {((joined >> lane) & 1ull) != 0ull,
                            ((joined >> (lane + 32)) & 1ull) != 0ull};

      // Counts and coordinate sums of the joining columns, then the new mean.
      float add[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!pass[h]) continue;
        add[0] += s[h].n;   // lane-local sum of the two slots, then the butterfly
#pragma unroll
        for (int k = 0; k < 3; ++k) add[1 + k] += s[h].cs[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) add[k] = dplx::warp_sum(add[k]);
      const float new_n = DPLX_FROM_SLOT(n, phi, src) + add[0];
      const float new_s[3] = {DPLX_FROM_SLOT(cs[0], phi, src) + add[1],
                              DPLX_FROM_SLOT(cs[1], phi, src) + add[2],
                              DPLX_FROM_SLOT(cs[2], phi, src) + add[3]};
      const float nd = fmaxf(new_n, 1.f);
      const float mu[3] = {new_s[0] / nd, new_s[1] / nd, new_s[2] / nd};

      // Chan combine about mu over the representative and the joining columns.
      constexpr int kI[6] = {0, 0, 0, 1, 1, 2}, kJ[6] = {0, 1, 2, 1, 2, 2};
      float acc[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) acc[k] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pass[h] || lane + 32 * h == pid) {
          const float den = fmaxf(s[h].n, 1.f);
          const float dm[3] = {s[h].cs[0] / den - mu[0], s[h].cs[1] / den - mu[1],
                               s[h].cs[2] / den - mu[2]};
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            acc[k] += s[h].sc[k];
            acc[6 + k] += s[h].n * dm[kI[k]] * dm[kJ[k]];
          }
        }
      }
      float sc6[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) sc6[k] = dplx::warp_sum(acc[k]) + dplx::warp_sum(acc[6 + k]);
      DPLX_LAP(3);
      // The refit, on every lane alike: no broadcast.
      float nx, ny, nz, dd;
      dplx::fit_normal_d(sc6[0], sc6[1], sc6[2], sc6[3], sc6[4], sc6[5], new_s[0], new_s[1],
                         new_s[2], nd, &nx, &ny, &nz, &dd);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pass[h]) s[h].ml = pid;
        if (lane == src && phi == (h == 1)) {
          s[h].n = new_n;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            s[h].cs[k] = new_s[k];
            s[h].mean[k] = mu[k];
          }
#pragma unroll
          for (int k = 0; k < 6; ++k) s[h].sc[k] = sc6[k];
          s[h].nrm[0] = nx;
          s[h].nrm[1] = ny;
          s[h].nrm[2] = nz;
          s[h].d = dd;
        }
      }
      absorbed |= joined;
      dirty |= 1ull << pid;
#ifdef DPLX_PROFILE
      prof[8] += 1;
#endif
      DPLX_LAP(4);
    }
#ifdef DPLX_PROFILE
    prof[6] = rows - visited;
    prof[7] = visited - prof[8];
#endif
  }
  __syncthreads();   // the copy is done before the changed slots overwrite it
  if (warp != 0) return;

  // Merge labels of every slot; the full tables of the slots a merge changed.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (c >= M) continue;
    const size_t g = base + c;
    t.merge_labels[g] = s[h].ml;
    if (!((dirty >> c) & 1ull)) continue;
    t.out[0][g] = s[h].n;
    t.out[5][g] = s[h].d;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t.out[1][g * 3 + k] = s[h].cs[k];
      t.out[3][g * 3 + k] = s[h].nrm[k];
      t.out[4][g * 3 + k] = s[h].mean[k];
    }
    const float* q = s[h].sc;
    const float full[9] = {q[0], q[1], q[2], q[1], q[3], q[4], q[2], q[4], q[5]};
#pragma unroll
    for (int k = 0; k < 9; ++k) t.out[2][g * 9 + k] = full[k];
  }
#ifdef DPLX_PROFILE
  DPLX_LAP(5);
  if (lane == 0)
    for (int k = 0; k < kProfileSlots; ++k) t.profile[(size_t)b * kProfileSlots + k] = prof[k];
#endif
#undef DPLX_LAP
}

#undef DPLX_FROM_SLOT

// M > 64: one block a frame, one thread per slot, masks, tables and a band of
// labels in shared memory, block sums in a fixed order.
__global__ void merge_block_kernel(Tables t, int gh, int gw, int M, int band_cells,
                                   float min_cos, float max_dist) {
  extern __shared__ int4 dyn4[];
  __shared__ float red[32 * 12];
  const int words = (M + 63) / 64;
  unsigned long long* adj = reinterpret_cast<unsigned long long*>(dyn4);   // M * words
  float* smem = reinterpret_cast<float*>(adj + (M * words + 1) / 2 * 2);
  float* tn = smem;             // M
  float* tcs = smem + M;        // 3M
  float* tsc = smem + 4 * M;    // 6M: xx, xy, xz, yy, yz, zz
  float* tnrm = smem + 10 * M;  // 3M
  float* tmean = smem + 13 * M; // 3M
  float* td = smem + 16 * M;    // M
  int* tml = reinterpret_cast<int*>(smem + 17 * M);
  int* band = reinterpret_cast<int*>(smem) + (18 * M + 3) / 4 * 4;   // band_cells
  const int b = blockIdx.x, c = threadIdx.x;
  const size_t base = (size_t)b * M;
  const bool slot = c < M;
  constexpr int kSym[6] = {0, 1, 2, 4, 5, 8};

  for (int i = c; i < M * words; i += blockDim.x) adj[i] = 0ull;
  if (slot) {
    tn[c] = t.in[0][base + c];
    td[c] = t.in[5][base + c];
    tml[c] = c;
    for (int k = 0; k < 3; ++k) {
      tcs[c * 3 + k] = t.in[1][(base + c) * 3 + k];
      tnrm[c * 3 + k] = t.in[3][(base + c) * 3 + k];
      tmean[c * 3 + k] = t.in[4][(base + c) * 3 + k];
    }
    for (int k = 0; k < 6; ++k) tsc[c * 6 + k] = t.in[2][(base + c) * 9 + kSym[k]];
  }
  __syncthreads();
  build_adjacency(t.labels + (size_t)b * gh * gw, gh, gw, M, words, adj, band, band_cells);
  __syncthreads();

  const int rows = max(0, min(t.nr_planes[b], M));
  for (int r = 0; r < rows; ++r) {
    // A row with no mask bit above r changes nothing (uniform: no barrier).
    const unsigned long long* row = adj + (size_t)r * words;
    unsigned long long any = row[r / 64] & above(r % 64);
    for (int k = r / 64 + 1; k < words; ++k) any |= row[k];
    if (!any) continue;

    const int pid = tml[r];
    const float px = tnrm[pid * 3], py = tnrm[pid * 3 + 1], pz = tnrm[pid * 3 + 2];
    const float dp = td[pid];
    bool passing = false;
    if (slot && c > r && ((row[c / 64] >> (c % 64)) & 1ull)) {
      const float cosv = tnrm[c * 3] * px + tnrm[c * 3 + 1] * py + tnrm[c * 3 + 2] * pz;
      const float off = tmean[c * 3] * px + tmean[c * 3 + 1] * py + tmean[c * 3 + 2] * pz + dp;
      passing = cosv > min_cos && off * off < max_dist;
    }
    const float w = passing ? 1.f : 0.f;
    const float nc = slot ? tn[c] : 0.f;
    float a[5] = {w, w * nc, 0.f, 0.f, 0.f};
    if (slot)
      for (int k = 0; k < 3; ++k) a[2 + k] = w * tcs[c * 3 + k];
    dplx::block_sum<5>(a, red);
    if (a[0] == 0.f) continue;  // no column joins: the row changes nothing

    const float new_n = tn[pid] + a[1];
    const float new_s[3] = {tcs[pid * 3] + a[2], tcs[pid * 3 + 1] + a[3],
                            tcs[pid * 3 + 2] + a[4]};
    const float nd = fmaxf(new_n, 1.f);
    const float mu[3] = {new_s[0] / nd, new_s[1] / nd, new_s[2] / nd};

    const float wall = w + (c == pid ? 1.f : 0.f);
    float s[12];
    for (int k = 0; k < 12; ++k) s[k] = 0.f;
    if (slot) {
      const float den = fmaxf(nc, 1.f);
      const float dm[3] = {tcs[c * 3] / den - mu[0], tcs[c * 3 + 1] / den - mu[1],
                           tcs[c * 3 + 2] / den - mu[2]};
      const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
      for (int k = 0; k < 6; ++k) {
        s[k] = wall * tsc[c * 6 + k];
        s[6 + k] = wall * nc * dm[pi[k]] * dm[pj[k]];
      }
    }
    dplx::block_sum<12>(s, red);

    if (passing) tml[c] = pid;
    if (c == 0) {
      float sc6[6];
      for (int k = 0; k < 6; ++k) sc6[k] = s[k] + s[6 + k];
      float nx, ny, nz, dd;
      dplx::fit_normal_d(sc6[0], sc6[1], sc6[2], sc6[3], sc6[4], sc6[5], new_s[0],
                         new_s[1], new_s[2], nd, &nx, &ny, &nz, &dd);
      tn[pid] = new_n;
      for (int k = 0; k < 3; ++k) {
        tcs[pid * 3 + k] = new_s[k];
        tmean[pid * 3 + k] = mu[k];
      }
      for (int k = 0; k < 6; ++k) tsc[pid * 6 + k] = sc6[k];
      tnrm[pid * 3] = nx;
      tnrm[pid * 3 + 1] = ny;
      tnrm[pid * 3 + 2] = nz;
      td[pid] = dd;
    }
    __syncthreads();
  }

  if (slot) {
    t.merge_labels[base + c] = tml[c];
    t.out[0][base + c] = tn[c];
    t.out[5][base + c] = td[c];
    for (int k = 0; k < 3; ++k) {
      t.out[1][(base + c) * 3 + k] = tcs[c * 3 + k];
      t.out[3][(base + c) * 3 + k] = tnrm[c * 3 + k];
      t.out[4][(base + c) * 3 + k] = tmean[c * 3 + k];
    }
    const float* q = tsc + c * 6;
    const float full[9] = {q[0], q[1], q[2], q[1], q[3], q[4], q[2], q[4], q[5]};
    for (int k = 0; k < 9; ++k) t.out[2][(base + c) * 9 + k] = full[k];
  }
}

}  // namespace

extern "C" {

// labels_map (B, gh, gw) int32 cell labels (k > 0: slot k-1); nr_planes (B,)
// int32; n, d (B, M); coord_sum, normal, mean (B, M, 3); scatter (B, M, 3, 3),
// all float32. Outputs in the same layouts, merge_labels (B, M) int32.
// profile: (B, 9) int64 in -DDPLX_PROFILE builds, for M <= 64 (cycles of
// reading the labels and setting the masks, the row scan with the joins
// known up front, rows that test without merging, the sums of merging rows,
// their refits and write-out; counts of rows skipped, rows that test
// without merging and merging rows); otherwise unused, may be null. M is at
// most 1024.
int dplx_merge_from_labels(const void* labels_map, const void* nr_planes, const void* n,
                           const void* coord_sum, const void* scatter, const void* normal,
                           const void* mean, const void* d, int B, int gh, int gw, int M,
                           float min_cos, float max_dist, void* merge_labels, void* n_out,
                           void* coord_sum_out, void* scatter_out, void* normal_out,
                           void* mean_out, void* d_out, void* profile, void* stream) {
  if (B <= 0 || M <= 0) return (int)cudaSuccess;
  if (M > 1024 || gh <= 0 || gw <= 0) return (int)cudaErrorInvalidValue;
  Tables t{static_cast<const int*>(labels_map),
           static_cast<const int*>(nr_planes),
           {static_cast<const float*>(n), static_cast<const float*>(coord_sum),
            static_cast<const float*>(scatter), static_cast<const float*>(normal),
            static_cast<const float*>(mean), static_cast<const float*>(d)},
           {static_cast<float*>(n_out), static_cast<float*>(coord_sum_out),
            static_cast<float*>(scatter_out), static_cast<float*>(normal_out),
            static_cast<float*>(mean_out), static_cast<float*>(d_out)},
           static_cast<int*>(merge_labels),
           static_cast<long long*>(profile)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The labels take the shared memory left: the whole frame if it fits, else
  // bands of rows (two rows at least).
  const bool warp = M <= 64;
  const size_t fixed =
      warp ? kWarpStaticBytes
           : kBlockStaticBytes + (size_t)(M * ((M + 63) / 64) + 1) / 2 * 16 +
                 (size_t)(18 * M + 3) / 4 * 16;
  size_t band_cells = (size_t)(gh > 1 ? gh : 2) * gw;
  if (band_cells > (kBlockBytes - fixed) / 4) band_cells = (kBlockBytes - fixed) / 4;
  if (band_cells < (size_t)2 * gw) return (int)cudaErrorInvalidValue;
  const size_t smem = (warp ? 0 : fixed - kBlockStaticBytes) + band_cells * 4;
  const void* kernel = warp ? (const void*)merge_warp_kernel : (const void*)merge_block_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (warp)
    merge_warp_kernel<<<B, kStageThreads, smem, s>>>(t, gh, gw, M, (int)band_cells, min_cos,
                                                     max_dist);
  else
    merge_block_kernel<<<B, (M + 31) / 32 * 32, smem, s>>>(t, gh, gw, M, (int)band_cells,
                                                           min_cos, max_dist);
  return (int)cudaGetLastError();
}

}  // extern "C"
