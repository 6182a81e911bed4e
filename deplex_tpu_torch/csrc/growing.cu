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
// What bounds it on the H100: latency. Its bytes (9 a cell in, 4 out) take
// under a microsecond at B=64; the time is 40-100 dependent rounds a frame,
// each a chain of dependent steps, so the design keeps each step short:
//   * The rounds are one warp's (every step warp-synchronous, no block
//     barrier); 16 warps stage the frame first.
//   * Bit planes, ceil(gw/64) 64-bit words a row: the unassigned set U and
//     the four "can be entered from" masks (ops/growing.py:pack_edges;
//     border bits are dropped: admissibility_edges makes them False).
//   * The fill is bit-parallel, the TPU kernel's masked shift flood
//     (pallas_growing.py:_shift) in bits and registers. Lane l owns a band of
//     ceil(gh/32) rows (in registers for grids up to 64 x 64). Within a row or a column the closure of a set is the set, its
//     runs entered one way and its runs entered the other way, so both
//     directions run side by side: rows with the carry trick
//     ((m + s) ^ m) & m | s (bit-reversed for leftwards, carries crossing
//     words), columns as the scan D_r = A_r | (M_r & D_{r-1}) over each
//     lane's band plus a 5-step shuffle scan across lanes. Rows and columns
//     alternate until nothing changes: the count of passes follows the
//     region's turns, not its size. Directed reachability is unique, so any
//     fill order gives the twin's region.
//   * The seed needs no scan of the frame: the counted cells are bucketed by
//     bin once; a round scans only the dominant bin's list for the least
//     (mse, cell) with two warp reductions, and compacts consumed cells out
//     of it. The twin's argmin fallbacks (no candidate, or none with a
//     finite mse; non-finite values ordered as dplx::better_min orders
//     them) take one scan of the frame, only on such rounds.
//   * A region is consumed by the whole warp: its cells are listed a word at
//     a time (each lane places two bits by popcount rank), then walked 32 a
//     step: round_map is stored, the cell's bin entry turns -1 and the bin
//     counts drop a run of equal bins at a time. The histogram stays exact
//     (int counts in shared memory, argmax as two warp reductions, first
//     max wins).
// Where a frame's arrays do not fit in shared memory (over 65,535 cells, or
// 227 KB), the same code runs on a workspace in global memory that the
// caller allocates (dplx_grow_rounds_scratch_bytes).
#include <type_traits>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

// Bits of the packed edge byte (ops/growing.py:pack_edges).
constexpr uint8_t kFromUp = 1, kFromDown = 2, kFromLeft = 4, kFromRight = 8,
                  kPlanar = 16;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kThreads = 512;           // 16 warps stage; warp 0 runs the rounds

// Planes: U, enter-from-left, -right, -up, -down, active.
enum { kU, kFromL, kFromR, kFromU, kFromD, kA, kPlanes };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// One frame's workspace, in bytes. Compact (shared memory): int16 bins,
// uint16 list and region entries and a staged copy of mse. Otherwise
// (global memory): int32 bins and entries, mse read in place.
struct Layout {
  size_t words, hist, start, len, mse, list, bins, cells, total;
  __host__ __device__ Layout(int gh, int gw, int nb2, bool compact) {
    const size_t n = (size_t)gh * gw;
    words = (size_t)gh * ((gw + 63) / 64);
    hist = align16(kPlanes * words * sizeof(u64));
    start = hist + align16((size_t)nb2 * 4);
    len = start + align16((size_t)nb2 * 4);
    mse = len + align16((size_t)nb2 * 4);
    list = mse + (compact ? align16(n * 4) : 0);
    bins = list + align16(n * (compact ? 2 : 4));
    cells = bins + align16(n * (compact ? 2 : 4));
    total = cells + align16(n * (compact ? 2 : 4));
  }
};

__host__ __device__ inline bool fits_shared(int gh, int gw, int nb2) {
  return (long long)gh * gw <= 65535 && nb2 <= 32767 &&
         Layout(gh, gw, nb2, true).total <= (size_t)kSmemLimit;
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(dplx::kFullMask, v); }

// A float's bits as an unsigned key in the float order (-0 as +0), and
// 0xffffffff for +inf and NaN: dplx::better_min never takes a NaN, and a
// +inf candidate ties with the non-candidates (the twin's fallbacks).
__device__ __forceinline__ unsigned order_key(float v) {
  if (!(v < INFINITY)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Cells of the runs of m entered from the active cells just below them:
// s are the first cells entered (s within m).
__device__ __forceinline__ u64 run_fill(u64 m, u64 s) { return (((m + s) ^ m) & m) | s; }

// The exclusive scans across the lanes, down (lanes in row order) and up,
// side by side, of the band transfers (a, m): (a1, m1) then (a2, m2) is
// (a2 | (m2 & a1), m2 & m1). Returns what enters each lane's band.
__device__ __forceinline__ void band_scans(u64 da, u64 dm, u64 ua, u64 um, int lane,
                                           u64& into_down, u64& into_up) {
  for (int off = 1; off < 32; off <<= 1) {
    const u64 dap = __shfl_up_sync(dplx::kFullMask, da, off);
    const u64 dmp = __shfl_up_sync(dplx::kFullMask, dm, off);
    const u64 uap = __shfl_down_sync(dplx::kFullMask, ua, off);
    const u64 ump = __shfl_down_sync(dplx::kFullMask, um, off);
    if (lane >= off) {
      da |= dm & dap;
      dm &= dmp;
    }
    if (lane + off < 32) {
      ua |= um & uap;
      um &= ump;
    }
  }
  const u64 d = __shfl_up_sync(dplx::kFullMask, da, 1);
  const u64 u = __shfl_down_sync(dplx::kFullMask, ua, 1);
  into_down = lane == 0 ? 0ull : d;
  into_up = lane == 31 ? 0ull : u;
}

// The bit planes of one lane's band of rows [r0, r1), W words a row, in
// shared or global memory. plane(k) is plane k of the frame.
struct MemBand {
  u64* planes;
  size_t words;
  int W, r0, r1, lane;

  __device__ u64* plane(int k) const { return planes + k * words; }
  __device__ int rows() const { return r1 - r0; }

  // Horizontal closure of the band's rows. Returns whether a bit was added.
  __device__ bool close_rows() {
    bool changed = false;
    u64 *A = plane(kA), *U = plane(kU), *fl = plane(kFromL), *fr = plane(kFromR);
    for (int r = r0; r < r1; ++r) {
      const size_t row = (size_t)r * W;
      u64 carry = 0;
      for (int w = 0; w < W; ++w) {                  // rightwards
        const u64 x = A[row + w], m = fl[row + w] & U[row + w];
        const u64 nx = x | run_fill(m, ((x << 1) | carry) & m);
        carry = nx >> 63;
        if (nx != x) { A[row + w] = nx; changed = true; }
      }
      carry = 0;
      for (int w = W - 1; w >= 0; --w) {             // leftwards, bit-reversed
        const u64 x = A[row + w], xr = __brevll(x), m = __brevll(fr[row + w] & U[row + w]);
        const u64 nr = xr | run_fill(m, ((xr << 1) | carry) & m);
        carry = nr >> 63;
        if (nr != xr) { A[row + w] = __brevll(nr); changed = true; }
      }
    }
    return changed;
  }

  // Vertical closure, down and up side by side. Returns whether a bit was added.
  __device__ bool close_columns() {
    u64 *A = plane(kA), *U = plane(kU), *fu = plane(kFromU), *fd = plane(kFromD);
    bool changed = false;
    for (int w = 0; w < W; ++w) {
      u64 da = 0, dm = ~0ull, ua = 0, um = ~0ull;   // the band's transfers
      for (int k = 0; k < r1 - r0; ++k) {
        const size_t i = (size_t)(r0 + k) * W + w, j = (size_t)(r1 - 1 - k) * W + w;
        const u64 md = fu[i] & U[i], mu = fd[j] & U[j];
        da = A[i] | (md & da);
        dm &= md;
        ua = A[j] | (mu & ua);
        um &= mu;
      }
      u64 d, u;
      band_scans(da, dm, ua, um, lane, d, u);
      for (int k = 0; k < r1 - r0; ++k) {
        const size_t i = (size_t)(r0 + k) * W + w;
        const u64 a = A[i], nd = a | (fu[i] & U[i] & d);
        if (nd != a) { A[i] = nd; changed = true; }
        d = nd;
      }
      for (int k = r1 - r0 - 1; k >= 0; --k) {
        const size_t i = (size_t)(r0 + k) * W + w;
        const u64 a = A[i], nu = a | (fd[i] & U[i] & u);
        if (nu != a) { A[i] = nu; changed = true; }
        u = nu;
      }
    }
    return changed;
  }

  __device__ u64 active(int k, int w) const { return plane(kA)[(size_t)(r0 + k) * W + w]; }
  __device__ void retire(int k, int w) {
    const size_t i = (size_t)(r0 + k) * W + w;
    plane(kU)[i] &= ~plane(kA)[i];
    plane(kA)[i] = 0;
  }
  // Whether cell (r, col) is unassigned; if so, the lane that owns row r
  // makes it the only active cell. Every lane calls it.
  __device__ bool seed(int r, int col, int band) {
    const size_t i = (size_t)r * W + (col >> 6);
    const bool live = (plane(kU)[i] >> (col & 63)) & 1ull;
    if (live && lane == r / band) plane(kA)[i] = 1ull << (col & 63);
    return live;
  }
};

// The same band held in registers: one word a row (gw <= 64), at most KB
// rows a lane (gh <= 32 * KB). U is mirrored to the shared plane, which the
// seed scan reads.
template <int KB>
struct RegBand {
  u64 U[KB], from_left[KB], from_right[KB], from_up[KB], from_down[KB], A[KB];
  u64* shared_u;
  int n, r0, lane;

  __device__ explicit RegBand(const MemBand& m)
      : shared_u(m.plane(kU)), n(m.rows()), r0(m.r0), lane(m.lane) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const bool in = k < n;
      const size_t i = (size_t)(r0 + k);
      U[k] = in ? m.plane(kU)[i] : 0;
      from_left[k] = in ? m.plane(kFromL)[i] : 0;
      from_right[k] = in ? m.plane(kFromR)[i] : 0;
      from_up[k] = in ? m.plane(kFromU)[i] : 0;
      from_down[k] = in ? m.plane(kFromD)[i] : 0;
      A[k] = 0;
    }
  }

  __device__ int rows() const { return n; }

  __device__ bool close_rows() {
    bool changed = false;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const u64 x = A[k], m = from_left[k] & U[k];
      const u64 xr = __brevll(x), mr = __brevll(from_right[k] & U[k]);
      const u64 nx = x | run_fill(m, (x << 1) & m) | __brevll(run_fill(mr, (xr << 1) & mr));
      changed |= nx != x;
      A[k] = nx;
    }
    return changed;
  }

  __device__ bool close_columns() {
    u64 da = 0, dm = ~0ull, ua = 0, um = ~0ull;     // the band's transfers
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t < n) {
        const u64 m = from_up[t] & U[t];
        da = A[t] | (m & da);
        dm &= m;
      }
      const int k = KB - 1 - t;
      if (k < n) {
        const u64 m = from_down[k] & U[k];
        ua = A[k] | (m & ua);
        um &= m;
      }
    }
    u64 dd, du;
    band_scans(da, dm, ua, um, lane, dd, du);
    u64 down[KB];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t < n) {
        down[t] = A[t] | (from_up[t] & U[t] & dd);
        dd = down[t];
      }
    }
    bool changed = false;
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const int k = KB - 1 - t;
      if (k < n) {
        const u64 up = A[k] | (from_down[k] & U[k] & du);
        du = up;
        const u64 nx = down[k] | up;
        changed |= nx != A[k];
        A[k] = nx;
      }
    }
    return changed;
  }

  __device__ u64 active(int k, int) const {
    u64 a = 0;
#pragma unroll
    for (int t = 0; t < KB; ++t) if (t == k) a = A[t];
    return a;
  }
  __device__ void retire(int k, int) {
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t == k) {
        U[t] &= ~A[t];
        A[t] = 0;
        shared_u[r0 + t] = U[t];
      }
    }
  }
  __device__ bool seed(int r, int col, int band) {
    const int owner = r / band, k = r - owner * band;
    const bool live = (shared_u[r] >> col) & 1ull;
    if (live && lane == owner) {
#pragma unroll
      for (int t = 0; t < KB; ++t) if (t == k) A[t] = 1ull << col;
    }
    return live;
  }
};

// What one frame's rounds loop works on.
template <typename bin_t, typename idx_t>
struct Frame {
  int gh, gw, W, N, nb2, band, r_max, min_cand, lane;
  int *hist, *start, *len;
  idx_t* list;
  idx_t* cells;         // the current region's cells
  bin_t* bins;          // counted bin of each unassigned cell, else -1
  const float* mse;
  int* round_map;
  int* seeds;
  // DPLX_PROFILE builds: cycles of argmax, seed, fill and consume, closure
  // passes, list entries scanned, rounds, and the staging's cycles.
  long long* profile;
};

#ifdef DPLX_PROFILE
#define DPLX_MARK(slot)                                   \
  do {                                                    \
    const long long now = clock64();                      \
    prof[slot] += now - mark;                             \
    mark = now;                                           \
  } while (0)
#else
#define DPLX_MARK(slot) do {} while (0)
#endif

// The rounds of one frame; returns the number of rounds.
template <class Band, typename bin_t, typename idx_t>
__device__ int rounds_loop(Band& p, const Frame<bin_t, idx_t>& f, int remaining) {
  const int lane = f.lane;
#ifdef DPLX_PROFILE
  long long prof[7] = {0, 0, 0, 0, 0, 0, 0};
  long long mark = clock64();
#endif
  int round = 0;
  while (remaining > 0 && round < f.r_max) {
    // Dominant bin (largest count, first bin on ties); counts are >= 0.
    int bv = -1, bi = INT_MAX;
    for (int i0 = 0; i0 < f.nb2; i0 += 512) {       // 16 loads in flight
      int v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + 32 * u + lane;
        v[u] = i < f.nb2 ? f.hist[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (v[u] > bv) { bv = v[u]; bi = i0 + 32 * u + lane; }
    }
    const int top = __reduce_max_sync(dplx::kFullMask, bv);
    const int mf = (int)__reduce_min_sync(dplx::kFullMask, bv == top ? (unsigned)bi : ~0u);
    const bool stop = top < f.min_cand;
    DPLX_MARK(0);

    // Seed: least (mse, cell) of the bin's unassigned cells; the list drops
    // the cells consumed since its last scan. Four chunks of 32 a step.
    unsigned mk = ~0u, mc = ~0u;
    if (top > 0) {
      idx_t* seg = f.list + f.start[mf];
      const int n = f.len[mf];
      int kept = 0;
      for (int j0 = 0; j0 < n; j0 += 128) {
        int c[4];
        bool live[4];
        float m[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          c[u] = j < n ? (int)seg[j] : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          live[u] = c[u] >= 0 && f.bins[c[u]] == mf;
          m[u] = c[u] >= 0 ? f.mse[c[u]] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned bal = __ballot_sync(dplx::kFullMask, live[u]);
          if (live[u]) {
            seg[kept + __popc(bal & ((1u << lane) - 1u))] = (idx_t)c[u];
            const unsigned key = order_key(m[u]);
            if (key < mk || (key == mk && (unsigned)c[u] < mc)) {
              mk = key;
              mc = (unsigned)c[u];
            }
          }
          kept += __popc(bal);
        }
      }
      if (lane == 0) f.len[mf] = kept;
      const unsigned best = __reduce_min_sync(dplx::kFullMask, mk);
      mc = __reduce_min_sync(dplx::kFullMask, mk == best ? mc : ~0u);
      mk = best;
#ifdef DPLX_PROFILE
      prof[5] += n;
#endif
    }
    int mi = (int)mc;
    if (mk == ~0u) {
      // The twin's argmin over where(candidate, mse, inf) without a finite
      // candidate: the first cell whose value is +inf.
      mi = INT_MAX;
      for (int c0 = 0; c0 < f.N; c0 += 32) {
        const int c = c0 + lane;
        bool inf = false;
        if (c < f.N) inf = f.bins[c] == mf ? f.mse[c] == INFINITY : true;
        const unsigned bal = __ballot_sync(dplx::kFullMask, inf);
        if (bal) { mi = c0 + __ffs(bal) - 1; break; }
      }
    }
    if (lane == 0) f.seeds[round] = mi;
    DPLX_MARK(1);
    if (stop) {
      ++round;
      break;
    }

    // Fill from the seed, if it is live: alternate the closures.
    const int sr = mi < f.N ? mi / f.gw : 0;
    const bool live = mi < f.N && p.seed(sr, mi - sr * f.gw, f.band);
    if (live) {
      for (bool first = true;; first = false) {
#ifdef DPLX_PROFILE
        prof[4] += 1;
#endif
        const bool h = __any_sync(dplx::kFullMask, p.close_rows());
        if (!h && !first) break;
        if (!__any_sync(dplx::kFullMask, p.close_columns())) break;
      }
    }
    DPLX_MARK(2);

    // Consume the region. First the warp lists its cells, a nonzero word at
    // a time (lane l places bits l and l + 32 by their rank in the word, no
    // loads), then walks the list 32 cells a step: round_map is stored, the
    // cell's bin entry turns -1 (the twin's live_bins), and each lane
    // decrements the bin counts a run of equal bins at a time.
    int taken = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int k = 0; k < f.band; ++k) {
      for (int w = 0; w < f.W; ++w) {
        const u64 a = k < p.rows() ? p.active(k, w) : 0ull;
        for (unsigned has = __ballot_sync(dplx::kFullMask, a != 0); has; has &= has - 1) {
          const int j = __ffs(has) - 1;
          const u64 word = __shfl_sync(dplx::kFullMask, a, j);
          const unsigned lo = (unsigned)word, hi = (unsigned)(word >> 32);
          const int base = (j * f.band + k) * f.gw + w * 64;
          if ((lo >> lane) & 1u) f.cells[taken + __popc(lo & below)] = (idx_t)(base + lane);
          if ((hi >> lane) & 1u)
            f.cells[taken + __popc(lo) + __popc(hi & below)] = (idx_t)(base + 32 + lane);
          taken += __popcll(word);
        }
        if (k < p.rows()) p.retire(k, w);
      }
    }
    __syncwarp();
    int run_bin = -1, run = 0;
    for (int i0 = 0; i0 < taken; i0 += 128) {      // four cells a lane in flight
      int c[4], bn[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        c[u] = i < taken ? (int)f.cells[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) bn[u] = c[u] >= 0 ? (int)f.bins[c[u]] : -1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c[u] < 0) continue;
        f.round_map[c[u]] = round;
        if (bn[u] < 0) continue;
        f.bins[c[u]] = (bin_t)-1;
        if (bn[u] != run_bin) {
          if (run) atomicSub(&f.hist[run_bin], run);
          run_bin = bn[u];
          run = 0;
        }
        ++run;
      }
    }
    // The last runs: one atomic where every lane's run is of one bin.
    const int lo = __reduce_min_sync(dplx::kFullMask, run ? run_bin : INT_MAX);
    const int hi = __reduce_max_sync(dplx::kFullMask, run ? run_bin : -1);
    if (lo == hi) {
      const int total = __reduce_add_sync(dplx::kFullMask, run);
      if (lane == 0) atomicSub(&f.hist[lo], total);
    } else if (run) {
      atomicSub(&f.hist[run_bin], run);
    }
    remaining -= taken;
    ++round;
    __syncwarp();
    DPLX_MARK(3);
  }
#ifdef DPLX_PROFILE
  prof[6] = round;
  if (lane == 0)
    for (int k = 0; k < 7; ++k) f.profile[k] = prof[k];
#endif
  return round;
}

template <bool kCompact, int KB>
__global__ void __launch_bounds__(kThreads)
grow_rounds_kernel(const int* __restrict__ bins_in, const float* __restrict__ mse_in,
                   const uint8_t* __restrict__ edges_in, int gh, int gw, int nb2,
                   int r_max, int min_cand, int* __restrict__ round_map,
                   int* __restrict__ seeds, int* __restrict__ nr_rounds,
                   unsigned char* __restrict__ scratch) {
  using bin_t = typename std::conditional<kCompact, int16_t, int>::type;
  using idx_t = typename std::conditional<kCompact, uint16_t, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_planar;
#ifdef DPLX_PROFILE
  const long long t0 = clock64();
#endif
  const int N = gh * gw, W = (gw + 63) / 64, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const Layout L(gh, gw, nb2, kCompact);
  unsigned char* ws = kCompact ? smem : scratch + (size_t)b * L.total;
  u64* planes = reinterpret_cast<u64*>(ws);
  const size_t words = L.words;
  int* hist = reinterpret_cast<int*>(ws + L.hist);
  int* start = reinterpret_cast<int*>(ws + L.start);
  int* len = reinterpret_cast<int*>(ws + L.len);
  idx_t* list = reinterpret_cast<idx_t*>(ws + L.list);
  bin_t* bins = reinterpret_cast<bin_t*>(ws + L.bins);
  bins_in += (size_t)b * N;
  mse_in += (size_t)b * N;
  edges_in += (size_t)b * N;
  round_map += (size_t)b * N;
  seeds += (size_t)b * r_max;
  float* mse_s = reinterpret_cast<float*>(ws + L.mse);
  const float* mse = kCompact ? mse_s : mse_in;
  // The edge bytes pass through the list's space before the lists exist.
  uint8_t* edges_s = reinterpret_cast<uint8_t*>(list);
  const uint8_t* edges = kCompact ? edges_s : edges_in;

  // 1. Stage the frame and count the histogram (the cells of one bin in a
  //    warp add with one atomic).
  for (int i = tid; i < nb2; i += kThreads) hist[i] = 0;
  for (int r = tid; r < r_max; r += kThreads) seeds[r] = N;
  if (tid == 0) s_planar = 0;
  __syncthreads();
  int planar = 0;
  constexpr int kBatch = 4;               // chunks of 32 cells whose loads overlap
  for (int c0 = warp * 32; c0 < N; c0 += kThreads * kBatch) {
    uint8_t e[kBatch];
    int bn[kBatch];
    float m[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + lane;
      e[u] = c < N ? edges_in[c] : 0;
      bn[u] = c < N ? bins_in[c] : -1;
      m[u] = c < N && kCompact ? mse_in[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + lane;
      const bool pl = e[u] & kPlanar;
      const int key = pl && bn[u] >= 0 && bn[u] < nb2 ? bn[u] : -1;
      if (c < N) {
        round_map[c] = -1;
        bins[c] = (bin_t)key;
        if (kCompact) {
          edges_s[c] = e[u];
          mse_s[c] = m[u];
        }
      }
      planar += pl;
      const unsigned peers = __match_any_sync(dplx::kFullMask, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
    }
  }
  planar = warp_sum(planar);
  if (lane == 0) atomicAdd(&s_planar, planar);
  __syncthreads();

  // 2. The bit planes (border bits of the edge masks dropped); a warp a row.
  for (int r = warp; r < gh; r += kWarps) {
    for (int w = 0; w < W; ++w) {
      u64 bits[kPlanes] = {};
      for (int half = 0; half < 2; ++half) {
        if (w * 64 + half * 32 >= gw) break;
        const int col = w * 64 + half * 32 + lane;
        uint8_t e = col < gw ? edges[(size_t)r * gw + col] : 0;
        if (r == 0) e &= ~kFromUp;
        if (r == gh - 1) e &= ~kFromDown;
        if (col == 0) e &= ~kFromLeft;
        if (col == gw - 1) e &= ~kFromRight;
        const int shift = 32 * half;
        bits[kU] |= (u64)__ballot_sync(dplx::kFullMask, e & kPlanar) << shift;
        bits[kFromL] |= (u64)__ballot_sync(dplx::kFullMask, e & kFromLeft) << shift;
        bits[kFromR] |= (u64)__ballot_sync(dplx::kFullMask, e & kFromRight) << shift;
        bits[kFromU] |= (u64)__ballot_sync(dplx::kFullMask, e & kFromUp) << shift;
        bits[kFromD] |= (u64)__ballot_sync(dplx::kFullMask, e & kFromDown) << shift;
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k)      // A (all zero) included
        if (lane == k) planes[k * words + (size_t)r * W + w] = bits[k];
    }
  }
  __syncthreads();

  // 3. A list per bin of its counted cells: exclusive scan of the counts.
  if (warp == 0) {
    const int per = (nb2 + 31) / 32, lo = min(nb2, lane * per), hi = min(nb2, lo + per);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += hist[i];
    int incl = s;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(dplx::kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - s;
    for (int i = lo; i < hi; ++i) {
      start[i] = run;
      run += hist[i];
      len[i] = 0;
    }
  }
  __syncthreads();
  for (int c0 = warp * 32; c0 < N; c0 += kThreads) {
    const int c = c0 + lane;
    const int key = c < N ? (int)bins[c] : -1;
    const unsigned peers = __match_any_sync(dplx::kFullMask, key);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (key >= 0 && lane == leader) at = atomicAdd(&len[key], __popc(peers));
    at = __shfl_sync(dplx::kFullMask, at, leader);
    if (key >= 0) list[start[key] + at + __popc(peers & ((1u << lane) - 1u))] = (idx_t)c;
  }
  __syncthreads();
  if (warp != 0) return;   // the rounds are one warp's

  // 4. The rounds.
  long long* profile = nullptr;
#ifdef DPLX_PROFILE
  profile = reinterpret_cast<long long*>(scratch) + (size_t)b * 8;
  if (lane == 0) profile[7] = clock64() - t0;
#endif
  const int band = (gh + 31) / 32;
  const int r0 = min(gh, lane * band), r1 = min(gh, r0 + band);
  const MemBand mem{planes, words, W, r0, r1, lane};
  const Frame<bin_t, idx_t> f{gh, gw, W, N, nb2, band, r_max, min_cand, lane, hist,
                              start, len, list, reinterpret_cast<idx_t*>(ws + L.cells),
                              bins, mse, round_map, seeds, profile};
  int rounds;
  if constexpr (KB > 0) {
    RegBand<KB> reg(mem);
    rounds = rounds_loop(reg, f, s_planar);
  } else {
    MemBand band_planes = mem;
    rounds = rounds_loop(band_planes, f, s_planar);
  }
  if (lane == 0) nr_rounds[b] = rounds;
}

}  // namespace

extern "C" {

// Bytes of global workspace dplx_grow_rounds needs for B frames: 0 where a
// frame fits in shared memory.
long long dplx_grow_rounds_scratch_bytes(int B, int gh, int gw, int nb2) {
  if (fits_shared(gh, gw, nb2)) return 0;
  return (long long)B * (long long)Layout(gh, gw, nb2, false).total;
}

// bins (B, gh*gw) int32; mse (B, gh*gw) float32; edges (B, gh*gw) uint8
// packed as ops/growing.py:pack_edges; round_map (B, gh*gw) int32;
// seeds (B, r_max) int32; nr_rounds (B,) int32; scratch: the bytes that
// dplx_grow_rounds_scratch_bytes asks for (may be null when it asks none).
int dplx_grow_rounds(const void* bins, const void* mse, const void* edges,
                     int B, int gh, int gw, int nb2, int r_max, int min_cand,
                     void* round_map, void* seeds, void* nr_rounds, void* scratch,
                     void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (gh <= 0 || gw <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bi = static_cast<const int*>(bins);
  const float* ms = static_cast<const float*>(mse);
  const uint8_t* ed = static_cast<const uint8_t*>(edges);
  int* rm = static_cast<int*>(round_map);
  int* sd = static_cast<int*>(seeds);
  int* nr = static_cast<int*>(nr_rounds);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (!fits_shared(gh, gw, nb2)) {
    grow_rounds_kernel<false, 0><<<B, kThreads, 0, st>>>(bi, ms, ed, gh, gw, nb2, r_max,
                                                         min_cand, rm, sd, nr, sc);
    return (int)cudaGetLastError();
  }
  // Grids up to 64 x 64 cells (TUM's 48 x 64 at P=10) keep their band of
  // rows in registers.
  auto kernel = gw <= 64 && gh <= 64 ? grow_rounds_kernel<true, 2>
                                     : grow_rounds_kernel<true, 0>;
  const size_t smem = Layout(gh, gw, nb2, true).total;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, kThreads, smem, st>>>(bi, ms, ed, gh, gw, nb2, r_max, min_cand, rm, sd, nr, sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
