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
// each a chain of dependent steps, so the design keeps each step short and
// moves what it can off the chain into the staging:
//   * The rounds are one warp's (every step warp-synchronous, no block
//     barrier; wide grids: see the last point); 16 warps stage the frame
//     first.
//   * Bit planes, ceil(gw/64) 64-bit words a row: the unassigned set U and
//     the four "can be entered from" masks (ops/growing.py:pack_edges;
//     border bits are dropped: admissibility_edges makes them False).
//     U is the only liveness a round reads; the bins are read-only.
//   * The fill is bit-parallel, the TPU kernel's masked shift flood
//     (pallas_growing.py:_shift) in bits and registers. Lane l owns a band of
//     ceil(gh/32) rows (in registers for grids up to 64 x 64). Within a row
//     or a column the closure of a set is the set, its runs entered one way
//     and its runs entered the other way, so both directions run side by
//     side: rows with the carry trick
//     ((m + s) ^ m) & m | s (bit-reversed for leftwards, carries crossing
//     words), columns as the scan D_r = A_r | (M_r & D_{r-1}) over each
//     lane's band plus a 5-step shuffle scan across lanes. Rows and columns
//     alternate until nothing changes: the count of passes follows the
//     region's turns, not its size. Directed reachability is unique, so any
//     fill order gives the twin's region.
//   * The seed reads a head: the staging sorts each bin's counted cells by
//     (seed_key(mse), cell) once, so the least live candidate of a bin is
//     its first entry at or past the bin's head that U holds. A round reads
//     32 entries at the head, takes the first live one by ballot and moves
//     the head past the dead prefix. Keys order as the twin's argmin over
//     where(candidate, mse, inf) does: NaN first, -0 as +0, +inf last; the
//     entries from the bin's `fin` on are +inf. A bin with no live entry
//     before its fin seeds at cell 0, the twin's argmin over a row of +inf.
//     The sort: where the bins are small (TUM's), each cell's place is the
//     count of its bin's cells before it, by comparisons; else a stable LSD
//     radix sort of the block: 8 bits a pass over the key's bytes that the
//     counted cells differ in, then the bin in one pass (up to 512 bins).
//     An entry's rank among its warp's lanes of the same digit comes from a
//     shared-memory bitmap for the digit's low 5 bits and a ballot for each
//     bit above: a ballot costs the H100 about 3.6 SM cycles a warp, so 8
//     of them bound a pass that the bitmap's three shared-memory accesses
//     do not.
//   * A region is consumed a nonzero word at a time: the word is broadcast,
//     lane l takes bits l and l + 32, stores their round_map (coalesced) and
//     drops each counted cell from its bin's count with a shared atomic that
//     nothing on the chain waits for. Nothing per cell is written to shared
//     memory: U loses the region's bits, and the histogram stays exact (int
//     counts in shared memory, argmax as two warp reductions, first max
//     wins).
//   * Grids past the register band (gw or gh over 64) with rows of 3 words
//     (129-192 cells: ICL's 120 x 160 at P=4, 720p's 90 x 160 at P=8) run
//     their rounds on ceil(gh/32) warps instead, one row a lane, its masks
//     and A in registers (rows_loop): a column's closure is each warp's
//     shuffle scan, the warps' transfers joined through shared memory
//     across a barrier of the rounds warps (bar.red on barrier 1); every
//     warp finds the bin and the seed itself, and the region's words are
//     consumed spread over the warps.
// Where a frame's arrays do not fit in shared memory (over 65,535 cells, or
// 227 KB), the same code runs on a workspace in global memory that the
// caller allocates (dplx_grow_rounds_scratch_bytes); the sort's counters and
// bitmaps stay in shared memory.
// Counters: where the caller passes them, each frame adds 1, its rounds, 1
// if its staging took the radix sort, 1 if its rounds ran one row a lane
// and its radix sort's passes to five int64s in global memory
// (kCounterSlots), with no launch of its
// own, so a recorded graph adds them at every replay. The first warp past
// the rounds warps adds the frame, the sort, its passes and the band as it
// leaves after the staging, lane 0 of warp 0 the rounds when they end: the
// rounds warps
// then keep nothing more live through their rounds (holding the sort's flag
// there slowed the memory-band rounds 2% at ICL's 120 x 160, the rounds'
// count alone 0.2%).
#include <type_traits>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

// Bits of the packed edge byte (ops/growing.py:pack_edges).
constexpr uint8_t kFromUp = 1, kFromDown = 2, kFromLeft = 4, kFromRight = 8,
                  kPlanar = 16;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kThreads = 512;           // 16 warps stage; warp 0 (or rows_loop's) runs the rounds
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;            // the sort's radix, 8 bits a pass
// The bins that the sort takes in one pass (nb2 digits, a bin's entries
// written from its head), where kWarps counters a bin fit the sort's space.
constexpr int kBinDigits = 512;
// The rank's bitmaps: a word a warp and value of a digit's low kMapBits
// bits, after the frame's arrays in shared memory where 2 KB are left
// there (else ballots alone rank). Five bits are as fast as eight on ICL's
// frames on the H100, in an eighth of the memory.
constexpr int kMapBits = 5;
constexpr int kMapBytes = (kWarps << kMapBits) * 4;
// The staging's scratch ints at the end of the sort's space: the radix
// sort's block scan (kWarps), the planar and counted cells, the squared bin
// counts (two ints), the OR and the AND of the counted cells' seed keys.
constexpr int kSortScratch = 32 * 4;
enum { kNPlanar = kWarps, kNCounted, kSquares, kKeyOr = kSquares + 2, kKeyAnd };
// The counters' slots: frames, rounds, frames whose staging took the radix
// sort, frames whose rounds ran one row a lane (rows_loop), the radix
// sort's passes.
constexpr int kCounterSlots = 5;
// The width in words of the rows that run one row a lane (rows_loop): that
// of every configuration past the register band. Other widths take the
// memory band, which spares the build an instantiation a width. Such grids
// have at most 32 * kWarps rows.
constexpr int kRowsWords = 3;

// Planes: U, enter-from-left, -right, -up, -down, active.
enum { kU, kFromL, kFromR, kFromU, kFromD, kA, kPlanes };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of the sort's counters (a count a digit and warp) and its scratch:
// compact, the floor of the bit planes' space that they share (256 digits);
// on the global workspace, the launch's, sized for a one-pass bin sort.
__host__ __device__ inline size_t sort_bytes(bool compact, int nb2) {
  const int digits = !compact && nb2 > kDigits && nb2 <= kBinDigits ? nb2 : kDigits;
  return (size_t)digits * kWarps * (compact ? 2 : 4) + kSortScratch;
}

// One frame's workspace, in bytes. Compact (shared memory): int16 bins,
// uint16 list entries and heads, and the keys; the sort's counters share
// the bit planes' space, which is written after the sort. Otherwise (global
// memory): int32 bins, entries and heads, keys computed from mse in place,
// the counters in shared memory.
struct Layout {
  size_t words, hist, head, fin, keys, list, bins, buf, total;
  __host__ __device__ Layout(int gh, int gw, int nb2, bool compact) {
    const size_t n = (size_t)gh * gw, idx = compact ? 2 : 4;
    words = (size_t)gh * ((gw + 63) / 64);
    const size_t planes = align16(kPlanes * words * sizeof(u64));
    hist = compact && planes < sort_bytes(true, nb2) ? align16(sort_bytes(true, nb2)) : planes;
    head = hist + align16((size_t)nb2 * 4);
    fin = head + align16((size_t)nb2 * idx);
    keys = fin + align16((size_t)nb2 * idx);
    list = keys + (compact ? align16(n * 4) : 0);
    bins = list + align16(n * idx);
    buf = bins + align16(n * idx);
    total = buf + align16(n * idx);
  }
};

__host__ __device__ inline bool fits_shared(int gh, int gw, int nb2) {
  return (long long)gh * gw <= 65535 && nb2 <= 32767 &&
         Layout(gh, gw, nb2, true).total <= (size_t)kSmemLimit;
}

// Whether the sort ranks with bitmaps: on the global workspace always, in
// shared memory where kMapBytes are left after the frame's arrays.
__host__ __device__ inline bool rank_maps(int gh, int gw, int nb2) {
  return !fits_shared(gh, gw, nb2) ||
         Layout(gh, gw, nb2, true).total + kMapBytes <= (size_t)kSmemLimit;
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(dplx::kFullMask, v); }

// A candidate's MSE as an unsigned key in the order of the twin's argmin
// over where(candidate, mse, inf) (torch.argmin takes a NaN first): NaN 0,
// then the floats in order with -0 as +0, then +inf 0xffffffff, which ties
// with the non-candidates.
__device__ __forceinline__ unsigned seed_key(float v) {
  if (v != v) return 0u;
  if (v == INFINITY) return 0xffffffffu;
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
  static constexpr int kMaxRows = 0;    // the band's rows are known at run time
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
  __device__ bool seed(int r, int col, int owner) {
    const size_t i = (size_t)r * W + (col >> 6);
    const bool live = (plane(kU)[i] >> (col & 63)) & 1ull;
    if (live && lane == owner) plane(kA)[i] = 1ull << (col & 63);
    return live;
  }
};

// The same band held in registers: one word a row (gw <= 64), at most KB
// rows a lane (gh <= 32 * KB). U is mirrored to the shared plane, which the
// seed scan reads.
template <int KB>
struct RegBand {
  static constexpr int kMaxRows = KB;
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
  __device__ bool seed(int r, int col, int owner) {
    const bool live = (shared_u[r] >> col) & 1ull;
    if (live && lane == owner) {
#pragma unroll
      for (int t = 0; t < KB; ++t) if (t == r - r0) A[t] = 1ull << col;
    }
    return live;
  }
};

// What one frame's rounds loop works on.
template <typename bin_t, typename idx_t>
struct Frame {
  int gh, gw, W, N, nb2, band, r_max, min_cand, lane;
  int* hist;
  idx_t *head, *fin;    // each bin's first entry not known dead; its first +inf entry
  const idx_t* list;    // each bin's counted cells by (seed_key(mse), cell)
  const bin_t* bins;    // counted bin of each cell, else -1; read-only
  const u64* U;         // the unassigned plane
  unsigned row_magic, band_magic;   // c / gw and r / band as multiply-highs
  bool magic_rows;
  int* round_map;
  int* seeds;
  // DPLX_PROFILE builds: cycles of argmax, seed, fill and consume, closure
  // passes, list entries read from heads, rounds, the staging's cycles but
  // the sort's, the sort's, and rounds seeded from a head's first 32 entries.
  long long* profile;

  __device__ int row_of(int c) const {
    if constexpr (sizeof(idx_t) == 2)    // c * gw < 2^32 for every compact grid
      return gw == 1 ? c : (int)__umulhi((unsigned)c, row_magic);
    return magic_rows ? (int)__umulhi((unsigned)c, row_magic) : c / gw;
  }
  __device__ int lane_of(int r) const {
    return band == 1 ? r : (int)__umulhi((unsigned)r, band_magic);
  }
  __device__ bool live(int c) const {
    const int r = row_of(c), col = c - r * gw;
    return (U[(size_t)r * W + (col >> 6)] >> (col & 63)) & 1ull;
  }
};

constexpr int kProfileSlots = 10;

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
  constexpr int kRows = Band::kMaxRows;   // > 0: one word a row (gw <= 64)
  auto live = [&](int c) -> bool {       // whether cell c is unassigned
    if constexpr (kRows > 0) {
      const int r = f.row_of(c);
      return (f.U[r] >> (c - r * f.gw)) & 1ull;
    } else {
      return f.live(c);
    }
  };
#ifdef DPLX_PROFILE
  long long prof[kProfileSlots] = {};
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

    // Seed: the first live entry of the bin's sorted list before its +inf
    // entries, 32 a step from its head; the head moves past the dead ones.
    // Without one, cell 0: the twin's argmin over a row of +inf.
    int mi = 0;
    if (top > 0) {
      const int end = (int)f.fin[mf];
      int j = (int)f.head[mf];
      for (bool first = true; j < end; j += 32, first = false) {
        const int i = j + lane;
        const int c = (int)f.list[min(i, end - 1)];
        const unsigned bal = __ballot_sync(dplx::kFullMask, live(c) && i < end);
#ifdef DPLX_PROFILE
        prof[5] += min(32, end - j);
        if (bal && first) prof[9] += 1;
#endif
        if (bal) {
          const int k = __ffs(bal) - 1;
          mi = __shfl_sync(dplx::kFullMask, c, k);
          j += k;
          break;
        }
      }
      if (lane == 0) f.head[mf] = (idx_t)min(j, end);
    }
    if (lane == 0) f.seeds[round] = mi;
    DPLX_MARK(1);
    if (stop) {
      ++round;
      break;
    }

    // Fill from the seed, if it is live: alternate the closures.
    const int sr = f.row_of(mi);
    if (p.seed(sr, mi - sr * f.gw, f.lane_of(sr))) {
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

    // Consume the region a nonzero word at a time: the word is broadcast,
    // lane l takes its bits l and l + 32, stores their round_map and drops
    // each counted cell from its bin's count with a shared atomic (fire and
    // forget: the chain waits on none of them). The bins are read-only: U
    // alone says what is live.
    int taken = 0;
    auto take = [&](u64 word, int row, int col0) {   // a region word of row `row`
      taken += __popcll(word);
      const int c0 = row * f.gw + col0 + lane;
      const bool i0 = (word >> lane) & 1ull, i1 = (word >> (32 + lane)) & 1ull;
      const int b0 = i0 ? (int)f.bins[c0] : -1, b1 = i1 ? (int)f.bins[c0 + 32] : -1;
      if (i0) f.round_map[c0] = round;
      if (i1) f.round_map[c0 + 32] = round;
      if (b0 >= 0) atomicSub(&f.hist[b0], 1);
      if (b1 >= 0) atomicSub(&f.hist[b1], 1);
    };
    if constexpr (kRows > 0) {
      // The band's rows in registers, one word each: every row's ballot first.
      u64 a[kRows];
      unsigned has[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        a[k] = p.active(k, 0);
        has[k] = __ballot_sync(dplx::kFullMask, a[k] != 0);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        for (unsigned h = has[k]; h; h &= h - 1) {
          const int j = __ffs(h) - 1;
          take(__shfl_sync(dplx::kFullMask, a[k], j), j * f.band + k, 0);
        }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < p.rows()) p.retire(k, 0);
    } else {
      for (int k = 0; k < f.band; ++k) {
        for (int w = 0; w < f.W; ++w) {
          const u64 a = k < p.rows() ? p.active(k, w) : 0ull;
          for (unsigned has = __ballot_sync(dplx::kFullMask, a != 0); has; has &= has - 1) {
            const int j = __ffs(has) - 1;
            take(__shfl_sync(dplx::kFullMask, a, j), j * f.band + k, w * 64);
          }
          if (k < p.rows()) p.retire(k, w);
        }
      }
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
  if (lane == 0) f.profile[9] = prof[9];
#endif
  return round;
}

// Whether v holds in any of the first `threads` threads of the block (the
// rounds warps, a multiple of 32), which all wait for each other here: a
// bar.red on barrier 1 (barrier 0 is __syncthreads, which the warps that
// left after the staging never reach). Orders their shared-memory accesses.
__device__ __forceinline__ bool rounds_any(bool v, int threads) {
  unsigned r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"((unsigned)v), "r"(threads)
      : "memory");
  return r != 0;
}

// The rounds of one frame on nw = ceil(gh / 32) warps, one row a lane, kW
// words a row (gw <= 64 * kW): the lane of row r holds its words of the
// four masks (kept within U) and of A in registers; U stays in its shared
// plane, which the seed reads. Rows close in registers with the carry
// trick, both directions side by side. Columns close by each warp's
// shuffle scan of its 32 rows' transfers, every word and both directions
// interleaved; the warps' totals go to shared memory, and after a barrier
// of the nw warps each warp folds those of the warps above it (down) and
// below it (up). From the second pass on, a barrier before the scan says
// whether the pass's rows grew anywhere: once they did not, the region is
// closed. Every warp finds the dominant bin and the seed itself, from the
// histogram, the heads and U (warp 0 alone writes head and seeds: a head
// moved by another warp in the same round has skipped dead entries only,
// so every warp finds the same seed). The region's words are consumed as
// rounds_loop does, spread over the warps through a queue in shared
// memory, and the round ends at a barrier that makes the counts visible
// to the next argmax and says whether any cell is left. Returns the
// number of rounds.
template <int kW, typename bin_t, typename idx_t>
__device__ int rows_loop(const Frame<bin_t, idx_t>& f, u64* planes, size_t words, int nw,
                         int warp, int remaining) {
  const int lane = f.lane, row = warp * 32 + lane, threads = 32 * nw;
  u64 fl[kW], frr[kW], fu[kW], fd[kW], A[kW];   // frr: from-right, bit-reversed
  u64* const shared_u = planes + kU * words;       // U itself stays in shared memory
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const size_t i = (size_t)row * kW + w;
    const bool in = row < f.gh;
    const u64 u = in ? shared_u[i] : 0ull;
    fl[w] = in ? planes[kFromL * words + i] & u : 0ull;
    frr[w] = in ? __brevll(planes[kFromR * words + i] & u) : 0ull;
    fu[w] = in ? planes[kFromU * words + i] & u : 0ull;
    fd[w] = in ? planes[kFromD * words + i] & u : 0ull;
    A[w] = 0ull;
  }
  // The warps' column transfers, [down, up][word][warp] x (a, m), in the
  // masks' planes, which every warp has read once the barrier below is
  // passed. With the queue below they take 416 * kW * nw + 4 * nw bytes,
  // which the planes' space holds (40 bytes a row-word past U, or the
  // sort's 8,320 bytes where that is more).
  u64* const xfer = planes + kFromL * words;
  // The consume's queue beside them: a segment of 32 * kW entries a warp (a
  // word, the cell of its bit 0), and each segment's length.
  u64* const qword = xfer + 4 * kW * nw;
  int* const qtag = reinterpret_cast<int*>(qword + 32 * kW * nw);
  int* const qn = qtag + 32 * kW * nw;
  const bool half_last = f.gw - 64 * (kW - 1) <= 32;
  rounds_any(true, threads);
#ifdef DPLX_PROFILE
  long long prof[kProfileSlots] = {};
  long long mark = clock64();
#endif
  int round = 0;
  while (remaining && round < f.r_max) {
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

    // Seed: as rounds_loop's, 64 entries a step.
    int mi = 0;
    if (top > 0) {
      const int end = (int)f.fin[mf];
      int j = (int)f.head[mf];
      for (bool first = true; j < end; j += 64, first = false) {
        const int i = j + lane;
        const int c0 = (int)f.list[min(i, end - 1)], c1 = (int)f.list[min(i + 32, end - 1)];
        const unsigned bal0 = __ballot_sync(dplx::kFullMask, f.live(c0) && i < end);
        const unsigned bal1 = __ballot_sync(dplx::kFullMask, f.live(c1) && i + 32 < end);
#ifdef DPLX_PROFILE
        prof[5] += min(64, end - j);
        if (bal0 && first) prof[9] += 1;
#endif
        if (bal0 | bal1) {
          const int k = bal0 ? __ffs(bal0) - 1 : 32 + __ffs(bal1) - 1;
          mi = __shfl_sync(dplx::kFullMask, bal0 ? c0 : c1, k & 31);
          j += k;
          break;
        }
      }
      if (warp == 0 && lane == 0) f.head[mf] = (idx_t)min(j, end);
    }
    if (warp == 0 && lane == 0) f.seeds[round] = mi;
    DPLX_MARK(1);
    if (stop) {
      ++round;
      break;
    }

    // Fill from the seed, if it is live.
    if (f.live(mi)) {
      const int sr = f.row_of(mi), sc = mi - sr * f.gw;
#pragma unroll
      for (int w = 0; w < kW; ++w) A[w] = row == sr && w == sc >> 6 ? 1ull << (sc & 63) : 0ull;
      for (int pass = 0;; ++pass) {
#ifdef DPLX_PROFILE
        prof[4] += 1;
#endif
        // Rows: rightwards through the words, and leftwards bit-reversed.
        u64 right[kW], left[kW], cr = 0, cl = 0;
#pragma unroll
        for (int t = 0; t < kW; ++t) {
          right[t] = A[t] | run_fill(fl[t], ((A[t] << 1) | cr) & fl[t]);
          cr = right[t] >> 63;
          const int k = kW - 1 - t;
          const u64 xr = __brevll(A[k]);
          left[k] = xr | run_fill(frr[k], ((xr << 1) | cl) & frr[k]);
          cl = left[k] >> 63;
        }
        bool grew = false;
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          const u64 nx = right[w] | __brevll(left[w]);
          grew |= nx != A[w];
          A[w] = nx;
        }
        // After the first pass the columns are closed: rows that grew
        // nowhere close the region.
        if (pass > 0 && !rounds_any(grew, threads)) break;
        // Columns: the warp's inclusive scans of its rows' transfers (a, m),
        // down (lanes in row order) and up; (a1, m1) then (a2, m2) is
        // (a2 | (m2 & a1), m2 & m1). A last word of at most 32 columns
        // shuffles its low halves only.
        u64 da[kW], dm[kW], ua[kW], um[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          da[w] = ua[w] = A[w];
          dm[w] = fu[w];
          um[w] = fd[w];
        }
        auto scan = [&](auto half) {
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
            for (int w = 0; w < kW; ++w) {
              u64 dap, dmp, uap, ump;
              if (decltype(half)::value && w == kW - 1) {
                dap = __shfl_up_sync(dplx::kFullMask, (unsigned)da[w], off);
                dmp = __shfl_up_sync(dplx::kFullMask, (unsigned)dm[w], off);
                uap = __shfl_down_sync(dplx::kFullMask, (unsigned)ua[w], off);
                ump = __shfl_down_sync(dplx::kFullMask, (unsigned)um[w], off);
              } else {
                dap = __shfl_up_sync(dplx::kFullMask, da[w], off);
                dmp = __shfl_up_sync(dplx::kFullMask, dm[w], off);
                uap = __shfl_down_sync(dplx::kFullMask, ua[w], off);
                ump = __shfl_down_sync(dplx::kFullMask, um[w], off);
              }
              if (lane >= off) {
                da[w] |= dm[w] & dap;
                dm[w] &= dmp;
              }
              if (lane + off < 32) {
                ua[w] |= um[w] & uap;
                um[w] &= ump;
              }
            }
          }
        };
        if (half_last)
          scan(std::true_type{});
        else
          scan(std::false_type{});
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          if (lane == 31) {                  // the warp's whole transfer down
            xfer[2 * (w * nw + warp)] = da[w];
            xfer[2 * (w * nw + warp) + 1] = dm[w];
          }
          if (lane == 0) {                   // and up
            xfer[2 * ((kW + w) * nw + warp)] = ua[w];
            xfer[2 * ((kW + w) * nw + warp) + 1] = um[w];
          }
        }
        rounds_any(true, threads);
        // What enters the warp's first row from above and its last from below.
        u64 din[kW] = {}, uin[kW] = {};
        for (int v = 0; v < warp; ++v) {
#pragma unroll
          for (int w = 0; w < kW; ++w)
            din[w] = xfer[2 * (w * nw + v)] | (xfer[2 * (w * nw + v) + 1] & din[w]);
        }
        for (int v = nw - 1; v > warp; --v) {
#pragma unroll
          for (int w = 0; w < kW; ++w)
            uin[w] = xfer[2 * ((kW + w) * nw + v)] |
                     (xfer[2 * ((kW + w) * nw + v) + 1] & uin[w]);
        }
#pragma unroll
        for (int w = 0; w < kW; ++w) A[w] |= da[w] | (dm[w] & din[w]) | ua[w] | (um[w] & uin[w]);
      }
    }
    DPLX_MARK(2);

    // Consume the region a nonzero word at a time, as rounds_loop does, with
    // the words spread over the warps: each warp lists its rows' nonzero
    // words (and the cell of their bit 0) in its segment of a queue in
    // shared memory; after a barrier, warp v takes the queue's entries v,
    // v + nw, ..., two a step (their loads before their atomics). Then
    // each lane drops its row's region from U and from the masks.
    int n = 0;
    for (int w = 0; w < kW; ++w) {           // not unrolled: a word is picked
      u64 a = A[0];
#pragma unroll
      for (int t = 1; t < kW; ++t)
        if (w == t) a = A[t];
      const unsigned has = __ballot_sync(dplx::kFullMask, a != 0);
      if (a) {
        const int at = warp * 32 * kW + n + __popc(has & ((1u << lane) - 1u));
        qword[at] = a;
        qtag[at] = row * f.gw + 64 * w;
      }
      n += __popc(has);
    }
    if (lane == 0) qn[warp] = n;
    rounds_any(true, threads);
    const int cnt = lane < nw ? qn[lane] : 0;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(dplx::kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    const int total = __shfl_sync(dplx::kFullMask, incl, 31), excl = incl - cnt;
    for (int g = warp; g < total; g += 2 * nw) {    // entries g and g1: segments v0, v1
      const int g1 = g + nw;
      const bool two = g1 < total;
      const int v0 = __popc(__ballot_sync(dplx::kFullMask, lane < nw && incl <= g));
      const int v1 = __popc(__ballot_sync(dplx::kFullMask, lane < nw && incl <= g1));
      const int at0 = v0 * 32 * kW + g - __shfl_sync(dplx::kFullMask, excl, v0);
      const int at1 = two ? v1 * 32 * kW + g1 - __shfl_sync(dplx::kFullMask, excl, v1) : at0;
      const u64 w0 = qword[at0], w1 = two ? qword[at1] : 0ull;
      const int c0 = qtag[at0] + lane, c1 = qtag[at1] + lane;
      const bool i0 = (w0 >> lane) & 1ull, i1 = (w0 >> (32 + lane)) & 1ull;
      const bool i2 = (w1 >> lane) & 1ull, i3 = (w1 >> (32 + lane)) & 1ull;
      const int b0 = i0 ? (int)f.bins[c0] : -1, b1 = i1 ? (int)f.bins[c0 + 32] : -1;
      const int b2 = i2 ? (int)f.bins[c1] : -1, b3 = i3 ? (int)f.bins[c1 + 32] : -1;
      if (i0) f.round_map[c0] = round;
      if (i1) f.round_map[c0 + 32] = round;
      if (i2) f.round_map[c1] = round;
      if (i3) f.round_map[c1 + 32] = round;
      if (b0 >= 0) atomicSub(&f.hist[b0], 1);
      if (b1 >= 0) atomicSub(&f.hist[b1], 1);
      if (b2 >= 0) atomicSub(&f.hist[b2], 1);
      if (b3 >= 0) atomicSub(&f.hist[b3], 1);
    }
    bool left_any = false;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      u64 u = row < f.gh ? shared_u[(size_t)row * kW + w] : 0ull;
      if (A[w]) {
        u &= ~A[w];
        fl[w] &= ~A[w];
        frr[w] &= ~__brevll(A[w]);
        fu[w] &= ~A[w];
        fd[w] &= ~A[w];
        shared_u[(size_t)row * kW + w] = u;
        A[w] = 0ull;
      }
      left_any |= u != 0;
    }
    remaining = rounds_any(left_any, threads);
    ++round;
    DPLX_MARK(3);
  }
#ifdef DPLX_PROFILE
  prof[6] = round;
  if (warp == 0 && lane == 0) {
    for (int k = 0; k < 7; ++k) f.profile[k] = prof[k];
    f.profile[9] = prof[9];
  }
#endif
  return round;
}

// Exclusive scan of the sort's counters in digit-major order: entry
// w * kDigits + d (warp-major, so a warp's lanes of distinct digits meet
// few bank conflicts) becomes the first position of digit d in warp w's
// slice. Every thread of the block calls it; thread t takes digit t / 2 in
// 8 of the warps.
template <typename cnt_t>
__device__ void scan_counters(cnt_t* cnt, int* warp_tot) {
  static_assert(kDigits * kWarps == 8 * kThreads, "8 counters a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cnt_t v[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = cnt[((tid & 1) * 8 + j) * kDigits + (tid >> 1)];
    sum += (int)v[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(dplx::kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int s = __shfl_up_sync(dplx::kFullMask, t, off);
      if (lane >= off) t += s;
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_tot[warp - 1] : 0) + incl - sum;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[((tid & 1) * 8 + j) * kDigits + (tid >> 1)] = (cnt_t)run;
    run += (int)v[j];
  }
  __syncthreads();
}

// cnt[i] += n with a shared atomic (16-bit counters add in their 32-bit word).
template <typename cnt_t>
__device__ __forceinline__ void add_count(cnt_t* cnt, int i, unsigned n) {
  if constexpr (sizeof(cnt_t) == 2)
    atomicAdd(reinterpret_cast<unsigned*>(cnt) + (i >> 1), n << (16 * (i & 1)));
  else
    atomicAdd(reinterpret_cast<unsigned*>(cnt) + i, n);
}

// The lanes of the warp with an entry (d >= 0) whose kBits-bit digit equals
// this lane's: the digit's low kMap bits from the warp's bitmap (1 << kMap
// words, zero between steps: each lane sets its bit in the word of its
// value and reads the word back), a ballot for each bit above. kMap = 0:
// ballots alone.
template <int kBits, int kMap>
__device__ __forceinline__ unsigned digit_peers(int d, unsigned* map) {
  const int lane = threadIdx.x & 31;
  unsigned peers;
  if constexpr (kMap > 0) {
    unsigned* word = map + (d & ((1 << kMap) - 1));
    if (d >= 0) atomicOr(word, 1u << lane);
    __syncwarp();
    peers = d >= 0 ? *word : 0u;
  } else {
    peers = __ballot_sync(dplx::kFullMask, d >= 0);
  }
#pragma unroll
  for (int k = kMap; k < kBits; ++k) {
    const bool bit = (d >> k) & 1;
    const unsigned b = __ballot_sync(dplx::kFullMask, bit);
    peers &= bit ? b : ~b;
  }
  return peers;
}

// One stable pass of the radix sort: the n entries of src (the counted
// cells in order where src is null) into dst by digit(c) in [0, D), digits
// of kBits bits. Warp w takes the w-th slice, 32 entries a step, four
// steps' loads in flight: it counts its digits (an atomic a lane), then,
// after the scan (each digit's first position from `base` where given,
// else a block scan of 256 digits), writes each entry at its digit's
// running offset plus its rank among the step's lanes of that digit. The
// leader of a digit moves the offset and clears the digit's bitmap word.
// Every thread of the block calls it.
template <int kBits, int kMap, typename bin_t, typename idx_t, typename cnt_t, typename Digit>
__device__ void radix_pass(const bin_t* bins, const idx_t* src, int n, Digit digit, int D,
                           const idx_t* base, idx_t* dst, cnt_t* cnt, unsigned* maps,
                           int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int slice = ((n + kThreads - 1) / kThreads) * 32;
  const int lo = min(n, warp * slice), hi = min(n, lo + slice);
  auto cell = [&](int i) -> int {            // -1: not a counted cell
    if (i >= hi) return -1;
    if (src) return (int)src[i];
    return bins[i] >= 0 ? i : -1;
  };
  unsigned* words = reinterpret_cast<unsigned*>(cnt);
  for (int i = tid; i < kWarps * D * (int)sizeof(cnt_t) / 4; i += kThreads) words[i] = 0u;
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 128) {
    int d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = cell(i0 + 32 * u + lane);
      d[u] = c >= 0 ? digit(c) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (d[u] >= 0) add_count(cnt, warp * D + d[u], 1u);
  }
  __syncthreads();
  if (base) {                 // a digit's warps in order, from its first position
    for (int t = tid; t < D; t += kThreads) {
      int run = (int)base[t];
      for (int w = 0; w < kWarps; ++w) {
        const int v = (int)cnt[w * D + t];
        cnt[w * D + t] = (cnt_t)run;
        run += v;
      }
    }
    __syncthreads();
  } else {
    scan_counters(cnt, warp_tot);
  }
  unsigned* map = kMap > 0 ? maps + (warp << kMap) : nullptr;
  for (int i0 = lo; i0 < hi; i0 += 128) {
    int c[4], d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = cell(i0 + 32 * u + lane);
      d[u] = c[u] >= 0 ? digit(c[u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned peers = digit_peers<kBits, kMap>(d[u], map);
      const int at = d[u] >= 0 ? (int)cnt[warp * D + d[u]] : 0;
      if (c[u] >= 0) dst[at + __popc(peers & below)] = (idx_t)c[u];
      __syncwarp();
      if (d[u] >= 0 && lane == __ffs(peers) - 1) {
        cnt[warp * D + d[u]] = (cnt_t)(at + __popc(peers));
        if constexpr (kMap > 0) map[d[u] & ((1 << kMap) - 1)] = 0u;
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// Whether the sort takes the bins in one pass: at most kBinDigits of them,
// with kWarps counters each in the sort's `space` bytes (its scratch at
// their end). ICL's 400 bins take 12,928 of 17,280.
__host__ __device__ inline bool one_bin_pass(int nb2, size_t space, size_t counter_bytes) {
  return nb2 <= kBinDigits && (size_t)kWarps * nb2 * counter_bytes + kSortScratch <= space;
}

// The radix sort's passes for a frame of M counted cells whose seed keys
// differ in the bits of `vary`: a pass a byte of the key with such a bit,
// then the bin's passes (none where there is one bin and a key pass).
__host__ __device__ inline int radix_passes(int M, unsigned vary, int nb2, bool one_bin) {
  if (M == 0) return 0;
  int key_passes = 0, bin_bits = 0;
  for (int k = 0; k < 4; ++k) key_passes += ((vary >> (8 * k)) & 0xffu) != 0;
  while ((1 << bin_bits) < nb2) ++bin_bits;
  if (nb2 <= 1 && key_passes) return key_passes;
  return key_passes + (one_bin || bin_bits <= 8 ? 1 : (bin_bits + 7) / 8);
}

// Sorts the counted cells (bins[c] >= 0) of a frame by (bin, key(c), c)
// into list: a stable LSD radix sort of the block (radix_pass), starting
// from the cells in order: a pass a byte of the key that the counted cells'
// keys differ in (the bits of their OR ^ AND), lowest first, then the bin:
// one pass of nb2 digits written from each bin's head where its counters
// fit the sort's `space` bytes (cnt), else 8 bits a pass. maps: kWarps <<
// kMap words of bitmaps for the ranks (kMap = 0: none); scratch: the
// staging's (kSortScratch bytes). Every thread of the block calls it; M is
// the count of counted cells. Returns the passes it ran. (Taking the OR and
// AND here rather than in the staging loop, which every frame runs, keeps
// that loop's code and TUM's rounds as they were: there they cost TUM's
// K2 3.4% on the H100.)
template <int kMap, typename bin_t, typename idx_t, typename cnt_t, typename Key>
__device__ int sort_passes(const bin_t* bins, Key key, int N, int M, int nb2,
                           const idx_t* head, idx_t* list, idx_t* buf, cnt_t* cnt, size_t space,
                           unsigned* maps, int* scratch) {
  unsigned key_or = 0u, key_and = ~0u;
  if (threadIdx.x == 0) {
    scratch[kKeyOr] = 0;
    scratch[kKeyAnd] = -1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += kThreads)
    if (bins[c] >= 0) {
      const unsigned k = key(c);
      key_or |= k;
      key_and &= k;
    }
  key_or = __reduce_or_sync(dplx::kFullMask, key_or);
  key_and = __reduce_and_sync(dplx::kFullMask, key_and);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(reinterpret_cast<unsigned*>(&scratch[kKeyOr]), key_or);
    atomicAnd(reinterpret_cast<unsigned*>(&scratch[kKeyAnd]), key_and);
  }
  __syncthreads();
  const unsigned vary = (unsigned)scratch[kKeyOr] ^ (unsigned)scratch[kKeyAnd];
  const bool one_bin = one_bin_pass(nb2, space, sizeof(cnt_t));
  const int passes = radix_passes(M, vary, nb2, one_bin);
  if constexpr (kMap > 0)
    for (int i = threadIdx.x; i < (kWarps << kMap); i += kThreads) maps[i] = 0u;
  // The last pass writes list.
  idx_t* dst = (passes & 1) ? list : buf;
  const idx_t* src = nullptr;                // the first pass reads the cells in order
  int left = passes;
  for (int k = 0; k < 4 && left > 0; ++k) {
    const int shift = 8 * k;
    if (!((vary >> shift) & 0xffu)) continue;
    radix_pass<8, kMap>(bins, src, src ? M : N,
                        [&](int c) { return (int)((key(c) >> shift) & (kDigits - 1)); },
                        kDigits, (const idx_t*)nullptr, dst, cnt, maps, scratch);
    src = dst;
    dst = dst == list ? buf : list;
    --left;
  }
  if (left > 0 && one_bin) {
    radix_pass<9, kMap>(bins, src, src ? M : N, [&](int c) { return (int)bins[c]; }, nb2, head,
                        dst, cnt, maps, scratch);
  } else {
    for (int shift = 0; left > 0; shift += 8, --left) {
      radix_pass<8, kMap>(bins, src, src ? M : N,
                          [&](int c) { return ((int)bins[c] >> shift) & (kDigits - 1); },
                          kDigits, (const idx_t*)nullptr, dst, cnt, maps, scratch);
      src = dst;
      dst = dst == list ? buf : list;
    }
  }
  return passes;
}

// Frames whose bins are small (the sum of the squared bin counts at most
// kRankRatio times the counted cells, as TUM's 48 x 64 grid gives) sort by
// comparisons instead: the counted cells go to their bin's segment of buf
// in any order, then each takes its place in list from the count of its
// bin's cells before it in (key, cell) order. hist is counted down for the
// segments' slots and set again after; start and end bound each bin's
// segment. Every thread of the block calls it.
constexpr long long kRankRatio = 256;
constexpr int kRankStep = 8;

template <typename bin_t, typename idx_t, typename Key>
__device__ void rank_sort(const bin_t* bins, Key key, int N, int M, int nb2, int* hist,
                          const idx_t* start, const idx_t* end, idx_t* list, idx_t* buf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c0 = warp * 32; c0 < N; c0 += kThreads) {
    const int c = c0 + lane;
    const int b = c < N ? (int)bins[c] : -1;
    const unsigned peers = __match_any_sync(dplx::kFullMask, b);
    const int leader = __ffs(peers) - 1, n = __popc(peers);
    int at = 0;
    if (b >= 0 && lane == leader) at = atomicSub(&hist[b], n) - n;
    at = __shfl_sync(dplx::kFullMask, at, leader);
    if (b >= 0) buf[(int)start[b] + at + __popc(peers & ((1u << lane) - 1u))] = (idx_t)c;
  }
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    const int c = (int)buf[i], b = (int)bins[c];
    const unsigned k = key(c);
    const int s = (int)start[b], e = (int)end[b];
    int rank = 0, j = s;
    for (; j + kRankStep <= e; j += kRankStep) {     // the loads first, all in flight
      int o[kRankStep];
      unsigned ko[kRankStep];
#pragma unroll
      for (int u = 0; u < kRankStep; ++u) o[u] = (int)buf[j + u];
#pragma unroll
      for (int u = 0; u < kRankStep; ++u) ko[u] = key(o[u]);
#pragma unroll
      for (int u = 0; u < kRankStep; ++u) rank += ko[u] < k || (ko[u] == k && o[u] < c);
    }
    for (; j < e; ++j) {
      const int o = (int)buf[j];
      const unsigned ko = key(o);
      rank += ko < k || (ko == k && o < c);
    }
    list[s + rank] = (idx_t)c;
  }
  for (int b = tid; b < nb2; b += kThreads) hist[b] = (int)end[b] - (int)start[b];
  __syncthreads();
}

// The rounds' band by KB: KB > 0 rows a lane in registers on warp 0
// (RegBand), 0 the memory band on warp 0 (MemBand), -W one row a lane of W
// words on ceil(gh / 32) warps (rows_loop).
template <bool kCompact, int KB>
__global__ void __launch_bounds__(kThreads, 1)
grow_rounds_kernel(const int* __restrict__ bins_in, const float* __restrict__ mse_in,
                   const uint8_t* __restrict__ edges_in, int gh, int gw, int nb2,
                   int r_max, int min_cand, int* __restrict__ round_map,
                   int* __restrict__ seeds, int* __restrict__ nr_rounds,
                   unsigned char* __restrict__ scratch,
                   unsigned long long* __restrict__ counters) {
  using bin_t = typename std::conditional<kCompact, int16_t, int>::type;
  using idx_t = typename std::conditional<kCompact, uint16_t, int>::type;
  using cnt_t = typename std::conditional<kCompact, uint16_t, unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem[];
#ifdef DPLX_PROFILE
  long long t0 = clock64(), sort_cycles = 0;
#endif
  const int N = gh * gw, W = (gw + 63) / 64, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L(gh, gw, nb2, kCompact);
  unsigned char* ws = kCompact ? smem : scratch + (size_t)b * L.total;
  u64* planes = reinterpret_cast<u64*>(ws);
  const size_t words = L.words;
  int* hist = reinterpret_cast<int*>(ws + L.hist);
  idx_t* head = reinterpret_cast<idx_t*>(ws + L.head);
  idx_t* fin = reinterpret_cast<idx_t*>(ws + L.fin);
  idx_t* list = reinterpret_cast<idx_t*>(ws + L.list);
  idx_t* buf = reinterpret_cast<idx_t*>(ws + L.buf);
  bin_t* bins = reinterpret_cast<bin_t*>(ws + L.bins);
  unsigned* keys = reinterpret_cast<unsigned*>(ws + L.keys);
  // The sort's counters and scratch: in the planes' space (compact), else
  // the launch's shared memory; its scratch at the end of that space, its
  // bitmaps after it (compact: after the frame's arrays, where they fit).
  const size_t sort_space = kCompact ? L.hist : sort_bytes(false, nb2);
  cnt_t* cnt = reinterpret_cast<cnt_t*>(kCompact ? ws : smem);
  int* sort_scratch = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(cnt) + sort_space -
                                             kSortScratch);
  unsigned* maps = reinterpret_cast<unsigned*>(smem + (kCompact ? L.total : sort_space));
  bins_in += (size_t)b * N;
  mse_in += (size_t)b * N;
  edges_in += (size_t)b * N;
  round_map += (size_t)b * N;
  seeds += (size_t)b * r_max;

  // 1. Stage the frame and count the histogram (the cells of one bin in a
  //    warp add with one atomic), the planar cells and the counted ones.
  for (int i = tid; i < nb2; i += kThreads) hist[i] = 0;
  for (int r = tid; r < r_max; r += kThreads) seeds[r] = N;
  if (tid < 2) sort_scratch[kNPlanar + tid] = 0;
  __syncthreads();
  int planar = 0, counted = 0;
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
        if (kCompact) keys[c] = seed_key(m[u]);
      }
      planar += pl;
      counted += key >= 0;
      const unsigned peers = __match_any_sync(dplx::kFullMask, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
    }
  }
  planar = warp_sum(planar);
  counted = warp_sum(counted);
  if (lane == 0) {
    atomicAdd(&sort_scratch[kNPlanar], planar);
    atomicAdd(&sort_scratch[kNCounted], counted);
  }
  __syncthreads();
  const int n_planar = sort_scratch[kNPlanar], M = sort_scratch[kNCounted];

  // 2. Each bin's segment of the list: an exclusive scan of the counts
  //    gives its head (first entry) and fin (its end, until step 3).
  if (warp == 0) {
    const int per = (nb2 + 31) / 32, lo = min(nb2, lane * per), hi = min(nb2, lo + per);
    int s = 0;
    long long sq = 0;
    for (int i = lo; i < hi; ++i) {
      s += hist[i];
      sq += (long long)hist[i] * hist[i];
    }
    int incl = s;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(dplx::kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - s;
    for (int i = lo; i < hi; ++i) {
      head[i] = (idx_t)run;
      run += hist[i];
      fin[i] = (idx_t)run;
    }
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(dplx::kFullMask, sq, off);
    if (lane == 0) *reinterpret_cast<long long*>(sort_scratch + kSquares) = sq;
  }
  __syncthreads();

  // 3. Each bin's counted cells in the seed's order; then each fin moves to
  //    the bin's first +inf entry.
  auto key = [&](int c) -> unsigned { return kCompact ? keys[c] : seed_key(__ldg(mse_in + c)); };
#ifdef DPLX_PROFILE
  const long long s0 = clock64();
#endif
  const long long squares = *reinterpret_cast<const long long*>(sort_scratch + kSquares);
  const bool by_rank = kCompact && squares <= kRankRatio * M;
  int passes = 0;                         // the radix sort's
  if (by_rank)
    rank_sort(bins, key, N, M, nb2, hist, head, fin, list, buf);
  else if (rank_maps(gh, gw, nb2))
    passes = sort_passes<kMapBits>(bins, key, N, M, nb2, head, list, buf, cnt, sort_space,
                                   maps, sort_scratch);
  else
    passes = sort_passes<0>(bins, key, N, M, nb2, head, list, buf, cnt, sort_space, maps,
                            sort_scratch);
#ifdef DPLX_PROFILE
  sort_cycles = clock64() - s0;
#endif
  for (int i = tid; i < M; i += kThreads) {
    const int c = (int)list[i];
    if (key(c) != 0xffffffffu) continue;
    const int bn = (int)bins[c];
    const int p = i > 0 ? (int)list[i - 1] : -1;
    if (p < 0 || (int)bins[p] != bn || key(p) != 0xffffffffu) fin[bn] = (idx_t)i;
  }
  __syncthreads();

  // 4. The bit planes (border bits of the edge masks dropped); a warp a row.
  //    They take the sort's space.
  for (int r = warp; r < gh; r += kWarps) {
    for (int w = 0; w < W; ++w) {
      u64 bits[kPlanes] = {};
      for (int half = 0; half < 2; ++half) {
        if (w * 64 + half * 32 >= gw) break;
        const int col = w * 64 + half * 32 + lane;
        uint8_t e = col < gw ? edges_in[(size_t)r * gw + col] : 0;
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
  // x / d as the high word of x * (2^32 / d + 1), d > 1: exact while
  // x * d < 2^32 (so r / band always is).
  auto magic = [](int d) { return d > 1 ? (unsigned)((1ull << 32) / (unsigned)d + 1) : 0u; };
  if constexpr (KB < 0) {
    // 5. The rounds, one row a lane on the first ceil(gh / 32) warps; the
    //    first warp past them (warp 0 where all 16 hold rows) counts the
    //    frame, its sort, the sort's passes and its band before they start.
    const int nw = (gh + 31) / 32;
    if (warp == nw % kWarps && lane == 0 && counters) {
      atomicAdd(counters, 1ull);
      if (!by_rank) atomicAdd(counters + 2, 1ull);
      atomicAdd(counters + 3, 1ull);
      if (passes) atomicAdd(counters + 4, (unsigned long long)passes);
    }
    if (warp >= nw) return;
    long long* profile = nullptr;
#ifdef DPLX_PROFILE
    profile = reinterpret_cast<long long*>(scratch) + (size_t)b * kProfileSlots;
    if (tid == 0) {
      profile[7] = clock64() - t0 - sort_cycles;
      profile[8] = sort_cycles;
    }
#endif
    const bool magic_rows = gw > 1 && (unsigned long long)N * (unsigned)gw < (1ull << 32);
    const Frame<bin_t, idx_t> f{gh, gw, W, N, nb2, 1, r_max, min_cand, lane, hist, head, fin,
                                list, bins, planes + (size_t)kU * words,
                                magic(gw), 0u, magic_rows, round_map, seeds, profile};
    const int rounds = rows_loop<-KB>(f, planes, words, nw, warp, n_planar);
    if (tid == 0) {
      nr_rounds[b] = rounds;
      if (counters) atomicAdd(counters + 1, (unsigned long long)rounds);
    }
  } else {
    if (warp != 0) {         // the rounds are one warp's
      if (warp == 1 && lane == 0 && counters) {     // the frame and its sort
        atomicAdd(counters, 1ull);
        if (!by_rank) atomicAdd(counters + 2, 1ull);
        if (passes) atomicAdd(counters + 4, (unsigned long long)passes);
      }
      return;
    }

    // 5. The rounds.
    long long* profile = nullptr;
#ifdef DPLX_PROFILE
    profile = reinterpret_cast<long long*>(scratch) + (size_t)b * kProfileSlots;
    if (lane == 0) {
      profile[7] = clock64() - t0 - sort_cycles;
      profile[8] = sort_cycles;
    }
#endif
    const int band = (gh + 31) / 32;
    const int r0 = min(gh, lane * band), r1 = min(gh, r0 + band);
    const MemBand mem{planes, words, W, r0, r1, lane};
    const bool magic_rows = gw > 1 && (unsigned long long)N * (unsigned)gw < (1ull << 32);
    const Frame<bin_t, idx_t> f{gh, gw, W, N, nb2, band, r_max, min_cand, lane, hist, head,
                                fin, list, bins, planes + (size_t)kU * words,
                                magic(gw), magic(band), magic_rows, round_map, seeds,
                                profile};
    int rounds;
    if constexpr (KB > 0) {
      RegBand<KB> reg(mem);
      rounds = rounds_loop(reg, f, n_planar);
    } else {
      MemBand band_planes = mem;
      rounds = rounds_loop(band_planes, f, n_planar);
    }
    if (lane == 0) {
      nr_rounds[b] = rounds;
      if (counters) atomicAdd(counters + 1, (unsigned long long)rounds);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of global workspace dplx_grow_rounds needs for B frames: 0 where a
// frame fits in shared memory.
long long dplx_grow_rounds_scratch_bytes(int B, int gh, int gw, int nb2) {
  if (fits_shared(gh, gw, nb2)) return 0;
  return (long long)B * (long long)Layout(gh, gw, nb2, false).total;
}

// The int64 slots a -DDPLX_PROFILE build writes a frame to the scratch
// pointer: see Frame::profile.
int dplx_grow_rounds_profile_slots() { return kProfileSlots; }

// The int64 counters dplx_grow_rounds adds to: frames, rounds, radix-sorted
// frames, frames whose rounds ran one row a lane, the radix sorts' passes.
int dplx_grow_rounds_counter_slots() { return kCounterSlots; }

// bins (B, gh*gw) int32; mse (B, gh*gw) float32; edges (B, gh*gw) uint8
// packed as ops/growing.py:pack_edges; round_map (B, gh*gw) int32;
// seeds (B, r_max) int32; nr_rounds (B,) int32; scratch: the bytes that
// dplx_grow_rounds_scratch_bytes asks for (may be null when it asks none);
// counters: kCounterSlots int64s the launch adds to, or null.
int dplx_grow_rounds(const void* bins, const void* mse, const void* edges,
                     int B, int gh, int gw, int nb2, int r_max, int min_cand,
                     void* round_map, void* seeds, void* nr_rounds, void* scratch,
                     void* counters, void* stream) {
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
  auto* ct = static_cast<unsigned long long*>(counters);
  if (!fits_shared(gh, gw, nb2)) {
    grow_rounds_kernel<false, 0><<<B, kThreads, sort_bytes(false, nb2) + kMapBytes, st>>>(
        bi, ms, ed, gh, gw, nb2, r_max, min_cand, rm, sd, nr, sc, ct);
    return (int)cudaGetLastError();
  }
  // Grids up to 64 x 64 cells (TUM's 48 x 64 at P=10) keep their band of
  // rows in registers; larger ones of up to 512 rows of 3 words (ICL's
  // 120 x 160 at P=4) run one row a lane; the rest on the memory band.
  const int W = (gw + 63) / 64;
  auto kernel = gw <= 64 && gh <= 64                     ? grow_rounds_kernel<true, 2>
                : W == kRowsWords && gh <= 32 * kWarps ? grow_rounds_kernel<true, -kRowsWords>
                                                       : grow_rounds_kernel<true, 0>;
  const size_t smem = Layout(gh, gw, nb2, true).total + (rank_maps(gh, gw, nb2) ? kMapBytes : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, kThreads, smem, st>>>(bi, ms, ed, gh, gw, nb2, r_max, min_cand, rm, sd, nr, sc,
                                    ct);
  return (int)cudaGetLastError();
}

}  // extern "C"
