// Stage-1 epilogue kernel: every cell's plane fit and gates, its normal
// bin and the packed edge byte that the growing kernel reads.
//
// Replaces the XLA fusions of deplex_tpu/ops/cellstats.py:finalize_cell_stats,
// deplex_tpu/ops/histogram.py:normal_bins and
// deplex_tpu/ops/growing.py:admissibility_edges (no pallas_call there; the
// Pallas path builds the same bins and edges outside its kernel,
// deplex_tpu/ops/pallas_growing.py:399-403). Its plain twin is
// ops/cellstats.py:finalize_cell_stats, then ops/histogram.py:normal_bins,
// then ops/growing.py:pack_edges(admissibility_edges(...)), operation for
// operation:
//   * the eigensolve is dplx::eigh3x3_min (common.cuh), the twin's
//     ops/eigh3x3.py arithmetic; atan2, cos, sin and acos go through double
//     and are rounded to float, as ops/eigh3x3.py:f64_rounded does;
//   * every constant the twin takes from a Python float (the sigma
//     coefficients, sin_angle, max_merge_dist, min_cos, the bin scales) is
//     rounded to float32 on the host, as torch rounds a Python scalar for a
//     float32 tensor, and passed in;
//   * x ** 2 is x * x; dot products add left to right; the library is built
//     with -fmad=false, so no multiply-add is contracted.
//
// What bounds it on the H100: bytes. A cell reads 13 moment planes (52
// bytes) and writes 90 (every CellStats field, the bin and the edge byte):
// 27.9 MB at TUM B=64, 8.3 us at 3.35 TB/s; its double-precision work
// (atan2, cos, sin, acos, atan2 a cell) is a fraction of that. The design:
// a block takes a tile of whole grid rows (a band; grids wider than 128
// cells in column strips) and the tile's one-cell ring as a halo, whose
// fits it recomputes (1.04x the fits at TUM B=64: two 24-row bands of 64
// cells), so that the four neighbours' normal and d are in shared memory
// when the edges are taken: one launch, no second pass over the grid. Every
// thread of the launch has a cell (a warp takes 32 consecutive cells of the
// tile, halo cells last), each plane is read by consecutive lanes, the
// 4-byte outputs are written by consecutive lanes, and the 12- and 36-byte
// outputs (normal, mean, coord_sum, scatter) go through a warp's buffer in
// shared memory and out as contiguous runs. The wrapper chooses the tile
// (kernels/cellfinal.py:tile_plan): larger bands where the batch fills the
// card, thinner ones at small batches so that more blocks share the work.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 32 * 9;                 // a warp's buffer: 32 cells x 9 floats
constexpr int kStaticSmem = kWarps * (kStage + 32) * 4;  // the buffers and their cells

// Bits of the packed edge byte (ops/growing.py:pack_edges).
constexpr uint8_t kFromUp = 1, kFromDown = 2, kFromLeft = 4, kFromRight = 8,
                  kPlanar = 16;

// The gates' constants, each already rounded as the twin rounds it.
struct Gates {
  float n;              // P * P points a cell
  float valid_thr;      // (P * P * 3) // min_pts_per_cell
  float max_disc;       // max_number_depth_discontinuity
  float sigma_coeff, sigma_margin;
  float sin_angle, tol_lo, tol_hi;
  float min_cos;
  float polar_scale, azimuth_scale, pi;
  int nr_bins;
};

// ops/growing.py:admissibility_edges for one neighbour (normal a, offset
// ad): it may enter the cell (normal n, mean m, tolerance tol) iff
// a . n >= min_cos and (a . m + ad)^2 <= tol; dot products add left to right.
__device__ __forceinline__ bool admits(float ax, float ay, float az, float ad, float nx,
                                       float ny, float nz, float mx, float my, float mz,
                                       float tol, float min_cos) {
  const float cosang = ax * nx + ay * ny + az * nz;
  const float off = (ax * mx + ay * my + az * mz) + ad;
  return cosang >= min_cos && off * off <= tol;
}

struct Outputs {
  bool* planar;
  float *normal, *mean, *d, *mse, *tol, *coord_sum, *scatter, *nr_pts;
  int* bins;
  uint8_t* edges;
};

// A tile's shared memory: the normal and d of its cells and ring (the
// edges' neighbours), then its cells' mean, tol and planar flag.
inline size_t tile_smem_bytes(int rows, int cols) {
  return (size_t)(rows + 2) * (cols + 2) * 16 + (size_t)rows * cols * 17;
}

// A warp's K-float outputs of its 32 cells (x[c] of lane l, cell index
// idx[l] or -1) written through its buffer as contiguous runs of out.
template <int K>
__device__ __forceinline__ void store_runs(float* out, const float (&x)[K], float* st,
                                           const int* idx, int lane) {
#pragma unroll
  for (int c = 0; c < K; ++c) st[lane * K + c] = x[c];
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 32 * K; e += 32) {
    const int i = idx[e / K];
    if (i >= 0) out[(size_t)K * i + e % K] = st[e];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
cell_finalize_kernel(const float* __restrict__ planes, int B, int gh, int gw, int rows,
                     int cols, Gates g, Outputs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float stage[kWarps][kStage];
  __shared__ int stage_idx[kWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.z;
  const int r0 = blockIdx.y * rows, c0 = blockIdx.x * cols;
  const int nr = min(rows, gh - r0), nc = min(cols, gw - c0);   // the tile's cells
  const int tw = cols + 2;                                      // ring included
  const int ring = (rows + 2) * tw;
  float* s_nx = reinterpret_cast<float*>(smem);
  float* s_ny = s_nx + ring;
  float* s_nz = s_ny + ring;
  float* s_d = s_nz + ring;
  float* s_mx = s_d + ring;
  float* s_my = s_mx + rows * cols;
  float* s_mz = s_my + rows * cols;
  float* s_tol = s_mz + rows * cols;
  uint8_t* s_planar = reinterpret_cast<uint8_t*>(s_tol + rows * cols);
  float* st = stage[warp];
  int* idx = stage_idx[warp];
  const size_t plane = (size_t)B * gh * gw;
  if (b == 0 && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *out.nr_pts = g.n;

  // The tile's cells first, then the ring's that lie in the grid: top,
  // bottom, left, right.
  const int inner = nr * nc;
  const int top = r0 > 0 ? nc : 0, bottom = r0 + nr < gh ? nc : 0;
  const int left = c0 > 0 ? nr : 0, right = c0 + nc < gw ? nr : 0;
  const int tasks = inner + top + bottom + left + right;
  for (int t = warp * 32 + lane; t - lane < tasks; t += kThreads) {
    int tr = 0, tc = 0;          // position in the tile, ring included
    if (t < inner) {
      tr = t / nc + 1;
      tc = t % nc + 1;
    } else {
      int h = t - inner;
      if (h < top) {
        tc = h + 1;
      } else if ((h -= top) < bottom) {
        tr = nr + 1;
        tc = h + 1;
      } else if ((h -= bottom) < left) {
        tr = h + 1;
      } else {
        tr = h - left + 1;
        tc = nc + 1;
      }
    }
    const bool valid = t < tasks, interior = t < inner;
    const int r = r0 + tr - 1, c = c0 + tc - 1;
    const size_t i = valid ? ((size_t)b * gh + r) * gw + c : 0;

    float nx = 0.f, ny = 0.f, nz = 1.f, d = 0.f, mx = 0.f, my = 0.f, mz = 0.f, tol = 0.f;
    float mse = 0.f, m[13] = {};
    bool planar = false;
    if (valid) {
      // ops/cellstats.py:moments_from_planes order.
#pragma unroll
      for (int k = 0; k < 13; ++k) m[k] = planes[k * plane + i];
      const float cnt = m[0], disc_h = m[1], disc_v = m[2];
      const float sx = m[3], sy = m[4], sz = m[5];
      const float diam = m[12];

      // ops/cellstats.py:finalize_cell_stats.
      const bool has_valid = cnt >= g.valid_thr;
      const bool continuous = disc_h < g.max_disc && disc_v < g.max_disc;
      mx = sx / g.n;
      my = sy / g.n;
      mz = sz / g.n;
      const dplx::Eig3 e = dplx::eigh3x3_min(m[6], m[7], m[8], m[9], m[10], m[11]);
      const float d_raw = -(mx * e.vx + my * e.vy + mz * e.vz);
      const bool keep = d_raw > 0.f;
      nx = keep ? e.vx : -e.vx;
      ny = keep ? e.vy : -e.vy;
      nz = keep ? e.vz : -e.vz;
      d = fabsf(d_raw);
      mse = e.w0 / g.n;
      const float sigma = g.sigma_coeff * (mz * mz) + g.sigma_margin;
      planar = has_valid && continuous && mse <= sigma * sigma;
      float tl = diam * g.sin_angle;      // torch.clamp keeps a NaN
      tl = tl < g.tol_lo ? g.tol_lo : tl;
      tl = tl > g.tol_hi ? g.tol_hi : tl;
      tol = tl * tl;
      if (!planar) mse = FLT_MAX;           // never seeds
      const int s = tr * tw + tc;
      s_nx[s] = nx;
      s_ny[s] = ny;
      s_nz[s] = nz;
      s_d[s] = d;
    }
    const bool mine = valid && interior;
    if (mine) {
      s_mx[t] = mx;
      s_my[t] = my;
      s_mz[t] = mz;
      s_tol[t] = tol;
      s_planar[t] = planar;
      out.planar[i] = planar;
      out.d[i] = d;
      out.mse[i] = mse;
      out.tol[i] = tol;

      // ops/histogram.py:normal_bins.
      const float rho = sqrtf(nx * nx + ny * ny);
      float mnz = -nz;
      mnz = mnz < -1.f ? -1.f : (mnz > 1.f ? 1.f : mnz);
      const float polar = (float)acos((double)mnz);
      const bool has_rho = rho > 0.f;
      const float safe_rho = has_rho ? rho : 1.f;
      float azimuth = (float)atan2((double)(nx / safe_rho), (double)(ny / safe_rho));
      if (!has_rho) azimuth = 0.f;
      const int xq = (int)(polar * g.polar_scale);
      int yq = (int)((azimuth + g.pi) * g.azimuth_scale);
      if (!(xq > 0)) yq = 0;
      out.bins[i] = planar ? yq * g.nr_bins + xq : -1;
    }
    // The 12- and 36-byte outputs as contiguous runs (whole warps only).
    if (__any_sync(dplx::kFullMask, mine)) {
      idx[lane] = mine ? (int)i : -1;
      __syncwarp();
      const float nrm[3] = {nx, ny, nz}, mu[3] = {mx, my, mz}, cs[3] = {m[3], m[4], m[5]};
      const float sc[9] = {m[6], m[7], m[8], m[7], m[9], m[10], m[8], m[10], m[11]};
      store_runs<3>(out.normal, nrm, st, idx, lane);
      store_runs<3>(out.mean, mu, st, idx, lane);
      store_runs<3>(out.coord_sum, cs, st, idx, lane);
      store_runs<9>(out.scatter, sc, st, idx, lane);
    }
  }
  __syncthreads();

  // The packed edge bytes: the four in-neighbours (border cells have none),
  // from the tile and its ring.
  for (int t = tid; t < inner; t += kThreads) {
    const int tr = t / nc + 1, tc = t % nc + 1;
    const int r = r0 + tr - 1, c = c0 + tc - 1;
    const int s = tr * tw + tc;
    const float nx = s_nx[s], ny = s_ny[s], nz = s_nz[s];
    const float mx = s_mx[t], my = s_my[t], mz = s_mz[t], tol = s_tol[t];
    const int nbr[4] = {s - tw, s + tw, s - 1, s + 1};
    const bool inside[4] = {r >= 1, r < gh - 1, c >= 1, c < gw - 1};
    const uint8_t bit[4] = {kFromUp, kFromDown, kFromLeft, kFromRight};
    uint8_t packed = s_planar[t] ? kPlanar : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = nbr[k];
      if (inside[k] && admits(s_nx[q], s_ny[q], s_nz[q], s_d[q], nx, ny, nz, mx, my, mz, tol,
                              g.min_cos))
        packed |= bit[k];
    }
    out.edges[((size_t)b * gh + r) * gw + c] = packed;
  }
}

}  // namespace

extern "C" {

// planes: (13, B, gh, gw) float32 in ops/cellstats.py:moments_from_planes
// order; a block takes a tile of rows x cols cells (kernels/cellfinal.py:
// tile_plan) and its ring. Outputs (all contiguous): planar (B, gh, gw)
// bool; normal, mean and coord_sum (B, gh, gw, 3), scatter (B, gh, gw, 3,
// 3), d, mse and tol (B, gh, gw) float32; nr_pts a 0-d float32; bins
// (B, gh, gw) int32 (-1 off the planar cells); edges (B, gh, gw) uint8
// (ops/growing.py:pack_edges).
int dplx_cell_finalize(const void* planes, int B, int gh, int gw, int rows, int cols,
                       float n, float valid_thr, float max_disc, float sigma_coeff,
                       float sigma_margin, float sin_angle, float tol_lo, float tol_hi,
                       float min_cos, float polar_scale, float azimuth_scale, float pi,
                       int nr_bins, void* planar, void* normal, void* mean, void* d, void* mse,
                       void* tol, void* coord_sum, void* scatter, void* nr_pts, void* bins,
                       void* edges, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0 || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const unsigned strips = (unsigned)((gw + cols - 1) / cols);
  const unsigned bands = (unsigned)((gh + rows - 1) / rows);
  if (B > 65535 || bands > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_smem_bytes(rows, cols);
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cell_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Gates g{n, valid_thr, max_disc, sigma_coeff, sigma_margin, sin_angle, tol_lo,
                tol_hi, min_cos, polar_scale, azimuth_scale, pi, nr_bins};
  const Outputs out{static_cast<bool*>(planar), static_cast<float*>(normal),
                    static_cast<float*>(mean), static_cast<float*>(d),
                    static_cast<float*>(mse), static_cast<float*>(tol),
                    static_cast<float*>(coord_sum), static_cast<float*>(scatter),
                    static_cast<float*>(nr_pts), static_cast<int*>(bins),
                    static_cast<uint8_t*>(edges)};
  cell_finalize_kernel<<<dim3(strips, bands, B), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), B, gh, gw, rows, cols, g, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
