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
// one thread a cell over a 16 x 32 tile whose one-cell ring is a halo. A
// halo cell's fit is recomputed (1.22x the fits) so that the four
// neighbours' normal and d are in shared memory when the edges are taken,
// and the whole stage is one launch with no second pass over the grid.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kTileH = 16, kTileW = 32;          // threads of a block
constexpr int kInH = kTileH - 2, kInW = kTileW - 2;  // cells it writes

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

__global__ void __launch_bounds__(kTileH * kTileW)
cell_finalize_kernel(const float* __restrict__ planes, int B, int gh, int gw, Gates g,
                     Outputs out) {
  __shared__ float s_nx[kTileH][kTileW], s_ny[kTileH][kTileW], s_nz[kTileH][kTileW],
      s_d[kTileH][kTileW];
  const int tx = threadIdx.x, ty = threadIdx.y, b = blockIdx.z;
  const int r = blockIdx.y * kInH + ty - 1, c = blockIdx.x * kInW + tx - 1;
  const bool in_grid = r >= 0 && r < gh && c >= 0 && c < gw;
  const bool interior = in_grid && ty >= 1 && ty <= kInH && tx >= 1 && tx <= kInW;
  const size_t plane = (size_t)B * gh * gw;
  const size_t i = ((size_t)b * gh + (in_grid ? r : 0)) * gw + (in_grid ? c : 0);
  if (b == 0 && blockIdx.x == 0 && blockIdx.y == 0 && tx == 0 && ty == 0) *out.nr_pts = g.n;

  float nx = 0.f, ny = 0.f, nz = 1.f, d = 0.f, mx = 0.f, my = 0.f, mz = 0.f, tol = 0.f;
  bool planar = false;
  if (in_grid) {
    // ops/cellstats.py:moments_from_planes order.
    float m[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) m[k] = planes[k * plane + i];
    const float cnt = m[0], disc_h = m[1], disc_v = m[2];
    const float sx = m[3], sy = m[4], sz = m[5];
    const float sxx = m[6], sxy = m[7], sxz = m[8], syy = m[9], syz = m[10], szz = m[11];
    const float diam = m[12];

    // ops/cellstats.py:finalize_cell_stats.
    const bool has_valid = cnt >= g.valid_thr;
    const bool continuous = disc_h < g.max_disc && disc_v < g.max_disc;
    mx = sx / g.n;
    my = sy / g.n;
    mz = sz / g.n;
    const dplx::Eig3 e = dplx::eigh3x3_min(sxx, sxy, sxz, syy, syz, szz);
    const float d_raw = -(mx * e.vx + my * e.vy + mz * e.vz);
    const bool keep = d_raw > 0.f;
    nx = keep ? e.vx : -e.vx;
    ny = keep ? e.vy : -e.vy;
    nz = keep ? e.vz : -e.vz;
    d = fabsf(d_raw);
    float mse = e.w0 / g.n;
    const float sigma = g.sigma_coeff * (mz * mz) + g.sigma_margin;
    planar = has_valid && continuous && mse <= sigma * sigma;
    float t = diam * g.sin_angle;      // torch.clamp keeps a NaN
    t = t < g.tol_lo ? g.tol_lo : t;
    t = t > g.tol_hi ? g.tol_hi : t;
    tol = t * t;
    if (!planar) mse = FLT_MAX;           // never seeds

    if (interior) {
      out.planar[i] = planar;
      out.d[i] = d;
      out.mse[i] = mse;
      out.tol[i] = tol;
      float* nrm = out.normal + 3 * i;
      nrm[0] = nx; nrm[1] = ny; nrm[2] = nz;
      float* mean = out.mean + 3 * i;
      mean[0] = mx; mean[1] = my; mean[2] = mz;
      float* cs = out.coord_sum + 3 * i;
      cs[0] = sx; cs[1] = sy; cs[2] = sz;
      float* sc = out.scatter + 9 * i;
      sc[0] = sxx; sc[1] = sxy; sc[2] = sxz;
      sc[3] = sxy; sc[4] = syy; sc[5] = syz;
      sc[6] = sxz; sc[7] = syz; sc[8] = szz;

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
  }
  s_nx[ty][tx] = nx;
  s_ny[ty][tx] = ny;
  s_nz[ty][tx] = nz;
  s_d[ty][tx] = d;
  __syncthreads();
  if (!interior) return;

  // The four in-neighbours (border cells have none), from the tile's halo.
  const int nbr_y[4] = {ty - 1, ty + 1, ty, ty};
  const int nbr_x[4] = {tx, tx, tx - 1, tx + 1};
  const bool inside[4] = {r >= 1, r < gh - 1, c >= 1, c < gw - 1};
  const uint8_t bit[4] = {kFromUp, kFromDown, kFromLeft, kFromRight};
  uint8_t packed = planar ? kPlanar : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = nbr_y[k], xx = nbr_x[k];
    if (inside[k] && admits(s_nx[yy][xx], s_ny[yy][xx], s_nz[yy][xx], s_d[yy][xx], nx, ny,
                            nz, mx, my, mz, tol, g.min_cos))
      packed |= bit[k];
  }
  out.edges[i] = packed;
}

}  // namespace

extern "C" {

// planes: (13, B, gh, gw) float32 in ops/cellstats.py:moments_from_planes
// order. Outputs (all contiguous): planar (B, gh, gw) bool; normal, mean and
// coord_sum (B, gh, gw, 3), scatter (B, gh, gw, 3, 3), d, mse and tol
// (B, gh, gw) float32; nr_pts a 0-d float32; bins (B, gh, gw) int32 (-1 off
// the planar cells); edges (B, gh, gw) uint8 (ops/growing.py:pack_edges).
int dplx_cell_finalize(const void* planes, int B, int gh, int gw, float n, float valid_thr,
                       float max_disc, float sigma_coeff, float sigma_margin,
                       float sin_angle, float tol_lo, float tol_hi, float min_cos,
                       float polar_scale, float azimuth_scale, float pi, int nr_bins,
                       void* planar, void* normal, void* mean, void* d, void* mse,
                       void* tol, void* coord_sum, void* scatter, void* nr_pts, void* bins,
                       void* edges, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const Gates g{n, valid_thr, max_disc, sigma_coeff, sigma_margin, sin_angle, tol_lo,
                tol_hi, min_cos, polar_scale, azimuth_scale, pi, nr_bins};
  const Outputs out{static_cast<bool*>(planar), static_cast<float*>(normal),
                    static_cast<float*>(mean), static_cast<float*>(d),
                    static_cast<float*>(mse), static_cast<float*>(tol),
                    static_cast<float*>(coord_sum), static_cast<float*>(scatter),
                    static_cast<float*>(nr_pts), static_cast<int*>(bins),
                    static_cast<uint8_t*>(edges)};
  const dim3 grid((gw + kInW - 1) / kInW, (gh + kInH - 1) / kInH, B);
  cell_finalize_kernel<<<grid, dim3(kTileW, kTileH), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), B, gh, gw, g, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
