// Stage-4 kernel: the greedy merge of adjacent compatible plane segments.
//
// Replaces the TPU kernel deplex_tpu/ops/pallas_merge.py:_merge_kernel (K3).
// For each row r < nr_planes, in order: pid = merge_labels[r]; every column
// c > r adjacent to r whose normal and mean are compatible with pid's
// (cos > min_cos, dist^2 < max_dist) joins pid. The joining columns' counts,
// sums and scatters are combined into pid about the new mean (Chan's
// formula), pid's mean is updated, and its normal and d are refit by the
// smallest-eigenvector fit of common.cuh (a real atan2, not the TPU
// kernel's polynomial). Candidate columns carry their pre-merge stats and the
// representative is refit at the end of the row, as in
// ops/merge.py:merge_planes_from_adjacency.
//
// Bound on the H100 by latency: up to MAXP (64 by default) dependent rows,
// each a few block reductions. Design: one block per frame, one thread per
// plane slot (MAXP <= 1024), the whole plane table in shared memory, and
// block sums in a fixed order so a run is deterministic. Frames run on
// separate SMs and retire on their own.
#include "common.cuh"

namespace {

// Slot state in shared memory, structure of arrays over M slots.
struct Table {
  float* n;     // M
  float* cs;    // 3M
  float* sc;    // 6M: xx, xy, xz, yy, yz, zz
  float* nrm;   // 3M
  float* mean;  // 3M
  float* d;     // M
  int* ml;      // M
};

__global__ void merge_kernel(const uint8_t* __restrict__ assoc,
                             const int* __restrict__ nr_planes,
                             const float* __restrict__ n_in,
                             const float* __restrict__ cs_in,
                             const float* __restrict__ sc_in,
                             const float* __restrict__ nrm_in,
                             const float* __restrict__ mean_in,
                             const float* __restrict__ d_in, int M,
                             float min_cos, float max_dist,
                             int* __restrict__ ml_out, float* __restrict__ n_out,
                             float* __restrict__ cs_out,
                             float* __restrict__ sc_out,
                             float* __restrict__ nrm_out,
                             float* __restrict__ mean_out,
                             float* __restrict__ d_out) {
  extern __shared__ float smem[];
  __shared__ float red[32 * 12];
  Table t{smem, smem + M, smem + 4 * M, smem + 10 * M, smem + 13 * M,
          smem + 16 * M, reinterpret_cast<int*>(smem + 17 * M)};
  const int b = blockIdx.x, c = threadIdx.x;
  const size_t base = (size_t)b * M;
  const bool slot = c < M;
  const int kSym[6] = {0, 1, 2, 4, 5, 8};

  if (slot) {
    t.n[c] = n_in[base + c];
    t.d[c] = d_in[base + c];
    t.ml[c] = c;
    for (int k = 0; k < 3; ++k) {
      t.cs[c * 3 + k] = cs_in[(base + c) * 3 + k];
      t.nrm[c * 3 + k] = nrm_in[(base + c) * 3 + k];
      t.mean[c * 3 + k] = mean_in[(base + c) * 3 + k];
    }
    for (int k = 0; k < 6; ++k) t.sc[c * 6 + k] = sc_in[(base + c) * 9 + kSym[k]];
  }
  __syncthreads();

  const int rows = min(nr_planes[b], M);
  for (int r = 0; r < rows; ++r) {
    const int pid = t.ml[r];
    const float px = t.nrm[pid * 3], py = t.nrm[pid * 3 + 1], pz = t.nrm[pid * 3 + 2];
    const float dp = t.d[pid];
    bool passing = false;
    if (slot && c > r && assoc[(base + r) * M + c]) {
      const float cosv = t.nrm[c * 3] * px + t.nrm[c * 3 + 1] * py + t.nrm[c * 3 + 2] * pz;
      const float off = t.mean[c * 3] * px + t.mean[c * 3 + 1] * py + t.mean[c * 3 + 2] * pz + dp;
      passing = cosv > min_cos && off * off < max_dist;
    }
    const float w = passing ? 1.f : 0.f;
    const float nc = slot ? t.n[c] : 0.f;
    float a[5] = {w, w * nc, 0.f, 0.f, 0.f};
    if (slot)
      for (int k = 0; k < 3; ++k) a[2 + k] = w * t.cs[c * 3 + k];
    dplx::block_sum<5>(a, red);
    if (a[0] == 0.f) continue;  // no column joins: the row changes nothing

    const float new_n = t.n[pid] + a[1];
    const float new_s[3] = {t.cs[pid * 3] + a[2], t.cs[pid * 3 + 1] + a[3],
                            t.cs[pid * 3 + 2] + a[4]};
    const float nd = fmaxf(new_n, 1.f);
    const float mu[3] = {new_s[0] / nd, new_s[1] / nd, new_s[2] / nd};

    // Chan combine about mu over the representative and the joining columns.
    const float wall = w + (c == pid ? 1.f : 0.f);
    float s[12];
    for (int k = 0; k < 12; ++k) s[k] = 0.f;
    if (slot) {
      const float den = fmaxf(nc, 1.f);
      const float dm[3] = {t.cs[c * 3] / den - mu[0], t.cs[c * 3 + 1] / den - mu[1],
                           t.cs[c * 3 + 2] / den - mu[2]};
      const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
      for (int k = 0; k < 6; ++k) {
        s[k] = wall * t.sc[c * 6 + k];
        s[6 + k] = wall * nc * dm[pi[k]] * dm[pj[k]];
      }
    }
    dplx::block_sum<12>(s, red);

    if (passing) t.ml[c] = pid;
    if (c == 0) {
      float sc6[6];
      for (int k = 0; k < 6; ++k) sc6[k] = s[k] + s[6 + k];
      float nx, ny, nz, dd;
      dplx::fit_normal_d(sc6[0], sc6[1], sc6[2], sc6[3], sc6[4], sc6[5], new_s[0],
                         new_s[1], new_s[2], nd, &nx, &ny, &nz, &dd);
      t.n[pid] = new_n;
      for (int k = 0; k < 3; ++k) {
        t.cs[pid * 3 + k] = new_s[k];
        t.mean[pid * 3 + k] = mu[k];
      }
      for (int k = 0; k < 6; ++k) t.sc[pid * 6 + k] = sc6[k];
      t.nrm[pid * 3] = nx;
      t.nrm[pid * 3 + 1] = ny;
      t.nrm[pid * 3 + 2] = nz;
      t.d[pid] = dd;
    }
    __syncthreads();
  }

  if (slot) {
    ml_out[base + c] = t.ml[c];
    n_out[base + c] = t.n[c];
    d_out[base + c] = t.d[c];
    for (int k = 0; k < 3; ++k) {
      cs_out[(base + c) * 3 + k] = t.cs[c * 3 + k];
      nrm_out[(base + c) * 3 + k] = t.nrm[c * 3 + k];
      mean_out[(base + c) * 3 + k] = t.mean[c * 3 + k];
    }
    const float* q = t.sc + c * 6;
    const float full[9] = {q[0], q[1], q[2], q[1], q[3], q[4], q[2], q[4], q[5]};
    for (int k = 0; k < 9; ++k) sc_out[(base + c) * 9 + k] = full[k];
  }
}

}  // namespace

extern "C" {

// assoc (B, M, M) uint8; nr_planes (B,) int32; n, d (B, M); coord_sum, normal,
// mean (B, M, 3); scatter (B, M, 3, 3), all float32. Outputs in the same
// layouts, merge_labels (B, M) int32.
int dplx_merge_planes(const void* assoc, const void* nr_planes, const void* n,
                      const void* coord_sum, const void* scatter,
                      const void* normal, const void* mean, const void* d,
                      int B, int M, float min_cos, float max_dist,
                      void* merge_labels, void* n_out, void* coord_sum_out,
                      void* scatter_out, void* normal_out, void* mean_out,
                      void* d_out, void* stream) {
  if (B <= 0 || M <= 0) return (int)cudaSuccess;
  const int threads = (M + 31) / 32 * 32;
  const size_t smem = (size_t)18 * M * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(assoc), static_cast<const int*>(nr_planes),
      static_cast<const float*>(n), static_cast<const float*>(coord_sum),
      static_cast<const float*>(scatter), static_cast<const float*>(normal),
      static_cast<const float*>(mean), static_cast<const float*>(d), M, min_cos,
      max_dist, static_cast<int*>(merge_labels), static_cast<float*>(n_out),
      static_cast<float*>(coord_sum_out), static_cast<float*>(scatter_out),
      static_cast<float*>(normal_out), static_cast<float*>(mean_out),
      static_cast<float*>(d_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
