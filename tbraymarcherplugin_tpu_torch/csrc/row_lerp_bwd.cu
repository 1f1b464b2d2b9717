// K6: adjoint of the per-row lerp gather (K2), d rows from d out.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_warp.py::
// _band_adjoint_kernel (entry point _banded_row_lerp_adjoint). With
// ic = clip(idx[r % Rq, q], 0, N - 1), i0 = floor(ic), fr = ic - i0 and
// i1 = min(i0 + 1, N - 1):
//   d_rows[r, i0] += g[r, q] * (1 - fr),   d_rows[r, i1] += g[r, q] * fr.
// The index takes no gradient. The TPU kernel clipped its taps into a
// 384-texel band per tile; this kernel keeps no band, so it is exact at any
// index spread (the two agree wherever the spread fits the band).
//
// Bound on the H100: device memory (reads g and idx, writes d_rows: about
// 70 MB per warp pass at 1080p). Design: one warp per row; the warp keeps
// the row's N accumulators in shared memory and walks q in chunks of 32.
// Lanes of a chunk that hit the same texel (a magnifying warp maps a few
// neighbouring q to one texel) add in lane order, chunks in q order
// (common.cuh, tbr_warp_ordered_add): no atomics, the same bits on every
// run. The finished row is written once, coalesced.

#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    row_lerp_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ idx,
                        float* __restrict__ d_rows, int R, int Rq, int N,
                        int Q) {
  extern __shared__ float acc_all[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= R) return;  // a whole warp: no collective is left waiting
  float* acc = acc_all + (threadIdx.x >> 5) * N;
  for (int t = lane; t < N; t += 32) acc[t] = 0.0f;
  __syncwarp();
  const float* irow = idx + (size_t)(r % Rq) * Q;
  const float* grow = g + (size_t)r * Q;
  const float nmax = (float)(N - 1);
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    const bool act = q < Q;
    int i0 = 0, i1 = 0;
    float wa = 0.0f, wb = 0.0f;
    if (act) {
      const float ic = fminf(fmaxf(irow[q], 0.0f), nmax);
      const float i0f = floorf(ic);
      const float fr = __fsub_rn(ic, i0f);
      i0 = (int)i0f;
      i1 = min(i0 + 1, N - 1);
      const float gv = grow[q];
      wa = __fmul_rn(gv, __fsub_rn(1.0f, fr));
      wb = __fmul_rn(gv, fr);
    }
    tbr_warp_ordered_add<1>(acc, 0, i0, &wa, act);
    tbr_warp_ordered_add<1>(acc, 0, i1, &wb, act);
  }
  float* out = d_rows + (size_t)r * N;
  for (int t = lane; t < N; t += 32) out[t] = acc[t];
}

}  // namespace

// The caller checks that 4 * N floats fit one block's shared memory.
TBR_API int tbr_row_lerp_bwd(const float* g, const float* idx, float* d_rows,
                             int R, int Rq, int N, int Q, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)ROWS_PER_BLOCK * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(row_lerp_bwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  row_lerp_bwd_kernel<<<blocks, ROWS_PER_BLOCK * 32, smem,
                        (cudaStream_t)stream>>>(g, idx, d_rows, R, Rq, N, Q);
  return (int)cudaGetLastError();
}
