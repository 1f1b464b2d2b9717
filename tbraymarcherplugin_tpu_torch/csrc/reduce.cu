// Fixed-order sum of per-block partials, shared by the backward kernels
// that reduce a histogram or a scalar over the whole input (K5, K8): the
// column sums of a (B, C) array. A block takes 32 columns; its 32 warps
// split the rows, warp w adding rows w, w + 32, w + 64, ... in order (a
// warp reads 32 neighbouring floats of a row), and one thread per column
// adds the 32 warp sums in warp order. The order depends on B and C only,
// so the result is the same on every run. B runs to several thousand rows
// (K5 has one per block of its grid), C to a few thousand columns.

#include "common.cuh"

namespace {

constexpr int COLS = 32, SPLIT = 32;  // columns per block, warps per block

__global__ void __launch_bounds__(COLS * SPLIT)
    sum_rows_kernel(const float* __restrict__ partials,
                    float* __restrict__ out, int B, int C) {
  __shared__ float part[SPLIT][COLS + 1];
  const int lane = threadIdx.x % COLS, w = threadIdx.x / COLS;
  const int c = blockIdx.x * COLS + lane;
  float s = 0.0f;
  if (c < C) {
    for (int b = w; b < B; b += SPLIT) {
      s = __fadd_rn(s, partials[(size_t)b * C + c]);
    }
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < C) {
    float t = 0.0f;
    for (int v = 0; v < SPLIT; ++v) t = __fadd_rn(t, part[v][lane]);
    out[c] = t;
  }
}

}  // namespace

TBR_API int tbr_sum_rows(const float* partials, float* out, int B, int C,
                         void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  sum_rows_kernel<<<(C + COLS - 1) / COLS, COLS * SPLIT, 0,
                    (cudaStream_t)stream>>>(partials, out, B, C);
  return (int)cudaGetLastError();
}
