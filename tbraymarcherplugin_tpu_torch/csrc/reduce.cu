// Fixed-order sum of per-block partials, shared by the backward kernels
// that reduce a histogram or a scalar over the whole input (K5, K8). One
// thread per column adds the B rows in order, so the result is the same on
// every run. B is a few hundred to a thousand rows (one per block of the
// producing kernel) and C a few thousand columns: a small pass.

#include "common.cuh"

__global__ void sum_rows_kernel(const float* __restrict__ partials,
                                float* __restrict__ out, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s = __fadd_rn(s, partials[(size_t)b * C + c]);
  out[c] = s;
}

TBR_API int tbr_sum_rows(const float* partials, float* out, int B, int C,
                         void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  sum_rows_kernel<<<(C + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(partials, out, B, C);
  return (int)cudaGetLastError();
}
