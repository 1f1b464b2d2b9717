// K11: the gather probe, out = tab[idx].
//
// Replaces the TPU kernel benchmarks/micro.py::kern (section f of that
// script, a per-lane gather from a table held in VMEM). A 65536-entry
// float32 table is 256 KB: more than one block's 227 KB of shared memory,
// so the table is read from L1/L2 (the 50 MB L2 holds it) through the
// read-only path (__ldg). One thread per index, neighbouring threads on
// neighbouring indices; the index is clamped into the table, so a bad index
// reads an end of the table and never leaves it.
//
// Bound on the H100: device memory for the indices and the output (4 B
// each per element; the table once): 8.4 MB at (8, 131072), about 2.5 us
// at 3.35 TB/s. At that size the launch itself (a few us) dominates.

#include "common.cuh"

__global__ void gather_probe_kernel(const float* __restrict__ tab,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, long long n,
                                    int n_tab) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int j = min(max(idx[i], 0), n_tab - 1);
    out[i] = __ldg(tab + j);
  }
}

TBR_API int tbr_gather_probe(const float* tab, const int* idx, float* out,
                             long long n, int n_tab, void* stream) {
  if (n <= 0 || n_tab <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  gather_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(tab, idx, out, n, n_tab);
  return (int)cudaGetLastError();
}
