// K11: the gather probe, out = tab[idx].
//
// Replaces the TPU kernel benchmarks/micro.py::kern (section f of that
// script, a per-lane gather from a table held in VMEM). The index is clamped
// into the table, so a bad index reads an end of the table and never leaves
// it.
//
// Bound on the H100: device memory for the indices and the output (4 B
// each per element; the table once): 8.4 MB at (8, 131072), about 2.5 us at
// 3.35 TB/s. Between the streams sit one million 4-byte gathers from a
// 256 KB table, which L2 holds but one block's shared memory does not.
//
// The first design took one index per thread, so each thread had one
// gather in flight, and gave each SM the default shared-memory/L1 split.
// Here each thread loads its indices eight at a time as two 16-byte
// streaming loads (__ldcs; neighbouring lanes on neighbouring vectors),
// issues all eight gathers before it stores, and writes two 16-byte
// streaming stores (__stcs), so eight gathers per thread are in flight. The
// kernel asks for the smallest shared-memory carveout: it uses none, and
// the rest of the SM's 256 KB serves as L1, where most of the table then
// stays. The grid is the card's resident blocks (SMs times blocks per SM,
// asked once), fewer where the input needs fewer; a grid-stride loop covers
// the rest. Elements after the last whole vector, or all of them when the
// index or output pointer is not 16-byte aligned, take one 4-byte load
// each.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // 16-byte index vectors per thread per iteration

__device__ __forceinline__ float tap(const float* __restrict__ tab, int j,
                                     int hi) {
  return __ldg(tab + min(max(j, 0), hi));
}

__global__ void __launch_bounds__(THREADS)
    gather_probe_kernel(const float* __restrict__ tab,
                        const int* __restrict__ idx, float* __restrict__ out,
                        long long n_vec, long long n, int n_tab) {
  const int hi = n_tab - 1;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long v = t; v < n_vec; v += UNROLL * stride) {
    int4 k[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = v + u * stride;
      k[u] = w < n_vec ? __ldcs(idx4 + w) : make_int4(0, 0, 0, 0);
    }
    float4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      r[u] = make_float4(tap(tab, k[u].x, hi), tap(tab, k[u].y, hi),
                         tap(tab, k[u].z, hi), tap(tab, k[u].w, hi));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = v + u * stride;
      if (w < n_vec) __stcs(out4 + w, r[u]);
    }
  }
  for (long long i = 4 * n_vec + t; i < n; i += stride) {
    out[i] = tap(tab, idx[i], hi);
  }
}

}  // namespace

TBR_API int tbr_gather_probe(const float* tab, const int* idx, float* out,
                             long long n, int n_tab, void* stream) {
  if (n <= 0 || n_tab <= 0) return (int)cudaGetLastError();
  static int resident = 0;  // blocks the card holds at once, asked once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(gather_probe_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  gather_probe_kernel,
                                                  THREADS, 0);
    if (sms * per_sm <= 0) {
      const cudaError_t e = cudaGetLastError();
      return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    resident = sms * per_sm;
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long n_vec = aligned ? n / 4 : 0;
  const long long tail = n - 4 * n_vec;
  long long threads = (n_vec + UNROLL - 1) / UNROLL;
  if (tail > threads) threads = tail;
  long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > resident) blocks = resident;
  gather_probe_kernel<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(tab, idx, out, n_vec, n,
                                                n_tab);
  return (int)cudaGetLastError();
}
