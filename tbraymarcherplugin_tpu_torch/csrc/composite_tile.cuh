// The tile and staging design shared by K1 (composite.cu) and K5
// (composite_bwd.cu), the shear-warp composite and its backward.
//
// Both stream the pre-sheared planes W (and L), (K, n1, n2), n2 the fast
// axis, and do a short, data-dependent computation per (pixel, plane). The
// first Hopper designs gave each thread one pixel and issued one 2-byte
// load per plane behind the previous plane's branch, and visited every
// plane: a warp kept 64 bytes in flight, each visit behind its own load. Here:
// - A warp's tile is 32 neighbouring pixels of one row, a thread's one
//   pixel of it, so a warp's loads of a plane coalesce and enough warps
//   stay resident to hide the arithmetic's latency. The tile's plane
//   interval [k_lo, k_hi) comes from the host
//   (ops/composite.py::tile_plane_bounds, geometry only): no thread visits
//   a plane its tile's footprint misses.
// - Planes go in groups of GROUP: a thread issues the loads of a whole
//   group (GROUP + 1 planes with jitter) before it uses any, GROUP loads
//   in flight per stream instead of one, and parks the values in its own
//   slots of shared memory, from which the group's per-plane loop (not
//   unrolled: its body stays small in the instruction cache) reads them.
// - Per-pixel arithmetic is that of the first designs, operation for
//   operation: the outputs keep their bits.
// A first version of this design gave each thread 4 pixels, with the
// group's values in registers and the per-plane code unrolled over 8
// planes x 4 pixels: 155-226 registers, tens of KB of code per kernel,
// and K1 took 2.5x, K5 7.7x the first designs' times.
#pragma once

#include "common.cuh"

namespace tbr_tile {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 32;   // a warp's tile: one row of TILE pixels
constexpr int GROUP = 8;   // planes staged at once
constexpr int KB = 16;     // planes per occupancy chunk (K1)

// One read-only element as float (bf16: the high half of a float).
template <typename T>
__device__ __forceinline__ float load1(const T* __restrict__ p) {
  if constexpr (sizeof(T) == 2) {
    const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float((unsigned)b << 16);
  } else {
    return __ldg(reinterpret_cast<const float*>(p));
  }
}

// Load planes [k0, k0 + N) of one pixel into v: all N loads go out
// before any is used; planes outside [k_from, k_to) are not read (0).
template <typename T, int N>
__device__ __forceinline__ void load_group(float (&v)[N],
                                           const T* __restrict__ base,
                                           size_t plane, int k0, int k_from,
                                           int k_to) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int k = k0 + s;
    v[s] = (k >= k_from && k < k_to) ? load1<T>(base + (size_t)k * plane)
                                     : 0.0f;
  }
}

// Park a loaded group in the thread's slots slot[s * stride].
template <int N>
__device__ __forceinline__ void park(float* slot, int stride,
                                     const float (&v)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) slot[s * stride] = v[s];
}

// load_group, then park.
template <typename T, int N>
__device__ __forceinline__ void stage(float* slot, int stride,
                                      const T* __restrict__ base,
                                      size_t plane, int k0, int k_from,
                                      int k_to) {
  float v[N];
  load_group<T, N>(v, base, plane, k0, k_from, k_to);
  park<N>(slot, stride, v);
}

// The pixel's in-cube test at plane k for the sample coordinates v1, v2.
__device__ __forceinline__ bool in_cube(float v1, float v2, float hi1,
                                        float hi2) {
  return v1 >= -0.5f && v1 <= hi1 && v2 >= -0.5f && v2 <= hi2;
}

}  // namespace tbr_tile
