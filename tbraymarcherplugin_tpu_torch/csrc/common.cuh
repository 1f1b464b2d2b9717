// Shared helpers of the port's hand-written kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_kernels.py), launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.
//
// Arithmetic that the plain PyTorch versions also do is written with the
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...), which the
// compiler never contracts into fused multiply-adds: each operation rounds
// once, as PyTorch's one-operation-per-kernel eager arithmetic does, so a
// kernel and its plain version can agree bit for bit on the same inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TBR_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float tbr_to_f32(float x) { return x; }
__device__ __forceinline__ float tbr_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a + (b - a) * t, rounded as three separate operations.
__device__ __forceinline__ float tbr_lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

// Windowing: (value - center + width * 0.5) / width.
__device__ __forceinline__ float tbr_tf_pos(float value, float center,
                                            float half_width, float width) {
  return __fdiv_rn(__fadd_rn(__fsub_rn(value, center), half_width), width);
}

// Texel taps of a 256-texel clamp-addressed lookup: x = tf_pos * 256 - 0.5,
// the fraction x - floor(x) is not clipped, both taps are.
__device__ __forceinline__ void tbr_tf_taps(float tf_pos, int* i0, int* i1,
                                            float* frac) {
  float x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
  float i0f = floorf(x);
  *frac = __fsub_rn(x, i0f);
  *i0 = (int)fminf(fmaxf(i0f, 0.0f), 255.0f);
  *i1 = (int)fminf(fmaxf(__fadd_rn(i0f, 1.0f), 0.0f), 255.0f);
}

// Step-size opacity correction 1 - exp(step * log(max(1 - a, 1e-10))) of a
// clamped alpha.
__device__ __forceinline__ float tbr_correct_alpha(float a, float step) {
  a = fminf(fmaxf(a, 0.0f), 1.0f);
  float base = fmaxf(__fsub_rn(1.0f, a), 1e-10f);
  return __fsub_rn(1.0f, expf(__fmul_rn(step, logf(base))));
}

__device__ __forceinline__ bool tbr_cut(float tf_pos, float low_c,
                                        float high_c) {
  return (tf_pos < 0.0f && low_c > 0.0f) || (tf_pos > 1.0f && high_c > 0.0f);
}

template <typename T>
__device__ __forceinline__ T tbr_from_f32(float x);
template <>
__device__ __forceinline__ float tbr_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 tbr_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

// XLA's subgradient of clip(a, 0, 1): 1 inside, 0.5 at an exact bound (ties
// are common: TF plateaus sit at exactly 0), 0 outside.
__device__ __forceinline__ float tbr_clip_grad(float a) {
  if (a > 0.0f && a < 1.0f) return 1.0f;
  return (a == 0.0f || a == 1.0f) ? 0.5f : 0.0f;
}

// Deterministic scatter-add into a warp-private shared-memory histogram:
// hist[c * stride + idx] += v[c] for c < NV, for every lane with `act`.
// Lanes that share `idx` add one at a time in lane order, so the sums do
// not depend on scheduling and every run gives the same bits (shared-memory
// atomics would add in whatever order the lanes arrive). The number of
// rounds is the largest group of lanes on one bin. Every lane of the warp
// must call it: it uses warp collectives. Blocks are one-dimensional.
template <int NV>
__device__ __forceinline__ void tbr_warp_ordered_add(float* hist, int stride,
                                                     int idx, const float* v,
                                                     bool act) {
  const unsigned mask = __ballot_sync(0xffffffffu, act);
  if (mask == 0u) return;  // warp-uniform
  if (act) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned grp = __match_any_sync(mask, idx);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int rounds = (int)__reduce_max_sync(mask, (unsigned)__popc(grp));
    for (int r = 0; r < rounds; ++r) {
      if (rank == r) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          hist[c * stride + idx] = __fadd_rn(hist[c * stride + idx], v[c]);
        }
      }
      __syncwarp(mask);
    }
  }
  __syncwarp();
}

// Bilinear shift of a 2D (H, W) field with a constant border, separable as
// lighting.shift_2d_bilinear_border: the value at (i, j) lerps rows
// i + ix, i + ix + 1 by fx, then columns j + iy, j + iy + 1 by fy; a tap
// outside the field reads `border`. A null `src` is the constant field
// `fill`.
__device__ __forceinline__ float tbr_field_tap(const float* __restrict__ src,
                                               float fill, float border,
                                               int r, int c, int H, int W) {
  if (r < 0 || r >= H) return border;
  return src ? src[(size_t)r * W + c] : fill;
}

__device__ __forceinline__ float tbr_shift2d(const float* __restrict__ src,
                                             float fill, float border, int i,
                                             int j, int H, int W, int ix,
                                             float fx, int iy, float fy) {
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  float t[2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int c = j + iy + dy;
    if (c < 0 || c >= W) {
      t[dy] = border;  // the column pass reads the border outside
    } else {
      const float s0 = tbr_field_tap(src, fill, border, i + ix, c, H, W);
      const float s1 = tbr_field_tap(src, fill, border, i + ix + 1, c, H, W);
      t[dy] = __fadd_rn(__fmul_rn(s0, gx), __fmul_rn(s1, fx));
    }
  }
  return __fadd_rn(__fmul_rn(t[0], gy), __fmul_rn(t[1], fy));
}
