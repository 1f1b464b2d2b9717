// K1: front-to-back composite of the pre-sheared shear-warp planes, in the
// three modes of the renderer.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/shearwarp_pallas.py::
// _composite_kernel (entry point shearwarp_intermediate_fused). Per
// intermediate pixel (i, j) and plane k < K, a sample is masked by the
// in-cube test, the clip plane e0 + lam * e1 > 0, termination and, with a
// scene-depth map, lam <= lam_max of the pixel. With jitter, coordinates,
// lambda, value and light all lerp with plane k + 1 by the pixel's delta.
// The mode is a template parameter:
//   - lit: window the value, look up the 256-texel TF (4 channels), clamp
//     and step-correct alpha, modulate by light, over-composite, and snap
//     alpha to 1 once a sample with a > 0 lifts it past the early-
//     termination threshold;
//   - unlit: the same with light 1 (the octree mode; its nearest-texel
//     sampling is in the pre-shear, not here); the light stream is never
//     read;
//   - intensity: the first sample that passes the mask gives the pixel
//     (g, g, g, 1) with g = clamp(tf_pos, 0, 1); no TF, no cutoffs, no
//     light.
//
// Bound on the H100: device memory. The planes stream W (and L in lit
// mode), (K, n1, n2) in bf16 on the main path (about 0.5 GB each at
// 1080p); everything else is per-pixel arithmetic. Design: one thread per
// pixel, n2 the fast axis so that the bf16 loads of W[k] and L[k]
// coalesce; the 4 KB TF and the (5, P) plane coefficients live in shared
// memory and the TF lookup is a direct index. The mask depends on geometry
// only, so a masked sample reads no plane. A thread stops at its pixel's
// termination (intensity: its first hit), and chunks of 16 planes whose
// value range cannot give alpha (exact occupancy flags; all set in
// intensity mode) are skipped.

#include "common.cuh"

namespace {

constexpr int KB = 16;  // planes per occupancy chunk
constexpr int MODE_LIT = 0, MODE_UNLIT = 1, MODE_INTENSITY = 2;

template <typename T, int MODE>
__global__ void composite_kernel(
    const T* __restrict__ W, const T* __restrict__ L,
    const float* __restrict__ tf, const float* __restrict__ pa,
    const int* __restrict__ occ, const float* __restrict__ e1,
    const float* __restrict__ sw, const float* __restrict__ jit,
    const float* __restrict__ dlam, const float* __restrict__ win,
    float* __restrict__ out, int n1, int n2, int k_real, int P, float e0,
    float et, float d1f, float d2f) {
  extern __shared__ __align__(16) float smem[];
  float4* tf4 = reinterpret_cast<float4*>(smem);  // 256 texels
  float* spa = smem + 1024;                       // (5, P)
  if (MODE != MODE_INTENSITY) {
    for (int t = threadIdx.x; t < 1024; t += blockDim.x) smem[t] = tf[t];
  }
  for (int t = threadIdx.x; t < 5 * P; t += blockDim.x) spa[t] = pa[t];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= n2 || i >= n1) return;

  const size_t plane = (size_t)n1 * n2;
  const size_t pix = (size_t)i * n2 + j;
  const float gi = (float)i, gj = (float)j;
  const float e1v = e1[pix];
  const float swv = sw[pix];
  const bool jitter_on = jit != nullptr;
  const float delta = jitter_on ? jit[pix] : 0.0f;
  const bool depth_on = dlam != nullptr;
  const float lam_max = depth_on ? dlam[pix] : 0.0f;
  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float lo1 = -0.5f, hi1 = __fsub_rn(d1f, 0.5f);
  const float hi2 = __fsub_rn(d2f, 0.5f);
  const float* a1 = spa;
  const float* b1 = spa + P;
  const float* a2 = spa + 2 * P;
  const float* b2 = spa + 3 * P;
  const float* lam = spa + 4 * P;

  float rr = 0.0f, rg = 0.0f, rb = 0.0f, alpha = 0.0f;
  for (int k = 0; k < k_real; ++k) {
    if (!occ[k / KB]) {
      k = (k / KB + 1) * KB - 1;  // whole chunk has zero alpha
      continue;
    }
    float v1 = __fadd_rn(a1[k], __fmul_rn(b1[k], gi));
    float v2 = __fadd_rn(a2[k], __fmul_rn(b2[k], gj));
    float lam_px = lam[k];
    if (jitter_on) {
      float v1n = __fadd_rn(a1[k + 1], __fmul_rn(b1[k + 1], gi));
      float v2n = __fadd_rn(a2[k + 1], __fmul_rn(b2[k + 1], gj));
      v1 = tbr_lerp(v1, v1n, delta);
      v2 = tbr_lerp(v2, v2n, delta);
      lam_px = tbr_lerp(lam_px, lam[k + 1], delta);
    }
    bool m = v1 >= lo1 && v1 <= hi1 && v2 >= -0.5f && v2 <= hi2 &&
             __fadd_rn(e0, __fmul_rn(lam_px, e1v)) > 0.0f;
    if (depth_on) m = m && lam_px <= lam_max;
    if (!m) continue;  // contributes exactly zero
    float value = tbr_to_f32(W[k * plane + pix]);
    if (jitter_on) {
      value = tbr_lerp(value, tbr_to_f32(W[(k + 1) * plane + pix]), delta);
    }
    float tf_pos = tbr_tf_pos(value, center, half_width, width);
    if (MODE == MODE_INTENSITY) {
      rr = fminf(fmaxf(tf_pos, 0.0f), 1.0f);  // the first hit
      alpha = 1.0f;
      break;
    }
    if (tbr_cut(tf_pos, low_c, high_c)) continue;  // a == 0 exactly
    float light = 1.0f;
    if (MODE == MODE_LIT) {
      light = tbr_to_f32(L[k * plane + pix]);
      if (jitter_on) {
        light = tbr_lerp(light, tbr_to_f32(L[(k + 1) * plane + pix]), delta);
      }
    }
    int t0, t1;
    float frac;
    tbr_tf_taps(tf_pos, &t0, &t1, &frac);
    float4 c0 = tf4[t0], c1 = tf4[t1];
    float cr = tbr_lerp(c0.x, c1.x, frac);
    float cg = tbr_lerp(c0.y, c1.y, frac);
    float cb = tbr_lerp(c0.z, c1.z, frac);
    float a = tbr_correct_alpha(tbr_lerp(c0.w, c1.w, frac), swv);
    float w = __fmul_rn(__fsub_rn(1.0f, alpha), a);
    rr = __fadd_rn(rr, __fmul_rn(__fmul_rn(w, cr), light));
    rg = __fadd_rn(rg, __fmul_rn(__fmul_rn(w, cg), light));
    rb = __fadd_rn(rb, __fmul_rn(__fmul_rn(w, cb), light));
    float alpha_new = __fadd_rn(alpha, w);
    if (a > 0.0f && alpha_new > et) {
      alpha = 1.0f;  // early-termination snap; the pixel is done
      break;
    }
    alpha = alpha_new;
  }
  if (MODE == MODE_INTENSITY) rg = rb = rr;
  out[pix] = rr;
  out[plane + pix] = rg;
  out[2 * plane + pix] = rb;
  out[3 * plane + pix] = alpha;
}

template <typename T, int MODE>
int launch_mode(const void* W, const void* L, const float* tf,
                const float* pa, const int* occ, const float* e1,
                const float* sw, const float* jit, const float* dlam,
                const float* win, float* out, int n1, int n2, int k_real,
                int P, float e0, float et, float d1f, float d2f,
                void* stream) {
  const int threads = 128;
  dim3 grid((n2 + threads - 1) / threads, n1);
  size_t smem = (1024 + 5 * (size_t)P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(composite_kernel<T, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  composite_kernel<T, MODE><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(L), tf, pa, occ, e1, sw,
      jit, dlam, win, out, n1, n2, k_real, P, e0, et, d1f, d2f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* W, const void* L, const float* tf, const float* pa,
           const int* occ, const float* e1, const float* sw, const float* jit,
           const float* dlam, const float* win, float* out, int n1, int n2,
           int k_real, int P, int mode, float e0, float et, float d1f,
           float d2f, void* stream) {
  switch (mode) {
    case MODE_LIT:
      return launch_mode<T, MODE_LIT>(W, L, tf, pa, occ, e1, sw, jit, dlam,
                                      win, out, n1, n2, k_real, P, e0, et,
                                      d1f, d2f, stream);
    case MODE_UNLIT:
      return launch_mode<T, MODE_UNLIT>(W, L, tf, pa, occ, e1, sw, jit, dlam,
                                        win, out, n1, n2, k_real, P, e0, et,
                                        d1f, d2f, stream);
    case MODE_INTENSITY:
      return launch_mode<T, MODE_INTENSITY>(W, L, tf, pa, occ, e1, sw, jit,
                                            dlam, win, out, n1, n2, k_real, P,
                                            e0, et, d1f, d2f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ``mode``: 0 lit, 1 unlit (L may be null), 2 intensity (L and tf unread,
// L may be null); ``jit`` and ``dlam`` may be null (no jitter, no depth).
#define TBR_COMPOSITE_ARGS                                                   \
  const void *W, const void *L, const float *tf, const float *pa,            \
      const int *occ, const float *e1, const float *sw, const float *jit,    \
      const float *dlam, const float *win, float *out, int n1, int n2,       \
      int k_real, int P, int mode, float e0, float et, float d1f, float d2f, \
      void *stream
#define TBR_COMPOSITE_CALL                                                 \
  W, L, tf, pa, occ, e1, sw, jit, dlam, win, out, n1, n2, k_real, P, mode, \
      e0, et, d1f, d2f, stream

TBR_API int tbr_composite_f32(TBR_COMPOSITE_ARGS) {
  return launch<float>(TBR_COMPOSITE_CALL);
}

TBR_API int tbr_composite_bf16(TBR_COMPOSITE_ARGS) {
  return launch<__nv_bfloat16>(TBR_COMPOSITE_CALL);
}
