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
// Bound on the H100: the bytes of the samples that pass the mask (W, and L
// where they are shaded) and the operations of the masks and the shading.
// The first design (one thread per pixel, one 2-byte load per plane behind
// the previous plane's branch, every plane of every occupied chunk
// visited, the occupancy flag read from device memory at each plane) was
// bound by its instructions more than by its loads: a visit's
// coordinates, lerps and mask, a sample's window (an IEEE division), a
// shaded sample's logf and expf, each issued for a warp while any of its
// 32 pixels needs them. This design (composite_tile.cuh) cuts the visits:
// a warp takes one tile of 32 pixels of a row and visits only the planes
// of the tile's interval (the TPU kernel's per-tile chunk bounds, at
// plane granularity) and of occupied chunks (a flag in shared memory per
// group of 8 planes); with jitter, plane k + 1's coordinates carry over to
// the next visit. The lit and unlit modes stage each group of 8 planes of
// W, with the next plane under jitter, through shared memory, their loads
// issued together; the light is read where a sample is shaded (staging it
// too cost more bytes than it saved waiting), and intensity mode reads its
// first hit only. The grid has one tile per warp: tiles differ widely in
// work, and a persistent grid left SMs idle behind its slowest warps. The
// 4 KB TF and the (5, P) plane coefficients live in shared memory; the TF
// lookup is a direct index. A thread stops once its pixel has terminated
// (intensity: hit) or passed its λ ceiling (λ grows with k). The
// per-pixel arithmetic is the first design's, operation for operation:
// the same bits.

#include "composite_tile.cuh"

namespace {

using namespace tbr_tile;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MODE_LIT = 0, MODE_UNLIT = 1, MODE_INTENSITY = 2;

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) composite_kernel(
    const T* __restrict__ W, const T* __restrict__ L,
    const float* __restrict__ tf, const float* __restrict__ pa,
    const int* __restrict__ occ, const int2* __restrict__ bounds,
    const float* __restrict__ e1, const float* __restrict__ sw,
    const float* __restrict__ jit, const float* __restrict__ dlam,
    const float* __restrict__ win, float* __restrict__ out, int n1, int n2,
    int P, int nch, float e0, float et, float d1f, float d2f) {
  // intensity mode reads one sample per pixel: a staged group would be
  // read for its first hit only
  constexpr bool STAGED = MODE != MODE_INTENSITY;
  extern __shared__ __align__(16) float smem[];
  float4* tf4 = reinterpret_cast<float4*>(smem);  // 256 texels
  float* stage_w = smem + 1024;                   // (GROUP + 1) x THREADS
  float* spa = stage_w + (STAGED ? (GROUP + 1) * THREADS : 0);  // (5, P)
  int* socc = reinterpret_cast<int*>(spa + 5 * P);
  if (MODE != MODE_INTENSITY) {
    for (int t = threadIdx.x; t < 1024; t += THREADS) smem[t] = tf[t];
  }
  for (int t = threadIdx.x; t < 5 * P; t += THREADS) spa[t] = pa[t];
  for (int t = threadIdx.x; t < nch; t += THREADS) socc[t] = occ[t];
  __syncthreads();

  // this thread's slots: plane s of the staged group at [s * THREADS]
  float* my_w = stage_w + threadIdx.x;
  const size_t plane = (size_t)n1 * n2;
  const bool jitter_on = jit != nullptr;
  const bool depth_on = dlam != nullptr;
  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float hi1 = __fsub_rn(d1f, 0.5f), hi2 = __fsub_rn(d2f, 0.5f);
  const float* a1 = spa;
  const float* b1 = spa + P;
  const float* a2 = spa + 2 * P;
  const float* b2 = spa + 3 * P;
  const float* lam = spa + 4 * P;
  const int tpr = (n2 + TILE - 1) / TILE;  // tiles per row
  const int n_tiles = n1 * tpr;

  for (int tile = blockIdx.x * WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * WARPS) {
    const int i = tile / tpr;
    const int j = (tile - i * tpr) * TILE + (threadIdx.x & 31);
    if (j >= n2) continue;
    const int k_lo = bounds[tile].x, k_hi = bounds[tile].y;
    const size_t pix = (size_t)i * n2 + j;
    const float gi = (float)i, gj = (float)j;
    const float e1v = e1[pix];
    const float swv = MODE != MODE_INTENSITY ? sw[pix] : 0.0f;
    const float delta = jitter_on ? jit[pix] : 0.0f;
    const float lam_max = depth_on ? dlam[pix] : 0.0f;

    float rr = 0.0f, rg = 0.0f, rb = 0.0f, alpha = 0.0f;
    bool live = true;
    // with jitter, plane k + 1's coordinates are plane k + 1's own at the
    // next visit: carried, not recomputed (the same operations)
    int k_next = -1;
    float v1_next = 0.0f, v2_next = 0.0f;
    // groups of GROUP planes in [k_lo, k_hi) whose occupancy chunk is set;
    // with jitter a sample also reads plane k + 1
    const int g_end = (k_hi + GROUP - 1) / GROUP;
    const int k_load = k_hi + (jitter_on ? 1 : 0);
    int g = k_lo < k_hi ? k_lo / GROUP : g_end;
    while (live) {
      while (g < g_end && !socc[g * GROUP / KB]) ++g;
      if (g >= g_end) break;
      const int k0 = g * GROUP;
      if (STAGED) {
        stage<T, GROUP + 1>(my_w, THREADS, W + pix, plane, k0, k_lo, k_load);
      }
      const int s_end = min(GROUP, k_hi - k0);
      for (int s = max(0, k_lo - k0); s < s_end; ++s) {
        const int k = k0 + s;
        float v1, v2;
        if (k == k_next) {
          v1 = v1_next;
          v2 = v2_next;
        } else {
          v1 = __fadd_rn(a1[k], __fmul_rn(b1[k], gi));
          v2 = __fadd_rn(a2[k], __fmul_rn(b2[k], gj));
        }
        float lam_px = lam[k];
        if (jitter_on) {
          v1_next = __fadd_rn(a1[k + 1], __fmul_rn(b1[k + 1], gi));
          v2_next = __fadd_rn(a2[k + 1], __fmul_rn(b2[k + 1], gj));
          k_next = k + 1;
          v1 = tbr_lerp(v1, v1_next, delta);
          v2 = tbr_lerp(v2, v2_next, delta);
          lam_px = tbr_lerp(lam_px, lam[k + 1], delta);
        }
        if (depth_on && !(lam_px <= lam_max)) {
          live = false;  // λ only grows: no later sample passes
          break;
        }
        if (!in_cube(v1, v2, hi1, hi2) ||
            !(__fadd_rn(e0, __fmul_rn(lam_px, e1v)) > 0.0f)) {
          continue;  // contributes exactly zero
        }
        const T* w_k = W + pix + (size_t)k * plane;
        float value = STAGED ? my_w[s * THREADS] : load1<T>(w_k);
        if (jitter_on) {
          value = tbr_lerp(
              value, STAGED ? my_w[(s + 1) * THREADS] : load1<T>(w_k + plane),
              delta);
        }
        const float tf_pos = tbr_tf_pos(value, center, half_width, width);
        if (MODE == MODE_INTENSITY) {
          rr = fminf(fmaxf(tf_pos, 0.0f), 1.0f);  // the first hit
          alpha = 1.0f;
          live = false;
          break;
        }
        if (tbr_cut(tf_pos, low_c, high_c)) continue;  // a == 0 exactly
        float light = 1.0f;
        if (MODE == MODE_LIT) {  // read where a sample is shaded only
          const T* l_k = L + pix + (size_t)k * plane;
          light = load1<T>(l_k);
          if (jitter_on) light = tbr_lerp(light, load1<T>(l_k + plane), delta);
        }
        int t0, t1;
        float frac;
        tbr_tf_taps(tf_pos, &t0, &t1, &frac);
        const float4 c0 = tf4[t0], c1 = tf4[t1];
        const float cr = tbr_lerp(c0.x, c1.x, frac);
        const float cg = tbr_lerp(c0.y, c1.y, frac);
        const float cb = tbr_lerp(c0.z, c1.z, frac);
        const float a = tbr_correct_alpha(tbr_lerp(c0.w, c1.w, frac), swv);
        const float w = __fmul_rn(__fsub_rn(1.0f, alpha), a);
        rr = __fadd_rn(rr, __fmul_rn(__fmul_rn(w, cr), light));
        rg = __fadd_rn(rg, __fmul_rn(__fmul_rn(w, cg), light));
        rb = __fadd_rn(rb, __fmul_rn(__fmul_rn(w, cb), light));
        const float alpha_new = __fadd_rn(alpha, w);
        if (a > 0.0f && alpha_new > et) {
          alpha = 1.0f;  // early-termination snap; the pixel is done
          live = false;
          break;
        }
        alpha = alpha_new;
      }
      ++g;
    }
    if (MODE == MODE_INTENSITY) rg = rb = rr;
    out[pix] = rr;
    out[plane + pix] = rg;
    out[2 * plane + pix] = rb;
    out[3 * plane + pix] = alpha;
  }
}

template <typename T, int MODE>
int launch_mode(const void* W, const void* L, const float* tf,
                const float* pa, const int* occ, const int* bounds,
                const float* e1, const float* sw, const float* jit,
                const float* dlam, const float* win, float* out, int n1,
                int n2, int P, int nch, float e0, float et, float d1f,
                float d2f, void* stream) {
  const long long tiles = (long long)n1 * ((n2 + TILE - 1) / TILE);
  const int blocks = (int)((tiles + WARPS - 1) / WARPS);  // a tile per warp
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem =
      (1024 + (MODE != MODE_INTENSITY ? (GROUP + 1) * THREADS : 0) +
       5 * (size_t)P + nch) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  composite_kernel<T, MODE><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(L), tf, pa, occ,
      reinterpret_cast<const int2*>(bounds), e1, sw, jit, dlam, win, out, n1,
      n2, P, nch, e0, et, d1f, d2f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* W, const void* L, const float* tf, const float* pa,
           const int* occ, const int* bounds, const float* e1,
           const float* sw, const float* jit, const float* dlam,
           const float* win, float* out, int n1, int n2, int k_real, int P,
           int nch, int mode, float e0, float et, float d1f, float d2f,
           void* stream) {
  switch (mode) {
    case MODE_LIT:
      return launch_mode<T, MODE_LIT>(W, L, tf, pa, occ, bounds, e1, sw, jit,
                                      dlam, win, out, n1, n2, P, nch, e0, et,
                                      d1f, d2f, stream);
    case MODE_UNLIT:
      return launch_mode<T, MODE_UNLIT>(W, L, tf, pa, occ, bounds, e1, sw,
                                        jit, dlam, win, out, n1, n2, P, nch,
                                        e0, et, d1f, d2f, stream);
    case MODE_INTENSITY:
      return launch_mode<T, MODE_INTENSITY>(W, L, tf, pa, occ, bounds, e1, sw,
                                            jit, dlam, win, out, n1, n2, P,
                                            nch, e0, et, d1f, d2f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ``mode``: 0 lit, 1 unlit (L may be null), 2 intensity (L and tf unread,
// L may be null); ``jit`` and ``dlam`` may be null (no jitter, no depth).
// ``bounds`` is (n1, ceil(n2 / 32), 2) int32 [k_lo, k_hi) per tile
// (tile_plane_bounds), ``occ`` the nch chunk flags.
#define TBR_COMPOSITE_ARGS                                                   \
  const void *W, const void *L, const float *tf, const float *pa,            \
      const int *occ, const int *bounds, const float *e1, const float *sw,   \
      const float *jit, const float *dlam, const float *win, float *out,     \
      int n1, int n2, int k_real, int P, int nch, int mode, float e0,        \
      float et, float d1f, float d2f, void *stream
#define TBR_COMPOSITE_CALL                                                  \
  W, L, tf, pa, occ, bounds, e1, sw, jit, dlam, win, out, n1, n2, k_real, P, \
      nch, mode, e0, et, d1f, d2f, stream

TBR_API int tbr_composite_f32(TBR_COMPOSITE_ARGS) {
  return launch<float>(TBR_COMPOSITE_CALL);
}

TBR_API int tbr_composite_bf16(TBR_COMPOSITE_ARGS) {
  return launch<__nv_bfloat16>(TBR_COMPOSITE_CALL);
}
