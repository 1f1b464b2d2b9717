// K5: backward of the lit shear-warp composite (K1 without jitter).
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/shearwarp_grad.py::
// _composite_bwd_kernel (entry point fused_composite's VJP). Per pixel, with
// a_k the masked step-corrected alpha of plane k, T_{k-1} = prod_{i<k}
// (1 - a_i), P_k = g_rgb . (c_k * l_k) and g_alpha the alpha cotangent
// (zero where the early-termination snap fired):
//   d a_k = T_{k-1} * (P_k - U_k + g_alpha * V_k)
//   U <- a P + (1 - a) U,   V <- (1 - a) V      (k descending, U = 0, V = 1)
// Division-free, so exact even where a == 1. Sweep 1 (k ascending) reruns
// the forward recurrence and stores T_{k-1}; sweep 2 (k descending) emits
// dW (through the TF slopes, times 256 / width), dL = T a g_rgb.c, the
// d TF histogram (both lerp taps of all four channels) and the d center /
// d width sums. Masks, cutoffs and the 0.95 snap are constants, and the
// clip of the TF alpha takes XLA's 0.5 subgradient at exact ties, as the
// JAX package's autodiff oracle does. dW and dL are written in the stream
// type (bf16 on the main path), as the JAX package rounds them.
//
// Bound on the H100: device memory. At 1080p and 150 planes W and L are
// about 0.5 GB each in bf16; the kernel reads W in both sweeps and L in the
// second, writes dW and dL (the same size) and writes and reads the T
// scratch (f32, about 1 GB), each only up to the pixel's termination (the
// zeros past it are written, not computed). Design: one
// thread per pixel with T in a (K, n1, n2) f32 global scratch, n2 the fast
// axis so every plane access coalesces; a thread stops at its pixel's
// termination and skips planes outside the cube or the clip plane. The
// TPU's one-hot MXU histogram becomes a warp-private (8 x 256)-bin
// histogram in shared memory with lane-ordered adds (common.cuh), and the
// blocks walk pixel tiles in a fixed order, so each block's partial row is
// the same on every run; reduce.cu sums the rows in block order.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HIST = 8 * 256;  // [tap(2) x channel(4)][texel]
constexpr int ROW = HIST + 2;  // + d center, d width

template <typename T>
__global__ void __launch_bounds__(THREADS) composite_bwd_kernel(
    const T* __restrict__ W, const T* __restrict__ L,
    const float* __restrict__ tf, const float* __restrict__ pa,
    const float* __restrict__ e1, const float* __restrict__ sw,
    const float* __restrict__ win, const float* __restrict__ g,
    float* __restrict__ tsto, T* __restrict__ dW, T* __restrict__ dL,
    float* __restrict__ partials, int n1, int n2, int k_real, int kp, int P,
    float e0, float et, float d1f, float d2f) {
  extern __shared__ __align__(16) float smem[];
  float4* tf4 = reinterpret_cast<float4*>(smem);  // 256 texels
  float* hist = smem + 1024;                      // WARPS x HIST
  float* red = hist + WARPS * HIST;               // 2 x THREADS
  float* spa = red + 2 * THREADS;                 // (5, P)
  for (int t = threadIdx.x; t < 1024; t += THREADS) smem[t] = tf[t];
  for (int t = threadIdx.x; t < WARPS * HIST; t += THREADS) hist[t] = 0.0f;
  for (int t = threadIdx.x; t < 5 * P; t += THREADS) spa[t] = pa[t];
  __syncthreads();

  const float* a1 = spa;
  const float* b1 = spa + P;
  const float* a2 = spa + 2 * P;
  const float* b2 = spa + 3 * P;
  const float* lam = spa + 4 * P;
  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float s256w = __fdiv_rn(256.0f, width);
  const float neg256w = __fdiv_rn(-256.0f, width);
  const float hi1 = __fsub_rn(d1f, 0.5f), hi2 = __fsub_rn(d2f, 0.5f);
  float* wh = hist + (threadIdx.x >> 5) * HIST;
  const long long plane = (long long)n1 * n2;
  float acc_c = 0.0f, acc_w = 0.0f;

  for (long long base = (long long)blockIdx.x * THREADS; base < plane;
       base += (long long)gridDim.x * THREADS) {  // block-uniform trip count
    const long long p = base + threadIdx.x;
    const bool valid = p < plane;
    const float gi = valid ? (float)(p / n2) : 0.0f;
    const float gj = valid ? (float)(p % n2) : 0.0f;
    const float e1v = valid ? e1[p] : 0.0f;
    const float swv = valid ? sw[p] : 0.0f;
    auto inside = [&](int k) {
      const float v1 = __fadd_rn(a1[k], __fmul_rn(b1[k], gi));
      const float v2 = __fadd_rn(a2[k], __fmul_rn(b2[k], gj));
      return v1 >= -0.5f && v1 <= hi1 && v2 >= -0.5f && v2 <= hi2 &&
             __fadd_rn(e0, __fmul_rn(lam[k], e1v)) > 0.0f;
    };

    // ---- sweep 1: the forward recurrence, storing T_{k-1} ----
    int k_end = 0;  // planes [k_end, kp) are past termination: zero cotangent
    bool term = false;
    if (valid) {
      float alpha = 0.0f;
      k_end = k_real;
      for (int k = 0; k < k_real; ++k) {
        if (!inside(k)) continue;  // a == 0: alpha unchanged
        const float tf_pos = tbr_tf_pos(tbr_to_f32(W[k * plane + p]), center,
                                        half_width, width);
        if (tbr_cut(tf_pos, low_c, high_c)) continue;
        tsto[k * plane + p] = __fsub_rn(1.0f, alpha);
        int t0, t1;
        float frac;
        tbr_tf_taps(tf_pos, &t0, &t1, &frac);
        const float a =
            tbr_correct_alpha(tbr_lerp(tf4[t0].w, tf4[t1].w, frac), swv);
        const float alpha_new =
            __fadd_rn(alpha, __fmul_rn(__fsub_rn(1.0f, alpha), a));
        if (a > 0.0f && alpha_new > et) {
          term = true;
          k_end = k + 1;
          break;
        }
        alpha = alpha_new;
      }
      for (int k = k_end; k < kp; ++k) {
        dW[k * plane + p] = tbr_from_f32<T>(0.0f);
        dL[k * plane + p] = tbr_from_f32<T>(0.0f);
      }
    }

    // ---- sweep 2: k descending, every cotangent ----
    const float g0 = valid ? g[p] : 0.0f;
    const float g1 = valid ? g[plane + p] : 0.0f;
    const float g2 = valid ? g[2 * plane + p] : 0.0f;
    const float galpha =
        valid ? __fmul_rn(g[3 * plane + p], term ? 0.0f : 1.0f) : 0.0f;
    float U = 0.0f, V = 1.0f;
    const int k_top = (int)__reduce_max_sync(0xffffffffu, (unsigned)k_end);
    for (int k = k_top - 1; k >= 0; --k) {
      float wts[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int ia = 0;
      bool hit = false;
      if (k < k_end) {  // implies valid
        float dw = 0.0f, dl = 0.0f;
        const bool in = inside(k);
        const float tf_pos =
            in ? tbr_tf_pos(tbr_to_f32(W[k * plane + p]), center, half_width,
                            width)
               : 0.0f;
        if (in && !tbr_cut(tf_pos, low_c, high_c)) {
          const float Tk = tsto[k * plane + p];
          const float light = tbr_to_f32(L[k * plane + p]);
          const float x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
          int ib;
          float frac;
          tbr_tf_taps(tf_pos, &ia, &ib, &frac);
          const float4 c0 = tf4[ia], c1 = tf4[ib];
          const float cr = tbr_lerp(c0.x, c1.x, frac);
          const float cg = tbr_lerp(c0.y, c1.y, frac);
          const float cb = tbr_lerp(c0.z, c1.z, frac);
          const float a_raw = tbr_lerp(c0.w, c1.w, frac);
          const float a_clip = fminf(fmaxf(a_raw, 0.0f), 1.0f);
          const float one_m = __fsub_rn(1.0f, a_clip);
          const float logb = logf(fmaxf(one_m, 1e-10f));
          const float basemask = one_m >= 1e-10f ? 1.0f : 0.0f;
          const float corr = __fsub_rn(1.0f, expf(__fmul_rn(swv, logb)));
          const float dcorr = __fmul_rn(
              __fmul_rn(swv, expf(__fmul_rn(__fsub_rn(swv, 1.0f), logb))),
              basemask);
          const float gatef = Tk > 0.0f ? 1.0f : 0.0f;  // alive
          const float a_eff = __fmul_rn(gatef, corr);
          const float gl = __fadd_rn(
              __fadd_rn(__fmul_rn(g0, cr), __fmul_rn(g1, cg)),
              __fmul_rn(g2, cb));
          const float Pk = __fmul_rn(gl, light);
          const float da = __fmul_rn(
              Tk, __fadd_rn(__fsub_rn(Pk, U), __fmul_rn(galpha, V)));
          const float w_ = __fmul_rn(Tk, a_eff);
          const float ger = __fmul_rn(__fmul_rn(g0, w_), light);
          const float geg = __fmul_rn(__fmul_rn(g1, w_), light);
          const float geb = __fmul_rn(__fmul_rn(g2, w_), light);
          const float ga = __fmul_rn(
              __fmul_rn(__fmul_rn(da, gatef), dcorr), tbr_clip_grad(a_raw));
          const float gx = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(ger, __fsub_rn(c1.x, c0.x)),
                                  __fmul_rn(geg, __fsub_rn(c1.y, c0.y))),
                        __fmul_rn(geb, __fsub_rn(c1.z, c0.z))),
              __fmul_rn(ga, __fsub_rn(c1.w, c0.w)));
          dw = __fmul_rn(gx, s256w);
          dl = __fmul_rn(w_, gl);
          acc_c = __fadd_rn(acc_c, __fmul_rn(gx, neg256w));
          acc_w = __fadd_rn(
              acc_w, __fmul_rn(gx, __fdiv_rn(__fmul_rn(256.0f,
                                                       __fsub_rn(0.5f, tf_pos)),
                                             width)));
          const bool in_rng = x >= 0.0f && x < 255.0f;
          const float wa = in_rng ? __fsub_rn(1.0f, frac) : 1.0f;
          const float wb = in_rng ? frac : 0.0f;
          wts[0] = __fmul_rn(ger, wa);
          wts[1] = __fmul_rn(geg, wa);
          wts[2] = __fmul_rn(geb, wa);
          wts[3] = __fmul_rn(ga, wa);
          wts[4] = __fmul_rn(ger, wb);
          wts[5] = __fmul_rn(geg, wb);
          wts[6] = __fmul_rn(geb, wb);
          wts[7] = __fmul_rn(ga, wb);
          hit = gatef > 0.0f;
          const float om = __fsub_rn(1.0f, a_eff);
          U = __fadd_rn(__fmul_rn(a_eff, Pk), __fmul_rn(om, U));
          V = __fmul_rn(om, V);
        }
        dW[k * plane + p] = tbr_from_f32<T>(dw);
        dL[k * plane + p] = tbr_from_f32<T>(dl);
      }
      tbr_warp_ordered_add<8>(wh, 256, ia, wts, hit);
    }
  }
  __syncthreads();

  float* row = partials + (size_t)blockIdx.x * ROW;
  for (int t = threadIdx.x; t < HIST; t += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, hist[w * HIST + t]);
    row[t] = s;
  }
  red[threadIdx.x] = acc_c;
  red[THREADS + threadIdx.x] = acc_w;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
      red[THREADS + threadIdx.x] = __fadd_rn(red[THREADS + threadIdx.x],
                                             red[THREADS + threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    row[HIST] = red[0];
    row[HIST + 1] = red[THREADS];
  }
}

template <typename T>
int launch(const void* W, const void* L, const float* tf, const float* pa,
           const float* e1, const float* sw, const float* win, const float* g,
           float* tsto, void* dW, void* dL, float* partials, int n1, int n2,
           int k_real, int kp, int P, int blocks, float e0, float et,
           float d1f, float d2f, void* stream) {
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem =
      (1024 + WARPS * HIST + 2 * THREADS + 5 * (size_t)P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(composite_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  composite_bwd_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(L), tf, pa, e1, sw, win,
      g, tsto, static_cast<T*>(dW), static_cast<T*>(dL), partials, n1, n2,
      k_real, kp, P, e0, et, d1f, d2f);
  return (int)cudaGetLastError();
}

}  // namespace

#define TBR_COMPOSITE_BWD_ARGS                                              \
  const void *W, const void *L, const float *tf, const float *pa,           \
      const float *e1, const float *sw, const float *win, const float *g,   \
      float *tsto, void *dW, void *dL, float *partials, int n1, int n2,     \
      int k_real, int kp, int P, int blocks, float e0, float et, float d1f, \
      float d2f, void *stream
#define TBR_COMPOSITE_BWD_CALL                                              \
  W, L, tf, pa, e1, sw, win, g, tsto, dW, dL, partials, n1, n2, k_real, kp, \
      P, blocks, e0, et, d1f, d2f, stream

// partials is (blocks, 2050): per block, the d TF histogram as
// [tap(2) x channel(4)][texel(256)] (the frac tap kept at the floor texel),
// then d center and d width. tsto is (k_real, n1, n2) f32 scratch; dW and
// dL are (kp, n1, n2) in the stream type and are written in full.
TBR_API int tbr_composite_bwd_f32(TBR_COMPOSITE_BWD_ARGS) {
  return launch<float>(TBR_COMPOSITE_BWD_CALL);
}

TBR_API int tbr_composite_bwd_bf16(TBR_COMPOSITE_BWD_ARGS) {
  return launch<__nv_bfloat16>(TBR_COMPOSITE_BWD_CALL);
}
