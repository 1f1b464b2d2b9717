// K10b: backward of the windowed TF RGBA unit (K10a).
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_tf.py::
// _rgba_bwd_kernel (entry point windowed_tf_rgba's custom VJP). Per
// element, with g the (r, g, b, a) cotangent, the masks and clamps taken as
// XLA's autodiff takes them (the clip's 0.5 subgradient at ties, the 1e-10
// floor of the log's argument):
//   ge_c = g_c * keep                     (colour channels, c < 3)
//   ge_3 = g_3 * keep * step * (1 - a)^(step - 1) * clipgrad(a_raw)
//   gx   = sum_c ge_c * (tf[i1, c] - tf[i0, c])   (c = 0, 1, 2, 3 in order)
//   dval = gx * 256 / width,   d center += -gx * 256 / width,
//   d width += gx * 256 * (0.5 - tf_pos) / width,
//   dstep = g_3 * keep * -(1 - a)^step * log(1 - a)   (only when asked)
// and TF channel c takes ge_c * (1 - frac) at texel i0 and ge_c * frac at
// i0 + 1 (the whole ge_c at the clamped ends, where both taps coincide).
//
// Bound on the H100: device memory. One launch at the bench plan (8, 1280,
// 1280) reads the values (4 B per element) and g (16 B) and writes d values
// (4 B; d step another 4 B when asked): about 24 B per element, 315 MB, 94
// us at 3.35 TB/s; plus the histogram. The TPU accumulated the 256 x 4
// histogram and the window sums in one output block that its sequential
// grid revisited, the histogram as one-hot matmuls on the MXU. Blocks on
// Hopper run in no order, so, as K5 and K8: each warp owns a (2 taps x 4
// channels x 256) shared-memory histogram (the frac tap kept at the floor
// texel and shifted by one afterwards), lanes that hit one bin add in lane
// order (common.cuh, tbr_warp_ordered_add), and each block writes its
// histogram and its center/width sums as one row of per-block partials that
// reduce.cu sums in block order: two launches give the same bits. Four
// warps per block keep the histograms (32 KB) in static shared memory.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HIST = 2 * 4 * 256;  // [tap(2) x channel(4) x texel(256)]
constexpr int ROW = HIST + 2;      // + d center, d width

__global__ void __launch_bounds__(THREADS)
    tf_rgba_bwd_kernel(const float* __restrict__ values,
                       const float* __restrict__ tf,
                       const float* __restrict__ win,
                       const float* __restrict__ step,
                       const float4* __restrict__ g, float* __restrict__ dval,
                       float* __restrict__ dstep, float* __restrict__ partials,
                       long long n, long long step_n) {
  __shared__ float4 tab[256];
  __shared__ float hist[WARPS * HIST];
  __shared__ float red[2][THREADS];
  for (int t = threadIdx.x; t < 256; t += THREADS) {
    tab[t] = make_float4(tf[4 * t], tf[4 * t + 1], tf[4 * t + 2],
                         tf[4 * t + 3]);
  }
  for (int t = threadIdx.x; t < WARPS * HIST; t += THREADS) hist[t] = 0.0f;
  __syncthreads();

  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float s256w = __fdiv_rn(256.0f, width);
  const float neg256w = __fdiv_rn(-256.0f, width);
  float* wh = hist + (threadIdx.x >> 5) * HIST;
  float acc_c = 0.0f, acc_w = 0.0f;

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += stride) {  // block-uniform trip count: the warps stay whole
    const long long i = base + threadIdx.x;
    float w8[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int i0 = 0;
    bool hit = false;
    if (i < n) {
      const float tf_pos = tbr_tf_pos(values[i], center, half_width, width);
      const float x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
      int i1;
      float frac;
      tbr_tf_taps(tf_pos, &i0, &i1, &frac);
      const float4 c0 = tab[i0], c1 = tab[i1];
      const float4 gi = g[i];
      const float sw = __ldg(step + i % step_n);
      const float a_raw = tbr_lerp(c0.w, c1.w, frac);
      const float a_clip = fminf(fmaxf(a_raw, 0.0f), 1.0f);
      const float one_m = __fsub_rn(1.0f, a_clip);
      const float logb = logf(fmaxf(one_m, 1e-10f));
      const float basemask = one_m >= 1e-10f ? 1.0f : 0.0f;
      const float dcorr = __fmul_rn(
          __fmul_rn(sw, expf(__fmul_rn(__fsub_rn(sw, 1.0f), logb))),
          basemask);
      const float keep = tbr_cut(tf_pos, low_c, high_c) ? 0.0f : 1.0f;
      const float ge[4] = {
          __fmul_rn(gi.x, keep), __fmul_rn(gi.y, keep),
          __fmul_rn(gi.z, keep),
          __fmul_rn(__fmul_rn(__fmul_rn(gi.w, keep), dcorr),
                    tbr_clip_grad(a_raw))};
      float gx = __fmul_rn(ge[0], __fsub_rn(c1.x, c0.x));
      gx = __fadd_rn(gx, __fmul_rn(ge[1], __fsub_rn(c1.y, c0.y)));
      gx = __fadd_rn(gx, __fmul_rn(ge[2], __fsub_rn(c1.z, c0.z)));
      gx = __fadd_rn(gx, __fmul_rn(ge[3], __fsub_rn(c1.w, c0.w)));
      dval[i] = __fmul_rn(gx, s256w);
      if (dstep != nullptr) {
        dstep[i] = __fmul_rn(
            __fmul_rn(__fmul_rn(gi.w, keep), -expf(__fmul_rn(sw, logb))),
            logb);
      }
      acc_c = __fadd_rn(acc_c, __fmul_rn(gx, neg256w));
      acc_w = __fadd_rn(
          acc_w,
          __fmul_rn(gx, __fdiv_rn(__fmul_rn(256.0f, __fsub_rn(0.5f, tf_pos)),
                                  width)));
      const bool in_rng = x >= 0.0f && x < 255.0f;
      const float w_lo = in_rng ? __fsub_rn(1.0f, frac) : 1.0f;
      const float w_hi = in_rng ? frac : 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w8[c] = __fmul_rn(ge[c], w_lo);
        w8[4 + c] = __fmul_rn(ge[c], w_hi);
        hit = hit || ge[c] != 0.0f;
      }
    }
    tbr_warp_ordered_add<8>(wh, 256, i0, w8, hit);
  }
  __syncthreads();

  float* row = partials + (size_t)blockIdx.x * ROW;
  for (int t = threadIdx.x; t < HIST; t += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, hist[w * HIST + t]);
    row[t] = s;
  }
  red[0][threadIdx.x] = acc_c;
  red[1][threadIdx.x] = acc_w;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] = __fadd_rn(red[0][threadIdx.x],
                                      red[0][threadIdx.x + s]);
      red[1][threadIdx.x] = __fadd_rn(red[1][threadIdx.x],
                                      red[1][threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    row[HIST] = red[0][0];
    row[HIST + 1] = red[1][0];
  }
}

}  // namespace

// g is (n, 4) float32, channel-last; dstep may be null (not computed).
// partials is (blocks, 2050): per block, the floor-tap histograms (4 x
// 256), the frac-tap histograms at the floor texel (4 x 256), d center,
// d width.
TBR_API int tbr_tf_rgba_bwd(const float* values, const float* tf,
                            const float* win, const float* step,
                            const float* g, float* dval, float* dstep,
                            float* partials, long long n, long long step_n,
                            int blocks, void* stream) {
  if (blocks <= 0 || step_n <= 0) return (int)cudaGetLastError();
  tf_rgba_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      values, tf, win, step, reinterpret_cast<const float4*>(g), dval, dstep,
      partials, n, step_n);
  return (int)cudaGetLastError();
}
