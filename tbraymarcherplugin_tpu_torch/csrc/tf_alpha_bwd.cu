// K8: backward of the windowed TF alpha of the occluder field (K3).
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_tf.py::
// _alpha_bwd_kernel (entry point windowed_tf_alpha_vjp). Per element, with
// g the cotangent of the alpha, a_raw the lerp of the table's alpha column,
// and the masks and clamps taken as XLA's autodiff takes them (the clip's
// 0.5 subgradient at ties, the 1e-10 floor of the log's argument):
//   ga   = g * keep * step * (1 - a)^(step - 1) * clipgrad(a_raw)
//   gx   = ga * (a1 - a0)                     (slope of the lerp in texels)
//   dval = gx * 256 / width,   d center += -gx * 256 / width,
//   d width += gx * 256 * (0.5 - tf_pos) / width
// and the TF alpha column takes ga * (1 - frac) at texel i0 and ga * frac
// at i0 + 1 (the whole ga at the clamped edges, where both taps coincide).
// The step is a host constant and takes no gradient.
//
// Bound on the H100: device memory (reads values and g, writes dval: 201 MB
// at 256^3, about 60 us) plus the histogram. The TPU built the 256-bin
// histogram as one-hot matmuls on the MXU; here each warp owns a 512-bin
// shared-memory histogram (the two lerp taps, both kept at texel i0 and
// the second shifted by one texel afterwards) and lanes that hit the same
// bin add in lane order (common.cuh, tbr_warp_ordered_add), so no atomics
// and the same bits on every run. Each block writes its histogram and its
// center/width sums as one row of per-block partials, which reduce.cu sums
// in block order.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW = 2 * 256 + 2;  // [tap(2) x texel(256)], d center, d width

__global__ void __launch_bounds__(THREADS)
    tf_alpha_bwd_kernel(const float* __restrict__ values,
                        const float* __restrict__ tf,
                        const float* __restrict__ win,
                        const float* __restrict__ g, float* __restrict__ dval,
                        float* __restrict__ partials, long long n,
                        float step) {
  __shared__ float alpha_tab[256];
  __shared__ float hist[WARPS * 512];
  __shared__ float red[2][THREADS];
  for (int t = threadIdx.x; t < 256; t += THREADS) alpha_tab[t] = tf[4 * t + 3];
  for (int t = threadIdx.x; t < WARPS * 512; t += THREADS) hist[t] = 0.0f;
  __syncthreads();

  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float s256w = __fdiv_rn(256.0f, width);
  const float neg256w = __fdiv_rn(-256.0f, width);
  const float sm1 = __fsub_rn(step, 1.0f);
  float* wh = hist + (threadIdx.x >> 5) * 512;
  float acc_c = 0.0f, acc_w = 0.0f;

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += stride) {  // block-uniform trip count: the warps stay whole
    const long long i = base + threadIdx.x;
    float w2[2] = {0.0f, 0.0f};
    int i0 = 0;
    bool hit = false;
    if (i < n) {
      const float tf_pos = tbr_tf_pos(values[i], center, half_width, width);
      const float x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
      int i1;
      float frac;
      tbr_tf_taps(tf_pos, &i0, &i1, &frac);
      const float a0 = alpha_tab[i0], a1 = alpha_tab[i1];
      const float a_raw = tbr_lerp(a0, a1, frac);
      const float a_clip = fminf(fmaxf(a_raw, 0.0f), 1.0f);
      const float one_m = __fsub_rn(1.0f, a_clip);
      const float logb = logf(fmaxf(one_m, 1e-10f));
      const float basemask = one_m >= 1e-10f ? 1.0f : 0.0f;
      const float dcorr =
          __fmul_rn(__fmul_rn(step, expf(__fmul_rn(sm1, logb))), basemask);
      const float keep = tbr_cut(tf_pos, low_c, high_c) ? 0.0f : 1.0f;
      const float ga = __fmul_rn(
          __fmul_rn(__fmul_rn(g[i], keep), dcorr), tbr_clip_grad(a_raw));
      const float gx = __fmul_rn(ga, __fsub_rn(a1, a0));
      dval[i] = __fmul_rn(gx, s256w);
      acc_c = __fadd_rn(acc_c, __fmul_rn(gx, neg256w));
      acc_w = __fadd_rn(
          acc_w,
          __fmul_rn(gx, __fdiv_rn(__fmul_rn(256.0f, __fsub_rn(0.5f, tf_pos)),
                                  width)));
      const bool in_rng = x >= 0.0f && x < 255.0f;
      w2[0] = __fmul_rn(ga, in_rng ? __fsub_rn(1.0f, frac) : 1.0f);
      w2[1] = __fmul_rn(ga, in_rng ? frac : 0.0f);
      hit = ga != 0.0f;
    }
    tbr_warp_ordered_add<2>(wh, 256, i0, w2, hit);
  }
  __syncthreads();

  float* row = partials + (size_t)blockIdx.x * ROW;
  for (int t = threadIdx.x; t < 512; t += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, hist[w * 512 + t]);
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
    row[512] = red[0][0];
    row[513] = red[1][0];
  }
}

}  // namespace

// partials is (blocks, 514): per block, the floor-tap histogram (256), the
// frac-tap histogram at the floor texel (256), d center, d width.
TBR_API int tbr_tf_alpha_bwd(const float* values, const float* tf,
                             const float* win, const float* g, float* dval,
                             float* partials, long long n, float step,
                             int blocks, void* stream) {
  if (blocks <= 0) return (int)cudaGetLastError();
  tf_alpha_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      values, tf, win, g, dval, partials, n, step);
  return (int)cudaGetLastError();
}
