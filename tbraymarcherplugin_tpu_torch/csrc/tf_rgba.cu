// K10a: windowed transfer-function RGBA of the dense shear-warp composite.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_tf.py::
// _rgba_fwd_kernel (entry point windowed_tf_rgba). Per element: the window
// gives tf_pos, the cutoffs zero the sample, the clamp-addressed floor/frac
// taps lerp all four TF channels, and alpha is clamped and corrected for the
// element's step, 1 - exp(step * log(max(1 - a, 1e-10))). On the TPU the
// 256-texel lookup was a lane shuffle on packed (8, 128) tiles; here the
// 4 KB table sits in shared memory as float4 and is indexed directly. The
// window is read from device memory.
//
// The step is a field read as step[i % step_n]: the dense composite passes
// its (n1, n2) field under (B, n1, n2) values, so the field is read from
// L2 and not expanded to the values' size.
//
// Bound on the H100: device memory. One launch at the bench plan (8, 1280,
// 1280) reads the values (4 B per element; the step field, 6.6 MB, once)
// and writes one float4 (16 B): about 20 B per element, 262 MB, 78 us at
// 3.35 TB/s. Design: a grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring addresses, one 16-byte store each.

#include "common.cuh"

__global__ void tf_rgba_kernel(const float* __restrict__ values,
                               const float* __restrict__ tf,
                               const float* __restrict__ win,
                               const float* __restrict__ step,
                               float4* __restrict__ out, long long n,
                               long long step_n) {
  __shared__ float4 tab[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    tab[t] = make_float4(tf[4 * t], tf[4 * t + 1], tf[4 * t + 2],
                         tf[4 * t + 3]);
  }
  __syncthreads();
  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float tf_pos = tbr_tf_pos(values[i], center, half_width, width);
    int i0, i1;
    float frac;
    tbr_tf_taps(tf_pos, &i0, &i1, &frac);
    const float4 c0 = tab[i0], c1 = tab[i1];
    const float a = tbr_correct_alpha(tbr_lerp(c0.w, c1.w, frac),
                                      __ldg(step + i % step_n));
    out[i] = tbr_cut(tf_pos, low_c, high_c)
                 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                 : make_float4(tbr_lerp(c0.x, c1.x, frac),
                               tbr_lerp(c0.y, c1.y, frac),
                               tbr_lerp(c0.z, c1.z, frac), a);
  }
}

// out is (n, 4) float32, channel-last (16-byte aligned: torch allocates it).
TBR_API int tbr_tf_rgba(const float* values, const float* tf,
                        const float* win, const float* step, float* out,
                        long long n, long long step_n, void* stream) {
  if (n <= 0 || step_n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks/SM
  tf_rgba_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      values, tf, win, step, reinterpret_cast<float4*>(out), n, step_n);
  return (int)cudaGetLastError();
}
