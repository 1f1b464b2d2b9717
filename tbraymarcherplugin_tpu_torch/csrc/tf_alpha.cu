// K3: windowed transfer-function alpha of the occluder field.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_tf.py::
// _alpha_kernel (entry point windowed_tf_alpha). On the TPU the 256-texel
// lookup was a lane shuffle on a packed (8, 128) tile; here it is a direct
// index into a 1 KB alpha table in shared memory. The window (center,
// width, low cutoff, high cutoff) is read from device memory, so it can be a
// tensor that takes a gradient without a host sync.
//
// Bound on the H100: device memory. At 256^3 the pass reads and writes
// 16.8M floats (134 MB), about 40 us at 3.35 TB/s; the table gather and the
// exp/log are a few dozen instructions per element. Design: a grid-stride
// loop over the flat array, one element per thread per step, neighbouring
// threads on neighbouring addresses; the table is loaded once per block.

#include "common.cuh"

__global__ void tf_alpha_kernel(const float* __restrict__ values,
                                const float* __restrict__ tf,
                                const float* __restrict__ win,
                                float* __restrict__ out, long long n,
                                float step) {
  __shared__ float alpha_tab[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    alpha_tab[t] = tf[4 * t + 3];
  }
  __syncthreads();
  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float tf_pos = tbr_tf_pos(values[i], center, half_width, width);
    int i0, i1;
    float frac;
    tbr_tf_taps(tf_pos, &i0, &i1, &frac);
    float a = tbr_lerp(alpha_tab[i0], alpha_tab[i1], frac);
    a = tbr_correct_alpha(a, step);
    out[i] = tbr_cut(tf_pos, low_c, high_c) ? 0.0f : a;
  }
}

TBR_API int tbr_tf_alpha(const float* values, const float* tf,
                         const float* win, float* out, long long n,
                         float step, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks/SM
  tf_alpha_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      values, tf, win, out, n, step);
  return (int)cudaGetLastError();
}

TBR_API const char* tbr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
