// K2: per-row 1D linear interpolation, the gather of the two-pass screen
// warp.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_warp.py::
// _band_kernel (entry points banded_row_lerp, warp_to_screen_fused):
//   out[r, q] = lerp(rows[r], clip(idx[r % Rq, q], 0, N - 1))
// with i1 = min(i0 + 1, N - 1); the C channel blocks of rows share one index
// array (R = C * Rq). It runs once per warp pass.
//
// Bound on the H100: device memory (reads of idx and rows and writes of out
// are streams; at the bench frame 156 MB for both passes, 0.047 ms). The
// TPU copied one 384-texel band per tile into VMEM, which limited the
// per-tile index spread; here each thread reads its taps straight from
// global memory (L1/L2: a row's taps lie near each other), so any index
// spread is exact.
//
// The first Hopper design gave each thread one output of one (channel, row):
// it read each index once per channel, and each thread's chain (the index,
// two taps, a 4-byte store) kept little in flight. Here a thread takes 4
// consecutive q of one index row and serves all C channel rows: one 16-byte
// index load, then C independent groups of 8 tap loads in flight, and one
// 16-byte streaming store per channel. Threads are laid out flat over
// (index row, q / 4), so no grid dimension limits the rows. Where Q is not
// a multiple of 4 or idx does not start on 16 bytes, the same threads take
// scalar index loads and stores. The arithmetic (clamp, floor, tbr_lerp)
// is the plain version's: the same bits.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 4;         // consecutive q per thread
constexpr int MAX_GROUPS = 4;  // channel rows a thread serves at once

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    row_lerp_kernel(const float* __restrict__ rows,
                    const float* __restrict__ idx, float* __restrict__ out,
                    int groups, int Rq, int N, int Q) {
  const int Q4 = (Q + RUN - 1) / RUN;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)Rq * Q4) return;
  const int rq = (int)(t / Q4);
  const int q = (int)(t - (long long)rq * Q4) * RUN;
  const size_t irow = (size_t)rq * Q;
  float x[RUN];
  if (VEC) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(idx + irow + q));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) x[k] = q + k < Q ? idx[irow + q + k] : 0.0f;
  }
  const float nmax = (float)(N - 1);
  int i0[RUN], i1[RUN];
  float fr[RUN];
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const float ic = fminf(fmaxf(x[k], 0.0f), nmax);
    const float i0f = floorf(ic);
    fr[k] = __fsub_rn(ic, i0f);
    i0[k] = (int)i0f;
    i1[k] = min(i0[k] + 1, N - 1);
  }
  for (int c0 = 0; c0 < groups; c0 += MAX_GROUPS) {
    float a[MAX_GROUPS][RUN], b[MAX_GROUPS][RUN];
#pragma unroll
    for (int c = 0; c < MAX_GROUPS; ++c) {
      if (c0 + c < groups) {
        const float* row = rows + ((size_t)(c0 + c) * Rq + rq) * N;
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
          a[c][k] = __ldg(row + i0[k]);
          b[c][k] = __ldg(row + i1[k]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_GROUPS; ++c) {
      if (c0 + c < groups) {
        float* o = out + ((size_t)(c0 + c) * Rq + rq) * Q + q;
        float y[RUN];
#pragma unroll
        for (int k = 0; k < RUN; ++k) y[k] = tbr_lerp(a[c][k], b[c][k], fr[k]);
        if (VEC) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(y[0], y[1], y[2], y[3]));
        } else {
#pragma unroll
          for (int k = 0; k < RUN; ++k) {
            if (q + k < Q) o[k] = y[k];
          }
        }
      }
    }
  }
}

}  // namespace

// out is (R, Q) with R = groups * Rq, 16-byte aligned.
TBR_API int tbr_row_lerp(const float* rows, const float* idx, float* out,
                         int R, int Rq, int N, int Q, void* stream) {
  if (R <= 0 || Q <= 0) return (int)cudaGetLastError();
  if (Rq <= 0 || R % Rq != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long work = (long long)Rq * ((Q + RUN - 1) / RUN);
  const long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = Q % RUN == 0 && (reinterpret_cast<size_t>(idx) & 15) == 0;
  if (vec) {
    row_lerp_kernel<true><<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(rows, idx, out, R / Rq,
                                                    Rq, N, Q);
  } else {
    row_lerp_kernel<false><<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(rows, idx, out, R / Rq,
                                                     Rq, N, Q);
  }
  return (int)cudaGetLastError();
}
