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
// at 256^3, 0.060 ms at 3.35 TB/s). The TPU built the 256-bin histogram as
// one-hot matmuls on the MXU.
//
// The first Hopper design gave each lane one element and added it through
// tbr_warp_ordered_add, and each call ended in eight more device operations
// (the row sums of reduce.cu, fills, a pad, an add, a slice assignment, a
// cat): 0.141 ms on the device at the bench faces (NVIDIA H100 80GB HBM3,
// 700 W). This design is K10b's (tf_rgba_bwd.cu) for one channel:
// - Each thread takes a run of 4 consecutive elements with one 16-byte
//   load each of values and g, and writes dval as one 16-byte streaming
//   store; a view that does not start on 16 bytes, and the ragged tail,
//   take scalar loads and stores. The next run's loads are issued before
//   this run's arithmetic.
// - An element whose g is 0 or that a cutoff drops has ga = gx = 0 (the
//   step correction is finite): it skips the lookup, log and exp. On the
//   bench faces about 4 in 5 elements add nothing, most of them cut.
// - It merges the histogram values of consecutive elements on one texel in
//   registers, in element order, and adds a merged run when the next
//   element leaves its texel (the warp adds together, add_runs).
// - Each warp keeps a private 2 x 257 histogram (the floor taps; the frac
//   taps one texel up, so the two never share an address and one round
//   adds both); lanes on one texel add one at a time in lane order. A
//   shuffle tree for warps whose adding lanes all sit on one texel was
//   tried and measured slower: on the bench faces under 0.3% of a warp's
//   128 elements share one texel (PERF_HISTORY.md).
// - The window sums gather sum gx and sum gx * (0.5 - tf_pos); the last
//   block scales them by -256 / width and 256 / width.
// - Each block sums its warps' histograms in warp order and writes one row
//   of per-block partials; the last block to finish (a counter in device
//   memory that the wrapper allocates once per device and stream, and that
//   this block sets back to 0) sums the rows in block order and writes dTF
//   (256, 4), RGB zero, and the window's (d center, d width, 0, 0): one
//   launch and no other device operation per call.
// Every sum runs in an order fixed by the data's layout, never by the
// scheduling: two launches on the same inputs give the same bits. What
// bounds it now: the streams (the three alone take 0.070 ms in this
// launch shape on the same card, 86% of the bound) and the live
// elements' arithmetic.

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 4;            // consecutive elements per thread
constexpr int BINS = 257;         // texels, and one past the top
constexpr int WHIST = 2 * BINS;   // one warp's histogram: [tap][bin]
constexpr int ROW = 256 + 2;      // a block's partials: dTF alpha, dc, dw
constexpr int PARTS = 4;          // the last block's split of the blocks
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = (256 + WARPS * WHIST) * sizeof(float);

// h[bin] += lo and h[BINS + bin + 1] += hi for every lane with `add`:
// lanes on one texel add one at a time in lane order (the floor and the
// frac taps of a round never share an address). Every lane of the warp
// calls it.
__device__ __forceinline__ void add_runs(float* wh, int bin, float lo,
                                         float hi, bool add) {
  const unsigned mask = __ballot_sync(FULL, add);
  if (mask == 0u) return;  // warp-uniform
  if (add) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned grp = __match_any_sync(mask, bin);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int rounds = (int)__reduce_max_sync(mask, (unsigned)__popc(grp));
    for (int r = 0; r < rounds; ++r) {
      if (rank == r) {
        wh[bin] = __fadd_rn(wh[bin], lo);
        wh[BINS + bin + 1] = __fadd_rn(wh[BINS + bin + 1], hi);
      }
      __syncwarp(mask);
    }
  }
  __syncwarp();
}

// Run q of 4 elements of x into r: one 16-byte load where the run is whole
// and x starts on 16 bytes, else scalar loads (0 past n).
__device__ __forceinline__ void load_run(const float* __restrict__ x,
                                         bool vec, long long q, long long n,
                                         float* r) {
  const long long i = q * RUN;
  if (vec && i + RUN <= n) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(x) + q);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) r[k] = i + k < n ? x[i + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    tf_alpha_bwd_kernel(const float* __restrict__ values,
                        const float* __restrict__ tf,
                        const float* __restrict__ win,
                        const float* __restrict__ g, float* __restrict__ dval,
                        float* __restrict__ partials,
                        unsigned* __restrict__ counter,
                        float* __restrict__ dtf, float* __restrict__ dwin,
                        long long n, float step) {
  extern __shared__ float smem[];
  float* alpha_tab = smem;
  float* hist = smem + 256;
  __shared__ float red[2][WARPS];
  __shared__ float part[PARTS][ROW];
  __shared__ bool last_block;
  for (int t = threadIdx.x; t < 256; t += THREADS) alpha_tab[t] = tf[4 * t + 3];
  for (int t = threadIdx.x; t < WARPS * WHIST; t += THREADS) hist[t] = 0.0f;
  __syncthreads();

  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float s256w = __fdiv_rn(256.0f, width);
  const float sm1 = __fsub_rn(step, 1.0f);
  float* wh = hist + (threadIdx.x >> 5) * WHIST;
  // 16-byte loads where the view starts on 16 bytes (dval always does)
  const bool vec_v = (reinterpret_cast<size_t>(values) & 15) == 0;
  const bool vec_g = (reinterpret_cast<size_t>(g) & 15) == 0;
  // sum gx and sum gx * (0.5 - tf_pos); the last block scales them
  float acc_c = 0.0f, acc_w = 0.0f;

  const long long runs = (n + RUN - 1) / RUN;
  const long long stride = (long long)gridDim.x * THREADS;
  float vn[RUN], gn[RUN];  // the next run's values and g, in flight
  long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  load_run(values, vec_v, q, n, vn);
  load_run(g, vec_g, q, n, gn);
  for (long long base = (long long)blockIdx.x * THREADS; base < runs;
       base += stride, q += stride) {  // block-uniform trip count
    const long long i = q * RUN;
    float v[RUN], gi[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      v[k] = vn[k];
      gi[k] = gn[k];
    }
    load_run(values, vec_v, q + stride, n, vn);
    load_run(g, vec_g, q + stride, n, gn);

    float dv[RUN];
    int cur = -1;  // the texel of the run being merged, -1 before one
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const float tf_pos = tbr_tf_pos(v[k], center, half_width, width);
      const bool in = i + k < n;
      // an element whose g * keep is 0 has ga = gx = 0 (its step
      // correction is finite): it adds nothing and skips the alpha
      const bool live =
          in && gi[k] != 0.0f && !tbr_cut(tf_pos, low_c, high_c);
      float ga = 0.0f, gx = 0.0f, frac = 0.0f, x = 0.0f;
      int i0 = 0;
      if (live) {
        x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
        int i1;
        tbr_tf_taps(tf_pos, &i0, &i1, &frac);
        const float a0 = alpha_tab[i0], a1 = alpha_tab[i1];
        const float a_raw = tbr_lerp(a0, a1, frac);
        const float a_clip = fminf(fmaxf(a_raw, 0.0f), 1.0f);
        const float one_m = __fsub_rn(1.0f, a_clip);
        const float logb = logf(fmaxf(one_m, 1e-10f));
        const float basemask = one_m >= 1e-10f ? 1.0f : 0.0f;
        const float dcorr =
            __fmul_rn(__fmul_rn(step, expf(__fmul_rn(sm1, logb))), basemask);
        ga = __fmul_rn(__fmul_rn(gi[k], dcorr), tbr_clip_grad(a_raw));
        gx = __fmul_rn(ga, __fsub_rn(a1, a0));
        acc_c = __fadd_rn(acc_c, gx);
        acc_w = __fadd_rn(acc_w, __fmul_rn(gx, __fsub_rn(0.5f, tf_pos)));
      }
      dv[k] = __fmul_rn(gx, s256w);
      const bool hit = ga != 0.0f;
      // a lane whose run ends here adds it before it starts the next; the
      // warp adds together
      const bool ends = hit && cur >= 0 && i0 != cur;
      if (__any_sync(FULL, ends)) {
        add_runs(wh, cur, lo, hi, ends);
        if (ends) {
          cur = -1;
          lo = hi = 0.0f;
        }
      }
      if (hit) {
        const bool in_rng = x >= 0.0f && x < 255.0f;
        cur = i0;
        lo = __fadd_rn(lo, __fmul_rn(ga, in_rng ? __fsub_rn(1.0f, frac)
                                                : 1.0f));
        hi = __fadd_rn(hi, __fmul_rn(ga, in_rng ? frac : 0.0f));
      }
    }
    add_runs(wh, cur, lo, hi, cur >= 0);

    if (i + RUN <= n) {
      __stcs(reinterpret_cast<float4*>(dval) + q,
             make_float4(dv[0], dv[1], dv[2], dv[3]));
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        if (i + k < n) dval[i + k] = dv[k];
      }
    }
  }

  // the block's warps' window sums, in a fixed tree order
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    acc_c = __fadd_rn(acc_c, __shfl_down_sync(FULL, acc_c, d));
    acc_w = __fadd_rn(acc_w, __shfl_down_sync(FULL, acc_w, d));
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = acc_c;
    red[1][threadIdx.x >> 5] = acc_w;
  }
  __syncthreads();

  float* row = partials + (size_t)blockIdx.x * ROW;
  for (int t = threadIdx.x; t < 256; t += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) {  // floor tap, then frac tap
      s = __fadd_rn(s, hist[w * WHIST + t]);
      s = __fadd_rn(s, hist[w * WHIST + BINS + t]);
    }
    row[t] = s;
  }
  if (threadIdx.x < 2) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, red[threadIdx.x][w]);
    row[256 + threadIdx.x] = s;
  }
  __threadfence();  // the row is visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // the rows in block order: PARTS consecutive ranges of blocks, each
  // summed by one thread (8 loads in flight), then the ranges in order
  const int nb = (int)gridDim.x;
  for (int t = threadIdx.x; t < PARTS * ROW; t += THREADS) {
    const int p = t / ROW, c = t % ROW;
    const int b0 = nb * p / PARTS, b1 = nb * (p + 1) / PARTS;
    float s = 0.0f;
    for (int b = b0; b < b1; b += 8) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[k] = b + k < b1 ? __ldcg(partials + (size_t)(b + k) * ROW + c)
                          : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (b + k < b1) s = __fadd_rn(s, x[k]);
      }
    }
    part[p][c] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ROW; t += THREADS) {
    float s = part[0][t];
#pragma unroll
    for (int p = 1; p < PARTS; ++p) s = __fadd_rn(s, part[p][t]);
    if (t < 256) {
      dtf[4 * t] = 0.0f;
      dtf[4 * t + 1] = 0.0f;
      dtf[4 * t + 2] = 0.0f;
      dtf[4 * t + 3] = s;
    } else if (t == 256) {  // d center = sum gx * -256 / width
      dwin[0] = __fmul_rn(s, __fdiv_rn(-256.0f, win[1]));
    } else {  // d width = sum gx * (0.5 - tf_pos) * 256 / width
      dwin[1] = __fdiv_rn(__fmul_rn(s, 256.0f), win[1]);
    }
  }
  if (threadIdx.x < 2) dwin[2 + threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

}  // namespace

// values, g and dval hold n float32s (dval 16-byte aligned); partials is
// (blocks, 258) scratch, counter one unsigned that is 0 between launches;
// dtf (256, 4) and dwin (4,) are written whole.
TBR_API int tbr_tf_alpha_bwd(const float* values, const float* tf,
                             const float* win, const float* g, float* dval,
                             float* partials, unsigned* counter, float* dtf,
                             float* dwin, long long n, float step, int blocks,
                             void* stream) {
  if (blocks <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  static bool ready = false;  // the shared-memory limit, raised once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tf_alpha_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  tf_alpha_bwd_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      values, tf, win, g, dval, partials, counter, dtf, dwin, n, step);
  return (int)cudaGetLastError();
}
