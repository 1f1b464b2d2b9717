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
// Bound on the H100: device memory. One launch at the bench block (8,
// 1280, 1280) reads the values (4 B per element), g (16 B) and the (1280,
// 1280) step field, and writes d values (4 B; d step another 4 B when
// asked): about 321 MB, 96 us at 3.35 TB/s. The TPU accumulated the 256 x 4
// histogram and the window sums in one output block that its sequential
// grid revisited, the histogram as one-hot matmuls on the MXU.
//
// The first Hopper design gave each lane one element and added its 8
// histogram values through tbr_warp_ordered_add: lanes on one texel added
// one at a time, so a warp whose 32 neighbouring pixels hit one texel took
// 32 rounds of dependent shared-memory adds per 32 elements; its 37 KB of
// static shared memory per 128 threads held an SM to 24 warps; and each
// call ended in seven more device operations (the row sums of reduce.cu, a
// pad, an add, a transpose, a fill, a cat). Here:
// - Each thread takes a run of 4 consecutive elements of a row with one
//   16-byte load of values, four of g and, where the step field's length is
//   a multiple of 4, one of step, and writes d values (and d step) as one
//   16-byte streaming store.
// - It merges the histogram values of consecutive elements on one texel in
//   registers, in element order, and adds a merged run when the next
//   element leaves its texel (the warp adds together, add_runs): lanes on
//   one texel still add in lane order, but once per run of a thread, so a
//   warp all on one texel takes 32 rounds per 128 elements, not per 32.
//   Merging across lanes too (a segmented scan by shuffles) was tried: on
//   the dense path's blocks, where most warps hold one or two elements per
//   texel, its shuffles and registers cost more than the rounds it saves.
// - Each warp keeps a private 4 x 257 histogram (the frac tap at the next
//   texel; the 257th bin only ever takes zeros); 32 warps per block in
//   dynamic shared memory (133 KB with the TF table), one block per SM.
// - Each block sums its warps' histograms in warp order and writes one row
//   of per-block partials; the last block to finish (a counter in device
//   memory that the wrapper allocates once per stream, and that this block
//   sets back to 0) sums the rows in block order and writes dTF (256, 4)
//   and the window's (d center, d width, 0, 0) itself: one launch per call.
// Every sum runs in an order fixed by the data's layout, never by the
// scheduling: two launches on the same inputs give the same bits. What
// bounds it now: the streams and, on blocks where many elements hit, the
// histogram adds (their __match_any_sync and rounds).

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 4;           // consecutive elements per thread
constexpr int BINS = 257;        // texels, and one past the top
constexpr int WHIST = 4 * BINS;  // one warp's histogram: [channel][bin]
constexpr int NT = 4 * 256;      // dTF in a row: [channel][texel]
constexpr int ROW = NT + 2;      // + d center, d width
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = 256 * sizeof(float4) + WARPS * WHIST * sizeof(float);

// hist[c * BINS + bin] += v[c] and hist[c * BINS + bin + 1] += v[4 + c]
// for every lane with `add`: lanes on one texel add one at a time in lane
// order, the floor taps of every round before the frac taps (a frac tap's
// address is the next texel's floor tap). One __match_any_sync serves both
// taps. Every lane of the warp calls it.
__device__ __forceinline__ void add_runs(float* wh, int bin, const float* v,
                                         bool add) {
  const unsigned mask = __ballot_sync(FULL, add);
  if (mask == 0u) return;  // warp-uniform
  if (add) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned grp = __match_any_sync(mask, bin);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int rounds = (int)__reduce_max_sync(mask, (unsigned)__popc(grp));
    for (int tap = 0; tap < 2; ++tap) {
      for (int r = 0; r < rounds; ++r) {
        if (rank == r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* h = wh + c * BINS + bin + tap;
            *h = __fadd_rn(*h, v[4 * tap + c]);
          }
        }
        __syncwarp(mask);
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
    tf_rgba_bwd_kernel(const float* __restrict__ values,
                       const float* __restrict__ tf,
                       const float* __restrict__ win,
                       const float* __restrict__ step,
                       const float4* __restrict__ g, float* __restrict__ dval,
                       float* __restrict__ dstep, float* __restrict__ partials,
                       unsigned* __restrict__ counter,
                       float* __restrict__ dtf, float* __restrict__ dwin,
                       long long n, long long step_n) {
  extern __shared__ float4 smem[];
  float4* tab = smem;
  float* hist = reinterpret_cast<float*>(smem + 256);
  __shared__ float red[2][WARPS];
  __shared__ bool last_block;
  for (int t = threadIdx.x; t < 256; t += THREADS) {
    tab[t] = make_float4(tf[4 * t], tf[4 * t + 1], tf[4 * t + 2],
                         tf[4 * t + 3]);
  }
  for (int t = threadIdx.x; t < WARPS * WHIST; t += THREADS) hist[t] = 0.0f;
  __syncthreads();

  const float center = win[0], width = win[1];
  const float low_c = win[2], high_c = win[3];
  const float half_width = __fmul_rn(width, 0.5f);
  const float s256w = __fdiv_rn(256.0f, width);
  const float neg256w = __fdiv_rn(-256.0f, width);
  float* wh = hist + (threadIdx.x >> 5) * WHIST;
  const bool step_vec = step_n % RUN == 0;
  // i % step_n of the thread's run, carried from one iteration to the next
  // (a 64-bit division per run costs as much as an element's arithmetic)
  const long long step_inc = (long long)gridDim.x * THREADS * RUN % step_n;
  long long si = ((long long)blockIdx.x * THREADS + threadIdx.x) * RUN %
                 step_n;
  float acc_c = 0.0f, acc_w = 0.0f;

  const long long runs = (n + RUN - 1) / RUN;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < runs;
       base += stride) {  // block-uniform trip count: the warps stay whole
    const long long q = base + threadIdx.x;
    const long long i = q * RUN;
    const bool whole = i + RUN <= n;
    float v[RUN], sw[RUN];
    float4 gi[RUN];
    if (whole) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(values) + q);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
#pragma unroll
      for (int k = 0; k < RUN; ++k) gi[k] = __ldcs(g + i + k);
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        const bool in = i + k < n;
        v[k] = in ? values[i + k] : 0.0f;
        gi[k] = in ? g[i + k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    if (whole && step_vec) {
      const float4 t =
          __ldg(reinterpret_cast<const float4*>(step + si));
      sw[0] = t.x; sw[1] = t.y; sw[2] = t.z; sw[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        long long j = si + k;
        while (j >= step_n) j -= step_n;  // at most 3 times
        sw[k] = i + k < n ? __ldg(step + j) : 1.0f;
      }
    }

    float dv[RUN], ds[RUN];
    int cur = -1;  // the texel of the run being merged, -1 before one
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const float tf_pos = tbr_tf_pos(v[k], center, half_width, width);
      const float x = __fsub_rn(__fmul_rn(tf_pos, 256.0f), 0.5f);
      int i0, i1;
      float frac;
      tbr_tf_taps(tf_pos, &i0, &i1, &frac);
      const float4 c0 = tab[i0], c1 = tab[i1];
      const float a_raw = tbr_lerp(c0.w, c1.w, frac);
      const float a_clip = fminf(fmaxf(a_raw, 0.0f), 1.0f);
      const float one_m = __fsub_rn(1.0f, a_clip);
      const float logb = logf(fmaxf(one_m, 1e-10f));
      const float basemask = one_m >= 1e-10f ? 1.0f : 0.0f;
      const float dcorr = __fmul_rn(
          __fmul_rn(sw[k], expf(__fmul_rn(__fsub_rn(sw[k], 1.0f), logb))),
          basemask);
      const float keep = tbr_cut(tf_pos, low_c, high_c) ? 0.0f : 1.0f;
      const float ge[4] = {
          __fmul_rn(gi[k].x, keep), __fmul_rn(gi[k].y, keep),
          __fmul_rn(gi[k].z, keep),
          __fmul_rn(__fmul_rn(__fmul_rn(gi[k].w, keep), dcorr),
                    tbr_clip_grad(a_raw))};
      float gx = __fmul_rn(ge[0], __fsub_rn(c1.x, c0.x));
      gx = __fadd_rn(gx, __fmul_rn(ge[1], __fsub_rn(c1.y, c0.y)));
      gx = __fadd_rn(gx, __fmul_rn(ge[2], __fsub_rn(c1.z, c0.z)));
      gx = __fadd_rn(gx, __fmul_rn(ge[3], __fsub_rn(c1.w, c0.w)));
      dv[k] = __fmul_rn(gx, s256w);
      ds[k] = dstep == nullptr
                  ? 0.0f
                  : __fmul_rn(__fmul_rn(__fmul_rn(gi[k].w, keep),
                                        -expf(__fmul_rn(sw[k], logb))),
                              logb);
      const bool in = i + k < n;
      if (in) {
        acc_c = __fadd_rn(acc_c, __fmul_rn(gx, neg256w));
        acc_w = __fadd_rn(
            acc_w, __fmul_rn(gx, __fdiv_rn(__fmul_rn(256.0f,
                                                     __fsub_rn(0.5f, tf_pos)),
                                           width)));
      }
      const bool in_rng = x >= 0.0f && x < 255.0f;
      const float w_lo = in_rng ? __fsub_rn(1.0f, frac) : 1.0f;
      const float w_hi = in_rng ? frac : 0.0f;
      const bool hit = in && (ge[0] != 0.0f || ge[1] != 0.0f ||
                              ge[2] != 0.0f || ge[3] != 0.0f);
      // a lane whose run ends here adds it before it starts the next; the
      // warp adds together
      const bool ends = hit && cur >= 0 && i0 != cur;
      if (__any_sync(FULL, ends)) {
        add_runs(wh, cur, acc, ends);
        if (ends) {
          cur = -1;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
        }
      }
      if (hit) {
        cur = i0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] = __fadd_rn(acc[c], __fmul_rn(ge[c], w_lo));
          acc[4 + c] = __fadd_rn(acc[4 + c], __fmul_rn(ge[c], w_hi));
        }
      }
    }
    add_runs(wh, cur, acc, cur >= 0);
    si += step_inc;
    if (si >= step_n) si -= step_n;

    if (whole) {
      __stcs(reinterpret_cast<float4*>(dval) + q,
             make_float4(dv[0], dv[1], dv[2], dv[3]));
      if (dstep != nullptr) {
        __stcs(reinterpret_cast<float4*>(dstep) + q,
               make_float4(ds[0], ds[1], ds[2], ds[3]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        if (i + k < n) {
          dval[i + k] = dv[k];
          if (dstep != nullptr) dstep[i + k] = ds[k];
        }
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
  for (int t = threadIdx.x; t < NT; t += THREADS) {
    const int off = (t >> 8) * BINS + (t & 255);
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, hist[w * WHIST + off]);
    row[t] = s;
  }
  if (threadIdx.x < 2) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, red[threadIdx.x][w]);
    row[NT + threadIdx.x] = s;
  }
  __threadfence();  // the row is visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int t = threadIdx.x; t < ROW; t += THREADS) {
    float s = 0.0f;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      s = __fadd_rn(s, __ldcg(partials + (size_t)b * ROW + t));
    }
    if (t < NT) {
      dtf[(t & 255) * 4 + (t >> 8)] = s;  // (texel, channel)
    } else {
      dwin[t - NT] = s;
    }
  }
  if (threadIdx.x < 2) dwin[2 + threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

}  // namespace

// g is (n, 4) float32, channel-last; values and g 16-byte aligned; dstep
// may be null (not computed). partials is (blocks, 1026) scratch, counter
// one unsigned that is 0 between launches; dtf (256, 4) and dwin (4,) are
// written whole.
TBR_API int tbr_tf_rgba_bwd(const float* values, const float* tf,
                            const float* win, const float* step,
                            const float* g, float* dval, float* dstep,
                            float* partials, unsigned* counter, float* dtf,
                            float* dwin, long long n, long long step_n,
                            int blocks, void* stream) {
  if (blocks <= 0 || step_n <= 0) return (int)cudaErrorInvalidValue;
  static bool ready = false;  // the shared-memory limit, raised once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tf_rgba_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  tf_rgba_bwd_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      values, tf, win, step, reinterpret_cast<const float4*>(g), dval, dstep,
      partials, counter, dtf, dwin, n, step_n);
  return (int)cudaGetLastError();
}
