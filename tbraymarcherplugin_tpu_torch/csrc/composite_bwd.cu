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
// the forward recurrence up to each pixel's termination; sweep 2 (k
// descending) emits dW (through the TF slopes, times 256 / width), dL =
// T a g_rgb.c, the d TF histogram (both lerp taps of all four channels)
// and the d center / d width sums. Masks, cutoffs and the 0.95 snap are
// constants, and the clip of the TF alpha takes XLA's 0.5 subgradient at
// exact ties, as the JAX package's autodiff oracle does. dW and dL are
// written in the stream type (bf16 on the main path), as the JAX package
// rounds them.
//
// Bound on the H100: device memory. At 1080p and 150 planes W, L, dW and
// dL are about 0.5 GB each in bf16; the kernel reads W and L up to each
// pixel's termination and writes dW and dL whole (zeros past
// termination). The first Hopper design (one thread per pixel, one 2-byte
// load per plane behind the previous plane's branch, T_{k-1} stored in a
// (K, n1, n2) float32 scratch of 1 GB between the sweeps, one warp-wide
// ordered add per plane whose rounds grew with the lanes on one texel) was
// bound by its instructions and their latency, not by the scratch. This
// one follows composite_tile.cuh (a warp per tile of 32 pixels of a row,
// only the planes of the tile's geometric interval, groups of 8 planes
// staged through shared memory), and:
// - keeps no T: sweep 1 writes alpha at the start of each group of 8
//   planes into a (ceil(K / 8), n1, n2) float32 scratch (an eighth of the
//   old one); sweep 2 walks the groups down, and for each restages the
//   group's W and L, recomputes T_{k-1} forward from the group's
//   checkpoint with sweep 1's operations (so T has the bits the old
//   scratch held) into shared memory, keeps the samples' window positions
//   for the walk down, and walks the group backward;
// - writes the zero cotangents outside the tile's visited planes, reading
//   nothing there, with 16-byte stores where the rows allow;
// - adds to the histogram by texel group: the lanes on one texel sum
//   their values in a fixed tree of shuffles (log2 of the largest group
//   steps, not one round per lane), and the group's lowest lane adds the
//   sum, every floor tap before the frac taps. On the bench's fwd+bwd
//   inputs where a warp adds at a plane, 6.7 lanes on average share a
//   texel, while runs of equal texels along a row are 1.5 pixels long
//   (texels alternate), so merging neighbours' values in registers, as
//   K10b does, saves little.
// What bounds it now: its instructions, the forward recurrence twice
// (sweep 1 and the recompute) with logf and expf per sample, the backward
// body and the adds.
// Each warp keeps a private 4 x 257 histogram (the frac tap at the next
// texel; the 257th bin only ever takes zeros). Each block sums its warps'
// histograms in warp order into one row of partials, and reduce.cu sums
// the rows in a fixed order: the same bits on every run.

#include "composite_tile.cuh"

namespace {

using namespace tbr_tile;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 257;        // texels, and one past the top
constexpr int WHIST = 4 * BINS;  // one warp's histogram: [channel][bin]
constexpr int NT = 4 * 256;      // d TF in a row: [channel][texel]
constexpr int ROW = NT + 2;      // + d center, d width

// wh[c * BINS + bin] += v[c] and wh[c * BINS + bin + 1] += v[4 + c] for
// every lane with `add`. Lanes on one bin first sum their values in a
// fixed tree by rank (rank r takes rank r + d for d = 1, 2, 4, ...), then
// the rank-0 lane adds the sum: floor taps, then frac taps. Every lane of
// the warp calls it.
__device__ __forceinline__ void add_groups(float* wh, int bin, float (&v)[8],
                                           bool add) {
  if (__ballot_sync(FULL, add) == 0u) return;  // warp-uniform
  const unsigned lane = threadIdx.x & 31u;
  // a lane that adds nothing gets a key of its own
  const int key = add ? bin : -1 - (int)lane;
  const unsigned grp = __match_any_sync(FULL, key);
  const int size = __popc(grp);
  const int rank = __popc(grp & ((1u << lane) - 1u));
  const int most = (int)__reduce_max_sync(FULL, (unsigned)size);
  for (int d = 1; d < most; d <<= 1) {  // warp-uniform
    const unsigned src = __fns(grp, lane, d + 1);  // the lane of rank + d
    const int from = src < 32u ? (int)src : (int)lane;
    const bool take = (rank & (2 * d - 1)) == 0 && rank + d < size;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float o = __shfl_sync(FULL, v[c], from);
      if (take) v[c] = __fadd_rn(v[c], o);
    }
  }
  const bool lead = add && rank == 0;
  if (lead) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* h = wh + c * BINS + bin;
      *h = __fadd_rn(*h, v[c]);
    }
  }
  __syncwarp();
  if (lead) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* h = wh + c * BINS + bin + 1;
      *h = __fadd_rn(*h, v[4 + c]);
    }
  }
  __syncwarp();
}

// dW and dL = 0 at planes [0, k_a) and [k_b, kp) of one tile's 32
// pixels of row i (tile column tc). `vec`: the tile is whole and its rows
// 16-byte aligned, so each lane stores 16 bytes, a warp-wide store
// covering several planes; otherwise each lane stores its own pixel.
template <typename T>
__device__ __forceinline__ void zero_fill(T* __restrict__ dW,
                                          T* __restrict__ dL, size_t plane,
                                          int i, int n2, int tc, int lane,
                                          int k_a, int k_b, int kp,
                                          bool vec) {
  const size_t row = (size_t)i * n2 + (size_t)tc * TILE;
  if (vec) {
    constexpr int CHUNKS = TILE * (int)sizeof(T) / 16;  // per plane
    constexpr int PLANES = 32 / CHUNKS;                 // per store
    const int c = lane % CHUNKS;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int k = lane / CHUNKS; k < kp; k += PLANES) {
      if (k >= k_a && k < k_b) continue;
      const size_t at = (size_t)k * plane + row;
      __stcs(reinterpret_cast<uint4*>(dW + at) + c, z);
      __stcs(reinterpret_cast<uint4*>(dL + at) + c, z);
    }
    return;
  }
  if (tc * TILE + lane >= n2) return;
  const T zero = tbr_from_f32<T>(0.0f);
  for (int k = 0; k < kp; ++k) {
    if (k == k_a) k = k_b;
    if (k >= kp) break;
    dW[(size_t)k * plane + row + lane] = zero;
    dL[(size_t)k * plane + row + lane] = zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) composite_bwd_kernel(
    const T* __restrict__ W, const T* __restrict__ L,
    const float* __restrict__ tf, const float* __restrict__ pa,
    const int2* __restrict__ bounds, const float* __restrict__ e1,
    const float* __restrict__ sw, const float* __restrict__ win,
    const float* __restrict__ g, float* __restrict__ ckpt,
    T* __restrict__ dW, T* __restrict__ dL, float* __restrict__ partials,
    int n1, int n2, int k_real, int kp, int P, int zvec_i, float e0,
    float et, float d1f, float d2f) {
  extern __shared__ __align__(16) float smem[];
  float4* tf4 = reinterpret_cast<float4*>(smem);  // 256 texels
  float* hist = smem + 1024;                      // WARPS x WHIST
  float* stage_w = hist + WARPS * WHIST;          // GROUP x THREADS
  float* stage_l = stage_w + GROUP * THREADS;
  float* stage_t = stage_l + GROUP * THREADS;
  float* spa = stage_t + GROUP * THREADS;         // (5, P)
  __shared__ float red[2][WARPS];
  for (int t = threadIdx.x; t < 1024; t += THREADS) smem[t] = tf[t];
  for (int t = threadIdx.x; t < WARPS * WHIST; t += THREADS) hist[t] = 0.0f;
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wh = hist + warp * WHIST;
  // this thread's slots: plane s of the staged group at [s * THREADS]
  float* my_w = stage_w + threadIdx.x;
  float* my_l = stage_l + threadIdx.x;
  float* my_t = stage_t + threadIdx.x;
  const size_t plane = (size_t)n1 * n2;
  const int tpr = (n2 + TILE - 1) / TILE;
  const int n_tiles = n1 * tpr;
  float acc_c = 0.0f, acc_w = 0.0f;
  const bool zvec = zvec_i != 0;

  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles;
       tile += gridDim.x * WARPS) {  // warp-uniform
    const int i = tile / tpr;
    const int j = (tile - i * tpr) * TILE + lane;
    const bool valid = j < n2;
    const int2 kb = bounds[tile];
    const size_t pix = (size_t)i * n2 + (valid ? j : 0);
    const float gi = (float)i, gj = (float)j;
    const float e1v = valid ? e1[pix] : 0.0f;
    const float swv = valid ? sw[pix] : 0.0f;
    auto inside = [&](int k) {
      const float v1 = __fadd_rn(a1[k], __fmul_rn(b1[k], gi));
      const float v2 = __fadd_rn(a2[k], __fmul_rn(b2[k], gj));
      return in_cube(v1, v2, hi1, hi2) &&
             __fadd_rn(e0, __fmul_rn(lam[k], e1v)) > 0.0f;
    };
    // forward alpha of a sample that passes inside() and the cutoffs
    auto sample_alpha = [&](float tf_pos) {
      int t0, t1;
      float frac;
      tbr_tf_taps(tf_pos, &t0, &t1, &frac);
      return tbr_correct_alpha(tbr_lerp(tf4[t0].w, tf4[t1].w, frac), swv);
    };
    const bool any_k = kb.x < kb.y;
    const int g_lo = any_k ? kb.x / GROUP : 0;
    const int g_hi = any_k ? (kb.y + GROUP - 1) / GROUP : 0;

    // ---- sweep 1: the forward recurrence up to termination, alpha
    // checkpointed at the start of each group ----
    float alpha = 0.0f;
    int k_end = valid ? k_real : 0;  // planes [k_end, kp): zero cotangent
    bool term = false, live = valid;
    int g_top = g_lo;  // one past the last group this thread visits
    for (int gg = g_lo; gg < g_hi && live; ++gg) {
      const int k0 = gg * GROUP;
      ckpt[(size_t)gg * plane + pix] = alpha;
      stage<T, GROUP>(my_w, THREADS, W + pix, plane, k0, kb.x, kb.y);
      const int s_end = min(GROUP, kb.y - k0);
      for (int s = max(0, kb.x - k0); s < s_end; ++s) {
        const int k = k0 + s;
        if (!inside(k)) continue;  // a == 0: alpha unchanged
        const float tf_pos =
            tbr_tf_pos(my_w[s * THREADS], center, half_width, width);
        if (tbr_cut(tf_pos, low_c, high_c)) continue;
        const float a = sample_alpha(tf_pos);
        const float alpha_new =
            __fadd_rn(alpha, __fmul_rn(__fsub_rn(1.0f, alpha), a));
        if (a > 0.0f && alpha_new > et) {
          term = true;
          live = false;
          k_end = k + 1;
          break;
        }
        alpha = alpha_new;
      }
      g_top = gg + 1;
    }
    const int g_top_w = (int)__reduce_max_sync(FULL, (unsigned)g_top);

    // zero cotangents outside the planes sweep 2 writes: planes
    // [0, g_lo * GROUP) and [g_top_w * GROUP, kp), the same for the whole
    // tile; a whole, aligned tile's rows go as 16-byte stores, several
    // planes per warp-wide store
    const int tc = tile - i * tpr;
    zero_fill<T>(dW, dL, plane, i, n2, tc, lane, g_lo * GROUP,
                 g_top_w * GROUP, kp, zvec && (tc + 1) * TILE <= n2);

    // ---- sweep 2: groups descending, T recomputed from the checkpoints ----
    const float g0 = valid ? g[pix] : 0.0f;
    const float g1 = valid ? g[plane + pix] : 0.0f;
    const float g2 = valid ? g[2 * plane + pix] : 0.0f;
    const float galpha =
        valid ? __fmul_rn(g[3 * plane + pix], term ? 0.0f : 1.0f) : 0.0f;
    float U = 0.0f, V = 1.0f;
    for (int gg = g_top_w - 1; gg >= g_lo; --gg) {  // warp-uniform
      const int k0 = gg * GROUP;
      const bool mine = gg < g_top;  // visited by this thread in sweep 1
      unsigned shade = 0u;  // bit s: plane k0 + s is in the cube, not cut
      if (mine) {
        const int k_to = min(kb.y, k_end);
        stage<T, GROUP>(my_w, THREADS, W + pix, plane, k0, kb.x, k_to);
        stage<T, GROUP>(my_l, THREADS, L + pix, plane, k0, kb.x, k_to);
        // T_{k-1} of the group's samples, with sweep 1's operations; the
        // window's tf_pos replaces the value in its slot for the walk down
        float ta = ckpt[(size_t)gg * plane + pix];
        const int s_end = min(GROUP, k_to - k0);
        for (int s = max(0, kb.x - k0); s < s_end; ++s) {
          const int k = k0 + s;
          if (!inside(k)) continue;
          const float tf_pos =
              tbr_tf_pos(my_w[s * THREADS], center, half_width, width);
          if (tbr_cut(tf_pos, low_c, high_c)) continue;
          shade |= 1u << s;
          my_w[s * THREADS] = tf_pos;
          my_t[s * THREADS] = __fsub_rn(1.0f, ta);
          const float a = sample_alpha(tf_pos);
          ta = __fadd_rn(ta, __fmul_rn(__fsub_rn(1.0f, ta), a));
        }
      }
      for (int s = GROUP - 1; s >= 0; --s) {  // warp-uniform
        const int k = k0 + s;
        float dw = 0.0f, dl = 0.0f;
        float wts[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        int ia = 0;
        bool hit = false;
        if ((shade >> s) & 1u) {
          const float tf_pos = my_w[s * THREADS];
          const float Tk = my_t[s * THREADS];
          const float light = my_l[s * THREADS];
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
          const float ga = __fmul_rn(__fmul_rn(__fmul_rn(da, gatef), dcorr),
                                     tbr_clip_grad(a_raw));
          const float gx = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(ger, __fsub_rn(c1.x, c0.x)),
                                  __fmul_rn(geg, __fsub_rn(c1.y, c0.y))),
                        __fmul_rn(geb, __fsub_rn(c1.z, c0.z))),
              __fmul_rn(ga, __fsub_rn(c1.w, c0.w)));
          dw = __fmul_rn(gx, s256w);
          dl = __fmul_rn(w_, gl);
          acc_c = __fadd_rn(acc_c, __fmul_rn(gx, neg256w));
          const float dpos = __fmul_rn(256.0f, __fsub_rn(0.5f, tf_pos));
          acc_w = __fadd_rn(acc_w, __fmul_rn(gx, __fdiv_rn(dpos, width)));
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
        add_groups(wh, ia, wts, hit);
        if (valid && k < kp) {
          dW[(size_t)k * plane + pix] = tbr_from_f32<T>(dw);
          dL[(size_t)k * plane + pix] = tbr_from_f32<T>(dl);
        }
      }
    }
  }

  // the block's window sums, in a fixed tree order, and its histogram row
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    acc_c = __fadd_rn(acc_c, __shfl_down_sync(FULL, acc_c, d));
    acc_w = __fadd_rn(acc_w, __shfl_down_sync(FULL, acc_w, d));
  }
  if (lane == 0) {
    red[0][warp] = acc_c;
    red[1][warp] = acc_w;
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
}

size_t smem_bytes(int P) {
  return (1024 + WARPS * WHIST + 3 * GROUP * THREADS + 5 * (size_t)P) *
         sizeof(float);
}

template <typename T>
int launch(const void* W, const void* L, const float* tf, const float* pa,
           const int* bounds, const float* e1, const float* sw,
           const float* win, const float* g, float* ckpt, void* dW, void* dL,
           float* partials, int n1, int n2, int k_real, int kp, int P,
           int blocks, int zvec, float e0, float et, float d1f, float d2f,
           void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  composite_bwd_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(L), tf, pa,
      reinterpret_cast<const int2*>(bounds), e1, sw, win, g, ckpt,
      static_cast<T*>(dW), static_cast<T*>(dL), partials, n1, n2, k_real, kp,
      P, zvec, e0, et, d1f, d2f);
  return (int)cudaGetLastError();
}

}  // namespace

#define TBR_COMPOSITE_BWD_ARGS                                                \
  const void *W, const void *L, const float *tf, const float *pa,             \
      const int *bounds, const float *e1, const float *sw, const float *win,  \
      const float *g, float *ckpt, void *dW, void *dL, float *partials,       \
      int n1, int n2, int k_real, int kp, int P, int blocks, int zvec,        \
      float e0, float et, float d1f, float d2f, void *stream
#define TBR_COMPOSITE_BWD_CALL                                              \
  W, L, tf, pa, bounds, e1, sw, win, g, ckpt, dW, dL, partials, n1, n2,     \
      k_real, kp, P, blocks, zvec, e0, et, d1f, d2f, stream

// One tile of 32 pixels per warp: `blocks` * 8 warps cover the
// n1 * ceil(n2 / 32) tiles (more blocks than that idle; fewer loop).
// bounds is (n1, ceil(n2 / 32), 2) int32 [k_lo, k_hi) per tile
// (tile_plane_bounds, no jitter); ckpt (ceil(k_real / 8), n1, n2) float32
// scratch; partials (blocks, 1026): per block the d TF histogram as
// [channel(4)][texel(256)], then d center and d width. dW and dL are
// (kp, n1, n2) in the stream type and are written in full. `zvec`: rows
// of n2 elements of the stream type are a multiple of 16 bytes, and dW and
// dL start on a 16-byte boundary.
TBR_API int tbr_composite_bwd_f32(TBR_COMPOSITE_BWD_ARGS) {
  return launch<float>(TBR_COMPOSITE_BWD_CALL);
}

TBR_API int tbr_composite_bwd_bf16(TBR_COMPOSITE_BWD_ARGS) {
  return launch<__nv_bfloat16>(TBR_COMPOSITE_BWD_CALL);
}
