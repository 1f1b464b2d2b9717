// K4: illumination propagation scan of one cube face.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_lighting.py::
// _scan_kernel (entry point propagate_face_scan_pallas). It computes
//   c_k = shift2d_border(c_{k-1}, (off_x, off_y), border = alpha) * (1 - o_k)
// with c_{-1} = alpha everywhere, or the plane `carry` where one is given
// (the light entering a chunk of a face that another launch, or another
// card, scanned up to it: the chunks chained by their carries are the
// whole face's scan bit for bit), and writes every c_k; the carry out is
// the last slice written. A tap whose true index lies outside [0, n)
// reads alpha. alpha (intensity times face weight)
// is read from device memory, so it can be a tensor that takes a gradient
// without a host sync, or passed by value.
//
// Bound on the H100: the bytes are o in and c out, once each (0.040 ms for
// a 256^3 face), but no slice can start before the rows its taps read in
// the previous one are complete, so the chain of K slices, not bandwidth,
// sets the time. The lateral offset couples a row to the rows
// reach = ix + 1 below it (ix = floor(off_x) >= 0) or reach = -ix above it
// (ix < 0): one side only. Design: one cooperative launch per face, at most
// one block per SM, so every block is resident and may wait for another:
// - block b owns the row band [b R, b R + R) of every slice;
// - slices go in groups of T; a block hands off once a group: it publishes
//   after writing its rows of the group's last slice (scan_sync.cuh: a
//   block barrier and one release store of its 64-bit counter; the counter
//   pool is shared with K7), and before a group it waits, with acquire
//   loads, only for the blocks whose rows its taps read; each slice is a
//   plane of its own, so there is no write-after-read hazard;
// - the carry needs no buffer of its own: it is the output slice c_{k-1},
//   resident in L2, read with ld.global.cg and written with st.cg;
// - staged (T >= 1): a block copies its band plus a halo of T reach rows
//   (on the side the taps read) of c_{k0-1} into shared memory, computes
//   the group's T slices there, the halo shrinking by reach rows a slice
//   (a __syncthreads between slices, two buffers in turn), and writes only
//   its own rows of each slice; the halo rows go through the same
//   operations in the same order as their owner's rows, so the result is
//   exact however the face is cut;
// - unstaged (T = 1, for a face whose band and halo do not fit shared
//   memory): the taps are read from c_{k-1} in L2 directly;
// - a thread takes units of V = 4 adjacent pixels of a row (V = 1 where W
//   is not a multiple of 4 or a tensor is not 16-byte aligned): the rows
//   lerp at the unit's 5 tap columns, each pixel lerps two of them, and o
//   and the output move as float4s; the slice's time is its instructions
//   (per row of the frame and per slice), so fewer of them a pixel is what
//   counts;
// - a thread's first P units are placed once (plane and stage offsets,
//   tap validity) and each slice tests a frame row against two bounds;
//   the block is sized to the frame, so few threads idle;
// - o_k does not depend on the carry: those units load it two slices
//   ahead into registers and prefetch it into L2 eight slices ahead;
//   further units (large faces) are placed and load it in the slice.
// A thread carries nothing else from slice to slice, so it loops over any
// number of pixels: every face size runs. ops/light_scan.py::scan_plan
// picks R, T, V, the threads and the units a thread, and the wrapper's CPU
// test emulates that schedule on halo-extended sub-faces. Each pixel does
// the plain version's operations in its order, so K4 agrees with
// propagate_face_scan_plain bit for bit.

#include "common.cuh"
#include "scan_sync.cuh"

namespace {

using tbr_scan::publish;
using tbr_scan::wait_for;

constexpr int L2_AHEAD = 8;  // slices ahead that o is prefetched into L2

// The launch's shape, from ops/light_scan.py::scan_plan.
struct ScanShape {
  int K, H, W;
  int R;       // rows a block owns
  int T;       // slices between hand-offs
  int reach;   // rows beyond its own that a row's taps read, on one side
  int chunks;  // chunks of P units a thread; the first is placed once
  int ix, iy;
  float fx, fy;
};

// A unit of V adjacent pixels of a row, fixed for the whole scan: the
// offset of its first pixel in a face plane and in the stage, and its frame
// row c (row fb + c of the face) << 8 with the validity of its V + 1 tap
// columns (bits 2 to V + 2) and two tap rows (bits 0, 1); c = -1 outside
// the frame or the face.
struct Unit {
  int pg, so, cb;
};

template <int V>
struct Vals {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vals<V> load_vals(const float* p) {
  Vals<V> r;
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = x.x, r.v[1] = x.y, r.v[2] = x.z, r.v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = __ldg(p + e);
  }
  return r;
}

template <int V, bool L2>
__device__ __forceinline__ void store_vals(float* p, const float* v) {
  if constexpr (V == 4) {
    const float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if (L2) {
      __stcg(reinterpret_cast<float4*>(p), x);
    } else {
      *reinterpret_cast<float4*>(p) = x;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (L2) {
        __stcg(p + e, v[e]);
      } else {
        p[e] = v[e];
      }
    }
  }
}

template <int P, int V, bool STAGED>
__global__ void __launch_bounds__(1024, 1)
    light_scan_kernel(const float* __restrict__ op, float* out,
                      unsigned long long* flags, unsigned long long base,
                      const ScanShape s, const float* __restrict__ alpha_p,
                      float alpha_v, const float* __restrict__ carry) {
  extern __shared__ __align__(16) float stage[];
  const int K = s.K, H = s.H, W = s.W, T = s.T, reach = s.reach;
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int b = blockIdx.x;
  const int r0 = b * s.R;
  const int r1 = min(r0 + s.R, H);
  const int nb = r1 - r0;
  const size_t hw = (size_t)H * W;
  const float alpha = alpha_p ? *alpha_p : alpha_v;
  const float gx = __fsub_rn(1.0f, s.fx), gy = __fsub_rn(1.0f, s.fy);
  const bool up = s.ix < 0;
  // the rows [lr0, lr1) of slice k0 - 1 that a group of T slices reads, and
  // the blocks that own them
  const int halo = T * reach;
  const int lr0 = up ? r0 - halo : r0;
  const int lr1 = up ? r1 : r1 + halo;
  const int lo = max(lr0, 0) / s.R;
  const int hi = (min(lr1, H) - 1) / s.R;
  const int plane = (s.R + halo) * W;  // floats of one stage buffer
  // the frame: the rows a group's first slice computes; a thread's unit u
  // is face row fb + u / (W / V), its first column V (u % (W / V))
  const int fb = up ? r0 - (T - 1) * reach : r0;
  const int wv = W / V;
  const int nunits = (nb + (T - 1) * reach) * wv;
  const int tap = s.ix * W + s.iy;  // a pixel's first tap, as an offset

  auto place = [&](int u) {
    Unit p{0, 0, -256};
    const int c = u / wv;
    const int i = fb + c, j = (u - c * wv) * V;
    if (u < nunits && i >= 0 && i < H) {
      p.pg = i * W + j;
      p.so = (i - lr0) * W + j;
      const int r = i + s.ix;
      int bits = (int)(r >= 0 && r < H) | (int)(r + 1 >= 0 && r + 1 < H) << 1;
#pragma unroll
      for (int d = 0; d <= V; ++d) {
        const int col = j + s.iy + d;
        bits |= (int)(col >= 0 && col < W) << (2 + d);
      }
      p.cb = c << 8 | bits;
    }
    return p;
  };
  auto load_o = [&](int k, const Unit& p) {
    if (p.cb >= 0) return load_vals<V>(op + (size_t)k * hw + p.pg);
    return Vals<V>{};
  };
  // tbr_shift2d's arithmetic at unit p on the previous slice `src` (the
  // stage, or the output plane or the carry; null: the constant alpha
  // before slice 0):
  // the rows lerp by fx at the unit's V + 1 tap columns (alpha outside the
  // face), then each pixel lerps two neighbouring columns by fy
  auto shifted = [&](const float* src, const Unit& p, float* v) {
    const int o = (STAGED ? p.so : p.pg) + tap;
    float c[V + 1];
#pragma unroll
    for (int d = 0; d <= V; ++d) {
      if (!((p.cb >> (2 + d)) & 1)) {
        c[d] = alpha;  // the column pass reads the border outside
        continue;
      }
      float t[2];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const bool ok = src != nullptr && ((p.cb >> dx) & 1);
        const float* a = src + o + dx * W + d;
        t[dx] = ok ? (STAGED ? *a : __ldcg(a)) : alpha;
      }
      c[d] = __fadd_rn(__fmul_rn(t[0], gx), __fmul_rn(t[1], s.fx));
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = __fadd_rn(__fmul_rn(c[e], gy), __fmul_rn(c[e + 1], s.fy));
    }
  };
  // stage rows [max(lr0, 0), min(lr1, H)) of slice k - 1 (at k = 0 the
  // carry, or alpha)
  auto load_stage = [&](int k) {
    const int f0 = max(lr0, 0);
    const int n = (min(lr1, H) - f0) * W;
    float* dst = stage + (f0 - lr0) * W;
    const float* src = (k > 0 ? out + (size_t)(k - 1) * hw : carry) +
                       (size_t)f0 * W;
    const bool read = k > 0 || carry != nullptr;
    for (int u0 = tid; u0 < n; u0 += 4 * nt) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e * nt;
        v[e] = u < n ? (read ? __ldcg(src + u) : alpha) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e * nt;
        if (u < n) dst[u] = v[e];
      }
    }
    __syncthreads();
  };

  Unit px[P];
#pragma unroll
  for (int q = 0; q < P; ++q) px[q] = place(tid + q * nt);

  // slice k from o loaded two slices before (`ov`), which then takes slice
  // k + 2's
  auto step = [&](int k, Vals<V> (&ov)[P]) {
    const int t = k % T;
    const bool last = t == T - 1 || k == K - 1;
    if (t == 0) {
      if (k > 0) wait_for(flags, lo, hi, base + k / T);
      if (STAGED) load_stage(k);
    }
    // the frame rows [clo, chi) this slice computes (the block's own rows
    // at the last of a group), and the own rows [olo, ohi)
    const int olo = r0 - fb, ohi = r1 - fb;
    const int clo = last ? olo : up ? t * reach : 0;
    const int chi = last ? ohi : up ? ohi : nb + (T - 1 - t) * reach;
    const float* src =
        STAGED ? stage + (t & 1) * plane
               : (k > 0 ? out + (size_t)(k - 1) * hw : carry);
    float* next = STAGED && !last ? stage + ((t + 1) & 1) * plane : nullptr;
    float* dst = out + (size_t)k * hw;
    auto compute = [&](const Unit& p, const Vals<V>& o) {
      const int c = p.cb >> 8;
      if (c < clo || c >= chi) return;
      float v[V];
      shifted(src, p, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = __fmul_rn(v[e], __fsub_rn(1.0f, o.v[e]));
      }
      if (next) store_vals<V, false>(next + p.so, v);
      if (c >= olo && c < ohi) store_vals<V, true>(dst + p.pg, v);
    };
#pragma unroll
    for (int q = 0; q < P; ++q) compute(px[q], ov[q]);
    for (int ch = 1; ch < s.chunks; ++ch) {  // large faces
      Unit pc[P];
      Vals<V> o[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        pc[q] = place(tid + (ch * P + q) * nt);
        o[q] = load_o(k, pc[q]);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) compute(pc[q], o[q]);
    }
    if (!last) {
      __syncthreads();  // the stage of slice k is complete
    } else if (k < K - 1) {
      publish(flags, b, base + k / T + 1);  // the group's last slice
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (k + L2_AHEAD < K && px[q].cb >= 0) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            op + (size_t)(k + L2_AHEAD) * hw + px[q].pg));
      }
      if (k + 2 < K) ov[q] = load_o(k + 2, px[q]);
    }
  };

  Vals<V> oA[P], oB[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    oA[q] = load_o(0, px[q]);
    oB[q] = K > 1 ? load_o(1, px[q]) : Vals<V>{};
  }
  for (int k = 0; k < K; k += 2) {
    step(k, oA);
    if (k + 1 < K) step(k + 1, oB);
  }
}

template <int P, int V, bool STAGED>
int launch(int blocks, int threads, int smem, void** args,
           cudaStream_t stream) {
  const void* fn = (const void*)light_scan_kernel<P, V, STAGED>;
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads),
                                          args, (size_t)smem, stream);
}

template <bool STAGED>
int dispatch(int P, int V, int blocks, int threads, int smem, void** args,
             cudaStream_t s) {
  switch (V * 8 + P) {
    case 8 + 1: return launch<1, 1, STAGED>(blocks, threads, smem, args, s);
    case 8 + 2: return launch<2, 1, STAGED>(blocks, threads, smem, args, s);
    case 8 + 3: return launch<3, 1, STAGED>(blocks, threads, smem, args, s);
    case 8 + 4: return launch<4, 1, STAGED>(blocks, threads, smem, args, s);
    case 32 + 1: return launch<1, 4, STAGED>(blocks, threads, smem, args, s);
    case 32 + 2: return launch<2, 4, STAGED>(blocks, threads, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// An attribute of the current device (cudaDeviceAttr), or -1.
TBR_API int tbr_device_attribute(int attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, (cudaDeviceAttr)attr, dev) != cudaSuccess) {
    return -1;
  }
  return v;
}

// One cooperative launch per face, in the shape ops/light_scan.py::
// scan_plan gives (blocks of `threads`, P units of V pixels a thread
// (V = 4: op and out 16-byte aligned, W a multiple of 4) in `chunks`,
// `smem` bytes of stage when `staged`). (ix, fx, iy, fy) split the offset;
// alpha is *alpha_p, or alpha_v where alpha_p is null; `carry`, an (H, W)
// plane or null, is the light entering slice 0 (c_{-1}). `flags` holds at
// least `blocks` counters, none above `base`; the launch leaves them at
// most base + ceil(K / T) - 1 (the caller's next base is base + ceil(K /
// T)).
TBR_API int tbr_light_scan(const float* op, float* out,
                           unsigned long long* flags, unsigned long long base,
                           int K, int H, int W, int blocks, int R, int T,
                           int reach, int staged, int threads, int P,
                           int V, int chunks, int smem, int ix, float fx,
                           int iy, float fy, const float* alpha_p,
                           float alpha_v, const float* carry, void* stream) {
  if (K <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (blocks <= 0 || R <= 0 || T <= 0 || reach <= 0 || chunks <= 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      (V != 1 && V != 4) || W % V != 0 ||
      (long long)blocks * R < H || (!staged && T != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  ScanShape shape{K, H, W, R, T, reach, chunks, ix, iy, fx, fy};
  void* args[] = {&op,   &out,     &flags,   &base,
                  &shape, &alpha_p, &alpha_v, &carry};
  cudaStream_t s = (cudaStream_t)stream;
  int err = staged ? dispatch<true>(P, V, blocks, threads, smem, args, s)
                   : dispatch<false>(P, V, blocks, threads, 0, args, s);
  return err ? err : (int)cudaGetLastError();
}
