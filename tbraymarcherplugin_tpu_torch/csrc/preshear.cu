// K12: the pre-shear of the shear-warp composite, and its adjoint.
//
// Replaces no TPU kernel: the JAX package pre-shears with two banded
// einsums a plane (tbraymarcherplugin_tpu/ops/shearwarp.py::
// _resample_block), which XLA runs as matrix products, and which the port
// ran as dense tent matrices built from torch operators and two `bmm`s
// (ops/shearwarp.py::_resample_block). Here each plane sample reads its
// texels straight from the source volume:
//   P[r, c]   = S[m0, r, c] (1 - t) + S[m1, r, c] t   (or S[m0] alone)
//   line[i, c] = P[r0(i), c] wr0(i) + P[r1(i), c] wr1(i)
//   out[k, i, j] = line[i, c0(j)] wc0(j) + line[i, c1(j)] wc1(j)
// with the taps of v = clip(a + b x, 0, D - 1): r0 = floor(v),
// r1 = min(r0 + 1, D - 1), weights 1 - fr and fr (fr = v - r0), or with
// `nearest` the texel floor(v + 0.5) alone (the octree mode). Rows lerp
// first, then columns, as the tent products do; every operation rounds once
// (common.cuh) and the sample rounds once to the plane type, so the planes
// are ops/preshear.py::preshear_plain's bit for bit. The source is read
// through its strides (S is the volume permuted to (principal, rows,
// columns)); plane k's slices, lerp weight and coefficients come from a
// packed per-plan array (8 floats a plane, the slices as int32 bits), whose
// padding planes repeat the last real plane.
//
// Bound on the H100: device memory. The planes are written once (at the
// chest CT's 161 x 1280 x 1280 bfloat16 planes, 0.53 GB a stream) and
// each plane's two source slices read about once (0.25 GB a stream): about
// 0.23 ms a stream at 3.35 TB/s. Design: a block per (plane, band of
// output rows). It stages the band's row-lerped lines (rows x the plane's
// column span, the principal-axis lerp done once per texel read) in shared
// memory, whose source rows come from L1 and L2 (neighbouring output rows
// share source rows); then each thread owns VEC consecutive columns, whose
// taps it computes once, and writes them for every row of the band as one
// 8-byte store (4 bfloat16 or 2 float32), neighbouring threads on
// neighbouring columns (16-byte stores, 4-byte ones, fewer or more rows a
// band and 256 or 512 threads a block were each 1-16% slower at the chest
// CT's planes on the H100). Source reads are coalesced where the columns
// are the volume's contiguous axis (a principal axis X or Y); along Z they
// are strided, correct but not tuned.
//
// The adjoint, in gather form, in a fixed order with no atomics (the same
// bits on every run):
//   A: dline[k, i, c] = sum over the columns j whose taps touch texel c;
//   B: dS[m, r, c] = sum over the planes k reading slice m of their lerp
//      weight times the sum over the rows i whose taps touch r of
//      dline[k, i, c].
// The taps' coordinate is monotone in the pixel index (b >= 0), so the
// pixels touching a texel are a contiguous range, found from an estimate
// and a step or two of the exact float32 coordinate. The pixels whose
// coordinate is clipped to the first or last texel (outside the cube) are
// summed once per row by a warp (A) or in a loop that every thread of a row
// runs alike (B), not by one thread. dline is a (K, n1, D2) float32
// scratch. Bound: the cotangent read once, dline written and read once,
// dS written once.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int COEF = 8;          // floats a plane in the packed array
constexpr int MAX_THREADS = 256;  // a block of the adjoint's passes
constexpr int FWD_THREADS = 1024;  // at most, a forward block
constexpr int STORE_BYTES = 8;     // a forward thread's store
constexpr int LINE_BYTES = 40 * 1024;  // staged lines a block
constexpr int MAX_ROWS = 32;     // output rows a forward block
constexpr int ROWS_A = 8;        // output rows a block of pass A
constexpr int ROWS_B = 4;        // source rows a block of pass B

struct Plane {
  float a1, b1, a2, b2, t;
  int m0, m1;
};

__device__ __forceinline__ Plane load_plane(const float* __restrict__ coef,
                                            int k) {
  const float* c = coef + (size_t)k * COEF;
  return Plane{c[0], c[1], c[2], c[3], c[4], __float_as_int(c[5]),
               __float_as_int(c[6])};
}

struct Tap {
  int i0, i1;
  float w0, w1;
};

// The unclipped coordinate a + b * x.
__device__ __forceinline__ float coord(float a, float b, float x) {
  return __fadd_rn(a, __fmul_rn(b, x));
}

template <bool NEAREST>
__device__ __forceinline__ Tap tap(float a, float b, float x, int dim) {
  const float v = fminf(fmaxf(coord(a, b, x), 0.0f), (float)(dim - 1));
  Tap q;
  if (NEAREST) {
    q.i0 = q.i1 = (int)floorf(__fadd_rn(v, 0.5f));
    q.w0 = 1.0f;
    q.w1 = 0.0f;
  } else {
    const float f = floorf(v);
    q.w1 = __fsub_rn(v, f);
    q.w0 = __fsub_rn(1.0f, q.w1);
    q.i0 = (int)f;
    q.i1 = min(q.i0 + 1, dim - 1);
  }
  return q;
}

// What the first pixel index of a range tests, on the coordinate of pixel
// q (all monotone in q for b >= 0).
enum Test : int { GE = 0, GT = 1, SEL_GE = 2 };

template <int TEST>
__device__ __forceinline__ bool passes(float a, float b, int off, int q,
                                       float x, int dim) {
  if (TEST == SEL_GE) return tap<true>(a, b, (float)(off + q), dim).i0 >= x;
  const float v = coord(a, b, (float)(off + q));
  return TEST == GE ? v >= x : v > x;
}

// The first q in [0, n] whose coordinate passes the test against x (n if
// none): an estimate from (x - a) / b, then steps of the exact coordinate.
template <int TEST>
__device__ int first_pass(float a, float b, int off, int n, float x,
                          int dim) {
  const float at = TEST == SEL_GE ? __fsub_rn(x, 0.5f) : x;
  const float e = __fsub_rn(ceilf(__fdiv_rn(__fsub_rn(at, a), b)),
                            (float)off);
  int q = e >= 0.0f ? (e <= (float)n ? (int)e : n) : 0;  // NaN: 0
  while (q > 0 && passes<TEST>(a, b, off, q - 1, x, dim)) --q;
  while (q < n && !passes<TEST>(a, b, off, q, x, dim)) ++q;
  return q;
}

// The pixels [lo, hi) whose taps touch texel c with a weight that is not
// a clipped edge's; with linear taps the pixels clipped to texel 0 are
// [0, e0) and those clipped to texel dim - 1 are [e1, n) (e1 >= e0: at
// dim 1 a pixel on texel 0 counts once).
template <bool NEAREST>
__device__ __forceinline__ void touching(float a, float b, int off, int n,
                                         int dim, int c, int e0, int e1,
                                         int* lo, int* hi) {
  if (NEAREST) {
    *lo = first_pass<SEL_GE>(a, b, off, n, (float)c, dim);
    *hi = first_pass<SEL_GE>(a, b, off, n, (float)(c + 1), dim);
  } else {
    *lo = c <= 1 ? e0 : first_pass<GE>(a, b, off, n, (float)(c - 1), dim);
    *hi = c + 1 >= dim - 1 ? e1
                           : first_pass<GE>(a, b, off, n, (float)(c + 1), dim);
  }
}

// Texel c's weight in pixel q's taps, for q in its `touching` range.
template <bool NEAREST>
__device__ __forceinline__ float weight(float a, float b, int off, int q,
                                        int dim, int c) {
  if (NEAREST) return 1.0f;
  const Tap t = tap<false>(a, b, (float)(off + q), dim);
  return t.i0 == c ? t.w0 : t.w1;
}

template <bool LERP>
__device__ __forceinline__ float texel(const float* __restrict__ p0,
                                       const float* __restrict__ p1,
                                       long long off, float omt, float t) {
  const float a = __ldg(p0 + off);
  if (!LERP) return a;
  return __fadd_rn(__fmul_rn(a, omt), __fmul_rn(__ldg(p1 + off), t));
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VEC values rounded to T and stored as one STORE_BYTES-wide store.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* o, const float (&x)[VEC]) {
  constexpr int NW = VEC * (int)sizeof(T) / 4;  // 32-bit words
  unsigned w[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    w[i] = sizeof(T) == 4
               ? __float_as_uint(x[i])
               : pack2(x[2 * i], x[2 * i + 1 < VEC ? 2 * i + 1 : 0]);
  }
  if (NW == 1) {
    *reinterpret_cast<unsigned*>(o) = w[0];
  } else if (NW == 2) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[NW > 1 ? 1 : 0]);
  } else {
    *reinterpret_cast<uint4*>(o) = make_uint4(
        w[0], w[NW > 1 ? 1 : 0], w[NW > 2 ? 2 : 0], w[NW > 3 ? 3 : 0]);
  }
}

template <typename T, bool LERP, bool NEAREST>
__global__ void __launch_bounds__(FWD_THREADS)
    preshear_kernel(const float* __restrict__ src, long long s0,
                    long long s1, long long s2, int D1, int D2,
                    const float* __restrict__ coef, T* __restrict__ out,
                    int n1, int n2, int j0, int rows, int vec_ok) {
  extern __shared__ float line[];  // rows x the plane's column span
  constexpr int VEC = STORE_BYTES / sizeof(T);
  const int k = blockIdx.y;
  const int ib = blockIdx.x * rows;
  const int nr = min(rows, n1 - ib);
  const Plane p = load_plane(coef, k);
  const Tap first = tap<NEAREST>(p.a2, p.b2, (float)j0, D2);
  const Tap last = tap<NEAREST>(p.a2, p.b2, (float)(j0 + n2 - 1), D2);
  const int clo = min(first.i0, last.i0);
  const int width = max(first.i1, last.i1) - clo + 1;

  // the band's lines: rows lerped, from the principal-axis lerp of the
  // source's texels
  const float* p0 = src + (long long)p.m0 * s0;
  const float* p1 = src + (long long)p.m1 * s0;
  const float omt = __fsub_rn(1.0f, p.t);
  const int total = nr * width;
  int rho = threadIdx.x / width;
  int c = threadIdx.x - rho * width;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const Tap r = tap<NEAREST>(p.a1, p.b1, (float)(ib + rho), D1);
    const long long col = (long long)(clo + c) * s2;
    const float v0 = texel<LERP>(p0, p1, r.i0 * s1 + col, omt, p.t);
    const float v1 = texel<LERP>(p0, p1, r.i1 * s1 + col, omt, p.t);
    line[e] = __fadd_rn(__fmul_rn(v0, r.w0), __fmul_rn(v1, r.w1));
    c += blockDim.x;
    while (c >= width) {
      c -= width;
      ++rho;
    }
  }
  __syncthreads();

  // the columns: taps once a thread, one store a row
  const int nvec = (n2 + VEC - 1) / VEC;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int jb = v * VEC;
    int c0[VEC], c1[VEC];
    float w0[VEC], w1[VEC];
#pragma unroll
    for (int s = 0; s < VEC; ++s) {
      const Tap q = tap<NEAREST>(p.a2, p.b2, (float)(j0 + min(jb + s, n2 - 1)),
                                 D2);
      c0[s] = q.i0 - clo;
      c1[s] = q.i1 - clo;
      w0[s] = q.w0;
      w1[s] = q.w1;
    }
    const bool whole = vec_ok && jb + VEC <= n2;
    for (int rr = 0; rr < nr; ++rr) {
      const float* ln = line + rr * width;
      float x[VEC];
#pragma unroll
      for (int s = 0; s < VEC; ++s) {
        x[s] = __fadd_rn(__fmul_rn(ln[c0[s]], w0[s]),
                         __fmul_rn(ln[c1[s]], w1[s]));
      }
      T* o = out + ((size_t)k * n1 + ib + rr) * n2 + jb;
      if (whole) {
        store_vec<T, VEC>(o, x);
      } else {
        for (int s = 0; s < VEC && jb + s < n2; ++s) {
          o[s] = tbr_from_f32<T>(x[s]);
        }
      }
    }
  }
}

// Pass A: dline[k, i, c] for ROWS_A output rows of one plane a block, a
// thread a texel column c.
template <typename G, bool NEAREST>
__global__ void __launch_bounds__(MAX_THREADS)
    preshear_cols_adjoint_kernel(const G* __restrict__ g,
                                 float* __restrict__ dline,
                                 const float* __restrict__ coef, int n1,
                                 int n2, int D2, int j0) {
  __shared__ float edge[2][ROWS_A];
  const int k = blockIdx.y;
  const int ib = blockIdx.x * ROWS_A;
  const int nr = min(ROWS_A, n1 - ib);
  const Plane p = load_plane(coef, k);
  const G* gk = g + ((size_t)k * n1 + ib) * n2;
  int e0 = 0, e1 = n2;
  if (!NEAREST) {  // the columns clipped to texel 0 and to texel D2 - 1
    e0 = first_pass<GT>(p.a2, p.b2, j0, n2, 0.0f, D2);
    e1 = max(first_pass<GE>(p.a2, p.b2, j0, n2, (float)(D2 - 1), D2), e0);
    const int lane = threadIdx.x & 31;
    for (int rr = threadIdx.x >> 5; rr < nr; rr += blockDim.x >> 5) {
      const G* gr = gk + (size_t)rr * n2;
      float a = 0.0f, b = 0.0f;
      for (int j = lane; j < e0; j += 32) a = __fadd_rn(a, tbr_to_f32(gr[j]));
      for (int j = e1 + lane; j < n2; j += 32) {
        b = __fadd_rn(b, tbr_to_f32(gr[j]));
      }
      for (int d = 16; d > 0; d >>= 1) {  // every lane ends with the same
        a = __fadd_rn(a, __shfl_xor_sync(FULL, a, d));
        b = __fadd_rn(b, __shfl_xor_sync(FULL, b, d));
      }
      if (lane == 0) {
        edge[0][rr] = a;
        edge[1][rr] = b;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D2; c += blockDim.x) {
    int lo, hi;
    touching<NEAREST>(p.a2, p.b2, j0, n2, D2, c, e0, e1, &lo, &hi);
    float s[ROWS_A];
#pragma unroll
    for (int rr = 0; rr < ROWS_A; ++rr) s[rr] = 0.0f;
    for (int j = lo; j < hi; ++j) {
      const float w = weight<NEAREST>(p.a2, p.b2, j0, j, D2, c);
#pragma unroll
      for (int rr = 0; rr < ROWS_A; ++rr) {
        if (rr < nr) {
          s[rr] = __fadd_rn(
              s[rr], __fmul_rn(tbr_to_f32(gk[(size_t)rr * n2 + j]), w));
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < ROWS_A; ++rr) {
      if (rr < nr) {
        float x = s[rr];
        if (!NEAREST && c == 0) x = __fadd_rn(x, edge[0][rr]);
        if (!NEAREST && c == D2 - 1) x = __fadd_rn(x, edge[1][rr]);
        dline[((size_t)k * n1 + ib + rr) * D2 + c] = x;
      }
    }
  }
}

// Plane k's cotangent of texel (r, c) of its lerped slice P from dline.
template <bool NEAREST>
__device__ __forceinline__ float plane_adjoint(const float* __restrict__ dl,
                                               const Plane& p, int n1, int D1,
                                               int D2, int r, int c) {
  int e0 = 0, e1 = n1;
  if (!NEAREST) {
    e0 = first_pass<GT>(p.a1, p.b1, 0, n1, 0.0f, D1);
    e1 = max(first_pass<GE>(p.a1, p.b1, 0, n1, (float)(D1 - 1), D1), e0);
  }
  int lo, hi;
  touching<NEAREST>(p.a1, p.b1, 0, n1, D1, r, e0, e1, &lo, &hi);
  float s = 0.0f;
  for (int i = lo; i < hi; ++i) {
    s = __fadd_rn(s, __fmul_rn(dl[(size_t)i * D2 + c],
                               weight<NEAREST>(p.a1, p.b1, 0, i, D1, r)));
  }
  if (!NEAREST && (r == 0 || r == D1 - 1)) {  // the clipped rows
    float t = 0.0f;
    if (r == 0) {
      for (int i = 0; i < e0; ++i) t = __fadd_rn(t, dl[(size_t)i * D2 + c]);
    }
    if (r == D1 - 1) {
      for (int i = e1; i < n1; ++i) t = __fadd_rn(t, dl[(size_t)i * D2 + c]);
    }
    s = __fadd_rn(s, t);
  }
  return s;
}

// Pass B: dS[m, r, c] for ROWS_B source rows of slice m a block, a thread
// a texel column; the planes reading slice m are [ks, ke) (slices[m]).
template <bool LERP, bool NEAREST>
__global__ void __launch_bounds__(MAX_THREADS)
    preshear_rows_adjoint_kernel(const float* __restrict__ dline,
                                 float* __restrict__ ds, long long o0,
                                 long long o1, long long o2, int D1, int D2,
                                 const float* __restrict__ coef,
                                 const int* __restrict__ slices, int n1) {
  const int m = blockIdx.y;
  const int rb = blockIdx.x * ROWS_B;
  const int re = min(rb + ROWS_B, D1);
  const int ks = slices[2 * m], ke = slices[2 * m + 1];
  for (int c = threadIdx.x; c < D2; c += blockDim.x) {
    for (int r = rb; r < re; ++r) {
      float acc = 0.0f;
      for (int k = ks; k < ke; ++k) {
        const Plane p = load_plane(coef, k);
        const bool on0 = p.m0 == m, on1 = LERP && p.m1 == m;
        if (!on0 && !on1) continue;
        const float d = plane_adjoint<NEAREST>(
            dline + (size_t)k * n1 * D2, p, n1, D1, D2, r, c);
        if (!LERP) {
          acc = __fadd_rn(acc, d);
          continue;
        }
        if (on0) acc = __fadd_rn(acc, __fmul_rn(d, __fsub_rn(1.0f, p.t)));
        if (on1) acc = __fadd_rn(acc, __fmul_rn(d, p.t));
      }
      ds[m * o0 + r * o1 + c * o2] = acc;
    }
  }
}

int block_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t;
}

template <typename T, bool LERP, bool NEAREST>
int launch_forward(const float* src, long long s0, long long s1,
                   long long s2, int D1, int D2, const float* coef, T* out,
                   int K, int n1, int n2, int j0, cudaStream_t stream) {
  constexpr int VEC = STORE_BYTES / sizeof(T);
  int rows = LINE_BYTES / (int)(D2 * sizeof(float));
  rows = rows < 1 ? 1 : rows > MAX_ROWS ? MAX_ROWS : rows;
  const size_t smem = (size_t)rows * D2 * sizeof(float);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    int err = (int)cudaFuncSetAttribute(
        preshear_kernel<T, LERP, NEAREST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // threads: the column vectors spread evenly over at most FWD_THREADS
  const int nvec = (n2 + VEC - 1) / VEC;
  const int per = (nvec + FWD_THREADS - 1) / FWD_THREADS;
  int threads = (nvec + per - 1) / per;
  threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
  const int vec_ok = (n2 % VEC == 0) &&
                     (reinterpret_cast<size_t>(out) % STORE_BYTES == 0);
  const dim3 grid((n1 + rows - 1) / rows, K);
  preshear_kernel<T, LERP, NEAREST><<<grid, threads, smem, stream>>>(
      src, s0, s1, s2, D1, D2, coef, out, n1, n2, j0, rows, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const float* src, long long s0, long long s1, long long s2,
            int D1, int D2, const float* coef, void* out, int K, int n1,
            int n2, int j0, int lerp, int nearest, void* stream) {
  if (K <= 0 || n1 <= 0 || n2 <= 0) return (int)cudaGetLastError();
  if (D1 <= 0 || D2 <= 0) return (int)cudaErrorInvalidValue;
  T* o = static_cast<T*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (nearest) {
    return launch_forward<T, false, true>(src, s0, s1, s2, D1, D2, coef, o,
                                          K, n1, n2, j0, st);
  }
  if (lerp) {
    return launch_forward<T, true, false>(src, s0, s1, s2, D1, D2, coef, o,
                                          K, n1, n2, j0, st);
  }
  return launch_forward<T, false, false>(src, s0, s1, s2, D1, D2, coef, o, K,
                                         n1, n2, j0, st);
}

template <typename G, bool LERP, bool NEAREST>
int launch_adjoint(const G* g, float* dline, float* ds, long long o0,
                   long long o1, long long o2, int D0, int D1, int D2,
                   const float* coef, const int* slices, int K, int n1,
                   int n2, int j0, cudaStream_t stream) {
  const int threads = block_threads(D2);
  preshear_cols_adjoint_kernel<G, NEAREST>
      <<<dim3((n1 + ROWS_A - 1) / ROWS_A, K), threads, 0, stream>>>(
          g, dline, coef, n1, n2, D2, j0);
  int err = (int)cudaGetLastError();
  if (err) return err;
  preshear_rows_adjoint_kernel<LERP, NEAREST>
      <<<dim3((D1 + ROWS_B - 1) / ROWS_B, D0), threads, 0, stream>>>(
          dline, ds, o0, o1, o2, D1, D2, coef, slices, n1);
  return (int)cudaGetLastError();
}

template <typename G>
int adjoint(const void* g, float* dline, float* ds, long long o0,
            long long o1, long long o2, int D0, int D1, int D2,
            const float* coef, const int* slices, int K, int n1, int n2,
            int j0, int lerp, int nearest, void* stream) {
  if (D0 <= 0 || D1 <= 0 || D2 <= 0) return (int)cudaGetLastError();
  if (K <= 0 || n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  const G* gg = static_cast<const G*>(g);
  cudaStream_t st = (cudaStream_t)stream;
  if (nearest) {
    return launch_adjoint<G, false, true>(gg, dline, ds, o0, o1, o2, D0, D1,
                                          D2, coef, slices, K, n1, n2, j0,
                                          st);
  }
  if (lerp) {
    return launch_adjoint<G, true, false>(gg, dline, ds, o0, o1, o2, D0, D1,
                                          D2, coef, slices, K, n1, n2, j0,
                                          st);
  }
  return launch_adjoint<G, false, false>(gg, dline, ds, o0, o1, o2, D0, D1,
                                         D2, coef, slices, K, n1, n2, j0, st);
}

}  // namespace

// ``src``: the source volume at its principal-axis, row and column element
// strides s0, s1, s2 (its permuted view's), D1 rows and D2 columns a
// slice; ``coef`` the (K, 8) packed planes; ``out`` (K, n1, n2) of the
// entry point's type; column j is the grid's column j0 + j.
#define TBR_PRESHEAR_ARGS                                                  \
  const float *src, long long s0, long long s1, long long s2, int D1,      \
      int D2, const float *coef, void *out, int K, int n1, int n2, int j0, \
      int lerp, int nearest, void *stream
#define TBR_PRESHEAR_CALL \
  src, s0, s1, s2, D1, D2, coef, out, K, n1, n2, j0, lerp, nearest, stream

TBR_API int tbr_preshear_f32(TBR_PRESHEAR_ARGS) {
  return forward<float>(TBR_PRESHEAR_CALL);
}

TBR_API int tbr_preshear_bf16(TBR_PRESHEAR_ARGS) {
  return forward<__nv_bfloat16>(TBR_PRESHEAR_CALL);
}

// ``g``: the (K, n1, n2) cotangent of the planes, of the entry point's
// type; ``dline`` a (K, n1, D2) float32 scratch; ``ds`` the source's
// cotangent, written whole at element strides o0, o1, o2 along the
// principal axis (D0 slices), the rows and the columns; ``slices`` the
// (D0, 2) int32 [first, last + 1) of the planes that read each slice.
#define TBR_PRESHEAR_ADJOINT_ARGS                                           \
  const void *g, float *dline, float *ds, long long o0, long long o1,       \
      long long o2, int D0, int D1, int D2, const float *coef,              \
      const int *slices, int K, int n1, int n2, int j0, int lerp,           \
      int nearest, void *stream
#define TBR_PRESHEAR_ADJOINT_CALL                                        \
  g, dline, ds, o0, o1, o2, D0, D1, D2, coef, slices, K, n1, n2, j0, lerp, \
      nearest, stream

TBR_API int tbr_preshear_adjoint_f32(TBR_PRESHEAR_ADJOINT_ARGS) {
  return adjoint<float>(TBR_PRESHEAR_ADJOINT_CALL);
}

TBR_API int tbr_preshear_adjoint_bf16(TBR_PRESHEAR_ADJOINT_ARGS) {
  return adjoint<__nv_bfloat16>(TBR_PRESHEAR_ADJOINT_CALL);
}
