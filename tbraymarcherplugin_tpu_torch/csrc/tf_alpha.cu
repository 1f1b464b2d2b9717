// K3: windowed transfer-function alpha of the occluder field.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_tf.py::
// _alpha_kernel (entry point windowed_tf_alpha), and with its occluder
// source also the XLA work around it in tbraymarcherplugin_tpu/ops/
// lighting.py::occluder_opacity_volume: the constant-shift trilinear
// resample of the volume at the light voxels' offset centers, the [0, 1]^3
// cube test and the soft clip weight. On the TPU the 256-texel lookup was a
// lane shuffle on a packed (8, 128) tile; here it is a direct index into a
// 1 KB alpha table in shared memory. The window (center, width, low cutoff,
// high cutoff) is read from device memory, so it can be a tensor that takes
// a gradient without a host sync; the occluder source takes a host window
// by value instead.
//
// Where the values come from is a template parameter:
//   - values: an array of sampled values (the slab-sharded occluder, whose
//     samples come from a slab and its halo);
//   - occluder: the volume itself. Each light voxel's value, cube test and
//     clip weight are computed in registers, and only the opacity
//     keep ? alpha * weight : 0 is written, in the light grid's (X, Y, Z)
//     layout. The sampled values and keep ? weight : 0, which the backward
//     (K8) needs, are written only when asked for.
//
// Bound on the H100: device memory. Values: at 256^3 the pass reads and
// writes 16.8M floats (134 MB), about 40 us at 3.35 TB/s. Occluder: at full
// light resolution the volume read once and the opacity written once, the
// same bytes (a 512x512x384 face: 805 MB, 0.24 ms); the resample, clip
// weight and TF are some 80 float operations a voxel, about a third of the
// time of those bytes at 67 TFLOP/s. Designs: values, a grid-stride loop
// over the flat array, neighbouring threads on neighbouring addresses.
// Occluder, a column walk: a thread per light (y, z) column of a slab of
// OCC_SLAB x planes, neighbouring threads on neighbouring z (coalesced loads
// and stores); at ratio 1 along x each step carries the previous plane's 4
// corners in registers and loads the 4 of the next plane, and the y and z
// halo corners are the neighbouring threads' (L1 and L2), so the volume is
// read from device memory about once. The table is loaded once per block.
//
// A Z window (`oz`, `vz`) lets a launch write a run of the light grid's
// Z planes from a volume that holds only a run of its Z planes (a slab and
// its halo, parallel/slab_sharding.py): every coordinate stays the whole
// grid's, and only the addresses are re-based, so a window's values are
// those of the whole field's planes bit for bit.
//
// Arithmetic as ops/lighting.py::occluder_opacity_plain and the parent
// composition: uvw = ((g + 0.5) / res) + off, the resample's lerps
// (z, then y, then x at ratio 1; x, then y, then z, the selection
// matmuls' order, above it) and the clip weight's sums each round once, so
// the values are those of the plain version at ratio 1. The clip weight's
// distance and norm sum in a fixed order (the norm's squares fused), which
// may part from PyTorch's reductions in the last ulps: a distance's ulp
// moves the weight by up to its slope, 1/sqrt(3) times the light grid's
// largest size.

#include "common.cuh"

enum TbrAlphaSource : int { TBR_ALPHA_VALUES = 0, TBR_ALPHA_OCCLUDER = 1 };

// One face's occluder geometry, computed on the host
// (ops/lighting.py::_const_shift and occluder_opacity): light voxel g
// samples volume indices base + g * r and base + g * r + 1 per axis,
// clamped to the volume (clamp-to-edge), with weights (g_w, f).
struct TbrOccluder {
  int vd[3];        // volume (X, Y, Z)
  int ld[3];        // light grid (X, Y, Z)
  int base[3];      // first corner of light voxel 0, may lie outside
  int r[3];         // volume / light ratio per axis
  float f[3];       // weight of the second corner
  float g[3];       // 1 - f
  float res[3];     // the light grid's size as floats
  float off[3];     // UVW offset toward the light
  float clip[6];    // clip center and direction, where clip_dev is null
  float win[4];     // the window, where the kernel's `win` is null
  const float* clip_dev;  // the clip plane (6 floats) on the device, or null
  int x_first;      // any ratio above 1: lerp x, then y, then z
  int oz[2];        // the light Z planes written: oz[0] .. oz[0] + oz[1] - 1
  int vz[2];        // the volume's Z planes held: vz[0] .. vz[0] + vz[1] - 1
};

constexpr int OCC_SLAB = 16;  // x planes a thread walks
constexpr float TBR_ONE_OVER_SQRT_3 = 0.57735026919f;

__device__ __forceinline__ float tbr_alpha(float value, const float* tab,
                                           float center, float half_width,
                                           float width, float low_c,
                                           float high_c, float step) {
  float tf_pos = tbr_tf_pos(value, center, half_width, width);
  int i0, i1;
  float frac;
  tbr_tf_taps(tf_pos, &i0, &i1, &frac);
  float a = tbr_correct_alpha(tbr_lerp(tab[i0], tab[i1], frac), step);
  return tbr_cut(tf_pos, low_c, high_c) ? 0.0f : a;
}

__device__ __forceinline__ int tbr_clampi(int i, int hi) {
  return min(max(i, 0), hi);
}

// (g + 0.5) / res + off, each operation rounded once.
__device__ __forceinline__ float tbr_uvw(int g, float res, float off) {
  return __fadd_rn(__fdiv_rn(__fadd_rn((float)g, 0.5f), res), off);
}

// Trilinear value from the corners v[dx][dy * 2 + dz].
__device__ __forceinline__ float tbr_trilerp(const float (&v)[2][4],
                                             const TbrOccluder& o) {
  if (o.x_first) {  // the selection matmuls' order: x, then y, then z
    float t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t[c] = __fadd_rn(__fmul_rn(v[0][c], o.g[0]), __fmul_rn(v[1][c], o.f[0]));
    }
    const float u0 = __fadd_rn(__fmul_rn(t[0], o.g[1]), __fmul_rn(t[2], o.f[1]));
    const float u1 = __fadd_rn(__fmul_rn(t[1], o.g[1]), __fmul_rn(t[3], o.f[1]));
    return __fadd_rn(__fmul_rn(u0, o.g[2]), __fmul_rn(u1, o.f[2]));
  }
  float c[2][2];  // z, then y, then x
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      c[dx][dy] = __fadd_rn(__fmul_rn(v[dx][2 * dy], o.g[2]),
                            __fmul_rn(v[dx][2 * dy + 1], o.f[2]));
    }
  }
  const float c0 = __fadd_rn(__fmul_rn(c[0][0], o.g[1]), __fmul_rn(c[0][1], o.f[1]));
  const float c1 = __fadd_rn(__fmul_rn(c[1][0], o.g[1]), __fmul_rn(c[1][1], o.f[1]));
  return __fadd_rn(__fmul_rn(c0, o.g[0]), __fmul_rn(c1, o.f[0]));
}

// src: the values (TBR_ALPHA_VALUES, n of them) or the volume
// (TBR_ALPHA_OCCLUDER, geometry in `o`; `win`, `values` and `keep_weight`
// may be null).
template <int SRC>
__global__ void tf_alpha_kernel(const float* __restrict__ src,
                                const float* __restrict__ tf,
                                const float* __restrict__ win,
                                float* __restrict__ out, long long n,
                                float step, TbrOccluder o,
                                float* __restrict__ values,
                                float* __restrict__ keep_weight) {
  __shared__ float alpha_tab[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    alpha_tab[t] = tf[4 * t + 3];
  }
  __syncthreads();
  const float* w = win ? win : o.win;
  const float center = w[0], width = w[1];
  const float low_c = w[2], high_c = w[3];
  const float half_width = __fmul_rn(width, 0.5f);
  if constexpr (SRC == TBR_ALPHA_VALUES) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      out[i] = tbr_alpha(src[i], alpha_tab, center, half_width, width, low_c,
                         high_c, step);
    }
  } else {
    const int LX = o.ld[0], LY = o.ld[1], LZ = o.oz[1];  // LZ written
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= (long long)LY * LZ) return;
    const int y = (int)(col / LZ), zl = (int)(col - (long long)y * LZ);
    const int z = o.oz[0] + zl;  // the grid's own Z index
    const int x0 = blockIdx.y * OCC_SLAB, x1 = min(x0 + OCC_SLAB, LX);
    // the column's corners in a volume plane, (dy, dz) as dy * 2 + dz
    const int yb = o.base[1] + y * o.r[1], zb = o.base[2] + z * o.r[2];
    long long corner[4];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        corner[2 * dy + dz] =
            (long long)tbr_clampi(yb + dy, o.vd[1] - 1) * o.vz[1] +
            (tbr_clampi(zb + dz, o.vd[2] - 1) - o.vz[0]);
      }
    }
    const long long plane = (long long)o.vd[1] * o.vz[1];
    // the column's UVW along y and z, its cube test and clip terms
    float cc[3], cd[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cc[a] = o.clip_dev ? o.clip_dev[a] : o.clip[a];
      cd[a] = o.clip_dev ? o.clip_dev[3 + a] : o.clip[3 + a];
    }
    const float uy = tbr_uvw(y, o.res[1], o.off[1]);
    const float uz = tbr_uvw(z, o.res[2], o.off[2]);
    const bool in_yz = uy >= 0.0f && uy <= 1.0f && uz >= 0.0f && uz <= 1.0f;
    const float dist_y = __fmul_rn(__fsub_rn(uy, cc[1]), cd[1]);
    const float dist_z = __fmul_rn(__fsub_rn(uz, cc[2]), cd[2]);
    float v[2][4];
    for (int x = x0; x < x1; ++x) {
      const int xb = o.base[0] + x * o.r[0];
      const float* p1 = src + (long long)tbr_clampi(xb + 1, o.vd[0] - 1) * plane;
      if (x == x0 || o.r[0] != 1) {
        const float* p0 = src + (long long)tbr_clampi(xb, o.vd[0] - 1) * plane;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[0][c] = p0[corner[c]];
      } else {  // ratio 1: this plane's first corners are the last step's second
#pragma unroll
        for (int c = 0; c < 4; ++c) v[0][c] = v[1][c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) v[1][c] = p1[corner[c]];
      const float value = tbr_trilerp(v, o);
      const float ux = tbr_uvw(x, o.res[0], o.off[0]);
      const bool inside = in_yz && ux >= 0.0f && ux <= 1.0f;
      // soft clip weight (ops/sampling.py::clip_soft_alpha_weight)
      const float dist = __fadd_rn(
          __fadd_rn(__fmul_rn(__fsub_rn(ux, cc[0]), cd[0]), dist_y), dist_z);
      float vox[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        vox[a] = __fmul_rn(__fmul_rn(cd[a], dist), o.res[a]);
      }
      const float norm = __fsqrt_rn(__fmaf_rn(
          vox[2], vox[2], __fmaf_rn(vox[1], vox[1], __fmul_rn(vox[0], vox[0]))));
      const float sign = dist > 0.0f ? 1.0f : (dist < 0.0f ? -1.0f : 0.0f);
      const float weight = fminf(fmaxf(__fadd_rn(__fmul_rn(__fmul_rn(
          TBR_ONE_OVER_SQRT_3, norm), sign), 0.5f), 0.0f), 1.0f);
      const bool keep = inside && weight > 0.0f;
      const float a = tbr_alpha(value, alpha_tab, center, half_width, width,
                                low_c, high_c, step);
      const long long i = ((long long)x * LY + y) * LZ + zl;
      out[i] = keep ? __fmul_rn(a, weight) : 0.0f;
      if (values) values[i] = value;
      if (keep_weight) keep_weight[i] = keep ? weight : 0.0f;
    }
  }
}

TBR_API int tbr_tf_alpha(const float* values, const float* tf,
                         const float* win, float* out, long long n,
                         float step, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks/SM
  tf_alpha_kernel<TBR_ALPHA_VALUES>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          values, tf, win, out, n, step, TbrOccluder{}, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// One face's occluder opacity from the volume (X, Y, Z), or from the Z
// planes geo->vz of it, into the light planes geo->oz; `geo` is a host
// pointer, copied into the launch. `win` (then read from geo->win),
// `values` and `keep_weight` may be null.
TBR_API int tbr_occluder_alpha(const float* volume, const float* tf,
                               const float* win, const TbrOccluder* geo,
                               float* out, float* values, float* keep_weight,
                               float step, void* stream) {
  const long long cols = (long long)geo->ld[1] * geo->oz[1];
  if (cols <= 0 || geo->ld[0] <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const dim3 grid((unsigned)((cols + threads - 1) / threads),
                  (unsigned)((geo->ld[0] + OCC_SLAB - 1) / OCC_SLAB));
  tf_alpha_kernel<TBR_ALPHA_OCCLUDER>
      <<<grid, threads, 0, (cudaStream_t)stream>>>(
          volume, tf, win, out, 0, step, *geo, values, keep_weight);
  return (int)cudaGetLastError();
}

TBR_API const char* tbr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
