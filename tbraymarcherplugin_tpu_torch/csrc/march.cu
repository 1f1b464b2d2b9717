// K9: the exact lit ray march (`PerformWindowedLitRaymarch`), one thread
// per ray.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_march.py::
// _march_kernel_body (entry point march_lit_pallas). Per ray: sample k sits
// at pos0 + step_vec * (k + 1) for k < n_full; each sample is clipped by the
// plane (dot(P - c, d) <= 0, at the unclamped position), the volume is
// sampled trilinearly at the unclamped position (per-axis clamped taps), the
// value is windowed (cutoffs on the TF position), the 256-texel TF looked
// up, its alpha clamped and step-corrected, the rgb multiplied by the light
// volume sampled at the position clamped to [0, 1], and the sample
// over-composited; a regular step that lifts alpha past the threshold snaps
// it to 1 and ends the ray. A ray that did not end takes the fractional
// final sample at pos0 + step_vec * (n_full + final_frac), whose step is
// VOLUME_DENSITY * final_frac (compat) or step_world * final_frac, and which
// never snaps.
//
// Bound on the H100: the scattered volume and light loads (16 four-byte
// loads per sample, up to ~260 samples per ray at 150 steps) and their
// latency; the 256^3 volume (64 MB) and the light volume fit the 50 MB L2
// only in part, but neighbouring rays sample neighbouring voxels. Design:
// threads in 16x16-pixel blocks, so a warp's rays (2 rows of 16 pixels)
// share cache lines; loads through the read-only path (__ldg); the TF (4 KB)
// in shared memory, indexed directly; the window and the clip plane read
// from a device array (no host sync); each thread loops to its own n_full
// and stops at termination. The trilinear lerps are written out by hand:
// hardware texture filtering keeps 8 fractional bits in its weights. The
// TPU design (pencil swizzle, DMA windows, 4-step segments, lane-shuffle
// TF) has no counterpart here. Every operation rounds as the plain version
// (ops/fused_march.py::march_lit_fused_plain) does it, in its order.

#include "common.cuh"

namespace {

// Texel taps of a clamp-addressed trilinear fetch along one axis:
// g = p * dim - 0.5, taps floor(g) and floor(g) + 1 clamped to the volume.
__device__ __forceinline__ void axis_taps(float p, int dim, int* i0, int* i1,
                                          float* frac) {
  const float g = __fsub_rn(__fmul_rn(p, (float)dim), 0.5f);
  const float gf = floorf(g);
  *frac = __fsub_rn(g, gf);
  // clamped before the int conversion; the clamped taps are unchanged
  const int i = (int)fminf(fmaxf(gf, -1.0f), (float)dim);
  *i0 = min(max(i, 0), dim - 1);
  *i1 = min(max(i + 1, 0), dim - 1);
}

__device__ __forceinline__ float trilinear(const float* __restrict__ v,
                                           int X, int Y, int Z, float px,
                                           float py, float pz) {
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  axis_taps(px, X, &x0, &x1, &fx);
  axis_taps(py, Y, &y0, &y1, &fy);
  axis_taps(pz, Z, &z0, &z1, &fz);
  const size_t sx = (size_t)Y * Z;
  const float* r00 = v + x0 * sx + (size_t)y0 * Z;
  const float* r01 = v + x0 * sx + (size_t)y1 * Z;
  const float* r10 = v + x1 * sx + (size_t)y0 * Z;
  const float* r11 = v + x1 * sx + (size_t)y1 * Z;
  const float gz = __fsub_rn(1.0f, fz);
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  const float c00 = __fadd_rn(__fmul_rn(__ldg(r00 + z0), gz),
                              __fmul_rn(__ldg(r00 + z1), fz));
  const float c01 = __fadd_rn(__fmul_rn(__ldg(r01 + z0), gz),
                              __fmul_rn(__ldg(r01 + z1), fz));
  const float c10 = __fadd_rn(__fmul_rn(__ldg(r10 + z0), gz),
                              __fmul_rn(__ldg(r10 + z1), fz));
  const float c11 = __fadd_rn(__fmul_rn(__ldg(r11 + z0), gz),
                              __fmul_rn(__ldg(r11 + z1), fz));
  const float c0 = __fadd_rn(__fmul_rn(c00, gy), __fmul_rn(c01, fy));
  const float c1 = __fadd_rn(__fmul_rn(c10, gy), __fmul_rn(c11, fy));
  return __fadd_rn(__fmul_rn(c0, gx), __fmul_rn(c1, fx));
}

struct Scene {
  const float* __restrict__ vol;
  const float* __restrict__ light;
  int X, Y, Z, LX, LY, LZ;
  float center, width, half_width, low_c, high_c;
  float ccx, ccy, ccz, cdx, cdy, cdz;
};

// One sample at (px, py, pz) with opacity step `sw`: false when it is
// clipped or cut (it then adds exactly nothing), else its rgb times light
// and its corrected alpha.
__device__ __forceinline__ bool lit_sample(const Scene& s,
                                           const float4* __restrict__ tf,
                                           float px, float py, float pz,
                                           float sw, float* cr, float* cg,
                                           float* cb, float* a) {
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(px, s.ccx), s.cdx),
                __fmul_rn(__fsub_rn(py, s.ccy), s.cdy)),
      __fmul_rn(__fsub_rn(pz, s.ccz), s.cdz));
  if (dot <= 0.0f) return false;
  const float value = trilinear(s.vol, s.X, s.Y, s.Z, px, py, pz);
  const float tf_pos = tbr_tf_pos(value, s.center, s.half_width, s.width);
  if (tbr_cut(tf_pos, s.low_c, s.high_c)) return false;
  int t0, t1;
  float frac;
  tbr_tf_taps(tf_pos, &t0, &t1, &frac);
  const float4 c0 = tf[t0], c1 = tf[t1];
  *a = tbr_correct_alpha(tbr_lerp(c0.w, c1.w, frac), sw);
  const float l = trilinear(s.light, s.LX, s.LY, s.LZ,
                            fminf(fmaxf(px, 0.0f), 1.0f),
                            fminf(fmaxf(py, 0.0f), 1.0f),
                            fminf(fmaxf(pz, 0.0f), 1.0f));
  *cr = __fmul_rn(tbr_lerp(c0.x, c1.x, frac), l);
  *cg = __fmul_rn(tbr_lerp(c0.y, c1.y, frac), l);
  *cb = __fmul_rn(tbr_lerp(c0.z, c1.z, frac), l);
  return true;
}

__global__ void __launch_bounds__(256) march_kernel(
    const float* __restrict__ ch, const float* __restrict__ vol,
    const float* __restrict__ light, const float* __restrict__ tf,
    const float* __restrict__ prm, float* __restrict__ out, int H, int W,
    int X, int Y, int Z, int LX, int LY, int LZ, float step_world,
    float density, float et, int compat) {
  __shared__ float4 stf[256];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < 256; t += blockDim.x * blockDim.y) {
    stf[t] = make_float4(tf[4 * t], tf[4 * t + 1], tf[4 * t + 2],
                         tf[4 * t + 3]);
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t n = (size_t)H * W;
  const size_t r = (size_t)y * W + x;
  const float p0x = ch[r], p0y = ch[n + r], p0z = ch[2 * n + r];
  const float svx = ch[3 * n + r], svy = ch[4 * n + r], svz = ch[5 * n + r];
  const float n_full = ch[6 * n + r], ff = ch[7 * n + r];

  Scene s;
  s.vol = vol;
  s.light = light;
  s.X = X, s.Y = Y, s.Z = Z, s.LX = LX, s.LY = LY, s.LZ = LZ;
  s.center = prm[0], s.width = prm[1];
  s.half_width = __fmul_rn(s.width, 0.5f);
  s.low_c = prm[2], s.high_c = prm[3];
  s.ccx = prm[4], s.ccy = prm[5], s.ccz = prm[6];
  s.cdx = prm[7], s.cdy = prm[8], s.cdz = prm[9];

  float rr = 0.0f, rg = 0.0f, rb = 0.0f, alpha = 0.0f;
  float cr, cg, cb, a;
  bool term = false;
  for (int k = 0; (float)k < n_full; ++k) {
    const float kk = (float)(k + 1);
    if (!lit_sample(s, stf, __fadd_rn(p0x, __fmul_rn(svx, kk)),
                    __fadd_rn(p0y, __fmul_rn(svy, kk)),
                    __fadd_rn(p0z, __fmul_rn(svz, kk)), step_world, &cr, &cg,
                    &cb, &a)) {
      continue;
    }
    const float trans = __fsub_rn(1.0f, alpha);
    rr = __fadd_rn(rr, __fmul_rn(__fmul_rn(cr, a), trans));
    rg = __fadd_rn(rg, __fmul_rn(__fmul_rn(cg, a), trans));
    rb = __fadd_rn(rb, __fmul_rn(__fmul_rn(cb, a), trans));
    alpha = __fadd_rn(alpha, __fmul_rn(a, trans));
    if (alpha > et) {  // early-termination snap; the ray is done
      alpha = 1.0f;
      term = true;
      break;
    }
  }
  if (!term && ff > 0.0f) {
    const float kk = __fadd_rn(n_full, ff);
    const float sw = compat ? __fmul_rn(density, ff) : __fmul_rn(step_world, ff);
    if (lit_sample(s, stf, __fadd_rn(p0x, __fmul_rn(svx, kk)),
                   __fadd_rn(p0y, __fmul_rn(svy, kk)),
                   __fadd_rn(p0z, __fmul_rn(svz, kk)), sw, &cr, &cg, &cb,
                   &a)) {
      const float trans = __fsub_rn(1.0f, alpha);
      rr = __fadd_rn(rr, __fmul_rn(__fmul_rn(cr, a), trans));
      rg = __fadd_rn(rg, __fmul_rn(__fmul_rn(cg, a), trans));
      rb = __fadd_rn(rb, __fmul_rn(__fmul_rn(cb, a), trans));
      alpha = __fadd_rn(alpha, __fmul_rn(a, trans));
    }
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(rr, rg, rb, alpha);
}

}  // namespace

TBR_API int tbr_march(const float* ch, const float* vol, const float* light,
                      const float* tf, const float* prm, float* out, int H,
                      int W, int X, int Y, int Z, int LX, int LY, int LZ,
                      float step_world, float density, float et, int compat,
                      void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((W + 15) / 16, (H + 15) / 16);
  march_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ch, vol, light, tf, prm, out, H, W, X, Y, Z, LX, LY, LZ, step_world,
      density, et, compat);
  return (int)cudaGetLastError();
}
