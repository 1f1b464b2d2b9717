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
// Bound on the H100: its memory traffic and the latency of its dependent
// round trips. A step that fetches reads 8 volume taps, then, where the
// sample is not cut and has alpha above 0, 8 light taps; a step that only
// tests its cell reads one byte. Measured (PERF.md): dropping the light
// fetch took a third off the first design; loading the light taps together
// with the volume's, for every sample, cost more than its round trip saved;
// a walk that tested one cell per load cost half a fetching step per step.
// The 256^3 volume (64 MB) and the light volume fit the 50 MB L2 only in
// part, but neighbouring rays sample neighbouring voxels. Design: threads
// in 16x16-pixel blocks, a warp's rays a tile of 8x4 pixels that share
// cache lines (1-3% faster than rows of 16x2); the TF (4 KB) in shared
// memory, indexed directly; the window and the clip plane read from a
// device array (no host sync). Per ray:
// - with an occupancy grid (ops/octree.py::occupancy_grid, one byte per
//   cell, built with a margin for the rounding of the trilinear lerps), the
//   next 8 steps' positions, clip tests and cell bytes are evaluated at once
//   into a mask (8 byte loads, one round trip), and only the steps it keeps
//   are fetched: a sample whose cell can hold no windowed-TF alpha above 0
//   has alpha 0, and x + 0 * y is x;
// - a sample that is cut, or whose corrected alpha is 0, fetches no light
//   and composites nothing (the light volume is finite).
// Sample k keeps its position pos0 + step_vec * (k + 1): a skip advances k,
// never a position. Each thread loops to its own n_full and stops at
// termination. The trilinear lerps are written out by hand: hardware
// texture filtering keeps 8 fractional bits in its weights. The TPU design
// (pencil swizzle, DMA windows, 4-step segments, lane-shuffle TF) has no
// counterpart here. Every operation rounds as the plain version
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
  const unsigned char* __restrict__ occ;
  int X, Y, Z, LX, LY, LZ, GX, GY, GZ;
  float center, width, half_width, low_c, high_c;
  float ccx, ccy, ccz, cdx, cdy, cdz;
  float gsx, gsy, gsz;  // occupancy cells per unit of position
};

// The clip plane keeps a sample when dot(P - c, d) > 0.
__device__ __forceinline__ bool clipped(const Scene& s, float px, float py,
                                        float pz) {
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(px, s.ccx), s.cdx),
                __fmul_rn(__fsub_rn(py, s.ccy), s.cdy)),
      __fmul_rn(__fsub_rn(pz, s.ccz), s.cdz));
  return dot <= 0.0f;
}

__device__ __forceinline__ int cell(float p, float scale, int n) {
  return (int)fminf(fmaxf(floorf(__fmul_rn(p, scale)), 0.0f), (float)(n - 1));
}

// The occupancy byte of the cell of (px, py, pz): 0 only where the grid
// proves the sample's alpha is 0.
__device__ __forceinline__ unsigned char occupancy(const Scene& s, float px,
                                                   float py, float pz) {
  const int ix = cell(px, s.gsx, s.GX), iy = cell(py, s.gsy, s.GY);
  const int iz = cell(pz, s.gsz, s.GZ);
  return __ldg(s.occ + ((size_t)ix * s.GY + iy) * s.GZ + iz);
}

struct Ray {
  float p0x, p0y, p0z, svx, svy, svz, n_full;
  __device__ __forceinline__ void at(float kk, float* px, float* py,
                                     float* pz) const {
    *px = __fadd_rn(p0x, __fmul_rn(svx, kk));
    *py = __fadd_rn(p0y, __fmul_rn(svy, kk));
    *pz = __fadd_rn(p0z, __fmul_rn(svz, kk));
  }
};

constexpr int WINDOW = 8;  // steps whose fetch test is evaluated at once

// Bit j: step base + j is in the ray (k < n_full), not clipped and, with a
// grid, in an occupied cell. The cell bytes are loaded together.
template <bool GRID>
__device__ __forceinline__ unsigned fetch_mask(const Scene& s, const Ray& ray,
                                               int base) {
  unsigned mask = 0u;
  unsigned char occ[WINDOW];
#pragma unroll
  for (int j = 0; j < WINDOW; ++j) {
    float px, py, pz;
    ray.at((float)(base + j + 1), &px, &py, &pz);
    const bool keep = (float)(base + j) < ray.n_full && !clipped(s, px, py, pz);
    mask |= (unsigned)keep << j;
    if (GRID) occ[j] = occupancy(s, px, py, pz);
  }
  if (GRID) {
#pragma unroll
    for (int j = 0; j < WINDOW; ++j) {
      if (occ[j] == 0) mask &= ~(1u << j);
    }
  }
  return mask;
}

// The fetched sample at (px, py, pz) with opacity step `sw`: false when it
// is cut or its corrected alpha is 0 (it then adds exactly nothing), else
// its rgb times light and its corrected alpha.
__device__ __forceinline__ bool lit_sample(const Scene& s,
                                           const float4* __restrict__ tf,
                                           float px, float py, float pz,
                                           float sw, float* cr, float* cg,
                                           float* cb, float* a) {
  const float value = trilinear(s.vol, s.X, s.Y, s.Z, px, py, pz);
  const float tf_pos = tbr_tf_pos(value, s.center, s.half_width, s.width);
  if (tbr_cut(tf_pos, s.low_c, s.high_c)) return false;
  int t0, t1;
  float frac;
  tbr_tf_taps(tf_pos, &t0, &t1, &frac);
  const float4 c0 = tf[t0], c1 = tf[t1];
  *a = tbr_correct_alpha(tbr_lerp(c0.w, c1.w, frac), sw);
  if (*a == 0.0f) return false;
  const float l = trilinear(s.light, s.LX, s.LY, s.LZ,
                            fminf(fmaxf(px, 0.0f), 1.0f),
                            fminf(fmaxf(py, 0.0f), 1.0f),
                            fminf(fmaxf(pz, 0.0f), 1.0f));
  *cr = __fmul_rn(tbr_lerp(c0.x, c1.x, frac), l);
  *cg = __fmul_rn(tbr_lerp(c0.y, c1.y, frac), l);
  *cb = __fmul_rn(tbr_lerp(c0.z, c1.z, frac), l);
  return true;
}

template <bool GRID>
__global__ void __launch_bounds__(256) march_kernel(
    const float* __restrict__ ch, const float* __restrict__ vol,
    const float* __restrict__ light, const float* __restrict__ tf,
    const float* __restrict__ prm, const unsigned char* __restrict__ occ,
    float* __restrict__ out, int H, int W, int X, int Y, int Z, int LX,
    int LY, int LZ, int GX, int GY, int GZ, float step_world, float density,
    float et, float gsx, float gsy, float gsz, int compat) {
  __shared__ float4 stf[256];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < 256; t += blockDim.x * blockDim.y) {
    stf[t] = make_float4(tf[4 * t], tf[4 * t + 1], tf[4 * t + 2],
                         tf[4 * t + 3]);
  }
  __syncthreads();

  // a warp takes a tile of 8x4 pixels: its rays sample a rounder patch of
  // voxels than a 16x2 row pair does
  const int lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * 16 + (warp >> 1) * 4 + (lane >> 3);
  if (x >= W || y >= H) return;
  const size_t n = (size_t)H * W;
  const size_t r = (size_t)y * W + x;
  Ray ray;
  ray.p0x = ch[r], ray.p0y = ch[n + r], ray.p0z = ch[2 * n + r];
  ray.svx = ch[3 * n + r], ray.svy = ch[4 * n + r], ray.svz = ch[5 * n + r];
  ray.n_full = ch[6 * n + r];
  const float ff = ch[7 * n + r];

  Scene s;
  s.vol = vol;
  s.light = light;
  s.occ = occ;
  s.X = X, s.Y = Y, s.Z = Z, s.LX = LX, s.LY = LY, s.LZ = LZ;
  s.GX = GX, s.GY = GY, s.GZ = GZ;
  s.gsx = gsx, s.gsy = gsy, s.gsz = gsz;
  s.center = prm[0], s.width = prm[1];
  s.half_width = __fmul_rn(s.width, 0.5f);
  s.low_c = prm[2], s.high_c = prm[3];
  s.ccx = prm[4], s.ccy = prm[5], s.ccz = prm[6];
  s.cdx = prm[7], s.cdy = prm[8], s.cdz = prm[9];

  float rr = 0.0f, rg = 0.0f, rb = 0.0f, alpha = 0.0f;
  float cr, cg, cb, a, px, py, pz;
  bool term = false;
  for (int base = 0; !term && (float)base < ray.n_full; base += WINDOW) {
    unsigned mask = fetch_mask<GRID>(s, ray, base);
    while (mask != 0u) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1u;
      ray.at((float)(base + j + 1), &px, &py, &pz);
      if (!lit_sample(s, stf, px, py, pz, step_world, &cr, &cg, &cb, &a)) {
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
  }
  if (!term && ff > 0.0f) {
    const float sw =
        compat ? __fmul_rn(density, ff) : __fmul_rn(step_world, ff);
    ray.at(__fadd_rn(ray.n_full, ff), &px, &py, &pz);
    if (!clipped(s, px, py, pz) && (!GRID || occupancy(s, px, py, pz)) &&
        lit_sample(s, stf, px, py, pz, sw, &cr, &cg, &cb, &a)) {
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

// occ: the (GX, GY, GZ) occupancy grid as bytes, or null; (gsx, gsy, gsz)
// its cells per unit of position.
TBR_API int tbr_march(const float* ch, const float* vol, const float* light,
                      const float* tf, const float* prm,
                      const unsigned char* occ, float* out, int H, int W,
                      int X, int Y, int Z, int LX, int LY, int LZ, int GX,
                      int GY, int GZ, float step_world, float density,
                      float et, float gsx, float gsy, float gsz, int compat,
                      void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((W + 15) / 16, (H + 15) / 16);
  auto kernel = occ ? march_kernel<true> : march_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ch, vol, light, tf, prm, occ, out, H, W, X, Y, Z, LX, LY, LZ, GX, GY,
      GZ, step_world, density, et, gsx, gsy, gsz, compat);
  return (int)cudaGetLastError();
}
