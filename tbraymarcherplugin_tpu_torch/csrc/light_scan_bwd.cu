// K7: adjoint of the propagation scan (K4), a reverse shift-scan.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_lighting.py::
// _scan_bwd_kernel (entry point _scan_bwd_pallas). With g_k the cotangent
// of slice k, y_k the forward output (y_{-1} = alpha) and S the forward's
// border shift, k runs from K-1 down to 0:
//   lam_k = g_k + shift2d_border(m_{k+1}, -off, border = 0)   (m_K = 0)
//   m_k   = (1 - o_k) * lam_k
//   d o_k = -S(y_{k-1}) * lam_k
// and it outputs every d o_k, sum_k m_k and m_0; the caller assembles
// d alpha from the last two. The offsets take no gradient.
//
// Bound on the H100: the slice-to-slice dependency. No pixel of slice k can
// start before the carry m_{k+1} around it is complete, and the lateral
// offset couples each pixel to rows |off_x| + 1 away. Design: one
// cooperative launch per face, at most one block per SM, so every block is
// resident and may wait for another:
// - block b owns the row band [b R, b R + R), R = ceil(H / min(H, SMs));
// - the carry m ping-pongs between two (H, W) planes in global memory,
//   which stay in L2 and are read with L2 loads (ld.global.cg);
// - after writing its rows of m_k a block publishes the slice with a
//   release store of a 64-bit counter; before reading m_{k+1} it waits,
//   with acquire loads, for the counters of the blocks within |jx| + 1 + R
//   rows of its band: those whose rows its shift reads (m_{k+1} is there)
//   and those that read its rows (they are done with the plane it is about
//   to overwrite). No grid-wide barrier: a block waits for its neighbours
//   only. The counters persist between calls (the wrapper passes the value
//   they reached, `base`), so nothing is zero-filled per call;
// - g, o and the taps of y_{k-1} do not depend on the carry: a block loads
//   them two slices ahead into registers, right after it publishes, so
//   their latency is off the chain; the d o stores come after the publish;
// - the publish is a block barrier and one release store (no separate
//   fence); the wait, acquire loads and a block barrier (scan_sync.cuh,
//   shared with K4, whose counters are the same pool);
// - sum_k m_k stays in registers and is written once at the end, m_0 at
//   slice 0.
// A thread takes 1 to 8 pixels of its band (a template parameter); a face
// fits when R W <= 8192 (1024 threads of 8 pixels): on the H100's 132 SMs
// every face up to 1024x1024 does, and the wrapper raises for a larger one
// (tbr_light_scan_bwd_blocks returns 0). A wait that lasts 2 s is a fault:
// the kernel traps rather than hang. Each pixel does the plain version's
// operations in its order, so K7 agrees with
// ops/light_scan.py::propagate_face_scan_bwd_plain bit for bit.

#include "common.cuh"
#include "scan_sync.cuh"

namespace {

constexpr int MAX_UNITS = 8;                 // pixels a thread

using tbr_scan::publish;
using tbr_scan::wait_for;

// One pixel's place: its offset in a plane, and for each shift (m's by
// -off, y's by +off) the offset of its first tap with the validity of the
// two tap rows (bits 0, 1) and columns (bits 2, 3).
struct Pixel {
  int plane, mo, yo;
  unsigned mbits, ybits;
};

__device__ __forceinline__ unsigned tap_bits(int r, int c, int H, int W) {
  return (unsigned)(r >= 0 && r < H) | (unsigned)(r + 1 >= 0 && r + 1 < H)
                                           << 1 |
         (unsigned)(c >= 0 && c < W) << 2 |
         (unsigned)(c + 1 >= 0 && c + 1 < W) << 3;
}

// The four taps of a shift (rows r, r + 1 by columns c, c + 1), a tap in a
// row outside the face reading `border`.
template <bool L2>
__device__ __forceinline__ void load_taps(const float* src, int o, int W,
                                          unsigned bits, float border,
                                          float* t) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int row = d >> 1, col = d & 1;
    const bool ok = ((bits >> row) & 1u) && ((bits >> (2 + col)) & 1u);
    const float* p = src + o + row * W + col;
    t[d] = ok ? (L2 ? __ldcg(p) : __ldg(p)) : border;
  }
}

// tbr_shift2d's arithmetic on loaded taps (t[0], t[1]: row r, columns c and
// c + 1; t[2], t[3]: row r + 1): rows lerp by fx, then columns by fy; a
// column outside the face gives `border` without a lerp.
__device__ __forceinline__ float shift_taps(const float* t, unsigned bits,
                                            float border, float gx, float fx,
                                            float gy, float fy) {
  float c[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    c[d] = ((bits >> (2 + d)) & 1u)
               ? __fadd_rn(__fmul_rn(t[d], gx), __fmul_rn(t[2 + d], fx))
               : border;
  }
  return __fadd_rn(__fmul_rn(c[0], gy), __fmul_rn(c[1], fy));
}

template <int P, int THREADS>
__global__ void __launch_bounds__(THREADS, 1) light_scan_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ op,
    const float* __restrict__ y, float* __restrict__ d_op,
    float* __restrict__ msum_out, float* __restrict__ m0_out, float* mbuf,
    unsigned long long* flags, unsigned long long base, int K, int H, int W,
    int R, int ix, float fx, int iy, float fy, int jx, float hx, int jy,
    float hy, const float* __restrict__ alpha_p) {
  const int b = blockIdx.x;
  const int r0 = b * R;
  const int npix = min(R, H - r0) * W;
  const size_t hw = (size_t)H * W;
  const float alpha = *alpha_p;
  const float gxm = __fsub_rn(1.0f, hx), gym = __fsub_rn(1.0f, hy);
  const float gxy = __fsub_rn(1.0f, fx), gyy = __fsub_rn(1.0f, fy);
  // the blocks within |jx| + 1 + R rows of this band
  const int reach = abs(jx) + 1 + R;
  const int lo = max(r0 - reach, 0) / R;
  const int hi = min(r0 + R - 1 + reach, H - 1) / R;

  Pixel px[P];
  float msum[P], gA[P], oA[P], yA[P][4], gB[P], oB[P], yB[P][4];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int u = min((int)threadIdx.x + q * THREADS, npix - 1);
    const int i = r0 + u / W, j = u % W;
    px[q].plane = i * W + j;
    px[q].mo = (i + jx) * W + j + jy;
    px[q].yo = (i + ix) * W + j + iy;
    px[q].mbits = tap_bits(i + jx, j + jy, H, W);
    px[q].ybits = tap_bits(i + ix, j + iy, H, W);
    msum[q] = 0.0f;
  }

  // the inputs of slice k: g_k, o_k and the taps of y_{k-1} (alpha at 0)
  auto load_inputs = [&](int k, float (&gv)[P], float (&ov)[P],
                         float (&yt)[P][4]) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      gv[q] = __ldg(g + k * hw + px[q].plane);
      ov[q] = __ldg(op + k * hw + px[q].plane);
      if (k > 0) {
        load_taps<false>(y + (k - 1) * hw, px[q].yo, W, px[q].ybits, alpha,
                         yt[q]);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) yt[q][d] = alpha;
      }
    }
  };
  // step s computes slice k = K - 1 - s from inputs loaded two steps
  // before, then loads slice k - 2's into the same registers
  auto step = [&](int s, float (&gv)[P], float (&ov)[P], float (&yt)[P][4]) {
    const int k = K - 1 - s;
    if (s > 0) wait_for(flags, lo, hi, base + s);
    const float* m_next = mbuf + ((s + 1) & 1) * hw;
    float* m_out = mbuf + (s & 1) * hw;
    float dv[P], mv[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float sm = 0.0f;  // m_K = 0: every tap and the border are 0
      if (s > 0) {
        float t[4];
        load_taps<true>(m_next, px[q].mo, W, px[q].mbits, 0.0f, t);
        sm = shift_taps(t, px[q].mbits, 0.0f, gxm, hx, gym, hy);
      }
      const float pre = shift_taps(yt[q], px[q].ybits, alpha, gxy, fx, gyy,
                                   fy);
      const float lam = __fadd_rn(gv[q], sm);
      mv[q] = __fmul_rn(__fsub_rn(1.0f, ov[q]), lam);
      msum[q] = __fadd_rn(msum[q], mv[q]);
      dv[q] = __fmul_rn(-pre, lam);
    }
    if (k > 0) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if ((int)threadIdx.x + q * THREADS < npix) {
          __stcg(m_out + px[q].plane, mv[q]);
        }
      }
      publish(flags, b, base + s + 1);  // the block's rows of m_k
    }
    float* dk = d_op + k * hw;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if ((int)threadIdx.x + q * THREADS < npix) {
        dk[px[q].plane] = dv[q];
        if (k == 0) m0_out[px[q].plane] = mv[q];
      }
    }
    if (k >= 2) load_inputs(k - 2, gv, ov, yt);
  };
  if (K > 0) load_inputs(K - 1, gA, oA, yA);
  if (K > 1) load_inputs(K - 2, gB, oB, yB);
  for (int s = 0; s < K; s += 2) {
    step(s, gA, oA, yA);
    if (s + 1 < K) step(s + 1, gB, oB, yB);
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if ((int)threadIdx.x + q * THREADS < npix) {
      msum_out[px[q].plane] = msum[q];
      if (K == 0) m0_out[px[q].plane] = 0.0f;  // m_K
    }
  }
}

// The launch's shape for an (H, W) face on the current device: blocks, rows
// a block, threads a block and pixels a thread; false if the face does not
// fit (more than MAX_UNITS pixels a thread of 1024).
struct Plan {
  int blocks, R, threads, units;
};

bool make_plan(int H, int W, Plan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      H <= 0 || W <= 0) {
    return false;
  }
  const int blocks = H < sms ? H : sms;
  p->R = (H + blocks - 1) / blocks;
  p->blocks = (H + p->R - 1) / p->R;
  const long long pixels = (long long)p->R * W;
  p->threads = pixels <= 256 ? 256 : pixels <= 512 ? 512 : 1024;
  const long long units = (pixels + p->threads - 1) / p->threads;
  p->units = units <= 1 ? 1 : units <= 2 ? 2 : units <= 4 ? 4 : 8;
  return units <= MAX_UNITS;
}

template <int P, int THREADS>
int launch(const Plan& plan, void** args, cudaStream_t stream) {
  return (int)cudaLaunchCooperativeKernel(
      (const void*)light_scan_bwd_kernel<P, THREADS>, dim3(plan.blocks),
      dim3(THREADS), args, 0, stream);
}

}  // namespace

// The blocks (and so the counters) K7 takes for an (H, W) face on the
// current device; 0 if the face is too large for one launch.
TBR_API int tbr_light_scan_bwd_blocks(int H, int W) {
  Plan p;
  return make_plan(H, W, &p) ? p.blocks : 0;
}

// One launch per face. (ix, fx, iy, fy) split the forward offset, (jx, hx,
// jy, hy) its negation. Writes d_op (K, H, W), msum and m0 (H, W); mbuf is
// (2, H, W) scratch; `flags` holds at least tbr_light_scan_bwd_blocks(H, W)
// counters, none above `base`, and the launch leaves them at most
// base + K - 1 (the caller's next base is base + K).
TBR_API int tbr_light_scan_bwd(const float* g, const float* op,
                               const float* y, float* d_op, float* msum,
                               float* m0, float* mbuf,
                               unsigned long long* flags,
                               unsigned long long base, int K, int H, int W,
                               int ix, float fx, int iy, float fy, int jx,
                               float hx, int jy, float hy, const float* alpha,
                               void* stream) {
  Plan plan;
  if (!make_plan(H, W, &plan)) return (int)cudaErrorInvalidValue;
  int R = plan.R;
  void* args[] = {&g,  &op, &y,  &d_op, &msum, &m0, &mbuf, &flags,
                  &base, &K, &H, &W, &R,   &ix,  &fx,  &iy,   &fy,
                  &jx, &hx, &jy, &hy, &alpha};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (plan.units == 1 && plan.threads == 256) {
    err = launch<1, 256>(plan, args, s);
  } else if (plan.units == 1 && plan.threads == 512) {
    err = launch<1, 512>(plan, args, s);
  } else if (plan.units == 1) {
    err = launch<1, 1024>(plan, args, s);
  } else if (plan.units == 2) {
    err = launch<2, 1024>(plan, args, s);
  } else if (plan.units == 4) {
    err = launch<4, 1024>(plan, args, s);
  } else {
    err = launch<8, 1024>(plan, args, s);
  }
  return err ? err : (int)cudaGetLastError();
}
