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
// Bound on the H100: the slice-to-slice dependency, as in K4. Design: the
// same one launch per slice from a host loop in C; the carry m ping-pongs
// between two (H, W) buffers that stay in L2, the running sum is updated in
// place, and the forward outputs y are re-read instead of recomputed.

#include "common.cuh"

__global__ void light_scan_bwd_step(
    const float* __restrict__ g, const float* __restrict__ op,
    const float* __restrict__ y_prev, const float* __restrict__ m_next,
    float* __restrict__ m_out, float* __restrict__ msum,
    float* __restrict__ d_op, int H, int W, int ix, float fx, int iy,
    float fy, int jx, float hx, int jy, float hy,
    const float* __restrict__ alpha_p) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float alpha = *alpha_p;
  const size_t p = (size_t)i * W + j;
  const float lam = __fadd_rn(
      g[p], tbr_shift2d(m_next, 0.0f, 0.0f, i, j, H, W, jx, hx, jy, hy));
  const float m = __fmul_rn(__fsub_rn(1.0f, op[p]), lam);
  const float pre =
      tbr_shift2d(y_prev, alpha, alpha, i, j, H, W, ix, fx, iy, fy);
  d_op[p] = __fmul_rn(-pre, lam);
  m_out[p] = m;
  msum[p] = __fadd_rn(msum[p], m);
}

// msum must hold zeros; mbuf is (2, H, W) scratch, and m_0 ends in its
// first half. (ix, fx, iy, fy) split the forward offset, (jx, hx, jy, hy)
// its negation.
TBR_API int tbr_light_scan_bwd(const float* g, const float* op,
                               const float* y, float* d_op, float* msum,
                               float* mbuf, int K, int H, int W, int ix,
                               float fx, int iy, float fy, int jx, float hx,
                               int jy, float hy, const float* alpha,
                               void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  const size_t hw = (size_t)H * W;
  for (int k = K - 1; k >= 0; --k) {
    const float* y_prev = k ? y + (k - 1) * hw : nullptr;
    const float* m_next = k == K - 1 ? nullptr : mbuf + ((k + 1) & 1) * hw;
    light_scan_bwd_step<<<grid, block, 0, (cudaStream_t)stream>>>(
        g + k * hw, op + k * hw, y_prev, m_next, mbuf + (k & 1) * hw, msum,
        d_op + k * hw, H, W, ix, fx, iy, fy, jx, hx, jy, hy, alpha);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
