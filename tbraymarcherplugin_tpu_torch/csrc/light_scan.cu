// K4: illumination propagation scan of one cube face.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_lighting.py::
// _scan_kernel (entry point propagate_face_scan_pallas). It computes
//   c_k = shift2d_border(c_{k-1}, (off_x, off_y), border = alpha) * (1 - o_k)
// with c_{-1} = alpha everywhere, and writes every c_k. A tap whose true
// index lies outside [0, n) reads alpha. alpha (intensity times face weight)
// is read from device memory, so it can be a tensor that takes a gradient
// without a host sync.
//
// Bound on the H100: the dependency from slice to slice. Each slice is a
// 256 x 256 stencil (about 1 us of memory traffic), and no slice can start
// before the previous one is complete, so synchronisation, not bandwidth,
// sets the time. The TPU kept the 256 KB carry in VMEM; one block's shared
// memory (227 KB) cannot hold it, and the lateral offset (up to about 10 px
// on the secondary face) couples every tile to its neighbours. Design: the
// output slice k-1, just written and resident in L2, is the carry that slice
// k reads, so no extra buffer exists; one launch per slice orders the
// slices on the stream, issued by a host loop inside this C entry point
// (K launches per scan). A single cooperative or cluster launch that syncs
// in place of the launch boundary is the next step.

#include "common.cuh"

__global__ void light_scan_step(const float* __restrict__ prev,
                                const float* __restrict__ op,
                                float* __restrict__ out, int H, int W, int ix,
                                float fx, int iy, float fy,
                                const float* __restrict__ alpha_p) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float alpha = *alpha_p;
  float shifted = tbr_shift2d(prev, alpha, alpha, i, j, H, W, ix, fx, iy, fy);
  size_t p = (size_t)i * W + j;
  out[p] = __fmul_rn(shifted, __fsub_rn(1.0f, op[p]));
}

TBR_API int tbr_light_scan(const float* op, float* out, int K, int H, int W,
                           int ix, float fx, int iy, float fy,
                           const float* alpha, void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  const size_t hw = (size_t)H * W;
  for (int k = 0; k < K; ++k) {
    const float* prev = k ? out + (k - 1) * hw : nullptr;
    light_scan_step<<<grid, block, 0, (cudaStream_t)stream>>>(
        prev, op + k * hw, out + k * hw, H, W, ix, fx, iy, fy, alpha);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
