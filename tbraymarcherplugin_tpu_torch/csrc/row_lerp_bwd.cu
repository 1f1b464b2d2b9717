// K6: adjoint of the per-row lerp gather (K2), d rows from d out.
//
// Replaces the TPU kernel tbraymarcherplugin_tpu/ops/pallas_warp.py::
// _band_adjoint_kernel (entry point _banded_row_lerp_adjoint). With
// ic = clip(idx[r % Rq, q], 0, N - 1), i0 = floor(ic), fr = ic - i0 and
// i1 = min(i0 + 1, N - 1):
//   d_rows[r, i0] += g[r, q] * (1 - fr),   d_rows[r, i1] += g[r, q] * fr.
// The index takes no gradient. The TPU kernel clipped its taps into a
// 384-texel band per tile; this kernel keeps no band, so it is exact at any
// index spread (the two agree wherever the spread fits the band).
//
// Bound on the H100: device memory (reads g and idx once, writes d_rows
// once: about 75 MB per warp pass at 1080p, 0.047 ms for both). What held
// the first design back was instructions: every chunk of 32 q took two
// rounds of __match_any_sync and serialized shared-memory adds. What holds
// this one is the latency of a chunk's chain of warp collectives and adds,
// so the warps in flight count. Design:
// - one warp per row keeps the row's N accumulators in shared memory; a
//   block holds as many warps as 48 KB of accumulators allow, 1 to 8 (at
//   the warp passes' N = 1280, 8 warps and 40 KB a block: shared memory
//   lets an SM hold 5 blocks, 40 warps);
// - it walks q in chunks of 32, the loads of the next DEPTH chunks in
//   flight (coalesced g and idx);
// - one warp vote tests whether the chunk's i0 is monotone in lane order,
//   rising or falling (a warp map's row keeps the sign of its denominator:
//   both warp passes rise, a mirrored view falls). Then lanes with equal
//   taps are contiguous runs: a segmented scan by shuffles (as many steps
//   as the longest run needs) gives each run's sum, and the run's last lane
//   adds it once, i0's sums, then i1's (distinct addresses in each phase);
// - other chunks keep the ordered rounds (common.cuh,
//   tbr_warp_ordered_add): lanes on one texel add in lane order;
// - chunks add in q order; the finished row is written once, coalesced
//   (as float4s where N is a multiple of 4).
// No atomics: the same bits on every run. The sums run in another order
// than the plain version's (scatter_add), within float32 ulps of it.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 4;       // chunks of 32 q whose loads are in flight
constexpr int MAX_WARPS = 8;   // warps (rows) a block
constexpr size_t BLOCK_ACC = 48 * 1024;  // accumulator bytes a block

__global__ void row_lerp_bwd_kernel(const float* __restrict__ g,
                                    const float* __restrict__ idx,
                                    float* __restrict__ d_rows, int R, int Rq,
                                    int N, int Q) {
  extern __shared__ __align__(16) float acc_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // a whole warp: no collective is left waiting
  float* acc = acc_all + warp * N;
  const bool wide = (N & 3) == 0;  // rows of whole float4s
  if (wide) {
    for (int t = lane; t < N / 4; t += 32) {
      reinterpret_cast<float4*>(acc)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int t = lane; t < N; t += 32) acc[t] = 0.0f;
  }
  __syncwarp();
  const float* irow = idx + (size_t)(r % Rq) * Q;
  const float* grow = g + (size_t)r * Q;
  const float nmax = (float)(N - 1);
  const int nchunks = (Q + 31) / 32;

  float xs[DEPTH], gs[DEPTH];
  auto load = [&](int c, float& x, float& gv) {
    const int q = c * 32 + lane;
    if (c < nchunks && q < Q) {
      x = __ldg(irow + q);
      gv = __ldg(grow + q);
    }
  };
  auto chunk = [&](int c, float x, float gv) {
    const int q = c * 32 + lane;
    const bool act = q < Q;  // the active lanes are a prefix
    int i0 = 0;
    float wa = 0.0f, wb = 0.0f;
    if (act) {
      const float ic = fminf(fmaxf(x, 0.0f), nmax);
      const float i0f = floorf(ic);
      const float fr = __fsub_rn(ic, i0f);
      i0 = (int)i0f;
      wa = __fmul_rn(gv, __fsub_rn(1.0f, fr));
      wb = __fmul_rn(gv, fr);
    }
    const int i1 = min(i0 + 1, N - 1);
    const int prev = __shfl_up_sync(FULL, i0, 1);
    const bool follows = act && lane > 0;  // lane - 1 is active too
    const unsigned order =
        follows ? (unsigned)(i0 >= prev) | (unsigned)(i0 <= prev) << 1 : 3u;
    if (__reduce_and_sync(FULL, order) == 0u) {  // neither rising nor falling
      tbr_warp_ordered_add<1>(acc, 0, i0, &wa, act);
      tbr_warp_ordered_add<1>(acc, 0, i1, &wb, act);
      return;
    }
    // runs of equal i0 (and so of equal i1) are contiguous
    const int nact = min(Q - c * 32, 32);
    const unsigned amask = nact == 32 ? FULL : (1u << nact) - 1u;
    const unsigned heads =
        __ballot_sync(FULL, act && (lane == 0 || i0 != prev));
    const int start = 31 - __clz(heads & ((2u << lane) - 1u));
    const bool tail = act && (lane == 31 || ((heads >> (lane + 1)) & 1u) ||
                              !((amask >> (lane + 1)) & 1u));
    const int longest =
        (int)__reduce_max_sync(FULL, tail ? (unsigned)(lane - start + 1) : 0u);
    for (int d = 1; d < longest; d <<= 1) {  // segmented inclusive scan
      const float a = __shfl_up_sync(FULL, wa, d);
      const float b = __shfl_up_sync(FULL, wb, d);
      if (lane - d >= start) {
        wa = __fadd_rn(a, wa);
        wb = __fadd_rn(b, wb);
      }
    }
    // each run's last lane adds its i0 sum, then its i1 sum; i1 = i0 + 1 is
    // distinct per run, except that the run of i0 = N - 1 (whose fr is 0)
    // shares i1 = N - 1 with the run of N - 2: it adds its i1 sum with its
    // i0 sum
    const bool edge = i0 == N - 1;
    if (tail) {
      float s = __fadd_rn(acc[i0], wa);
      if (edge) s = __fadd_rn(s, wb);
      acc[i0] = s;
    }
    __syncwarp();
    if (tail && !edge) acc[i1] = __fadd_rn(acc[i1], wb);
    __syncwarp();
  };

#pragma unroll
  for (int s = 0; s < DEPTH; ++s) load(s, xs[s], gs[s]);
  for (int c0 = 0; c0 < nchunks; c0 += DEPTH) {
#pragma unroll
    for (int s = 0; s < DEPTH; ++s) {
      if (c0 + s < nchunks) {  // warp-uniform
        chunk(c0 + s, xs[s], gs[s]);
        load(c0 + s + DEPTH, xs[s], gs[s]);
      }
    }
  }
  __syncwarp();
  float* out = d_rows + (size_t)r * N;
  if (wide) {
    for (int t = lane; t < N / 4; t += 32) {
      reinterpret_cast<float4*>(out)[t] =
          reinterpret_cast<const float4*>(acc)[t];
    }
  } else {
    for (int t = lane; t < N; t += 32) out[t] = acc[t];
  }
}

}  // namespace

// The caller checks that 4 * N floats fit one block's shared memory.
TBR_API int tbr_row_lerp_bwd(const float* g, const float* idx, float* d_rows,
                             int R, int Rq, int N, int Q, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaGetLastError();
  if (Rq <= 0 || R % Rq != 0) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)N * sizeof(float);
  int warps = (int)(BLOCK_ACC / row);  // one at the largest N
  warps = warps < 1 ? 1 : warps > MAX_WARPS ? MAX_WARPS : warps;
  const size_t smem = warps * row;
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        row_lerp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  const int blocks = (R + warps - 1) / warps;
  row_lerp_bwd_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      g, idx, d_rows, R, Rq, N, Q);
  return (int)cudaGetLastError();
}
