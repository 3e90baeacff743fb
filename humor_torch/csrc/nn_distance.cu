// One-way nearest neighbour (humor_torch/ops/chamfer.py): for each point of
// xyz1 (B, N, 3), the squared distance to and the index of its closest
// point in xyz2 (B, M, 3). Replaces the Pallas kernel `_nn_pallas` of
// humor_tpu/ops/chamfer.py (:90-165).
//
// What bounds it on the H100: instruction dispatch. The operation bound counts
// 6 FLOP a (query, point) pair, i.e. 3 FFMA dispatch slots; at the PROX fit's
// shape (960 clouds x 4096 x 6890, 2.7e10 pairs) that is ~2.4 ms, against
// ~0.16 GB of inputs (~0.05 ms). The distance matrix is never stored. So
// the design spends as few dispatched instructions a pair above those 3 as it
// can:
//   * the query's norm is folded out of the loop: each point of xyz2 is
//     staged as the float4 (-2y.x, -2y.y, -2y.z, |y|^2) (scaling by -2 is
//     exact), so a pair is d' = fma(x0, a, fma(x1, b, fma(x2, c, w))),
//     3 FFMA; |x|^2 is added once a query at the end and the result
//     clamped at 0. Adding a constant and rounding is monotone, so the
//     min over d' gives the min over |x|^2 + d';
//   * Q queries a thread in registers, so one broadcast LDS.128 of a point
//     serves Q pairs;
//   * a min-only inner loop: over a chunk of C points each query keeps
//     only fminf(d') (1 FMNMX a pair). After a chunk, a query whose chunk
//     minimum is strictly below its best records the chunk. When the tile
//     is done, each query whose best chunk lies in it rescans that one
//     chunk with the same __fmaf_rn expression (bit-identical) for the
//     first j whose d' equals its best. The strict < across chunks and the
//     first match inside one give exactly the running strict-< scan: a tie
//     goes to the lowest index, as argmin does. Rescanning once at the end
//     of a tile, not after every improving chunk, keeps the warps
//     convergent: a query improves ~ln(chunks) times, but some lane of a
//     warp of 32 queries improves in many of the chunks when the points
//     come in no spatial order, and each such rescan holds the whole warp;
//   * the mesh is staged once a block, in tiles of up to TILE float4s in
//     dynamic shared memory: 3,456 points (55.3 KB), so the 6,890-vertex
//     SMPL mesh takes two tiles and four blocks of 128 threads share an
//     SM. Small blocks matter more than a whole-mesh tile: a block's warps
//     end unevenly and hold its slot until the last one ends. On an H100
//     (PERF.md) this choice beat a whole-mesh tile of 6,912 points at 128
//     and 256 threads, and other tiles, block sizes and Q = 8. The staged tile is padded to a multiple of C with
//     (0, 0, 0, +inf), whose d' is +inf and never wins; xyz2 itself is not
//     padded. Staging is under 1% of a block's dispatched instructions at the
//     fit's shape, so it is not double buffered.
// Count: 3 FFMA + 1 FMNMX + 1/Q LDS.128 a pair, plus ~3/C a pair for the
// chunk bookkeeping: 4.38 dispatched instructions a pair in the SASS of the
// chunk loop at Q = 4, C = 32.
//
// No tensor cores: the contract is exact f32. Reduced-precision products
// flip argmins near ties (the TPU's bf16 truncation, chamfer.py:121-122;
// TF32 keeps ~3 digits), and a 3xTF32 emulation rounds differently from the
// plain version, whose f32 CUDA-core bound is the one this kernel is held
// to.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// The design's sizes. chip_smoke.nn_design() reads them from this file:
// its edge sizes (M = 1, C - 1, C, C + 1, TILE +- 1, ..., N no multiple of
// BLOCK * Q) and the CPU test of this arithmetic follow them.
constexpr int Q = 4;           // queries a thread
constexpr int BLOCK = 128;     // threads a block
constexpr int C = 32;          // points a chunk
constexpr int TILE = 3456;     // float4s a staged tile (55,296 bytes)
constexpr int MIN_BLOCKS = 4;  // blocks an SM (what the shared memory allows)
static_assert(TILE % C == 0, "a tile holds whole chunks");

__device__ __forceinline__ float dprime(float x0, float x1, float x2,
                                        float4 p) {
  return __fmaf_rn(x0, p.x, __fmaf_rn(x1, p.y, __fmaf_rn(x2, p.z, p.w)));
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
          float* __restrict__ dist, int* __restrict__ idx, int N, int M) {
  extern __shared__ float4 tile[];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * (BLOCK * Q) + threadIdx.x;
  const float* y = xyz2 + (size_t)b * M * 3;
  float x0[Q], x1[Q], x2[Q], best[Q];
  int best_chunk[Q], best_i[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = n0 + q * BLOCK;
    x0[q] = x1[q] = x2[q] = 0.f;
    if (n < N) {
      const float* x = xyz1 + ((size_t)b * N + n) * 3;
      x0[q] = x[0];
      x1[q] = x[1];
      x2[q] = x[2];
    }
    best[q] = INFINITY;
    best_chunk[q] = -1;   // no chunk improved on +inf (non-finite input)
    best_i[q] = 0;
  }
  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int cnt = min(TILE, M - m0);
    const int cnt_pad = (cnt + C - 1) / C * C;
    __syncthreads();
    for (int j = threadIdx.x; j < cnt_pad; j += BLOCK) {
      float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (j < cnt) {
        const float* p = y + (size_t)(m0 + j) * 3;
        const float a = p[0], c = p[1], e = p[2];
        v = make_float4(-2.f * a, -2.f * c, -2.f * e,
                        __fmaf_rn(a, a, __fmaf_rn(c, c, __fmul_rn(e, e))));
      }
      tile[j] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < cnt_pad; c0 += C) {
      float cm[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) cm[q] = INFINITY;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 p = tile[c0 + j];
#pragma unroll
        for (int q = 0; q < Q; ++q)
          cm[q] = fminf(cm[q], dprime(x0[q], x1[q], x2[q], p));
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (cm[q] < best[q]) {
          best[q] = cm[q];
          best_chunk[q] = m0 + c0;
        }
      }
    }
    // first index of the best inside its chunk, while the tile is staged
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (best_chunk[q] >= m0) {
        const int base = best_chunk[q] - m0;
        int first = 0;
#pragma unroll 4
        for (int j = C - 1; j >= 0; --j)
          if (dprime(x0[q], x1[q], x2[q], tile[base + j]) == best[q])
            first = j;
        best_i[q] = best_chunk[q] + first;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = n0 + q * BLOCK;
    if (n < N) {
      const float sqx = __fmaf_rn(x0[q], x0[q],
                                  __fmaf_rn(x1[q], x1[q],
                                            __fmul_rn(x2[q], x2[q])));
      dist[(size_t)b * N + n] = fmaxf(__fadd_rn(sqx, best[q]), 0.f);
      idx[(size_t)b * N + n] = best_i[q];
    }
  }
}

}  // namespace

extern "C" {

const char* humor_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xyz1 (B, N, 3), xyz2 (B, M, 3) float32, contiguous, on the device ->
// dist (B, N) float32, idx (B, N) int32. Enqueues on `stream`, does not
// synchronise; returns the launch error (0 = none).
int nn_distance(const float* xyz1, const float* xyz2, float* dist, int* idx,
                int B, int N, int M, void* stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  if (M <= 0 || B > 65535) return cudaErrorInvalidValue;
  // The limit is the function's, shared by every launch: set it to the
  // largest tile, so that a concurrent launch never finds it lowered.
  cudaError_t err = cudaFuncSetAttribute(
      nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float4) * TILE));
  if (err != cudaSuccess) return err;
  const int whole = (M + C - 1) / C * C;
  const size_t smem = sizeof(float4) * (whole < TILE ? whole : TILE);
  dim3 grid((N + BLOCK * Q - 1) / (BLOCK * Q), B);
  nn_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, dist, idx, N, M);
  return cudaGetLastError();
}

}  // extern "C"
