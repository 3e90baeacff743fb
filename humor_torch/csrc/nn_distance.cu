// One-way nearest neighbour (humor_torch/ops/chamfer.py): for each point of
// xyz1 (B, N, 3), the squared distance to and the index of its closest
// point in xyz2 (B, M, 3). Replaces the Pallas kernel `_nn_pallas` of
// humor_tpu/ops/chamfer.py (:90-165).
//
// What bounds it on the H100: operations. Every (query, point) pair costs
// the 6 FLOP the cost model counts (3 products, 3 sums) plus a compare and
// a select, so at the PROX fit's shape (960 clouds x 4096 x 6890) it is
// ~1.6e11 FLOP against ~0.16 GB of inputs: far above the card's
// operations-per-byte line. The distance matrix is never stored.
//
// Design (simple and exact first):
//   * one thread per query point, BLOCK queries of one cloud per block;
//     grid (ceil(N / BLOCK), B);
//   * xyz2 is walked in TILE-point tiles staged in shared memory as float4
//     (x, y, z, |y|^2), so each pair costs one broadcast shared load;
//   * d = (|x|^2 + |y|^2) - 2 (x . y) in plain f32 (no tensor cores, no
//     TF32: truncation flips argmins near ties), the expression of the
//     plain version and of the JAX package;
//   * a running min/argmin with a strict `<`, walked in index order, so a
//     tie goes to the lowest index (as argmin does); the result is
//     clamped at 0;
//   * the tails of N and M are bounds-checked: no padding of xyz2.
// Later work: several queries per thread in registers, a cp.async/TMA
// double buffer for the tiles, one tile shared by the candidate clouds
// that share a query cloud.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 1024;  // 16 KB of float4

__global__ void __launch_bounds__(BLOCK)
nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
          float* __restrict__ dist, int* __restrict__ idx, int N, int M) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = n < N;
  const float* y = xyz2 + (size_t)b * M * 3;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (valid) {
    const float* x = xyz1 + ((size_t)b * N + n) * 3;
    x0 = x[0];
    x1 = x[1];
    x2 = x[2];
  }
  const float sqx = x0 * x0 + x1 * x1 + x2 * x2;
  float best = INFINITY;
  int best_i = 0;
  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int cnt = min(TILE, M - m0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += BLOCK) {
      const float* p = y + (size_t)(m0 + j) * 3;
      const float a = p[0], c = p[1], e = p[2];
      tile[j] = make_float4(a, c, e, a * a + c * c + e * e);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      const float d = (sqx + p.w) - 2.f * (x0 * p.x + x1 * p.y + x2 * p.z);
      if (d < best) {
        best = d;
        best_i = m0 + j;
      }
    }
  }
  if (valid) {
    dist[(size_t)b * N + n] = fmaxf(best, 0.f);
    idx[(size_t)b * N + n] = best_i;
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
  dim3 grid((N + BLOCK - 1) / BLOCK, B);
  nn_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, dist, idx, N, M);
  return cudaGetLastError();
}

}  // extern "C"
