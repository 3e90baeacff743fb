// Shared pieces of the fused HuMoR rollout kernels (rollout_fwd.cu,
// rollout_bwd.cu): the layout constants, the weights struct and the 3x3
// rotation and tail helpers. The persistent launch machinery both kernels
// run on is in rollout_persistent.cuh. The math mirrors the plain PyTorch
// version in humor_torch/ops/rollout_kernel.py; see its module docstring
// for the layout.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace humor {

constexpr int D_X = 339;     // network input = state vector
constexpr int CW = 351;      // carry: x | g_rot 9 | g_trans 3
constexpr int OUT_W = 444;   // world x | contacts 9 | pm 48 | pv 48
constexpr int LAT = 48;      // latent size
constexpr int HID = 1024;
constexpr int RAW = 216;     // decoder head
constexpr int PHEAD = 96;    // prior head
constexpr int GROUPS = 16;
constexpr float GN_EPS = 1e-5f;

}  // namespace humor

extern "C" {
// Per layer: w (in, out) row-major, bias, and the GroupNorm affine applied
// to the layer's INPUT (null for layer 0).
struct RolloutWeights {
  const float* pw[5];
  const float* pb[5];
  const float* pgs[5];
  const float* pgb[5];
  const float* dw[4];
  const float* db[4];
  const float* dgs[4];
  const float* dgb[4];
};

const char* humor_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
}

namespace humor {

// ---------------------------------------------------------------------------
// 3x3 rotation helpers (row-major 9-vectors)
// ---------------------------------------------------------------------------

__device__ inline void rodrigues(const float* aa, float* R) {
  const float x = aa[0] + 1e-8f, y = aa[1] + 1e-8f, z = aa[2] + 1e-8f;
  const float angle = sqrtf(fmaxf(x * x + y * y + z * z, 1e-16f));
  const float ux = x / angle, uy = y / angle, uz = z / angle;
  const float c = cosf(angle), s = sinf(angle), C = 1.f - c;
  R[0] = c + ux * ux * C; R[1] = ux * uy * C - uz * s; R[2] = ux * uz * C + uy * s;
  R[3] = uy * ux * C + uz * s; R[4] = c + uy * uy * C; R[5] = uy * uz * C - ux * s;
  R[6] = uz * ux * C - uy * s; R[7] = uz * uy * C + ux * s; R[8] = c + uz * uz * C;
}

// d max(x, lo)/dx as JAX differentiates it (0.5 at a tie)
__device__ inline float clamp_grad(float x, float lo) {
  return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}

// C = A B
__device__ inline void mm(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
// C = A^T B
__device__ inline void mtm(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}
// C = A B^T
__device__ inline void mmt(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}
// o = A v
__device__ inline void mv(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}
// o = A^T v
__device__ inline void mtv(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[i] * v[0] + A[3 + i] * v[1] + A[6 + i] * v[2];
}

// compute_world2aligned_mat: body right = -column 0, closed-form Rz
__device__ inline void heading(const float* r, float* W) {
  const float bx = -r[0], by = -r[3];
  const float h = sqrtf(fmaxf(bx * bx + by * by, 1e-12f));
  const bool deg = h < 1e-6f;
  const float c = deg ? 1.f : bx / (h + 1e-6f);
  const float s = deg ? 0.f : by / (h + 1e-6f);
  W[0] = c; W[1] = s; W[2] = 0.f;
  W[3] = -s; W[4] = c; W[5] = 0.f;
  W[6] = 0.f; W[7] = 0.f; W[8] = 1.f;
}

// Per-row quantities of one step's tail that every lane needs.
struct TailGlobals {
  float g[9], gt[3], t2j[3];
  float root[9], Rdr[9];
  float n_trans[3], n_tv[3], n_rv[3], n_root[9], W[9], f[3];
};

__device__ inline void tail_globals(const float* c, const float* t2j,
                                    const float* d, TailGlobals& q) {
#pragma unroll
  for (int i = 0; i < 9; ++i) { q.g[i] = c[339 + i]; q.root[i] = c[6 + i]; }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q.gt[i] = c[348 + i];
    q.t2j[i] = t2j[i];
    q.n_trans[i] = c[i] + d[i];
    q.n_tv[i] = c[3 + i] + d[3 + i];
    q.n_rv[i] = c[15 + i] + d[9 + i];
  }
  rodrigues(d + 6, q.Rdr);
  mm(q.Rdr, q.root, q.n_root);
  heading(q.n_root, q.W);
  q.f[0] = -q.n_trans[0]; q.f[1] = -q.n_trans[1]; q.f[2] = 0.f;
}

}  // namespace humor
