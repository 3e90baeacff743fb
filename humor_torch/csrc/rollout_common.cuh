// Shared pieces of the fused HuMoR rollout kernels (rollout_fwd.cu,
// rollout_bwd.cu): the layout constants, the weights struct and the 3x3
// rotation and tail helpers; the forward's split-K product with its
// epilogues (bias, GroupNorm(16)+ReLU) and per-step MLP forward. The math
// mirrors the plain PyTorch version in humor_torch/ops/rollout_kernel.py;
// see its module docstring for the layout and the design.
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

// split-K product tiling
constexpr int MM_COLS = 64;    // output columns per block
constexpr int MM_ROWS = 16;    // output rows per block
constexpr int MM_KS = 128;     // K depth of one slice (one block)
constexpr int MM_THREADS = 256;
constexpr int MAX_N = 1072;    // widest product output (1024 + 48)
constexpr int MAX_S = (MAX_N + MM_KS - 1) / MM_KS;

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

#define HUMOR_CHECK_LAUNCH()                      \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return e_;             \
  } while (0)

// ---------------------------------------------------------------------------
// Scratch layout (floats) of the forward
// ---------------------------------------------------------------------------

struct Scratch {
  float* part;      // MAX_S x M x MAX_N split-K partial sums
  float* hp[4];     // prior pre-GroupNorm activations (M x 1024)
  float* ap[4];     // prior post-ReLU activations
  float* phead;     // M x 96
  float* hd[3];     // decoder pre-GroupNorm (M x 1024, last uses 512)
  float* ad[3];
  float* draw;      // M x 216
  float* last;      // M x CW: carry after the last step
};

inline long long scratch_floats(int M) {
  long long m = M;
  return (long long)MAX_S * m * MAX_N + 8 * m * HID + m * PHEAD +
         6 * m * HID + m * RAW + m * CW;
}

inline Scratch carve(float* base, int M) {
  Scratch s;
  size_t m = M;
  float* p = base;
  s.part = p; p += (size_t)MAX_S * m * MAX_N;
  for (int i = 0; i < 4; ++i) { s.hp[i] = p; p += m * HID; }
  for (int i = 0; i < 4; ++i) { s.ap[i] = p; p += m * HID; }
  s.phead = p; p += m * PHEAD;
  for (int i = 0; i < 3; ++i) { s.hd[i] = p; p += m * HID; }
  for (int i = 0; i < 3; ++i) { s.ad[i] = p; p += m * HID; }
  s.draw = p; p += m * RAW;
  s.last = p;
  return s;
}

// ---------------------------------------------------------------------------
// Split-K product: part[s][row][col] = sum over slice s of [a1 | a2] @ w
// ---------------------------------------------------------------------------

struct MatArgs {
  const float* a1; int lda1; int k1;   // input columns [0, k1)
  const float* a2; int lda2; int k2;   // input columns [k1, k1 + k2)
  const float* w; int ldw;             // (k1 + k2) x n, row stride ldw
  int m, n;
  float* part;                         // S x m x n
};

// grid (ceil(n / 64), ceil(m / 16), S); 256 threads = 64 columns x 4 row
// lanes, 4 rows each. The slice's A (16 x 128) and W (128 x 64) tiles are
// staged in shared memory with coalesced loads, all of a thread's loads
// issued before any is stored (a load-store loop would wait out the L2
// latency once per element); then every thread runs 128 x 4 FMAs from
// shared memory (A reads are warp broadcasts).
constexpr int MM_A_PER_THREAD = MM_ROWS * MM_KS / MM_THREADS;   // 8
constexpr int MM_W_PER_THREAD = MM_KS * MM_COLS / MM_THREADS;   // 32

__global__ void __launch_bounds__(MM_THREADS) matmul_splitk(MatArgs p) {
  __shared__ float as[MM_ROWS][MM_KS + 1];
  __shared__ float ws[MM_KS][MM_COLS];
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * MM_COLS;
  const int row0 = blockIdx.y * MM_ROWS;
  const int k0 = blockIdx.z * MM_KS;
  const int ktot = p.k1 + p.k2;

  float av[MM_A_PER_THREAD], wv[MM_W_PER_THREAD];
#pragma unroll
  for (int j = 0; j < MM_A_PER_THREAD; ++j) {
    const int i = tid + j * MM_THREADS;
    const int gr = row0 + i / MM_KS, gk = k0 + i % MM_KS;
    float v = 0.f;
    if (gr < p.m && gk < ktot)
      v = gk < p.k1 ? p.a1[(size_t)gr * p.lda1 + gk]
                    : p.a2[(size_t)gr * p.lda2 + (gk - p.k1)];
    av[j] = v;
  }
#pragma unroll
  for (int j = 0; j < MM_W_PER_THREAD; ++j) {
    const int i = tid + j * MM_THREADS;
    const int gk = k0 + i / MM_COLS, gc = col0 + i % MM_COLS;
    wv[j] = (gk < ktot && gc < p.n) ? p.w[(size_t)gk * p.ldw + gc] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < MM_A_PER_THREAD; ++j) {
    const int i = tid + j * MM_THREADS;
    as[i / MM_KS][i % MM_KS] = av[j];
  }
#pragma unroll
  for (int j = 0; j < MM_W_PER_THREAD; ++j) {
    const int i = tid + j * MM_THREADS;
    ws[i / MM_COLS][i % MM_COLS] = wv[j];
  }
  __syncthreads();

  const int cl = tid % MM_COLS, rl = tid / MM_COLS;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int kk = 0; kk < MM_KS; ++kk) {
    const float wk = ws[kk][cl];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(as[rl + 4 * j][kk], wk, acc[j]);
  }
  const int col = col0 + cl;
  if (col >= p.n) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = row0 + rl + 4 * j;
    if (row < p.m)
      p.part[((size_t)blockIdx.z * p.m + row) * p.n + col] = acc[j];
  }
}

inline int num_slices(int k) { return (k + MM_KS - 1) / MM_KS; }

inline cudaError_t matmul(const float* a1, int lda1, int k1, const float* a2,
                          int lda2, int k2, const float* w, int ldw, int m,
                          int n, float* part, cudaStream_t st) {
  MatArgs p{a1, lda1, k1, a2, lda2, k2, w, ldw, m, n, part};
  dim3 grid((n + MM_COLS - 1) / MM_COLS, (m + MM_ROWS - 1) / MM_ROWS,
            num_slices(k1 + k2));
  matmul_splitk<<<grid, MM_THREADS, 0, st>>>(p);
  HUMOR_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

// Sum of a 64-thread block (two warps); every thread gets the total.
__device__ inline float block64_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return red[0] + red[1];
}

// c[row, col] (+)= bias[col0 + col] + sum_s part[s][row][col0 + col] for
// col < ncols. grid (ceil(ncols / 128), m), 128 threads.
__global__ void sum_epilogue(const float* part, int S, int m, int ldp,
                             int col0, int ncols, const float* bias, float* c,
                             int ldc, int accumulate) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= ncols) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[((size_t)s * m + row) * ldp + col0 + col];
  if (bias) v += bias[col0 + col];
  float* dst = c + (size_t)row * ldc + col;
  *dst = accumulate ? *dst + v : v;
}

inline cudaError_t sum_epi(const float* part, int S, int m, int ldp, int col0,
                           int ncols, const float* bias, float* c, int ldc,
                           int accumulate, cudaStream_t st) {
  dim3 grid((ncols + 127) / 128, m);
  sum_epilogue<<<grid, 128, 0, st>>>(part, S, m, ldp, col0, ncols, bias, c,
                                     ldc, accumulate);
  HUMOR_CHECK_LAUNCH();
  return cudaSuccess;
}

// h = bias + sum_s part (M x n, dense), act = relu(GroupNorm(h) * gs + gb).
// grid (16 groups, m rows), 64 threads (group size n / 16 <= 64).
__global__ void gn_relu_epilogue(const float* part, int S, int m,
                                 const float* bias, const float* gs,
                                 const float* gb, int n, float* h,
                                 float* act) {
  __shared__ float red[2];
  const int gsz = n / GROUPS;
  const int row = blockIdx.y;
  const int col = blockIdx.x * gsz + threadIdx.x;
  const bool on = threadIdx.x < gsz;
  float v = 0.f;
  if (on) {
    v = bias[col];
    for (int s = 0; s < S; ++s) v += part[((size_t)s * m + row) * n + col];
    h[(size_t)row * n + col] = v;
  }
  const float mean = block64_sum(on ? v : 0.f, red) / gsz;
  const float cent = v - mean;
  const float var = block64_sum(on ? cent * cent : 0.f, red) / gsz;
  const float rstd = 1.f / sqrtf(var + GN_EPS);
  if (on) {
    const float y = cent * rstd * gs[col] + gb[col];
    act[(size_t)row * n + col] = y > 0.f ? y : 0.f;
  }
}

inline cudaError_t gn_relu_epi(const float* part, int S, int m,
                               const float* bias, const float* gs,
                               const float* gb, int n, float* h, float* act,
                               cudaStream_t st) {
  gn_relu_epilogue<<<dim3(GROUPS, m), 64, 0, st>>>(part, S, m, bias, gs, gb,
                                                   n, h, act);
  HUMOR_CHECK_LAUNCH();
  return cudaSuccess;
}

// One fused layer: h = [a1 | a2] @ w + bias, act = relu(GN(h)).
inline cudaError_t layer_gn(const float* a1, int lda1, int k1, const float* a2,
                            int k2, const float* w, const float* bias,
                            const float* gs, const float* gb, int n, int m,
                            float* part, float* h, float* act,
                            cudaStream_t st) {
  cudaError_t e = matmul(a1, lda1, k1, a2, LAT, k2, w, n, m, n, part, st);
  if (e != cudaSuccess) return e;
  return gn_relu_epi(part, num_slices(k1 + k2), m, bias, gs, gb, n, h, act,
                     st);
}

// Head layer: out (m x n, dense) = [a1 | a2] @ w + bias.
inline cudaError_t layer_head(const float* a1, int lda1, int k1,
                              const float* a2, int k2, const float* w,
                              const float* bias, int n, int m, float* part,
                              float* out, cudaStream_t st) {
  cudaError_t e = matmul(a1, lda1, k1, a2, LAT, k2, w, n, m, n, part, st);
  if (e != cudaSuccess) return e;
  return sum_epi(part, num_slices(k1 + k2), m, n, 0, n, bias, out, n, 0, st);
}

// Prior and decoder MLPs of one step from the carry's state vector x
// (ld CW) and z (ld LAT); keeps every layer's pre-GroupNorm activation.
inline cudaError_t mlp_forward(const RolloutWeights* w, const float* x,
                               const float* z, const Scratch& s, int m,
                               cudaStream_t st) {
  cudaError_t e;
  // prior: 339 -> 1024 x4 -> 96
  e = layer_gn(x, CW, D_X, nullptr, 0, w->pw[0], w->pb[0], w->pgs[1],
               w->pgb[1], HID, m, s.part, s.hp[0], s.ap[0], st);
  if (e) return e;
  for (int i = 1; i < 4; ++i) {
    e = layer_gn(s.ap[i - 1], HID, HID, nullptr, 0, w->pw[i], w->pb[i],
                 w->pgs[i + 1], w->pgb[i + 1], HID, m, s.part, s.hp[i],
                 s.ap[i], st);
    if (e) return e;
  }
  e = layer_head(s.ap[3], HID, HID, nullptr, 0, w->pw[4], w->pb[4], PHEAD, m,
                 s.part, s.phead, st);
  if (e) return e;
  // decoder: [x, z] 387 -> 1024 -> 1024 -> 512 -> 216, z into every layer
  e = layer_gn(x, CW, D_X, z, LAT, w->dw[0], w->db[0], w->dgs[1], w->dgb[1],
               HID, m, s.part, s.hd[0], s.ad[0], st);
  if (e) return e;
  e = layer_gn(s.ad[0], HID, HID, z, LAT, w->dw[1], w->db[1], w->dgs[2],
               w->dgb[2], HID, m, s.part, s.hd[1], s.ad[1], st);
  if (e) return e;
  e = layer_gn(s.ad[1], HID, HID, z, LAT, w->dw[2], w->db[2], w->dgs[3],
               w->dgb[3], 512, m, s.part, s.hd[2], s.ad[2], st);
  if (e) return e;
  return layer_head(s.ad[2], 512, 512, z, LAT, w->dw[3], w->db[3], RAW, m,
                    s.part, s.draw, st);
}

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
