// Linear-blend skinning's per-vertex blend and apply (humor_torch/ops/skinning.py),
// forward and backward:
//
//   v[b, v] = sum_j w[v, j] (Rw[b, j] v_posed[b, v] + t_rel[b, j]) + trans[b]
//
// Replaces no TPU kernel: the JAX package writes these as einsums that XLA fuses
// (humor_tpu/body_model/smpl.py's lbs). In eager PyTorch the same einsums store the
// blended transforms, (B, V, 3, 3) and (B, V, 3), in device memory (0.5 GB a body at
// 2,000 x 6,890) and apply them as 13.8 M batched 3 x 3 GEMVs, forward and backward,
// one cuBLAS launch per 65,535 matrices.
//
// What bounds it on the H100: float32 FMA. The forward needs 12 J FMA a (row,
// vertex) for the blend and 5 operations a coordinate for the apply, against 24
// bytes of v_posed in and vertices out: at 2,000 x 6,890 x 22, 7.6 GFLOP (0.11 ms
// at 67 TFLOP/s) and 0.33 GB (0.10 ms at 3.35 TB/s). The backward kernel re-blends
// the rotation (9 J FMA), writes grad_v_posed = R_v^T g and the products
// g (x) v_posed that the gradients of Rw and t_rel sum over the vertices (those sums
// run as the plain path's own GEMMs; ops/skinning.py says why): bound by its bytes,
// g and v_posed in, 12 floats out a (row, vertex), 0.99 GB (0.30 ms).
//
// The kernels round as the plain path does, bit for bit at a training step's
// shapes (measured on an H100, PERF.md section 6): the blend is one FMA chain a
// float over the joints in order from 0, as the einsum's GEMM computes it; the
// apply's three products are summed as the batched GEMV sums them, fma(p1, p0) + p2
// in its launches of 65,535 matrices and fma(p2, p0) + p1 in the last, partial one;
// R_v^T g as fma(p1, p0) + p2; then + t, + trans, each rounded.
//
// Design: a block takes FB x FQ vertices and ROWS rows. It stages the vertices'
// weights in shared memory as they lie in device memory (rows of J floats; copy_in
// moves the tile's contiguous floats 16 bytes a thread, coalesced, by cp.async) and
// the rows' transforms as 12 floats a joint (R row-major, then t), read as broadcast
// float4s. A thread then blends FQ vertices of a row at once in registers and runs
// the rows with no barrier. The (B, V, 3) streams are read and written directly: a
// warp's 32 lanes take 32 consecutive vertices, so its three accesses of a vertex's
// coordinates cover one contiguous 384-byte span, every sector fetched through L1
// used, and the blend hides the loads' latency. The sizes are the fastest of those
// timed on an H100 (PERF.md section 6: 2 to 8 vertices a thread, weight tiles padded
// to conflict-free strides and copied row by row or a warp a row).
// Float32 FMA only, no tensor cores: the contract is exact f32 (TF32 stays off), and
// no term is dropped (a weight of 0 is multiplied like any other).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The design's sizes. humor_torch/ops/skinning.design() reads them from this file:
// the edge sizes of the kernel tests follow them.
constexpr int FB = 128;           // threads a block
constexpr int FQ = 4;             // vertices a thread
constexpr int ROWS = 8;           // rows a block
constexpr int MAX_JOINTS = 64;    // SMPL 24, SMPL+H 52, SMPL-X 55
constexpr int GEMV_BATCH = 65535; // matrices a launch of the plain path's batched GEMV
constexpr int NV = FB * FQ;       // vertices a block
constexpr int TS = 12;            // floats of a joint's transform: R (3 x 3), t

__host__ __device__ inline int padded(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ int phase(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// n floats from g into buf: g[i] lands at buf[phase(g) + i] (buf 16-byte aligned),
// whole float4s as float4s
__device__ void copy_in(float* __restrict__ buf, const float* __restrict__ g, int n) {
  const int ph = phase(g);
  const int units = (ph + n + 3) >> 2;
  for (int u = threadIdx.x; u < units; u += FB) {
    const int lo = 4 * u - ph;
    if (lo >= 0 && lo + 4 <= n) {
      cp16(buf + 4 * u, g + lo);
    } else {
      for (int k = 0; k < 4; ++k)
        if (lo + k >= 0 && lo + k < n) cp4(buf + ph + lo + k, g + lo + k);
    }
  }
}

// The block's tiles: the weights of vertices v0 .. v0 + nv - 1 into wt (from
// wt[phase]), and rows b0 .. b0 + nb - 1's transforms into tr (J x 12 floats a row;
// t set to 0 without t_rel). Returns the weights' phase.
__device__ int stage(float* __restrict__ wt, float* __restrict__ tr,
                     const float* __restrict__ w, const float* __restrict__ Rw,
                     const float* __restrict__ t_rel, int v0, int nv, int b0, int nb,
                     int J) {
  copy_in(wt, w + (size_t)v0 * J, nv * J);
  for (int i = threadIdx.x; i < nb * J; i += FB) {
    float* dst = tr + i * TS;
    const float* r = Rw + ((size_t)b0 * J + i) * 9;
#pragma unroll
    for (int e = 0; e < 9; ++e) cp4(dst + e, r + e);
    if (t_rel != nullptr) {
      const float* t = t_rel + ((size_t)b0 * J + i) * 3;
#pragma unroll
      for (int e = 0; e < 3; ++e) cp4(dst + 9 + e, t + e);
    } else {
#pragma unroll
      for (int e = 0; e < 3; ++e) dst[9 + e] = 0.f;
    }
  }
  return phase(w + (size_t)v0 * J);
}

// acc[q][e] = sum_j w[v_q, j] tr[j][e] for the thread's FQ vertices, one FMA chain
// a float over the joints in order, from 0; E = 12 (R and t) or 9 (R).
template <int E>
__device__ __forceinline__ void blend(float (&acc)[FQ][E], const float* __restrict__ tr,
                                      const float* __restrict__ wrow, int J) {
#pragma unroll
  for (int q = 0; q < FQ; ++q)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[q][e] = 0.f;
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    const float4* T = reinterpret_cast<const float4*>(tr + j * TS);
    const float4 a = T[0], c = T[1];
    float m[E];
    m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
    m[4] = c.x; m[5] = c.y; m[6] = c.z; m[7] = c.w;
    if constexpr (E == 12) {
      const float4 d = T[2];
      m[8] = d.x; m[9] = d.y; m[10] = d.z; m[11] = d.w;
    } else {
      m[8] = tr[j * TS + 8];
    }
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const float wj = wrow[q * FB * J + j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[q][e] = __fmaf_rn(wj, m[e], acc[q][e]);
    }
  }
}

__global__ void __launch_bounds__(FB, 4)
skin_fwd_kernel(const float* __restrict__ w, const float* __restrict__ Rw,
                const float* __restrict__ t_rel, const float* __restrict__ vp,
                const float* __restrict__ trans, float* __restrict__ out, int B,
                int V, int J, long long tail) {
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);   // NV x J, from wt[ph]
  float* tr = wt + padded(NV * J + 4);            // ROWS x J x 12
  float* tt = tr + ROWS * J * TS;                 // ROWS x 4
  const int v0 = blockIdx.x * NV, nv = min(NV, V - v0);
  const int b0 = blockIdx.y * ROWS, nb = min(ROWS, B - b0);
  const int ph = stage(wt, tr, w, Rw, t_rel, v0, nv, b0, nb, J);
  for (int i = threadIdx.x; i < nb * 3; i += FB)
    cp4(tt + (i / 3) * 4 + i % 3, trans + (size_t)b0 * 3 + i);
  cp_commit_wait_all();
  __syncthreads();

  for (int r = 0; r < nb; ++r) {
    const long long row0 = (long long)(b0 + r) * V + v0;   // matrix index of v0
    float x[FQ][3];                  // loaded now, used after the blend
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int v = threadIdx.x + q * FB;
#pragma unroll
      for (int c = 0; c < 3; ++c) x[q][c] = v < nv ? __ldcs(vp + (row0 + v) * 3 + c) : 0.f;
    }
    float acc[FQ][TS];
    blend<TS>(acc, tr + r * J * TS, wt + ph + threadIdx.x * J, J);
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int v = threadIdx.x + q * FB;
      if (v < nv) {
        const bool full = row0 + v < tail;   // in a full launch of the GEMV
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float* a = acc[q] + 3 * i;
          const float s = full
              ? __fadd_rn(__fmaf_rn(a[1], x[q][1], __fmul_rn(a[0], x[q][0])),
                          __fmul_rn(a[2], x[q][2]))
              : __fadd_rn(__fmaf_rn(a[2], x[q][2], __fmul_rn(a[0], x[q][0])),
                          __fmul_rn(a[1], x[q][1]));
          __stcs(out + (row0 + v) * 3 + i,
                 __fadd_rn(__fadd_rn(s, acc[q][9 + i]), tt[r * 4 + i]));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(FB, 4)
skin_bwd_kernel(const float* __restrict__ w, const float* __restrict__ Rw,
                const float* __restrict__ vp, const float* __restrict__ g,
                float* __restrict__ gvp, float* __restrict__ prod, int B, int V,
                int J) {
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);   // NV x J, from wt[ph]
  float* tr = wt + padded(NV * J + 4);            // ROWS x J x 12
  const int v0 = blockIdx.x * NV, nv = min(NV, V - v0);
  const int b0 = blockIdx.y * ROWS, nb = min(ROWS, B - b0);
  const int ph = stage(wt, tr, w, Rw, nullptr, v0, nv, b0, nb, J);
  cp_commit_wait_all();
  __syncthreads();

  for (int r = 0; r < nb; ++r) {
    const long long row0 = (long long)(b0 + r) * V + v0;
    float gv[FQ][3], x[FQ][3];
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int v = threadIdx.x + q * FB;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gv[q][c] = v < nv ? __ldcs(g + (row0 + v) * 3 + c) : 0.f;
        x[q][c] = v < nv ? __ldcs(vp + (row0 + v) * 3 + c) : 0.f;
      }
    }
    float rot[FQ][9];
    blend<9>(rot, tr + r * J * TS, wt + ph + threadIdx.x * J, J);
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int v = threadIdx.x + q * FB;
      if (v < nv) {
        const float* R = rot[q];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          __stcs(gvp + (row0 + v) * 3 + k,
                 __fadd_rn(__fmaf_rn(R[3 + k], gv[q][1], __fmul_rn(R[k], gv[q][0])),
                           __fmul_rn(R[6 + k], gv[q][2])));
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            __stcs(prod + (row0 + v) * 9 + 3 * i + k, __fmul_rn(gv[q][i], x[q][k]));
      }
    }
  }
}

size_t fwd_smem(int J) {
  return sizeof(float) * ((size_t)padded(NV * J + 4) + ROWS * J * TS + ROWS * 4);
}

size_t bwd_smem(int J) {
  return sizeof(float) * ((size_t)padded(NV * J + 4) + ROWS * J * TS);
}

}  // namespace

extern "C" {

const char* humor_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// weights (V, J), Rw (B, J, 3, 3), t_rel (B, J, 3), v_posed (B, V, 3), trans (B, 3)
// float32, contiguous, on the device -> out (B, V, 3). Enqueues on `stream`, does
// not synchronise; returns the launch error (0 = none). Nothing is launched when B
// or V is 0.
int skin_forward(const float* w, const float* Rw, const float* t_rel, const float* vp,
                 const float* trans, float* out, int B, int V, int J, void* stream) {
  if (B <= 0 || V <= 0) return cudaSuccess;
  if (J < 1 || J > MAX_JOINTS || (B + ROWS - 1) / ROWS > 65535)
    return cudaErrorInvalidValue;
  // The limit is the function's, shared by every launch: set it to the largest
  // size, so that a concurrent launch never finds it lowered.
  cudaError_t err = cudaFuncSetAttribute(
      skin_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_smem(MAX_JOINTS));
  if (err != cudaSuccess) return err;
  const long long n = (long long)B * V;
  dim3 grid((V + NV - 1) / NV, (B + ROWS - 1) / ROWS);
  skin_fwd_kernel<<<grid, FB, fwd_smem(J), static_cast<cudaStream_t>(stream)>>>(
      w, Rw, t_rel, vp, trans, out, B, V, J, n - n % GEMV_BATCH);
  return cudaGetLastError();
}

// weights, Rw, v_posed as for skin_forward, grad (B, V, 3) -> grad_v_posed (B, V, 3)
// and the products prod[b][v][i][k] = grad[b][v][i] v_posed[b][v][k] (B, V, 3, 3),
// every element written. Nothing is launched when B or V is 0.
int skin_backward(const float* w, const float* Rw, const float* vp, const float* g,
                  float* gvp, float* prod, int B, int V, int J, void* stream) {
  if (B <= 0 || V <= 0) return cudaSuccess;
  if (J < 1 || J > MAX_JOINTS || (B + ROWS - 1) / ROWS > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      skin_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem(MAX_JOINTS));
  if (err != cudaSuccess) return err;
  dim3 grid((V + NV - 1) / NV, (B + ROWS - 1) / ROWS);
  skin_bwd_kernel<<<grid, FB, bwd_smem(J), static_cast<cudaStream_t>(stream)>>>(
      w, Rw, vp, g, gvp, prod, B, V, J);
  return cudaGetLastError();
}

}  // extern "C"
