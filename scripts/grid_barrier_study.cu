// Grid-wide barriers in a persistent cooperative launch: an empty kernel
// that passes `n` barriers, for timing what one barrier costs at a given
// grid. Two barriers: cooperative_groups' grid.sync() (kind 0) and a
// hand-written generation barrier (kind 1: one arrive counter and one
// generation word, thread 0 of each block arrives with a fenced atomicAdd
// and spins on an acquire load; the last arriver resets the counter and
// releases the next generation). Both need the co-residency that only a
// cooperative launch guarantees. Built and timed by
// scripts/grid_barrier_study.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// state[0] = arrive count, state[1] = generation
__device__ __forceinline__ void gen_barrier(unsigned* state) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(state + 1);
    __threadfence();
    if (atomicAdd(state, 1u) == gridDim.x - 1) {
      state[0] = 0u;
      st_release(state + 1, gen + 1);
    } else {
      while (ld_acquire(state + 1) == gen) {
      }
    }
  }
  __syncthreads();
}

template <int KIND>
__global__ void barriers(int n, unsigned* state, float* sink) {
  extern __shared__ float smem[];
  if (KIND == 0) {
    cg::grid_group g = cg::this_grid();
    for (int i = 0; i < n; ++i) g.sync();
  } else {
    for (int i = 0; i < n; ++i) gen_barrier(state);
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) sink[0] = (float)n + smem[0] * 0.f;
}

static void* kernel_of(int kind) {
  return kind == 0 ? (void*)barriers<0> : (void*)barriers<1>;
}

extern "C" {

// Blocks of `threads` with `smem` bytes of dynamic shared memory that can
// be co-resident on the whole card (0 on error).
int barrier_max_blocks(int kind, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  if (cudaFuncSetAttribute(kernel_of(kind),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(kind),
                                                    threads, smem))
    return 0;
  return per_sm * sms;
}

// One cooperative launch of `blocks` x `threads` passing `n` barriers.
// `state` (2 unsigned) must be zero before the first call; it is zero again
// after each. Returns the launch's error code (0 = none).
int barrier_run(int kind, int blocks, int threads, int smem, int n,
                unsigned* state, float* sink, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel_of(kind), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  void* args[] = {&n, &state, &sink};
  e = cudaLaunchCooperativeKernel(kernel_of(kind), dim3(blocks),
                                  dim3(threads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e) return e;
  return cudaGetLastError();
}

}  // extern "C"
