// Fused HuMoR rollout, forward: T sequential steps of prior MLP -> decoder
// MLP -> delta composition -> world un-canonicalization -> heading
// re-canonicalization, saving each step's entry carry for the backward, as
// ONE persistent cooperative launch per rollout. Replaces the Pallas kernel
// `_fwd_pallas` of humor_tpu/ops/rollout_kernel.py (:536-606,
// pl.pallas_call at :594); computes what its `kstep` computes (:395-452).
// Per step: the prior (339 -> 1024x4 -> 96, GroupNorm(16)+ReLU) gives the
// latent mean and log-variance, the decoder (387 -> 1024 -> 1024 -> 512 ->
// 216, z into every layer) the deltas, and the tail composes them onto the
// carry. Plain f32 FMA: no TF32, no bf16. The math mirrors
// rollout_forward_plain in humor_torch/ops/rollout_kernel.py;
// tests/test_torch_rollout_fwd_schedule.py replays this kernel's
// partitioning in torch against it.
//
// Bound on the H100: operations. 2 * M * 5.78M FLOP a step against 67
// TFLOP/s of f32 outside the tensor cores: 0.162 ms at T=59, M=16, 1.30 ms
// at M=128.
//
// Design. The persistent machinery of rollout_persistent.cuh, the same as
// the backward's recompute: one block of 256 threads an SM, the weights
// held in shared memory as 1,452 swizzled 64 x 64 tiles loaded once per
// call, split-K products whose output tiles are finished (bias,
// GroupNorm+ReLU, or a head), 16 rows at a time, by dealt blocks after an
// integer-counter wait, in a fixed summation order, so two runs are
// bit-identical.
// * Phases of a step. The next carry depends only on the decoder's head
//   (the prior's head goes into the output alone), so the decoder's chain
//   D0 -> D1 -> D2 -> D3 -> tail sets the pace and the prior runs beside
//   it: phase k = 0..3 runs prior layer k and decoder layer k, then the
//   tail (one block a row), and the prior head of step t runs beside
//   phase 0 of step t + 1 (the last step's in a phase of its own). No
//   grid barrier between phases (rollout_persistent.cuh's ready
//   counters): one a call, after the weights are loaded. Layer 0 of step
//   t waits for the tail rows of step t - 1 in its row tile; the tail for
//   the decoder head's tiles.
// * The prior head's finish writes the latent mean and exp(log-variance)
//   straight into out[t][348:444]; the tail writes out[t][0:348].
// * The running carry lives in scratch with rows padded to 352 floats (16
//   bytes), written by the tail of the step before and read by layer 0
//   through cp.async.cg (L2 only): a copy that allocates in L1 could
//   return a line that another SM has since rewritten. `saved` (the entry
//   carries for the backward) is written only. carry0 is copied into both
//   in the kernel, so the C entry enqueues nothing but the launch.
// * No pre-GroupNorm activation is kept: the backward recomputes its own.
//
// Why it is not nearer its bound: a step is a chain of latencies. At M=16
// a block waits for its inputs ~23 of the ~44 us a step
// (scripts/rollout_fwd_study.py): each layer costs its slowest producer's
// units (2, 4, 3 and 3 tiles in phases 0-3), a signal (a fence, an L2
// round trip) to the finisher, the finish's L2 reads and a signal to the
// next layer's blocks; a block runs its prior and decoder tasks of a phase
// together, so the prior's chain rides on the decoder's; and the tail's
// lane-0 part runs serially, one warp a row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o librollout_fwd.so rollout_fwd.cu

#include <cooperative_groups.h>
#include <stdint.h>

#include "rollout_common.cuh"
#include "rollout_persistent.cuh"

namespace cg = cooperative_groups;

namespace humor {

constexpr int PHASES = 4;           // phases with products a step
constexpr int BARRIERS_PER_CALL = 1;
constexpr int CWP = (CW + 3) & ~3;     // running carry's padded row
constexpr int OUT_X = D_X + 9;         // out: world x | contacts, then pm, pv
static_assert(RAW + 2 * CW + OUT_X <= RING_FLOATS, "tail buffers fit");

struct Params {
  Layer L[NL];
  const float* carry0;
  const float* z;
  const float* t2j;
  float* out;
  float* saved;
  float* pcarry;       // T x M x CWP: the running entry carries
  Counters cnt;
  int n_tiles, M, T;
};

// One step's tail for one row, run by one warp (`lane` 0-31): from the
// entry carry c and the decoder head d (both in shared memory) and the
// row's t2j, writes the world output o[0, OUT_X) and the next carry
// nc[0, CW). Every lane computes the row's global quantities (composed
// root, heading frame); lane j handles body joint j (pose rotation j < 21,
// joint position and velocity j < 22).
__device__ void tail_fwd_row(int lane, const float* c, const float* t2j,
                             const float* d, float* o, float* nc) {
  TailGlobals q;
  tail_globals(c, t2j, d, q);

  if (lane < 22) {
    const int j = lane;
    float nj[3], nv[3], a[3], b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nj[i] = c[207 + 3 * j + i] + d[75 + 3 * j + i];
      nv[i] = c[273 + 3 * j + i] + d[141 + 3 * j + i];
    }
    // world: g^T (n + t2j) - t2j - g_trans; g^T v
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = nj[i] + q.t2j[i];
    mtv(q.g, a, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) o[207 + 3 * j + i] = b[i] - q.t2j[i] - q.gt[i];
    mtv(q.g, nv, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) o[273 + 3 * j + i] = b[i];
    // local: W (n + f + t2j) - t2j; W v
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = nj[i] + q.f[i] + q.t2j[i];
    mv(q.W, a, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) nc[207 + 3 * j + i] = b[i] - q.t2j[i];
    mv(q.W, nv, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) nc[273 + 3 * j + i] = b[i];
  }
  if (lane < 21) {
    float Rd[9], np[9];
    rodrigues(d + 12 + 3 * lane, Rd);
    mm(Rd, c + 18 + 9 * lane, np);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      o[18 + 9 * lane + i] = np[i];
      nc[18 + 9 * lane + i] = np[i];
    }
  }
  if (lane < 9) o[339 + lane] = d[207 + lane];
  if (lane != 0) return;

  float wt[3], v[3], R[9];
  mtv(q.g, q.n_trans, wt);
#pragma unroll
  for (int i = 0; i < 3; ++i) wt[i] -= q.gt[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = wt[i];
  mtv(q.g, q.n_tv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[3 + i] = v[i];
  mtm(q.g, q.n_root, R);
#pragma unroll
  for (int i = 0; i < 9; ++i) o[6 + i] = R[i];
  mtv(q.g, q.n_rv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[15 + i] = v[i];

  float a[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] = q.n_trans[i] + q.f[i];
  mv(q.W, a, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) nc[i] = v[i];
  mv(q.W, q.n_tv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) nc[3 + i] = v[i];
  mm(q.W, q.n_root, R);
#pragma unroll
  for (int i = 0; i < 9; ++i) nc[6 + i] = R[i];
  mv(q.W, q.n_rv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) nc[15 + i] = v[i];
  mm(q.g, q.W, R);
#pragma unroll
  for (int i = 0; i < 9; ++i) nc[339 + i] = R[i];
  nc[348] = -wt[0];
  nc[349] = -wt[1];
  nc[350] = 0.f;
}

// One block a row: once the decoder head of step t is finished in the
// row's row tile, its threads gather the row's head and entry carry into
// shared memory (every load issued before the first store), its first warp
// runs the tail there, then its threads write the world output and the
// next carry (the running carry and saved[t + 1]) and publish the row.
// The entry carry is the one this block wrote at step t - 1 (a row is
// always the same block's).
__device__ void tail_phase(const Params& P, BlockState& bs, int t,
                           float* smem) {
  constexpr int N = RAW + CW;
  constexpr int PER = (N + BT - 1) / BT;
  const Layer* Ls = bs.Ls;
  const int M = P.M;
  float* sd = smem;               // decoder head
  float* sc = sd + RAW;           // the entry carry
  float* so = sc + CW;            // the world output
  float* sn = so + OUT_X;         // the next carry
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const int r = row / RT;
    wait_all(bs, col_tiles(Ls[8]), [&](int j, const int** p) {
      *p = Ls[8].rdy_f + j * bs.R + r;
      return t + 1;
    });
    const float* carry = P.pcarry + ((size_t)t * M + row) * CWP;
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BT;
      float x = 0.f;
      if (i < RAW)
        x = __ldcg(Ls[8].out + (size_t)row * RAW + i);
      else if (i < N)
        x = __ldcg(carry + i - RAW);
      v[j] = x;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BT;
      if (i < N) smem[i] = v[j];
    }
    __syncthreads();
    if (threadIdx.x < 32)
      tail_fwd_row(threadIdx.x, sc, P.t2j + 3 * row, sd, so, sn);
    __syncthreads();
    float* o = P.out + ((size_t)t * M + row) * OUT_W;
    for (int i = threadIdx.x; i < OUT_X; i += BT) o[i] = so[i];
    if (t + 1 < P.T) {
      float* pc = P.pcarry + ((size_t)(t + 1) * M + row) * CWP;
      float* sv = P.saved + ((size_t)(t + 1) * M + row) * CW;
      for (int i = threadIdx.x; i < CWP; i += BT) {
        const float x = i < CW ? sn[i] : 0.f;
        pc[i] = x;
        if (i < CW) sv[i] = x;
      }
    }
    publish_tail_row(bs, row);
  }
}

__global__ void __launch_bounds__(BT, 1)
    rollout_fwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ float4 smem4[];
  // the layer table, the block's tiles and a phase's lists
  __shared__ BlockState bs;
  float* tiles = reinterpret_cast<float*>(smem4);
  float* ring = tiles + MAX_TILES * TILE;
  cg::grid_group grid = cg::this_grid();
  // step 0's entry carry: saved[0] and the running carry
  for (int i = blockIdx.x * BT + threadIdx.x; i < P.M * CWP;
       i += gridDim.x * BT) {
    const int row = i / CWP, c = i % CWP;
    const float x = c < CW ? __ldg(P.carry0 + (size_t)row * CW + c) : 0.f;
    P.pcarry[i] = x;
    if (c < CW) P.saved[(size_t)row * CW + c] = x;
  }
  block_setup(P.L, P.n_tiles, P.cnt.base, P.cnt.n, P.cnt.tail, P.M, bs,
              tiles);
  grid.sync();   // counters zeroed, step 0's carry written
  const Layer* Ls = bs.Ls;
  auto finish = [&](bool, int l, int o, int step, int row0) {
    finish_fwd(Ls, P.M, l, o, step, row0);
  };
  // phase k < 4 of step t: prior layer k beside decoder layer k, and in
  // phase 0 the prior head of step t - 1; then the tail. The last step's
  // prior head runs in a phase of its own. Step t's tasks use their
  // counters for the (t + 1)-th time; layer 0 reads the carry of the tail
  // of step t - 1 (its t-th use).
  for (int t = 0; t <= P.T; ++t) {
    for (int k = 0; k < (t < P.T ? PHASES : 1); ++k) {
      if (threadIdx.x == 0) {
        int n = 0;
        if (t < P.T) {
          const int in = k == 0 ? t : t + 1;
          bs.plan.set(n++, k, false, t, t + 1, in);
          bs.plan.set(n++, 5 + k, false, t, t + 1, in);
        }
        if (k == 0 && t > 0) bs.plan.set(n++, 4, false, t - 1, t, t);
        bs.plan.n = n;
      }
      run_phase(bs, P.z, tiles, ring, finish);
    }
    if (t < P.T) tail_phase(P, bs, t, ring);
  }
  add_tally(bs, P.cnt.stats);
}

// ---------------------------------------------------------------------------
// Host side: the layer table and the launch
// ---------------------------------------------------------------------------

// Fills the layer table; returns the scratch floats it needs.
inline size_t build(Params& P, const RolloutWeights& w, float* scratch,
                    int M, int T) {
  Carver cv{reinterpret_cast<uintptr_t>(scratch), 0};
  P.n_tiles = build_layers(P.L, w, cv, M, false, &P.cnt);
  P.pcarry = cv.take((size_t)T * M * CWP);
  const int first[2] = {0, 5};   // layer 0 of each MLP
  for (int i : first) {
    P.L[i].in = P.pcarry;
    P.L[i].in_ld = CWP;
    P.L[i].in_step = (long long)M * CWP;
  }
  // the prior head: the latent mean and exp(log-variance) into out[t]
  Layer& head = P.L[4];
  head.out = P.out ? P.out + OUT_X : nullptr;
  head.out_ld = OUT_W;
  head.out_step = (long long)M * OUT_W;
  head.exp_col = LAT;
  return cv.off;
}

}  // namespace humor

using namespace humor;

extern "C" {

long long rollout_fwd_scratch_floats(int M, int T) {
  Params P = {};
  return (long long)build(P, RolloutWeights{}, nullptr, M, T);
}

// The grid of every launch (blocks), or minus the CUDA error of the query.
int rollout_fwd_grid_blocks(void) {
  int blocks = 0;
  const cudaError_t e =
      grid_blocks(reinterpret_cast<const void*>(rollout_fwd_kernel), &blocks);
  return e ? -(int)e : blocks;
}

int rollout_fwd_barriers_per_call(void) { return BARRIERS_PER_CALL; }

// carry0 (M, CW), z (T, M, 48), t2j (M, 3) -> out (T, M, OUT_W) and the
// entry carry of every step, saved (T, M, CW); scratch holds
// rollout_fwd_scratch_floats(M, T) floats, 16-byte aligned, and ends the
// call with its ready-waits and the ones that spun in its first two int32
// (read only by a recording caller). Enqueues one
// cooperative launch on `stream` and nothing else, does not synchronise;
// returns the launch's error (0 = none), a refused launch included. A card
// whose blocks cannot hold every weight tile (fewer than 132 SMs) is
// refused with cudaErrorInvalidConfiguration.
int rollout_fwd(const RolloutWeights* w, const float* carry0, const float* z,
                const float* t2j, float* out, float* saved, float* scratch,
                int M, int T, void* stream) {
  if (M < 1 || T < 1) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(rollout_fwd_kernel);
  int blocks = 0;
  cudaError_t e = grid_blocks(kernel, &blocks);
  if (e) return e;
  Params P = {};
  P.carry0 = carry0; P.z = z; P.t2j = t2j; P.out = out; P.saved = saved;
  P.M = M; P.T = T;
  build(P, *w, scratch, M, T);
  return launch(kernel, P, P.n_tiles, blocks, stream);
}

}  // extern "C"
