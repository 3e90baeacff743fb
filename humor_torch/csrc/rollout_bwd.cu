// Fused HuMoR rollout, backward: the reversed T-step VJP of the forward in
// rollout_fwd.cu, written out by hand, as ONE persistent cooperative launch
// per rollout. Replaces the Pallas kernel `_bwd_pallas` of
// humor_tpu/ops/rollout_kernel.py (:609-709, pl.pallas_call at :695),
// which traced jax.vjp inside the kernel. Per reversed step t: recompute
// the prior (339 -> 1024x4 -> 96) and decoder (387 -> 1024 -> 1024 -> 512
// -> 216, z into every layer) activations from the saved entry carry, run
// the tail VJP, then back through both MLPs (GroupNorm(16)+ReLU backward
// and the transposed products). Returns d(carry0), dz for every step and
// the accumulated d(trans2joint); the weights get no cotangent. Plain f32
// FMA: no TF32, no bf16. The math mirrors rollout_backward_plain in
// humor_torch/ops/rollout_kernel.py; tests/test_torch_rollout_bwd_schedule.py
// replays this kernel's partitioning in torch against it.
//
// Bound on the H100: operations. 2 x 2 * M * 5.78M FLOP a step (recompute
// and transposed products) against 67 TFLOP/s of f32 outside the tensor
// cores: 0.324 ms at T=59, M=16.
//
// Design. One block of 256 threads an SM (its shared memory allows no
// more), launched with cudaLaunchCooperativeKernel, which refuses a grid
// that cannot be co-resident; grid.sync() separates dependent phases.
// * Weight-stationary: the 23 MB of weights are cut into 64 x 64 tiles
//   (1,452 of them), dealt round-robin to the blocks (11 at most on 132
//   SMs) and loaded into shared memory once per call. A tile serves both
//   directions: the recompute's product reads its rows, the backward's
//   transposed product (dh @ w^T) its columns; a swizzled layout keeps
//   both reads free of bank conflicts. A phase then moves activations
//   only, not weights.
// * A product is split over K: a tile writes the partial sums of its
//   K-slice for all M rows (row tiles of RT) and arrives at its output
//   tile's counter (an integer atomic). Each output tile of a phase is
//   dealt to one block, which waits for all its K-slices to arrive, sums
//   the partials in slice order and finishes it: bias, GroupNorm(16) and
//   ReLU (the 64 columns cover whole groups), or in the backward the
//   GroupNorm+ReLU VJP at the stored pre-GroupNorm h, the z columns into
//   dz. The next phase reads finished inputs. The order of the sums is
//   fixed, not the order of arrival, so two runs give bit-identical
//   outputs.
// * Phases of a step: F0-F4 recompute (F_i runs prior layer i and decoder
//   layer i together), TL the tail VJP (one block a row), B0-B4 backward
//   (B_k runs prior layer 4-k and decoder layer 3-k transposed). The
//   recompute of step t needs only its saved carry, so it runs beside the
//   backward of step t + 1: iteration t is F_k(t) | B_k(t + 1) for k =
//   0..4, then TL(t). Barriers: 6 a step, 6 T + 6 a call (one after the
//   weights are loaded). h is kept in two copies, by step parity.
// Scratch written inside the launch is read only through L2 (__ldcg or
// cp.async.cg), never through the non-coherent read-only path; only the
// weights and the inputs are read that way. The arrival counters and dt2j
// are zeroed in the kernel and dz is written before it is added to, so
// the C entry enqueues nothing but the launch.
//
// Why it is not nearer its bound: 6 T + 6 barriers at ~1.1 us each (0.40
// ms at T=59, scripts/grid_barrier_study.py); a phase waits for its
// slowest block's products, then for the L2 round trips of its finishes
// (the partials, then the finished tile); and the tail's lane-0 part
// (root, heading, global transform) runs serially, one warp a row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o librollout_bwd.so rollout_bwd.cu

#include <cooperative_groups.h>
#include <stdint.h>

#include "rollout_common.cuh"

namespace cg = cooperative_groups;

namespace humor {

// Cotangent of rodrigues(): aa (3), dR (9) -> daa (3).
__device__ inline void rodrigues_vjp(const float* aa, const float* dR,
                                     float* daa) {
  const float v[3] = {aa[0] + 1e-8f, aa[1] + 1e-8f, aa[2] + 1e-8f};
  const float sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float angle = sqrtf(fmaxf(sq, 1e-16f));
  const float u[3] = {v[0] / angle, v[1] / angle, v[2] / angle};
  const float c = cosf(angle), s = sinf(angle), C = 1.f - c;
  const float dc = dR[0] + dR[4] + dR[8];
  float dC = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) dC += dR[3 * i + j] * u[i] * u[j];
  const float ds = -dR[1] * u[2] + dR[2] * u[1] + dR[3] * u[2] -
                   dR[5] * u[0] - dR[6] * u[1] + dR[7] * u[0];
  float du[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) acc += (dR[3 * i + j] + dR[3 * j + i]) * u[j];
    du[i] = C * acc;
  }
  du[0] += s * (dR[7] - dR[5]);
  du[1] += s * (dR[2] - dR[6]);
  du[2] += s * (dR[3] - dR[1]);
  const float dangle = -s * (dc - dC) + c * ds -
                       (du[0] * v[0] + du[1] * v[1] + du[2] * v[2]) /
                           (angle * angle);
  const float dsq = dangle / (2.f * angle) * clamp_grad(sq, 1e-16f);
#pragma unroll
  for (int i = 0; i < 3; ++i) daa[i] = du[i] / angle + 2.f * v[i] * dsq;
}

// Adds the cotangent of heading() w.r.t. the root (entries 0 and 3).
__device__ inline void heading_vjp(const float* r, const float* dW,
                                   float* dr) {
  const float bx = -r[0], by = -r[3];
  const float hsq = bx * bx + by * by;
  const float h = sqrtf(fmaxf(hsq, 1e-12f));
  const bool deg = h < 1e-6f;
  const float hp = h + 1e-6f;
  const float dc = dW[0] + dW[4], ds = dW[1] - dW[3];
  float dbx = deg ? 0.f : dc / hp;
  float dby = deg ? 0.f : ds / hp;
  const float dh = deg ? 0.f : -(dc * bx + ds * by) / (hp * hp);
  const float dhsq = dh / (2.f * h) * clamp_grad(hsq, 1e-12f);
  dbx += 2.f * bx * dhsq;
  dby += 2.f * by * dhsq;
  dr[0] -= dbx;
  dr[3] -= dby;
}

__device__ inline void outer_add(const float* a, const float* b, float* M) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] += a[i] * b[j];
}

// Every lane gets the warp's sums of v[0..N) (unrolled, so v stays in
// registers).
template <int N>
__device__ inline void warp_sum(float* v) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// VJP of tail_fwd for one row, run by one warp (`lane` 0-31): given the
// step's entry carry c, its t2j, decoder head d and prior head ph, the
// output cotangent go and the next carry's cotangent gn, writes d(carry)
// (the tail's part; the MLPs' layer-0 parts are added in the next tail),
// d(decoder head), d(prior head), and adds this step's d(trans2joint).
// c, d, ph, go and gn may lie in shared memory; dt2j was written by
// earlier steps on other SMs, so it is read through L2.
__device__ void tail_vjp_row(int lane, const float* c, const float* t2j,
                             const float* d, const float* ph,
                             const float* go, const float* gn, float* dc,
                             float* dd, float* dph, float* dt2j) {
  TailGlobals q;
  tail_globals(c, t2j, d, q);

  // joints and joint velocities: lane j, partial sums reduced below
  // red = dW 9 | dgT 9 | df 3 | dt2j 3 | dg_trans 3
  float red[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) red[i] = 0.f;
  if (lane < 22) {
    const int j = lane;
    float nj[3], nv[3], dlj[3], dlv[3], dwj[3], dwv[3], a[3], dq[3], dqw[3],
        b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nj[i] = c[207 + 3 * j + i] + d[75 + 3 * j + i];
      nv[i] = c[273 + 3 * j + i] + d[141 + 3 * j + i];
      dlj[i] = gn[207 + 3 * j + i];
      dlv[i] = gn[273 + 3 * j + i];
      dwj[i] = go[207 + 3 * j + i];
      dwv[i] = go[273 + 3 * j + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = nj[i] + q.f[i] + q.t2j[i];
    outer_add(dlj, a, red);
    outer_add(dlv, nv, red);
    mtv(q.W, dlj, dq);
    float dnv[3];
    mtv(q.W, dlv, dnv);
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = nj[i] + q.t2j[i];
    outer_add(dwj, a, red + 9);
    outer_add(dwv, nv, red + 9);
    mv(q.g, dwj, dqw);
    mv(q.g, dwv, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      red[18 + i] += dq[i];
      red[21 + i] += dq[i] - dlj[i] + dqw[i] - dwj[i];
      red[24 + i] -= dwj[i];
      const float dnj = dq[i] + dqw[i];
      dnv[i] += b[i];
      dc[207 + 3 * j + i] = dnj;
      dd[75 + 3 * j + i] = dnj;
      dc[273 + 3 * j + i] = dnv[i];
      dd[141 + 3 * j + i] = dnv[i];
    }
  }
  warp_sum<27>(red);

  // body pose rotations: lane j < 21
  if (lane < 21) {
    float dnp[9], Rd[9], dRd[9], dP[9], daa[3];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      dnp[i] = go[18 + 9 * lane + i] + gn[18 + 9 * lane + i];
    rodrigues(d + 12 + 3 * lane, Rd);
    mmt(dnp, c + 18 + 9 * lane, dRd);
    mtm(Rd, dnp, dP);
    rodrigues_vjp(d + 12 + 3 * lane, dRd, daa);
#pragma unroll
    for (int i = 0; i < 9; ++i) dc[18 + 9 * lane + i] = dP[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) dd[12 + 3 * lane + i] = daa[i];
  }
  if (lane < 9) dd[207 + lane] = go[339 + lane];
  for (int i = lane; i < LAT; i += 32) {
    dph[i] = go[348 + i];
    dph[LAT + i] = go[396 + i] * expf(ph[LAT + i]);
  }
  if (lane != 0) return;

  // root, translation and velocities, the frames, the global transform
  const float* dl_trans = gn;
  const float* dl_tv = gn + 3;
  const float* dl_root = gn + 6;
  const float* dl_rv = gn + 15;
  const float* dG = gn + 339;
  const float* dw_tv = go + 3;
  const float* dw_root = go + 6;
  const float* dw_rv = go + 15;
  const float dw_trans[3] = {go[0] - gn[348], go[1] - gn[349], go[2]};
  float dW[9], dgT[9], tmp[9], v[3];
  mtm(q.g, dG, dW);
#pragma unroll
  for (int i = 0; i < 9; ++i) { dW[i] += red[i]; dgT[i] = red[9 + i]; }
  float dg[9];
  mmt(dG, q.W, dg);
  outer_add(dl_tv, q.n_tv, dW);
  outer_add(dl_rv, q.n_rv, dW);
  float dn_tv[3], dn_rv[3], dn_trans[3], df[3], qt[3], dn_root[9];
  mtv(q.W, dl_tv, dn_tv);
  mtv(q.W, dl_rv, dn_rv);
#pragma unroll
  for (int i = 0; i < 3; ++i) qt[i] = q.n_trans[i] + q.f[i];
  outer_add(dl_trans, qt, dW);
  mtv(q.W, dl_trans, dn_trans);
#pragma unroll
  for (int i = 0; i < 3; ++i) df[i] = red[18 + i] + dn_trans[i];
  mmt(dl_root, q.n_root, tmp);
#pragma unroll
  for (int i = 0; i < 9; ++i) dW[i] += tmp[i];
  mtm(q.W, dl_root, dn_root);
  dn_trans[0] -= df[0];
  dn_trans[1] -= df[1];
  heading_vjp(q.n_root, dW, dn_root);

  outer_add(dw_tv, q.n_tv, dgT);
  outer_add(dw_rv, q.n_rv, dgT);
  outer_add(dw_trans, q.n_trans, dgT);
  mmt(dw_root, q.n_root, tmp);
#pragma unroll
  for (int i = 0; i < 9; ++i) dgT[i] += tmp[i];
  mv(q.g, dw_tv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) dn_tv[i] += v[i];
  mv(q.g, dw_rv, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) dn_rv[i] += v[i];
  mv(q.g, dw_trans, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) dn_trans[i] += v[i];
  mm(q.g, dw_root, tmp);
#pragma unroll
  for (int i = 0; i < 9; ++i) dn_root[i] += tmp[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) dg[3 * i + j] += dgT[3 * j + i];

  float dRdr[9], droot[9], daa[3];
  mmt(dn_root, q.root, dRdr);
  mtm(q.Rdr, dn_root, droot);
  rodrigues_vjp(d + 6, dRdr, daa);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dc[i] = dn_trans[i];
    dc[3 + i] = dn_tv[i];
    dc[15 + i] = dn_rv[i];
    dc[348 + i] = red[24 + i] - dw_trans[i];
    dd[i] = dn_trans[i];
    dd[3 + i] = dn_tv[i];
    dd[6 + i] = daa[i];
    dd[9 + i] = dn_rv[i];
    dt2j[i] = __ldcg(dt2j + i) + red[21 + i];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    dc[6 + i] = droot[i];
    dc[339 + i] = dg[i];
  }
}

constexpr int BT = 256;                // threads a block, one block an SM
constexpr int TK = 64;                 // weight tile: TK rows of w
constexpr int TN = 64;                 //   x TN columns
constexpr int TILE = TK * TN;
constexpr int RT = 16;                 // rows a row tile
constexpr int LD_IN = TK + 4;          // staged input: RT rows of TK (= TN)
constexpr int NBUF = 10;               // staged inputs in flight
constexpr int MAX_TILES = 11;          // weight tiles a block holds
constexpr int NL = 9;                  // prior layers 0-4, decoder 0-3
constexpr int STAGES = 5;
constexpr int BARRIERS_PER_STEP = STAGES + 1;
constexpr int MAX_SLICES = (HID + LAT + TK - 1) / TK;
constexpr int SMEM_FLOATS = MAX_TILES * TILE + NBUF * RT * LD_IN;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(TK == TN && TK == 64, "square tiles of 16 float4 columns");
static_assert(BT == 4 * (TN / 4) * (RT / 4), "thread = K quarter x 4 columns "
                                              "x 4 rows");
static_assert(RAW + PHEAD + 2 * CW + OUT_W <= NBUF * RT * LD_IN,
              "tail buffers fit");
static_assert(SMEM_BYTES + 2048 <= 232448,
              "shared memory of one block, with the static tables");

// One layer: its weights and the buffers of its two products. Recompute:
// out (M, n) = in (M, ka [+ z 48]) @ w; backward: d(input) (M, ka [+ 48])
// = dh_in (M, n) @ w^T.
struct Layer {
  const float* w;      // (ka + kz) x n
  const float* bias;   // n
  const float* gs;     // GroupNorm affine on the output (the next layer's
  const float* gb;     //   input), null for a head
  const float* in;     // recompute input, rows of in_ld, + t * in_step
  long long in_step;
  const float* dh_in;  // backward input: d(output), M x n
  float* part_f;       // recompute partials: slices x M x n
  float* part_b;       // backward partials: n tiles x M x (ka + kz)
  float* h;            // pre-GroupNorm output, 2 x M x n by step parity
  float* out;          // relu(GroupNorm(h)), or a head's h (M x n)
  float* dh_out;       // d(input), M x ka: the previous layer's dh, or dx
  int* cnt_f;          // arrivals at each recompute output tile
  int* cnt_b;          // arrivals at each backward output slice
  int in_ld, ka, kz, n;
  int tile0;           // first index of its tiles in the dealing order
  int prev;            // the layer that feeds it, -1 for layer 0
};

struct Params {
  Layer L[NL];
  const float* saved;
  const float* z;
  const float* t2j;
  const float* dout;
  float* dcarry0;
  float* dz;
  float* dt2j;
  float* dcur[2];      // tail parts of the carry cotangent, by step parity
  float* ddraw;        // M x RAW: the decoder head's backward input
  float* dp;           // M x PHEAD: the prior head's
  int* counters;
  int n_counters, n_tiles, M, T;
};

__host__ __device__ inline int act_slices(const Layer& l) {
  return (l.ka + TK - 1) / TK;
}
__host__ __device__ inline int slices(const Layer& l) {
  return act_slices(l) + (l.kz > 0);
}
__host__ __device__ inline int col_tiles(const Layer& l) {
  return (l.n + TN - 1) / TN;
}
// rows of w in slice s, and the first of them
__host__ __device__ inline int slice_rows(const Layer& l, int s) {
  return s < act_slices(l) ? min(TK, l.ka - s * TK) : l.kz;
}
__host__ __device__ inline int slice_row0(const Layer& l, int s) {
  return s < act_slices(l) ? s * TK : l.ka;
}

// sum over s < S <= MAX_SLICES of p[s * stride], in order; every load is
// issued before the first add
__device__ __forceinline__ float sum_slices(const float* p, int S,
                                            size_t stride) {
  float u[MAX_SLICES];
#pragma unroll
  for (int s = 0; s < MAX_SLICES; ++s)
    u[s] = s < S ? __ldcg(p + s * stride) : 0.f;
  float v = u[0];
#pragma unroll
  for (int s = 1; s < MAX_SLICES; ++s)
    if (s < S) v += u[s];
  return v;
}

__device__ __forceinline__ float4 sum_slices4(const float* p, int S,
                                              size_t stride) {
  float4 u[MAX_SLICES];
#pragma unroll
  for (int s = 0; s < MAX_SLICES; ++s)
    u[s] = s < S ? __ldcg(reinterpret_cast<const float4*>(p + s * stride))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = u[0];
#pragma unroll
  for (int s = 1; s < MAX_SLICES; ++s)
    if (s < S) {
      v.x += u[s].x; v.y += u[s].y; v.z += u[s].z; v.w += u[s].w;
    }
  return v;
}

// sum over the `lanes` lanes (8 or 16, aligned) that hold one group
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// global -> shared, asynchronous; zero-filled when !on
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A weight tile's element (k, c) sits in row k at float4 column
// (c / 4) ^ f(k), f(k) = 2 ((k / 4) % 4) ^ 4 (k % 2). A K quarter q is the
// float4 columns (or rows) q, q + 4, q + 8, q + 12 of its slice, so the
// lanes of a quarter-warp (four quarters x two column groups, or x two
// output rows) read eight different banks both in the recompute (rows
// 4q + 16i + e) and in the backward (rows kg + 16j, float4 column q + 4i),
// and the input rows are read at four float4 columns 4 apart.
__device__ __forceinline__ int swz(int k, int c4) {
  return k * TN + 4 * (c4 ^ (((k >> 2) & 3) << 1) ^ ((k & 1) << 2));
}

// The layer, K-slice and column tile of tile g of the dealing order.
__device__ inline int decode(const Layer* Ls, int g, int* s, int* nn) {
  for (int l = 0; l < NL; ++l) {
    const Layer& L = Ls[l];
    const int nt = col_tiles(L), i = g - L.tile0;
    if (i >= 0 && i < slices(L) * nt) {
      *s = i / nt;
      *nn = i % nt;
      return l;
    }
  }
  return -1;
}

// The block's tiles, g = blockIdx.x + i * gridDim.x of the dealing order
// (layer, K-slice, column tile in own[0..2][i]), into shared memory, zero
// past the layer's rows and columns.
__device__ void load_tiles(const Layer* Ls, const int (*own)[MAX_TILES],
                           int n_own, float* tiles) {
  for (int i = 0; i < n_own; ++i) {
    const int s = own[1][i], nn = own[2][i];
    const Layer& L = Ls[own[0][i]];
    const int kw = slice_rows(L, s), k0 = slice_row0(L, s);
    const int nw = min(TN, L.n - nn * TN);
    for (int e = threadIdx.x; e < TK * TN / 4; e += BT) {
      const int k = e / (TN / 4), c4 = e % (TN / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < kw && 4 * c4 < nw)
        v = __ldg(reinterpret_cast<const float4*>(
            L.w + (size_t)(k0 + k) * L.n + nn * TN + 4 * c4));
      *reinterpret_cast<float4*>(tiles + i * TILE + swz(k, c4)) = v;
    }
  }
}

// A phase's lists, built by thread 0 in shared memory.
struct StageLists {
  int tasks[2 * MAX_TILES];
  int seg_l[4], seg_step[4], seg_n[4];
  int n, nseg;
};

// A work unit: one direction of one held tile for one row tile.
struct Unit {
  int l, s, nn, slot, bwd, row0, step;
};

// Start copying a unit's input (RT rows x 64 columns) into `buf`: the
// recompute reads the K-slice s of its input (or z), the backward the
// column tile nn of d(output). Zero past M and past the slice's width.
__device__ void stage_input(const Params& P, const Layer* Ls, const Unit& u,
                            float* buf) {
  const Layer& L = Ls[u.l];
  const int r = threadIdx.x >> 4, c = 4 * (threadIdx.x & 15);
  const int row = u.row0 + r;
  const bool on = row < P.M;
  float* dst = buf + r * LD_IN + c;
  if (u.bwd) {
    const int nw = min(TN, L.n - u.nn * TN);
    const float* src = L.dh_in + (size_t)row * L.n + u.nn * TN + c;
    cp_async16(dst, on && c < nw ? src : L.dh_in, on && c < nw);
  } else if (u.s >= act_slices(L)) {
    const float* src = P.z + ((size_t)u.step * P.M + row) * LAT + c;
    cp_async16(dst, on && c < LAT ? src : P.z, on && c < LAT);
  } else {
    const int kw = slice_rows(L, u.s);
    const float* base = L.in + u.step * L.in_step;
    const float* src = base + (size_t)row * L.in_ld + u.s * TK + c;
    if (L.in_ld % 4 == 0) {
      cp_async16(dst, on && c < kw ? src : base, on && c < kw);
    } else {   // the carry's rows (351 floats) are not 16-byte aligned
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async4(dst + q, on && c + q < kw ? src + q : base,
                  on && c + q < kw);
    }
  }
}

// The unit's product from its staged input and tile: thread (q, cg, rg)
// sums K quarter q for rows 4rg..4rg+3 and four outputs; the quarters are
// added across lanes in a fixed order. Writes the unit's partials.
__device__ void unit_product(const Params& P, const Layer* Ls, const Unit& u,
                             const float* in, const float* tile) {
  const Layer& L = Ls[u.l];
  const int q = threadIdx.x & 3, cg = (threadIdx.x >> 2) & 15;
  const int rg = threadIdx.x >> 6;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a0 = in + 4 * rg * LD_IN;
  if (!u.bwd) {
    // out[r][4cg + j] += in[r][k] * w[k][4cg + j], k in quarter q (rows
    // past the slice are zero in the tile and the input)
#pragma unroll
    for (int k = 4 * q; k < TK; k += 16) {
      float4 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const float4*>(tile + swz(k + e, cg));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a0 + i * LD_IN + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][0] = fmaf(av[e], w[e].x, acc[i][0]);
          acc[i][1] = fmaf(av[e], w[e].y, acc[i][1]);
          acc[i][2] = fmaf(av[e], w[e].z, acc[i][2]);
          acc[i][3] = fmaf(av[e], w[e].w, acc[i][3]);
        }
      }
    }
  } else {
    // out[r][cg + 16j] += dh[r][c] * w[cg + 16j][c], c in quarter q
    // (columns past the layer are zero in the tile and the input)
#pragma unroll
    for (int c = 4 * q; c < TN; c += 16) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(tile +
                                                swz(cg + 16 * j, c >> 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a0 + i * LD_IN + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a.x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, w[j].w, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 2);
    }
  if (q != 0) return;
  const int M = P.M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = u.row0 + 4 * rg + i;
    if (row >= M) break;
    if (!u.bwd) {
      const int col = u.nn * TN + 4 * cg;
      if (col < L.n)
        *reinterpret_cast<float4*>(
            L.part_f + ((size_t)u.s * M + row) * L.n + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      const int ld = L.ka + L.kz, c0 = slice_row0(L, u.s);
      const int kw = slice_rows(L, u.s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cg + 16 * j < kw)
          L.part_b[((size_t)u.nn * M + row) * ld + c0 + cg + 16 * j] =
              acc[i][j];
    }
  }
}

// Finish recompute output tile nn of layer l (all K-slices have arrived):
// h = partials in slice order + bias; a head keeps h, a hidden layer keeps
// h (its step's copy) and relu(GroupNorm(h) * gs + gb). A warp holds two
// rows; a GroupNorm group of 64 or 32 columns is 16 or 8 lanes.
__device__ void finish_fwd(const Params& P, const Layer* Ls, int l, int nn,
                           int t) {
  const Layer& L = Ls[l];
  const int M = P.M, S = slices(L);
  const int col = nn * TN + 4 * (threadIdx.x & 15);
  const bool cv = col < L.n;
  const int lanes = L.n / GROUPS / 4;
  // the column's bias and GroupNorm affine, loaded once
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = zero, gs = zero, gb = zero;
  if (cv) {
    b = __ldg(reinterpret_cast<const float4*>(L.bias + col));
    if (L.gs) {
      gs = __ldg(reinterpret_cast<const float4*>(L.gs + col));
      gb = __ldg(reinterpret_cast<const float4*>(L.gb + col));
    }
  }
  const float gsv[4] = {gs.x, gs.y, gs.z, gs.w};
  const float gbv[4] = {gb.x, gb.y, gb.z, gb.w};
  for (int row0 = 0; row0 < M; row0 += BT / 16) {
    const int row = row0 + (threadIdx.x >> 4);
    const bool on = row < M && cv;
    float4 v = zero;
    if (on)
      v = sum_slices4(L.part_f + (size_t)row * L.n + col, S,
                      (size_t)M * L.n);
    const float h[4] = {v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w};
    if (!L.gs) {
      if (on)
        *reinterpret_cast<float4*>(L.out + (size_t)row * L.n + col) =
            make_float4(h[0], h[1], h[2], h[3]);
      continue;
    }
    if (on)
      *reinterpret_cast<float4*>(L.h + ((size_t)(t & 1) * M + row) * L.n +
                                 col) = make_float4(h[0], h[1], h[2], h[3]);
    const float inv_g = 1.f / (4 * lanes);
    const float mean = group_sum(h[0] + h[1] + h[2] + h[3], lanes) * inv_g;
    float cent[4], sq = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cent[e] = h[e] - mean;
      sq += cent[e] * cent[e];
    }
    const float rstd = 1.f / sqrtf(group_sum(sq, lanes) * inv_g + GN_EPS);
    if (!on) continue;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ye = cent[e] * rstd * gsv[e] + gbv[e];
      y[e] = ye > 0.f ? ye : 0.f;
    }
    *reinterpret_cast<float4*>(L.out + (size_t)row * L.n + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// Finish backward output slice s of layer l for step t: d(input) = the
// partials in order. z columns go into dz[t] (written by decoder layer 3,
// the first to finish, added to by layers 2, 1, 0); layer 0's other
// columns are dx; a hidden layer's become the previous layer's dh through
// the GroupNorm+ReLU VJP at its stored h.
__device__ void finish_bwd(const Params& P, const Layer* Ls, int l, int s,
                           int t) {
  const Layer& L = Ls[l];
  const int M = P.M, S = col_tiles(L), ld = L.ka + L.kz;
  const int kw = slice_rows(L, s), c0 = slice_row0(L, s);
  const int c = 4 * (threadIdx.x & 15);
  const bool zs = s >= act_slices(L);
  // a hidden layer's input columns: their GroupNorm affine (the previous
  // layer's output affine), loaded once
  float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), gb = gs;
  if (!zs && L.prev >= 0) {
    gs = __ldg(reinterpret_cast<const float4*>(Ls[L.prev].gs + c0 + c));
    gb = __ldg(reinterpret_cast<const float4*>(Ls[L.prev].gb + c0 + c));
  }
  const float gsv[4] = {gs.x, gs.y, gs.z, gs.w};
  const float gbv[4] = {gb.x, gb.y, gb.z, gb.w};
  for (int row0 = 0; row0 < M; row0 += BT / 16) {
    const int row = row0 + (threadIdx.x >> 4);
    const bool rv = row < M;
    if (zs || L.prev < 0) {
      // columns one by one: layer 0's rows (339, 387) are not aligned
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!rv || c + e >= kw) continue;
        const float v = sum_slices(L.part_b + (size_t)row * ld + c0 + c + e,
                                   S, (size_t)M * ld);
        if (zs) {
          float* d = P.dz + ((size_t)t * M + row) * LAT + c + e;
          *d = l == NL - 1 ? v : __ldcg(d) + v;
        } else {
          L.dh_out[(size_t)row * L.ka + c0 + c + e] = v;
        }
      }
      continue;
    }
    const Layer& Lp = Ls[L.prev];
    const int col = c0 + c;
    float4 da = make_float4(0.f, 0.f, 0.f, 0.f), hv = da;
    if (rv) {
      da = sum_slices4(L.part_b + (size_t)row * ld + col, S,
                       (size_t)M * ld);
      hv = __ldcg(reinterpret_cast<const float4*>(
          Lp.h + ((size_t)(t & 1) * M + row) * L.ka + col));
    }
    const int lanes = L.ka / GROUPS / 4;
    const float inv_g = 1.f / (4 * lanes);
    const float h[4] = {hv.x, hv.y, hv.z, hv.w};
    const float dav[4] = {da.x, da.y, da.z, da.w};
    const float mean = group_sum(h[0] + h[1] + h[2] + h[3], lanes) * inv_g;
    float cent[4], sq = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cent[e] = h[e] - mean;
      sq += cent[e] * cent[e];
    }
    const float r = 1.f / sqrtf(group_sum(sq, lanes) * inv_g + GN_EPS);
    float gg[4], gc = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = cent[e] * r * gsv[e] + gbv[e];
      gg[e] = (y > 0.f ? dav[e] : 0.f) * gsv[e];
      gc += gg[e] * cent[e];
    }
    const float mgc = group_sum(gc, lanes) * inv_g;
    float dcent[4], dc = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dcent[e] = r * gg[e] - r * r * r * cent[e] * mgc;
      dc += dcent[e];
    }
    const float mdc = group_sum(dc, lanes) * inv_g;
    if (rv)
      *reinterpret_cast<float4*>(L.dh_out + (size_t)row * L.ka + col) =
          make_float4(dcent[0] - mdc, dcent[1] - mdc, dcent[2] - mdc,
                      dcent[3] - mdc);
  }
}

// Phase k of iteration t: for every held tile, the recompute F_k of step t
// (t >= 0) and the backward B_k of step t + 1 (t + 1 < T) where its layer
// takes part. Units (tile, direction, row tile) run in order with NBUF - 1
// inputs in flight and store their partials; then each task arrives at
// its output tile's counter (one atomic a task, all at once), and the
// block finishes the output tiles dealt to it once all their K-slices
// have arrived.
__device__ void run_stage(const Params& P, const Layer* Ls,
                          const int (*own)[MAX_TILES], int n_own, int k,
                          int t, const float* tiles, float* ring,
                          StageLists& sl) {
  const int R = (P.M + RT - 1) / RT;
  // this block's tasks, (slot, direction) in slot order, and the phase's
  // output tiles in segments (layer, step, count), listed in shared memory
  // (a thread-local array indexed at run time would live in local memory,
  // which the large shared-memory carve-out leaves little L1 to cache)
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < n_own; ++i) {
      const int l = own[0][i];
      if (t >= 0 && (l == k || (k < 4 && l == 5 + k))) sl.tasks[n++] = 2 * i;
      if (t + 1 < P.T && (l == 4 - k || (k < 4 && l == 8 - k)))
        sl.tasks[n++] = 2 * i + 1;
    }
    sl.n = n;
    int nseg = 0;
    for (int dir = 0; dir < 2; ++dir) {
      const int step = dir ? t + 1 : t;
      if (step < 0 || step >= P.T) continue;
      for (int j = 0; j < (k < 4 ? 2 : 1); ++j) {
        const int l = dir ? (j ? 8 - k : 4 - k) : (j ? 5 + k : k);
        sl.seg_l[nseg] = dir ? -1 - l : l;   // negative: the backward's
        sl.seg_step[nseg] = step;
        sl.seg_n[nseg++] = dir ? slices(Ls[l]) : col_tiles(Ls[l]);
      }
    }
    sl.nseg = nseg;
  }
  __syncthreads();
  const int n = sl.n;
  const int* tasks = sl.tasks;
  const int units = n * R;
  auto unit = [&](int x) {
    Unit u;
    const int task = tasks[x / R];
    u.slot = task >> 1;
    u.bwd = task & 1;
    u.row0 = (x % R) * RT;
    u.step = u.bwd ? t + 1 : t;
    u.l = own[0][u.slot];
    u.s = own[1][u.slot];
    u.nn = own[2][u.slot];
    return u;
  };
  for (int x = 0; x < NBUF - 1; ++x) {
    if (x < units)
      stage_input(P, Ls, unit(x), ring + (x % NBUF) * RT * LD_IN);
    cp_async_commit();
  }
  for (int x = 0; x < units; ++x) {
    cp_async_wait<NBUF - 2>();
    __syncthreads();   // unit x staged; unit x - 1's buffer free
    const int nx = x + NBUF - 1;
    if (nx < units)
      stage_input(P, Ls, unit(nx), ring + (nx % NBUF) * RT * LD_IN);
    cp_async_commit();
    const Unit u = unit(x);
    unit_product(P, Ls, u, ring + (x % NBUF) * RT * LD_IN,
                 tiles + u.slot * TILE);
  }
  cp_async_wait<0>();
  // every partial of every task is stored: arrive
  __threadfence();
  __syncthreads();
  if ((int)threadIdx.x < n) {
    const Unit u = unit(threadIdx.x * R);
    const Layer& L = Ls[u.l];
    atomicAdd(u.bwd ? L.cnt_b + u.s : L.cnt_f + u.nn, 1);
  }
  // the phase's output tiles, dealt to the blocks from the last one down
  // (the products are dealt from the first): this block waits for each of
  // its tiles' K-slices to arrive and finishes it
  for (int i = gridDim.x - 1 - blockIdx.x;; i += gridDim.x) {
    int sg = 0, o = i;
    while (sg < sl.nseg && o >= sl.seg_n[sg]) o -= sl.seg_n[sg++];
    if (sg == sl.nseg) break;
    const bool bwd = sl.seg_l[sg] < 0;
    const int l = bwd ? -1 - sl.seg_l[sg] : sl.seg_l[sg];
    const Layer& L = Ls[l];
    if (threadIdx.x == 0) {
      int* cnt = bwd ? L.cnt_b + o : L.cnt_f + o;
      const int need = bwd ? col_tiles(L) : slices(L);
      while (ld_acquire(cnt) != need) {
      }
      *cnt = 0;
    }
    __syncthreads();
    __threadfence();
    if (bwd)
      finish_bwd(P, Ls, l, o, sl.seg_step[sg]);
    else
      finish_fwd(P, Ls, l, o, sl.seg_step[sg]);
    __syncthreads();
  }
}

// The carry cotangent entering the tail of the step before the one whose
// tail part is dprev: its tail part + (decoder + prior layer-0 parts).
__device__ __forceinline__ float carry_cot(const Layer* Ls, const float* dprev,
                                           int row, int i) {
  float v = __ldcg(dprev + (size_t)row * CW + i);
  if (i < D_X)
    v += __ldcg(Ls[5].dh_out + (size_t)row * D_X + i) +
         __ldcg(Ls[0].dh_out + (size_t)row * D_X + i);
  return v;
}

// One block a row: its threads gather the row's heads, carry cotangent,
// entry carry and output cotangent into shared memory (every load issued
// before the first store), then its first warp runs the tail VJP from
// there.
__device__ void tail_phase(const Params& P, const Layer* Ls, int t,
                           float* smem) {
  constexpr int N = RAW + PHEAD + 2 * CW + OUT_W;
  constexpr int PER = (N + BT - 1) / BT;
  const int M = P.M;
  float* sd = smem;               // decoder head
  float* sph = sd + RAW;          // prior head
  float* sdn = sph + PHEAD;       // the next carry's cotangent
  float* sc = sdn + CW;           // the entry carry
  float* sgo = sc + CW;           // the output cotangent
  const float* dprev = P.dcur[(t + 1) & 1];
  float* dnew = P.dcur[t & 1];
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const float* carry = P.saved + ((size_t)t * M + row) * CW;
    const float* go = P.dout + ((size_t)t * M + row) * OUT_W;
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BT;
      float x = 0.f;
      if (i < RAW) {
        x = __ldcg(Ls[8].out + (size_t)row * RAW + i);
      } else if (i < RAW + PHEAD) {
        x = __ldcg(Ls[4].out + (size_t)row * PHEAD + i - RAW);
      } else if (i < RAW + PHEAD + CW) {
        if (t != P.T - 1) x = carry_cot(Ls, dprev, row, i - RAW - PHEAD);
      } else if (i < RAW + PHEAD + 2 * CW) {
        x = __ldg(carry + i - RAW - PHEAD - CW);
      } else if (i < N) {
        x = __ldg(go + i - RAW - PHEAD - 2 * CW);
      }
      v[j] = x;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BT;
      if (i < N) smem[i] = v[j];
    }
    __syncthreads();
    if (threadIdx.x < 32)
      tail_vjp_row(threadIdx.x, sc, P.t2j + 3 * row, sd, sph, sgo, sdn,
                   dnew + (size_t)row * CW, P.ddraw + (size_t)row * RAW,
                   P.dp + (size_t)row * PHEAD, P.dt2j + 3 * row);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(BT, 1)
    rollout_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ float4 smem4[];
  // the layer table and the block's tiles, read from shared memory
  __shared__ Layer Ls[NL];
  __shared__ int own[3][MAX_TILES];
  __shared__ int n_own;
  __shared__ StageLists lists;
  float* tiles = reinterpret_cast<float*>(smem4);
  float* ring = tiles + MAX_TILES * TILE;
  cg::grid_group grid = cg::this_grid();
  for (int i = threadIdx.x; i < NL * (int)sizeof(Layer) / 4; i += BT)
    reinterpret_cast<int*>(Ls)[i] = reinterpret_cast<const int*>(P.L)[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int i = 0;
    for (int g = blockIdx.x; g < P.n_tiles && i < MAX_TILES;
         g += gridDim.x, ++i)
      own[0][i] = decode(Ls, g, &own[1][i], &own[2][i]);
    n_own = i;
  }
  for (int i = blockIdx.x * BT + threadIdx.x; i < P.n_counters;
       i += gridDim.x * BT)
    P.counters[i] = 0;
  for (int i = blockIdx.x * BT + threadIdx.x; i < 3 * P.M;
       i += gridDim.x * BT)
    P.dt2j[i] = 0.f;
  __syncthreads();
  load_tiles(Ls, own, n_own, tiles);
  grid.sync();
  // iteration t: the recompute of step t beside the backward of step t + 1,
  // then the tail of step t
  for (int t = P.T - 1; t >= -1; --t) {
    for (int k = 0; k < STAGES; ++k) {
      run_stage(P, Ls, own, n_own, k, t, tiles, ring, lists);
      grid.sync();
    }
    if (t >= 0) {
      tail_phase(P, Ls, t, ring);
      grid.sync();
    }
  }
  for (int i = blockIdx.x * BT + threadIdx.x; i < P.M * CW;
       i += gridDim.x * BT)
    P.dcarry0[i] = carry_cot(Ls, P.dcur[0], i / CW, i % CW);
}

// ---------------------------------------------------------------------------
// Host side: the layer table and the launch
// ---------------------------------------------------------------------------

// Hands out scratch in 16-byte-aligned pieces; with a null base it only
// counts.
struct Carver {
  uintptr_t base;
  size_t off;
  float* take(size_t n) {
    float* p = reinterpret_cast<float*>(base + off * sizeof(float));
    off += (n + 3) & ~size_t(3);
    return p;
  }
};

// Fills the layer table; returns the scratch floats it needs.
inline size_t build(Params& P, const RolloutWeights& w, float* scratch,
                    int M) {
  Carver cv{reinterpret_cast<uintptr_t>(scratch), 0};
  const int DW[4] = {HID, HID, 512, RAW};      // decoder layer widths
  for (int i = 0; i < NL; ++i) {
    Layer& L = P.L[i];
    L = Layer{};
    const bool prior = i < 5;
    const int j = prior ? i : i - 5;            // index within its MLP
    const int last = prior ? 4 : 3;
    L.w = prior ? w.pw[j] : w.dw[j];
    L.bias = prior ? w.pb[j] : w.db[j];
    if (j < last) {
      L.gs = prior ? w.pgs[j + 1] : w.dgs[j + 1];
      L.gb = prior ? w.pgb[j + 1] : w.dgb[j + 1];
    }
    L.n = prior ? (j < 4 ? HID : PHEAD) : DW[j];
    L.ka = j == 0 ? D_X : (prior ? HID : DW[j - 1]);
    L.kz = prior ? 0 : LAT;
    L.prev = j == 0 ? -1 : i - 1;
    if (j == 0) {
      L.in = P.saved;
      L.in_ld = CW;
      L.in_step = (long long)M * CW;
    } else {
      L.in = P.L[i - 1].out;
      L.in_ld = L.ka;
    }
    L.part_f = cv.take((size_t)slices(L) * M * L.n);
    L.part_b = cv.take((size_t)col_tiles(L) * M * (L.ka + L.kz));
    if (j < last) L.h = cv.take(2 * (size_t)M * L.n);
    L.out = cv.take((size_t)M * L.n);
    L.dh_out = cv.take((size_t)M * L.ka);
  }
  for (int k = 0; k < 2; ++k) P.dcur[k] = cv.take((size_t)M * CW);
  P.ddraw = cv.take((size_t)M * RAW);
  P.dp = cv.take((size_t)M * PHEAD);
  for (int i = 0; i < NL; ++i) {
    Layer& L = P.L[i];
    const bool head = i == 4 || i == NL - 1;
    L.dh_in = head ? (i == 4 ? P.dp : P.ddraw) : P.L[i + 1].dh_out;
  }
  // counters (ints) after the floats
  int n_cnt = 0;
  for (int i = 0; i < NL; ++i) n_cnt += col_tiles(P.L[i]) + slices(P.L[i]);
  int* cnt = reinterpret_cast<int*>(cv.take(n_cnt));
  P.counters = cnt;
  P.n_counters = n_cnt;
  for (int i = 0; i < NL; ++i) {
    P.L[i].cnt_f = cnt;
    cnt += col_tiles(P.L[i]);
    P.L[i].cnt_b = cnt;
    cnt += slices(P.L[i]);
  }
  // dealing order: layers of the same phases apart, so that every phase's
  // tiles spread evenly over the blocks
  const int order[NL] = {2, 6, 1, 7, 3, 5, 0, 4, 8};
  int g = 0;
  for (int i = 0; i < NL; ++i) {
    Layer& L = P.L[order[i]];
    L.tile0 = g;
    g += slices(L) * col_tiles(L);
  }
  P.n_tiles = g;
  return cv.off;
}

// Co-resident blocks on the current device, queried once a device after
// the dynamic shared-memory limit is set.
static cudaError_t grid_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    e = cudaFuncSetAttribute(rollout_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rollout_bwd_kernel, BT, SMEM_BYTES);
    if (e) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

}  // namespace humor

using namespace humor;

extern "C" {

long long rollout_bwd_scratch_floats(int M) {
  Params P = {};
  return (long long)build(P, RolloutWeights{}, nullptr, M);
}

// The grid of every launch (blocks), or minus the CUDA error of the query.
int rollout_bwd_grid_blocks(void) {
  int blocks = 0;
  const cudaError_t e = grid_blocks(&blocks);
  return e ? -(int)e : blocks;
}

int rollout_bwd_barriers_per_step(void) { return BARRIERS_PER_STEP; }

// saved (T, M, CW) entry carries from rollout_fwd, z (T, M, 48), t2j (M, 3),
// dout (T, M, OUT_W) -> dcarry0 (M, CW), dz (T, M, 48), dt2j (M, 3);
// scratch holds rollout_bwd_scratch_floats(M) floats, 16-byte aligned.
// Enqueues one cooperative launch on `stream` and nothing else, does not
// synchronise; returns the launch's error (0 = none), a refused launch
// included. A card whose blocks cannot hold every weight tile (fewer than
// 132 SMs) is refused with cudaErrorInvalidConfiguration.
int rollout_bwd(const RolloutWeights* w, const float* saved, const float* z,
                const float* t2j, const float* dout, float* dcarry0, float* dz,
                float* dt2j, float* scratch, int M, int T, void* stream) {
  if (M < 1 || T < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = grid_blocks(&blocks);
  if (e) return e;
  Params P = {};
  P.saved = saved; P.z = z; P.t2j = t2j; P.dout = dout;
  P.dcarry0 = dcarry0; P.dz = dz; P.dt2j = dt2j;
  P.M = M; P.T = T;
  build(P, *w, scratch, M);
  if ((P.n_tiles + blocks - 1) / blocks > MAX_TILES)
    return cudaErrorInvalidConfiguration;
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rollout_bwd_kernel),
                                  dim3(blocks), dim3(BT), args,
                                  (size_t)SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e) return e;
  return cudaGetLastError();
}

}  // extern "C"
