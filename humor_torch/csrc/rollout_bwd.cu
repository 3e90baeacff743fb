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
// Design. The persistent machinery of rollout_persistent.cuh (shared with
// the forward): one block of 256 threads an SM, launched with
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident; the weights held in shared memory as 64 x 64 tiles loaded
// once per call; split-K products whose output tiles are finished, 16
// rows at a time, by dealt blocks after an integer-counter wait, in a
// fixed summation order.
// A tile serves both directions: the recompute's product reads its rows,
// the backward's transposed product (dh @ w^T) its columns.
// * The backward finish sums a slice's partials over the column tiles in
//   order: the GroupNorm+ReLU VJP at the stored pre-GroupNorm h, the z
//   columns into dz, layer 0's columns into dx.
// * Phases of a step: F0-F4 recompute (F_i runs prior layer i and decoder
//   layer i together), TL the tail VJP (one block a row), B0-B4 backward
//   (B_k runs prior layer 4-k and decoder layer 3-k transposed). The
//   recompute of step t needs only its saved carry, so it runs beside the
//   backward of step t + 1: iteration t is F_k(t) | B_k(t + 1) for k =
//   0..4, then TL(t). No grid barrier between phases
//   (rollout_persistent.cuh's ready counters): two a call, after the
//   weights are loaded and before d(carry0) is summed. h is kept in two copies, by step parity. The tail
//   of step t waits for both heads of step t and the layer-0 cotangents
//   of step t + 1 in its row tile; a head's transposed products for the
//   tail rows of their step.
// The counters and dt2j are zeroed in the kernel and dz is written before
// it is added to, so the C entry enqueues nothing but the launch.
//
// Why it is not nearer its bound: a step is a chain of latencies. At M=16
// a block waits for its inputs ~34 of the ~76 us a step
// (scripts/rollout_bwd_study.py): each layer costs its slowest producer's
// units, a signal (a fence, an L2 round trip) to the finisher, the
// finish's L2 reads (the partials, then the finished tile) and a signal to
// the next layer's blocks; and the tail's lane-0 part (root, heading,
// global transform) runs serially, one warp a row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o librollout_bwd.so rollout_bwd.cu

#include <cooperative_groups.h>
#include <stdint.h>

#include "rollout_common.cuh"
#include "rollout_persistent.cuh"

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

constexpr int STAGES = 5;
constexpr int BARRIERS_PER_CALL = 2;
static_assert(RAW + PHEAD + 2 * CW + OUT_W <= RING_FLOATS,
              "tail buffers fit");

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
  Counters cnt;
  int n_tiles, M, T;
};

// Finish rows row0..row0 + RT - 1 of backward output slice s of layer l for
// step t: d(input) = the partials in order. z columns go into dz[t] (written by decoder layer 3,
// the first to finish, added to by layers 2, 1, 0); layer 0's other
// columns are dx; a hidden layer's become the previous layer's dh through
// the GroupNorm+ReLU VJP at its stored h.
__device__ void finish_bwd(const Params& P, const Layer* Ls, int l, int s,
                           int t, int row0) {
  const Layer& L = Ls[l];
  const int M = P.M, S = col_tiles(L), ld = L.ka + L.kz;
  const int kw = slice_rows(L, s), c0 = slice_row0(L, s);
  const int c = 4 * (threadIdx.x & 15);
  const bool zs = s >= act_slices(L);
  // a hidden layer's input columns: their GroupNorm affine (the previous
  // layer's output affine)
  float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), gb = gs;
  if (!zs && L.prev >= 0) {
    gs = __ldg(reinterpret_cast<const float4*>(Ls[L.prev].gs + c0 + c));
    gb = __ldg(reinterpret_cast<const float4*>(Ls[L.prev].gb + c0 + c));
  }
  const float gsv[4] = {gs.x, gs.y, gs.z, gs.w};
  const float gbv[4] = {gb.x, gb.y, gb.z, gb.w};
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
    return;
  }
  const Layer& Lp = Ls[L.prev];
  const int col = c0 + c;
  float4 da = make_float4(0.f, 0.f, 0.f, 0.f), hv = da;
  if (rv) {
    da = sum_slices4(L.part_b + (size_t)row * ld + col, S, (size_t)M * ld);
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

// One block a row (always the same block's, so the tail part of the
// carry cotangent and dt2j it reads are its own): once both heads of step
// t are recomputed and the layer-0 cotangents of step t + 1 (both MLPs,
// and decoder layer 0's z columns, the last reader of the decoder head's
// cotangent) are finished in the row's row tile, its threads gather the
// row's heads, carry cotangent, entry carry and output cotangent into
// shared memory (every load issued before the first store), its first
// warp runs the tail VJP from there, and the row is published.
__device__ void tail_phase(const Params& P, BlockState& bs, int t,
                           float* smem) {
  constexpr int N = RAW + PHEAD + 2 * CW + OUT_W;
  constexpr int PER = (N + BT - 1) / BT;
  const Layer* Ls = bs.Ls;
  const int M = P.M;
  const int u = P.T - t;    // the step's use of its counters
  const int n8 = col_tiles(Ls[8]), n4 = col_tiles(Ls[4]);
  const int n0 = slices(Ls[0]), n5 = slices(Ls[5]);
  float* sd = smem;               // decoder head
  float* sph = sd + RAW;          // prior head
  float* sdn = sph + PHEAD;       // the next carry's cotangent
  float* sc = sdn + CW;           // the entry carry
  float* sgo = sc + CW;           // the output cotangent
  const float* dprev = P.dcur[(t + 1) & 1];
  float* dnew = P.dcur[t & 1];
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const int r = row / RT;
    wait_all(bs, n8 + n4 + n0 + n5, [&](int j, const int** p) {
      const int R = bs.R;
      if (j < n8) {
        *p = Ls[8].rdy_f + j * R + r;
        return u;
      }
      j -= n8;
      if (j < n4) {
        *p = Ls[4].rdy_f + j * R + r;
        return u;
      }
      j -= n4;
      *p = j < n0 ? Ls[0].rdy_b + j * R + r : Ls[5].rdy_b + (j - n0) * R + r;
      return u - 1;
    });
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
    publish_tail_row(bs, row);
  }
}

__global__ void __launch_bounds__(BT, 1)
    rollout_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ float4 smem4[];
  // the layer table, the block's tiles and a phase's lists
  __shared__ BlockState bs;
  float* tiles = reinterpret_cast<float*>(smem4);
  float* ring = tiles + MAX_TILES * TILE;
  cg::grid_group grid = cg::this_grid();
  for (int i = blockIdx.x * BT + threadIdx.x; i < 3 * P.M;
       i += gridDim.x * BT)
    P.dt2j[i] = 0.f;
  block_setup(P.L, P.n_tiles, P.cnt.base, P.cnt.n, P.cnt.tail, P.M, bs,
              tiles);
  grid.sync();   // counters and dt2j zeroed
  const Layer* Ls = bs.Ls;
  auto finish = [&](bool bwd, int l, int o, int step, int row0) {
    if (bwd)
      finish_bwd(P, Ls, l, o, step, row0);
    else
      finish_fwd(Ls, P.M, l, o, step, row0);
  };
  // iteration t: the recompute of step t beside the backward of step t + 1,
  // then the tail of step t. F_k: prior layer k, decoder layer k; B_k:
  // prior layer 4 - k, decoder layer 3 - k; a step's counters are used for
  // the (T - step)-th time.
  for (int t = P.T - 1; t >= -1; --t) {
    const int tb = t + 1;
    for (int k = 0; k < STAGES; ++k) {
      if (threadIdx.x == 0) {
        int n = 0;
        if (t >= 0) {
          const int u = P.T - t, in = k == 0 ? 0 : u;
          bs.plan.set(n++, k, false, t, u, in);
          if (k < 4) bs.plan.set(n++, 5 + k, false, t, u, in);
        }
        if (tb < P.T) {
          const int u = P.T - tb;
          bs.plan.set(n++, 4 - k, true, tb, u, u);
          if (k < 4) bs.plan.set(n++, 8 - k, true, tb, u, u);
        }
        bs.plan.n = n;
      }
      run_phase(bs, P.z, tiles, ring, finish);
    }
    if (t >= 0) tail_phase(P, bs, t, ring);
  }
  add_tally(bs, P.cnt.stats);
  grid.sync();   // every cotangent of step 0 written
  for (int i = blockIdx.x * BT + threadIdx.x; i < P.M * CW;
       i += gridDim.x * BT)
    P.dcarry0[i] = carry_cot(Ls, P.dcur[0], i / CW, i % CW);
}

// ---------------------------------------------------------------------------
// Host side: the layer table and the launch
// ---------------------------------------------------------------------------

// Fills the layer table; returns the scratch floats it needs.
inline size_t build(Params& P, const RolloutWeights& w, float* scratch,
                    int M) {
  Carver cv{reinterpret_cast<uintptr_t>(scratch), 0};
  P.n_tiles = build_layers(P.L, w, cv, M, true, &P.cnt);
  const int first[2] = {0, 5};   // layer 0 of each MLP
  for (int i : first) {
    P.L[i].in = P.saved;
    P.L[i].in_ld = CW;
    P.L[i].in_step = (long long)M * CW;
  }
  for (int k = 0; k < 2; ++k) P.dcur[k] = cv.take((size_t)M * CW);
  P.ddraw = cv.take((size_t)M * RAW);
  P.dp = cv.take((size_t)M * PHEAD);
  for (int i = 0; i < NL; ++i) {
    Layer& L = P.L[i];
    const bool head = i == 4 || i == NL - 1;
    L.dh_in = head ? (i == 4 ? P.dp : P.ddraw) : P.L[i + 1].dh_out;
  }
  return cv.off;
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
  const cudaError_t e =
      grid_blocks(reinterpret_cast<const void*>(rollout_bwd_kernel), &blocks);
  return e ? -(int)e : blocks;
}

int rollout_bwd_barriers_per_call(void) { return BARRIERS_PER_CALL; }

// saved (T, M, CW) entry carries from rollout_fwd, z (T, M, 48), t2j (M, 3),
// dout (T, M, OUT_W) -> dcarry0 (M, CW), dz (T, M, 48), dt2j (M, 3);
// scratch holds rollout_bwd_scratch_floats(M) floats, 16-byte aligned,
// and ends the call with its ready-waits and the ones that spun in its
// first two int32 (read only by a recording caller). Enqueues one
// cooperative launch on `stream` and nothing else, does not
// synchronise; returns the launch's error (0 = none), a refused launch
// included. A card whose blocks cannot hold every weight tile (fewer than
// 132 SMs) is refused with cudaErrorInvalidConfiguration.
int rollout_bwd(const RolloutWeights* w, const float* saved, const float* z,
                const float* t2j, const float* dout, float* dcarry0, float* dz,
                float* dt2j, float* scratch, int M, int T, void* stream) {
  if (M < 1 || T < 1) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(rollout_bwd_kernel);
  int blocks = 0;
  cudaError_t e = grid_blocks(kernel, &blocks);
  if (e) return e;
  Params P = {};
  P.saved = saved; P.z = z; P.t2j = t2j; P.dout = dout;
  P.dcarry0 = dcarry0; P.dz = dz; P.dt2j = dt2j;
  P.M = M; P.T = T;
  build(P, *w, scratch, M);
  return launch(kernel, P, P.n_tiles, blocks, stream);
}

}  // extern "C"
