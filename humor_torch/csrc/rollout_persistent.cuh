// The persistent machinery shared by the rollout kernels (rollout_fwd.cu,
// rollout_bwd.cu): one cooperative launch a rollout, one block of BT
// threads an SM, the 23 MB of weights cut into 64 x 64 tiles (1,452 of
// them), dealt round-robin to the blocks and held in shared memory for the
// whole call. A phase runs, for every tile a block holds whose layer takes
// part, the tile's product for each row tile of RT rows (the forward reads
// a tile's rows, the backward's transposed product its columns) and stores
// its K-slice's partial sums; each task then arrives at its output tile's
// integer counter, and each row tile of each output tile of the phase is
// dealt to one block, which waits for all the tile's K-slices and finishes
// those rows from the partials summed in slice order (a fixed order:
// repeats are bit-identical). The forward finish (bias, GroupNorm(16)+ReLU,
// or a head's output) is here; the backward's finish and both kernels'
// tails and schedules are in their own files.
//
// Dataflow, not barriers. No grid barrier separates the phases: every
// finish publishes its (layer, output tile, row tile) on a ready counter
// (`rdy_f`, `rdy_b`), and each tail row its row tile on the tail counter;
// every consumer waits for what it reads and every writer for the readers
// of what it overwrites. All counters count over the whole call: the g-th
// use of one is complete when it reads g (times the K-slices for an arrival
// counter, times the rows of the row tile for the tail's). The uses of a
// layer are numbered by step in the order the kernel runs them (the
// forward from step 0, the backward from step T - 1). The waits (`u` the
// waiting task's use, rows r):
//   * a product task, before the block stages its inputs: the finished
//     tiles of its input (the previous layer's output slice s, or
//     d(output) tile nn of the next layer; the tail's rows where it reads
//     the carry or a head's cotangent), and its own output tile's finish
//     of use u - 1, which has read the single buffer of partials it is
//     about to write;
//   * a finishing job: its tile's arrivals; before it overwrites a layer's
//     output (one copy), the readers of use u - 1 (the next layer's
//     product tasks, or the tail where a head is read by it); before it
//     overwrites the pre-GroupNorm h (two copies by step parity), the
//     backward finish that read use u - 2; a backward finish also the h it
//     reads, and a z slice the next decoder layer's z slice, which wrote
//     dz before it adds;
//   * a tail row (in its kernel's file): the heads of its step, and in the
//     backward the layer-0 cotangents of the step after.
// Every block runs its tasks in one order: step by step, phase by phase,
// a phase's products before its finishes, then the tail. Each wait points
// to a task earlier in that order, and a block signals a phase's products
// before it waits for any of the phase's finishes, and those finishes
// before it waits for the next phase, so, all blocks being co-resident (a
// cooperative launch), the earliest unfinished task can always run and no
// wait deadlocks. A block waits once for all its products of a phase (one
// round trip, whatever their number), arrives for all of them at once, and
// publishes all its finishes of the phase at once: each signal costs a
// fence, and a fence by a thread with copies in flight waits for them,
// so signals are few and fall where no copy is in flight (PERF.md has the
// designs that signalled more often and ran slower).
//
// Everything here has internal linkage (an unnamed namespace): each kernel
// library is one translation unit and gets its own copy, statics included,
// so two libraries loaded into one process share no C++ object.
//
// Scratch written inside a launch is read only through L2 (__ldcg or
// cp.async.cg), after an ld.acquire of its counter and a block barrier,
// never through the non-coherent read-only path or an L1-allocating copy;
// only the weights and the inputs are read that way. A writer's threads
// store and pass a block barrier; then one thread fences (acq_rel, not
// a fence by every thread) and adds to the counter.
#pragma once

#include <stdint.h>

#include "rollout_common.cuh"

namespace humor {
namespace {

constexpr int BT = 256;                // threads a block, one block an SM
constexpr int TK = 64;                 // weight tile: TK rows of w
constexpr int TN = 64;                 //   x TN columns
constexpr int TILE = TK * TN;
constexpr int RT = 16;                 // rows a row tile
constexpr int LD_IN = TK + 4;          // staged input: RT rows of TK (= TN)
constexpr int NBUF = 10;               // staged inputs in flight
constexpr int MAX_TILES = 11;          // weight tiles a block holds
constexpr int NL = 9;                  // prior layers 0-4, decoder 0-3
constexpr int MAX_SLICES = (HID + LAT + TK - 1) / TK;
constexpr int RING_FLOATS = NBUF * RT * LD_IN;
constexpr int SMEM_FLOATS = MAX_TILES * TILE + RING_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(TK == TN && TK == 64, "square tiles of 16 float4 columns");
static_assert(BT == 4 * (TN / 4) * (RT / 4), "thread = K quarter x 4 columns "
                                              "x 4 rows");
static_assert(BT == RT * (TN / 4), "a finish: a row tile of 16 float4 "
                                   "columns");
static_assert(SMEM_BYTES + 4096 <= 232448,
              "shared memory of one block, with the static tables");

// One layer: its weights and the buffers of its products. Forward:
// out (M, n) = in (M, ka [+ z 48]) @ w; backward: d(input) (M, ka [+ 48])
// = dh_in (M, n) @ w^T. The backward's fields are null in the forward.
struct Layer {
  const float* w;      // (ka + kz) x n
  const float* bias;   // n
  const float* gs;     // GroupNorm affine on the output (the next layer's
  const float* gb;     //   input), null for a head
  const float* in;     // forward input, rows of in_ld, + t * in_step
  long long in_step;
  const float* dh_in;  // backward input: d(output), M x n
  float* part_f;       // forward partials: slices x M x n
  float* part_b;       // backward partials: n tiles x M x (ka + kz)
  float* h;            // pre-GroupNorm output, 2 x M x n by step parity
                       //   (kept for the backward only)
  float* out;          // relu(GroupNorm(h)) (M x n), or a head's h at
                       //   out + t * out_step, rows of out_ld
  long long out_step;
  float* dh_out;       // d(input), M x ka: the previous layer's dh, or dx
  int* cnt_f;          // arrivals at each forward output tile, over the call
  int* cnt_b;          // arrivals at each backward output slice, likewise
  int* rdy_f;          // finished forward output tiles: tile x row tile
  int* rdy_b;          // finished backward output slices: slice x row tile
  int in_ld, ka, kz, n;
  int out_ld;
  int exp_col;         // a head's columns from here on are exp(h)
  int tile0;           // first index of its tiles in the dealing order
  int prev;            // the layer that feeds it, -1 for layer 0
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
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
// Adds 1 to a counter as a release of the block's stores: called by one
// thread after a block barrier that follows them (a fence by that thread
// alone, then a relaxed add).
__device__ __forceinline__ void release_add(int* p) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 [%0], 1;"
               ::"l"(p)
               : "memory");
}

// global -> shared, asynchronous, through L2 only: the first `bytes` (0-16)
// of the 16 copied, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes, zero-filled when !on; allocates in L1, so only for inputs of the
// launch
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
// output rows) read eight different banks both in the forward product
// (rows 4q + 16i + e) and in the backward (rows kg + 16j, float4 column
// q + 4i), and the input rows are read at four float4 columns 4 apart.
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

// A work unit: one direction of one held tile for one row tile; `e` is
// its entry in the phase's plan.
struct Unit {
  int l, s, nn, slot, bwd, e, row0, step;
};

// A task (a unit for every row tile), packed so that a unit's staging
// waits on one 8-byte shared-memory load: x = layer | K-slice << 4 |
// column tile << 9 | slot << 14 | backward << 18 | entry << 19, y = step.
static_assert(NL <= 16 && MAX_SLICES < 32 && HID / TN < 32 && MAX_TILES < 16,
              "task fields fit their bits");
__device__ __forceinline__ int2 pack_task(int l, int s, int nn, int slot,
                                          int bwd, int e, int step) {
  return make_int2(l | s << 4 | nn << 9 | slot << 14 | bwd << 18 | e << 19,
                   step);
}
__device__ __forceinline__ Unit unpack_task(int2 t, int row0) {
  Unit u;
  u.l = t.x & 15;
  u.s = (t.x >> 4) & 31;
  u.nn = (t.x >> 9) & 31;
  u.slot = (t.x >> 14) & 15;
  u.bwd = (t.x >> 18) & 1;
  u.e = (t.x >> 19) & 3;
  u.row0 = row0;
  u.step = t.y;
  return u;
}

struct StageLists {
  int2 tasks[2 * MAX_TILES];
  int seg_l[4], seg_bwd[4], seg_step[4], seg_n[4], seg_use[4];
  int n, nseg;
};

// A phase's products: up to four (layer, direction, step, use) entries;
// `use` counts the uses of the layer's counters in that direction so far,
// this one included, and `in_use` the use its input's counters must have
// reached (0: an input of the launch, no wait). Thread 0 fills it in
// shared memory, counting the entries in a register (a thread-local copy
// indexed at run time would live in local memory, read back through L2).
struct Plan {
  int l[4], bwd[4], step[4], use[4], in_use[4];
  int n;
  __device__ void set(int e, int layer, bool backward, int s, int u,
                      int in_u) {
    l[e] = layer;
    bwd[e] = backward;
    step[e] = s;
    use[e] = u;
    in_use[e] = in_u;
  }
};

// What a block keeps in shared memory for the whole call: the layer table,
// its tiles' (layer, K-slice, column tile), a phase's plan and lists, the
// tail counter, the rows and row tiles, and the block's wait tally
// (thread 0's).
struct BlockState {
  Layer Ls[NL];
  int own[3][MAX_TILES];
  int n_own;
  Plan plan;
  StageLists lists;
  int* tail;           // tail rows done in each row tile, over the call
  int M, R;
  int waits, stalled;
};

__device__ __forceinline__ int tile_rows(const BlockState& bs, int r) {
  return min(RT, bs.M - r * RT);
}

// Copies the layer table into shared memory, lists the block's tiles,
// zeroes the counters (grid-stride) and loads the block's tiles. The
// caller passes a grid barrier before any block waits on a counter.
__device__ void block_setup(const Layer* L, int n_tiles, int* counters,
                            int n_counters, int* tail, int M, BlockState& bs,
                            float* tiles) {
  for (int i = threadIdx.x; i < NL * (int)sizeof(Layer) / 4; i += BT)
    reinterpret_cast<int*>(bs.Ls)[i] = reinterpret_cast<const int*>(L)[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int i = 0;
    for (int g = blockIdx.x; g < n_tiles && i < MAX_TILES;
         g += gridDim.x, ++i)
      bs.own[0][i] = decode(bs.Ls, g, &bs.own[1][i], &bs.own[2][i]);
    bs.n_own = i;
    bs.tail = tail;
    bs.M = M;
    bs.R = (M + RT - 1) / RT;
    bs.waits = bs.stalled = 0;
  }
  for (int i = blockIdx.x * BT + threadIdx.x; i < n_counters;
       i += gridDim.x * BT)
    counters[i] = 0;
  __syncthreads();
  load_tiles(bs.Ls, bs.own, bs.n_own, tiles);
}

// Blocks until counter j of a wait reaches its need, for every j < n:
// at(j, &p) points p at counter j and returns its need (<= 0: none).
// Thread j looks at counter j (j + BT, ... beyond the block); a block
// barrier ends the wait. Thread 0 tallies the wait, and a stall where any
// counter was short at the first look.
template <class At>
__device__ void wait_all(BlockState& bs, int n, At at) {
  int spun = 0;
  for (int j = threadIdx.x; j < n; j += BT) {
    const int* p = nullptr;
    const int need = at(j, &p);
    if (need > 0 && ld_acquire(p) < need) {
      spun = 1;
      while (ld_relaxed(p) < need) {
      }
      ld_acquire(p);
    }
  }
  spun = __syncthreads_or(spun);
  if (threadIdx.x == 0) {
    ++bs.waits;
    bs.stalled += spun != 0;
  }
}

// Counter j < 2R of the wait of a product task (entry e of the plan, use
// u): j < R the finished input of row tile j, then the finish of use u - 1
// of its own output tile in row tile j - R. Returns the need (see the
// header).
__device__ __forceinline__ int task_dep(const BlockState& bs, const Unit& u,
                                        int j, const int** p) {
  const Layer& L = bs.Ls[u.l];
  const int R = bs.R, r = j % R;
  const int use = bs.plan.use[u.e], in_use = bs.plan.in_use[u.e];
  if (j >= R) {
    *p = (u.bwd ? L.rdy_b + u.s * R : L.rdy_f + u.nn * R) + r;
    return use - 1;
  }
  if (in_use <= 0) return 0;
  if (u.bwd) {
    if (L.gs == nullptr) {   // a head: d(output) from the tail
      *p = bs.tail + r;
      return in_use * tile_rows(bs, r);
    }
    *p = bs.Ls[u.l + 1].rdy_b + u.nn * R + r;
    return in_use;
  }
  if (u.s >= act_slices(L)) return 0;   // z
  if (L.prev < 0) {   // the carry, from the tail
    *p = bs.tail + r;
    return in_use * tile_rows(bs, r);
  }
  *p = bs.Ls[L.prev].rdy_f + u.s * R + r;
  return in_use;
}

// Counter j < FINISH_WAITS of a finishing job's wait (backward or
// forward, layer l, its output tile or slice `tile`, row tile r, use u):
// j = 0 its arrivals, then the guards of the header (at most a layer's
// slices and two more). Returns the need, or -1 past the last.
constexpr int FINISH_WAITS = 2 + MAX_SLICES;
__device__ int finish_dep(const BlockState& bs, bool bwd, int l, int tile,
                          int r, int u, int j, const int** p) {
  const Layer* Ls = bs.Ls;
  const Layer& L = Ls[l];
  const int R = bs.R;
  if (j == 0) {
    *p = bwd ? L.cnt_b + tile : L.cnt_f + tile;
    return (bwd ? col_tiles(L) : slices(L)) * u;
  }
  --j;
  if (!bwd) {
    if (L.gs != nullptr) {
      // relu(GN(h)): the next layer's products of use u - 1 read it
      const Layer& C = Ls[l + 1];
      if (j < col_tiles(C)) {
        *p = C.cnt_f + j;
        return slices(C) * (u - 1);
      }
      j -= col_tiles(C);
      // h of use u - 2 (same parity): read by the next layer's backward
      // finish of that use
      if (L.h != nullptr && j == 0) {
        *p = C.rdy_b + tile * R + r;
        return u - 2;
      }
      return -1;
    }
    if (L.out_step == 0 && j == 0) {   // a head's one copy: the tail reads it
      *p = bs.tail + r;
      return (u - 1) * tile_rows(bs, r);
    }
    return -1;
  }
  if (tile >= act_slices(L)) {
    // z columns: the next decoder layer wrote dz[step] first
    if (l + 1 < NL && j == 0) {
      const Layer& N = Ls[l + 1];
      *p = N.rdy_b + (slices(N) - 1) * R + r;
      return u;
    }
    return -1;
  }
  if (L.prev < 0) {
    // layer 0's d(input): the tail reads the step before's until it runs
    if (j == 0) {
      *p = bs.tail + r;
      return u * tile_rows(bs, r);
    }
    return -1;
  }
  const Layer& P = Ls[L.prev];
  if (j == 0) {   // the h this finish reads
    *p = P.rdy_f + tile * R + r;
    return u;
  }
  --j;
  if (j < slices(P)) {   // dh of use u - 1: read by the previous layer
    *p = P.cnt_b + j;
    return col_tiles(P) * (u - 1);
  }
  return -1;
}

// Start copying a unit's input (RT rows x 64 columns) into `buf`: the
// forward reads the K-slice s of its input (or z), the backward the
// column tile nn of d(output). Zero past M and past the slice's width.
__device__ void stage_input(const Layer* Ls, const Unit& u, int M,
                            const float* z, float* buf) {
  const Layer& L = Ls[u.l];
  const int r = threadIdx.x >> 4, c = 4 * (threadIdx.x & 15);
  const int row = u.row0 + r;
  const bool on = row < M;
  float* dst = buf + r * LD_IN + c;
  if (u.bwd) {
    const int nw = min(TN, L.n - u.nn * TN);
    const float* src = L.dh_in + (size_t)row * L.n + u.nn * TN + c;
    cp_async16(dst, on && c < nw ? src : L.dh_in, on && c < nw ? 16 : 0);
  } else if (u.s >= act_slices(L)) {
    const float* src = z + ((size_t)u.step * M + row) * LAT + c;
    cp_async16(dst, on && c < LAT ? src : z, on && c < LAT ? 16 : 0);
  } else {
    const int kw = slice_rows(L, u.s);
    const float* base = L.in + u.step * L.in_step;
    const float* src = base + (size_t)row * L.in_ld + u.s * TK + c;
    if (L.in_ld % 4 == 0) {
      // a slice's last vector may be partial (layer 0's 339 columns)
      const int b = on ? 4 * max(0, min(4, kw - c)) : 0;
      cp_async16(dst, b ? src : base, b);
    } else {   // rows of an input not 16-byte aligned (the saved carries)
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
__device__ void unit_product(const Layer* Ls, const Unit& u, int M,
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

// Finish rows row0..row0 + RT - 1 of forward output tile nn of layer l for
// step t (all K-slices have arrived): h = partials in slice order + bias; a
// head writes h (exp(h) from column exp_col on), a hidden layer
// relu(GroupNorm(h) * gs + gb) and, where the backward keeps it, h (its
// step's copy). A warp holds two rows; a GroupNorm group of 64 or 32
// columns is 16 or 8 lanes.
__device__ void finish_fwd(const Layer* Ls, int M, int l, int nn, int t,
                           int row0) {
  const Layer& L = Ls[l];
  const int S = slices(L);
  const int col = nn * TN + 4 * (threadIdx.x & 15);
  const bool cv = col < L.n;
  const int lanes = L.n / GROUPS / 4;
  // the column's bias and GroupNorm affine
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
  const int row = row0 + (threadIdx.x >> 4);
  const bool on = row < M && cv;
  float4 v = zero;
  if (on)
    v = sum_slices4(L.part_f + (size_t)row * L.n + col, S, (size_t)M * L.n);
  const float h[4] = {v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w};
  if (!L.gs) {
    if (on) {
      const bool ex = col >= L.exp_col;   // exp_col is a multiple of 4
      *reinterpret_cast<float4*>(L.out + t * L.out_step +
                                 (size_t)row * L.out_ld + col) =
          ex ? make_float4(expf(h[0]), expf(h[1]), expf(h[2]), expf(h[3]))
             : make_float4(h[0], h[1], h[2], h[3]);
    }
    return;
  }
  if (on && L.h)
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
  if (!on) return;
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ye = cent[e] * rstd * gsv[e] + gbv[e];
    y[e] = ye > 0.f ? ye : 0.f;
  }
  *reinterpret_cast<float4*>(L.out + (size_t)row * L.n + col) =
      make_float4(y[0], y[1], y[2], y[3]);
}

// The k-th finishing job of this block in the phase (the phase's jobs,
// output tile x row tile in segments, dealt from the last block down):
// its segment and its index there; false past the block's last.
__device__ __forceinline__ bool block_job(const StageLists& sl, int k,
                                          int* sg, int* o) {
  int i = gridDim.x - 1 - blockIdx.x + k * gridDim.x, g = 0;
  while (g < sl.nseg && i >= sl.seg_n[g]) i -= sl.seg_n[g++];
  *sg = g;
  *o = i;
  return g < sl.nseg;
}

// A phase of the block. Its products: for every held tile whose layer is
// in the block's plan (filled by thread 0 before the call), that entry's
// product (the forward reads the tile's rows, the backward's transposed
// product its columns), once every task's input is finished and its
// partials' buffer read (task_dep, one wait for all of them); units
// (task, row tile) run in order with NBUF - 1 inputs in flight and store
// their partials; then each task arrives at its output tile's counter.
// Its finishing jobs: each waits for its tile's K-slices and for the
// readers of what it overwrites (finish_dep), then finish(backward?,
// layer, tile, step, first row); once all are done they are published on
// their tiles' ready counters.
template <class Finish>
__device__ void run_phase(BlockState& bs, const float* z, const float* tiles,
                          float* ring, Finish finish) {
  const Layer* Ls = bs.Ls;
  const int (*own)[MAX_TILES] = bs.own;
  StageLists& sl = bs.lists;
  const int M = bs.M, R = bs.R;
  // this block's tasks, (slot, entry) in slot order, and the phase's
  // finishing jobs (output tile x row tile) in segments (layer, direction,
  // step, count, use), listed in shared memory by the first warp while the
  // others wait: lane i matches held tile i (at most MAX_TILES < 32)
  // against the plan, lane e < 4 builds entry e's segment. (A thread-local
  // array indexed at run time would live in local memory, which the large
  // shared-memory carve-out leaves little L1 to cache.)
  if (threadIdx.x < 32) {
    __syncwarp();   // the plan, filled by thread 0
    const int lane = threadIdx.x;
    const Plan& plan = bs.plan;
    const int np = plan.n;
    int pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pl[e] = e < np ? plan.l[e] : -1;
    // a tile's layer is in at most two entries (the same layer forward
    // and backward)
    int l = -1, s = 0, nn = 0, e1 = -1, e2 = -1;
    if (lane < bs.n_own) {
      l = own[0][lane];
      s = own[1][lane];
      nn = own[2][lane];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (l >= 0 && l == pl[e]) {
        if (e1 < 0)
          e1 = e;
        else
          e2 = e;
      }
    const unsigned b1 = __ballot_sync(0xffffffffu, e1 >= 0);
    const unsigned b2 = __ballot_sync(0xffffffffu, e2 >= 0);
    const unsigned below = (1u << lane) - 1;
    int at = __popc(b1 & below) + __popc(b2 & below);
    if (e1 >= 0)
      sl.tasks[at++] = pack_task(l, s, nn, lane, plan.bwd[e1], e1,
                                 plan.step[e1]);
    if (e2 >= 0)
      sl.tasks[at] = pack_task(l, s, nn, lane, plan.bwd[e2], e2,
                               plan.step[e2]);
    if (lane < np) {
      const int le = plan.l[lane];
      const Layer& L = Ls[le];
      const bool b = plan.bwd[lane];
      sl.seg_l[lane] = le;
      sl.seg_bwd[lane] = b;
      sl.seg_step[lane] = plan.step[lane];
      sl.seg_n[lane] = (b ? slices(L) : col_tiles(L)) * R;
      sl.seg_use[lane] = plan.use[lane];
    }
    if (lane == 0) {
      sl.n = __popc(b1) + __popc(b2);
      sl.nseg = np;
    }
  }
  __syncthreads();
  const int n = sl.n;
  const int2* tasks = sl.tasks;
  const int units = n * R;
  auto unit = [&](int x) { return unpack_task(tasks[x / R], (x % R) * RT); };
  // counter j % 2R of task j / 2R
  if (n > 0)
    wait_all(bs, 2 * R * n, [&](int j, const int** p) {
      return task_dep(bs, unpack_task(tasks[j / (2 * R)], 0), j % (2 * R),
                      p);
    });
  for (int x = 0; x < NBUF - 1; ++x) {
    if (x < units)
      stage_input(Ls, unit(x), M, z, ring + (x % NBUF) * RT * LD_IN);
    cp_async_commit();
  }
  for (int x = 0; x < units; ++x) {
    cp_async_wait<NBUF - 2>();
    __syncthreads();   // unit x staged; unit x - 1's buffer free
    const int nx = x + NBUF - 1;
    if (nx < units)
      stage_input(Ls, unit(nx), M, z, ring + (nx % NBUF) * RT * LD_IN);
    cp_async_commit();
    const Unit u = unit(x);
    unit_product(Ls, u, M, ring + (x % NBUF) * RT * LD_IN,
                 tiles + u.slot * TILE);
  }
  cp_async_wait<0>();
  // every partial of every task is stored: arrive (thread i for task i)
  __syncthreads();
  if ((int)threadIdx.x < n) {
    const Unit u = unpack_task(tasks[threadIdx.x], 0);
    const Layer& L = Ls[u.l];
    release_add(u.bwd ? L.cnt_b + u.s : L.cnt_f + u.nn);
  }
  int jobs = 0, sg, o;
  for (; block_job(sl, jobs, &sg, &o); ++jobs) {
    const bool bwd = sl.seg_bwd[sg];
    const int l = sl.seg_l[sg], use = sl.seg_use[sg];
    wait_all(bs, FINISH_WAITS, [&](int j, const int** p) {
      return finish_dep(bs, bwd, l, o / R, o % R, use, j, p);
    });
    finish(bwd, l, o / R, sl.seg_step[sg], (o % R) * RT);
  }
  // every job's rows are stored: publish (thread k for job k)
  __syncthreads();
  for (int k = threadIdx.x; k < jobs; k += BT) {
    block_job(sl, k, &sg, &o);
    const Layer& L = Ls[sl.seg_l[sg]];
    release_add((sl.seg_bwd[sg] ? L.rdy_b : L.rdy_f) + o);
  }
  __syncthreads();   // the lists read: the next phase may rewrite them
}

// Publishes a tail row of row tile r (after its stores) on the tail
// counter.
__device__ __forceinline__ void publish_tail_row(const BlockState& bs,
                                                 int row) {
  __syncthreads();
  if (threadIdx.x == 0) release_add(bs.tail + row / RT);
}

// ---------------------------------------------------------------------------
// Host side
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

// The call's integer counters, first in its scratch and zeroed in the
// kernel: the wait tally (scratch[0] waits and scratch[1] stalled waits,
// as int32, summed over the blocks at the end of the call), the tail
// counter (a row tile each), then each layer's arrival and ready counters.
struct Counters {
  int* base;
  int n;
  int* stats;
  int* tail;
};

// Fills the layer table (weights, widths, the counters, the forward's
// partials and outputs, with the backward's buffers where `bwd`) and the
// dealing order; the caller sets each layer-0 input and the backward's
// dh_in. Returns the number of tiles.
inline int build_layers(Layer* Ls, const RolloutWeights& w, Carver& cv,
                        int M, bool bwd, Counters* c) {
  const int DW[4] = {HID, HID, 512, RAW};      // decoder layer widths
  const int R = (M + RT - 1) / RT;
  for (int i = 0; i < NL; ++i) {
    Layer& L = Ls[i];
    L = Layer{};
    const bool prior = i < 5;
    const int j = prior ? i : i - 5;            // index within its MLP
    L.n = prior ? (j < 4 ? HID : PHEAD) : DW[j];
    L.ka = j == 0 ? D_X : (prior ? HID : DW[j - 1]);
    L.kz = prior ? 0 : LAT;
    L.prev = j == 0 ? -1 : i - 1;
  }
  // the counters (ints) before the floats
  int n_cnt = 2 + R;
  for (int i = 0; i < NL; ++i)
    n_cnt += (col_tiles(Ls[i]) + (bwd ? slices(Ls[i]) : 0)) * (1 + R);
  int* cnt = reinterpret_cast<int*>(cv.take(n_cnt));
  *c = Counters{cnt, n_cnt, cnt, cnt + 2};
  cnt += 2 + R;
  for (int i = 0; i < NL; ++i) {
    Layer& L = Ls[i];
    L.cnt_f = cnt;
    cnt += col_tiles(L);
    L.rdy_f = cnt;
    cnt += col_tiles(L) * R;
    if (bwd) {
      L.cnt_b = cnt;
      cnt += slices(L);
      L.rdy_b = cnt;
      cnt += slices(L) * R;
    }
  }
  for (int i = 0; i < NL; ++i) {
    Layer& L = Ls[i];
    const bool prior = i < 5;
    const int j = prior ? i : i - 5;
    const int last = prior ? 4 : 3;
    L.w = prior ? w.pw[j] : w.dw[j];
    L.bias = prior ? w.pb[j] : w.db[j];
    if (j < last) {
      L.gs = prior ? w.pgs[j + 1] : w.dgs[j + 1];
      L.gb = prior ? w.pgb[j + 1] : w.dgb[j + 1];
    }
    if (j > 0) {
      L.in = Ls[i - 1].out;
      L.in_ld = L.ka;
    }
    L.part_f = cv.take((size_t)slices(L) * M * L.n);
    if (bwd) {
      L.part_b = cv.take((size_t)col_tiles(L) * M * (L.ka + L.kz));
      if (j < last) L.h = cv.take(2 * (size_t)M * L.n);
    }
    L.out = cv.take((size_t)M * L.n);
    L.out_ld = L.n;
    L.exp_col = L.n;
    if (bwd) L.dh_out = cv.take((size_t)M * L.ka);
  }
  // dealing order: layers of the same phases apart, so that every phase's
  // tiles spread evenly over the blocks (for the forward's phases too: its
  // busiest block holds 2, 4, 3 and 3 tiles in phases 0-3, the prior head
  // in phase 0 included, the least that 132 blocks allow)
  const int order[NL] = {2, 6, 1, 7, 3, 5, 0, 4, 8};
  int g = 0;
  for (int i = 0; i < NL; ++i) {
    Layer& L = Ls[order[i]];
    L.tile0 = g;
    g += slices(L) * col_tiles(L);
  }
  return g;
}

// Adds the block's wait tally to the call's (after its last wait).
__device__ __forceinline__ void add_tally(const BlockState& bs, int* stats) {
  if (threadIdx.x == 0) {
    atomicAdd(stats, bs.waits);
    atomicAdd(stats + 1, bs.stalled);
  }
}

// Co-resident blocks of `kernel` on the current device, queried once a
// device after its dynamic shared-memory limit is set. The cache is this
// library's own (internal linkage, one cooperative kernel a library).
cudaError_t grid_blocks(const void* kernel, int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      BT, SMEM_BYTES);
    if (e) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

// Enqueues the cooperative launch of `kernel` with its one parameter block
// on `stream`: refused with cudaErrorInvalidConfiguration where the grid's
// blocks cannot hold every weight tile (fewer than 132 SMs).
template <class Params>
cudaError_t launch(const void* kernel, Params& P, int n_tiles, int blocks,
                   void* stream) {
  if ((n_tiles + blocks - 1) / blocks > MAX_TILES)
    return cudaErrorInvalidConfiguration;
  void* args[] = {&P};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(BT), args, (size_t)SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  if (e) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace humor
