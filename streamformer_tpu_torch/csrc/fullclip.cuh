// The pipeline shared by the full-clip temporal kernels: C, the forward
// (temporal_fullclip.cu), and H, its backward (temporal_fullclip_bwd.cu).
// Each source wraps it in its own __global__ kernel and computes its own
// phases; the contracts are in those sources.
//
// Bound on the H100: bytes. A (b, n) row holds T frames of q, k, v (and g)
// for every head, and the work on them is a few fp32 FMAs a byte at T = 16.
// So the body keeps rows in flight and never waits for one before asking
// for the next:
//
// - The grid is persistent: as many blocks as fit on the card (two a
//   streaming multiprocessor where their shared memory allows), block b
//   taking work items b, b + grid, ... A work item is one (b, n) row and one
//   group of `hg` of its heads; `plan` takes the most heads an item whose
//   block leaves room for a second block on the SM, or else the most that
//   fit one block.
// - One producer warp copies, item after item, each operand's frame rows
//   (a span of hg * dh contiguous elements at element strides (sb, st, sn)
//   over (b, t, n)) with one bulk asynchronous copy each (cp.async.bulk,
//   completing on an mbarrier), into a ring of two shared-memory stages; it
//   refills a stage as soon as the consumers hand it back (another
//   mbarrier). So the kernels read their operands in place, in any layout
//   whose D axis is contiguous and whose spans and strides are multiples of
//   16 bytes: the (B, T, N, 3D) output of the qkv projection as well as
//   (R, T, D) rows. Every input byte is read from device memory once.
// - Eight consumer warps compute from shared memory with all their lanes:
//   the scores as one task per (head, query, group of four keys), a table
//   of the causal (query, group) pairs standing in for the triangle (of
//   every pair when the attention is not causal), so a task computes at
//   most three keys past its query (a group's tail, whose sums are
//   discarded); the softmax one thread per (head, query), straight-line
//   code up to 32 frames and a loop past them; the products one thread per
//   (two frames, head, 8 elements), so
//   that each staged chunk feeds two frames' sums, and neighbouring lanes
//   read neighbouring 16-byte chunks of a staged frame and write
//   neighbouring chunks of the output. A staged frame row is
//   padded by 16 bytes, so that lanes at one column of eight frames read
//   eight distinct bank groups.
//
// The order of arithmetic is the one decode_row.cuh keeps for a streamed
// frame (a linear stream equals the full clip bit for bit only while the two
// agree): per (row, head, query), each score is one sequential fp32 FMA
// chain over dh in element order, then times the scale; the max, then
// expf(s - max); a sequential sum in key order; PV one sequential FMA chain
// over the keys in order; one multiply by the reciprocal of the sum. Only
// independent chains run in parallel, and masked keys are skipped (a masked
// key's term is fmaf(0, v, acc) == acc).
//
// A clip of any length T takes this pipeline while one head's item fits a
// block (`plan`: the heads an item drop as T grows; one head fits up to
// T = 149 for C and 110 for H at heads of 64 in bf16, 66 and 49 at heads of
// 128 in fp32); past that C and H run tiled.cuh, which keeps this order of
// arithmetic on the CUDA cores: C's forward computes each score once,
// register-blocked, with a query tile's scores in shared memory (H's
// backward tiles both sides). kMaxT bounds the new frames of kernel E's
// whole-table body (temporal_append_pm.cu) only; past it E runs tiled.cuh
// too.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace fullclip {

constexpr int kConsumers = 256;            // eight consumer warps
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStages = 2;                 // of the ring
constexpr int kMaxT = 32;                  // E's whole-table frames; C's straight-line softmax
constexpr int kKeyGroup = 4;               // keys one score task takes
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block may use on sm_90
// Shared memory of a block that leaves room for a second on the SM: the
// SM's 233,472 bytes, less 1 KB the runtime keeps for each block, halved.
constexpr int kPairBudget = 233472 / 2 - 1024;

// Element strides of one operand over (b, t, n); its D axis is contiguous.
struct Operand {
  void* p;
  long long sb, st, sn;
};

// Operand o of a C entry's arguments: ptrs[o], strides[3 o .. 3 o + 2].
inline Operand operand(const void* const* ptrs, const long long* strides, int o) {
  return {const_cast<void*>(ptrs[o]), strides[3 * o], strides[3 * o + 1], strides[3 * o + 2]};
}

// Shared memory of a block: two stages of `ops` operands, each T frame rows
// of `row_bytes` (hg * dh elements, padded); then (hg, T, T + 1) fp32
// scores and, for H, as many dp values; the reciprocals of the sums
// (hg, T); the (query, key group) table, causal or whole; the barriers.
struct Plan {
  int hg, groups, row_bytes, op_bytes, stage_bytes, n_tri, ss;
  int scores, dps, inv, tri, full, empty, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Score tasks a head: the (query t, key group g) pairs with 4g <= t, or
// every pair (4g < T) when the attention is not causal.
__host__ __device__ inline int score_groups(int t_len, bool causal) {
  if (!causal) return t_len * ((t_len + kKeyGroup - 1) / kKeyGroup);
  int n = 0;
  for (int t = 0; t < t_len; ++t) n += t / kKeyGroup + 1;
  return n;
}

inline Plan plan_for(int hg, int heads, int t_len, int dh, int elt, int ops, bool dp,
                     bool causal) {
  Plan p;
  p.hg = hg;
  p.groups = heads / hg;
  p.row_bytes = round16(hg * dh * elt) + 16;
  p.op_bytes = t_len * p.row_bytes;
  p.stage_bytes = ops * p.op_bytes;
  p.n_tri = score_groups(t_len, causal);
  p.ss = t_len + 1;
  // each score region is followed by max(kMaxT, T) floats that a softmax
  // row, or the missing second query of a pair, may read past its last row
  // (and discard)
  const int scores = round16(4 * (hg * t_len * p.ss + (t_len > kMaxT ? t_len : kMaxT)));
  p.scores = kStages * p.stage_bytes;
  p.dps = p.scores + scores;
  p.inv = p.dps + (dp ? scores : 0);
  p.tri = p.inv + round16(4 * hg * t_len);
  p.full = p.tri + round16(4 * p.n_tri);
  p.empty = p.full + 8 * kStages;
  p.total = p.empty + 8 * kStages;
  return p;
}

// The most heads an item (a divisor of `heads`) whose block fits
// kPairBudget, else kMaxSmem; hg == 0 when not even one head fits.
inline Plan plan(int heads, int t_len, int dh, int elt, int ops, bool dp, bool causal) {
  for (int limit : {kPairBudget, kMaxSmem})
    for (int hg = heads; hg >= 1; --hg)
      if (heads % hg == 0) {
        const Plan p = plan_for(hg, heads, t_len, dh, elt, ops, dp, causal);
        if (p.total <= limit) return p;
      }
  Plan none = plan_for(1, heads, t_len, dh, elt, ops, dp, causal);
  none.hg = 0;
  return none;
}

template <int kOps>
struct Args {
  Operand in[kOps];  // q, k, v (and g)
  Operand out[3];    // out (C), or dq, dk, dv (H)
  Plan p;
  int items, n, t_len, dh, causal;
  float scale;
};

// The consumer warps' own barrier (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Element offset of column `col` of frame t of row `row` (b * n + n') in
// operand o.
__device__ __forceinline__ long long at(const Operand& o, int row, int n, int t, int col) {
  const int b = row / n;
  return b * o.sb + static_cast<long long>(t) * o.st + (row - b * n) * o.sn + col;
}

// Block set-up, by thread 0: the barriers and the score table (entry
// t << 8 | g, in query order; 4g <= t when causal). Every thread then meets
// at __syncthreads.
__device__ __forceinline__ void setup(unsigned char* smem, const Plan& p, int t_len, bool causal) {
  if (threadIdx.x == 0) {
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
    unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init_fence();
    int* tri = reinterpret_cast<int*>(smem + p.tri);
    for (int t = 0, i = 0; t < t_len; ++t)
      for (int g = 0; g * kKeyGroup <= (causal ? t : t_len - 1); ++g) tri[i++] = t << 8 | g;
  }
  __syncthreads();
}

// The producer warp: item after item, wait for its stage to be free, then
// announce the stage's bytes and copy each operand's T frame rows, the
// lanes sharing the copies.
template <typename T, int kOps>
__device__ __forceinline__ void produce(unsigned char* smem, const Args<kOps>& a) {
  const Plan& p = a.p;
  const int lane = threadIdx.x & 31;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  const int span = p.hg * a.dh * static_cast<int>(sizeof(T));
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    const int s = k % kStages;
    const int row = item / p.groups, col = (item - row * p.groups) * p.hg * a.dh;
    mbar_wait(empty + s, ((k / kStages) & 1) ^ 1);
    if (lane == 0) mbar_expect_tx(full + s, kOps * a.t_len * span);
    __syncwarp();
    unsigned char* stage = smem + s * p.stage_bytes;
    for (int c = lane; c < kOps * a.t_len; c += 32) {
      const int o = c / a.t_len, t = c - o * a.t_len;
      const T* src = static_cast<const T*>(a.in[o].p) + at(a.in[o], row, a.n, t, col);
      bulk_copy_g2s(stage + o * p.op_bytes + t * p.row_bytes, src, span, full + s);
    }
  }
}

// One score task: keys j0 .. j0 + nk - 1 of query t of one head, each one
// fp32 FMA chain over dh in element order; the query's chunk is loaded once
// for the group's keys. x holds the query rows, y the key rows (rows `rs`
// elements apart), acc the group's sums. The slots past nk repeat the last
// key (their sums are discarded), so the code has no branch, and two chunks
// are in flight at once. The two operands may differ in type (E's queries
// in the compute type, its keys in the cache's).
template <typename TX, typename TY>
__device__ __forceinline__ void dot_group(const TX* x, const TY* y, int rs, int nk, int dh,
                                          float (&acc)[kKeyGroup]) {
  const TY* yk[kKeyGroup];
#pragma unroll
  for (int kk = 0; kk < kKeyGroup; ++kk) {
    acc[kk] = 0.f;
    yk[kk] = y + min(kk, nk - 1) * rs;
  }
#pragma unroll 2
  for (int c = 0; c < dh; c += 8) {
    float xf[8];
    load8(x + c, xf);
#pragma unroll
    for (int kk = 0; kk < kKeyGroup; ++kk) {
      float yf[8];
      load8(yk[kk] + c, yf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[kk] = fmaf(xf[e], yf[e], acc[kk]);
    }
  }
}

// The exps of one (head, query t) row of scores (N >= T keys, sr[j] for j <=
// t valid): x[j] = expf(s_j - max) for j <= t and 0 past t; returns their
// sum in key order. Straight-line code: the row's loads go out together, the
// max is a tree (fmaxf is exact in any order), the exps are independent,
// and only the sum is a chain (adding the masked zeros changes nothing).
template <int N>
__device__ __forceinline__ float exps(const float* sr, int t, float (&x)[N]) {
  float mx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) mx[j] = x[j] = j <= t ? sr[j] : -INFINITY;
#pragma unroll
  for (int s = 1; s < N; s *= 2)
#pragma unroll
    for (int j = 0; j + s < N; j += 2 * s) mx[j] = fmaxf(mx[j], mx[j + s]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = expf(__fsub_rn(x[j], mx[0]));
    sum = __fadd_rn(sum, x[j]);
  }
  return sum;
}

// The same for a row of any length: the exps of keys 0 .. lim - 1 in place,
// their sum in key order returned (the max first, exact in any order).
__device__ __forceinline__ float exps_loop(float* sr, int lim) {
  float mx = -INFINITY;
  for (int j = 0; j < lim; ++j) mx = fmaxf(mx, sr[j]);
  float sum = 0.f;
  for (int j = 0; j < lim; ++j) {
    const float x = expf(__fsub_rn(sr[j], mx));
    sr[j] = x;
    sum = __fadd_rn(sum, x);
  }
  return sum;
}

}  // namespace fullclip
