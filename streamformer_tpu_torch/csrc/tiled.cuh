// Softmax attention over a sequence of any length, tiled, on the CUDA cores:
// the shapes past what the whole-row bodies hold in one block's shared
// memory. C and H (temporal_fullclip*.cu) take it once one head's (T x T)
// scores and its T frames no longer fit fullclip.cuh's plan; the fp32 bodies
// of B, L and I (spatial_flat*.cu) once N passes 256 keys a lane or the
// block's shared memory; E (temporal_append_pm.cu) past 32 new frames or its
// whole-table plan, with the cached prefix in front of the new frames.
//
// Operands are fullclip.cuh's: a base pointer and element strides over
// (b, t, n), D contiguous, row = b * n + n'; the sequence runs along t (the
// frames of C and H, the patches of B and I, as (R, N, D) rows with N = 1).
//
// The order of arithmetic is C's and H's (fullclip.cuh), so a tiled call
// gives the whole-row body's bits: per (head, query), each score is one
// sequential fp32 FMA chain over dh in element order, then times the scale;
// the max over the keys (exact in any order); then expf(s - max), their sum
// one sequential chain in key order, PV one sequential FMA chain in key
// order, and one multiply by the reciprocal of the sum. Masked keys are
// skipped. The backward repeats H's: p = expf(s - max) * (1 / sum), delta =
// sum_j p dp in key order, ds = p (dp - delta) scale, dq = sum_j ds k in key
// order (query side, which also writes max, 1/sum and delta, three fp32 a
// query); dk = sum_t ds q and dv = sum_t p g in query order (key side, a
// second launch reading those statistics). Each sum runs inside one thread
// in a fixed order, with no atomics, so two runs give the same bits. The
// exact softmax needs every score before the first exp. Those chains rule
// out the tensor cores (mma and wgmma sum in their own order), so both
// directions stay on the fp32 CUDA cores (67 TFLOP/s on the H100).
//
// Forward. Bound: operations where an item has many queries (C at T = 300:
// 1.4e10 FMAs, 0.41 ms), bytes where it has few (E at t = 1 reads every
// cached key once for one query). Scores are independent of each other and
// are computed once; only the sum and the PV chains are serial. Two bodies,
// chosen by the wrapper (ops._tiled_plan), one order of arithmetic:
//
// - Resident (more than four queries an item, while the scores of a tile
//   of 16 queries fit: keys up to about 3,200 at dh = 64 in bf16, 3,000 in
//   fp32): a block an item of (row, head, qt = 64, 32 or 16 queries). A
//   producer warp bulk-copies the tile's K rows, then its V rows, in tiles
//   of kKeyTile keys, into two stages on mbarriers, in their own type (bf16
//   stays bf16), rows padded by 16 bytes so that neighbouring keys fall in
//   distinct bank groups. Eight consumer warps compute every score of the
//   tile once, register-blocked: a thread owns qt / 16 queries x 4 keys
//   and walks dh in element order, each score its own chain, so that one
//   staged key row feeds qt / 16 chains and one query row four; the
//   (qt x keys) fp32 scores stay in shared memory. The max a warp a query
//   (shuffles), the exps by every thread, then PV: a thread owns two
//   queries' chains over 8 columns, so each staged V row feeds both, and
//   runs their sum chains beside them, key by key.
// - Split (few queries, as E's t = 1 step on a long cache, or scores past
//   shared memory): two launches over an fp32 scratch the wrapper
//   allocates. The scores: a block a (row, head, kSplitKeys keys), a thread
//   a key, reading its key row once and taking every query (kSplitQueries
//   at a time), so the card fills however few (row, head) items there are;
//   each block writes its scores and one partial max a query. Then PV: a
//   block a (row, head, kPvCols columns, kPvQueries queries), the max from
//   the partial maxima, the exps by every thread, and four chains a lane
//   (two queries' two columns, their sum chains beside them) streaming
//   whole head rows of V (DRAM serves a row's 128 bytes at once far better
//   than its halves) and the scores through three stages of cp.async, two
//   tiles ahead. The scratch holds t (keys + keys / 256) fp32 an item, T^2
//   for C at T frames: the wrapper caps it (ops._TILED_SCRATCH, 1 GiB), and
//   the pair of launches runs once for each chunk of as many whole items,
//   or of one item's queries, as it holds (forward_launch).
//
// Backward. Bound: operations, five dh-long FMA chains a visible (query,
// key) pair at the least (s, dp, dq, dk, dv): H at T = 300, causal, 3.4e10
// FMAs, 1.01 ms at 67 TFLOP/s; fp32 I at N = 576, 8.2e10, 2.43 ms. Two
// launches, the query side's statistics between them; ops._tiled_bwd_plan
// picks a plan of each side (two bits, backward()):
//
// - Query side, resident (dq_kernel): a block an item of (row, head, 32
//   queries). A producer warp bulk-copies the keys the tile sees, in stages
//   of kBwdKeys rows in their own type (bf16 stays bf16, rows padded by 16
//   bytes), three times over: K, V, K. Each score and each dp is computed
//   once, register-blocked (a thread owns 2 queries x 4 keys, so a staged
//   key row feeds two chains and a query row four), and kept: the tile's
//   (32 x keys) scores and dp in shared memory (to 701 keys at dh = 64 in
//   fp32, 797 in bf16). The max a warp a query (shuffles), the exps by the
//   warp's lanes, then 1/sum and delta a thread a query (the two serial
//   chains, each over the query's keys in key order: another block of the
//   SM computes beside them), ds by every thread in place of the exps, and
//   dq a thread a (2 queries, 4 columns) over the third pass's K. (16
//   queries a block, one chain a staged element, ran slower at every shape
//   tried: fp32 K rows are read from shared memory at 4.5 times the rate
//   the FMAs take them.)
// - Query side past shared memory (kBwdSweeps, dq_sweeps_kernel): the same
//   item and products, the keys swept four times, a stage's scores (and dp)
//   in a tile of shared memory: the max; the exps and the sum's chain; the
//   exps, dp and delta's chain; ds and dq. Seven chains a pair where the
//   resident side spends three (1.9x its time at T = 300), and no device
//   memory: it ran within 3 % of a query side keeping its scores and dp in
//   a scratch of device memory (PERF.md), which it replaced.
// - Key side (dkv_kernel): a block an item of (row, head, kBwdKeyTile
//   keys); query tiles of kBwdQueries rows of q and g stream through two
//   stages, and dk and dv run a thread two or four keys' 8 columns (the
//   head's two halves, so that eight lanes read one span of a staged row
//   and each row feeds every key), the two chains over the queries in
//   order. Their p and ds: stored (kBwdStored), the query side writes each
//   p and ds to a scratch (8 bytes a pair, 2 T^2 fp32 an item; both sides
//   launch over chunks of items under ops._TILED_SCRATCH) and the stages
//   bring the tile's rows of them beside q and g; else the block copies its
//   K and V rows once and recomputes s and dp (register-blocked, 2 queries
//   x 4 keys a thread), p and ds following from the statistics. The stored
//   key side ran 1.6-2.0x faster on the H100 at every shape measured (H at
//   T = 300 3.79 -> 1.96 ms; PERF.md): the recompute's two chains cost more
//   than moving 8 bytes a pair twice.
#pragma once

#include "fullclip.cuh"

namespace tiled {

struct Args {
  fullclip::Operand q, k, v, g;  // g: the output gradient (backward)
  fullclip::Operand o0, o1;      // out (forward), dq (query side), dk and dv (key side)
  float* stats;                  // (rows * heads, 3, len): max, 1/sum, delta (backward)
  int n, len, dh, heads, causal;
  float scale;
};

// Eight fp32 sums to operand o at (row, t, col), rounded to T.
template <typename T>
__device__ __forceinline__ void store_row8(const fullclip::Operand& o, int n, int row, int t,
                                           int col, const float* v) {
  store8(static_cast<T*>(o.p) + fullclip::at(o, row, n, t, col), v);
}

// Element (row, t, col) of operand o.
template <typename T>
__device__ __forceinline__ T* elem(const fullclip::Operand& o, int n, int row, int t, int col) {
  return static_cast<T*>(o.p) + fullclip::at(o, row, n, t, col);
}

// Four consecutive elements in fp32 (p 8- or 16-byte aligned), and four
// fp32 values stored as T.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v) {
  store2(p, make_float2(v[0], v[1]));
  store2(p + 2, make_float2(v[2], v[3]));
}

// One fp32 value stored as T (round to nearest even).
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---- forward: out = softmax(q k^T scale) v
//
// An item's keys are 0 .. n_keys - 1; a query reads its row through
// query(i) (a pointer to query i's head slice), a key through key(kv, j)
// (key j's head slice of K, kv 0, or V, kv 1), and the outputs go through
// store. Causal: query i sees keys <= i + off (off: the keys in front of
// the first query's own, E's cached prefix; 0 for C).

constexpr int kFwdConsumers = 256;               // eight consumer warps
constexpr int kFwdThreads = kFwdConsumers + 32;  // and the resident body's producer warp
constexpr int kFwdStages = 2;
constexpr int kKeyTile = 64;       // keys a stage of the resident body (4 a thread of a row)
constexpr int kSplitKeys = 256;    // keys a block of the split scores, one a thread
constexpr int kSplitQueries = 16;  // queries the split scores take at once
constexpr int kPvQueries = 16;     // queries a block of the split PV, two a warp
constexpr int kPvCols = 64;        // columns a block of the split PV, two a lane
constexpr int kPvStages = 3;       // of the split PV's ring: two tiles ahead

// Shared memory of a resident block (byte offsets): two stages of kKeyTile
// key rows (dh elements of the keys' type, padded by 16 bytes); the tile's
// queries in fp32 (rows of dh + 4); its (qt x ld) fp32 scores, ld = keys
// | 1 (odd: the rows of neighbouring queries fall in distinct banks); the
// barriers. ops._tiled_resident_smem repeats `total`.
struct Resident {
  int qt, row_bytes, stage_bytes, ld, qf, sc, full, empty, total;
};

__host__ __device__ inline Resident resident_plan(int qt, int keys, int dh, int elt) {
  Resident r;
  r.qt = qt;
  r.row_bytes = fullclip::round16(dh * elt) + 16;
  r.stage_bytes = kKeyTile * r.row_bytes;
  r.ld = keys | 1;
  r.qf = kFwdStages * r.stage_bytes;
  r.sc = r.qf + qt * (dh + 4) * 4;
  r.full = r.sc + fullclip::round16(4 * qt * r.ld);
  r.empty = r.full + 8 * kFwdStages;
  r.total = r.empty + 8 * kFwdStages;
  return r;
}

// PV over keys j0 .. j1 - 1 of one staged V tile (vs indexed by key, rows
// rs elements apart) for two queries (exps p0, p1 by key), columns c ..
// c + 7: each chain and each sum one sequential chain in key order.
template <typename TK>
__device__ __forceinline__ void pv2(const TK* vs, int rs, int c, int j0, int j1, const float* p0,
                                    const float* p1, float (&a0)[8], float (&a1)[8], float& s0,
                                    float& s1) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    float vf[8];
    load8(vs + j * rs + c, vf);
    const float x0 = p0[j], x1 = p1[j];
    s0 = __fadd_rn(s0, x0);
    s1 = __fadd_rn(s1, x1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a0[e] = fmaf(x0, vf[e], a0[e]);
      a1[e] = fmaf(x1, vf[e], a1[e]);
    }
  }
}

// The same for one query.
template <typename TK>
__device__ __forceinline__ void pv1(const TK* vs, int rs, int c, int j0, int j1, const float* p,
                                    float (&a)[8], float& s) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    float vf[8];
    load8(vs + j * rs + c, vf);
    const float x = p[j];
    s = __fadd_rn(s, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = fmaf(x, vf[e], a[e]);
  }
}

// The resident body: one item, queries t0 .. t0 + nt - 1 (nt <= r.qt = 16
// QB) of the queries' type TQ, keys of TK. Every thread of the block
// (kFwdThreads) calls it; the producer warp returns once its copies are
// issued.
template <typename TQ, typename TK, int QB, typename Query, typename Key, typename Store>
__device__ __forceinline__ void resident(unsigned char* smem, const Resident& r, int dh, int t0,
                                         int nt, int n_keys, bool causal, int off, float scale,
                                         Query query, Key key, Store store) {
  static_assert(QB == 1 || QB == 2 || QB == 4, "16 QB queries a tile");
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + r.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + r.empty);
  const int tid = threadIdx.x;
  const int kend = causal ? min(n_keys, t0 + nt + off) : n_keys;  // keys the tile sees
  const int nkt = (kend + kKeyTile - 1) / kKeyTile;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFwdConsumers / 32);  // a consumer warp's arrival each
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kFwdConsumers) {  // the producer warp: the K tiles, then the V tiles
    const int lane = tid & 31;
    const unsigned span = dh * static_cast<unsigned>(sizeof(TK));
    for (int g = 0; g < 2 * nkt; ++g) {
      const int s = g % kFwdStages, kv = g >= nkt;
      const int k0 = (g - kv * nkt) * kKeyTile, cnt = min(kKeyTile, kend - k0);
      mbar_wait(empty + s, ((g / kFwdStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + s, cnt * span);
      __syncwarp();
      unsigned char* st = smem + s * r.stage_bytes;
      for (int j = lane; j < cnt; j += 32)
        bulk_copy_g2s(st + j * r.row_bytes, key(kv, k0 + j), span, full + s);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, nc = dh / 8, qld = dh + 4;
  const int rs = r.row_bytes / static_cast<int>(sizeof(TK));  // elements between staged keys
  float* qf = reinterpret_cast<float*>(smem + r.qf);
  float* sc = reinterpret_cast<float*>(smem + r.sc);
  // the tile's queries in fp32, zeros past nt
  for (int w = tid; w < r.qt * nc; w += kFwdConsumers) {
    const int i = w / nc, c = (w - i * nc) * 8;
    float x[8];
    if (i < nt) {
      load8(query(t0 + i) + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    store8(qf + i * qld + c, x);
  }
  fullclip::consumers_sync();

  // scores: thread (tq, tk) owns queries tq + 16 a (a < QB) and keys tk +
  // 16 b (b < 4) of each tile
  {
    const int tq = tid >> 4, tk = tid & 15;
    const float* qs = qf + tq * qld;
    for (int g = 0; g < nkt; ++g) {
      const int s = g % kFwdStages, k0 = g * kKeyTile, k1 = min(k0 + kKeyTile, kend);
      mbar_wait(full + s, (g / kFwdStages) & 1);
      const TK* ks = reinterpret_cast<const TK*>(smem + s * r.stage_bytes) + tk * rs;
      float acc[QB][4];
#pragma unroll
      for (int a = 0; a < QB; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
      for (int e = 0; e < dh; e += 8) {
        float kf[4][8];
#pragma unroll
        for (int b = 0; b < 4; ++b) load8(ks + 16 * b * rs + e, kf[b]);
#pragma unroll
        for (int a = 0; a < QB; ++a) {
          float qv[8];
          load8(qs + 16 * a * qld + e, qv);
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[a][b] = fmaf(qv[x], kf[b][x], acc[a][b]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int a = 0; a < QB; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = tq + 16 * a, j = k0 + tk + 16 * b;
          if (i < nt && j < k1)
            sc[i * r.ld + j] =
                !causal || j <= t0 + i + off ? __fmul_rn(acc[a][b], scale) : -INFINITY;
        }
    }
  }
  fullclip::consumers_sync();

  // each query's max over its keys (a warp a query), then its exps in place
  for (int i = warp; i < nt; i += kFwdConsumers / 32) {
    const int lim = causal ? min(n_keys, t0 + i + off + 1) : n_keys;
    float* sr = sc + i * r.ld;
    float m = -INFINITY;
    for (int j = lane; j < lim; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    for (int j = lane; j < lim; j += 32) sr[j] = expf(__fsub_rn(sr[j], m));
  }
  fullclip::consumers_sync();

  // PV: unit w = (query pair qg, qg + half; columns c .. c + 7), at most two
  // a thread (qt = 64, dh = 128)
  const int half = r.qt / 2, units = half * nc;
  float acc[2][2][8], sum[2][2];
  int lim[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qg = (tid + u * kFwdConsumers) / nc;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int q = qg + half * f;
      sum[u][f] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][f][e] = 0.f;
      lim[u][f] = tid + u * kFwdConsumers < units && q < nt
                      ? (causal ? min(n_keys, t0 + q + off + 1) : n_keys)
                      : 0;
    }
  }
  for (int g = nkt; g < 2 * nkt; ++g) {
    const int s = g % kFwdStages, k0 = (g - nkt) * kKeyTile, k1 = min(k0 + kKeyTile, kend);
    mbar_wait(full + s, (g / kFwdStages) & 1);
    const TK* vs = reinterpret_cast<const TK*>(smem + s * r.stage_bytes) - k0 * rs;  // by key
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int w = tid + u * kFwdConsumers;
      if (w < units) {
        const int qg = w / nc, c = (w - qg * nc) * 8;
        const float* p0 = sc + qg * r.ld;
        const float* p1 = p0 + half * r.ld;
        // a later query sees at least the keys of an earlier one: both up
        // to the smaller limit, then the one with more keys alone
        const int l0 = lim[u][0], l1 = lim[u][1], both = min(k1, min(l0, l1));
        pv2(vs, rs, c, k0, both, p0, p1, acc[u][0], acc[u][1], sum[u][0], sum[u][1]);
        if (l1 > l0)
          pv1(vs, rs, c, max(k0, both), min(k1, l1), p1, acc[u][1], sum[u][1]);
        else
          pv1(vs, rs, c, max(k0, both), min(k1, l0), p0, acc[u][0], sum[u][0]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int w = tid + u * kFwdConsumers;
    if (w < units) {
      const int qg = w / nc, c = (w - qg * nc) * 8;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int q = qg + half * f;
        if (q < nt) {
          const float inv = __fdiv_rn(1.f, sum[u][f]);
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(acc[u][f][e], inv);
          store(t0 + q, c, o);
        }
      }
    }
  }
}

// The split body's plan for one pair of launches (scores, then PV): (row,
// head) items rh0 .. rh0 + items - 1, queries q0 .. q0 + nq - 1 of each.
// The scratch holds their scores, (items, nq, ls) fp32 (ls = keys rounded
// up to 4: 16-byte rows), then their partial maxima, (items, nq, nch), one a
// chunk of kSplitKeys keys; kt: keys a stage of the PV launch.
struct Split {
  float* scratch;
  int rh0, items, q0, nq, ls, nch, kt;
};

__host__ __device__ inline int split_ls(int keys) { return (keys + 3) / 4 * 4; }
__host__ __device__ inline int split_chunks(int keys) {
  return (keys + kSplitKeys - 1) / kSplitKeys;
}
// Shared memory of a split scores block: kSplitQueries fp32 query rows,
// then the warps' maxima.
inline int split_scores_smem(int dh) {
  return 4 * (kSplitQueries * (dh + 4) + kFwdConsumers / 32 * kSplitQueries);
}
// A PV stage: kt rows of kPvCols V elements, then the group's kt scores a
// query (min(nq, kPvQueries) queries); three stages, then the maxima.
__host__ __device__ inline int split_pv_stage(int kt, int nq, int elt) {
  return kt * kPvCols * elt + (nq < kPvQueries ? nq : kPvQueries) * kt * 4;
}
inline int split_pv_smem(int kt, int nq, int elt) {
  return kPvStages * split_pv_stage(kt, nq, elt) + 4 * kPvQueries;
}
// The PV launch's key tile: 512 keys, fewer where three stages would pass
// 105 KB (two blocks an SM) or the keys are fewer. Few queries stream the
// most keys a block: their chains wait on the copies two tiles ahead.
inline int split_pv_tile(int keys, int nq, int elt) {
  int kt = 512;
  while (kt > 32 && (kt / 2 >= keys || kPvStages * split_pv_stage(kt, nq, elt) > 105 * 1024))
    kt /= 2;
  return kt;
}
// Item rh's scores (its first query's row), and its partial maxima.
__device__ __forceinline__ float* split_scores_of(const Split& sp, int rh) {
  return sp.scratch + static_cast<long long>(rh - sp.rh0) * sp.nq * sp.ls;
}
__device__ __forceinline__ float* split_maxes_of(const Split& sp, int rh) {
  return sp.scratch + static_cast<long long>(sp.items) * sp.nq * sp.ls +
         static_cast<long long>(rh - sp.rh0) * sp.nq * sp.nch;
}

// The split scores of one item's queries qa .. qa + nq - 1 (of TQ) and one
// chunk of kSplitKeys keys: a thread a key, its row read once, every
// query's score one chain over dh (NQ queries at a time, NQ <=
// kSplitQueries), the visible ones to `scores` (row q - qa, ls apart), each
// query's max over the chunk's visible keys to maxes[(q - qa) * nch +
// chunk]. sm: split_scores_smem.
template <typename TQ, typename TK, int NQ, typename Query, typename Key>
__device__ __forceinline__ void split_scores(float* sm, int dh, int qa, int nq, int chunk,
                                             int n_keys, bool causal, int off, float scale,
                                             float* scores, int ls, float* maxes, int nch,
                                             Query query, Key key) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nc = dh / 8, qld = dh + 4;
  const int kend = causal ? min(n_keys, qa + nq + off) : n_keys;  // keys any query sees
  if (chunk * kSplitKeys >= kend) return;  // past the queries' keys (the whole block)
  const int j = chunk * kSplitKeys + tid;
  const bool on = j < kend;
  float* qf = sm;
  float* red = sm + kSplitQueries * qld;
  const TK* kr = key(0, on ? j : kend - 1);
  for (int g0 = 0; g0 < nq; g0 += NQ) {
    const int ng = min(NQ, nq - g0);
    __syncthreads();  // the previous group's queries and maxima are read
    for (int w = tid; w < ng * nc; w += kFwdConsumers) {
      const int i = w / nc, c = (w - i * nc) * 8;
      float x[8];
      load8(query(qa + g0 + i) + c, x);
      store8(qf + i * qld + c, x);
    }
    __syncthreads();
    float acc[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) acc[i] = 0.f;
    if (on) {
      constexpr int kUnroll = NQ <= 4 ? 8 : 4;  // the key row's loads in flight at once
#pragma unroll kUnroll
      for (int e = 0; e < dh; e += 8) {
        float kf[8];
        load8(kr + e, kf);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i < ng) {
            float qv[8];
            load8(qf + i * qld + e, qv);
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[i] = fmaf(qv[x], kf[x], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i < ng) {
        const int q = g0 + i;  // of the range
        const bool vis = on && (!causal || j <= qa + q + off);
        const float s = __fmul_rn(acc[i], scale);
        if (vis) scores[q * ls + j] = s;
        const float m = warp_max(vis ? s : -INFINITY);
        if (lane == 0) red[warp * kSplitQueries + i] = m;
      }
    }
    __syncthreads();
    if (tid < ng) {
      float m = red[tid];
      for (int w = 1; w < kFwdConsumers / 32; ++w) m = fmaxf(m, red[w * kSplitQueries + tid]);
      maxes[(g0 + tid) * nch + chunk] = m;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The split PV of one item's query group qa .. qa + nq - 1 (nq <=
// kPvQueries; warp w takes queries qa + w and qa + w + 8), columns c0 =
// slab kPvCols .. (two a lane, at most dh) of V (TV), outputs of TO through
// store(q, column, value); `scores` and `maxes` from query qa's row on.
// Each query's max from its chunks' partial maxima; then tile by tile (kt
// keys, three stages of cp.async two tiles ahead): the exps in place by
// every thread, then each lane's four PV chains and their queries' sum
// chains, key by key, so that each staged V element feeds two chains and
// each exp two. smem: split_pv_smem(kt, stage_q, sizeof(TV)), stage_q >= nq.
template <typename TO, typename TV, typename Key, typename Store>
__device__ __forceinline__ void split_pv(unsigned char* smem, int dh, int qa, int nq, int stage_q,
                                         int slab, int n_keys, bool causal, int off,
                                         const float* scores, int ls, const float* maxes, int nch,
                                         int kt, Key key, Store store) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = slab * kPvCols, cw = min(kPvCols, dh - c0);
  const int stage = split_pv_stage(kt, stage_q, sizeof(TV)), v_bytes = kt * kPvCols * sizeof(TV);
  float* mx = reinterpret_cast<float*>(smem + kPvStages * stage);
  auto lim_of = [&](int i) { return causal ? min(n_keys, qa + i + off + 1) : n_keys; };
  const int kend = lim_of(nq - 1);  // the group's last query sees the most keys
  for (int i = warp; i < nq; i += kFwdConsumers / 32) {  // the max over the query's chunks
    const int n = (lim_of(i) + kSplitKeys - 1) / kSplitKeys;
    float m = -INFINITY;
    for (int cc = lane; cc < n; cc += 32) m = fmaxf(m, maxes[i * nch + cc]);
    m = warp_max(m);  // exact in any order
    if (lane == 0) mx[i] = m;
  }
  const int ntl = (kend + kt - 1) / kt;
  constexpr int kPer = 16 / sizeof(TV);  // elements a 16-byte copy
  const int units = cw / kPer;           // of a slab row
  auto issue = [&](int it) {  // tile it's V columns and scores into stage it % kPvStages
    if (it < ntl) {
      const int k0 = it * kt, nk = min(kt, kend - k0);
      unsigned char* st = smem + (it % kPvStages) * stage;
      TV* vd = reinterpret_cast<TV*>(st);
      for (int w = tid; w < nk * units; w += kFwdConsumers) {
        const int jj = w / units, uu = w - jj * units;
        cp_async16(vd + jj * kPvCols + uu * kPer, key(1, k0 + jj) + c0 + uu * kPer);
      }
      float* sd = reinterpret_cast<float*>(st + v_bytes);
      const int n4 = (nk + 3) / 4;
      for (int w = tid; w < nq * n4; w += kFwdConsumers) {
        const int i = w / n4, u4 = w - i * n4;
        cp_async16(sd + i * kt + 4 * u4, scores + i * ls + k0 + 4 * u4);
      }
    }
    cp_async_commit();  // one group a tile, empty past the last
  };
  // warp w's queries i0 = w and i1 = w + 8 of the group; a later query sees
  // at least an earlier one's keys: both up to the smaller limit, then the
  // one with more alone
  const int i0 = warp, i1 = warp + kFwdConsumers / 32;
  const bool chain = i0 < nq && 2 * lane < cw, two = i1 < nq;
  const int l0 = i0 < nq ? lim_of(i0) : 0, l1 = two ? lim_of(i1) : 0;
  float2 a0 = make_float2(0.f, 0.f), a1 = a0;
  float s0 = 0.f, s1 = 0.f;
  issue(0);
  issue(1);
  for (int it = 0; it < ntl; ++it) {
    const int k0 = it * kt, nk = min(kt, kend - k0);
    cp_async_wait_one();  // this thread's copies of tile it have landed
    __syncthreads();      // everyone's; and every chain is done with tile it - 1's stage
    issue(it + 2);
    unsigned char* st = smem + (it % kPvStages) * stage;
    float* xs = reinterpret_cast<float*>(st + v_bytes);
    for (int w = tid; w < nq * kt; w += kFwdConsumers) {
      const int i = w / kt, jj = w - i * kt;
      if (jj < nk && k0 + jj < lim_of(i)) xs[w] = expf(__fsub_rn(xs[w], mx[i]));
    }
    __syncthreads();
    if (chain) {
      const TV* vv = reinterpret_cast<const TV*>(st) + 2 * lane;
      const float* x0 = xs + i0 * kt;
      const float* x1 = xs + (two ? i1 : i0) * kt;
      const int both = min(nk, min(l0, l1) - k0), more = min(nk, max(l0, l1) - k0);
#pragma unroll 8
      for (int jj = 0; jj < both; ++jj) {
        const float2 v = load2(vv + jj * kPvCols);
        const float y0 = x0[jj], y1 = x1[jj];
        s0 = __fadd_rn(s0, y0);
        s1 = __fadd_rn(s1, y1);
        a0.x = fmaf(y0, v.x, a0.x);
        a0.y = fmaf(y0, v.y, a0.y);
        a1.x = fmaf(y1, v.x, a1.x);
        a1.y = fmaf(y1, v.y, a1.y);
      }
      if (l1 > l0) {
#pragma unroll 8
        for (int jj = max(both, 0); jj < more; ++jj) {
          const float2 v = load2(vv + jj * kPvCols);
          const float y1 = x1[jj];
          s1 = __fadd_rn(s1, y1);
          a1.x = fmaf(y1, v.x, a1.x);
          a1.y = fmaf(y1, v.y, a1.y);
        }
      } else {
#pragma unroll 8
        for (int jj = max(both, 0); jj < more; ++jj) {
          const float2 v = load2(vv + jj * kPvCols);
          const float y0 = x0[jj];
          s0 = __fadd_rn(s0, y0);
          a0.x = fmaf(y0, v.x, a0.x);
          a0.y = fmaf(y0, v.y, a0.y);
        }
      }
    }
  }
  if (chain) {
    const int c = c0 + 2 * lane;
    const float inv0 = __fdiv_rn(1.f, s0);
    store(qa + i0, c, __fmul_rn(a0.x, inv0));
    store(qa + i0, c + 1, __fmul_rn(a0.y, inv0));
    if (two) {
      const float inv1 = __fdiv_rn(1.f, s1);
      store(qa + i1, c, __fmul_rn(a1.x, inv1));
      store(qa + i1, c + 1, __fmul_rn(a1.y, inv1));
    }
  }
}

// ---- C's, B's and L's forward on these bodies: rows of `a.len` positions,
// queries and keys alike

template <typename T, int QB>
__global__ void __launch_bounds__(kFwdThreads) forward_resident_kernel(const Args a,
                                                                       const Resident r) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = (a.len + r.qt - 1) / r.qt;
  const int rh = blockIdx.x / tiles, row = rh / a.heads, col = (rh - row * a.heads) * a.dh;
  const int t0 = (blockIdx.x - rh * tiles) * r.qt;
  resident<T, T, QB>(
      smem, r, a.dh, t0, min(r.qt, a.len - t0), a.len, a.causal, 0, a.scale,
      [&](int i) -> const T* { return elem<T>(a.q, a.n, row, i, col); },
      [&](int kv, int j) -> const T* { return elem<T>(kv ? a.v : a.k, a.n, row, j, col); },
      [&](int i, int c, const float* v) { store_row8<T>(a.o0, a.n, row, i, col + c, v); });
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kFwdConsumers) forward_scores_kernel(const Args a,
                                                                       const Split sp) {
  extern __shared__ __align__(16) float smf[];
  const int rh = sp.rh0 + static_cast<int>(blockIdx.x) / sp.nch;
  const int chunk = static_cast<int>(blockIdx.x) % sp.nch;
  const int row = rh / a.heads, col = (rh - row * a.heads) * a.dh;
  split_scores<T, T, NQ>(
      smf, a.dh, sp.q0, sp.nq, chunk, a.len, a.causal, 0, a.scale, split_scores_of(sp, rh),
      sp.ls, split_maxes_of(sp, rh), sp.nch,
      [&](int i) -> const T* { return elem<T>(a.q, a.n, row, i, col); },
      [&](int, int j) -> const T* { return elem<T>(a.k, a.n, row, j, col); });
}

// A split PV block's (item, query group, slab of kPvCols columns), and its
// group's first query and count.
struct PvBlock {
  int rh, slab, qa, nq, first;  // first: the offset of qa's row in the launch's scratch
};

__device__ __forceinline__ PvBlock pv_block(const Split& sp, int dh) {
  const int slabs = (dh + kPvCols - 1) / kPvCols;
  const int per = slabs * ((sp.nq + kPvQueries - 1) / kPvQueries);
  const int w = static_cast<int>(blockIdx.x) % per, qg = w / slabs;
  PvBlock b;
  b.rh = sp.rh0 + static_cast<int>(blockIdx.x) / per;
  b.slab = w - qg * slabs;
  b.first = qg * kPvQueries;
  b.qa = sp.q0 + b.first;
  b.nq = min(kPvQueries, sp.nq - b.first);
  return b;
}

template <typename T>
__global__ void __launch_bounds__(kFwdConsumers) forward_pv_kernel(const Args a, const Split sp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PvBlock b = pv_block(sp, a.dh);
  const int row = b.rh / a.heads, col = (b.rh - row * a.heads) * a.dh;
  split_pv<T, T>(
      smem, a.dh, b.qa, b.nq, sp.nq, b.slab, a.len, a.causal, 0,
      split_scores_of(sp, b.rh) + b.first * sp.ls, sp.ls,
      split_maxes_of(sp, b.rh) + b.first * sp.nch, sp.nch, sp.kt,
      [&](int, int j) -> const T* { return elem<T>(a.v, a.n, row, j, col); },
      [&](int i, int c, float v) { store1(elem<T>(a.o0, a.n, row, i, col + c), v); });
}

// A launch of `grid` blocks of `threads` with `smem` bytes of dynamic
// shared memory (the attribute set first: past 48 KB a launch needs it).
template <typename Kernel, typename... KArgs>
inline int launch_grid(Kernel kernel, int smem, unsigned grid, int threads, cudaStream_t stream,
                       const KArgs&... args) {
  if (smem > fullclip::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The forward on these bodies, C's and E's alike: `items` (row, head) items
// of t queries against at most `keys` keys of `elt` bytes, every kernel
// taking (args, plan). qt = 16, 32 or 64: the resident body at qt queries a
// block (res16, res32, res64). qt = 0: the split body on `scratch`, `floats`
// fp32 (ops._tiled_scratch's size): its scores launch (sc1, sc4 or sc16, by
// the queries it takes at once), then its PV launch, once for each chunk of
// as many whole items as the scratch holds, or, where it holds less than one
// item, of as many of an item's queries; a scratch that does not hold one
// query's scores is refused.
template <typename A, typename R16, typename R32, typename R64, typename S1, typename S4,
          typename S16, typename P>
int forward_launch(const A& a, unsigned items, int t, int keys, int dh, int elt, int qt,
                   float* scratch, long long floats, cudaStream_t stream, R16 res16, R32 res32,
                   R64 res64, S1 sc1, S4 sc4, S16 sc16, P pv) {
  if (dh % 8 || dh > 128 || t < 1 || keys < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (qt) {
    const Resident r = resident_plan(qt, keys, dh, elt);
    const unsigned grid = items * ((t + qt - 1) / qt);
    if (qt == 64) return launch_grid(res64, r.total, grid, kFwdThreads, stream, a, r);
    if (qt == 32) return launch_grid(res32, r.total, grid, kFwdThreads, stream, a, r);
    if (qt == 16) return launch_grid(res16, r.total, grid, kFwdThreads, stream, a, r);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Split sp;
  sp.scratch = scratch;
  sp.ls = split_ls(keys);
  sp.nch = split_chunks(keys);
  const long long per_q = sp.ls + sp.nch, per_item = per_q * t;
  if (!scratch || floats < per_q) return static_cast<int>(cudaErrorInvalidValue);
  const bool whole = floats >= per_item;  // whole items a launch, else queries of one
  const long long fit = whole ? floats / per_item : 1;
  const int ic = static_cast<int>(fit < items ? fit : items);
  const int qc = whole ? t : static_cast<int>(floats / per_q);
  sp.kt = split_pv_tile(keys, qc, elt);
  const int slabs = (dh + kPvCols - 1) / kPvCols, ss = split_scores_smem(dh);
  for (unsigned i0 = 0; i0 < items; i0 += ic) {
    sp.rh0 = static_cast<int>(i0);
    sp.items = static_cast<int>(items - i0 < static_cast<unsigned>(ic) ? items - i0 : ic);
    for (sp.q0 = 0; sp.q0 < t; sp.q0 += qc) {
      sp.nq = t - sp.q0 < qc ? t - sp.q0 : qc;
      const unsigned sgrid = static_cast<unsigned>(sp.items) * sp.nch;
      int rc = sp.nq == 1  ? launch_grid(sc1, ss, sgrid, kFwdConsumers, stream, a, sp)
               : sp.nq <= 4 ? launch_grid(sc4, ss, sgrid, kFwdConsumers, stream, a, sp)
                            : launch_grid(sc16, ss, sgrid, kFwdConsumers, stream, a, sp);
      if (rc) return rc;
      const unsigned pgrid =
          static_cast<unsigned>(sp.items) * slabs * ((sp.nq + kPvQueries - 1) / kPvQueries);
      rc = launch_grid(pv, split_pv_smem(sp.kt, sp.nq, elt), pgrid, kFwdConsumers, stream, a, sp);
      if (rc) return rc;
    }
  }
  return 0;
}

// out (a.o0) = attention of a.q, a.k, a.v; rows: the operands' rows (b * n);
// qt, scratch, floats: forward_launch's.
template <typename T>
int forward(int rows, const Args& a, int qt, float* scratch, long long floats,
            cudaStream_t stream) {
  return forward_launch(a, static_cast<unsigned>(rows) * a.heads, a.len, a.len, a.dh, sizeof(T),
                        qt, scratch, floats, stream, forward_resident_kernel<T, 1>,
                        forward_resident_kernel<T, 2>, forward_resident_kernel<T, 4>,
                        forward_scores_kernel<T, 1>, forward_scores_kernel<T, 4>,
                        forward_scores_kernel<T, kSplitQueries>, forward_pv_kernel<T>);
}

// ---- backward: dq and each query's max, 1/sum and delta on the query
// side, then dk and dv on the key side (the design is in the header).

constexpr int kBwdQt = 32;       // query side: queries a block, two a thread of 16
constexpr int kBwdKeys = 64;     // query side: keys a stage, four a thread of 16
constexpr int kBwdQueries = 32;  // key side: queries a stage, two a thread of 16
constexpr int kBwdKeyTile = 64;  // key side: keys a block, four a thread of 16
constexpr int kBwdLd = kBwdQueries + 1;  // row of the key side's (keys x queries) p and ds
constexpr int kSweepLd = kBwdKeys + 1;   // row of the sweeping query side's (queries x keys) tile

// The backward's plan (the `plan` of backward(), ops._tiled_bwd_plan), two
// bits: kBwdSweeps, the query side recomputing its scores and dp in four
// sweeps over the keys (past shared memory), else keeping them in shared
// memory; kBwdStored, the key side reading p and ds that the query side
// writes to a scratch, else recomputing s and dp.
constexpr int kBwdSweeps = 1, kBwdStored = 2;

// Floats between two queries' rows of the stored p (and of ds): len rounded
// up to 4, so that a key tile's span of a row is one 16-byte aligned copy.
__host__ __device__ inline int stored_ld(int len) { return (len + 3) / 4 * 4; }

// Query side's shared memory (byte offsets): two stages of kBwdKeys rows of
// K or V in their own type (rows padded by 16 bytes against bank
// conflicts); the tile's kBwdQt query and output-gradient rows, in their
// own type; the (kBwdQt x ld) fp32 scores, which become the exps and then
// ds, and dp, ld = keys | 1 (odd: neighbouring queries' rows in distinct
// banks); each query's max, 1/sum and delta; the barriers.
// ops._tiled_bwd_plan asks for `total` (sf_tiled_plan).
struct DqPlan {
  int rb, ld, qs, gs, sc, dc, stat, full, empty, total;
};

__host__ __device__ inline DqPlan dq_plan(int keys, int dh, int elt) {
  constexpr int qt = kBwdQt;
  DqPlan p;
  p.rb = fullclip::round16(dh * elt) + 16;
  p.ld = keys | 1;
  p.qs = kFwdStages * kBwdKeys * p.rb;
  p.gs = p.qs + qt * p.rb;
  p.sc = p.gs + qt * p.rb;
  p.dc = p.sc + fullclip::round16(4 * qt * p.ld);
  p.stat = p.dc + fullclip::round16(4 * qt * p.ld);
  p.full = p.stat + fullclip::round16(4 * 3 * qt);
  p.empty = p.full + 8 * kFwdStages;
  p.total = p.empty + 8 * kFwdStages;
  return p;
}

// The sweeping query side's: two stages of kBwdKeys rows of K, then as many
// of V (the last two sweeps); the tile's query and output-gradient rows;
// one stage's (kBwdQt x kSweepLd) fp32 scores (or exps, or ds) and dp; the
// statistics; the barriers.
__host__ __device__ inline DqPlan sweep_plan(int dh, int elt) {
  constexpr int qt = kBwdQt;
  DqPlan p;
  p.rb = fullclip::round16(dh * elt) + 16;
  p.ld = kSweepLd;
  p.qs = kFwdStages * 2 * kBwdKeys * p.rb;
  p.gs = p.qs + qt * p.rb;
  p.sc = p.gs + qt * p.rb;
  p.dc = p.sc + fullclip::round16(4 * qt * p.ld);
  p.stat = p.dc + fullclip::round16(4 * qt * p.ld);
  p.full = p.stat + fullclip::round16(4 * 3 * qt);
  p.empty = p.full + 8 * kFwdStages;
  p.total = p.empty + 8 * kFwdStages;
  return p;
}

// Key side's: (recomputing) the block's kBwdKeyTile rows of K, then of V;
// two stages of kBwdQueries query rows and as many output-gradient rows
// (all in their own type, padded), and (stored) the stage's (queries x
// kBwdKeyTile) fp32 p, then ds; (recomputing) the stage's (keys x kBwdLd)
// fp32 p and ds; the barriers (K and V's, then the stages').
struct DkvPlan {
  int rb, vs, st, stage_bytes, pc, dc, kv, full, empty, total;
};

__host__ __device__ inline DkvPlan dkv_plan(int dh, int elt, bool stored) {
  DkvPlan p;
  p.rb = fullclip::round16(dh * elt) + 16;
  p.vs = stored ? 0 : kBwdKeyTile * p.rb;
  p.st = 2 * p.vs;
  p.stage_bytes = 2 * kBwdQueries * p.rb + (stored ? 2 * 4 * kBwdQueries * kBwdKeyTile : 0);
  p.pc = p.st + kFwdStages * p.stage_bytes;
  p.dc = p.pc + (stored ? 0 : fullclip::round16(4 * kBwdKeyTile * kBwdLd));
  p.kv = p.dc + (stored ? 0 : fullclip::round16(4 * kBwdKeyTile * kBwdLd));
  p.full = p.kv + 16;
  p.empty = p.full + 8 * kFwdStages;
  p.total = p.empty + 8 * kFwdStages;
  return p;
}

// acc[a][b] += the product chains of rows x + 16 a (xr elements apart) and
// y + 16 b (yr apart), staged in shared memory: each one sequential fp32 FMA
// chain over dh in element order, fmaf(x, y, acc), as the whole-row body's
// dot products; a staged row of y feeds A chains and a row of x B.
template <int A, int B, typename TX, typename TY>
__device__ __forceinline__ void chains(float (&acc)[A][B], const TX* x, int xr, const TY* y,
                                       int yr, int dh) {
#pragma unroll 2
  for (int e = 0; e < dh; e += 8) {
    float yf[B][8];
#pragma unroll
    for (int b = 0; b < B; ++b) load8(y + 16 * b * yr + e, yf[b]);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float xf[8];
      load8(x + 16 * a * xr + e, xf);
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[a][b] = fmaf(xf[i], yf[b][i], acc[a][b]);
    }
  }
}

// One sequential fp32 sum of e[0 .. n) in order, and delta = the chain of
// fmaf(e_j * r, d_j, delta) in order: the next 16 values' loads issued
// before the current 16 are added.
__device__ __forceinline__ float ordered_sum(const float* e, int n) {
  float sum = 0.f, cur[16], next[16];
  const int whole = n / 16 * 16;
#pragma unroll
  for (int u = 0; u < 16; ++u) cur[u] = u < whole ? e[u] : 0.f;
  for (int j = 0; j < whole; j += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) next[u] = j + 16 + u < whole ? e[j + 16 + u] : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      sum = __fadd_rn(sum, cur[u]);
      cur[u] = next[u];
    }
  }
  for (int j = whole; j < n; ++j) sum = __fadd_rn(sum, e[j]);
  return sum;
}
__device__ __forceinline__ float ordered_delta(const float* e, const float* d, float r, int n) {
  float delta = 0.f, ce[8], cd[8], ne[8], nd[8];
  const int whole = n / 8 * 8;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    ce[u] = u < whole ? e[u] : 0.f;
    cd[u] = u < whole ? d[u] : 0.f;
  }
  for (int j = 0; j < whole; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ne[u] = j + 8 + u < whole ? e[j + 8 + u] : 0.f;
      nd[u] = j + 8 + u < whole ? d[j + 8 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      delta = fmaf(__fmul_rn(ce[u], r), cd[u], delta);
      ce[u] = ne[u];
      cd[u] = nd[u];
    }
  }
  for (int j = whole; j < n; ++j) delta = fmaf(__fmul_rn(e[j], r), d[j], delta);
  return delta;
}

// The query side's item (row, head, kBwdQt queries) of block b, and the keys
// its queries see.
struct DqItem {
  int rh, row, col, t0, nq, kend, nkt;
};
__device__ __forceinline__ DqItem dq_item(const Args& a, int b) {
  DqItem it;
  const int tiles = (a.len + kBwdQt - 1) / kBwdQt;
  it.rh = b / tiles;
  it.row = it.rh / a.heads;
  it.col = (it.rh - it.row * a.heads) * a.dh;
  it.t0 = (b - it.rh * tiles) * kBwdQt;
  it.nq = min(kBwdQt, a.len - it.t0);
  it.kend = a.causal ? it.t0 + it.nq : a.len;  // keys any query of the tile sees
  it.nkt = (it.kend + kBwdKeys - 1) / kBwdKeys;
  return it;
}

// The tile's q and g rows into shared memory (qs, gs; rows rs elements
// apart), zeros past its last query, by the consumer threads.
template <typename T>
__device__ __forceinline__ void stage_query_rows(const Args& a, const DqItem& it, T* qs, T* gs,
                                                 int rs) {
  const int nc = a.dh / 8;
  for (int w = threadIdx.x; w < 2 * kBwdQt * nc; w += kFwdConsumers) {
    const int og = w >= kBwdQt * nc, r = w - og * kBwdQt * nc, i = r / nc, c = (r - i * nc) * 8;
    T* dst = (og ? gs : qs) + i * rs + c;
    if (i < it.nq) {
      copy8(dst, elem<T>(og ? a.g : a.q, a.n, it.row, it.t0 + i, it.col + c));
    } else {
      const float zero[8] = {};
      store8(dst, zero);
    }
  }
}

// Where the query side writes its tile's p (`stored`: 2 len stored_ld(len)
// fp32 an item, p then ds, from the launch's first item on): query t0's row
// of p; ds's rows follow len rows later. Null without a scratch.
__device__ __forceinline__ float* stored_rows(const Args& a, const DqItem& it, float* stored,
                                             int block0) {
  if (!stored) return nullptr;
  const int item0 = block0 / ((a.len + kBwdQt - 1) / kBwdQt);
  return stored + (static_cast<long long>(it.rh - item0) * 2 * a.len + it.t0) * stored_ld(a.len);
}

// dq's chains over one stage of keys k0 .. k0 + cnt (rows of ks, rs
// elements apart), with ds of query i and key k0 + j at ds[i * ld + j]:
// unit u = (query group qg, 4 columns), the group's queries qg and qg + 16,
// at most two units a thread (dh = 128); each column one chain in key
// order, a staged key row feeding both queries' chains. A later query sees
// at least an earlier one's keys: both chains up to the smaller limit, then
// the one with more alone. lim(i): the keys query i sees.
template <typename T, typename Lim>
__device__ __forceinline__ void dq_stage(float (&acc)[2][2][4], const float* ds, int ld,
                                         const T* ks, int rs, int k0, int cnt, int nq, int dh,
                                         Lim lim) {
  const int cq = dh / 4, units = 16 * cq;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int u = threadIdx.x + f * kFwdConsumers, qg = u / cq, c = (u - qg * cq) * 4;
    if (u < units && qg < nq) {
      const float* ds0 = ds + qg * ld;
      const int jn0 = min(cnt, lim(qg) - k0);
      auto one = [&](const float* dsr, int j0, int j1, float(&o)[4]) {
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float x = dsr[j];
          const float2 k01 = load2(ks + j * rs + c), k23 = load2(ks + j * rs + c + 2);
          o[0] = fmaf(x, k01.x, o[0]);
          o[1] = fmaf(x, k01.y, o[1]);
          o[2] = fmaf(x, k23.x, o[2]);
          o[3] = fmaf(x, k23.y, o[3]);
        }
      };
      const float* ds1 = ds0 + 16 * ld;
      const int jn1 = qg + 16 < nq ? min(cnt, lim(qg + 16) - k0) : 0;
      const int both = min(jn0, jn1);
#pragma unroll 4
      for (int j = 0; j < both; ++j) {
        const float x0 = ds0[j], x1 = ds1[j];
        const float2 k01 = load2(ks + j * rs + c), k23 = load2(ks + j * rs + c + 2);
        acc[f][0][0] = fmaf(x0, k01.x, acc[f][0][0]);
        acc[f][0][1] = fmaf(x0, k01.y, acc[f][0][1]);
        acc[f][0][2] = fmaf(x0, k23.x, acc[f][0][2]);
        acc[f][0][3] = fmaf(x0, k23.y, acc[f][0][3]);
        acc[f][1][0] = fmaf(x1, k01.x, acc[f][1][0]);
        acc[f][1][1] = fmaf(x1, k01.y, acc[f][1][1]);
        acc[f][1][2] = fmaf(x1, k23.x, acc[f][1][2]);
        acc[f][1][3] = fmaf(x1, k23.y, acc[f][1][3]);
      }
      one(ds1, max(both, 0), jn1, acc[f][1]);
      one(ds0, max(both, 0), jn0, acc[f][0]);
    }
  }
}

// dq (a.o0) from the chains of dq_stage, and each query's max, 1/sum and
// delta (a.stats: (rows * heads, 3, len)).
template <typename T>
__device__ __forceinline__ void dq_write(const Args& a, const DqItem& it,
                                         const float (&acc)[2][2][4], const float* mx,
                                         const float* inv, const float* dl) {
  const int tid = threadIdx.x, cq = a.dh / 4, units = 16 * cq;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int u = tid + f * kFwdConsumers, qg = u / cq, c = (u - qg * cq) * 4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = qg + 16 * x;
      if (u < units && i < it.nq) {
        T* out = elem<T>(a.o0, a.n, it.row, it.t0 + i, it.col + c);
        store2(out, make_float2(acc[f][x][0], acc[f][x][1]));
        store2(out + 2, make_float2(acc[f][x][2], acc[f][x][3]));
      }
    }
  }
  if (tid < it.nq) {
    float* st = a.stats + static_cast<long long>(it.rh) * 3 * a.len + it.t0 + tid;
    st[0] = mx[tid];
    st[a.len] = inv[tid];
    st[2 * a.len] = dl[tid];
  }
}

// The query side: a block a (row, head, kBwdQt queries) item, blocks
// block0 + blockIdx.x of the launch. A producer warp bulk-copies the keys
// the tile sees in stages of kBwdKeys rows: K (the scores), V (dp), K again
// (dq). Eight consumer warps: the scores and dp register-blocked, a thread
// owning 2 queries x 4 keys of a stage, each product computed once and kept
// in shared memory; each query's max a warp (shuffles) and its exps by the
// warp's lanes; its 1/sum and delta, a thread a query, each one chain in
// key order; ds by every thread; dq by dq_stage. stored (non-null): each p
// and ds also go to it, 2 len stored_ld(len) fp32 an item from the
// launch's first item on, for the key side to read.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2) dq_kernel(const Args a, const DqPlan p,
                                                         float* stored, int block0) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int qt = kBwdQt;
  const int b = block0 + static_cast<int>(blockIdx.x);
  const DqItem it = dq_item(a, b);
  const int t0 = it.t0, nq = it.nq, kend = it.kend, nkt = it.nkt, dh = a.dh;
  const int rs = p.rb / static_cast<int>(sizeof(T));  // elements between staged rows
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFwdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kFwdConsumers) {  // the producer warp: K tiles, V tiles, K tiles
    const int lane = tid & 31;
    const unsigned span = dh * static_cast<unsigned>(sizeof(T));
    for (int g = 0; g < 3 * nkt; ++g) {
      const int s = g % kFwdStages, pass = g / nkt;
      const int k0 = (g - pass * nkt) * kBwdKeys, cnt = min(kBwdKeys, kend - k0);
      mbar_wait(empty + s, ((g / kFwdStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + s, cnt * span);
      __syncwarp();
      unsigned char* st = smem + s * kBwdKeys * p.rb;
      const fullclip::Operand& o = pass == 1 ? a.v : a.k;
      for (int j = lane; j < cnt; j += 32)
        bulk_copy_g2s(st + j * p.rb, elem<T>(o, a.n, it.row, k0 + j, it.col), span, full + s);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  T* qs = reinterpret_cast<T*>(smem + p.qs);
  T* gs = reinterpret_cast<T*>(smem + p.gs);
  const int ld = p.ld;
  float* sc = reinterpret_cast<float*>(smem + p.sc);
  float* dc = reinterpret_cast<float*>(smem + p.dc);
  float* mx = reinterpret_cast<float*>(smem + p.stat);
  float* inv = mx + qt;
  float* dl = inv + qt;
  auto lim = [&](int i) { return a.causal ? t0 + i + 1 : a.len; };  // keys query i sees
  stage_query_rows(a, it, qs, gs, rs);
  fullclip::consumers_sync();

  // the scores (K tiles), then dp (V tiles): thread (tq, tk) owns queries
  // tq + 16 a and keys tk + 16 b of each stage
  const int tq = tid >> 4, tk = tid & 15;
  for (int g = 0; g < 2 * nkt; ++g) {
    const int s = g % kFwdStages, pass = g >= nkt;
    const int k0 = (g - pass * nkt) * kBwdKeys, k1 = min(k0 + kBwdKeys, kend);
    mbar_wait(full + s, (g / kFwdStages) & 1);
    float acc[2][4] = {};
    chains(acc, (pass ? gs : qs) + tq * rs, rs,
           reinterpret_cast<const T*>(smem + s * kBwdKeys * p.rb) + tk * rs, rs, dh);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    float* out = pass ? dc : sc;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = tq + 16 * x, j = k0 + tk + 16 * y;
        if (i < nq && j < k1 && j < lim(i))
          out[i * ld + j] = pass ? acc[x][y] : __fmul_rn(acc[x][y], a.scale);
      }
  }
  fullclip::consumers_sync();

  // each query's max (a warp a query; exact in any order), then its exps in
  // place, each lane's loads issued before its stores
  for (int i = warp; i < nq; i += kFwdConsumers / 32) {
    float* sr = sc + i * ld;
    const int n = lim(i);
    float m = -INFINITY;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    for (int j0 = lane; j0 < n; j0 += 4 * 32) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < n) x[u] = sr[j0 + 32 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < n) sr[j0 + 32 * u] = expf(__fsub_rn(x[u], m));
    }
    if (lane == 0) mx[i] = m;
  }
  fullclip::consumers_sync();

  // 1/sum, then delta = sum_j p dp with p = exp * (1/sum): a thread a query,
  // each one chain in key order, its loads a batch ahead of the adds (the
  // other block of the SM computes beside them)
  if (tid < nq) {
    const float* e = sc + tid * ld;
    const float* d = dc + tid * ld;
    const int n = lim(tid);
    const float r = __fdiv_rn(1.f, ordered_sum(e, n));
    inv[tid] = r;
    dl[tid] = ordered_delta(e, d, r, n);
  }
  fullclip::consumers_sync();

  // ds = p (dp - delta) scale in place of the exps, by every thread, four
  // loads ahead of their stores; p and ds to `stored` too where given
  const int sl = stored_ld(a.len);
  float* pw = stored_rows(a, it, stored, block0);
  for (int w0 = tid; w0 < nq * kend; w0 += 4 * kFwdConsumers) {
    float x[4], y[4];
    int at[4], qi[4], kj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + u * kFwdConsumers, i = w / kend, j = w - i * kend;
      qi[u] = i;
      kj[u] = j;
      at[u] = w < nq * kend && j < lim(i) ? i * ld + j : -1;
      if (at[u] >= 0) {
        x[u] = sc[at[u]];
        y[u] = dc[at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) {
        const float pv = __fmul_rn(x[u], inv[qi[u]]);
        const float ds = __fmul_rn(__fmul_rn(pv, __fsub_rn(y[u], dl[qi[u]])), a.scale);
        sc[at[u]] = ds;
        if (pw) {
          pw[qi[u] * sl + kj[u]] = pv;
          pw[(static_cast<long long>(a.len) + qi[u]) * sl + kj[u]] = ds;
        }
      }
  }
  fullclip::consumers_sync();

  // dq over the K tiles again
  float acc[2][2][4] = {};
  for (int g = 2 * nkt; g < 3 * nkt; ++g) {
    const int s = g % kFwdStages, k0 = (g - 2 * nkt) * kBwdKeys, cnt = min(kBwdKeys, kend - k0);
    mbar_wait(full + s, (g / kFwdStages) & 1);
    dq_stage(acc, sc + k0, ld, reinterpret_cast<const T*>(smem + s * kBwdKeys * p.rb), rs, k0,
             cnt, nq, dh, lim);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  dq_write<T>(a, it, acc, mx, inv, dl);
}

// The query side past shared memory: the same item, its keys swept four
// times in stages of kBwdKeys rows, a stage's products register-blocked as
// above into one (kBwdQt x kSweepLd) tile: (0) the scores, each query's
// max folded stage by stage (a warp a query); (1) the scores again, their
// exps, and each query's sum, a thread a query, one chain carried across
// the stages in key order; (2) the scores and dp, delta's chain likewise;
// (3) the scores and dp, ds (and p and ds to `stored`, as dq_kernel), and dq
// by dq_stage on the stage's K rows. The producer stages K rows, and in the
// last two sweeps V rows beside them. Seven chains a pair against the
// resident query side's three, and no device-memory traffic for them.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2) dq_sweeps_kernel(const Args a, const DqPlan p,
                                                                float* stored, int block0) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int qt = kBwdQt, ld = kSweepLd;
  const DqItem it = dq_item(a, block0 + static_cast<int>(blockIdx.x));
  const int t0 = it.t0, nq = it.nq, kend = it.kend, nkt = it.nkt, dh = a.dh;
  const int rs = p.rb / static_cast<int>(sizeof(T));
  const int stage_bytes = 2 * kBwdKeys * p.rb;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFwdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kFwdConsumers) {  // the producer warp: K tiles (sweeps 0, 1), K and V (2, 3)
    const int lane = tid & 31;
    const unsigned span = dh * static_cast<unsigned>(sizeof(T));
    for (int g = 0; g < 4 * nkt; ++g) {
      const int s = g % kFwdStages, sweep = g / nkt, both = sweep >= 2;
      const int k0 = (g - sweep * nkt) * kBwdKeys, cnt = min(kBwdKeys, kend - k0);
      mbar_wait(empty + s, ((g / kFwdStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + s, (1 + both) * cnt * span);
      __syncwarp();
      unsigned char* st = smem + s * stage_bytes;
      for (int j = lane; j < (1 + both) * cnt; j += 32) {
        const int o = j >= cnt, r = j - o * cnt;
        bulk_copy_g2s(st + (o * kBwdKeys + r) * p.rb,
                      elem<T>(o ? a.v : a.k, a.n, it.row, k0 + r, it.col), span, full + s);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, tq = tid >> 4, tk = tid & 15;
  T* qs = reinterpret_cast<T*>(smem + p.qs);
  T* gs = reinterpret_cast<T*>(smem + p.gs);
  float* sc = reinterpret_cast<float*>(smem + p.sc);
  float* dc = reinterpret_cast<float*>(smem + p.dc);
  float* mx = reinterpret_cast<float*>(smem + p.stat);
  float* inv = mx + qt;
  float* dl = inv + qt;
  auto lim = [&](int i) { return a.causal ? t0 + i + 1 : a.len; };
  stage_query_rows(a, it, qs, gs, rs);
  if (tid < qt) mx[tid] = -INFINITY;
  fullclip::consumers_sync();
  float chain = 0.f, r = 0.f;  // thread tid < nq: query tid's sum, then its delta
  const int sl = stored_ld(a.len);
  float* pw = stored_rows(a, it, stored, block0);
  float acc[2][2][4] = {};
  for (int g = 0; g < 4 * nkt; ++g) {
    const int s = g % kFwdStages, sweep = g / nkt;
    const int k0 = (g - sweep * nkt) * kBwdKeys, cnt = min(kBwdKeys, kend - k0);
    const T* ks = reinterpret_cast<const T*>(smem + s * stage_bytes);
    mbar_wait(full + s, (g / kFwdStages) & 1);
    float sa[2][4] = {}, da[2][4] = {};
    chains(sa, qs + tq * rs, rs, ks + tk * rs, rs, dh);
    if (sweep >= 2) chains(da, gs + tq * rs, rs, ks + (kBwdKeys + tk) * rs, rs, dh);
    if (sweep < 3) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    fullclip::consumers_sync();  // the previous stage's tile is read (and mx, inv, dl in)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = tq + 16 * x, j = tk + 16 * y;
        if (i < nq && j < cnt && k0 + j < lim(i)) {
          const float sv = __fmul_rn(sa[x][y], a.scale);
          if (sweep == 0) {
            sc[i * ld + j] = sv;
          } else if (sweep < 3) {
            sc[i * ld + j] = expf(__fsub_rn(sv, mx[i]));
            if (sweep == 2) dc[i * ld + j] = da[x][y];
          } else {
            const float pv = __fmul_rn(expf(__fsub_rn(sv, mx[i])), inv[i]);
            const float ds = __fmul_rn(__fmul_rn(pv, __fsub_rn(da[x][y], dl[i])), a.scale);
            sc[i * ld + j] = ds;
            if (pw) {
              pw[i * sl + k0 + j] = pv;
              pw[(static_cast<long long>(a.len) + i) * sl + k0 + j] = ds;
            }
          }
        }
      }
    fullclip::consumers_sync();
    if (sweep == 0) {  // each query's max: a warp a query, folded across the stages
      for (int i = warp; i < nq; i += kFwdConsumers / 32) {
        const int n = min(cnt, lim(i) - k0);
        float m = -INFINITY;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[i * ld + j]);
        m = warp_max(m);
        if (lane == 0) mx[i] = fmaxf(mx[i], m);
      }
    } else if (sweep < 3) {  // the sum's chain, then delta's, a thread a query
      if (tid < nq) {
        const int n = min(cnt, lim(tid) - k0);
        const float* e = sc + tid * ld;
        const float* d = dc + tid * ld;
        if (sweep == 1) {
          for (int j = 0; j < n; ++j) chain = __fadd_rn(chain, e[j]);
        } else {
          for (int j = 0; j < n; ++j) chain = fmaf(__fmul_rn(e[j], r), d[j], chain);
        }
        if (g == (sweep + 1) * nkt - 1) {  // the sweep's last stage
          if (sweep == 1) {
            r = __fdiv_rn(1.f, chain);
            inv[tid] = r;
            chain = 0.f;
          } else {
            dl[tid] = chain;
          }
        }
      }
    } else {
      dq_stage(acc, sc, ld, ks, rs, k0, cnt, nq, dh, lim);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
  }
  fullclip::consumers_sync();
  dq_write<T>(a, it, acc, mx, inv, dl);
}

// The key side: a block a (row, head, kBwdKeyTile keys) item, blocks block0
// + blockIdx.x. The producer warp bulk-copies, query tile after query tile
// (causal: from the first query that sees the block's first key), the
// tile's q and g rows into two stages. Recomputing (STORED false): it first
// copies the item's K and V rows once, and eight consumer warps recompute
// s and dp register-blocked (a thread owning 2 queries x 4 keys of a
// stage, each product once), and p and ds from the query side's
// statistics. STORED: the stage also holds the tile's rows of p and ds that
// the query side wrote to `stored` (2 len stored_ld(len) fp32 an item from
// the launch's first item on), the same bits. Then dk and dv, a thread UF
// keys' 8 columns, each column's two chains running over the queries in
// order. Writes dk (a.o0) and dv (a.o1).
template <typename T, int UF, bool STORED>
__global__ void __launch_bounds__(kFwdThreads, 2) dkv_kernel(const Args a, const DkvPlan p,
                                                          const float* stored, int block0) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = (a.len + kBwdKeyTile - 1) / kBwdKeyTile;
  const int b = block0 + static_cast<int>(blockIdx.x);
  const int rh = b / tiles, row = rh / a.heads, col = (rh - row * a.heads) * a.dh;
  const int k0 = (b - rh * tiles) * kBwdKeyTile, nk = min(kBwdKeyTile, a.len - k0), dh = a.dh;
  const int q_first = a.causal ? k0 : 0;
  const int nqt = (a.len - q_first + kBwdQueries - 1) / kBwdQueries;
  const int rs = p.rb / static_cast<int>(sizeof(T));
  const int sl = stored_ld(a.len);
  unsigned long long* kv = reinterpret_cast<unsigned long long*>(smem + p.kv);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFwdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kFwdConsumers) {  // the producer warp
    const int lane = tid & 31;
    const unsigned span = dh * static_cast<unsigned>(sizeof(T));
    const unsigned pspan = (nk + 3) / 4 * 16;  // a query's p (or ds) of the block's keys
    const float* item =
        STORED ? stored + static_cast<long long>(rh - block0 / tiles) * 2 * a.len * sl : nullptr;
    if (!STORED) {
      if (lane == 0) mbar_expect_tx(kv, 2 * nk * span);
      __syncwarp();
      for (int j = lane; j < 2 * nk; j += 32) {
        const int o = j >= nk, r = j - o * nk;
        bulk_copy_g2s(smem + o * p.vs + r * p.rb,
                      elem<T>(o ? a.v : a.k, a.n, row, k0 + r, col), span, kv);
      }
    }
    for (int g = 0; g < nqt; ++g) {
      const int s = g % kFwdStages, q0 = q_first + g * kBwdQueries;
      const int cnt = min(kBwdQueries, a.len - q0);
      mbar_wait(empty + s, ((g / kFwdStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + s, 2 * cnt * (span + (STORED ? pspan : 0)));
      __syncwarp();
      unsigned char* st = smem + p.st + s * p.stage_bytes;
      for (int j = lane; j < 2 * cnt; j += 32) {
        const int o = j >= cnt, r = j - o * cnt;
        bulk_copy_g2s(st + (o * kBwdQueries + r) * p.rb,
                      elem<T>(o ? a.g : a.q, a.n, row, q0 + r, col), span, full + s);
        if (STORED)  // p, then ds: rows of kBwdKeyTile fp32 after the q and g rows
          bulk_copy_g2s(st + 2 * kBwdQueries * p.rb + (o * kBwdQueries + r) * 4 * kBwdKeyTile,
                        item + (static_cast<long long>(o) * a.len + q0 + r) * sl + k0, pspan,
                        full + s);
      }
    }
    return;
  }

  const int lane = tid & 31, nc = dh / 8, tq = tid >> 4, tk = tid & 15;
  // dk and dv: thread tid owns keys jb + kstep f (f < UF) and, of each, the
  // columns lo .. lo + 3 and hi .. hi + 3 (the two halves of the head: the
  // eight lanes of a key read one contiguous span of each staged row)
  const int jb = tid / nc, kstep = kFwdConsumers / nc, lo = 4 * (tid % nc), hi = dh / 2 + lo;
  const T* ks = reinterpret_cast<const T*>(smem);
  const T* vs = reinterpret_cast<const T*>(smem + p.vs);
  // p and ds of (key j, query i) at pc[j * pj + i * pi] (and dc)
  constexpr int pj = STORED ? 1 : kBwdLd, pi = STORED ? kBwdKeyTile : 1;
  const float* stats = a.stats + static_cast<long long>(rh) * 3 * a.len;
  float ak[UF][8] = {}, av[UF][8] = {};
  if (!STORED) mbar_wait(kv, 0);
  for (int g = 0; g < nqt; ++g) {
    const int s = g % kFwdStages, q0 = q_first + g * kBwdQueries;
    const int nq = min(kBwdQueries, a.len - q0);
    mbar_wait(full + s, (g / kFwdStages) & 1);
    const T* qst = reinterpret_cast<const T*>(smem + p.st + s * p.stage_bytes);
    const T* gst = qst + kBwdQueries * rs;
    const float* pc = STORED ? reinterpret_cast<const float*>(qst + 2 * kBwdQueries * rs)
                             : reinterpret_cast<const float*>(smem + p.pc);
    const float* dc = STORED ? pc + kBwdQueries * kBwdKeyTile
                             : reinterpret_cast<const float*>(smem + p.dc);
    if (!STORED) {
      float* pw = reinterpret_cast<float*>(smem + p.pc);
      float* dw = reinterpret_cast<float*>(smem + p.dc);
      float sa[2][4] = {}, da[2][4] = {};
      chains(sa, qst + tq * rs, rs, ks + tk * rs, rs, dh);
      chains(da, gst + tq * rs, rs, vs + tk * rs, rs, dh);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = tq + 16 * x, qpos = q0 + i;
        float m = 0.f, r = 0.f, delta = 0.f;
        if (i < nq) {
          m = stats[qpos];
          r = stats[a.len + qpos];
          delta = stats[2 * a.len + qpos];
        }
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int j = tk + 16 * y;
          float pv = 0.f, ds = 0.f;
          if (i < nq && j < nk && (!a.causal || k0 + j <= qpos)) {
            pv = __fmul_rn(expf(__fsub_rn(__fmul_rn(sa[x][y], a.scale), m)), r);
            ds = __fmul_rn(__fmul_rn(pv, __fsub_rn(da[x][y], delta)), a.scale);
          }
          pw[j * kBwdLd + i] = pv;
          dw[j * kBwdLd + i] = ds;
        }
      }
      fullclip::consumers_sync();
    }
    // each of the thread's UF keys' 8 columns (4 at lo, 4 at hi) two chains
    // over the queries in order; a staged q and g row feeds all UF keys
    int i0[UF], first = nq;
#pragma unroll
    for (int f = 0; f < UF; ++f) {
      const int j = jb + f * kstep;  // causal: queries at or after the key
      i0[f] = j < nk ? (a.causal ? max(0, k0 + j - q0) : 0) : nq;
      first = min(first, i0[f]);
    }
    for (int i = first; i < nq; ++i) {
      float qf[8], gf[8];
      load4(qst + i * rs + lo, qf);
      load4(qst + i * rs + hi, qf + 4);
      load4(gst + i * rs + lo, gf);
      load4(gst + i * rs + hi, gf + 4);
#pragma unroll
      for (int f = 0; f < UF; ++f) {
        if (i >= i0[f]) {
          const int j = jb + f * kstep;
          const float pv = pc[j * pj + i * pi], ds = dc[j * pj + i * pi];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ak[f][e] = fmaf(ds, qf[e], ak[f][e]);
            av[f][e] = fmaf(pv, gf[e], av[f][e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (!STORED) fullclip::consumers_sync();  // every unit is done with this stage's p and ds
  }
#pragma unroll
  for (int f = 0; f < UF; ++f) {
    const int j = jb + f * kstep;
    if (j < nk) {
      store4(elem<T>(a.o0, a.n, row, k0 + j, col + lo), ak[f]);
      store4(elem<T>(a.o0, a.n, row, k0 + j, col + hi), ak[f] + 4);
      store4(elem<T>(a.o1, a.n, row, k0 + j, col + lo), av[f]);
      store4(elem<T>(a.o1, a.n, row, k0 + j, col + hi), av[f] + 4);
    }
  }
}

// The key side over `n` items from item i0 on (stored: their p and ds).
template <typename T, bool STORED>
int key_side(const Args& dkv, long long i0, long long n, const float* stored,
             cudaStream_t stream) {
  const DkvPlan kp = dkv_plan(dkv.dh, sizeof(T), STORED);
  const int tiles = (dkv.len + kBwdKeyTile - 1) / kBwdKeyTile;
  const unsigned grid = static_cast<unsigned>(n * tiles);
  const int block0 = static_cast<int>(i0 * tiles);
  return dkv.dh <= 64 ? launch_grid(dkv_kernel<T, 2, STORED>, kp.total, grid, kFwdThreads,
                                    stream, dkv, kp, stored, block0)
                      : launch_grid(dkv_kernel<T, 4, STORED>, kp.total, grid, kFwdThreads,
                                    stream, dkv, kp, stored, block0);
}

// dq (dq.o0, with each query's statistics in dq.stats: rows * heads * 3 *
// len fp32), then dk and dv (dkv.o0, dkv.o1), on `plan` (its bits
// kBwdSweeps and kBwdStored; ops._tiled_bwd_plan picks it, and every plan
// gives the same bits). The resident query side takes a length whose
// dq_plan fits a block, the sweeping one any. kBwdStored: `scratch` holds
// `floats` fp32 for the stored p and ds, 2 len stored_ld(len) an item, and
// both sides launch over chunks of as many items as it holds (a scratch that
// does not hold one item's is refused); else no scratch.
template <typename T>
int backward(int rows, const Args& dq, const Args& dkv, int plan, float* scratch,
             long long floats, cudaStream_t stream) {
  const bool sweeps = plan & kBwdSweeps, stored = plan & kBwdStored;
  if (dq.dh % 8 || dq.dh > 128 || dq.len < 1 || !dq.stats || plan < 0 ||
      plan > (kBwdSweeps | kBwdStored) || stored != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(rows) * dq.heads;
  const int qtiles = (dq.len + kBwdQt - 1) / kBwdQt;
  const DqPlan p = sweeps ? sweep_plan(dq.dh, sizeof(T)) : dq_plan(dq.len, dq.dh, sizeof(T));
  const long long per = stored ? floats / (2LL * dq.len * stored_ld(dq.len)) : items;
  if (per < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (long long i0 = 0; i0 < items; i0 += per) {
    const long long n = items - i0 < per ? items - i0 : per;
    const unsigned grid = static_cast<unsigned>(n * qtiles);
    const int block0 = static_cast<int>(i0 * qtiles);
    int rc = sweeps ? launch_grid(dq_sweeps_kernel<T>, p.total, grid, kFwdThreads, stream, dq, p,
                                  scratch, block0)
                    : launch_grid(dq_kernel<T>, p.total, grid, kFwdThreads, stream, dq, p,
                                  scratch, block0);
    if (!rc)
      rc = stored ? key_side<T, true>(dkv, i0, n, scratch, stream)
                  : key_side<T, false>(dkv, i0, n, nullptr, stream);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace tiled
