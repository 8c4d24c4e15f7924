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
#pragma once

#include "fullclip.cuh"

namespace tiled {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // backward: queries (keys) an item, keys (queries) a stage
constexpr int kLd = kTile + 1;  // row of a (kTile x kTile) score tile

struct Args {
  fullclip::Operand q, k, v, g;  // g: the output gradient (backward)
  fullclip::Operand o0, o1;      // out (forward), dq (query side), dk and dv (key side)
  float* stats;                  // (rows * heads, 3, len): max, 1/sum, delta (backward)
  int n, len, dh, heads, causal;
  float scale;
};

// Shared memory of an item: `rows` staged rows of dh + 1 floats, `scores`
// (kTile x kTile) fp32 tiles, `per_row` fp32 values for each of kTile rows.
inline int smem_bytes(int dh, int rows, int scores, int per_row) {
  return 4 * (rows * (dh + 1) + scores * kTile * kLd + per_row * kTile);
}

// Rows t0 .. t0 + nr - 1 of the head slice (columns col .. col + dh - 1) of
// operand o for row `row`, as fp32 rows of dh + 1; kTile rows, zeros past nr.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const fullclip::Operand& o, int n, int row,
                                          int t0, int nr, int col, int dh) {
  const T* src = static_cast<const T*>(o.p);
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, e = i - r * dh;
    dst[r * (dh + 1) + e] = r < nr ? to_f32(src[fullclip::at(o, row, n, t0 + r, col + e)]) : 0.f;
  }
}

// One sequential fp32 FMA chain over dh in element order.
__device__ __forceinline__ float dot(const float* x, const float* y, int dh) {
  float acc = 0.f;
#pragma unroll 8
  for (int e = 0; e < dh; ++e) acc = fmaf(x[e], y[e], acc);
  return acc;
}

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

// One fp32 value stored as T (round to nearest even).
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The item of this block: its (row, head), the column of the head, and the
// first row of its tile.
struct Item {
  int rh, row, col, t0, nt;
};

__device__ __forceinline__ Item item_of(const Args& a) {
  const int tiles = (a.len + kTile - 1) / kTile;
  Item it;
  it.rh = blockIdx.x / tiles;
  it.row = it.rh / a.heads;
  it.col = (it.rh - it.row * a.heads) * a.dh;
  it.t0 = (blockIdx.x - it.rh * tiles) * kTile;
  it.nt = min(kTile, a.len - it.t0);
  return it;
}

// Whether query position qpos sees key position kpos.
__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return !a.causal || kpos <= qpos;
}

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

// ---- backward, query side: dq, and each query's max, 1/sum and delta

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int dh = a.dh, ld = dh + 1, nc = dh / 8;
  float* qs = sm;                  // kTile x ld
  float* gs = qs + kTile * ld;     // kTile x ld
  float* ks = gs + kTile * ld;     // kTile x ld
  float* vs = ks + kTile * ld;     // kTile x ld
  float* pc = vs + kTile * ld;     // kTile x kLd: exps, then p, then ds
  float* dc = pc + kTile * kLd;    // kTile x kLd: dp
  float* mx = dc + kTile * kLd;    // kTile
  float* inv = mx + kTile;         // kTile: the sum, then 1/sum
  float* dl = inv + kTile;         // kTile: delta
  const Item it = item_of(a);
  const int tid = threadIdx.x;
  const int kend = a.causal ? it.t0 + it.nt : a.len;
  load_rows<T>(qs, a.q, a.n, it.row, it.t0, it.nt, it.col, dh);
  load_rows<T>(gs, a.g, a.n, it.row, it.t0, it.nt, it.col, dh);
  if (tid < kTile) {
    mx[tid] = -INFINITY;
    inv[tid] = 0.f;
    dl[tid] = 0.f;
  }
  // sweeps 1-4: the max; the sum of the exps; delta; dq
  float acc[2][8];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[f][e] = 0.f;
  for (int sweep = 0; sweep < 4; ++sweep) {
    for (int k0 = 0; k0 < kend; k0 += kTile) {
      const int nk = min(kTile, kend - k0);
      __syncthreads();
      load_rows<T>(ks, a.k, a.n, it.row, k0, nk, it.col, dh);
      if (sweep >= 2) load_rows<T>(vs, a.v, a.n, it.row, k0, nk, it.col, dh);
      __syncthreads();
      for (int w = tid; w < kTile * kTile; w += kThreads) {
        const int i = w / kTile, j = w - i * kTile;
        const bool on = i < it.nt && j < nk && visible(a, it.t0 + i, k0 + j);
        const float s = on ? __fmul_rn(dot(qs + i * ld, ks + j * ld, dh), a.scale) : 0.f;
        if (sweep == 0) {
          pc[i * kLd + j] = on ? s : -INFINITY;
        } else if (sweep == 1) {
          pc[i * kLd + j] = on ? expf(__fsub_rn(s, mx[i])) : 0.f;
        } else {
          const float p = on ? __fmul_rn(expf(__fsub_rn(s, mx[i])), inv[i]) : 0.f;
          const float dp = on ? dot(gs + i * ld, vs + j * ld, dh) : 0.f;
          if (sweep == 2) {
            pc[i * kLd + j] = p;
            dc[i * kLd + j] = dp;
          } else {
            pc[i * kLd + j] = on ? __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dl[i])), a.scale) : 0.f;
          }
        }
      }
      __syncthreads();
      if (sweep < 3 && tid < it.nt) {
        const float* row = pc + tid * kLd;
        if (sweep == 0) {
          float m = mx[tid];
          for (int j = 0; j < nk; ++j) m = fmaxf(m, row[j]);
          mx[tid] = m;
        } else if (sweep == 1) {
          float s = inv[tid];
          for (int j = 0; j < nk; ++j) s = __fadd_rn(s, row[j]);
          inv[tid] = s;
        } else {
          float d = dl[tid];
          for (int j = 0; j < nk; ++j) d = fmaf(row[j], dc[tid * kLd + j], d);
          dl[tid] = d;
        }
      }
      if (sweep == 3) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int w = tid + f * kThreads;
          const int i = w / nc, c = (w - i * nc) * 8;
          if (i < it.nt) {
            const int jn = a.causal ? min(nk, it.t0 + i - k0 + 1) : nk;
            for (int j = 0; j < jn; ++j) {
              const float ds = pc[i * kLd + j];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[f][e] = fmaf(ds, ks[j * ld + c + e], acc[f][e]);
            }
          }
        }
      }
    }
    __syncthreads();
    if (sweep == 1 && tid < it.nt) inv[tid] = __fdiv_rn(1.f, inv[tid]);
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int w = tid + f * kThreads;
    const int i = w / nc, c = (w - i * nc) * 8;
    if (i < it.nt) store_row8<T>(a.o0, a.n, it.row, it.t0 + i, it.col + c, acc[f]);
  }
  if (tid < it.nt) {
    float* st = a.stats + static_cast<long long>(it.rh) * 3 * a.len + it.t0 + tid;
    st[0] = mx[tid];
    st[a.len] = inv[tid];
    st[2 * a.len] = dl[tid];
  }
}

// ---- backward, key side: dk and dv, queries in order

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int dh = a.dh, ld = dh + 1, nc = dh / 8;
  float* ks = sm;                  // kTile x ld: the item's keys
  float* vs = ks + kTile * ld;     // kTile x ld
  float* qs = vs + kTile * ld;     // kTile x ld: a query tile
  float* gs = qs + kTile * ld;     // kTile x ld
  float* pc = gs + kTile * ld;     // kTile x kLd: p, keys by rows
  float* dc = pc + kTile * kLd;    // kTile x kLd: ds
  float* st = dc + kTile * kLd;    // 3 x kTile: the query tile's max, 1/sum, delta
  const Item it = item_of(a);      // t0, nt: the item's keys
  const int tid = threadIdx.x;
  load_rows<T>(ks, a.k, a.n, it.row, it.t0, it.nt, it.col, dh);
  load_rows<T>(vs, a.v, a.n, it.row, it.t0, it.nt, it.col, dh);
  const float* stats = a.stats + static_cast<long long>(it.rh) * 3 * a.len;
  float ak[2][8], av[2][8];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) ak[f][e] = av[f][e] = 0.f;
  for (int q0 = a.causal ? it.t0 : 0; q0 < a.len; q0 += kTile) {
    const int nq = min(kTile, a.len - q0);
    __syncthreads();
    load_rows<T>(qs, a.q, a.n, it.row, q0, nq, it.col, dh);
    load_rows<T>(gs, a.g, a.n, it.row, q0, nq, it.col, dh);
    if (tid < nq)
      for (int s = 0; s < 3; ++s) st[s * kTile + tid] = stats[s * a.len + q0 + tid];
    __syncthreads();
    for (int w = tid; w < kTile * kTile; w += kThreads) {
      const int j = w / kTile, i = w - j * kTile;  // key j of the item, query i of the tile
      const bool on = j < it.nt && i < nq && visible(a, q0 + i, it.t0 + j);
      float p = 0.f, ds = 0.f;
      if (on) {
        const float s = __fmul_rn(dot(qs + i * ld, ks + j * ld, dh), a.scale);
        p = __fmul_rn(expf(__fsub_rn(s, st[i])), st[kTile + i]);
        const float dp = dot(gs + i * ld, vs + j * ld, dh);
        ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, st[2 * kTile + i])), a.scale);
      }
      pc[j * kLd + i] = p;
      dc[j * kLd + i] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int w = tid + f * kThreads;
      const int j = w / nc, c = (w - j * nc) * 8;
      if (j < it.nt) {
        // causal: queries at or after the key
        const int i0 = a.causal ? max(0, it.t0 + j - q0) : 0;
        for (int i = i0; i < nq; ++i) {
          const float p = pc[j * kLd + i], ds = dc[j * kLd + i];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ak[f][e] = fmaf(ds, qs[i * ld + c + e], ak[f][e]);
            av[f][e] = fmaf(p, gs[i * ld + c + e], av[f][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int w = tid + f * kThreads;
    const int j = w / nc, c = (w - j * nc) * 8;
    if (j < it.nt) {
      store_row8<T>(a.o0, a.n, it.row, it.t0 + j, it.col + c, ak[f]);
      store_row8<T>(a.o1, a.n, it.row, it.t0 + j, it.col + c, av[f]);
    }
  }
}

// Blocks of a backward launch: (rows * heads) items of ceil(len / kTile) tiles.
inline unsigned grid(int rows, const Args& a) {
  return static_cast<unsigned>(rows) * a.heads * ((a.len + kTile - 1) / kTile);
}

inline int backward_smem(int dh) { return smem_bytes(dh, 4 * kTile, 2, 3); }  // either side

template <typename Kernel>
inline int launch_one(Kernel kernel, int smem, int rows, const Args& a, cudaStream_t stream) {
  return launch_grid(kernel, smem, grid(rows, a), kThreads, stream, a);
}

// dq (dq.o0), then dk and dv (a.o0, a.o1 of dkv); a.stats: rows * heads * 3 * len fp32.
template <typename T>
int backward(int rows, const Args& dq, const Args& dkv, cudaStream_t stream) {
  if (dq.dh % 8 || dq.dh > 128 || dq.len < 1 || !dq.stats)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_one(dq_kernel<T>, backward_smem(dq.dh), rows, dq, stream);
  if (rc) return rc;
  return launch_one(dkv_kernel<T>, backward_smem(dkv.dh), rows, dkv, stream);
}

}  // namespace tiled
