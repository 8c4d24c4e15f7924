// Softmax attention over a sequence of any length, tiled on both sides, on
// the CUDA cores: the shapes past what the whole-row bodies hold in one
// block's shared memory. C and H (temporal_fullclip*.cu) take it once one
// head's (T x T) scores and its T frames no longer fit fullclip.cuh's plan;
// the fp32 bodies of B, L and I (spatial_flat*.cu) once N passes 256 keys a
// lane or the block's shared memory; E (temporal_append_pm.cu) past 32 new
// frames or its whole-table plan, on `attend` with the cached prefix in
// front of the new frames.
//
// Operands are fullclip.cuh's: a base pointer and element strides over
// (b, t, n), D contiguous, row = b * n + n'; the sequence runs along t (the
// frames of C and H, the patches of B and I, as (R, N, D) rows with N = 1).
// A work item is one (row, head) and a tile of kTile queries (the forward
// and the query side of the backward) or keys (the key side), one block of
// 256 threads an item; the other operand streams through shared memory in
// tiles of kTile rows, converted to fp32, rows padded to dh + 1 floats so
// that the lanes of a warp reading one column of 32 rows hit 32 banks.
//
// The order of arithmetic is C's and H's (fullclip.cuh), so a tiled call
// gives the whole-row body's bits: per (head, query), each score is one
// sequential fp32 FMA chain over dh in element order, then times the scale;
// the max over the keys (exact in any order) in a first sweep; then
// expf(s - max), their sum one sequential chain in key order, PV one
// sequential FMA chain in key order, and one multiply by the reciprocal of
// the sum. The backward repeats H's: p = expf(s - max) * (1 / sum), delta =
// sum_j p dp in key order, ds = p (dp - delta) scale, dq = sum_j ds k in key
// order (query side, which also writes max, 1/sum and delta, three fp32 a
// query); dk = sum_t ds q and dv = sum_t p g in query order (key side, a
// second launch reading those statistics). Each sum runs inside one thread
// in a fixed order, with no atomics, so two runs give the same bits. The
// exact softmax costs a sweep of the keys for the max before the sweep that
// sums: the price of keeping those bits.
//
// Bound: operations at these lengths (a (row, head) does about 4 L^2 dh
// FMAs forward, 11 L^2 dh backward, on 4 or 7 L dh elements), here on the
// fp32 CUDA cores. The design is simple and correct first; each key tile is
// read once a sweep from L2 by every query tile of its (row, head).
#pragma once

#include "fullclip.cuh"

namespace tiled {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // queries (keys) an item, keys (queries) a stage
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

// The forward of one item: its nt queries (rows t0 .. t0 + nt - 1), staged
// in fp32 at the start of `sm` (forward_smem) by the caller, against keys
// 0 .. n_keys - 1, which load_k(dst, k0, nk) and load_v(dst, k0, nk) stage
// as kTile fp32 rows of dh + 1 (zeros past nk). Causal: query t0 + i sees
// keys <= t0 + i + off (off: the keys in front of the first query's own,
// E's cached prefix; 0 for C). store(i, c, acc) takes query i's eight
// outputs from column c.
template <typename LoadK, typename LoadV, typename Store>
__device__ __forceinline__ void attend(float* sm, int dh, int t0, int nt, int n_keys, bool causal,
                                       int off, float scale, LoadK load_k, LoadV load_v,
                                       Store store) {
  const int ld = dh + 1, nc = dh / 8;
  float* qs = sm;                  // kTile x ld
  float* ks = qs + kTile * ld;     // kTile x ld
  float* vs = ks + kTile * ld;     // kTile x ld
  float* sc = vs + kTile * ld;     // kTile x kLd
  float* mx = sc + kTile * kLd;    // kTile
  float* sum = mx + kTile;         // kTile
  const int tid = threadIdx.x;
  const int kend = causal ? min(n_keys, t0 + nt + off) : n_keys;  // keys the tile sees
  if (tid < kTile) {
    mx[tid] = -INFINITY;
    sum[tid] = 0.f;
  }
  // sweep 1: each query's max
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int nk = min(kTile, kend - k0);
    __syncthreads();
    load_k(ks, k0, nk);
    __syncthreads();
    for (int w = tid; w < kTile * kTile; w += kThreads) {
      const int i = w / kTile, j = w - i * kTile;
      const bool on = i < nt && j < nk && (!causal || k0 + j <= t0 + i + off);
      sc[i * kLd + j] = on ? __fmul_rn(dot(qs + i * ld, ks + j * ld, dh), scale) : -INFINITY;
    }
    __syncthreads();
    if (tid < nt) {
      float m = mx[tid];
      for (int j = 0; j < nk; ++j) m = fmaxf(m, sc[tid * kLd + j]);
      mx[tid] = m;
    }
  }
  // sweep 2: the exps, their sum and PV, in key order
  float acc[2][8];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[f][e] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int nk = min(kTile, kend - k0);
    __syncthreads();
    load_k(ks, k0, nk);
    load_v(vs, k0, nk);
    __syncthreads();
    for (int w = tid; w < kTile * kTile; w += kThreads) {
      const int i = w / kTile, j = w - i * kTile;
      const bool on = i < nt && j < nk && (!causal || k0 + j <= t0 + i + off);
      sc[i * kLd + j] =
          on ? expf(__fsub_rn(__fmul_rn(dot(qs + i * ld, ks + j * ld, dh), scale), mx[i])) : 0.f;
    }
    __syncthreads();
    if (tid < nt) {
      float s = sum[tid];
      for (int j = 0; j < nk; ++j) s = __fadd_rn(s, sc[tid * kLd + j]);
      sum[tid] = s;
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int w = tid + f * kThreads;
      const int i = w / nc, c = (w - i * nc) * 8;
      if (i < nt) {
        const int jn = causal ? min(nk, t0 + i + off - k0 + 1) : nk;
        for (int j = 0; j < jn; ++j) {
          const float p = sc[i * kLd + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[f][e] = fmaf(p, vs[j * ld + c + e], acc[f][e]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int w = tid + f * kThreads;
    const int i = w / nc, c = (w - i * nc) * 8;
    if (i < nt) {
      const float inv = __fdiv_rn(1.f, sum[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[f][e] = __fmul_rn(acc[f][e], inv);
      store(i, c, acc[f]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) forward_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int dh = a.dh;
  const Item it = item_of(a);
  load_rows<T>(sm, a.q, a.n, it.row, it.t0, it.nt, it.col, dh);
  attend(
      sm, dh, it.t0, it.nt, a.len, a.causal, 0, a.scale,
      [&](float* dst, int k0, int nk) { load_rows<T>(dst, a.k, a.n, it.row, k0, nk, it.col, dh); },
      [&](float* dst, int k0, int nk) { load_rows<T>(dst, a.v, a.n, it.row, k0, nk, it.col, dh); },
      [&](int i, int c, const float* v) {
        store_row8<T>(a.o0, a.n, it.row, it.t0 + i, it.col + c, v);
      });
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

// Blocks of a launch: (rows * heads) items of ceil(len / kTile) tiles.
inline unsigned grid(int rows, const Args& a) {
  return static_cast<unsigned>(rows) * a.heads * ((a.len + kTile - 1) / kTile);
}

inline int forward_smem(int dh) { return smem_bytes(dh, 3 * kTile, 1, 2); }
inline int backward_smem(int dh) { return smem_bytes(dh, 4 * kTile, 2, 3); }  // either side

// A launch of `grid` blocks of kThreads with `smem` bytes of dynamic shared
// memory (the attribute set first: past 48 KB a launch needs it).
template <typename Kernel, typename KArgs>
inline int launch_grid(Kernel kernel, int smem, unsigned grid, const KArgs& a,
                       cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
inline int launch_one(Kernel kernel, int smem, int rows, const Args& a, cudaStream_t stream) {
  return launch_grid(kernel, smem, grid(rows, a), a, stream);
}

// out (a.o0) = attention of a.q, a.k, a.v; rows: the operands' rows (b * n).
template <typename T>
int forward(int rows, const Args& a, cudaStream_t stream) {
  if (a.dh % 8 || a.dh > 128 || a.len < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one(forward_kernel<T>, forward_smem(a.dh), rows, a, stream);
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
