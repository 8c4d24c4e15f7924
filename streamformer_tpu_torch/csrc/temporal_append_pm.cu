// t new frames per stream appended to the position-major KV cache in one
// pass: causal attention of each new frame over its stream's cached prefix
// and the new frames up to itself, then the stream's first `valid` new
// frames written into the cache (kernel E).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_append_pm_ragged
// (kernel body _pm_append_multi_kernel). Same contract: heads are dh-wide
// slices of D; the caches are (C, R, D); row r belongs to stream b = r /
// rows_per_stream, whose lens[b] positions are held in slots 0..lens[b]-1
// (the linear cache: no wrap-around). Query ti of stream b is the frame at
// position lens[b] + ti and attends cache slots < lens[b] and new frames
// 0..ti. New frames ti < valid[b] are then written at slot lens[b] + ti; a
// frame that would land at a slot >= C is dropped. Outputs for ti >=
// valid[b] are computed but unspecified. lens and valid are device int32
// vectors, so a call never waits for the host. The caller keeps lens +
// valid <= C (a host-side check in the serving engine). The TPU kernel's
// bound on t is a VMEM artefact; here a call takes up to 32 new frames (C's
// kMaxT) on any capacity whose plan fits a block's shared memory.
//
// q, k_new, v_new and out are read and written in place, each a base
// pointer and element strides over (b, t, n), D contiguous, as C's operands
// are (fullclip.cuh): the encoder hands over the (B, t, N, 3D) output of
// the qkv projection as it is and takes ctx as a contiguous (B, t, N, D);
// the (t, R, D) entry is the same kernel at N = 1. Row r is b * N + n.
//
// This is temporal_fullclip.cu with a cached prefix in front of the new
// frames: a (row, head)'s key sequence is cache slots 0..len-1, then the t
// new frames. The arithmetic is the full clip's and kernel A's step for
// step: each score one sequential fp32 FMA chain over dh in element order,
// then times the scale; the max, expf(s - max), a sequential sum in key
// order, PV one sequential FMA chain in key order, one multiply by the
// reciprocal of the sum. Only independent chains run in parallel, on the
// CUDA cores. So a stream fed in chunks through this kernel reproduces the
// full clip bit for bit, as A does.
//
// Bound on the H100: bytes. Per (row, head) the work is about (len + t) * t
// * dh FMAs on (2 len + 4 t) * dh elements, a few operations per byte. At
// the flagship shape (t = 8, 8 streams of 196 rows, D = 768, bf16) the call
// moves 2 sum(len) + 4 t B + 2 sum(valid) planes of 196 x 768 x 2 bytes.
// The design is fullclip.cuh's pipeline with the keys streamed in chunks:
//
// - A persistent grid of 288-thread blocks; a work item is one row and a
//   group of `hg` of its heads (`plan`: the most heads whose block leaves
//   room for a second on the SM with the whole key sequence in one stage,
//   else chunks of keys, else one block an SM).
// - A producer warp copies an item's t query rows (spans of hg * dh
//   elements) into a query buffer, then its keys' K spans and then V spans
//   (cache slots, then the new frames, each span one bulk asynchronous
//   copy) in chunks of `chunk` keys into a ring of two stages on mbarriers.
//   Every input byte is read from device memory once; the next item's
//   queries and first chunk are in flight while an item computes.
// - Eight consumer warps compute from shared memory with all their lanes:
//   the scores as one task per (head, query, group of four keys), queries
//   fastest (eight queries' rows in eight bank groups, the keys a
//   broadcast), causal pairs only; the (head, query, key) scores stay in
//   shared memory; the softmax a thread per (head, query); PV a thread per
//   (two queries, head, 8 elements), each staged V chunk feeding both
//   queries' sums, which wait in shared memory between chunks.
// - The appended rows are written from the staged K and V chunks (a new
//   frame's key index is its slot), so k_new and v_new are read once.
//   Reads (slots < len) and writes (slots >= len) are disjoint, and each
//   item writes only its own columns.
#include "fullclip.cuh"

namespace {

using fullclip::consumers_sync;
using fullclip::kConsumers;
using fullclip::kKeyGroup;
using fullclip::kStages;
using fullclip::kThreads;
using fullclip::Operand;
using fullclip::round16;

constexpr int kMaxT = fullclip::kMaxT;  // new frames a call
constexpr int kMinChunk = 8;            // keys a stage holds before a block gives up its pair

// Shared memory of a block: two stages of `chunk` key rows of `row_bytes`
// (hg * dh elements, padded by 16 bytes so that rows of neighbouring
// queries or keys fall in distinct bank groups); the query buffer, a
// 16-byte header (the item's len and valid) and t query rows; the (hg, t,
// ss) fp32 scores; the (hg, t, dh) PV sums when the keys take more than one
// chunk; the reciprocals of the sums (hg, t); the barriers (full and empty
// a stage, then the query buffer's).
struct Plan {
  int hg, groups, chunk, row_bytes, stage_bytes, ss;
  int q, scores, acc, inv, full, empty, qfull, qempty, total;
};

Plan plan_for(int hg, int chunk, int heads, int t_len, int cap, int dh, int elt) {
  Plan p;
  const int keys = cap + t_len;
  p.hg = hg;
  p.groups = heads / hg;
  p.chunk = chunk;
  p.row_bytes = round16(hg * dh * elt) + 16;
  p.stage_bytes = chunk * p.row_bytes;
  p.ss = keys | 1;  // odd: a thread per (head, query) row reads distinct banks
  p.q = kStages * p.stage_bytes;
  p.scores = p.q + 16 + t_len * p.row_bytes;
  p.acc = p.scores + round16(4 * hg * t_len * p.ss);
  p.inv = p.acc + (chunk < keys ? round16(4 * hg * t_len * dh) : 0);
  p.full = p.inv + round16(4 * hg * t_len);
  p.empty = p.full + 8 * kStages;
  p.qfull = p.empty + 8 * kStages;
  p.qempty = p.qfull + 8;
  p.total = p.qempty + 8;
  return p;
}

// The plan of a launch: under the pair budget, then under a block's most,
// the most heads an item with the whole key sequence in one stage, else
// with chunks of at least kMinChunk keys, else of any size; hg == 0 when
// not even one head in chunks of one key fits (the wrapper's
// _append_min_smem repeats that last plan's bytes).
Plan plan(int heads, int t_len, int cap, int dh, int elt) {
  const int keys = cap + t_len;
  for (int limit : {fullclip::kPairBudget, fullclip::kMaxSmem})
    for (int least : {keys, keys < kMinChunk ? keys : kMinChunk, 1})
      for (int hg = heads; hg >= 1; --hg) {
        if (heads % hg) continue;
        const Plan whole = plan_for(hg, keys, heads, t_len, cap, dh, elt);
        if (whole.total <= limit) return whole;
        const Plan one = plan_for(hg, 1, heads, t_len, cap, dh, elt);  // its fixed part
        const int chunk = (limit - (one.total - one.stage_bytes * kStages)) /
                          (kStages * one.row_bytes);
        if (chunk >= least && chunk >= 1) return plan_for(hg, chunk, heads, t_len, cap, dh, elt);
      }
  Plan none = plan_for(1, 1, heads, t_len, cap, dh, elt);
  none.hg = 0;
  return none;
}

struct Args {
  Operand q, k_new, v_new, out;
  void* k_cache;  // (C, R, D)
  void* v_cache;
  const int* lens;  // one per stream
  const int* valid;
  int rows_per_stream;
  Plan p;
  int items, rows, n, t_len, cap, d, dh;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* frame(const Operand& o, int row, int n, int t, int col) {
  return static_cast<const T*>(o.p) + fullclip::at(o, row, n, t, col);
}

// Row `row`'s slot `slot` of a cache, from column `col`.
template <typename T>
__device__ __forceinline__ T* slot_row(void* cache, const Args& a, int slot, int row, int col) {
  return static_cast<T*>(cache) + (static_cast<long long>(slot) * a.rows + row) * a.d + col;
}

// The producer warp: item after item, the query rows into the query buffer
// (with the item's len and valid in its header), then chunks of K spans and
// of V spans into the stages; the lanes share the copies. Lane i holds the
// len and valid of the item 32 items ahead's i-th, loaded once for 32 items.
template <typename T>
__device__ __forceinline__ void produce(unsigned char* smem, const Args& a) {
  const Plan& p = a.p;
  const int lane = threadIdx.x & 31;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  unsigned long long* qfull = reinterpret_cast<unsigned long long*>(smem + p.qfull);
  unsigned long long* qempty = reinterpret_cast<unsigned long long*>(smem + p.qempty);
  const int span = p.hg * a.dh * static_cast<int>(sizeof(T));
  int g = 0, lens = 0, valid = 0;
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    if (k % 32 == 0) {
      const long long ahead = item + static_cast<long long>(lane) * gridDim.x;
      const int stream = ahead < a.items ? static_cast<int>(ahead / p.groups) / a.rows_per_stream
                                         : 0;
      lens = ahead < a.items ? a.lens[stream] : 0;
      valid = ahead < a.items ? a.valid[stream] : 0;
    }
    const int len = __shfl_sync(0xffffffffu, lens, k % 32);
    const int nv = __shfl_sync(0xffffffffu, valid, k % 32);
    const int row = item / p.groups, col = (item - row * p.groups) * p.hg * a.dh;
    const int n_old = min(len, a.cap), n_keys = n_old + a.t_len;
    const int nck = (n_keys + p.chunk - 1) / p.chunk;

    mbar_wait(qempty, (k & 1) ^ 1);
    if (lane == 0) {
      int* hdr = reinterpret_cast<int*>(smem + p.q);
      hdr[0] = len;
      hdr[1] = nv;
      mbar_expect_tx(qfull, a.t_len * span);
    }
    __syncwarp();
    for (int ti = lane; ti < a.t_len; ti += 32)
      bulk_copy_g2s(smem + p.q + 16 + ti * p.row_bytes, frame<T>(a.q, row, a.n, ti, col), span,
                    qfull);

    for (int j = 0; j < 2 * nck; ++j, ++g) {
      const int kv = j >= nck;
      const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, n_keys - k0);
      unsigned long long* bar = full + g % kStages;
      mbar_wait(empty + g % kStages, ((g / kStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(bar, cnt * span);
      __syncwarp();
      unsigned char* st = smem + (g % kStages) * p.stage_bytes;
      for (int i = lane; i < cnt; i += 32) {
        const int key = k0 + i;
        const T* src = key < n_old
                           ? slot_row<T>(kv ? a.v_cache : a.k_cache, a, key, row, col)
                           : frame<T>(kv ? a.v_new : a.k_new, row, a.n, key - n_old, col);
        bulk_copy_g2s(st + i * p.row_bytes, src, span, bar);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) temporal_append_pm_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int tid = threadIdx.x;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  unsigned long long* qfull = reinterpret_cast<unsigned long long*>(smem + p.qfull);
  unsigned long long* qempty = reinterpret_cast<unsigned long long*>(smem + p.qempty);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kConsumers) {  // the producer warp
    produce<T>(smem, a);
    return;
  }

  float* scores = reinterpret_cast<float*>(smem + p.scores);
  float* accs = reinterpret_cast<float*>(smem + p.acc);
  float* invs = reinterpret_cast<float*>(smem + p.inv);
  const int* hdr = reinterpret_cast<const int*>(smem + p.q);
  const T* qs = reinterpret_cast<const T*>(smem + p.q + 16);
  const int t_len = a.t_len, dh = a.dh, hg = p.hg, ss = p.ss, nc = dh / 8;
  const int rs = p.row_bytes / static_cast<int>(sizeof(T));  // elements between staged rows
  const int units = hg * dh * static_cast<int>(sizeof(T)) / 16;  // 16-byte units of a span
  int g = 0;
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    const int row = item / p.groups, col = (item - row * p.groups) * hg * dh;
    mbar_wait(qfull, k & 1);
    const int len = hdr[0], nv = hdr[1];
    const int n_old = min(len, a.cap), n_keys = n_old + t_len;
    const int nck = (n_keys + p.chunk - 1) / p.chunk;
    const int n_append = min(n_old + nv, a.cap) - n_old;  // new frames written: slots n_old..
    for (int j = 0; j < 2 * nck; ++j, ++g) {
      const int kv = j >= nck;
      const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, n_keys - k0);
      mbar_wait(full + g % kStages, (g / kStages) & 1);
      const T* buf = reinterpret_cast<const T*>(smem + (g % kStages) * p.stage_bytes);

      if (!kv) {
        // scores: a task per (head, group of keys, query ti), queries fastest;
        // query ti attends keys <= n_old + ti
        const int groups = (cnt + kKeyGroup - 1) / kKeyGroup, per_h = groups * t_len;
        for (int w = tid; w < hg * per_h; w += kConsumers) {
          const int h = w / per_h, r = w - h * per_h, gi = r / t_len, ti = r - gi * t_len;
          const int j0 = k0 + gi * kKeyGroup, last = n_old + ti;
          if (j0 > last) continue;
          const int nk = min(kKeyGroup, min(k0 + cnt, last + 1) - j0);
          float acc[kKeyGroup];
          fullclip::dot_group(qs + ti * rs + h * dh, buf + (j0 - k0) * rs + h * dh, rs, nk, dh,
                              acc);
          float* to = scores + (h * t_len + ti) * ss + j0;
#pragma unroll
          for (int kk = 0; kk < kKeyGroup; ++kk)
            if (kk < nk) to[kk] = __fmul_rn(acc[kk], a.scale);
        }
      } else {
        // PV of queries t0 and t0 + 1 over this chunk's keys: a thread per
        // (query pair, head, 8 elements), keys in order; the sums wait in
        // shared memory between chunks
        const int per_t = hg * nc, first = k0 == 0, last_chunk = k0 + cnt == n_keys;
        for (int w = tid; w < (t_len + 1) / 2 * per_t; w += kConsumers) {
          const int t0 = w / per_t * 2, r = w - t0 / 2 * per_t, h = r / nc;
          const int c = h * dh + (r - h * nc) * 8;
          const bool two = t0 + 1 < t_len;
          const float* p0 = scores + (h * t_len + t0) * ss;
          const float* p1 = p0 + ss;
          float* sums = accs + (h * t_len + t0) * dh + (c - h * dh);
          float acc[2][8];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            if (first || (f == 1 && !two)) {
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[f][e] = 0.f;
            } else {
              load8(sums + f * dh, acc[f]);
            }
          }
          const int end = min(k0 + cnt, n_old + t0 + 1);  // keys of both queries
#pragma unroll 4
          for (int jj = k0; jj < end; ++jj) {
            float vf[8];
            load8(buf + (jj - k0) * rs + c, vf);
            const float a0 = p0[jj], a1 = two ? p1[jj] : 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc[0][e] = fmaf(a0, vf[e], acc[0][e]);
              acc[1][e] = fmaf(a1, vf[e], acc[1][e]);
            }
          }
          const int extra = n_old + t0 + 1;  // query t0 + 1's own frame
          if (two && extra >= k0 && extra < k0 + cnt) {
            float vf[8];
            load8(buf + (extra - k0) * rs + c, vf);
            const float a1 = p1[extra];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[1][e] = fmaf(a1, vf[e], acc[1][e]);
          }
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            if (f == 1 && !two) continue;
            if (last_chunk) {
              const float inv = invs[h * t_len + t0 + f];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[f][e] = __fmul_rn(acc[f][e], inv);
              store8(static_cast<T*>(a.out.p) + fullclip::at(a.out, row, a.n, t0 + f, col + c),
                     acc[f]);
            } else {
              store8(sums + f * dh, acc[f]);
            }
          }
        }
      }

      // the chunk's new frames that are appended: key index = slot
      const int a0 = max(k0, n_old), a1 = min(k0 + cnt, n_old + n_append);
      for (int w = tid; w < (a1 - a0) * units; w += kConsumers) {
        const int i = a0 + w / units, u = w - (w / units) * units;
        reinterpret_cast<uint4*>(slot_row<T>(kv ? a.v_cache : a.k_cache, a, i, row, col))[u] =
            reinterpret_cast<const uint4*>(buf + (i - k0) * rs)[u];
      }

      if (!kv && j == nck - 1) {  // every score in: the queries' buffer is free, then the softmax
        consumers_sync();
        if (tid == 0) mbar_arrive(qempty);
        for (int w = tid; w < hg * t_len; w += kConsumers) {  // a thread per (head, query)
          float* sr = scores + w * ss;
          const int n = n_old + w % t_len + 1;
          float m = -INFINITY;
          for (int jj = 0; jj < n; ++jj) m = fmaxf(m, sr[jj]);
          float sum = 0.f;
          for (int jj = 0; jj < n; ++jj) {
            const float x = expf(__fsub_rn(sr[jj], m));
            sr[jj] = x;
            sum = __fadd_rn(sum, x);
          }
          invs[w] = __fdiv_rn(1.f, sum);
        }
      }
      consumers_sync();  // every consumer is done with the stage
      if (tid == 0) mbar_arrive(empty + g % kStages);
    }
  }
}

template <typename T>
int launch(const void* const* ptrs, const long long* strides, void* k_cache, void* v_cache,
           const void* lens, const void* valid, int rows_per_stream, int batch, int n,
           int t_len, int cap, int d, int heads, float scale, cudaStream_t stream) {
  const int dh = d / heads;
  const Plan p = plan(heads, t_len, cap, dh, sizeof(T));
  if (p.hg < 1 || t_len < 1 || t_len > kMaxT || dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  Operand* ops[4] = {&a.q, &a.k_new, &a.v_new, &a.out};
  for (int o = 0; o < 4; ++o)
    *ops[o] = {const_cast<void*>(ptrs[o]), strides[3 * o], strides[3 * o + 1],
               strides[3 * o + 2]};
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.lens = static_cast<const int*>(lens);
  a.valid = static_cast<const int*>(valid);
  a.rows_per_stream = rows_per_stream;
  a.p = p;
  a.rows = batch * n;
  a.items = a.rows * p.groups;
  a.n = n;
  a.t_len = t_len;
  a.cap = cap;
  a.d = d;
  a.dh = dh;
  a.scale = scale;
  int blocks = 0;
  const cudaError_t err =
      persistent_grid(temporal_append_pm_kernel<T>, kThreads, p.total, a.items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_append_pm_kernel<T><<<blocks, kThreads, p.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the plan a launch takes (0 when none fits), and its heads
// an item and keys a stage.
extern "C" int sf_temporal_append_pm_plan(int t_len, int capacity, int d, int heads, int dtype,
                                          int* hg, int* chunk) {
  const Plan p = plan(heads, t_len, capacity, d / heads, dtype == SF_BFLOAT16 ? 2 : 4);
  *hg = p.hg;
  *chunk = p.chunk;
  return p.hg ? p.total : 0;
}

// ptrs: q, k_new, v_new, out; strides: their (b, t, n) element strides,
// three each; the caches (C, batch * n, D) contiguous; lens and valid one
// int32 per stream of rows_per_stream rows.
extern "C" int sf_temporal_append_pm(const void* const* ptrs, const long long* strides,
                                     void* k_cache, void* v_cache, const void* lens,
                                     const void* valid, int rows_per_stream, int batch, int n,
                                     int t_len, int capacity, int d, int heads, float scale,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(ptrs, strides, k_cache, v_cache, lens, valid, rows_per_stream,
                                 batch, n, t_len, capacity, d, heads, scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(ptrs, strides, k_cache, v_cache, lens, valid, rows_per_stream, batch,
                         n, t_len, capacity, d, heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
