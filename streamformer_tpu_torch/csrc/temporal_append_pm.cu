// t new frames per stream appended to the position-major KV cache in one
// pass: attention of each new frame over its stream's cached prefix and the
// new frames (causal: up to itself), then the new frames written into the
// cache (kernel E).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_append_pm_ragged
// (kernel body _pm_append_multi_kernel), and the JAX encoder's einsum paths
// that serve what that kernel does not (non-causal appends, more frames, any
// capacity, a cache in another float type, the ring's non-causal chunks:
// streamformer_tpu/models/encoder.py _streaming_attend_pos_major,
// _ragged_attend_einsum, _ring_attend_pos_major). Same contract: heads are
// dh-wide slices of D; the caches are (C, R, D); row r belongs to stream b =
// r / rows_per_stream, whose lens[b] positions are held in the cache.
//
// - Linear (ring = 0): slots 0..lens[b]-1 hold the positions. Query ti of
//   stream b is the frame at position lens[b] + ti and attends cache slots
//   < lens[b] and new frames 0..ti (causal), or all t new frames. New frames
//   ti < valid[b] are then written at slot lens[b] + ti; a frame that would
//   land at a slot >= C is dropped. Outputs for ti >= valid[b] are computed
//   but unspecified. The caller keeps lens + valid <= C (a host-side check
//   in the serving engine).
// - Ring (ring = 1, not causal past one frame): slot s holds the newest
//   position p = s mod C below lens[b]. Every query sees the window of the
//   C positions ending at lens[b] + t - 1: old positions p > lens[b] + t - 1
//   - C (and p >= 0), then new frames j > t - 1 - C. The last min(t, C) new
//   frames are written at slot (lens[b] + j) mod C: exactly the slots of the
//   positions that leave the window, which no query of the call reads, so
//   reads and writes are disjoint as on the linear cache. valid is ignored.
//   At t = 1 this is kernel A's ring step, which the encoder runs here
//   where A's plan does not fit the capacity.
//
// lens and valid are device int32 vectors, so a call never waits for the
// host. q and out are in the compute type T; k_new, v_new and the caches in
// the cache's type KV (float or bfloat16 either way: the caller rounds the
// new frames to KV, as the JAX package writes them before it attends them).
//
// q, k_new, v_new and out are read and written in place, each a base
// pointer and element strides over (b, t, n), D contiguous, as C's operands
// are (fullclip.cuh): the encoder hands over the (B, t, N, 3D) output of
// the qkv projection as it is and takes ctx as a contiguous (B, t, N, D);
// the (t, R, D) entry is the same kernel at N = 1. Row r is b * N + n.
//
// Two bodies, one order of arithmetic:
//
// - The whole-table body (up to kMaxT = 32 new frames, while `plan` fits a
//   block): temporal_fullclip.cu with a cached prefix in front of the new
//   frames. A (row, head)'s key sequence is the cached slots, oldest first,
//   then the new frames.
// - Past that, tiled.cuh's forward bodies on the same key sequence: any t,
//   any capacity; the cached keys read from their slots (ring slots too),
//   the new ones from their frames. Its resident body (a block an item of
//   (row, head, 16, 32 or 64 queries), the scores in shared memory) past 4
//   new frames while a query tile's scores fit; else its split body (the
//   keys split over blocks, the scores in a scratch the wrapper allocates,
//   PV four chains a lane), which serves E's t=1 step past A's plan.
//
// Both take C's and kernel A's arithmetic step for step: each score one
// sequential fp32 FMA chain over dh in element order, then times the
// scale; the max, expf(s - max), a sequential sum in key order, PV one
// sequential FMA chain in key order, one multiply by the reciprocal of the
// sum. Masked keys are skipped, never weighted by zero. So the two bodies
// give the same bits, and a stream fed in chunks through this kernel
// reproduces the full clip bit for bit, as A does.
//
// Bound on the H100: bytes. Per (row, head) the work is about (len + t) * t
// * dh FMAs on (2 len + 4 t) * dh elements, a few operations per byte. At
// the flagship shape (t = 8, 8 streams of 196 rows, D = 768, bf16) the call
// moves 2 sum(len) + 4 t B + 2 sum(valid) planes of 196 x 768 x 2 bytes.
// The whole-table body is fullclip.cuh's pipeline with the keys streamed in
// chunks:
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
//   broadcast), causal pairs only when causal; the (head, query, key)
//   scores stay in shared memory; the softmax a thread per (head, query);
//   PV a thread per (two queries, head, 8 elements), each staged V chunk
//   feeding both queries' sums, which wait in shared memory between chunks.
// - The appended rows are written from the staged K and V chunks, so k_new
//   and v_new are read once; each item writes only its own columns.
//
// The tiled bodies serve the shapes the whole-table plan cannot hold. At
// t = 1 on a long cache they are bound by the bytes of the cached keys (each
// read once, the keys split over enough blocks to fill the card); at many
// new frames by the fp32 FMAs (tiled.cuh's note).
#include "fullclip.cuh"
#include "tiled.cuh"

namespace {

using fullclip::consumers_sync;
using fullclip::kConsumers;
using fullclip::kKeyGroup;
using fullclip::kStages;
using fullclip::kThreads;
using fullclip::Operand;
using fullclip::round16;

constexpr int kMaxT = fullclip::kMaxT;  // new frames the whole-table body takes
constexpr int kMinChunk = 8;            // keys a stage holds before a block gives up its pair

// Shared memory of a block: two stages of `chunk` key rows of `row_bytes`
// (hg * dh cache-type elements, padded by 16 bytes so that rows of
// neighbouring keys fall in distinct bank groups); the query buffer, a
// 16-byte header (the item's len and valid) and t query rows of
// `q_row_bytes` (compute-type elements, padded alike); the (hg, t, ss) fp32
// scores; the (hg, t, dh) PV sums when the keys take more than one chunk;
// the reciprocals of the sums (hg, t); the barriers (full and empty a
// stage, then the query buffer's).
struct Plan {
  int hg, groups, chunk, row_bytes, q_row_bytes, stage_bytes, ss;
  int q, scores, acc, inv, full, empty, qfull, qempty, total;
};

Plan plan_for(int hg, int chunk, int heads, int t_len, int cap, int dh, int elt, int q_elt) {
  Plan p;
  const int keys = cap + t_len;
  p.hg = hg;
  p.groups = heads / hg;
  p.chunk = chunk;
  p.row_bytes = round16(hg * dh * elt) + 16;
  p.q_row_bytes = round16(hg * dh * q_elt) + 16;
  p.stage_bytes = chunk * p.row_bytes;
  p.ss = keys | 1;  // odd: a thread per (head, query) row reads distinct banks
  p.q = kStages * p.stage_bytes;
  p.scores = p.q + 16 + t_len * p.q_row_bytes;
  p.acc = p.scores + round16(4 * hg * t_len * p.ss);
  p.inv = p.acc + (chunk < keys ? round16(4 * hg * t_len * dh) : 0);
  p.full = p.inv + round16(4 * hg * t_len);
  p.empty = p.full + 8 * kStages;
  p.qfull = p.empty + 8 * kStages;
  p.qempty = p.qfull + 8;
  p.total = p.qempty + 8;
  return p;
}

// The plan of a whole-table launch: under the pair budget, then under a
// block's most, the most heads an item with the whole key sequence in one
// stage, else with chunks of at least kMinChunk keys, else of any size;
// hg == 0 when not even one head in chunks of one key fits, or past kMaxT
// frames (the wrapper's _append_min_smem repeats that last plan's bytes).
// The key count C + t bounds the ring's too (at most C).
Plan plan(int heads, int t_len, int cap, int dh, int elt, int q_elt) {
  const int keys = cap + t_len;
  if (t_len <= kMaxT)
    for (int limit : {fullclip::kPairBudget, fullclip::kMaxSmem})
      for (int least : {keys, keys < kMinChunk ? keys : kMinChunk, 1})
        for (int hg = heads; hg >= 1; --hg) {
          if (heads % hg) continue;
          const Plan whole = plan_for(hg, keys, heads, t_len, cap, dh, elt, q_elt);
          if (whole.total <= limit) return whole;
          const Plan one = plan_for(hg, 1, heads, t_len, cap, dh, elt, q_elt);  // its fixed part
          const int chunk = (limit - (one.total - one.stage_bytes * kStages)) /
                            (kStages * one.row_bytes);
          if (chunk >= least && chunk >= 1)
            return plan_for(hg, chunk, heads, t_len, cap, dh, elt, q_elt);
        }
  Plan none = plan_for(1, 1, heads, t_len, cap, dh, elt, q_elt);
  none.hg = 0;
  return none;
}

struct Args {
  Operand q, k_new, v_new, out;  // q, out: T; k_new, v_new: KV
  void* k_cache;  // (C, R, D) of KV
  void* v_cache;
  const int* lens;  // one per stream
  const int* valid;
  int rows_per_stream;
  Plan p;
  int items, rows, n, t_len, cap, d, dh, heads, causal, ring;
  float scale;
};

// An item's key sequence: n_old cached slots from slot0 on (mod C), oldest
// first, then new frames f0 .. t - 1; n_write of those new frames (from
// f0 on) are written, frame f at slot_of(f).
struct Keys {
  int len, n_old, slot0, f0, n_keys, n_write;
};

__device__ __forceinline__ Keys keys_of(const Args& a, int len, int nv) {
  Keys k;
  k.len = len;
  if (a.ring) {  // the window of the C positions ending at len + t - 1
    const int n_new = min(a.t_len, a.cap);
    k.n_old = max(0, min(len, a.cap - a.t_len));
    k.slot0 = (len - k.n_old) % a.cap;
    k.f0 = a.t_len - n_new;
    k.n_keys = k.n_old + n_new;
    k.n_write = n_new;
  } else {
    k.n_old = min(len, a.cap);
    k.slot0 = 0;
    k.f0 = 0;
    k.n_keys = k.n_old + a.t_len;
    k.n_write = min(k.n_old + nv, a.cap) - k.n_old;
  }
  return k;
}

// The slot new frame f is written at.
__device__ __forceinline__ int slot_of(const Args& a, const Keys& k, int f) {
  return a.ring ? (k.len + f) % a.cap : k.n_old + f;
}

template <typename T>
__device__ __forceinline__ const T* frame(const Operand& o, int row, int n, int t, int col) {
  return static_cast<const T*>(o.p) + fullclip::at(o, row, n, t, col);
}

// Row `row`'s slot `slot` of a cache, from column `col`.
template <typename KV>
__device__ __forceinline__ KV* slot_row(void* cache, const Args& a, int slot, int row, int col) {
  return static_cast<KV*>(cache) + (static_cast<long long>(slot) * a.rows + row) * a.d + col;
}

// Key i's row of K (kv 0) or V (kv 1), from column col: a cached slot, or
// a new frame.
template <typename KV>
__device__ __forceinline__ const KV* key_row(const Args& a, const Keys& k, int kv, int i, int row,
                                             int col) {
  if (i < k.n_old) {
    int s = k.slot0 + i;
    if (s >= a.cap) s -= a.cap;
    return slot_row<KV>(kv ? a.v_cache : a.k_cache, a, s, row, col);
  }
  return frame<KV>(kv ? a.v_new : a.k_new, row, a.n, k.f0 + i - k.n_old, col);
}

// The producer warp: item after item, the query rows into the query buffer
// (with the item's len and valid in its header), then chunks of K spans and
// of V spans into the stages; the lanes share the copies. Lane i holds the
// len and valid of the item 32 items ahead's i-th, loaded once for 32 items.
template <typename T, typename KV>
__device__ __forceinline__ void produce(unsigned char* smem, const Args& a) {
  const Plan& p = a.p;
  const int lane = threadIdx.x & 31;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  unsigned long long* qfull = reinterpret_cast<unsigned long long*>(smem + p.qfull);
  unsigned long long* qempty = reinterpret_cast<unsigned long long*>(smem + p.qempty);
  const int span = p.hg * a.dh * static_cast<int>(sizeof(KV));
  const int q_span = p.hg * a.dh * static_cast<int>(sizeof(T));
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
    const Keys ks = keys_of(a, len, nv);
    const int nck = (ks.n_keys + p.chunk - 1) / p.chunk;

    mbar_wait(qempty, (k & 1) ^ 1);
    if (lane == 0) {
      int* hdr = reinterpret_cast<int*>(smem + p.q);
      hdr[0] = len;
      hdr[1] = nv;
      mbar_expect_tx(qfull, a.t_len * q_span);
    }
    __syncwarp();
    for (int ti = lane; ti < a.t_len; ti += 32)
      bulk_copy_g2s(smem + p.q + 16 + ti * p.q_row_bytes, frame<T>(a.q, row, a.n, ti, col),
                    q_span, qfull);

    for (int j = 0; j < 2 * nck; ++j, ++g) {
      const int kv = j >= nck;
      const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, ks.n_keys - k0);
      unsigned long long* bar = full + g % kStages;
      mbar_wait(empty + g % kStages, ((g / kStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(bar, cnt * span);
      __syncwarp();
      unsigned char* st = smem + (g % kStages) * p.stage_bytes;
      for (int i = lane; i < cnt; i += 32)
        bulk_copy_g2s(st + i * p.row_bytes, key_row<KV>(a, ks, kv, k0 + i, row, col), span, bar);
    }
  }
}

// kCausal: the mask (query ti sees keys <= n_old + ti), else every key.
template <typename T, typename KV, bool kCausal>
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
    produce<T, KV>(smem, a);
    return;
  }

  float* scores = reinterpret_cast<float*>(smem + p.scores);
  float* accs = reinterpret_cast<float*>(smem + p.acc);
  float* invs = reinterpret_cast<float*>(smem + p.inv);
  const int* hdr = reinterpret_cast<const int*>(smem + p.q);
  const T* qs = reinterpret_cast<const T*>(smem + p.q + 16);
  const int t_len = a.t_len, dh = a.dh, hg = p.hg, ss = p.ss, nc = dh / 8;
  const int rs = p.row_bytes / static_cast<int>(sizeof(KV));  // elements between staged keys
  const int qrs = p.q_row_bytes / static_cast<int>(sizeof(T));  // and staged queries
  const int units = hg * dh * static_cast<int>(sizeof(KV)) / 16;  // 16-byte units of a span
  int g = 0;
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    const int row = item / p.groups, col = (item - row * p.groups) * hg * dh;
    mbar_wait(qfull, k & 1);
    const Keys ks = keys_of(a, hdr[0], hdr[1]);
    const int n_old = ks.n_old, n_keys = ks.n_keys;
    const int nck = (n_keys + p.chunk - 1) / p.chunk;
    for (int j = 0; j < 2 * nck; ++j, ++g) {
      const int kv = j >= nck;
      const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, n_keys - k0);
      mbar_wait(full + g % kStages, (g / kStages) & 1);
      const KV* buf = reinterpret_cast<const KV*>(smem + (g % kStages) * p.stage_bytes);

      if (!kv) {
        // scores: a task per (head, group of keys, query ti), queries fastest;
        // query ti attends keys <= n_old + ti (causal) or every key
        const int groups = (cnt + kKeyGroup - 1) / kKeyGroup, per_h = groups * t_len;
        for (int w = tid; w < hg * per_h; w += kConsumers) {
          const int h = w / per_h, r = w - h * per_h, gi = r / t_len, ti = r - gi * t_len;
          const int j0 = k0 + gi * kKeyGroup, last = kCausal ? n_old + ti : n_keys - 1;
          if (j0 > last) continue;
          const int nk = min(kKeyGroup, min(k0 + cnt, last + 1) - j0);
          float acc[kKeyGroup];
          fullclip::dot_group(qs + ti * qrs + h * dh, buf + (j0 - k0) * rs + h * dh, rs, nk, dh,
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
          // keys of both queries (causal: t0's; t0 + 1's last one below)
          const int end = kCausal ? min(k0 + cnt, n_old + t0 + 1) : k0 + cnt;
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
          if (kCausal && two && extra >= k0 && extra < k0 + cnt) {
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

      // the chunk's new frames that are written, from the staged rows
      const int a0 = max(k0, n_old), a1 = min(k0 + cnt, n_old + ks.n_write);
      for (int w = tid; w < (a1 - a0) * units; w += kConsumers) {
        const int i = a0 + w / units, u = w - (w / units) * units;
        KV* to = slot_row<KV>(kv ? a.v_cache : a.k_cache, a,
                              slot_of(a, ks, ks.f0 + i - n_old), row, col);
        reinterpret_cast<uint4*>(to)[u] = reinterpret_cast<const uint4*>(buf + (i - k0) * rs)[u];
      }

      if (!kv && j == nck - 1) {  // every score in: the queries' buffer is free, then the softmax
        consumers_sync();
        if (tid == 0) mbar_arrive(qempty);
        for (int w = tid; w < hg * t_len; w += kConsumers) {  // a thread per (head, query)
          float* sr = scores + w * ss;
          const int n = kCausal ? n_old + w % t_len + 1 : n_keys;
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

// The new frames that an item writes, columns c0 .. c0 + cw - 1 of its head
// (cols: its first column), from k_new and v_new into their slots, by
// every thread of the block (reads and writes are disjoint, so the order
// among blocks does not matter).
template <typename KV>
__device__ __forceinline__ void write_frames(const Args& a, const Keys& ks, int row, int col,
                                             int c0, int cw) {
  const int nc = cw / 8;
  for (int w = threadIdx.x; w < 2 * ks.n_write * nc; w += blockDim.x) {
    const int kv = w / (ks.n_write * nc), r = w - kv * ks.n_write * nc;
    const int f = ks.f0 + r / nc, c = col + c0 + r % nc * 8;
    copy8(slot_row<KV>(kv ? a.v_cache : a.k_cache, a, slot_of(a, ks, f), row, c),
          frame<KV>(kv ? a.v_new : a.k_new, row, a.n, f, c));
  }
}

// The tiled bodies (tiled.cuh) on an item's key sequence: the cached slots,
// then the new frames; the cached keys read from their slots.
__device__ __forceinline__ Keys item_keys(const Args& a, int row) {
  const int stream = row / a.rows_per_stream;
  return keys_of(a, a.lens[stream], a.valid[stream]);
}

// Resident: a block an item of (row, head, qt queries); the block of an
// item's first query tile also writes its head's slice of the appended rows.
template <typename T, typename KV, int QB>
__global__ void __launch_bounds__(tiled::kFwdThreads)
    temporal_append_pm_tiled_kernel(const Args a, const tiled::Resident r) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dh = a.dh, tiles = (a.t_len + r.qt - 1) / r.qt;
  const int rh = blockIdx.x / tiles, row = rh / a.heads, col = (rh - row * a.heads) * dh;
  const int t0 = (blockIdx.x - rh * tiles) * r.qt;
  const Keys ks = item_keys(a, row);
  tiled::resident<T, KV, QB>(
      smem, r, dh, t0, min(r.qt, a.t_len - t0), ks.n_keys, a.causal, ks.n_old, a.scale,
      [&](int i) -> const T* { return frame<T>(a.q, row, a.n, i, col); },
      [&](int kv, int j) { return key_row<KV>(a, ks, kv, j, row, col); },
      [&](int i, int c, const float* v) {
        store8(static_cast<T*>(a.out.p) + fullclip::at(a.out, row, a.n, i, col + c), v);
      });
  if (t0 == 0) write_frames<KV>(a, ks, row, col, 0, dh);
}

// Split, the scores: a block a (row, head, chunk of tiled::kSplitKeys keys).
template <typename T, typename KV, int NQ>
__global__ void __launch_bounds__(tiled::kFwdConsumers)
    temporal_append_pm_tiled_scores_kernel(const Args a, const tiled::Split sp) {
  extern __shared__ __align__(16) float smf[];
  const int rh = sp.rh0 + static_cast<int>(blockIdx.x) / sp.nch;
  const int chunk = static_cast<int>(blockIdx.x) % sp.nch;
  const int row = rh / a.heads, col = (rh - row * a.heads) * a.dh;
  const Keys ks = item_keys(a, row);
  tiled::split_scores<T, KV, NQ>(
      smf, a.dh, sp.q0, sp.nq, chunk, ks.n_keys, a.causal, ks.n_old, a.scale,
      tiled::split_scores_of(sp, rh), sp.ls, tiled::split_maxes_of(sp, rh), sp.nch,
      [&](int i) -> const T* { return frame<T>(a.q, row, a.n, i, col); },
      [&](int kv, int j) { return key_row<KV>(a, ks, kv, j, row, col); });
}

// Split, PV: a block a (row, head, tiled::kPvCols columns, tiled::kPvQueries
// queries); the blocks of an item's first query group write their columns
// of the appended rows.
template <typename T, typename KV>
__global__ void __launch_bounds__(tiled::kFwdConsumers)
    temporal_append_pm_tiled_pv_kernel(const Args a, const tiled::Split sp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const tiled::PvBlock b = tiled::pv_block(sp, a.dh);
  const int row = b.rh / a.heads, col = (b.rh - row * a.heads) * a.dh;
  const Keys ks = item_keys(a, row);
  tiled::split_pv<T, KV>(
      smem, a.dh, b.qa, b.nq, sp.nq, b.slab, ks.n_keys, a.causal, ks.n_old,
      tiled::split_scores_of(sp, b.rh) + b.first * sp.ls, sp.ls,
      tiled::split_maxes_of(sp, b.rh) + b.first * sp.nch, sp.nch, sp.kt,
      [&](int kv, int j) { return key_row<KV>(a, ks, kv, j, row, col); },
      [&](int i, int c, float v) {
        tiled::store1(static_cast<T*>(a.out.p) + fullclip::at(a.out, row, a.n, i, col + c), v);
      });
  if (b.qa == 0) {
    const int c0 = b.slab * tiled::kPvCols;
    write_frames<KV>(a, ks, row, col, c0, min(tiled::kPvCols, a.dh - c0));
  }
}

// The tiled bodies' launches at cap + t keys (qt, scratch, floats:
// tiled::forward_launch's).
template <typename T, typename KV>
int launch_tiled(const Args& a, int qt, float* scratch, long long floats, cudaStream_t stream) {
  return tiled::forward_launch(
      a, static_cast<unsigned>(a.rows) * a.heads, a.t_len, a.cap + a.t_len, a.dh, sizeof(KV), qt,
      scratch, floats, stream, temporal_append_pm_tiled_kernel<T, KV, 1>,
      temporal_append_pm_tiled_kernel<T, KV, 2>, temporal_append_pm_tiled_kernel<T, KV, 4>,
      temporal_append_pm_tiled_scores_kernel<T, KV, 1>,
      temporal_append_pm_tiled_scores_kernel<T, KV, 4>,
      temporal_append_pm_tiled_scores_kernel<T, KV, tiled::kSplitQueries>,
      temporal_append_pm_tiled_pv_kernel<T, KV>);
}

template <typename T, typename KV>
int launch(const void* const* ptrs, const long long* strides, void* k_cache, void* v_cache,
           const void* lens, const void* valid, int rows_per_stream, int batch, int n,
           int t_len, int cap, int d, int heads, float scale, int causal, int ring, int tiled_body,
           float* scratch, long long floats, cudaStream_t stream) {
  const int dh = d / heads;
  if (t_len < 1 || dh % 8 || dh > 128 || (ring && causal && t_len > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  Operand* ops[4] = {&a.q, &a.k_new, &a.v_new, &a.out};
  for (int o = 0; o < 4; ++o) *ops[o] = fullclip::operand(ptrs, strides, o);
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.lens = static_cast<const int*>(lens);
  a.valid = static_cast<const int*>(valid);
  a.rows_per_stream = rows_per_stream;
  a.rows = batch * n;
  a.n = n;
  a.t_len = t_len;
  a.cap = cap;
  a.d = d;
  a.dh = dh;
  a.heads = heads;
  a.causal = causal;
  a.ring = ring;
  a.scale = scale;
  if (tiled_body)
    return launch_tiled<T, KV>(a, tiled_body < 0 ? 0 : tiled_body, scratch, floats, stream);
  a.p = plan(heads, t_len, cap, dh, sizeof(KV), sizeof(T));
  if (a.p.hg < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.items = a.rows * a.p.groups;
  auto kernel = causal ? temporal_append_pm_kernel<T, KV, true>
                       : temporal_append_pm_kernel<T, KV, false>;
  int blocks = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, a.p.total, a.items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, a.p.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int elt(int dtype) { return dtype == SF_BFLOAT16 ? 2 : 4; }

}  // namespace

// The whole-table plan of a launch with queries and caches of one dtype:
// its shared memory (0 when none fits), heads an item and keys a stage.
extern "C" int sf_temporal_append_pm_plan(int t_len, int capacity, int d, int heads, int dtype,
                                          int* hg, int* chunk) {
  const Plan p = plan(heads, t_len, capacity, d / heads, elt(dtype), elt(dtype));
  *hg = p.hg;
  *chunk = p.chunk;
  return p.hg ? p.total : 0;
}

// Shared memory a block of the whole-table body needs, queries of dtype and
// caches of kv_dtype; 0 where only the tiled body takes the shape (past
// kMaxT frames, or no plan fits).
extern "C" int sf_temporal_append_pm_smem_bytes(int t_len, int capacity, int d, int heads,
                                                int dtype, int kv_dtype) {
  const Plan p = plan(heads, t_len, capacity, d / heads, elt(kv_dtype), elt(dtype));
  return p.hg ? p.total : 0;
}

// ptrs: q, k_new, v_new, out; strides: their (b, t, n) element strides,
// three each; the caches (C, batch * n, D) contiguous; lens and valid one
// int32 per stream of rows_per_stream rows. q and out of dtype, k_new, v_new
// and the caches of kv_dtype. causal: 0 lets every query see every key;
// ring: the ring's window (not causal past one frame); tiled: 0 runs the
// whole-table body, else tiled.cuh's (the same bits): 64, 32 or 16 its resident
// body at that many queries a block, -1 its split body on `scratch`, `floats`
// fp32 (ops._tiled_scratch's size at capacity + t_len keys; null otherwise).
extern "C" int sf_temporal_append_pm(const void* const* ptrs, const long long* strides,
                                     void* k_cache, void* v_cache, const void* lens,
                                     const void* valid, int rows_per_stream, int batch, int n,
                                     int t_len, int capacity, int d, int heads, float scale,
                                     int causal, int ring, int tiled, void* scratch,
                                     long long floats, int dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
#define SF_APPEND(T, KV)                                                                      \
  return launch<T, KV>(ptrs, strides, k_cache, v_cache, lens, valid, rows_per_stream, batch, n, \
                       t_len, capacity, d, heads, scale, causal, ring, tiled, sp, floats, st)
  const bool q16 = dtype == SF_BFLOAT16, kv16 = kv_dtype == SF_BFLOAT16;
  if ((!q16 && dtype != SF_FLOAT32) || (!kv16 && kv_dtype != SF_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q16 && kv16) SF_APPEND(__nv_bfloat16, __nv_bfloat16);
  if (q16) SF_APPEND(__nv_bfloat16, float);
  if (kv16) SF_APPEND(float, __nv_bfloat16);
  SF_APPEND(float, float);
#undef SF_APPEND
}
