// The body of the t=1 decode kernels: A, D and J on a float cache
// (temporal_decode_pm.cu), F and G on an int8 cache
// (temporal_decode_pm_int8.cu), and, read-only, K on the row-major cache,
// float or int8 (temporal_decode_rm.cu). Each source wraps decode_rows in
// its own __global__ kernel; the contracts are in those sources.
//
// Bound on the H100: bytes (one to two operations per byte of the cache).
// A (row, head) holds only 2-4 KB of K and V at the flagship, so the body
// keeps whole rows in flight, K and V at once, and never waits for one
// before asking for the next.
//
// Here a block owns a row across all heads, and walks rows: the grid is
// persistent (as many blocks as fit on the card), block b taking rows b,
// b + grid, ... In the pos-major layout a row's slot in a plane is one
// contiguous run of D elements (1536 bytes in bf16 at the flagship), in
// the row-major layout too. One producer warp copies, row after row, the
// query's row and the valid prefix of K and then of V, each slot (the new
// frame's row last) with one bulk asynchronous copy (cp.async.bulk,
// completing on an mbarrier), into a ring of two stages of up to `chunk`
// slots; it refills a stage as soon as the consumers hand it back (another
// mbarrier), so the next chunk, or the next row's first, is in flight
// while a chunk computes. The int8 scales of a chunk's keys are copied
// once by the producer's lanes, with 4-byte cp.async on the same barrier.
//
// The eight consumer warps compute from shared memory: one thread per
// (head, key) for the score chains and the exps, one thread per head for
// the max and the sum, one thread per (head, 8 elements) for PV, whose
// sums wait in shared memory between V chunks. A staged slot row is padded
// by 16 bytes (but in the read-only mode, below), so that the eight threads
// of a quarter warp, at eight consecutive keys of one head, read eight
// distinct bank groups. The new frame's row, staged as the last key, is
// written to slot len % C from shared memory (and, int8, its two scales);
// no block reads that slot.
//
// Rows whose byte width is not a multiple of 16 (int8 with D % 16 == 8)
// cannot be bulk-copied: there the producer's lanes stage them with 8-byte
// loads, and the arithmetic is the same.
//
// The order of arithmetic is the contract (temporal_fullclip.cu repeats
// it, so a linear stream equals the full clip bit for bit): per (row,
// head), each score is one sequential fp32 FMA chain over dh in element
// order, times the scale (int8: times the key's scale, then the scale);
// the max, expf(s - max), a sequential sum in key order, oldest first and
// the new frame last; the reciprocal of the sum; PV one sequential FMA
// chain in key order (int8: with weight p * v_scale); one multiply by the
// reciprocal last.
//
// Past the plan (the (heads, C) scores of a row no longer fit a block's
// shared memory: about C = 3,800 at the flagship) the same body keeps them
// in an fp32 scratch the wrapper allocates, one slice of heads x
// score_stride(C) floats a block, the persistent grid cut to the slices it
// holds (Args::scores non-null). Staging, the chains and the order of
// arithmetic are the same, so the scratch mode gives the whole-row body's
// bits; only where the scores live changes. Each head's max is exact in any
// order, so there it is folded chunk by chunk as the scores are produced (a
// segmented warp max, then one shared-memory atomic a head and warp on its
// order-preserving integer key) instead of a second walk. Each V chunk then
// reads its keys' scores back once, all threads at once, and stages their
// exps in shared memory, where PV reads them and each head's sum, one
// thread in key order, adds them chunk by chunk; the reciprocal and PV's
// last multiply follow the last chunk. Its stages hold up to 64 keys and
// 48 KB of slots (a block walks a long row alone).
//
// The read-only mode (kReadOnly, kernel K) takes keys 0..min(len, C-1) of
// the linear cache in position order, the new frame already at position
// len; it has no new row and writes nothing. On the row-major cache a
// chunk's positions are one contiguous span, copied with one bulk copy into
// unpadded slots (measured faster than a copy a slot into padded ones); so
// that the threads of neighbouring keys still read distinct bank groups,
// each score chain starts at a load of its own (the key's position in the
// row, modulo the loads a head's row takes, so that a chunk's size leaves
// the order alone) and wraps around: K's scores are one
// sequential fp32 FMA chain over dh, in that rotated order (K is held to
// its plain version within tolerance, not bit for bit to another kernel).
// Its int8 cache keeps one scale per (row, position, head), (R, C, H): a
// chunk's scales are one span of chunk x H floats (one bulk copy where H %
// 4 == 0, else the lanes' 4-byte copies), and K's own order applies the
// scale after the dot's scale: (dot * scale) * k_scale.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace decode {

constexpr int kConsumers = 256;            // eight consumer warps
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStages = 2;                 // of the ring
constexpr int kMaxChunk = 32;              // keys a stage holds at most: a producer lane each
constexpr int kSlotBudget = 18624;         // slot bytes of a stage: 12 bf16 rows at D=768
// The scratch mode's stages (its scores leave shared memory to them): up to
// 64 keys and 48 KB of slots, so that a block, which walks a long row alone,
// keeps some 100 KB in flight
constexpr int kScratchMaxChunk = 64;
constexpr int kScratchSlotBudget = 49152;

// Shared memory of a block. A stage holds `chunk` slot rows of
// `slot_bytes`, then the query's row (used by a row's first chunk), the
// chunk's int8 scales and the row's length. After the two stages: the
// query in fp32, PV sums, (heads, C) fp32 scores (rows C + 1 apart, so
// that a thread per head reads distinct banks; none in the scratch mode),
// the reciprocals of the sums, (scratch mode) each head's running max as
// an integer key, its running sum and a V chunk's (heads, chunk) exps, and
// the barriers.
struct Plan {
  int slot_bytes, chunk, q_at, scales_at, len_at, stage_bytes;
  int q, acc, scores, inv, max_keys, sums, xs, full, empty, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// The scratch mode's floats between two heads' score rows: C + 1 rounded
// up to 4, so that each row starts 16 bytes aligned.
__host__ __device__ inline int score_stride(int capacity) { return (capacity + 4) & ~3; }

// scale_cols: int8 scales a key (F, G: 1 a row; K: one a head); span: the
// read-only mode's unpadded slots, a chunk one copy (rows of whole 16 bytes);
// scratch: the scores in the wrapper's scratch, not in shared memory
__host__ __device__ inline Plan plan(int d, int heads, int capacity, int kv_bytes, int q_bytes,
                                     bool quant, int scale_cols = 1, bool span = false,
                                     bool scratch = false) {
  Plan p;
  p.slot_bytes = round16(d * kv_bytes) + (span && d * kv_bytes % 16 == 0 ? 0 : 16);
  const int most_chunk = scratch ? kScratchMaxChunk : kMaxChunk;
  const int most = capacity < most_chunk ? capacity : most_chunk;
  p.chunk = (scratch ? kScratchSlotBudget : kSlotBudget) / p.slot_bytes;
  p.chunk = p.chunk < 1 ? 1 : (p.chunk > most ? most : p.chunk);
  p.q_at = p.chunk * p.slot_bytes;
  p.scales_at = p.q_at + round16(d * q_bytes);
  p.len_at = p.scales_at + (quant ? round16(4 * p.chunk * scale_cols) : 0);
  p.stage_bytes = p.len_at + 16;
  p.q = kStages * p.stage_bytes;
  p.acc = p.q + round16(4 * d);
  p.scores = p.acc + round16(4 * d);
  p.inv = p.scores + (scratch ? 0 : round16(4 * heads * (capacity + 1)));
  p.max_keys = p.inv + round16(4 * heads);
  p.sums = p.max_keys + (scratch ? round16(4 * heads) : 0);
  p.xs = p.sums + (scratch ? round16(4 * heads) : 0);
  p.full = p.xs + (scratch ? round16(4 * heads * p.chunk) : 0);
  p.empty = p.full + 8 * kStages;
  p.total = p.empty + 8 * kStages;
  return p;
}

template <typename T, typename KV>
struct Args {
  const T* q;
  const KV* k_new;
  const KV* v_new;
  const float* k_new_scale;  // int8 only: (R,)
  const float* v_new_scale;
  KV* k_cache;
  KV* v_cache;
  float* k_scale;  // int8 only: (C, R); read-only: (R, C, H)
  float* v_scale;
  const int* lens;  // one per stream; row r is stream r / rows_per_stream
  int rows_per_stream;
  T* out;
  int rows, capacity, d, heads;
  long slot_stride, row_stride;  // elements between slots, and rows, of a cache
  float scale;
  float* scores = nullptr;  // scratch mode: heads x score_stride(C) floats a block
};

// The persistent grid of a launch: as many blocks as fit the card, at most
// one a row; in the scratch mode (scratch non-null) at most as many as its
// `floats` hold slices of heads x score_stride(C), and none if not even one.
// The wrapper sizes the scratch from this grid at the scratch mode's plan
// (each kernel file's sf_*_scratch_blocks entry).
template <typename Kernel>
inline cudaError_t grid(Kernel kernel, const Plan& p, int rows, int heads, int capacity,
                        const float* scratch, long long floats, int* blocks) {
  const cudaError_t err = persistent_grid(kernel, kThreads, p.total, rows, blocks);
  if (err != cudaSuccess || !scratch) return err;
  const long long fit = floats / (static_cast<long long>(heads) * score_stride(capacity));
  if (fit < 1) return cudaErrorInvalidValue;
  if (fit < *blocks) *blocks = static_cast<int>(fit);
  return cudaSuccess;
}

// The eight consumer warps' own barrier (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Four int8 codes (a 32-bit word) to fp32, exactly: each code, offset by
// 128, becomes the low byte of the mantissa of 2^23, and 2^23 + 128 is
// subtracted (a byte permute and an add, where a conversion instruction
// runs at an eighth of the FMA rate).
__device__ __forceinline__ void codes4(unsigned w, float* o) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    o[b] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + b)), 8388736.f);
}

// The dot product of a head's query (fp32) with one key row, both in
// shared memory: one fmaf chain in element order.
// kRotate (the read-only mode's unpadded slots): the chain starts at the
// rot-th load of the row and wraps around, so that neighbouring keys' threads
// read distinct bank groups at each step.
template <typename KV, bool kRotate = false>
__device__ __forceinline__ float dot(const float* q, const KV* k, int dh, int rot = 0) {
  float s = 0.f;
  if constexpr (std::is_same<KV, int8_t>::value) {
    if (dh % 16 == 0) {  // 16 codes a load
      int c = kRotate ? rot % (dh / 16) * 16 : 0;
      for (int u = 0; u < dh; u += 16, c = kRotate && c + 16 == dh ? 0 : c + 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(k + c);
        float kf[16], qf[16];
        codes4(raw.x, kf);
        codes4(raw.y, kf + 4);
        codes4(raw.z, kf + 8);
        codes4(raw.w, kf + 12);
        load8(q + c, qf);
        load8(q + c + 8, qf + 8);
#pragma unroll
        for (int e = 0; e < 16; ++e) s = fmaf(qf[e], kf[e], s);
      }
    } else {  // a head slice 8 bytes aligned: 8 codes a load
      for (int c = 0; c < dh; c += 8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(k + c);
        float kf[8], qf[8];
        codes4(raw.x, kf);
        codes4(raw.y, kf + 4);
        load8(q + c, qf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qf[e], kf[e], s);
      }
    }
  } else {
    int c = kRotate ? rot % (dh / 8) * 8 : 0;
    for (int u = 0; u < dh; u += 8, c = kRotate && c + 8 == dh ? 0 : c + 8) {
      float kf[8], qf[8];
      load8(k + c, kf);
      load8(q + c, qf);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(qf[e], kf[e], s);
    }
  }
  return s;
}

// A float's order-preserving unsigned key (b > a as floats iff key(b) >
// key(a), -0 below +0), and back.
__device__ __forceinline__ unsigned max_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_max(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// The scratch mode's running max: every lane of the warp calls it with its
// score s of head h (on: the lane has one). Lanes of one head are
// neighbours (h = w / cnt), so a segmented shuffle reduction leaves each
// head's max over the warp in its first lane, which folds it into keys[h].
// NaN is skipped, as fmaxf skips it in the whole-row body's walk.
__device__ __forceinline__ void fold_max(unsigned* keys, int h, float s, bool on, int lane) {
  float m = on && s == s ? s : -INFINITY;
  const int hh = on ? h : -1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float mo = __shfl_down_sync(0xffffffffu, m, o);
    const int ho = __shfl_down_sync(0xffffffffu, hh, o);
    if (lane + o < 32 && ho == hh) m = fmaxf(m, mo);
  }
  const int before = __shfl_up_sync(0xffffffffu, hh, 1);
  if (on && (lane == 0 || before != hh)) atomicMax(keys + h, max_key(m));
}

// Eight consecutive elements of a staged row, in fp32.
__device__ __forceinline__ void eight(const float* p, float* o) { load8(p, o); }
__device__ __forceinline__ void eight(const __nv_bfloat16* p, float* o) { load8(p, o); }
__device__ __forceinline__ void eight(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  codes4(raw.x, o);
  codes4(raw.y, o + 4);
}

template <typename T, typename KV, bool kReadOnly = false>
__device__ __forceinline__ void decode_rows(const Args<T, KV>& a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool in_scratch = a.scores != nullptr;
  const Plan p = plan(a.d, a.heads, a.capacity, sizeof(KV), sizeof(T), kQuant,
                      kReadOnly ? a.heads : 1, kReadOnly, in_scratch);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, heads = a.heads, dh = d / heads, cap = a.capacity;
  const int row_bytes = d * static_cast<int>(sizeof(KV));
  const int q_bytes = d * static_cast<int>(sizeof(T));
  const bool bulk = row_bytes % 16 == 0;  // else 8-byte loads (int8, D % 16 == 8)
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  auto stage = [&](int g) { return smem + (g % kStages) * p.stage_bytes; };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kQuant ? 33 : 1);  // int8: and the lanes' scale copies
      mbar_init(empty + s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ---- the producer warp
    int g = 0, lens = 0;          // g: chunks issued; lens: lane i holds row k + i's length
    for (int k = 0, row = blockIdx.x; row < a.rows; ++k, row += gridDim.x) {
      if (k % 32 == 0) {
        const long r = row + static_cast<long>(lane) * gridDim.x;
        lens = r < a.rows ? a.lens[r / a.rows_per_stream] : 0;
      }
      const int len = __shfl_sync(0xffffffffu, lens, k % 32);
      const int n_old = min(len, cap - 1);
      const int n_keys = n_old + 1;
      const int slot0 = kReadOnly ? 0 : (len - n_old) % cap;
      const int nck = (n_keys + p.chunk - 1) / p.chunk;
      // key i's row of K (kv 0) or V (kv 1): slot (slot0 + i) % C, the new
      // frame last (read-only: slot i, the new frame's among them)
      auto source = [&](int kv, int i) -> const KV* {
        if (!kReadOnly && i == n_old)
          return (kv ? a.v_new : a.k_new) + static_cast<long>(row) * d;
        int s = slot0 + i;
        if (s >= cap) s -= cap;
        return (kv ? a.v_cache : a.k_cache) + s * a.slot_stride + row * a.row_stride;
      };
      // read-only int8: the chunk's (keys, H) scales, one span
      const bool scale_span = kReadOnly && kQuant && heads % 4 == 0;
      for (int j = 0; j < 2 * nck; ++j, ++g) {
        const int kv = j >= nck;
        const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, n_keys - k0);
        mbar_wait(empty + g % kStages, ((g / kStages) & 1) ^ 1);
        unsigned char* st = stage(g);
        const float* scale_src =  // read-only int8: the chunk's scales span
            kReadOnly && kQuant
                ? (kv ? a.v_scale : a.k_scale) + (static_cast<long>(row) * cap + k0) * heads
                : nullptr;
        if (kQuant) {
          if (kReadOnly) {  // the lanes' 4-byte copies where the span is not 16-byte aligned
            if (!scale_span)
              for (int e = lane; e < cnt * heads; e += 32)
                cp_async4(st + p.scales_at + 4 * e, scale_src + e);
          } else {  // the scale of key k0 + e, copied by lane e % 32
            for (int e = lane; e < cnt; e += 32) {
              const int i = k0 + e;
              long s = slot0 + i;
              if (s >= cap) s -= cap;
              const float* src = i == n_old ? (kv ? a.v_new_scale : a.k_new_scale) + row
                                            : (kv ? a.v_scale : a.k_scale) + s * a.rows + row;
              cp_async4(st + p.scales_at + 4 * e, src);
            }
          }
          cp_async_arrive_noinc(full + g % kStages);
        }
        if (lane == 0) *reinterpret_cast<int*>(st + p.len_at) = len;
        if (!bulk) {  // 8-byte loads by the lanes
          const int words = row_bytes / 8;
          for (int w = lane; w < cnt * words; w += 32) {
            const int i = w / words, c = w - i * words;
            *reinterpret_cast<uint2*>(st + i * p.slot_bytes + 8 * c) =
                reinterpret_cast<const uint2*>(source(kv, k0 + i))[c];
          }
        }
        __syncwarp();
        if (lane == 0) {
          unsigned long long* bar = full + g % kStages;
          const unsigned scale_bytes = scale_span ? 4 * cnt * heads : 0;
          mbar_expect_tx(bar, (j == 0 ? q_bytes : 0) + (bulk ? cnt * row_bytes : 0) + scale_bytes);
          if (j == 0) bulk_copy_g2s(st + p.q_at, a.q + static_cast<long>(row) * d, q_bytes, bar);
          if (scale_span) bulk_copy_g2s(st + p.scales_at, scale_src, scale_bytes, bar);
          if (bulk && kReadOnly)  // positions k0.. of a row-major row: one span
            bulk_copy_g2s(st, source(kv, k0), cnt * row_bytes, bar);
          else if (bulk)
            for (int i = 0; i < cnt; ++i)
              bulk_copy_g2s(st + i * p.slot_bytes, source(kv, k0 + i), row_bytes, bar);
        }
      }
    }
    return;
  }

  // ---- the consumer warps
  float* qs = reinterpret_cast<float*>(smem + p.q);
  float* accs = reinterpret_cast<float*>(smem + p.acc);
  float* invs = reinterpret_cast<float*>(smem + p.inv);
  unsigned* max_keys = reinterpret_cast<unsigned*>(smem + p.max_keys);
  float* sums = reinterpret_cast<float*>(smem + p.sums);  // scratch mode
  float* xs = reinterpret_cast<float*>(smem + p.xs);
  const int ss = in_scratch ? score_stride(cap) : cap + 1;  // between two heads' score rows
  float* ps = in_scratch ? a.scores + static_cast<long long>(blockIdx.x) * heads * ss
                         : reinterpret_cast<float*>(smem + p.scores);
  int g = 0;
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    int len = 0, n_old = 0, n_keys = 1, nck = 1;
    for (int j = 0; j < 2 * nck; ++j, ++g) {
      mbar_wait(full + g % kStages, (g / kStages) & 1);
      const unsigned char* buf = stage(g);
      const float* scales = reinterpret_cast<const float*>(buf + p.scales_at);
      if (j == 0) {  // the row's first chunk: its length, and its query in fp32
        len = *reinterpret_cast<const int*>(buf + p.len_at);
        n_old = min(len, cap - 1);
        n_keys = n_old + 1;
        nck = (n_keys + p.chunk - 1) / p.chunk;
        const T* qt = reinterpret_cast<const T*>(buf + p.q_at);
        for (int e = tid; e < d; e += kConsumers) qs[e] = to_f32(qt[e]);
        if (in_scratch)
          for (int h = tid; h < heads; h += kConsumers) max_keys[h] = max_key(-INFINITY);
        consumers_sync();
      }
      const int kv = j >= nck;
      const int k0 = (j - kv * nck) * p.chunk, cnt = min(p.chunk, n_keys - k0);
      if (!kv) {  // scores: one thread per (head, key); the warp's lanes together
        const int work = heads * cnt;
        for (int w0 = tid - lane; w0 < work; w0 += kConsumers) {
          const int w = w0 + lane, h = w / cnt, i = w - h * cnt;
          const bool on = w < work;
          float s = 0.f;
          if (on) {
            const KV* kp = reinterpret_cast<const KV*>(buf + i * p.slot_bytes) + h * dh;
            s = dot<KV, kReadOnly>(qs + h * dh, kp, dh, k0 + i);
            if (kQuant && kReadOnly) {
              s = __fmul_rn(__fmul_rn(s, a.scale), scales[i * heads + h]);
            } else {
              if (kQuant) s = __fmul_rn(s, scales[i]);
              s = __fmul_rn(s, a.scale);
            }
            ps[h * ss + k0 + i] = s;
          }
          if (in_scratch) fold_max(max_keys, h, s, on, lane);
        }
      } else {  // PV: one thread per (head, 8 elements)
        const bool last = k0 + cnt == n_keys;
        if (in_scratch) {  // the chunk's exps, from its scores in the scratch
          for (int w0 = tid; w0 < heads * cnt; w0 += 4 * kConsumers) {
            float x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int w = w0 + u * kConsumers, h = w / cnt;
              if (w < heads * cnt) x[u] = ps[h * ss + k0 + (w - h * cnt)];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int w = w0 + u * kConsumers;
              if (w < heads * cnt) xs[w] = expf(__fsub_rn(x[u], invs[w / cnt]));
            }
          }
          consumers_sync();
        }
        for (int e0 = 8 * tid; e0 < d; e0 += 8 * kConsumers) {
          const int h = e0 / dh;
          const float* w = in_scratch ? xs + h * cnt : ps + h * ss + k0;
          float acc[8], v[8];
          if (k0 == 0) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = 0.f;
          } else {
            load8(accs + e0, acc);
          }
#pragma unroll 4
          for (int i = 0; i < cnt; ++i) {
            const float wt =
                kQuant ? __fmul_rn(w[i], scales[kReadOnly ? i * heads + h : i]) : w[i];
            eight(reinterpret_cast<const KV*>(buf + i * p.slot_bytes) + e0, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt, v[e], acc[e]);
          }
          if (last && !in_scratch) {
            const float inv = invs[h];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(acc[e], inv);
            store8(a.out + static_cast<long>(row) * d + e0, acc);
          } else {
            store8(accs + e0, acc);
          }
        }
        if (in_scratch) {  // each head's sum, in key order, over this chunk's exps
          for (int h = tid; h < heads; h += kConsumers) {
            float sum = k0 == 0 ? 0.f : sums[h];
            for (int i = 0; i < cnt; ++i) sum = __fadd_rn(sum, xs[h * cnt + i]);
            sums[h] = sum;
          }
          if (last) {  // the reciprocals, then PV's last multiply
            consumers_sync();
            for (int h = tid; h < heads; h += kConsumers) invs[h] = __fdiv_rn(1.f, sums[h]);
            consumers_sync();
            for (int e0 = 8 * tid; e0 < d; e0 += 8 * kConsumers) {
              const float inv = invs[e0 / dh];
              float acc[8];
              load8(accs + e0, acc);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(acc[e], inv);
              store8(a.out + static_cast<long>(row) * d + e0, acc);
            }
          }
        }
      }
      if (kQuant && !kReadOnly && tid == 0 && k0 + cnt == n_keys)  // and the new frame's scale
        (kv ? a.v_scale : a.k_scale)[static_cast<long>(len % cap) * a.rows + row] =
            scales[n_old - k0];
      if (!kReadOnly && k0 + cnt == n_keys) {  // the new frame's chunk: append it at slot len % C
        unsigned char* to = reinterpret_cast<unsigned char*>(
            (kv ? a.v_cache : a.k_cache) + (len % cap) * a.slot_stride + row * a.row_stride);
        const unsigned char* from = buf + (n_old - k0) * p.slot_bytes;
        if (bulk) {  // 16-byte aligned rows
          for (int w = tid; w < row_bytes / 16; w += kConsumers)
            reinterpret_cast<uint4*>(to)[w] = reinterpret_cast<const uint4*>(from)[w];
        } else {
          for (int w = tid; w < row_bytes / 8; w += kConsumers)
            reinterpret_cast<uint2*>(to)[w] = reinterpret_cast<const uint2*>(from)[w];
        }
      }
      if (j == nck - 1 && in_scratch) {  // all scores in: each head's max, folded chunk by chunk
        consumers_sync();
        for (int h = tid; h < heads; h += kConsumers) invs[h] = key_max(max_keys[h]);
      } else if (j == nck - 1) {  // all scores in: the softmax
        consumers_sync();
        for (int h = tid; h < heads; h += kConsumers) {  // each head's max
          float m = -INFINITY;
          for (int i = 0; i < n_keys; ++i) m = fmaxf(m, ps[h * ss + i]);
          invs[h] = m;
        }
        consumers_sync();
        for (int w = tid; w < heads * n_keys; w += kConsumers) {  // exp, a (head, key) each
          const int h = w / n_keys, i = w - h * n_keys;
          ps[h * ss + i] = expf(__fsub_rn(ps[h * ss + i], invs[h]));
        }
        consumers_sync();
        for (int h = tid; h < heads; h += kConsumers) {  // each head's sum, in key order
          float sum = 0.f;
          for (int i = 0; i < n_keys; ++i) sum = __fadd_rn(sum, ps[h * ss + i]);
          invs[h] = __fdiv_rn(1.f, sum);
        }
      }
      consumers_sync();  // every consumer is done with the stage
      if (tid == 0) mbar_arrive(empty + g % kStages);
    }
  }
}

}  // namespace decode
