// t new frames per stream appended to the position-major KV cache in one
// pass: causal attention of each new frame over its stream's cached prefix
// and the new frames up to itself, then the stream's first `valid` new
// frames written into the cache.
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_append_pm_ragged
// (kernel body _pm_append_multi_kernel). Same contract: q, k_new, v_new and
// out are (t, R, D), heads as dh-wide slices of D; the caches are (C, R, D);
// row r belongs to stream b = r / rows_per_stream, whose lens[b] positions
// are held in slots 0..lens[b]-1 (the linear cache: no wrap-around). Query ti
// of stream b is the frame at position lens[b] + ti and attends cache slots
// < lens[b] and new frames 0..ti. New frames ti < valid[b] are then written
// at slot lens[b] + ti; a frame that would land at a slot >= C is dropped.
// Outputs for ti >= valid[b] are computed but unspecified. lens and valid
// are device int32 vectors, so a call never waits for the host. The caller
// keeps lens + valid <= C (a host-side check in the serving engine).
//
// This is temporal_fullclip.cu with a cached prefix in front of the new
// frames: a (row, head)'s key sequence is cache slots 0..len-1, then the t
// new frames, at most C + t <= 32 keys (one lane per query, as there). The
// arithmetic is the full clip's and kernel A's step for step: each score
// one sequential fp32 FMA chain over dh, then scaled; the max, exp, a
// sequential sum in key order, PV as a sequential FMA chain in key order,
// one multiply by the reciprocal of the sum. So a stream fed in chunks
// through this kernel reproduces the full clip bit for bit, as A does.
//
// Bound on the H100: bytes. Per (row, head) the work is about (len + t) * t
// * dh FMAs on (2 len + 4 t) * dh elements, a few operations per byte. At the
// flagship shape (t = 8, 8 streams of 196 rows, D = 768, bf16) the call moves
// 2 sum(len) + 4 t B + 2 sum(valid) planes of 196 x 768 x 2 bytes (cache
// prefix read, q/k_new/v_new read, output written, appended rows written):
// 77 to 154 MB, 23 to 46 us at 3.35 TB/s, as lens and valid range over what
// lens + valid <= C = 16 allows. The design moves each byte once with many loads
// in flight: one warp per (row, head) stages its keys' dh-wide K and V slices
// in shared memory with 16-byte loads, neighbouring lanes on neighbouring
// addresses; one lane per query keeps its scores in registers, every lane
// reading the same K or V chunk at once (a broadcast). Unlike the TPU kernel,
// which writes every cache block back (a Pallas aliasing artifact), only the
// valid new rows are written. Reads (slots < len) and writes (slots >= len)
// are disjoint, and each warp writes only its own (row, head) slices, so
// there is no race.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;     // warps per block, one (row, head) each
constexpr int kMaxKeys = 32;  // cache capacity + new frames; one lane per query
                              // (ops/attention.py APPEND_MAX_KEYS)

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
temporal_append_pm_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, T* k_cache, T* v_cache,
                          const int* __restrict__ lens, const int* __restrict__ valid,
                          int rows_per_stream, T* __restrict__ out, int rows, int t_len,
                          int capacity, int d, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const long base = static_cast<long>(row) * d + head * dh;
  const long plane = static_cast<long>(rows) * d;  // one cache slot, one new frame
  const int stream = row / rows_per_stream;
  const int len = lens[stream];
  const int n_old = min(len, capacity);  // cached keys, slots 0..n_old-1
  const int n_keys = n_old + t_len;      // then the new frames

  T* ks = reinterpret_cast<T*>(smem) +
          static_cast<long>(warp) * 2 * (capacity + t_len) * dh;  // n_keys x dh
  T* vs = ks + (capacity + t_len) * dh;                             // n_keys x dh
  for (int i = lane; i < n_keys * nc; i += 32) {
    const int j = i / nc, c = i % nc;
    const bool old = j < n_old;
    const long g = static_cast<long>(old ? j : j - n_old) * plane + base + 8 * c;
    copy8(ks + j * dh + 8 * c, (old ? k_cache : k_new) + g);
    copy8(vs + j * dh + 8 * c, (old ? v_cache : v_new) + g);
  }
  __syncwarp();

  const int ti = lane;  // this lane's new frame
  const bool on = ti < t_len;
  const int last = n_old + ti;  // the last key it attends: itself
  float s[kMaxKeys];
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) s[j] = 0.f;
  for (int c = 0; c < nc; ++c) {
    float qv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on) load8(q + static_cast<long>(ti) * plane + base + 8 * c, qv);
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < n_keys) {  // the same for every lane
        float kf[8];
        load8(ks + j * dh + 8 * c, kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[j] = fmaf(qv[e], kf[e], s[j]);
      }
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    s[j] = __fmul_rn(s[j], scale);
    if (j <= last && j < n_keys) m = fmaxf(m, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    s[j] = j <= last && j < n_keys ? expf(__fsub_rn(s[j], m)) : 0.f;
    sum = __fadd_rn(sum, s[j]);
  }
  const float inv = __fdiv_rn(1.f, sum);

  for (int c = 0; c < nc; ++c) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < n_keys) {
        float vf[8];
        load8(vs + j * dh + 8 * c, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(s[j], vf[e], acc[e]);
      }
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(acc[e], inv);
      store8(out + static_cast<long>(ti) * plane + base + 8 * c, acc);
    }
  }

  // append this (row, head)'s first valid[stream] new frames at slots len + ti
  const int n_write = valid[stream];
  for (int i = lane; i < n_write * nc; i += 32) {
    const int f = i / nc, c = i % nc;
    const int slot = len + f;
    if (slot >= capacity) continue;  // past the linear cache: dropped
    const long src = static_cast<long>(f) * plane + base + 8 * c;
    const long dst = static_cast<long>(slot) * plane + base + 8 * c;
    copy8(k_cache + dst, k_new + src);
    copy8(v_cache + dst, v_new + src);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* lens, const void* valid, int rows_per_stream, void* out, int rows,
           int t_len, int capacity, int d, int heads, float scale, cudaStream_t stream) {
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const size_t smem = sizeof(T) * kWarps * 2 * (capacity + t_len) * (d / heads);
  cudaError_t err = cudaFuncSetAttribute(temporal_append_pm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_append_pm_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<const int*>(lens),
      static_cast<const int*>(valid), rows_per_stream, static_cast<T*>(out), rows, t_len,
      capacity, d, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sf_temporal_append_pm_smem_bytes(int dh, int keys, int dtype) {
  const int elt = dtype == SF_BFLOAT16 ? 2 : 4;
  return elt * kWarps * 2 * keys * dh;
}

extern "C" int sf_temporal_append_pm(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* lens,
                                     const void* valid, int rows_per_stream, void* out, int rows,
                                     int t_len, int capacity, int d, int heads, float scale,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, lens, valid,
                                 rows_per_stream, out, rows, t_len, capacity, d, heads, scale,
                                 st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, lens, valid, rows_per_stream, out,
                         rows, t_len, capacity, d, heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
