// t=1 causal temporal attention against the int8 position-major KV cache,
// with the new frame's codes and scales appended in place: one stream
// (kernel F) or a batch of streams, each at its own position (kernel G,
// continuous batching).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_decode_pm_int8
// (F) and fused_temporal_decode_pm_int8_ragged (G), which share the kernel
// body _pm8_decode_kernel. Same function: q is (R, D) float or bf16 with
// heads as dh-wide slices of D; the new frame arrives quantized, codes
// k_new, v_new (R, D) int8 and per-row scales (R,) fp32; the caches are
// (C, R, D) int8 with per-(position, row) fp32 scales, here position-major
// (C, R) so that the append is one contiguous row of scales. lens (device
// int32) holds the position the new frame takes, one per stream; row r
// belongs to stream r / rows_per_stream (F: one stream of all R rows). The
// new frame attends the last min(len, C-1) positions held in the cache and
// itself, dequantized; slot len % C is not read (it is the slot the new
// frame evicts on the ring) and the new codes AND both scales are written
// there afterwards. The TPU kernel leaves the scale writes to its caller and
// pads each stream's rows to 32; here the kernel writes them, and each warp
// looks up its own row's length, so rows are not padded.
//
// Dequantization is folded after the reductions, in fp32: the score of key
// i is ((q . codes_i) * k_scale_i) * dh^-0.5, with the dot one sequential
// FMA chain over dh; the value weight is p_i * v_scale_i. Keys are taken in
// position order, the new frame last; softmax max, exp, a sequential sum in
// key order and one multiply by the reciprocal of the sum, as kernel A. F
// and G run one body, so a ragged row equals a lone stream bit for bit.
//
// Bound on the H100: bytes. Each (row, head) does 4*dh operations per cache
// slot on 2*dh bytes of int8 codes, about two operations per byte, far
// below the ~590 int8 operations per byte where the tensor cores would be
// the limit. The design is kernel A's with one byte a code: one warp per
// (row, head); for the scores one lane per key, each issuing all dh/8
// 8-byte loads of its codes at once (64 bytes at dh = 64); for PV lanes over
// code pairs (one 64-byte load per key per warp at dh = 64). The
// per-(position, row) scales are shared by a row's head warps and come from
// L1/L2 after the first. Reads stop at the valid prefix; len is read on the
// device, so a step never waits for the host. Each warp writes only its
// (row, head) slice of the new plane and the row's head-0 warp its two
// scales, at a slot no warp reads, so the in-place append has no race.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block, one (row, head) each
constexpr int kGroup = 8;  // 8-code chunks of a key row loaded at once

// floats of shared memory per warp: q (dh) and the scores (capacity),
// rounded up to keep every warp's q 16-byte aligned
__host__ __device__ inline int warp_floats(int dh, int capacity) {
  return (dh + capacity + 3) & ~3;
}

__device__ __forceinline__ float2 load2_i8(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
temporal_decode_pm_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_new,
                               const int8_t* __restrict__ v_new,
                               const float* __restrict__ k_new_scale,
                               const float* __restrict__ v_new_scale, int8_t* k_cache,
                               int8_t* v_cache, float* k_scale, float* v_scale,
                               const int* __restrict__ lens, int rows_per_stream,
                               T* __restrict__ out, int rows, int capacity, int d, int heads,
                               float scale) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const long base = static_cast<long>(row) * d + head * dh;
  const long plane = static_cast<long>(rows) * d;
  const int len = lens[row / rows_per_stream];
  const int n_old = min(len, capacity - 1);  // cached keys attended
  const int first = len - n_old;             // position of the oldest of them
  const int n_keys = n_old + 1;              // and the new frame, last

  float* qs = smem + warp * warp_floats(dh, capacity);
  float* ps = qs + dh;
  for (int e = lane; e < dh; e += 32) qs[e] = to_f32(q[base + e]);
  __syncwarp();

  // scores, one lane per key
  float m = -INFINITY;
  for (int i = lane; i < n_keys; i += 32) {
    const int8_t* kp;
    float ks;
    if (i < n_old) {
      const long slot = (first + i) % capacity;
      kp = k_cache + slot * plane + base;
      ks = k_scale[slot * rows + row];
    } else {
      kp = k_new + base;
      ks = k_new_scale[row];
    }
    float s = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kGroup) {  // kGroup loads in flight, then the FMAs
      int2 raw[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (c0 + g < nc) raw[g] = *reinterpret_cast<const int2*>(kp + 8 * (c0 + g));
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g < nc) {
          const int8_t* c = reinterpret_cast<const int8_t*>(&raw[g]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s = fmaf(qs[8 * (c0 + g) + e], static_cast<float>(c[e]), s);
        }
      }
    }
    s = __fmul_rn(__fmul_rn(s, ks), scale);
    ps[i] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  __syncwarp();
  for (int i = lane; i < n_keys; i += 32) ps[i] = expf(__fsub_rn(ps[i], m));
  __syncwarp();
  float sum = 0.f;
  for (int i = 0; i < n_keys; ++i) sum = __fadd_rn(sum, ps[i]);  // key order, every lane
  const float inv = __fdiv_rn(1.f, sum);

  // PV, lanes over code pairs: lane holds pairs lane and lane + 32
  const int pairs = dh / 2;
  const bool on0 = lane < pairs;
  const bool on1 = lane + 32 < pairs;
  const long off = base + 2 * lane;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc0 = zero, acc1 = zero;
#pragma unroll 8
  for (int i = 0; i < n_keys; ++i) {
    const int8_t* vp;
    float vs;
    if (i < n_old) {
      const long slot = (first + i) % capacity;
      vp = v_cache + slot * plane;
      vs = v_scale[slot * rows + row];
    } else {
      vp = v_new;
      vs = v_new_scale[row];
    }
    const float p = __fmul_rn(ps[i], vs);
    const float2 v0 = on0 ? load2_i8(vp + off) : zero;
    const float2 v1 = on1 ? load2_i8(vp + off + 64) : zero;
    acc0.x = fmaf(p, v0.x, acc0.x); acc0.y = fmaf(p, v0.y, acc0.y);
    acc1.x = fmaf(p, v1.x, acc1.x); acc1.y = fmaf(p, v1.y, acc1.y);
  }

  const long slot_new = len % capacity;
  const long new_plane = slot_new * plane + off;
  if (on0) {
    store2(out + off, make_float2(__fmul_rn(acc0.x, inv), __fmul_rn(acc0.y, inv)));
    *reinterpret_cast<char2*>(k_cache + new_plane) = *reinterpret_cast<const char2*>(k_new + off);
    *reinterpret_cast<char2*>(v_cache + new_plane) = *reinterpret_cast<const char2*>(v_new + off);
  }
  if (on1) {
    store2(out + off + 64, make_float2(__fmul_rn(acc1.x, inv), __fmul_rn(acc1.y, inv)));
    *reinterpret_cast<char2*>(k_cache + new_plane + 64) =
        *reinterpret_cast<const char2*>(k_new + off + 64);
    *reinterpret_cast<char2*>(v_cache + new_plane + 64) =
        *reinterpret_cast<const char2*>(v_new + off + 64);
  }
  if (head == 0 && lane == 0) {
    k_scale[slot_new * rows + row] = k_new_scale[row];
    v_scale[slot_new * rows + row] = v_new_scale[row];
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
           const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
           const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
           int heads, float scale, cudaStream_t stream) {
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * warp_floats(d / heads, capacity);
  cudaError_t err = cudaFuncSetAttribute(temporal_decode_pm_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_decode_pm_int8_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const float*>(k_new_scale),
      static_cast<const float*>(v_new_scale), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(lens), rows_per_stream, static_cast<T*>(out), rows, capacity, d,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
             const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
             const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
             int heads, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                                 k_scale, v_scale, lens, rows_per_stream, out, rows, capacity, d,
                                 heads, scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale,
                         v_scale, lens, rows_per_stream, out, rows, capacity, d, heads, scale,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int sf_temporal_decode_pm_int8_smem_bytes(int dh, int capacity) {
  return static_cast<int>(sizeof(float)) * kWarps * warp_floats(dh, capacity);
}

// F: one stream, len a single device int32
extern "C" int sf_temporal_decode_pm_int8(const void* q, const void* k_new, const void* v_new,
                                          const void* k_new_scale, const void* v_new_scale,
                                          void* k_cache, void* v_cache, void* k_scale,
                                          void* v_scale, const void* len, void* out, int rows,
                                          int capacity, int d, int heads, float scale, int dtype,
                                          void* stream) {
  return dispatch(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale,
                  len, rows, out, rows, capacity, d, heads, scale, dtype, stream);
}

// G: rows / rows_per_stream streams, lens a device int32 vector of that length
extern "C" int sf_temporal_decode_pm_int8_ragged(
    const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
    const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d, int heads,
    float scale, int dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale,
                  lens, rows_per_stream, out, rows, capacity, d, heads, scale, dtype, stream);
}
