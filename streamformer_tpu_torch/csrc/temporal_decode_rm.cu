// Read-only t=1 causal temporal attention against the row-major KV cache,
// float or int8 (kernel K).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_decode (bodies
// _decode_kernel with scales and _decode_kernel_noscale without). Same
// contract: q is (R, D) float or bf16 with heads as dh-wide slices of D; the
// caches k, v are row-major (R, C, D) and already hold the new frame at
// position len (the caller wrote it); len is one device int32. Each
// (row, head) attends positions 0..min(len, C-1), the new frame's among
// them, and nothing is written: the float mode is the JAX package's test
// oracle for the in-place kernel J, and the int8 mode serves the row-major
// int8 cache, whose new codes and scales the caller quantizes and writes
// first. The int8 cache keeps one fp32 scale per (row, position, head),
// (R, C, H), and dequantization is folded after the reductions, as the TPU
// kernel folds it: the score of key i is ((q . codes_i) * dh^-0.5) *
// k_scale_i, its value weight p_i * v_scale_i, and the softmax's sum runs
// over the unscaled p_i. Keys are taken in position order; the arithmetic
// is kernel A's otherwise (one sequential fp32 FMA chain per score, max,
// exp, a sequential sum in key order, PV as a sequential FMA chain, one
// multiply by the reciprocal of the sum).
//
// Bound on the H100: bytes. Each (row, head) does 4*dh operations per
// position on 2*dh bytes of int8 codes plus two scales (4*dh bytes in
// bf16), one or two operations per byte, far below where the tensor cores
// would be the limit. The design is kernel A's on row-major strides: one
// warp per (row, head); for the scores one lane per key, each issuing all
// of its key row's loads at once (16 bytes each in float, 8 in int8); for PV
// lanes over element pairs. A row's positions are D elements apart, so a
// warp's PV loads of one key are one contiguous run of 2*dh codes. Reads
// stop at the valid prefix, with len read on the device.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block, one (row, head) each
constexpr int kGroup = 8;  // 8-element chunks of a key row loaded at once

// floats of shared memory per warp: q (dh) and the scores (capacity),
// rounded up to keep every warp's q 16-byte aligned
__host__ __device__ inline int warp_floats(int dh, int capacity) {
  return (dh + capacity + 3) & ~3;
}

// Eight cache elements as floats: int8 codes (8 bytes, 8-byte aligned) or
// common.cuh's 16-byte loads.
__device__ __forceinline__ void load8_cache(const int8_t* p, float* o) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = static_cast<float>(c[e]);
}
__device__ __forceinline__ void load8_cache(const float* p, float* o) { load8(p, o); }
__device__ __forceinline__ void load8_cache(const __nv_bfloat16* p, float* o) { load8(p, o); }

// Two cache elements as floats.
__device__ __forceinline__ float2 load2_cache(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}
__device__ __forceinline__ float2 load2_cache(const float* p) { return load2(p); }
__device__ __forceinline__ float2 load2_cache(const __nv_bfloat16* p) { return load2(p); }

// T: the type of q and the output; C: the cache's (T, or int8_t with scales)
template <typename T, typename C>
__global__ void __launch_bounds__(kWarps * 32)
temporal_decode_rm_kernel(const T* __restrict__ q, const C* __restrict__ k,
                          const C* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ lens,
                          T* __restrict__ out, int rows, int capacity, int d, int heads,
                          float scale) {
  constexpr bool kQuantized = sizeof(C) == 1;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const long base = static_cast<long>(row) * d + head * dh;                  // in q, out
  const long cbase = static_cast<long>(row) * capacity * d + head * dh;      // in k, v
  const long sbase = static_cast<long>(row) * capacity * heads + head;       // in the scales
  const int n_keys = min(lens[0], capacity - 1) + 1;  // positions 0..len

  float* qs = smem + warp * warp_floats(dh, capacity);
  float* ps = qs + dh;
  for (int e = lane; e < dh; e += 32) qs[e] = to_f32(q[base + e]);
  __syncwarp();

  // scores, one lane per key
  float m = -INFINITY;
  for (int i = lane; i < n_keys; i += 32) {
    const C* kp = k + cbase + static_cast<long>(i) * d;
    float s = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kGroup) {  // kGroup loads in flight, then the FMAs
      float kf[kGroup][8];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (c0 + g < nc) load8_cache(kp + 8 * (c0 + g), kf[g]);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g < nc) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qs[8 * (c0 + g) + e], kf[g][e], s);
        }
      }
    }
    s = __fmul_rn(s, scale);
    if constexpr (kQuantized) s = __fmul_rn(s, k_scale[sbase + static_cast<long>(i) * heads]);
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

  // PV, lanes over element pairs: lane holds pairs lane and lane + 32
  const int pairs = dh / 2;
  const bool on0 = lane < pairs;
  const bool on1 = lane + 32 < pairs;
  const long off = 2 * lane;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc0 = zero, acc1 = zero;
#pragma unroll 8
  for (int i = 0; i < n_keys; ++i) {
    const C* vp = v + cbase + static_cast<long>(i) * d;
    const float p = kQuantized ? __fmul_rn(ps[i], v_scale[sbase + static_cast<long>(i) * heads])
                               : ps[i];
    const float2 v0 = on0 ? load2_cache(vp + off) : zero;
    const float2 v1 = on1 ? load2_cache(vp + off + 64) : zero;
    acc0.x = fmaf(p, v0.x, acc0.x); acc0.y = fmaf(p, v0.y, acc0.y);
    acc1.x = fmaf(p, v1.x, acc1.x); acc1.y = fmaf(p, v1.y, acc1.y);
  }
  if (on0) store2(out + base + off, make_float2(__fmul_rn(acc0.x, inv), __fmul_rn(acc0.y, inv)));
  if (on1)
    store2(out + base + off + 64, make_float2(__fmul_rn(acc1.x, inv), __fmul_rn(acc1.y, inv)));
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* len, void* out, int rows, int capacity, int d, int heads, float scale,
           cudaStream_t stream) {
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * warp_floats(d / heads, capacity);
  cudaError_t err = cudaFuncSetAttribute(temporal_decode_rm_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_decode_rm_kernel<T, C><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(len), static_cast<T*>(out), rows, capacity, d, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sf_temporal_decode_rm_readonly_smem_bytes(int dh, int capacity) {
  return static_cast<int>(sizeof(float)) * kWarps * warp_floats(dh, capacity);
}

// K: k, v (R, C, D) int8 with (R, C, H) fp32 scales when quantized is 1, else
// in q's type with null scales; len a single device int32
extern "C" int sf_temporal_decode_rm_readonly(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* len, void* out, int rows, int capacity,
                                              int d, int heads, float scale, int dtype,
                                              int quantized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16) {
    return quantized
        ? launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d,
                                        heads, scale, st)
        : launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_scale, v_scale, len, out, rows,
                                               capacity, d, heads, scale, st);
  }
  if (dtype == SF_FLOAT32) {
    return quantized
        ? launch<float, int8_t>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d, heads,
                                scale, st)
        : launch<float, float>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d, heads,
                               scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
