// Helpers shared by the port's attention kernels: fp32 <-> storage-type
// conversion, 2- and 8-element vector loads and stores, warp reductions.
//
// Every kernel computes in fp32 and stores in its input type: float or
// __nv_bfloat16. The C entry points take a dtype code (SF_FLOAT32,
// SF_BFLOAT16, as ops/attention.py passes it) and return cudaGetLastError()
// right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum { SF_FLOAT32 = 0, SF_BFLOAT16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an fp32 value through the storage type (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Two consecutive elements; p is aligned to two elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// Eight consecutive elements; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Raw copy of two elements, both sides aligned to two elements.
__device__ __forceinline__ void copy2(float* dst, const float* src) {
  *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ void copy2(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = *reinterpret_cast<const __nv_bfloat162*>(src);
}

// Raw copy of eight elements (16 or 32 bytes), both sides 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  constexpr int kWords = sizeof(T) / 2;  // uint4 words in 8 elements
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
