// Causal softmax attention over the T <= 32 frames of each (b, n) row of a
// full clip, heads as dh-wide slices of D.
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_fullclip,
// forward (_fullclip_temporal_pallas, kernel body
// _fullclip_temporal_kernel). Same contract: q, k, v, out are (R, T, D);
// query t attends keys 0..t; scores, softmax and the PV sum are fp32, and
// the output is rounded to the input type.
//
// The arithmetic is the one temporal_decode_pm.cu repeats for a streamed
// frame: each score one sequential fp32 FMA chain over dh, then scaled;
// the max, exp, a sequential sum in key order, PV as a sequential FMA chain
// in key order, one multiply by the reciprocal of the sum. Keep the two in
// step: streaming equals the full clip bit for bit only while they agree.
//
// Bound on the H100: bytes. Per (row, head) the work is about T*T*dh FMAs
// on 4*T*dh elements, a few operations per byte at T = 16. The design moves
// each byte once with many loads in flight: one warp per (row, head) copies
// the head's T x dh slices of K and V into shared memory, 16 bytes a lane,
// neighbouring lanes on neighbouring addresses; then one lane per query
// keeps its T scores in registers (no shuffles), and every lane reads the
// same K or V chunk from shared memory at once (a broadcast).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps per block, one (row, head) each
constexpr int kMaxT = 32;   // one lane per query

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
temporal_fullclip_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int rows, int t_len,
                         int d, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const long base = static_cast<long>(row) * t_len * d + head * dh;
  T* ks = reinterpret_cast<T*>(smem) + static_cast<long>(warp) * 2 * t_len * dh;  // t_len x dh
  T* vs = ks + t_len * dh;                                                        // t_len x dh
  for (int i = lane; i < t_len * nc; i += 32) {
    const int j = i / nc, c = i % nc;
    const long g = base + static_cast<long>(j) * d + 8 * c;
    copy8(ks + j * dh + 8 * c, k + g);
    copy8(vs + j * dh + 8 * c, v + g);
  }
  __syncwarp();

  const int t = lane;  // this lane's query position
  const bool on = t < t_len;
  float s[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) s[j] = 0.f;
  for (int c = 0; c < nc; ++c) {
    float qv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on) load8(q + base + static_cast<long>(t) * d + 8 * c, qv);
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t_len) {  // the same for every lane
        float kf[8];
        load8(ks + j * dh + 8 * c, kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[j] = fmaf(qv[e], kf[e], s[j]);
      }
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    s[j] = __fmul_rn(s[j], scale);
    if (j <= t && j < t_len) m = fmaxf(m, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    s[j] = j <= t && j < t_len ? expf(__fsub_rn(s[j], m)) : 0.f;
    sum = __fadd_rn(sum, s[j]);
  }
  const float inv = __fdiv_rn(1.f, sum);

  for (int c = 0; c < nc; ++c) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t_len) {
        float vf[8];
        load8(vs + j * dh + 8 * c, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(s[j], vf[e], acc[e]);
      }
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(acc[e], inv);
      store8(out + base + static_cast<long>(t) * d + 8 * c, acc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int rows, int t_len, int d,
           int heads, float scale, cudaStream_t stream) {
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const size_t smem = sizeof(T) * kWarps * 2 * t_len * d / heads;
  cudaError_t err = cudaFuncSetAttribute(temporal_fullclip_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_fullclip_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), rows, t_len, d, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sf_temporal_fullclip(const void* q, const void* k, const void* v, void* out,
                                    int rows, int t_len, int d, int heads, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k, v, out, rows, t_len, d, heads, scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k, v, out, rows, t_len, d, heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
