// Backward of the causal softmax attention over the T <= 32 frames of each
// (b, n) row of a full clip: dq, dk, dv from q, k, v and the output
// gradient g, heads as dh-wide slices of D.
//
// Replaces: streamformer_tpu/ops/attention.py _fullclip_temporal_bwd_pallas
// (kernel body _fullclip_temporal_bwd_kernel), the backward of
// fused_temporal_fullclip. Same contract: q, k, v, g, dq, dk, dv are
// (R, T, D); nothing is saved by the forward but q, k, v, so the
// probabilities are recomputed; everything is fp32 and the three gradients
// are rounded to the input type once, when they are written:
//
//   p      = softmax(q k^T * scale, causal)        dv[j] = sum_t p[t][j] g[t]
//   dp     = g v^T                                  ds    = p (dp - delta) scale
//   delta  = sum_j p[t][j] dp[t][j]                 dq[t] = sum_j ds[t][j] k[j]
//                                                   dk[j] = sum_t ds[t][j] q[t]
//
// The scores and the softmax repeat temporal_fullclip.cu's order of
// arithmetic, so p here is the forward's p bit for bit.
//
// Bound on the H100: bytes (seven (R, T, D) arrays moved once against a few
// operations per byte at T = 16). One warp per (row, head). Phase 1 is the
// forward's layout: K and V of the head staged in shared memory, one lane
// per query, its T scores, probabilities and dp in registers; the lane
// writes its dq row and leaves its rows of p and ds in shared memory. Phase
// 2 turns the warp around: each lane owns 8-element chunks of (key j, dh)
// and sums over the queries t >= j in order, reading q and g from shared
// memory, so dk and dv are accumulated inside the warp and written once.
// No atomics: two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 4;  // warps per block, one (row, head) each
constexpr int kMaxT = 32;     // one lane per query

// Per warp: K, V, Q, G of the head (t_len x dh each, input type), then p and
// ds (t_len x pstride fp32 each).
inline __host__ __device__ int p_stride(int t_len) { return t_len | 1; }
inline __host__ __device__ size_t warp_bytes(int t_len, int dh, int elem) {
  const size_t bytes = static_cast<size_t>(4) * t_len * dh * elem +
                       static_cast<size_t>(2) * t_len * p_stride(t_len) * 4;
  return (bytes + 15) / 16 * 16;  // the next warp's K stays 16-byte aligned
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
temporal_fullclip_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                             int rows, int t_len, int d, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * warps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const int ps_stride = p_stride(t_len);
  const long base = static_cast<long>(row) * t_len * d + head * dh;
  unsigned char* mine = smem + warp * warp_bytes(t_len, dh, sizeof(T));
  T* ks = reinterpret_cast<T*>(mine);  // t_len x dh
  T* vs = ks + t_len * dh;
  T* qs = vs + t_len * dh;
  T* gs = qs + t_len * dh;
  float* ps = reinterpret_cast<float*>(gs + t_len * dh);  // t_len x ps_stride
  float* dss = ps + t_len * ps_stride;
  for (int i = lane; i < t_len * nc; i += 32) {
    const int j = i / nc, c = i % nc;
    const long src = base + static_cast<long>(j) * d + 8 * c;
    copy8(ks + j * dh + 8 * c, k + src);
    copy8(vs + j * dh + 8 * c, v + src);
    copy8(qs + j * dh + 8 * c, q + src);
    copy8(gs + j * dh + 8 * c, g + src);
  }
  __syncwarp();

  // ---- phase 1: lane t is query t
  const int t = lane;
  const bool on = t < t_len;
  float s[kMaxT], dp[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) s[j] = dp[j] = 0.f;
  for (int c = 0; c < nc; ++c) {
    float qv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float gv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on) {
      load8(q + base + static_cast<long>(t) * d + 8 * c, qv);
      load8(g + base + static_cast<long>(t) * d + 8 * c, gv);
    }
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t_len) {  // the same for every lane
        float kf[8], vf[8];
        load8(ks + j * dh + 8 * c, kf);
        load8(vs + j * dh + 8 * c, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[j] = fmaf(qv[e], kf[e], s[j]);
          dp[j] = fmaf(gv[e], vf[e], dp[j]);
        }
      }
    }
  }
  // the forward's softmax: scaled scores, max, exp, sequential sum
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
  const float inv = on ? __fdiv_rn(1.f, sum) : 0.f;
  float delta = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    s[j] = __fmul_rn(s[j], inv);  // p; 0 for masked keys
    delta = fmaf(s[j], dp[j], delta);
  }
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    dp[j] = s[j] * (dp[j] - delta) * scale;  // ds; 0 for masked keys
    if (on && j < t_len) {
      ps[t * ps_stride + j] = s[j];
      dss[t * ps_stride + j] = dp[j];
    }
  }
  for (int c = 0; c < nc; ++c) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t_len) {
        float kf[8];
        load8(ks + j * dh + 8 * c, kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(dp[j], kf[e], acc[e]);
      }
    }
    if (on) store8(dq + base + static_cast<long>(t) * d + 8 * c, acc);
  }
  __syncwarp();

  // ---- phase 2: each lane owns chunks (key j, 8 elements of dh)
  for (int i = lane; i < t_len * nc; i += 32) {
    const int j = i / nc, c = i % nc;
    float ak[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float av[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int tq = j; tq < t_len; ++tq) {  // queries that attend key j, in order
      const float ds_tj = dss[tq * ps_stride + j];
      const float p_tj = ps[tq * ps_stride + j];
      float qf[8], gf[8];
      load8(qs + tq * dh + 8 * c, qf);
      load8(gs + tq * dh + 8 * c, gf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ak[e] = fmaf(ds_tj, qf[e], ak[e]);
        av[e] = fmaf(p_tj, gf[e], av[e]);
      }
    }
    const long dst = base + static_cast<long>(j) * d + 8 * c;
    store8(dk + dst, ak);
    store8(dv + dst, av);
  }
}

// Warps per block: as many as the shared memory of one block holds, at most
// kMaxWarps; 0 when one warp's share alone is too large.
inline int warps_per_block(int t_len, int dh, int elem) {
  const size_t one = warp_bytes(t_len, dh, elem);
  const size_t fit = 232448 / one;
  return static_cast<int>(fit < static_cast<size_t>(kMaxWarps) ? fit : kMaxWarps);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int rows, int t_len, int d, int heads, float scale, cudaStream_t stream) {
  const int dh = d / heads;
  const int wpb = warps_per_block(t_len, dh, sizeof(T));
  if (wpb < 1 || t_len > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + wpb - 1) / wpb);
  const size_t smem = wpb * warp_bytes(t_len, dh, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(temporal_fullclip_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_fullclip_bwd_kernel<T><<<blocks, wpb * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      rows, t_len, d, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one warp needs; the wrapper refuses shapes whose share does
// not fit one block.
extern "C" int sf_temporal_fullclip_bwd_smem_bytes(int t_len, int d, int heads, int dtype) {
  return static_cast<int>(warp_bytes(t_len, d / heads, dtype == SF_BFLOAT16 ? 2 : 4));
}

extern "C" int sf_temporal_fullclip_bwd(const void* q, const void* k, const void* v,
                                        const void* g, void* dq, void* dk, void* dv, int rows,
                                        int t_len, int d, int heads, float scale, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, rows, t_len, d, heads, scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k, v, g, dq, dk, dv, rows, t_len, d, heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
