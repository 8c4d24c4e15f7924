// Backward of the softmax attention over the T frames of each (b, n) row of
// a full clip, causal or not: dq, dk, dv from q, k, v and the output
// gradient g, heads as dh-wide slices of D.
//
// Replaces: streamformer_tpu/ops/attention.py _fullclip_temporal_bwd_pallas
// (kernel body _fullclip_temporal_bwd_kernel), the backward of
// fused_temporal_fullclip. Same contract: nothing is saved by the forward
// but q, k, v, so the probabilities are recomputed; everything is fp32 and
// the three gradients are rounded to the input type once, when they are
// written:
//
//   p      = softmax(q k^T * scale, mask)          dv[j] = sum_t p[t][j] g[t]
//   dp     = g v^T                                  ds    = p (dp - delta) scale
//   delta  = sum_j p[t][j] dp[t][j]                 dq[t] = sum_j ds[t][j] k[j]
//                                                   dk[j] = sum_t ds[t][j] q[t]
//
// Operands are read and written in place, each a base pointer and element
// strides over (b, t, n), D contiguous, as in temporal_fullclip.cu: the
// encoder's q, k, v are the (B, T, N, 3D) output of the qkv projection, and
// dq, dk, dv the three thirds of its (B, T, N, 3D) gradient.
//
// The scores and the softmax repeat temporal_fullclip.cu's order of
// arithmetic, so p here is the forward's p bit for bit; every sum runs in a
// fixed order inside one thread, with no atomics, so two runs give the same
// bits. Any T: the whole-row pipeline below while one head's item fits a
// block, else tiled.cuh (two launches, the query side writing each query's
// max, 1/sum and delta to fp32 scratch for the key side), in the same
// order of arithmetic and so with the same bits.
//
// Bound on the H100: bytes (seven T x dh slices a (row, head) moved once
// against a few operations per byte at T = 16). The pipeline (fullclip.cuh)
// stages q, k, v and g of an item in flight on bulk asynchronous copies;
// the consumers run three phases an item: the causal scores and dp (one
// task per (head, query, group of keys), as C's scores), the softmax with
// delta and ds (a thread per (head, query)), and the three products, one
// thread per (two frames x0 and x0 + 1, head, 8 elements) computing dq[x]
// over keys j <= x and dk[x], dv[x] over queries t >= x: T + 2 steps,
// whatever x0, each staged chunk loaded once for the two frames (which
// halves the shared-memory reads and bf16 conversions a product); without
// the mask, over all T keys and all T queries.
#include "fullclip.cuh"
#include "tiled.cuh"

namespace {

using fullclip::Args;
using fullclip::consumers_sync;
using fullclip::kConsumers;
using fullclip::kKeyGroup;
using fullclip::kStages;
using fullclip::kThreads;

// One (head, query) row: the forward's p in place of the scores, then
// delta = sum_j p dp (in key order) and ds in place of dp (keys 0..last).
// N: the straight-line width (T <= N), or 0 for a loop.
template <int N>
__device__ __forceinline__ void softmax_grad_row(float* pr, float* dr, int last, float scale) {
  if constexpr (N == 0) {
    const float inv = __fdiv_rn(1.f, fullclip::exps_loop(pr, last + 1));
    float delta = 0.f;
    for (int j = 0; j <= last; ++j) {
      pr[j] = __fmul_rn(pr[j], inv);
      delta = fmaf(pr[j], dr[j], delta);
    }
    for (int j = 0; j <= last; ++j)
      dr[j] = __fmul_rn(__fmul_rn(pr[j], __fsub_rn(dr[j], delta)), scale);
    return;
  }
  constexpr int M = N > 0 ? N : 1;
  const int t = last;
  float x[M];
  const float inv = __fdiv_rn(1.f, fullclip::exps<M>(pr, t, x));
  float dp[M];
  float delta = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    x[j] = __fmul_rn(x[j], inv);  // 0 past t
    dp[j] = j <= t ? dr[j] : 0.f;
    delta = fmaf(x[j], dp[j], delta);
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j <= t) {
      pr[j] = x[j];
      dr[j] = __fmul_rn(__fmul_rn(x[j], __fsub_rn(dp[j], delta)), scale);
    }
}

// kCausal: the mask; kLong: T past kMaxT (the loop softmax). Both are
// template parameters, so that the causal kernel of a short clip compiles to
// the code it had before either existed (runtime flags there cost it 12 %,
// then 3 %, on the H100: tools/decode_timing.py against the parent).
template <typename T, bool kCausal, bool kLong>
__global__ void __launch_bounds__(kThreads, 2) temporal_fullclip_bwd_kernel(const Args<4> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const fullclip::Plan& p = a.p;
  fullclip::setup(smem, p, a.t_len, kCausal);
  const int tid = threadIdx.x;
  if (tid >= kConsumers) {  // the producer warp
    fullclip::produce<T>(smem, a);
    return;
  }
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  float* ps = reinterpret_cast<float*>(smem + p.scores);  // scores, then p
  float* dps = reinterpret_cast<float*>(smem + p.dps);    // dp, then ds
  const int* tri = reinterpret_cast<const int*>(smem + p.tri);
  const int t_len = a.t_len, dh = a.dh, hg = p.hg, ss = p.ss, nc = dh / 8;
  const int rs = p.row_bytes / static_cast<int>(sizeof(T));  // elements between frame rows
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    const int s = k % kStages;
    const int row = item / p.groups, col = (item - row * p.groups) * hg * dh;
    mbar_wait(full + s, (k / kStages) & 1);
    const T* qs = reinterpret_cast<const T*>(smem + s * p.stage_bytes);
    const T* ks = qs + p.op_bytes / sizeof(T);
    const T* vs = ks + p.op_bytes / sizeof(T);
    const T* gs = vs + p.op_bytes / sizeof(T);

    // scores and dp: a task per (head, query t, group of visible keys)
    for (int w = tid; w < hg * p.n_tri; w += kConsumers) {
      const int h = w / p.n_tri, e = tri[w - h * p.n_tri];
      const int t = e >> 8, j0 = (e & 255) * kKeyGroup;
      const int nk = min(kKeyGroup, (kCausal ? t + 1 : t_len) - j0);
      const int qo = t * rs + h * dh, ko = j0 * rs + h * dh;
      float sc[kKeyGroup], dp[kKeyGroup];
      fullclip::dot_group(qs + qo, ks + ko, rs, nk, dh, sc);
      fullclip::dot_group(gs + qo, vs + ko, rs, nk, dh, dp);
      const int to = (h * t_len + t) * ss + j0;
#pragma unroll
      for (int kk = 0; kk < kKeyGroup; ++kk) {
        if (kk < nk) {
          ps[to + kk] = __fmul_rn(sc[kk], a.scale);
          dps[to + kk] = dp[kk];
        }
      }
    }
    consumers_sync();

    // the forward's softmax, then delta and ds: a thread per (head, query)
    for (int w = tid; w < hg * t_len; w += kConsumers) {
      const int last = kCausal ? w % t_len : t_len - 1;
      if constexpr (kLong)
        softmax_grad_row<0>(ps + w * ss, dps + w * ss, last, a.scale);
      else if (t_len <= 16)
        softmax_grad_row<16>(ps + w * ss, dps + w * ss, last, a.scale);
      else
        softmax_grad_row<fullclip::kMaxT>(ps + w * ss, dps + w * ss, last, a.scale);
    }
    consumers_sync();

    // dq, dk, dv of two frames x0 and x0 + 1: dq[x] over keys j <= x, dk[x]
    // and dv[x] over queries t >= x, in order; each staged chunk feeds both
    const int per_x = hg * nc;
    for (int w = tid; w < (t_len + 1) / 2 * per_x; w += kConsumers) {
      const int x0 = w / per_x * 2, r = w - x0 / 2 * per_x, h = r / nc;
      const int c = h * dh + (r - h * nc) * 8;
      float aq[2][8], ak[2][8], av[2][8];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) aq[f][e] = ak[f][e] = av[f][e] = 0.f;
      const float* ds0 = dps + (h * t_len + x0) * ss;  // query x0's row; x0 + 1's follows
      const bool two = x0 + 1 < t_len;
      if constexpr (!kCausal) {  // every key, then every query, in order
#pragma unroll 2
        for (int j = 0; j < t_len; ++j) {
          float kf[8];
          load8(ks + j * rs + c, kf);
          const float d0 = ds0[j], d1 = ds0[ss + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            aq[0][e] = fmaf(d0, kf[e], aq[0][e]);
            aq[1][e] = fmaf(d1, kf[e], aq[1][e]);
          }
        }
#pragma unroll 2
        for (int t = 0; t < t_len; ++t) {
          float qf[8], gf[8];
          load8(qs + t * rs + c, qf);
          load8(gs + t * rs + c, gf);
          const int tx = (h * t_len + t) * ss + x0;
          const float d0 = dps[tx], p0 = ps[tx], d1 = dps[tx + 1], p1 = ps[tx + 1];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ak[0][e] = fmaf(d0, qf[e], ak[0][e]);
            av[0][e] = fmaf(p0, gf[e], av[0][e]);
            ak[1][e] = fmaf(d1, qf[e], ak[1][e]);
            av[1][e] = fmaf(p1, gf[e], av[1][e]);
          }
        }
      } else {
#pragma unroll 2
      for (int j = 0; j <= x0; ++j) {
        float kf[8];
        load8(ks + j * rs + c, kf);
        const float d0 = ds0[j], d1 = ds0[ss + j];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          aq[0][e] = fmaf(d0, kf[e], aq[0][e]);
          aq[1][e] = fmaf(d1, kf[e], aq[1][e]);
        }
      }
      {
        float kf[8], qf[8], gf[8];
        if (two) {
          load8(ks + (x0 + 1) * rs + c, kf);
          const float d1 = ds0[ss + x0 + 1];
#pragma unroll
          for (int e = 0; e < 8; ++e) aq[1][e] = fmaf(d1, kf[e], aq[1][e]);
        }
        load8(qs + x0 * rs + c, qf);
        load8(gs + x0 * rs + c, gf);
        const float d0 = ds0[x0], p0 = ps[(h * t_len + x0) * ss + x0];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ak[0][e] = fmaf(d0, qf[e], ak[0][e]);
          av[0][e] = fmaf(p0, gf[e], av[0][e]);
        }
      }
#pragma unroll 2
      for (int t = x0 + 1; t < t_len; ++t) {
        float qf[8], gf[8];
        load8(qs + t * rs + c, qf);
        load8(gs + t * rs + c, gf);
        const int tx = (h * t_len + t) * ss + x0;
        const float d0 = dps[tx], p0 = ps[tx], d1 = dps[tx + 1], p1 = ps[tx + 1];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ak[0][e] = fmaf(d0, qf[e], ak[0][e]);
          av[0][e] = fmaf(p0, gf[e], av[0][e]);
          ak[1][e] = fmaf(d1, qf[e], ak[1][e]);
          av[1][e] = fmaf(p1, gf[e], av[1][e]);
        }
      }
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (f == 0 || two) {
          const float* grads[3] = {aq[f], ak[f], av[f]};
#pragma unroll
          for (int o = 0; o < 3; ++o)
            store8(static_cast<T*>(a.out[o].p) + fullclip::at(a.out[o], row, a.n, x0 + f, col + c),
                   grads[o]);
        }
      }
    }
    consumers_sync();  // every consumer is done with the stage
    if (tid == 0) mbar_arrive(empty + s);
  }
}

// tiled.cuh's backward on the same operands by its `plan`: the query side
// (dq), then the key side (dk, dv), with stats between them.
template <typename T>
int launch_tiled(const void* const* ptrs, const long long* strides, int batch, int n, int t_len,
                 int d, int heads, float scale, int causal, int plan, float* stats,
                 float* scratch, long long floats, cudaStream_t stream) {
  tiled::Args a{};
  a.q = fullclip::operand(ptrs, strides, 0);
  a.k = fullclip::operand(ptrs, strides, 1);
  a.v = fullclip::operand(ptrs, strides, 2);
  a.g = fullclip::operand(ptrs, strides, 3);
  a.stats = stats;
  a.n = n;
  a.len = t_len;
  a.dh = d / heads;
  a.heads = heads;
  a.causal = causal;
  a.scale = scale;
  tiled::Args dkv = a;
  a.o0 = fullclip::operand(ptrs, strides, 4);
  dkv.o0 = fullclip::operand(ptrs, strides, 5);
  dkv.o1 = fullclip::operand(ptrs, strides, 6);
  return tiled::backward<T>(batch * n, a, dkv, plan, scratch, floats, stream);
}

template <typename T>
int launch(const void* const* ptrs, const long long* strides, int batch, int n, int t_len, int d,
           int heads, float scale, int causal, int tiled, float* stats, float* scratch,
           long long floats, cudaStream_t stream) {
  const int dh = d / heads;
  if (t_len < 1 || dh % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (tiled)
    return launch_tiled<T>(ptrs, strides, batch, n, t_len, d, heads, scale, causal, tiled - 1,
                           stats, scratch, floats, stream);
  const fullclip::Plan p = fullclip::plan(heads, t_len, dh, sizeof(T), 4, true, causal);
  if (p.hg < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<4> a;
  for (int o = 0; o < 7; ++o)
    (o < 4 ? a.in[o] : a.out[o - 4]) = fullclip::operand(ptrs, strides, o);
  a.p = p;
  a.items = batch * n * p.groups;
  a.n = n;
  a.t_len = t_len;
  a.dh = dh;
  a.causal = causal;
  a.scale = scale;
  const bool long_clip = t_len > fullclip::kMaxT;
  const auto kernel = causal ? (long_clip ? temporal_fullclip_bwd_kernel<T, true, true>
                                          : temporal_fullclip_bwd_kernel<T, true, false>)
                             : (long_clip ? temporal_fullclip_bwd_kernel<T, false, true>
                                          : temporal_fullclip_bwd_kernel<T, false, false>);
  int blocks = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, p.total, a.items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, p.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block of the whole-row pipeline needs; 0 when not even
// one head fits (the wrapper then asks for the tiled body).
extern "C" int sf_temporal_fullclip_bwd_smem_bytes(int t_len, int d, int heads, int dtype,
                                                   int causal) {
  const fullclip::Plan p =
      fullclip::plan(heads, t_len, d / heads, dtype == SF_BFLOAT16 ? 2 : 4, 4, true, causal);
  return p.hg ? p.total : 0;
}

// ptrs: q, k, v, g, dq, dk, dv; strides: their (b, t, n) element strides,
// three each. causal: 0 lets every query see every frame. tiled: 0 runs the
// whole-row pipeline, else tiled.cuh's backward (which gives the same bits)
// on plan tiled - 1 (its bits tiled::kBwdSweeps, kBwdStored). stats: for
// tiled.cuh, fp32 scratch of batch * n * heads * 3 * t_len elements (else
// unused); scratch: the plan's, `floats` fp32, or null
// (ops._tiled_bwd_launch).
extern "C" int sf_temporal_fullclip_bwd(const void* const* ptrs, const long long* strides,
                                        int batch, int n, int t_len, int d, int heads, float scale,
                                        int causal, int tiled, void* stats, void* scratch,
                                        long long floats, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  float* scr = static_cast<float*>(scratch);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(ptrs, strides, batch, n, t_len, d, heads, scale, causal, tiled,
                                 sp, scr, floats, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(ptrs, strides, batch, n, t_len, d, heads, scale, causal, tiled, sp, scr,
                         floats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// csrc/tiled.cuh's shared-memory plans: which 0, the resident forward's
// total for qt queries against `keys` keys (ops._tiled_resident_smem keeps a
// copy, which a card test holds to this); 1, the backward's query side with
// its scores in shared memory (ops._tiled_bwd_plan). elt: bytes an element
// of the operands.
extern "C" int sf_tiled_plan(int which, int qt, int keys, int dh, int elt) {
  if (which == 0) return tiled::resident_plan(qt, keys, dh, elt).total;
  if (which == 1) return tiled::dq_plan(keys, dh, elt).total;
  return -1;
}
