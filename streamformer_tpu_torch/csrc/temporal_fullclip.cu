// Softmax attention over the T frames of each (b, n) row of a full clip,
// causal or not, heads as dh-wide slices of D.
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_fullclip,
// forward (_fullclip_temporal_pallas, kernel body
// _fullclip_temporal_kernel). Same contract: query t attends keys 0..t
// (every key when `causal` is 0, as the JAX encoder's einsum path does past
// the TPU kernel); scores, softmax and the PV sum are fp32, and the output
// is rounded to the input type. Any T: the whole-row pipeline below while
// one head's item fits a block (fullclip::plan), tiled.cuh past it, both in
// this order of arithmetic. The operands are read in place: q, k, v and out are each a
// base pointer and element strides over (b, t, n), D contiguous, so one
// kernel takes the (B, T, N, 3D) output of the qkv projection (the encoder)
// and (R, T, D) rows (B = R, N = 1).
//
// The arithmetic is the one temporal_decode_pm.cu repeats for a streamed
// frame: each score one sequential fp32 FMA chain over dh, then scaled;
// the max, exp, a sequential sum in key order, PV as a sequential FMA chain
// in key order, one multiply by the reciprocal of the sum. Keep the two in
// step: streaming equals the full clip bit for bit only while they agree.
//
// Bound on the H100: bytes (4 T dh elements a (row, head) against about
// T^2 dh FMAs, a few a byte at T = 16). The pipeline (fullclip.cuh) keeps
// rows in flight on bulk asynchronous copies in a persistent grid; the
// consumers run three phases an item: the scores, the softmax, PV (a
// thread per two queries, so that each staged V chunk feeds both).
#include "fullclip.cuh"
#include "tiled.cuh"

namespace {

using fullclip::Args;
using fullclip::consumers_sync;
using fullclip::kConsumers;
using fullclip::kKeyGroup;
using fullclip::kStages;
using fullclip::kThreads;

// The softmax of one (head, query) row: the exps in place (keys 0..last),
// the reciprocal of their sum at *inv. N: the straight-line width (T <= N),
// or 0 for a loop.
template <int N>
__device__ __forceinline__ void softmax_row(float* sr, int last, float* inv) {
  float sum;
  if constexpr (N == 0) {
    sum = fullclip::exps_loop(sr, last + 1);
  } else {
    float x[N];
    sum = fullclip::exps<N>(sr, last, x);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j <= last) sr[j] = x[j];
  }
  *inv = __fdiv_rn(1.f, sum);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) temporal_fullclip_kernel(const Args<3> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const fullclip::Plan& p = a.p;
  fullclip::setup(smem, p, a.t_len, a.causal);
  const int tid = threadIdx.x;
  if (tid >= kConsumers) {  // the producer warp
    fullclip::produce<T>(smem, a);
    return;
  }
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + p.full);
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem + p.empty);
  float* scores = reinterpret_cast<float*>(smem + p.scores);
  float* invs = reinterpret_cast<float*>(smem + p.inv);
  const int* tri = reinterpret_cast<const int*>(smem + p.tri);
  const int t_len = a.t_len, dh = a.dh, hg = p.hg, ss = p.ss, nc = dh / 8;
  const int rs = p.row_bytes / static_cast<int>(sizeof(T));  // elements between frame rows
  T* out = static_cast<T*>(a.out[0].p);
  for (int item = blockIdx.x, k = 0; item < a.items; item += gridDim.x, ++k) {
    const int s = k % kStages;
    const int row = item / p.groups, col = (item - row * p.groups) * hg * dh;
    mbar_wait(full + s, (k / kStages) & 1);
    const T* qs = reinterpret_cast<const T*>(smem + s * p.stage_bytes);
    const T* ks = qs + p.op_bytes / sizeof(T);
    const T* vs = ks + p.op_bytes / sizeof(T);

    // scores: a task per (head, query t, group of visible keys)
    for (int w = tid; w < hg * p.n_tri; w += kConsumers) {
      const int h = w / p.n_tri, e = tri[w - h * p.n_tri];
      const int t = e >> 8, j0 = (e & 255) * kKeyGroup;
      const int nk = min(kKeyGroup, (a.causal ? t + 1 : t_len) - j0);
      float acc[kKeyGroup];
      fullclip::dot_group(qs + t * rs + h * dh, ks + j0 * rs + h * dh, rs, nk, dh, acc);
      float* to = scores + (h * t_len + t) * ss + j0;
#pragma unroll
      for (int kk = 0; kk < kKeyGroup; ++kk)
        if (kk < nk) to[kk] = __fmul_rn(acc[kk], a.scale);
    }
    consumers_sync();

    // softmax: a thread per (head, query); exps in place, the reciprocal aside
    for (int w = tid; w < hg * t_len; w += kConsumers) {
      const int last = a.causal ? w % t_len : t_len - 1;
      if (t_len <= 16)
        softmax_row<16>(scores + w * ss, last, invs + w);
      else if (t_len <= fullclip::kMaxT)
        softmax_row<fullclip::kMaxT>(scores + w * ss, last, invs + w);
      else
        softmax_row<0>(scores + w * ss, last, invs + w);
    }
    consumers_sync();

    // PV of two queries t0 and t0 + 1: a thread per (query pair, head, 8
    // elements), keys in order; each staged V chunk feeds both (causal: t0's
    // keys, then t0 + 1's last)
    const int per_t = hg * nc;
    for (int w = tid; w < (t_len + 1) / 2 * per_t; w += kConsumers) {
      const int t0 = w / per_t * 2, r = w - t0 / 2 * per_t, h = r / nc;
      const int c = h * dh + (r - h * nc) * 8;
      const float* p0 = scores + (h * t_len + t0) * ss;  // query t0's row; t0 + 1's follows
      float acc[2][8];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[f][e] = 0.f;
      const int jn = a.causal ? t0 + 1 : t_len;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        float vf[8];
        load8(vs + j * rs + c, vf);
        const float a0 = p0[j], a1 = p0[ss + j];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[0][e] = fmaf(a0, vf[e], acc[0][e]);
          acc[1][e] = fmaf(a1, vf[e], acc[1][e]);
        }
      }
      const bool two = t0 + 1 < t_len;
      if (two && a.causal) {
        float vf[8];
        load8(vs + (t0 + 1) * rs + c, vf);
        const float a1 = p0[ss + t0 + 1];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[1][e] = fmaf(a1, vf[e], acc[1][e]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (f == 0 || two) {
          const float inv = invs[h * t_len + t0 + f];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[f][e] = __fmul_rn(acc[f][e], inv);
          store8(out + fullclip::at(a.out[0], row, a.n, t0 + f, col + c), acc[f]);
        }
      }
    }
    consumers_sync();  // every consumer is done with the stage
    if (tid == 0) mbar_arrive(empty + s);
  }
}

// tiled.cuh's forward on the same operands (qt, scratch, floats:
// tiled::forward's).
template <typename T>
int launch_tiled(const void* const* ptrs, const long long* strides, int batch, int n, int t_len,
                 int d, int heads, float scale, int causal, int qt, float* scratch,
                 long long floats, cudaStream_t stream) {
  tiled::Args a{};
  a.q = fullclip::operand(ptrs, strides, 0);
  a.k = fullclip::operand(ptrs, strides, 1);
  a.v = fullclip::operand(ptrs, strides, 2);
  a.o0 = fullclip::operand(ptrs, strides, 3);
  a.n = n;
  a.len = t_len;
  a.dh = d / heads;
  a.heads = heads;
  a.causal = causal;
  a.scale = scale;
  return tiled::forward<T>(batch * n, a, qt, scratch, floats, stream);
}

template <typename T>
int launch(const void* const* ptrs, const long long* strides, int batch, int n, int t_len, int d,
           int heads, float scale, int causal, int tiled, float* scratch, long long floats,
           cudaStream_t stream) {
  const int dh = d / heads;
  if (t_len < 1 || dh % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (tiled)
    return launch_tiled<T>(ptrs, strides, batch, n, t_len, d, heads, scale, causal,
                           tiled < 0 ? 0 : tiled, scratch, floats, stream);
  const fullclip::Plan p = fullclip::plan(heads, t_len, dh, sizeof(T), 3, false, causal);
  if (p.hg < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<3> a;
  for (int o = 0; o < 4; ++o)
    (o < 3 ? a.in[o] : a.out[0]) = fullclip::operand(ptrs, strides, o);
  a.out[1] = a.out[2] = a.out[0];
  a.p = p;
  a.items = batch * n * p.groups;
  a.n = n;
  a.t_len = t_len;
  a.dh = dh;
  a.causal = causal;
  a.scale = scale;
  int blocks = 0;
  const cudaError_t err =
      persistent_grid(temporal_fullclip_kernel<T>, kThreads, p.total, a.items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_fullclip_kernel<T><<<blocks, kThreads, p.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block of the whole-row pipeline needs; 0 when not even
// one head fits (the wrapper then asks for the tiled body).
extern "C" int sf_temporal_fullclip_smem_bytes(int t_len, int d, int heads, int dtype,
                                               int causal) {
  const fullclip::Plan p =
      fullclip::plan(heads, t_len, d / heads, dtype == SF_BFLOAT16 ? 2 : 4, 3, false, causal);
  return p.hg ? p.total : 0;
}

// ptrs: q, k, v, out; strides: their (b, t, n) element strides, three each.
// causal: 0 lets every query see every frame. tiled: 0 runs the whole-row
// pipeline, else tiled.cuh (which gives the same bits): 64, 32 or 16 its
// resident body at that many queries a block, -1 its split body on
// `scratch`, `floats` fp32 (ops._tiled_scratch's size; null otherwise).
extern "C" int sf_temporal_fullclip(const void* const* ptrs, const long long* strides, int batch,
                                    int n, int t_len, int d, int heads, float scale, int causal,
                                    int tiled, void* scratch, long long floats, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(ptrs, strides, batch, n, t_len, d, heads, scale, causal, tiled,
                                 sp, floats, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(ptrs, strides, batch, n, t_len, d, heads, scale, causal, tiled, sp,
                         floats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
