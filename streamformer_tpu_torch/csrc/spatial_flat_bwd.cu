// Backward of the non-causal softmax attention over the N patches of each
// (b, t) row: dq, dk, dv from q, k, v and the output gradient g, heads as
// dh-wide slices of D.
//
// Replaces: streamformer_tpu/ops/attention.py _spatial_flat_bwd_pallas
// (kernel body _spatial_flat_bwd_kernel), the backward of
// fused_spatial_flat. Same contract: q, k, v, g, dq, dk, dv are (R, N, D);
// the forward saves q, k, v only, so s and p are recomputed per head:
//
//   s = q k^T * scale      p = softmax(s)          dp = g v^T
//   delta = sum_j dp p     ds = p (dp - delta) scale
//   dq = ds k              dk = ds^T q             dv = p^T g
//
// with the TPU kernel's rounding: products take operands in the input type
// with fp32 accumulation, the softmax statistics and delta are fp32, and ds
// and p are rounded to the input type before the last three products.
//
// Bound on the H100: bytes in bf16 if the products ran on the tensor cores
// (seven (R, N, D) arrays against about 2.5*N operations per byte). This
// first version computes on the CUDA cores, so what limits it is the fp32
// FMA rate and the shared-memory reads that feed it. An (N, N) tile of p
// does not fit beside the operands, and dk and dv sum over the queries while
// dq sums over the keys. So the work is two kernels of the forward's shape
// (spatial_flat.cu), launched back to back by one C entry:
//
//   1. query side, one block per (row, head, query chunk), K and V of the
//      head staged in shared memory: each warp takes four queries, lane j
//      holds keys j, j+32, ...; s, the row max and sum, p, dp, delta and ds
//      stay in registers; dq = ds k is reduced with shuffles and written;
//      the row's (max, 1/sum, delta) go to a small fp32 scratch, 3 floats
//      per (row, head, query).
//   2. key side, one block per (row, head, key chunk), Q and G staged in
//      shared memory with the statistics: each warp takes four keys, lane i
//      holds queries i, i+32, ...; it recomputes s^T and dp^T with the same
//      chain of FMAs, takes p and ds from the statistics, and reduces
//      dk = ds^T q and dv = p^T g over the queries with shuffles.
//
// Every output element is owned by one lane and summed in a fixed order:
// no atomics, two runs give the same bits. The price is that s and dp are
// computed twice (seven products for the TPU kernel's five).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps per block
constexpr int kQ = 4;       // rows (queries or keys) a warp takes at a time
constexpr int kMaxKpl = 8;  // columns per lane: N <= 256

// Stage the head slice (n x dh) of a and b into shared memory, rows padded
// to `stride` elements.
template <typename T>
__device__ __forceinline__ void stage2(T* as, T* bs, const T* __restrict__ a,
                                       const T* __restrict__ b, long row_base, int n, int d,
                                       int nc, int stride) {
  for (int i = threadIdx.x; i < n * nc; i += blockDim.x) {
    const int r = i / nc, c = i % nc;
    const long src = row_base + static_cast<long>(r) * d + c * 8;
    copy8(as + r * stride + c * 8, a + src);
    copy8(bs + r * stride + c * 8, b + src);
  }
}

// The warp's kQ rows [r0, r0 + kQ) of a and b as fp32 (zeros past r_end).
template <typename T>
__device__ __forceinline__ void own_rows(float* as, float* bs, const T* __restrict__ a,
                                         const T* __restrict__ b, long row_base, int r0,
                                         int r_end, int d, int dh, int lane) {
  for (int i = lane; i < kQ * dh; i += 32) {
    const int ri = i / dh, e = i % dh;
    const bool on = r0 + ri < r_end;
    const long src = row_base + static_cast<long>(r0 + ri) * d + e;
    as[i] = on ? to_f32(a[src]) : 0.f;
    bs[i] = on ? to_f32(b[src]) : 0.f;
  }
}

// acc[ri][j] = sum over dh of own[ri] . staged[lane + 32 j], one sequential
// FMA chain over dh for each pair (the same chain on both sides).
template <typename T>
__device__ __forceinline__ void dots(float (&acc)[kQ][kMaxKpl], const float* own, const T* staged,
                                     int n, int nc, int dh, int stride, int lane) {
  const int kpl = (n + 31) / 32;
#pragma unroll
  for (int ri = 0; ri < kQ; ++ri)
#pragma unroll
    for (int j = 0; j < kMaxKpl; ++j) acc[ri][j] = 0.f;
  for (int c = 0; c < nc; ++c) {
    float ov[kQ][8];
#pragma unroll
    for (int ri = 0; ri < kQ; ++ri) {
      const float4 a = *reinterpret_cast<const float4*>(own + ri * dh + c * 8);
      const float4 b = *reinterpret_cast<const float4*>(own + ri * dh + c * 8 + 4);
      ov[ri][0] = a.x; ov[ri][1] = a.y; ov[ri][2] = a.z; ov[ri][3] = a.w;
      ov[ri][4] = b.x; ov[ri][5] = b.y; ov[ri][6] = b.z; ov[ri][7] = b.w;
    }
#pragma unroll
    for (int j = 0; j < kMaxKpl; ++j) {
      const int col = lane + 32 * j;
      if (j < kpl && col < n) {
        float sf[8];
        load8(staged + col * stride + c * 8, sf);
#pragma unroll
        for (int ri = 0; ri < kQ; ++ri)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[ri][j] = fmaf(ov[ri][e], sf[e], acc[ri][j]);
      }
    }
  }
}

// out[r0 + ri] = sum over columns of w[ri][col] * staged[col], the weights
// handed over through `ps` (n float4, one per column). Lanes split into dh/8
// chunks of the output times a power-of-two number of column groups, summed
// with shuffles at the end.
template <typename T>
__device__ __forceinline__ void weighted_rows(T* __restrict__ out, const float (&w)[kQ][kMaxKpl],
                                              float4* ps, const T* staged, long row_base, int r0,
                                              int r_end, int n, int d, int nc, int stride,
                                              int lane) {
  const int kpl = (n + 31) / 32;
  int groups = 1;
  while (groups * 2 * nc <= 32) groups *= 2;
  const int pv_c = lane % nc;
  const int pv_g = lane / nc;
  __syncwarp();  // the previous readers of ps are done
#pragma unroll
  for (int j = 0; j < kMaxKpl; ++j) {
    const int col = lane + 32 * j;
    if (j < kpl && col < n) ps[col] = make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
  }
  __syncwarp();
  float acc[kQ][8];
#pragma unroll
  for (int ri = 0; ri < kQ; ++ri)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[ri][e] = 0.f;
  if (pv_g < groups) {
    for (int col = pv_g; col < n; col += groups) {
      const float4 pk = ps[col];
      const float pw[kQ] = {pk.x, pk.y, pk.z, pk.w};
      float sf[8];
      load8(staged + col * stride + pv_c * 8, sf);
#pragma unroll
      for (int ri = 0; ri < kQ; ++ri)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[ri][e] = fmaf(pw[ri], sf[e], acc[ri][e]);
    }
  }
  for (int half = groups / 2; half > 0; half /= 2) {
#pragma unroll
    for (int ri = 0; ri < kQ; ++ri)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[ri][e] += __shfl_down_sync(0xffffffffu, acc[ri][e], half * nc);
  }
  if (pv_g == 0) {
#pragma unroll
    for (int ri = 0; ri < kQ; ++ri)
      if (r0 + ri < r_end)
        store8(out + row_base + static_cast<long>(r0 + ri) * d + pv_c * 8, acc[ri]);
  }
}

// Kernel 1: the query side. stats: (rows * heads, 3, n) fp32.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spatial_flat_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                           float* __restrict__ stats, int n, int d, int heads, int per_block,
                           int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = d / heads;
  const int nc = dh / 8;
  T* ks = reinterpret_cast<T*>(smem);          // n x stride
  T* vs = ks + static_cast<long>(n) * stride;  // n x stride
  float* qs_all = reinterpret_cast<float*>(vs + static_cast<long>(n) * stride);  // warps x kQ x dh
  float* gs_all = qs_all + kWarps * kQ * dh;
  float4* ps_all = reinterpret_cast<float4*>(gs_all + kWarps * kQ * dh);  // warps x n

  const int row = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const long row_base = static_cast<long>(row) * n * d + head * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage2(ks, vs, k, v, row_base, n, d, nc, stride);
  __syncthreads();

  float* qs = qs_all + warp * kQ * dh;
  float* gs = gs_all + warp * kQ * dh;
  float4* ps = ps_all + warp * n;
  float* st = stats + static_cast<long>(blockIdx.x) * 3 * n;
  const int kpl = (n + 31) / 32;
  const int q_begin = blockIdx.y * per_block;
  const int q_end = min(n, q_begin + per_block);
  for (int q0 = q_begin + warp * kQ; q0 < q_end; q0 += kWarps * kQ) {
    __syncwarp();  // the previous round's readers of qs, gs are done
    own_rows(qs, gs, q, g, row_base, q0, q_end, d, dh, lane);
    __syncwarp();

    float p[kQ][kMaxKpl], dp[kQ][kMaxKpl];
    dots(p, qs, ks, n, nc, dh, stride, lane);
    float m[kQ], inv[kQ];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) {
        p[qi][j] = __fmul_rn(p[qi][j], scale);
        if (j < kpl && lane + 32 * j < n) mx = fmaxf(mx, p[qi][j]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) {
        p[qi][j] = j < kpl && lane + 32 * j < n ? expf(__fsub_rn(p[qi][j], mx)) : 0.f;
        sum += p[qi][j];
      }
      m[qi] = mx;
      inv[qi] = __fdiv_rn(1.f, warp_sum(sum));
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) p[qi][j] = __fmul_rn(p[qi][j], inv[qi]);
    }
    dots(dp, gs, vs, n, nc, dh, stride, lane);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) part = fmaf(p[qi][j], dp[qi][j], part);
      const float delta = warp_sum(part);
      if (lane == qi && q0 + qi < q_end) {
        st[q0 + qi] = m[qi];
        st[n + q0 + qi] = inv[qi];
        st[2 * n + q0 + qi] = delta;
      }
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j)  // ds, rounded to the input type
        dp[qi][j] = round_to<T>(__fmul_rn(__fmul_rn(p[qi][j], __fsub_rn(dp[qi][j], delta)), scale));
    }
    weighted_rows(dq, dp, ps, ks, row_base, q0, q_end, n, d, nc, stride, lane);
  }
}

// Kernel 2: the key side.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spatial_flat_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const float* __restrict__ stats, int n, int d, int heads,
                            int per_block, int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = d / heads;
  const int nc = dh / 8;
  T* qs = reinterpret_cast<T*>(smem);          // n x stride
  T* gs = qs + static_cast<long>(n) * stride;  // n x stride
  float* ks_all = reinterpret_cast<float*>(gs + static_cast<long>(n) * stride);  // warps x kQ x dh
  float* vs_all = ks_all + kWarps * kQ * dh;
  float4* ps_all = reinterpret_cast<float4*>(vs_all + kWarps * kQ * dh);  // warps x n
  float* st = reinterpret_cast<float*>(ps_all + kWarps * n);              // 3 x n

  const int row = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const long row_base = static_cast<long>(row) * n * d + head * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage2(qs, gs, q, g, row_base, n, d, nc, stride);
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    st[i] = stats[static_cast<long>(blockIdx.x) * 3 * n + i];
  __syncthreads();

  float* ks = ks_all + warp * kQ * dh;
  float* vs = vs_all + warp * kQ * dh;
  float4* ps = ps_all + warp * n;
  const int kpl = (n + 31) / 32;
  const int k_begin = blockIdx.y * per_block;
  const int k_end = min(n, k_begin + per_block);
  for (int k0 = k_begin + warp * kQ; k0 < k_end; k0 += kWarps * kQ) {
    __syncwarp();  // the previous round's readers of ks, vs are done
    own_rows(ks, vs, k, v, row_base, k0, k_end, d, dh, lane);
    __syncwarp();

    float p[kQ][kMaxKpl], ds[kQ][kMaxKpl];
    dots(p, ks, qs, n, nc, dh, stride, lane);   // s^T: p[kj][i] = k[kj] . q[i]
    dots(ds, vs, gs, n, nc, dh, stride, lane);  // dp^T
#pragma unroll
    for (int j = 0; j < kMaxKpl; ++j) {
      const int i = lane + 32 * j;
      const bool on = j < kpl && i < n;
      const float m = on ? st[i] : 0.f;
      const float inv = on ? st[n + i] : 0.f;
      const float delta = on ? st[2 * n + i] : 0.f;
#pragma unroll
      for (int kj = 0; kj < kQ; ++kj) {
        const float pf = on ? __fmul_rn(expf(__fsub_rn(__fmul_rn(p[kj][j], scale), m)), inv) : 0.f;
        ds[kj][j] = round_to<T>(__fmul_rn(__fmul_rn(pf, __fsub_rn(ds[kj][j], delta)), scale));
        p[kj][j] = round_to<T>(pf);
      }
    }
    weighted_rows(dk, ds, ps, qs, row_base, k0, k_end, n, d, nc, stride, lane);
    weighted_rows(dv, p, ps, gs, row_base, k0, k_end, n, d, nc, stride, lane);
  }
}

// Elements per staged row in shared memory: the head slice padded to an odd
// number of 16-byte units (eight lanes reading eight rows hit distinct banks).
inline int row_stride(int dh, int elem) { return ((dh * elem / 16) | 1) * 16 / elem; }

// Two staged operands (n rows each), the warps' two sets of fp32 rows, their
// weights, and (key side) the statistics.
inline int smem_bytes(int n, int dh, int elem) {
  return 2 * n * row_stride(dh, elem) * elem + 2 * kWarps * kQ * dh * 4 + kWarps * n * 16 +
         3 * n * 4;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, void* stats, int rows, int n, int d, int heads, int per_block, float scale,
           cudaStream_t stream) {
  const int dh = d / heads;
  const int elem = static_cast<int>(sizeof(T));
  const int stride = row_stride(dh, elem);
  const int smem = smem_bytes(n, dh, elem);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spatial_flat_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows) * heads, (n + per_block - 1) / per_block);
  spatial_flat_bwd_dq_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<float*>(stats), n, d, heads,
      per_block, stride, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_flat_bwd_dkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(stats), n, d, heads, per_block, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sf_spatial_flat_bwd_smem_bytes(int n, int d, int heads, int dtype) {
  return smem_bytes(n, d / heads, dtype == SF_BFLOAT16 ? 2 : 4);
}

// stats: fp32 scratch of rows * heads * 3 * n elements, written by the query
// side and read by the key side.
extern "C" int sf_spatial_flat_bwd(const void* q, const void* k, const void* v, const void* g,
                                   void* dq, void* dk, void* dv, void* stats, int rows, int n,
                                   int d, int heads, int per_block, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, per_block,
                                 scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, per_block, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
