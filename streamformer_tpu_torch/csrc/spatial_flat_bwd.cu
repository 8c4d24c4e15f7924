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
// with fp32 accumulation, the softmax statistics and delta are fp32 (delta
// from the fp32 p, not from the rounded output), and ds and p are rounded to
// the input type before the last three products.
//
// Bound on the H100: bytes in bf16. A (row, head) moves seven N x dh arrays
// (14 N dh bytes) for 10 N^2 dh operations, about 0.7 N = 140 operations a
// byte at N=196, under the ~295 a byte where the bf16 tensor cores become
// the limit. On the CUDA cores the same work is bound by the fp32 FMA rate
// instead, which is what the bf16 body below removes.
//
// bf16 body (spatial_flat_bwd_tc_kernel), on the tensor cores, one launch.
// One block per (row, head) holds all N queries and keys (N <= 256), four
// warps, in two phases split by __syncthreads; every product runs on
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulation) over rolled loops of
// 16-key (or 16-query) steps, as in the forward (spatial_flat.cu), and the
// exponentials are 2^(c s - c m) with c = scale log2(e):
//
//   1. query side: K and V of the head in shared memory (cp.async, zero rows
//      and columns to 16, rows padded for conflict-free ldmatrix). Each warp
//      takes 16-query tiles, its Q and G fragments in registers, and sweeps
//      the keys three times: S = Q K^T for the row's max and 1/sum (running
//      per lane, combined by the quad); S and dP = G V^T for
//      delta = sum_j dp p with the fp32 p; S and dP again (the same bits) for
//      ds = p (dp - delta) scale, rounded to bf16 and packed straight into A
//      fragments of dq = ds K (K by ldmatrix.trans). dq is written, and
//      (-c m, 1/sum, delta) go to shared memory, three fp32 a query.
//   2. key side: Q and G restaged into the same shared memory. Each warp
//      takes 16-key tiles, its K and V fragments in registers, over 16-query
//      steps: S^T = K Q^T and dP^T = V G^T, P^T from the shared statistics,
//      ds^T and the bf16-rounded P^T as A fragments of dk = ds^T Q and
//      dv = P^T G (Q, G by ldmatrix.trans), summed in registers over the
//      query steps and written once.
//
// No global scratch and no atomics: every output element is summed by one
// lane in a fixed order, so two runs give the same bits.
//
// Past 256 keys the head no longer fits one block: the two phases become
// two launches over tiles (spatial_flat_bwd_dq_tc_kernel, then
// spatial_flat_bwd_dkv_tc_kernel), eight warps a block. The query side takes
// 128 queries a block and streams K and V through shared memory in stages
// of 256 keys, once for the statistics and twice more for delta and dq; it
// writes (-c m, 1/sum, delta) to an fp32 scratch in device memory, three a
// query. The key side takes 128 keys a block and streams Q, G and those
// statistics in stages of 256 queries. Each 16-step runs the whole-row
// body's arithmetic in the same order, sums stay in one lane each, and no
// atomics: two runs give the same bits.
//
// fp32 body, on the CUDA cores (TF32 could not hold the 2e-5 fp32 gate): two
// kernels of the forward's fp32 shape (spatial_flat.cu), launched back to
// back by one C entry:
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
// Every output element is owned by one lane and summed in a fixed order, so
// this body too repeats bit for bit; it computes s and dp twice. Past 256
// keys, or past a block's shared memory (heads of 128 past 190 keys), fp32
// runs tiled.cuh's backward (two launches, the same statistics between).
#include "common.cuh"
#include "tiled.cuh"

namespace {

// ---- fp32 body on the CUDA cores

using T = float;
constexpr int kWarps = 4;   // warps per block (both bodies)
constexpr int kQ = 4;       // rows (queries or keys) a warp takes at a time
constexpr int kMaxKpl = 8;  // columns per lane: N <= 256

// Stage the head slice (n x dh) of a and b into shared memory, rows padded
// to `stride` elements.
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
      for (int j = 0; j < kMaxKpl; ++j)  // ds
        dp[qi][j] = __fmul_rn(__fmul_rn(p[qi][j], __fsub_rn(dp[qi][j], delta)), scale);
    }
    weighted_rows(dq, dp, ps, ks, row_base, q0, q_end, n, d, nc, stride, lane);
  }
}

// Kernel 2: the key side.
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
        ds[kj][j] = __fmul_rn(__fmul_rn(pf, __fsub_rn(ds[kj][j], delta)), scale);
        p[kj][j] = pf;
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

int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, void* stats, int rows, int n, int d, int heads, int per_block, float scale,
           cudaStream_t stream) {
  const int dh = d / heads;
  const int elem = static_cast<int>(sizeof(T));
  const int stride = row_stride(dh, elem);
  const int smem = smem_bytes(n, dh, elem);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spatial_flat_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows) * heads, (n + per_block - 1) / per_block);
  spatial_flat_bwd_dq_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<float*>(stats), n, d, heads,
      per_block, stride, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_flat_bwd_dkv_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(stats), n, d, heads, per_block, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 body on the tensor cores

using bf16 = __nv_bfloat16;

// DT: most 16-wide dh steps (dh <= 16 DT); the key and query steps are
// rolled loops, so the body stays small.
template <int DT>
__global__ void __launch_bounds__(kWarps * 32)
spatial_flat_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int n, int d, int heads, int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = d / heads;
  const int nkt = (n + 15) / 16, ndt = (dh + 15) / 16;
  const int npad = nkt * 16;
  bf16* xs = reinterpret_cast<bf16*>(smem);                 // npad x stride: K, then Q
  bf16* ys = xs + npad * stride;                            // npad x stride: V, then G
  float* st = reinterpret_cast<float*>(ys + npad * stride);  // 3 x npad: -c m, 1/sum, delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;
  const float c2 = scale * kLog2e;
  const long base = static_cast<long>(blockIdx.x / heads) * n * d + (blockIdx.x % heads) * dh;

  // ---- 1. the query side: dq, and the statistics of every query
  stage2_tc(xs, ys, k, v, base, d, n, npad, dh, stride);
  unsigned qa[DT][4], ga[DT][4];
  load_frags<DT>(qa, q, base, d, warp * 16, n, dh, lane);  // overlaps the staging copies
  load_frags<DT>(ga, g, base, d, warp * 16, n, dh, lane);
  cp_async_wait_all();
  __syncthreads();
  for (int q0 = warp * 16; q0 < n; q0 += kWarps * 16) {
    float mc[2], inv[2];
    softmax_stats<DT>(mc, inv, qa, xs, n, ndt, stride, c2, lane);
    // delta = sum_j dp p, with the fp32 p
    float delta[2] = {0.f, 0.f};
    for (int t = 0; t < nkt; ++t) {
      float s[2][4], p[2][4], dp[2][4];
      scores16<DT>(s, qa, xs, t, n, ndt, stride, lane);
      probs16(p, s, mc, inv, c2);
      frags_times_rows<DT>(dp, ga, ys, t, ndt, stride, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(p[h][e], dp[h][e], delta[e >> 1]);
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    // dq = ds K, ds = p (dp - delta) scale rounded to bf16
    float acc[2 * DT][4];
    zero_tiles<DT>(acc);
    for (int t = 0; t < nkt; ++t) {
      float s[2][4], p[2][4], dp[2][4];
      scores16<DT>(s, qa, xs, t, n, ndt, stride, lane);
      probs16(p, s, mc, inv, c2);
      frags_times_rows<DT>(dp, ga, ys, t, ndt, stride, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[h][e] = __fmul_rn(__fmul_rn(p[h][e], __fsub_rn(dp[h][e], delta[e >> 1])), scale);
      unsigned w[4];
      pack_frag(w, p);
      weights_times_cols<DT>(acc, w, xs, t, ndt, stride, lane);
    }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        st[q0 + gq + 8 * r] = mc[r];
        st[npad + q0 + gq + 8 * r] = inv[r];
        st[2 * npad + q0 + gq + 8 * r] = delta[r];
      }
    }
    if (q0 + kWarps * 16 < n) {
      load_frags<DT>(qa, q, base, d, q0 + kWarps * 16, n, dh, lane);
      load_frags<DT>(ga, g, base, d, q0 + kWarps * 16, n, dh, lane);
    }
    store_tiles<DT>(dq, acc, base, d, q0, n, dh, ndt, lane);
  }
  __syncthreads();  // K and V are done with; the statistics are complete

  // ---- 2. the key side: dk = ds^T Q and dv = P^T G
  stage2_tc(xs, ys, q, g, base, d, n, npad, dh, stride);
  unsigned ka[DT][4], va[DT][4];
  load_frags<DT>(ka, k, base, d, warp * 16, n, dh, lane);
  load_frags<DT>(va, v, base, d, warp * 16, n, dh, lane);
  cp_async_wait_all();
  __syncthreads();
  for (int k0 = warp * 16; k0 < n; k0 += kWarps * 16) {
    float dka[2 * DT][4], dva[2 * DT][4];
    zero_tiles<DT>(dka);
    zero_tiles<DT>(dva);
    for (int t = 0; t < nkt; ++t) {
      // rows: the warp's 16 keys; columns: queries 16 t .. 16 t + 15
      float sT[2][4], dpT[2][4];
      frags_times_rows<DT>(sT, ka, xs, t, ndt, stride, lane);
      frags_times_rows<DT>(dpT, va, ys, t, ndt, stride, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = t * 16 + h * 8 + 2 * c + (e & 1);  // the query
          const float pf = i < n ? ex2(fmaf(sT[h][e], c2, st[i])) * st[npad + i] : 0.f;
          dpT[h][e] = __fmul_rn(__fmul_rn(pf, __fsub_rn(dpT[h][e], st[2 * npad + i])), scale);
          sT[h][e] = pf;
        }
      }
      unsigned wds[4], wp[4];
      pack_frag(wds, dpT);
      pack_frag(wp, sT);
      weights_times_cols<DT>(dka, wds, xs, t, ndt, stride, lane);
      weights_times_cols<DT>(dva, wp, ys, t, ndt, stride, lane);
    }
    if (k0 + kWarps * 16 < n) {
      load_frags<DT>(ka, k, base, d, k0 + kWarps * 16, n, dh, lane);
      load_frags<DT>(va, v, base, d, k0 + kWarps * 16, n, dh, lane);
    }
    store_tiles<DT>(dk, dka, base, d, k0, n, dh, ndt, lane);
    store_tiles<DT>(dv, dva, base, d, k0, n, dh, ndt, lane);
  }
}

// ---- bf16 past 256 keys: the two phases as two tiled launches

constexpr int kTiledWarps = 8;    // warps a block: 128 queries (keys) an item
constexpr int kTcStage = 256;     // keys (queries) a stage
constexpr int kTcMaxN = 256;      // past this, the tiled launches

// The query side: dq, and (-c m, 1/sum, delta) of each query to stats
// ((rows * heads, 3, n) fp32).
template <int DT>
__global__ void __launch_bounds__(kTiledWarps * 32)
spatial_flat_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              bf16* __restrict__ dq, float* __restrict__ stats, int n, int d,
                              int heads, int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = d / heads, ndt = (dh + 15) / 16;
  const int npad = (n + 15) / 16 * 16;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kTcStage x stride: K
  bf16* ys = xs + kTcStage * stride;         // kTcStage x stride: V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;
  const float c2 = scale * kLog2e;
  const int chunks = (n + kTiledWarps * 16 - 1) / (kTiledWarps * 16);
  const int rh = blockIdx.x / chunks;
  const int q0 = (blockIdx.x - rh * chunks) * kTiledWarps * 16 + warp * 16;
  const long base = static_cast<long>(rh / heads) * n * d + (rh % heads) * dh;
  const bool on = q0 < n;
  unsigned qa[DT][4], ga[DT][4];
  load_frags<DT>(qa, q, base, d, q0, n, dh, lane);
  load_frags<DT>(ga, g, base, d, q0, n, dh, lane);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < npad; k0 += kTcStage) {
    const int nr = min(kTcStage, npad - k0);
    __syncthreads();
    stage1_tc(xs, k, base + static_cast<long>(k0) * d, d, n - k0, nr, dh, stride);
    cp_async_wait_all();
    __syncthreads();
    if (on) {
#pragma unroll 2
      for (int t = 0; t < nr / 16; ++t) {
        float s[2][4];
        scores16<DT>(s, qa, xs, t, n - k0, ndt, stride, lane);
        stats_step(mx, sum, s, c2);
      }
    }
  }
  float mc[2], inv[2];
  stats_finish(mc, inv, mx, sum, c2);
  // delta = sum_j dp p, with the fp32 p; then dq = ds K
  float delta[2] = {0.f, 0.f};
  float acc[2 * DT][4];
  zero_tiles<DT>(acc);
  for (int sweep = 0; sweep < 2; ++sweep) {
    if (sweep == 1) {
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
    }
    for (int k0 = 0; k0 < npad; k0 += kTcStage) {
      const int nr = min(kTcStage, npad - k0);
      __syncthreads();
      stage2_tc(xs, ys, k, v, base + static_cast<long>(k0) * d, d, n - k0, nr, dh, stride);
      cp_async_wait_all();
      __syncthreads();
      if (!on) continue;
      for (int t = 0; t < nr / 16; ++t) {
        float s[2][4], p[2][4], dp[2][4];
        scores16<DT>(s, qa, xs, t, n - k0, ndt, stride, lane);
        probs16(p, s, mc, inv, c2);
        frags_times_rows<DT>(dp, ga, ys, t, ndt, stride, lane);
        if (sweep == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(p[h][e], dp[h][e], delta[e >> 1]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[h][e] = __fmul_rn(__fmul_rn(p[h][e], __fsub_rn(dp[h][e], delta[e >> 1])), scale);
          unsigned w[4];
          pack_frag(w, p);
          weights_times_cols<DT>(acc, w, xs, t, ndt, stride, lane);
        }
      }
    }
  }
  if (!on) return;
  store_tiles<DT>(dq, acc, base, d, q0, n, dh, ndt, lane);
  if (c == 0) {
    float* st = stats + static_cast<long>(rh) * 3 * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + gq + 8 * r;
      if (i < n) {
        st[i] = mc[r];
        st[n + i] = inv[r];
        st[2 * n + i] = delta[r];
      }
    }
  }
}

// The key side: dk = ds^T Q and dv = P^T G, the statistics from stats.
template <int DT>
__global__ void __launch_bounds__(kTiledWarps * 32)
spatial_flat_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ g,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               const float* __restrict__ stats, int n, int d, int heads,
                               int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = d / heads, ndt = (dh + 15) / 16;
  const int npad = (n + 15) / 16 * 16;
  bf16* xs = reinterpret_cast<bf16*>(smem);                      // kTcStage x stride: Q
  bf16* ys = xs + kTcStage * stride;                             // kTcStage x stride: G
  float* st = reinterpret_cast<float*>(ys + kTcStage * stride);  // 3 x kTcStage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3;
  const float c2 = scale * kLog2e;
  const int chunks = (n + kTiledWarps * 16 - 1) / (kTiledWarps * 16);
  const int rh = blockIdx.x / chunks;
  const int k0 = (blockIdx.x - rh * chunks) * kTiledWarps * 16 + warp * 16;
  const long base = static_cast<long>(rh / heads) * n * d + (rh % heads) * dh;
  const float* stat = stats + static_cast<long>(rh) * 3 * n;
  const bool on = k0 < n;
  unsigned ka[DT][4], va[DT][4];
  load_frags<DT>(ka, k, base, d, k0, n, dh, lane);
  load_frags<DT>(va, v, base, d, k0, n, dh, lane);
  float dka[2 * DT][4], dva[2 * DT][4];
  zero_tiles<DT>(dka);
  zero_tiles<DT>(dva);
  for (int q0 = 0; q0 < npad; q0 += kTcStage) {
    const int nr = min(kTcStage, npad - q0), nq = n - q0;
    __syncthreads();
    stage2_tc(xs, ys, q, g, base + static_cast<long>(q0) * d, d, nq, nr, dh, stride);
    for (int i = threadIdx.x; i < 3 * kTcStage; i += blockDim.x) {
      const int s = i / kTcStage, r = i - s * kTcStage;
      st[i] = r < nq ? stat[s * n + q0 + r] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!on) continue;
    for (int t = 0; t < nr / 16; ++t) {
      // rows: the warp's 16 keys; columns: queries 16 t .. 16 t + 15 of the stage
      float sT[2][4], dpT[2][4];
      frags_times_rows<DT>(sT, ka, xs, t, ndt, stride, lane);
      frags_times_rows<DT>(dpT, va, ys, t, ndt, stride, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = t * 16 + h * 8 + 2 * c + (e & 1);  // the query, in the stage
          const float pf = i < nq ? ex2(fmaf(sT[h][e], c2, st[i])) * st[kTcStage + i] : 0.f;
          dpT[h][e] =
              __fmul_rn(__fmul_rn(pf, __fsub_rn(dpT[h][e], st[2 * kTcStage + i])), scale);
          sT[h][e] = pf;
        }
      }
      unsigned wds[4], wp[4];
      pack_frag(wds, dpT);
      pack_frag(wp, sT);
      weights_times_cols<DT>(dka, wds, xs, t, ndt, stride, lane);
      weights_times_cols<DT>(dva, wp, ys, t, ndt, stride, lane);
    }
  }
  if (!on) return;
  store_tiles<DT>(dk, dka, base, d, k0, n, dh, ndt, lane);
  store_tiles<DT>(dv, dva, base, d, k0, n, dh, ndt, lane);
}

// Two staged operands (16 * ceil(n / 16) rows each, at most a stage's) and
// the statistics (three fp32 a query of a stage).
inline int tc_smem_bytes(int n, int dh) {
  const int npad = min((n + 15) / 16 * 16, kTcStage);
  return 2 * npad * tc_row_stride(dh) * 2 + 3 * npad * 4;
}

template <int DT>
int launch_tc_tiled(const void* q, const void* k, const void* v, const void* g, void* dq,
                    void* dk, void* dv, void* stats, int rows, int n, int d, int heads,
                    float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes(n, d / heads);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_bwd_dq_tc_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(spatial_flat_bwd_dkv_tc_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n + kTiledWarps * 16 - 1) / (kTiledWarps * 16);
  const unsigned grid = static_cast<unsigned>(rows) * heads * chunks;
  const int stride = tc_row_stride(d / heads);
  spatial_flat_bwd_dq_tc_kernel<DT><<<grid, kTiledWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<float*>(stats), n, d,
      heads, stride, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_flat_bwd_dkv_tc_kernel<DT><<<grid, kTiledWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), n, d, heads, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_tc_body(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, int rows, int n, int d, int heads, float scale,
                   cudaStream_t stream) {
  const int smem = tc_smem_bytes(n, d / heads);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_bwd_tc_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_flat_bwd_tc_kernel<DT><<<static_cast<unsigned>(rows) * heads, kWarps * 32, smem,
                                   stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, d, heads, tc_row_stride(d / heads), scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
              void* dv, void* stats, int rows, int n, int d, int heads, float scale,
              cudaStream_t stream) {
  const int dh = d / heads;
  if (n < 1 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (n > kTcMaxN) {
    if (!stats) return static_cast<int>(cudaErrorInvalidValue);
    if (dh <= 32)
      return launch_tc_tiled<2>(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, scale, stream);
    if (dh <= 64)
      return launch_tc_tiled<4>(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, scale, stream);
    return launch_tc_tiled<8>(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, scale, stream);
  }
  if (dh <= 32) return launch_tc_body<2>(q, k, v, g, dq, dk, dv, rows, n, d, heads, scale, stream);
  if (dh <= 64) return launch_tc_body<4>(q, k, v, g, dq, dk, dv, rows, n, d, heads, scale, stream);
  return launch_tc_body<8>(q, k, v, g, dq, dk, dv, rows, n, d, heads, scale, stream);
}

// Whether the per-lane fp32 body takes n keys: kMaxKpl columns a lane, and
// its staged operands within a block's shared memory.
inline bool fp32_fits(int n, int dh) {
  return n <= 32 * kMaxKpl && smem_bytes(n, dh, 4) <= fullclip::kMaxSmem;
}

// tiled.cuh's backward on (R, N, D) rows, heads as column slices, by its
// `plan`.
int launch_tiled(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                 void* dv, void* stats, int rows, int n, int d, int heads, float scale, int plan,
                 void* scratch, long long floats, cudaStream_t stream) {
  const long long row = static_cast<long long>(n) * d;
  tiled::Args a{};
  a.q = {const_cast<void*>(q), row, d, 0};
  a.k = {const_cast<void*>(k), row, d, 0};
  a.v = {const_cast<void*>(v), row, d, 0};
  a.g = {const_cast<void*>(g), row, d, 0};
  a.stats = static_cast<float*>(stats);
  a.n = 1;
  a.len = n;
  a.dh = d / heads;
  a.heads = heads;
  a.causal = 0;
  a.scale = scale;
  tiled::Args dkv = a;
  a.o0 = {dq, row, d, 0};
  dkv.o0 = {dk, row, d, 0};
  dkv.o1 = {dv, row, d, 0};
  return tiled::backward<T>(rows, a, dkv, plan, static_cast<float*>(scratch), floats, stream);
}

}  // namespace

// Shared memory a block of the whole-head body needs (bf16: any n); 0 where
// only tiled.cuh takes the shape (fp32 past fp32_fits), and the wrapper
// then passes a plan of its backward as `tiled`.
extern "C" int sf_spatial_flat_bwd_smem_bytes(int n, int d, int heads, int dtype) {
  const int dh = d / heads;
  if (dtype == SF_BFLOAT16) return tc_smem_bytes(n, dh);
  return fp32_fits(n, dh) ? smem_bytes(n, dh, 4) : 0;
}

// stats: fp32 scratch of rows * heads * 3 * n elements, written by the
// query side and read by the key side: fp32 at any n, bf16 past 256 keys
// (else unused; the one-block bf16 body keeps them in shared memory).
// per_block: the fp32 body's rows a block takes; the bf16 body takes a
// whole head, or 128 queries (keys) an item past 256. tiled: 0 runs the
// whole-head body, else tiled.cuh's backward (fp32 only) on plan tiled - 1
// (its bits tiled::kBwdSweeps, kBwdStored). scratch: the plan's, `floats`
// fp32, or null (ops._tiled_bwd_launch).
extern "C" int sf_spatial_flat_bwd(const void* q, const void* k, const void* v, const void* g,
                                   void* dq, void* dk, void* dv, void* stats, int rows, int n,
                                   int d, int heads, int per_block, float scale, int tiled,
                                   void* scratch, long long floats, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16 && !tiled)
    return launch_tc(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, scale, st);
  if (dtype == SF_FLOAT32 && tiled)
    return launch_tiled(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, scale, tiled - 1,
                        scratch, floats, st);
  if (dtype == SF_FLOAT32 && fp32_fits(n, d / heads))
    return launch(q, k, v, g, dq, dk, dv, stats, rows, n, d, heads, per_block, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
