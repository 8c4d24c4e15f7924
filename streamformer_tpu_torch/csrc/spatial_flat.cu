// Non-causal softmax attention over the N patches of each (b, t) row: heads
// as dh-wide slices of D (kernel B), or head-split (kernel L).
//
// Replaces: streamformer_tpu/ops/attention.py fused_spatial_flat, forward
// (_spatial_flat_pallas, kernel body _spatial_flat_kernel), and
// fused_spatial_attention (_spatial_pallas, body _spatial_kernel). Same
// contract: q, k, v, out are (R, N, D) for B and (R, H, N, dh) for L, which
// the kernel reads through three strides (row, head, token); scores are taken
// from input-type values with fp32 accumulation, the softmax runs in fp32,
// and the probabilities are rounded to the input type before the PV
// product, as both TPU kernels do. L's TPU kernel pads N to 128 for Mosaic's
// tiles; nothing is padded here.
//
// Bound on the H100: bytes at the full-clip shape in bf16 (about 2*N
// operations per byte against the tensor cores' ~295), operations in fp32.
// This first version computes on the CUDA cores, not the tensor cores, so
// what limits it is the fp32 FMA rate and the shared-memory reads that feed
// it; its design keeps each K/V byte read from device memory once per
// block. One block per (row, head, query chunk): the head's K and V slices
// (N x dh) are staged in shared memory with rows padded to an odd number of
// 16-byte units, so that eight lanes reading eight rows hit distinct banks.
// Each warp takes four queries at a time, so every K/V element read from
// shared memory feeds four FMAs. QK^T: lane j holds the scores of keys j,
// j+32, ... (N <= 256), accumulated over dh in chunks of eight.
// PV: lanes split into dh/8 chunks of the output times a power-of-two
// number of key groups, reduced with shuffles at the end. The wrapper
// splits the queries of a row into chunks only when R*H blocks alone would
// leave SMs idle (the streaming step). L is B's body on head-split strides:
// a head's rows are contiguous dh-element runs there, which changes the
// addresses and nothing else.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps per block
constexpr int kQ = 4;       // queries a warp takes at a time
constexpr int kMaxKpl = 8;  // keys per lane in QK^T: N <= 256

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spatial_flat_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int n, int dh, int heads, long row_elems,
                    long head_elems, int tok_elems, int q_per_block, int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = dh / 8;  // 8-element chunks of a head slice
  T* ks = reinterpret_cast<T*>(smem);                                // n x stride
  T* vs = ks + static_cast<long>(n) * stride;                        // n x stride
  float* qs_all = reinterpret_cast<float*>(vs + static_cast<long>(n) * stride);  // warps x kQ x dh
  float4* ps_all = reinterpret_cast<float4*>(qs_all + kWarps * kQ * dh);          // warps x n

  const int row = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const long row_base = row * row_elems + head * head_elems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < n * nc; i += blockDim.x) {
    const int key = i / nc, c = i % nc;
    const long g = row_base + static_cast<long>(key) * tok_elems + c * 8;
    copy8(ks + key * stride + c * 8, k + g);
    copy8(vs + key * stride + c * 8, v + g);
  }
  __syncthreads();

  float* qs = qs_all + warp * kQ * dh;
  float4* ps = ps_all + warp * n;
  const int kpl = (n + 31) / 32;
  // PV lane layout: chunk c of the output, key group g of `groups`
  int groups = 1;
  while (groups * 2 * nc <= 32) groups *= 2;
  const int pv_c = lane % nc;
  const int pv_g = lane / nc;
  const bool pv_on = pv_g < groups;

  const int q_begin = blockIdx.y * q_per_block;
  const int q_end = min(n, q_begin + q_per_block);
  for (int q0 = q_begin + warp * kQ; q0 < q_end; q0 += kWarps * kQ) {
    for (int i = lane; i < kQ * dh; i += 32) {
      const int qi = i / dh, e = i % dh;
      qs[i] = q0 + qi < q_end ? to_f32(q[row_base + static_cast<long>(q0 + qi) * tok_elems + e])
                              : 0.f;
    }
    __syncwarp();

    float s[kQ][kMaxKpl];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) s[qi][j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      float qv[kQ][8];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        const float4 a = *reinterpret_cast<const float4*>(qs + qi * dh + c * 8);
        const float4 b = *reinterpret_cast<const float4*>(qs + qi * dh + c * 8 + 4);
        qv[qi][0] = a.x; qv[qi][1] = a.y; qv[qi][2] = a.z; qv[qi][3] = a.w;
        qv[qi][4] = b.x; qv[qi][5] = b.y; qv[qi][6] = b.z; qv[qi][7] = b.w;
      }
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) {
        const int key = lane + 32 * j;
        if (j < kpl && key < n) {
          float kf[8];
          load8(ks + key * stride + c * 8, kf);
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
            for (int e = 0; e < 8; ++e) s[qi][j] = fmaf(qv[qi][e], kf[e], s[qi][j]);
        }
      }
    }

    // fp32 softmax per query, probabilities rounded to the input type
    float p[kQ][kMaxKpl];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) {
        s[qi][j] *= scale;
        if (j < kpl && lane + 32 * j < n) m = fmaxf(m, s[qi][j]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) {
        p[qi][j] = j < kpl && lane + 32 * j < n ? expf(s[qi][j] - m) : 0.f;
        sum += p[qi][j];
      }
      const float inv = 1.f / warp_sum(sum);
#pragma unroll
      for (int j = 0; j < kMaxKpl; ++j) p[qi][j] = round_to<T>(p[qi][j] * inv);
    }
#pragma unroll
    for (int j = 0; j < kMaxKpl; ++j) {
      const int key = lane + 32 * j;
      if (j < kpl && key < n) ps[key] = make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncwarp();

    float acc[kQ][8];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[qi][e] = 0.f;
    if (pv_on) {
      for (int key = pv_g; key < n; key += groups) {
        const float4 pk = ps[key];
        const float pq[kQ] = {pk.x, pk.y, pk.z, pk.w};
        float vf[8];
        load8(vs + key * stride + pv_c * 8, vf);
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[qi][e] = fmaf(pq[qi], vf[e], acc[qi][e]);
      }
    }
    for (int half = groups / 2; half > 0; half /= 2) {
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[qi][e] += __shfl_down_sync(0xffffffffu, acc[qi][e], half * nc);
    }
    if (pv_g == 0) {
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi)
        if (q0 + qi < q_end)
          store8(out + row_base + static_cast<long>(q0 + qi) * tok_elems + pv_c * 8, acc[qi]);
    }
    __syncwarp();
  }
}

// Elements per K/V row in shared memory: the head slice padded to an odd
// number of 16-byte units.
inline int row_stride(int dh, int elem) { return ((dh * elem / 16) | 1) * 16 / elem; }

// K and V (n rows each), the warps' fp32 queries and their probabilities.
inline int smem_bytes(int n, int dh, int elem) {
  return 2 * n * row_stride(dh, elem) * elem + kWarps * kQ * dh * 4 + kWarps * n * 16;
}

// head_split: q, k, v, out are (R, H, N, dh), else (R, N, H*dh)
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
           int heads, bool head_split, int q_per_block, float scale, cudaStream_t stream) {
  const long d = static_cast<long>(heads) * dh;
  const long row_elems = n * d;
  const long head_elems = head_split ? static_cast<long>(n) * dh : dh;
  const int tok_elems = head_split ? dh : static_cast<int>(d);
  const int elem = static_cast<int>(sizeof(T));
  const int stride = row_stride(dh, elem);
  const int smem = smem_bytes(n, dh, elem);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows) * heads, (n + q_per_block - 1) / q_per_block);
  spatial_flat_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, dh, heads, row_elems, head_elems, tok_elems, q_per_block, stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
             int heads, bool head_split, int q_per_block, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k, v, out, rows, n, dh, heads, head_split, q_per_block, scale,
                                 st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k, v, out, rows, n, dh, heads, head_split, q_per_block, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int sf_spatial_flat_smem_bytes(int n, int d, int heads, int dtype) {
  return smem_bytes(n, d / heads, dtype == SF_BFLOAT16 ? 2 : 4);
}

// B: q, k, v, out (R, N, D)
extern "C" int sf_spatial_flat(const void* q, const void* k, const void* v, void* out, int rows,
                               int n, int d, int heads, int q_per_block, float scale, int dtype,
                               void* stream) {
  return dispatch(q, k, v, out, rows, n, d / heads, heads, false, q_per_block, scale, dtype,
                  stream);
}

// L: q, k, v, out (R, H, N, dh)
extern "C" int sf_spatial_heads(const void* q, const void* k, const void* v, void* out, int rows,
                                int heads, int n, int dh, int q_per_block, float scale,
                                int dtype, void* stream) {
  return dispatch(q, k, v, out, rows, n, dh, heads, true, q_per_block, scale, dtype, stream);
}
