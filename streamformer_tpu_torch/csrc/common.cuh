// Helpers shared by the port's attention kernels: fp32 <-> storage-type
// conversion, 2- and 8-element vector loads and stores, warp reductions;
// bulk asynchronous copies on mbarriers and the size of a persistent grid
// (the decode bodies, and C and H); and the
// tensor-core pieces of the bf16 spatial bodies (B, L and I): staging,
// ldmatrix, mma.sync and the softmax over 16-key steps.
//
// Every kernel computes in fp32 and stores in its input type: float or
// __nv_bfloat16. The C entry points take a dtype code (SF_FLOAT32,
// SF_BFLOAT16, as ops/attention.py passes it) and return cudaGetLastError()
// right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

enum { SF_FLOAT32 = 0, SF_BFLOAT16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// ---- Tensor-core helpers (bf16 bodies): cp.async staging, ldmatrix, and
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulation. Fragment
// layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4
// and c = lane % 4:
//   A 16x16, four b32 registers: (g, 2c..2c+1), (g+8, 2c..), (g, 8+2c..),
//     (g+8, 8+2c..);
//   B 16x8 (k x n), two registers: (k = 2c..2c+1, n = g), (k = 8+2c.., n = g);
//   C 16x8 fp32, four values: (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1).
// Two neighbouring C tiles (columns 0-7 and 8-15) are thus, packed in pairs,
// the A fragment of a product over those 16 columns.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; completes at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- Bulk asynchronous copies (decode_row.cuh, fullclip.cuh): one
// thread asks the copy engine for a contiguous run of bytes, global ->
// shared (cp.async.bulk; 16-byte aligned addresses, a size that is a
// multiple of 16), which completes on an mbarrier in shared memory. The
// barrier's phase ends when its arrivals have happened (arrive.expect_tx,
// which also announces the bytes to come, and any cp.async arrivals) and
// all those bytes have landed; the consumers wait on the phase's parity.

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}
// After every mbar_init, before the barriers are used by any thread or copy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes global -> shared; cp_async_arrive_noinc makes the barrier count
// one arrival once this thread's earlier cp.async copies have landed (the
// barrier's arrival count includes it).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive_noinc(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Blocks of a persistent grid: as many as fit on the card at `smem` bytes
// of dynamic shared memory, at most `items`. The kernel's shared-memory
// attributes are set, and its occupancy is asked, once per (kernel, device,
// shared-memory bytes); every later launch finds the grid in a table, so a
// launch makes one runtime call besides itself (cudaGetDevice).
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, int smem, int items, int* blocks) {
  struct Seen {
    Kernel kernel;
    int device, smem, blocks;
  };
  static std::mutex mutex;
  static std::vector<Seen> seen;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  int most = smem;  // the attribute only grows: it bounds every size seen
  for (const Seen& s : seen) {
    if (s.kernel != kernel || s.device != device) continue;
    if (s.smem == smem) {
      *blocks = items < s.blocks ? items : s.blocks;
      return cudaSuccess;
    }
    most = s.smem > most ? s.smem : most;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  seen.push_back({kernel, device, smem, sms * per_sm});
  *blocks = items < sms * per_sm ? items : sms * per_sm;
  return cudaSuccess;
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16x16 (A fragment), b 16x8 (b0, b1), c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even) and packed, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Reductions over the four lanes of a quad (the lanes holding one C row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Staged bf16 operand rows for ldmatrix: dh padded with zeros to a multiple
// of 16, then to an odd number of 16-byte units, so that the eight rows of
// an 8x8 matrix fall in eight distinct bank groups.
inline int tc_row_stride(int dh) { return ((((dh + 15) / 16 * 16) * 2 / 16) | 1) * 8; }

// Stage rows [0, npad) of the (n x dh) head slices of a and b (rows `tok`
// elements apart from `base`) into as and bs, `stride` elements a row, with
// cp.async by the whole block. Rows past n and columns past dh (up to
// dh rounded to 16) are zeros: nothing past the operands is read. The caller
// waits (cp_async_wait_all, __syncthreads) before reading.
__device__ __forceinline__ void stage2_tc(__nv_bfloat16* as, __nv_bfloat16* bs,
                                          const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ b, long base,
                                          int tok, int n, int npad, int dh, int stride) {
  const int nc = (dh + 15) / 16 * 2;  // 16-byte units a staged row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < npad * nc; i += blockDim.x) {
    const int r = i / nc, c = i % nc;
    __nv_bfloat16* ad = as + r * stride + c * 8;
    __nv_bfloat16* bd = bs + r * stride + c * 8;
    if (r < n && c * 8 < dh) {
      const long src = base + static_cast<long>(r) * tok + c * 8;
      cp_async16(ad, a + src);
      cp_async16(bd, b + src);
    } else {
      *reinterpret_cast<uint4*>(ad) = zero;
      *reinterpret_cast<uint4*>(bd) = zero;
    }
  }
  cp_async_commit();
}

// stage2_tc for one operand: rows [0, npad) of a's head slice into as.
__device__ __forceinline__ void stage1_tc(__nv_bfloat16* as, const __nv_bfloat16* __restrict__ a,
                                          long base, int tok, int n, int npad, int dh,
                                          int stride) {
  const int nc = (dh + 15) / 16 * 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < npad * nc; i += blockDim.x) {
    const int r = i / nc, c = i % nc;
    __nv_bfloat16* ad = as + r * stride + c * 8;
    if (r < n && c * 8 < dh)
      cp_async16(ad, a + base + static_cast<long>(r) * tok + c * 8);
    else
      *reinterpret_cast<uint4*>(ad) = zero;
  }
  cp_async_commit();
}

// A fragments of rows [r0, r0 + 16) of a head slice, straight from device
// memory (zeros past n and past dh): a[kk] is the fragment of dh step kk.
template <int DT>
__device__ __forceinline__ void load_frags(unsigned (&a)[DT][4],
                                           const __nv_bfloat16* __restrict__ x, long base, int tok,
                                           int r0, int n, int dh, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i & 1) * 8, e = kk * 16 + 2 * c + (i >> 1) * 8;
      a[kk][i] = r < n && e < dh
                     ? *reinterpret_cast<const unsigned*>(x + base + static_cast<long>(r) * tok + e)
                     : 0u;
    }
  }
}

// acc (16 x 16: two 8-column C tiles) = A X[16 t, 16 t + 16)^T, A given as
// fragments over ndt dh steps, X staged (rows `stride` elements apart).
template <int DT>
__device__ __forceinline__ void frags_times_rows(float (&acc)[2][4], const unsigned (&a)[DT][4],
                                                 const __nv_bfloat16* xs, int t, int ndt,
                                                 int stride, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk < ndt) {
      unsigned b[4];  // rows 0-7 of the step (b0, b1), rows 8-15 (b2, b3)
      ldsm_x4(b, xs + (t * 16 + (mi >> 1) * 8 + (lane & 7)) * stride + kk * 16 + (mi & 1) * 8);
      mma_bf16(acc[0], a[kk], b[0], b[1]);
      mma_bf16(acc[1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x dh) += W X[16 t, 16 t + 16), W a 16x16 A fragment, X staged.
template <int DT>
__device__ __forceinline__ void weights_times_cols(float (&acc)[2 * DT][4], const unsigned (&w)[4],
                                                   const __nv_bfloat16* xs, int t, int ndt,
                                                   int stride, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int dd = 0; dd < DT; ++dd) {
    if (dd < ndt) {
      unsigned b[4];  // dh 0-7 of the step (b0, b1), dh 8-15 (b2, b3)
      ldsm_x4_trans(b,
                    xs + (t * 16 + (mi & 1) * 8 + (lane & 7)) * stride + dd * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * dd], w, b[0], b[1]);
      mma_bf16(acc[2 * dd + 1], w, b[2], b[3]);
    }
  }
}

// A 16 x dh accumulator (2 DT C tiles) set to zero.
template <int DT>
__device__ __forceinline__ void zero_tiles(float (&acc)[2 * DT][4]) {
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Rows r0 + g and r0 + g + 8 (those below `limit`) of a 16 x dh accumulator
// to out in bf16, rows `tok` elements apart from `base`.
template <int DT>
__device__ __forceinline__ void store_tiles(__nv_bfloat16* __restrict__ out,
                                            const float (&acc)[2 * DT][4], long base, int tok,
                                            int r0, int limit, int dh, int ndt, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j) {
    const int e = j * 8 + 2 * c;
    if (j < 2 * ndt && e < dh) {
      if (r0 + g < limit)
        *reinterpret_cast<unsigned*>(out + base + static_cast<long>(r0 + g) * tok + e) =
            pack_bf16(acc[j][0], acc[j][1]);
      if (r0 + g + 8 < limit)
        *reinterpret_cast<unsigned*>(out + base + static_cast<long>(r0 + g + 8) * tok + e) =
            pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

// The A fragment of a 16x16 product operand from two C tiles (columns 0-7,
// 8-15), rounded to bf16.
__device__ __forceinline__ void pack_frag(unsigned (&w)[4], const float (&x)[2][4]) {
  w[0] = pack_bf16(x[0][0], x[0][1]);
  w[1] = pack_bf16(x[0][2], x[0][3]);
  w[2] = pack_bf16(x[1][0], x[1][1]);
  w[3] = pack_bf16(x[1][2], x[1][3]);
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp, subnormals to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Scores of a 16-query tile against keys [16 t, 16 t + 16): fp32 products
// of bf16 operands, keys at or past n set to -inf (only the last step has
// any). The scale is applied with the exponent: with c = scale * log2(e),
// exp(scale s - scale m) = 2^(c s - c m), one FFMA and one ex2 an element.
template <int DT>
__device__ __forceinline__ void scores16(float (&s)[2][4], const unsigned (&qa)[DT][4],
                                         const __nv_bfloat16* ks, int t, int n, int ndt,
                                         int stride, int lane) {
  frags_times_rows<DT>(s, qa, ks, t, ndt, stride, lane);
  if ((t + 1) * 16 > n) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t * 16 + h * 8 + 2 * (lane & 3) + (e & 1) >= n) s[h][e] = -INFINITY;
  }
}

// The softmax statistics of a 16-query tile's rows g (values 0, 1 of each C
// tile) and g + 8 (values 2, 3) over the n keys, in one pass over 16-key
// steps: mc = -c m, with m the row's largest score, and inv = 1 / sum of
// 2^(c s + mc). Each lane keeps a running max and sum of its own columns,
// rescaled when its max grows (stats_step, one 16-key step); the quad then
// combines them (stats_finish). A body that streams its keys through shared
// memory in stages calls the two itself, in the same order.
__device__ __forceinline__ void stats_step(float (&mx)[2], float (&sum)[2], const float (&s)[2][4],
                                           float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(mx[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                        fmaxf(s[1][2 * r], s[1][2 * r + 1])));
    const float b = mn == -INFINITY ? 0.f : -mn * c;  // no key of this lane yet: 0
    sum[r] = sum[r] * ex2(fmaf(mx[r], c, b)) + ex2(fmaf(s[0][2 * r], c, b)) +
             ex2(fmaf(s[0][2 * r + 1], c, b)) + ex2(fmaf(s[1][2 * r], c, b)) +
             ex2(fmaf(s[1][2 * r + 1], c, b));
    mx[r] = mn;
  }
}

__device__ __forceinline__ void stats_finish(float (&mc)[2], float (&inv)[2],
                                             const float (&mx)[2], const float (&sum)[2],
                                             float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = -quad_max(mx[r]) * c;
    inv[r] = __fdiv_rn(1.f, quad_sum(sum[r] * ex2(fmaf(mx[r], c, mc[r]))));
  }
}

template <int DT>
__device__ __forceinline__ void softmax_stats(float (&mc)[2], float (&inv)[2],
                                              const unsigned (&qa)[DT][4],
                                              const __nv_bfloat16* ks, int n, int ndt, int stride,
                                              float c, int lane) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  const int nkt = (n + 15) / 16;
#pragma unroll 2
  for (int t = 0; t < nkt; ++t) {
    float s[2][4];
    scores16<DT>(s, qa, ks, t, n, ndt, stride, lane);
    stats_step(mx, sum, s, c);
  }
  stats_finish(mc, inv, mx, sum, c);
}

// Normalised probabilities from the statistics: 2^(c s + mc) inv, fp32.
__device__ __forceinline__ void probs16(float (&p)[2][4], const float (&s)[2][4],
                                        const float (&mc)[2], const float (&inv)[2], float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[h][e] = ex2(fmaf(s[h][e], c, mc[e >> 1])) * inv[e >> 1];
}
