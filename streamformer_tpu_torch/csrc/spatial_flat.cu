// Non-causal softmax attention over the N patches of each (b, t) row: heads
// as dh-wide slices of D (kernel B), or head-split (kernel L).
//
// Replaces: streamformer_tpu/ops/attention.py fused_spatial_flat, forward
// (_spatial_flat_pallas, kernel body _spatial_flat_kernel), and
// fused_spatial_attention (_spatial_pallas, body _spatial_kernel). Same
// contract: q, k, v, out are (R, N, D) for B and (R, H, N, dh) for L, which
// the kernel reads through three strides (row, head, token); scores are taken
// from input-type values with fp32 accumulation and multiplied by the scale
// in fp32, the softmax runs in fp32 and is exact (two passes over the whole
// score row), and the normalised probabilities are rounded to the input type
// before the PV product, as both TPU kernels do. L's TPU kernel pads N to 128
// for Mosaic's tiles; here N is padded to 16 in shared memory only.
//
// Bound on the H100: bytes at the full-clip shape in bf16. Each (row, head)
// reads q, k, v and writes out, N x dh elements each, for 4 N^2 dh
// operations: about N/2 = 98 operations a byte at N=196, under the ~295 a
// byte where the bf16 tensor cores would become the limit. The products
// therefore belong on the tensor cores, and the design's work is to read
// each byte once and to hide the load latency behind the products.
//
// bf16 body (spatial_flat_tc_kernel), on the tensor cores. One block per
// (row, head, chunk of at most 208 queries: the whole row at N=196), one
// warp per 16-query tile of the chunk, two blocks an SM. Up to 256 keys,
// the head's K and V (N x dh) go to shared memory with cp.async once, rows
// zero-padded to a multiple
// of 16 keys (padded keys must hold zeros: they get probability 0, and
// 0 x NaN from stale memory would be NaN) and dh zero-padded to 16, each row
// then padded to an odd number of 16-byte units so that ldmatrix is free of
// bank conflicts. While the copies fly, each warp loads its Q fragments
// straight from device memory. The softmax is exact and normalised before
// rounding, in two passes over 16-key steps:
//   1. S = Q K^T on mma.sync.m16n8k16 (bf16 operands, fp32 accumulation; K
//      fragments by ldmatrix); each lane keeps a running max and sum of its
//      columns, the quad combines them into the row's max m and 1/sum;
//   2. S again (the same bits), p = exp(scale s - scale m) / sum rounded to
//      bf16 and packed straight into A fragments (the C layout of two
//      neighbouring 8-key tiles is the A layout of a 16-key step), and
//      O += P V on mma.sync with V fragments by ldmatrix.trans.
// The scale multiplies the fp32 scores inside the exponent: with
// c = scale log2(e), exp(scale s - scale m) = 2^(c s - c m), one FFMA and one
// ex2.approx an element. The key steps are rolled loops: a body that kept
// the whole score row in registers, unrolled over the row, measured slower
// on the H100. Computing S twice costs a third more tensor work. A query's
// arithmetic depends on its (row, head) operands only, never on the chunk
// or tile that holds it: B is batch-invariant, and L (B's body on
// head-split strides) is bit-equal to B. A template bounds dh
// (16-wide steps) so that narrow heads hold fewer registers.
//
// Past 256 keys (a 384x384 frame has 576 patches, joint space-time
// attention 1568 at 8 frames) K and V stream through the same shared
// memory in stages of 256 keys: pass 1 stages K stage by stage for the
// statistics, pass 2 stages K and V again for S and PV. Each 16-key step
// computes what it computes with the whole row staged, in the same order,
// so the softmax stays exact and two-pass (no rescaled output), and a
// query's bits do not depend on the staging either. The wrapper then splits
// a row's queries over more blocks when R x H x chunks would leave the SMs
// idle (one frame of joint attention: 12 (row, head) pairs).
//
// fp32 body (spatial_flat_kernel), on the CUDA cores: TF32 could not hold
// the 2e-5 fp32 gate, so fp32 keeps exact FMAs. One block per (row, head,
// query chunk): the head's K and V slices (N x dh) are staged in shared
// memory with rows padded to an odd number of 16-byte units, so that eight
// lanes reading eight rows hit distinct banks. Each warp takes four queries
// at a time, so every K/V element read from shared memory feeds four FMAs.
// QK^T: lane j holds the scores of keys j, j+32, ... (N <= 256),
// accumulated over dh in chunks of eight. PV: lanes split into dh/8 chunks
// of the output times a power-of-two number of key groups, reduced with
// shuffles at the end. The wrapper splits the queries of a row into chunks
// only when R*H blocks alone would leave SMs idle (the streaming step).
// Past 256 keys, or past a block's shared memory (heads of 128 past 200
// keys), fp32 runs tiled.cuh: both sides tiled, exact softmax, C's order of
// arithmetic. The wrapper chooses, as for C, H and I: the smem entry
// returns 0 where only tiled.cuh takes the shape, and the launch entry
// takes `tiled`.
#include "common.cuh"
#include "tiled.cuh"

namespace {

// ---- fp32 body on the CUDA cores

using T = float;
constexpr int kWarps = 4;   // warps per block
constexpr int kQ = 4;       // queries a warp takes at a time
constexpr int kMaxKpl = 8;  // keys per lane in QK^T: N <= 256

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

    // fp32 softmax per query
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
      for (int j = 0; j < kMaxKpl; ++j) p[qi][j] = p[qi][j] * inv;
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
int launch(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
           int heads, bool head_split, int q_per_block, float scale, cudaStream_t stream) {
  const long d = static_cast<long>(heads) * dh;
  const long row_elems = n * d;
  const long head_elems = head_split ? static_cast<long>(n) * dh : dh;
  const int tok_elems = head_split ? dh : static_cast<int>(d);
  const int elem = static_cast<int>(sizeof(T));
  const int stride = row_stride(dh, elem);
  const int smem = smem_bytes(n, dh, elem);
  cudaError_t err = cudaFuncSetAttribute(spatial_flat_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows) * heads, (n + q_per_block - 1) / q_per_block);
  spatial_flat_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, dh, heads, row_elems, head_elems, tok_elems, q_per_block, stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 body on the tensor cores

using bf16 = __nv_bfloat16;

// Most warps a block has: 208 queries, a whole row of the flagship (N=196)
// in one block, so that K and V are staged once per (row, head). Two such
// blocks fit an SM (at most 78 registers a thread, for dh <= 64).
constexpr int kTcMaxWarps = 13;

// DT: most 16-wide dh steps (dh <= 16 DT); the runtime count ndt is at most
// DT. The key steps are a rolled loop, so the body stays small.
// Keys a stage holds: the whole row up to 256 (one staging), else stages
// of 256.
constexpr int kTcStageKeys = 256;

// kStaged: the keys in stages (npad past kTcStageKeys), a template parameter
// so that the one-staging kernel compiles to the code it had before stages
// existed (a runtime branch cost it 3 % on the H100: tools/decode_timing.py).
template <int DT, bool kStaged>
__global__ void __launch_bounds__(kTcMaxWarps * 32, DT <= 4 ? 2 : 1)
spatial_flat_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int n, int dh,
                       int heads, long row_elems, long head_elems, int tok, int q_per_block,
                       int chunks, int stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkt = (n + 15) / 16, ndt = (dh + 15) / 16;
  const int npad = nkt * 16;
  const int rows = kStaged ? kTcStageKeys : npad;  // staged keys
  bf16* ks = reinterpret_cast<bf16*>(smem);  // rows x stride
  bf16* vs = ks + rows * stride;             // rows x stride

  const int rh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const long base = static_cast<long>(rh / heads) * row_elems + (rh % heads) * head_elems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const float c2 = scale * kLog2e;

  if constexpr (!kStaged) stage2_tc(ks, vs, k, v, base, tok, n, npad, dh, stride);
  const int q_begin = chunk * q_per_block;
  const int q_end = min(n, q_begin + q_per_block);
  int q0 = q_begin + warp * 16;
  unsigned qa[DT][4];
  load_frags<DT>(qa, q, base, tok, q0, n, dh, lane);  // overlaps the staging copies
  if constexpr (kStaged) {
    // K and V in stages: every warp takes one 16-query tile (q_per_block is
    // warps x 16) and joins every stage, with queries or not
    const bool on = q0 < q_end;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < npad; k0 += rows) {
      const int nr = min(rows, npad - k0);
      __syncthreads();  // the stage's readers are done
      stage1_tc(ks, k, base + static_cast<long>(k0) * tok, tok, n - k0, nr, dh, stride);
      cp_async_wait_all();
      __syncthreads();
      if (on) {
#pragma unroll 2
        for (int t = 0; t < nr / 16; ++t) {
          float s[2][4];
          scores16<DT>(s, qa, ks, t, n - k0, ndt, stride, lane);
          stats_step(mx, sum, s, c2);
        }
      }
    }
    float mc[2], inv[2];
    stats_finish(mc, inv, mx, sum, c2);
    float o[2 * DT][4];
    zero_tiles<DT>(o);
    for (int k0 = 0; k0 < npad; k0 += rows) {
      const int nr = min(rows, npad - k0);
      __syncthreads();
      stage2_tc(ks, vs, k, v, base + static_cast<long>(k0) * tok, tok, n - k0, nr, dh, stride);
      cp_async_wait_all();
      __syncthreads();
      if (on) {
        for (int t = 0; t < nr / 16; ++t) {
          float s[2][4], p[2][4];
          scores16<DT>(s, qa, ks, t, n - k0, ndt, stride, lane);
          probs16(p, s, mc, inv, c2);
          unsigned w[4];
          pack_frag(w, p);
          weights_times_cols<DT>(o, w, vs, t, ndt, stride, lane);
        }
      }
    }
    if (on) store_tiles<DT>(out, o, base, tok, q0, q_end, dh, ndt, lane);
    return;
  }
  cp_async_wait_all();
  __syncthreads();

  for (; q0 < q_end; q0 += warps * 16) {
    // pass 1: the exact row max and sum over all n keys
    float mc[2], inv[2];
    softmax_stats<DT>(mc, inv, qa, ks, n, ndt, stride, c2, lane);
    // pass 2: O = P V, P normalised and rounded to bf16 in the A fragments
    float o[2 * DT][4];
    zero_tiles<DT>(o);
    for (int t = 0; t < nkt; ++t) {
      float s[2][4], p[2][4];
      scores16<DT>(s, qa, ks, t, n, ndt, stride, lane);
      probs16(p, s, mc, inv, c2);
      unsigned w[4];
      pack_frag(w, p);
      weights_times_cols<DT>(o, w, vs, t, ndt, stride, lane);
    }
    if (q0 + warps * 16 < q_end) load_frags<DT>(qa, q, base, tok, q0 + warps * 16, n, dh, lane);
    store_tiles<DT>(out, o, base, tok, q0, q_end, dh, ndt, lane);
  }
}

// K and V, 16 * ceil(n / 16) rows each, at most a stage's.
inline int tc_smem_bytes(int n, int dh) {
  return 2 * min((n + 15) / 16 * 16, kTcStageKeys) * tc_row_stride(dh) * 2;
}

template <int DT>
int launch_tc_body(const void* q, const void* k, const void* v, void* out, int rows, int n,
                   int dh, int heads, long row_elems, long head_elems, int tok, int q_per_block,
                   float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes(n, dh);
  const auto kernel = (n + 15) / 16 * 16 > kTcStageKeys ? spatial_flat_tc_kernel<DT, true>
                                                       : spatial_flat_tc_kernel<DT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n + q_per_block - 1) / q_per_block;
  const dim3 grid(static_cast<unsigned>(rows) * heads * chunks);
  // one warp for each 16-query tile of a chunk
  kernel<<<grid, q_per_block / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), n, dh, heads, row_elems, head_elems, tok, q_per_block, chunks,
      tc_row_stride(dh), scale);
  return static_cast<int>(cudaGetLastError());
}

// head_split: q, k, v, out are (R, H, N, dh), else (R, N, H*dh). The query
// chunk is rounded up to whole 16-query tiles, at most kTcMaxWarps of them.
int launch_tc(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
              int heads, bool head_split, int q_per_block, float scale, cudaStream_t stream) {
  if (n < 1 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  const long d = static_cast<long>(heads) * dh;
  const long row_elems = n * d;
  const long head_elems = head_split ? static_cast<long>(n) * dh : dh;
  const int tok = head_split ? dh : static_cast<int>(d);
  const int qpb = min((q_per_block + 15) / 16, kTcMaxWarps) * 16;
  if (dh <= 32)
    return launch_tc_body<2>(q, k, v, out, rows, n, dh, heads, row_elems, head_elems, tok, qpb,
                             scale, stream);
  if (dh <= 64)
    return launch_tc_body<4>(q, k, v, out, rows, n, dh, heads, row_elems, head_elems, tok, qpb,
                             scale, stream);
  return launch_tc_body<8>(q, k, v, out, rows, n, dh, heads, row_elems, head_elems, tok, qpb,
                           scale, stream);
}

// Whether the per-lane fp32 body takes n keys: kMaxKpl keys a lane, and
// the head's K and V within a block's shared memory.
inline bool fp32_fits(int n, int dh) {
  return n <= 32 * kMaxKpl && smem_bytes(n, dh, 4) <= fullclip::kMaxSmem;
}

// tiled.cuh's forward: B's rows are (R, N, D) with heads as column slices,
// L's (R, H, N, dh) as R * H rows of one head.
int launch_tiled(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
                 int heads, bool head_split, float scale, int qt, float* scratch,
                 long long floats, cudaStream_t stream) {
  const long long d = static_cast<long long>(heads) * dh;
  const long long row = head_split ? static_cast<long long>(n) * dh : n * d;
  const long long tok = head_split ? dh : d;
  tiled::Args a{};
  a.q = {const_cast<void*>(q), row, tok, 0};
  a.k = {const_cast<void*>(k), row, tok, 0};
  a.v = {const_cast<void*>(v), row, tok, 0};
  a.o0 = {out, row, tok, 0};
  a.n = 1;
  a.len = n;
  a.dh = dh;
  a.heads = head_split ? 1 : heads;
  a.causal = 0;
  a.scale = scale;
  return tiled::forward<T>(head_split ? rows * heads : rows, a, qt, scratch, floats, stream);
}

int dispatch(const void* q, const void* k, const void* v, void* out, int rows, int n, int dh,
             int heads, bool head_split, int q_per_block, float scale, int tiled, void* scratch,
             long long floats, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_BFLOAT16 && !tiled)
    return launch_tc(q, k, v, out, rows, n, dh, heads, head_split, q_per_block, scale, st);
  if (dtype == SF_FLOAT32 && tiled)
    return launch_tiled(q, k, v, out, rows, n, dh, heads, head_split, scale,
                        tiled < 0 ? 0 : tiled, static_cast<float*>(scratch), floats, st);
  if (dtype == SF_FLOAT32 && fp32_fits(n, dh))
    return launch(q, k, v, out, rows, n, dh, heads, head_split, q_per_block, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory a block of the whole-head body needs (bf16: any n); 0 where
// only tiled.cuh takes the shape (fp32 past fp32_fits), and the wrapper
// then passes tiled = 1.
extern "C" int sf_spatial_flat_smem_bytes(int n, int d, int heads, int dtype) {
  const int dh = d / heads;
  if (dtype == SF_BFLOAT16) return tc_smem_bytes(n, dh);
  return fp32_fits(n, dh) ? smem_bytes(n, dh, 4) : 0;
}

// B: q, k, v, out (R, N, D). tiled: 0 runs the whole-head body, else
// tiled.cuh (fp32 only): 64, 32 or 16 its resident body at that many
// queries a block, -1 its split body on `scratch`, `floats` fp32
// (ops._tiled_scratch's size; null otherwise).
extern "C" int sf_spatial_flat(const void* q, const void* k, const void* v, void* out, int rows,
                               int n, int d, int heads, int q_per_block, float scale, int tiled,
                               void* scratch, long long floats, int dtype, void* stream) {
  return dispatch(q, k, v, out, rows, n, d / heads, heads, false, q_per_block, scale, tiled,
                  scratch, floats, dtype, stream);
}

// L: q, k, v, out (R, H, N, dh); tiled as for B.
extern "C" int sf_spatial_heads(const void* q, const void* k, const void* v, void* out, int rows,
                                int heads, int n, int dh, int q_per_block, float scale,
                                int tiled, void* scratch, long long floats, int dtype,
                                void* stream) {
  return dispatch(q, k, v, out, rows, n, dh, heads, true, q_per_block, scale, tiled, scratch,
                  floats, dtype, stream);
}
