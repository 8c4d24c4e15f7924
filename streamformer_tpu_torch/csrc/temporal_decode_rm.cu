// Read-only t=1 causal temporal attention against the row-major KV cache,
// float or int8 (kernel K).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_decode (bodies
// _decode_kernel with scales and _decode_kernel_noscale without). Same
// contract: q is (R, D) float or bf16 with heads as dh-wide slices of D; the
// caches k, v are row-major (R, C, D) and already hold the new frame at
// position len (the caller wrote it); len is one device int32. Each
// (row, head) attends positions 0..min(len, C-1), the new frame's among
// them, and nothing is written: the float mode is the JAX package's test
// oracle for the in-place kernel J, and the int8 mode serves the row-major
// int8 cache, whose new codes and scales the caller quantizes and writes
// first. The int8 cache keeps one fp32 scale per (row, position, head),
// (R, C, H), and dequantization is folded after the reductions, as the TPU
// kernel folds it: the score of key i is ((q . codes_i) * dh^-0.5) *
// k_scale_i, its value weight p_i * v_scale_i, and the softmax's sum runs
// over the unscaled p_i. Keys are taken in position order; the arithmetic
// is kernel A's otherwise (one sequential fp32 FMA chain per score, max,
// exp, a sequential sum in key order, PV as a sequential FMA chain, one
// multiply by the reciprocal of the sum).
//
// Bound on the H100: bytes. Each (row, head) does 4*dh operations per
// position on 2*dh bytes of int8 codes plus two scales (4*dh bytes in
// bf16), one or two operations per byte, far below where the tensor cores
// would be the limit. In the row-major layout a row's positions 0..len of
// K (or V) are one contiguous span of (len + 1) D elements, and its scales
// one span of (len + 1) H floats. The design is decode_row.cuh's read-only
// mode: a persistent grid, a block owning one row across all heads at a
// time; a producer warp bulk-copies the row's query, then its K positions
// and then its V positions, a chunk of positions one copy, with each
// chunk's (positions, H) scales, into two stages on mbarriers, refilling a
// stage as soon as the eight consumer warps hand it back; the consumers
// compute a thread per (head, key) for the scores (each chain starting at a
// load of its own, for the banks) and a thread per (head, 8 elements) for
// PV. Reads stop at the valid prefix, with len read on the device. Every
// input byte is read once. Past the (heads, C) scores a block holds in
// shared memory the wrapper passes a scratch for them (decode_row.cuh's
// scratch mode), so any capacity runs.
#include "decode_row.cuh"

namespace {

// T: the type of q and the output; KV: the cache's (T, or int8_t with scales)
template <typename T, typename KV>
__global__ void __launch_bounds__(decode::kThreads)
temporal_decode_rm_kernel(const decode::Args<T, KV> a) {
  decode::decode_rows<T, KV, true>(a);
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* len, void* out, int rows, int capacity, int d, int heads, float scale,
           float* scratch, long long floats, cudaStream_t stream, int* blocks_only = nullptr) {
  constexpr bool kQuant = sizeof(KV) == 1;
  decode::Args<T, KV> a{static_cast<const T*>(q), nullptr, nullptr, nullptr, nullptr,
                        const_cast<KV*>(static_cast<const KV*>(k)),
                        const_cast<KV*>(static_cast<const KV*>(v)),
                        const_cast<float*>(static_cast<const float*>(k_scale)),
                        const_cast<float*>(static_cast<const float*>(v_scale)),
                        static_cast<const int*>(len), rows, static_cast<T*>(out),
                        rows, capacity, d, heads, d, static_cast<long>(capacity) * d, scale,
                        scratch};
  const decode::Plan plan = decode::plan(d, heads, capacity, sizeof(KV), sizeof(T), kQuant,
                                         heads, true, scratch || blocks_only);
  int blocks = 0;
  const cudaError_t err = decode::grid(temporal_decode_rm_kernel<T, KV>, plan, rows, heads,
                                       capacity, scratch, floats, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_only) return *blocks_only = blocks, 0;
  temporal_decode_rm_kernel<T, KV><<<blocks, decode::kThreads, plan.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block needs at width d, heads and capacity, for q's dtype
// and an int8 (quantized 1) or float cache, with the scores in shared
// memory (past a block's: a scratch of heads x score_stride(C) floats a
// block, passed as `scratch`, `floats`).
extern "C" int sf_temporal_decode_rm_readonly_smem_bytes(int d, int heads, int capacity,
                                                         int dtype, int quantized) {
  const int elt = dtype == SF_FLOAT32 ? 4 : 2;
  return decode::plan(d, heads, capacity, quantized ? 1 : elt, elt, quantized != 0, heads, true)
      .total;
}

// The blocks of the scratch mode's persistent grid over `rows` rows (the
// wrapper allocates a slice of the scratch for each), or minus a CUDA error.
extern "C" int sf_temporal_decode_rm_readonly_scratch_blocks(int d, int heads, int capacity,
                                                             int dtype, int quantized, int rows) {
  int blocks = 0, rc = static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == SF_FLOAT32;
  if (f32 || dtype == SF_BFLOAT16) {
#define SF_BLOCKS(T, KV)                                                                  \
  launch<T, KV>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows, capacity, \
                d, heads, 0.f, nullptr, 0, nullptr, &blocks)
    rc = f32 ? (quantized ? SF_BLOCKS(float, int8_t) : SF_BLOCKS(float, float))
             : (quantized ? SF_BLOCKS(__nv_bfloat16, int8_t)
                          : SF_BLOCKS(__nv_bfloat16, __nv_bfloat16));
#undef SF_BLOCKS
  }
  return rc ? -rc : blocks;
}

// K: k, v (R, C, D) int8 with (R, C, H) fp32 scales when quantized is 1, else
// in q's type with null scales; len a single device int32
extern "C" int sf_temporal_decode_rm_readonly(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* len, void* out, int rows, int capacity,
                                              int d, int heads, float scale, void* scratch,
                                              long long floats, int dtype, int quantized,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (dtype == SF_BFLOAT16) {
    return quantized
        ? launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d,
                                        heads, scale, sp, floats, st)
        : launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_scale, v_scale, len, out, rows,
                                               capacity, d, heads, scale, sp, floats, st);
  }
  if (dtype == SF_FLOAT32) {
    return quantized
        ? launch<float, int8_t>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d, heads,
                                scale, sp, floats, st)
        : launch<float, float>(q, k, v, k_scale, v_scale, len, out, rows, capacity, d, heads,
                               scale, sp, floats, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
