// t=1 causal temporal attention against the KV cache, with the new frame's
// K/V appended in place: on the position-major cache one stream (kernel A)
// or a batch of streams, each at its own position (kernel D, continuous
// batching); on the row-major cache one stream (kernel J).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_decode_pm (A)
// and fused_temporal_decode_pm_ragged (D), which share the kernel body
// _pm_decode_kernel, and fused_temporal_decode_inplace (J, body
// _decode_write_kernel). Same contract: q, k_new, v_new are (R, D) with heads
// as dh-wide slices of D; the caches are (C, R, D) for A and D, (R, C, D)
// for J, which the kernel reads through two strides (slot and row); lens
// (device int32) holds the position the new frame takes, one per stream, and
// row r belongs to stream r / rows_per_stream (A and J: one stream of all R
// rows). The new frame attends the last min(len, C-1) positions held in the
// cache and itself; slot len % C (the position the new frame evicts: none
// for the linear cache, the oldest for the ring's sliding window) is not
// read, and the new frame's K/V are written there afterwards. J's contract is
// the linear cache (len < C), so it attends positions < len and writes at
// len, as the TPU kernel does; the TPU kernel's 8-row write-back window and
// its capacity % 8 gate are Mosaic tiling and have no counterpart here. The
// TPU kernels pad each stream's rows to a multiple of 8 so that a row block
// never spans two streams; here each block looks up its own row's length,
// so rows are not padded.
//
// q and the output are in the compute type, k_new, v_new and the caches in
// the cache's (float or bfloat16 either way: a cache in another type than
// the compute type, the new frame rounded to it by the caller as the JAX
// package rounds it, `kn.astype(cache dtype)`); the arithmetic is fp32.
//
// Keys are taken in position order, oldest first and the new frame last,
// with the arithmetic of temporal_fullclip.cu step for step (decode_row.cuh
// states it), so on the linear cache a streamed frame's attention output
// equals, bit for bit, the full clip's output for that frame; D is the same
// body with a length per stream, and J the same body on row-major strides,
// so a ragged row equals a lone stream and a row-major stream equals the
// pos-major one.
//
// Design (decode_row.cuh): a persistent grid, each block walking rows, one
// row across all heads at a time; a producer warp stages the query's row and
// the row's valid prefix of K, then of V (each slot one contiguous run: a
// slot of a pos-major plane, or a position of a row-major row), into two
// shared-memory stages by bulk asynchronous copies, refilling each as soon
// as the eight consumer warps hand it back. bf16 and fp32 share the body; a
// stage holds 12 flagship slots in bf16, 6 in fp32. The (heads, C) fp32
// scores of a row stay in shared memory while they fit
// (sf_temporal_decode_pm_smem_bytes); past that, any capacity, in a scratch
// the wrapper passes (decode_row.cuh's scratch mode, the same bits).
#include "decode_row.cuh"

namespace {

template <typename T, typename KV>
__global__ void __launch_bounds__(decode::kThreads)
temporal_decode_pm_kernel(const decode::Args<T, KV> a) {
  decode::decode_rows<T, KV>(a);
}

template <typename T, typename KV>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
           int heads, long slot_stride, long row_stride, float scale, float* scratch,
           long long floats, cudaStream_t stream, int* blocks_only) {
  decode::Args<T, KV> a{static_cast<const T*>(q), static_cast<const KV*>(k_new),
                        static_cast<const KV*>(v_new), nullptr, nullptr,
                        static_cast<KV*>(k_cache), static_cast<KV*>(v_cache), nullptr, nullptr,
                        static_cast<const int*>(lens), rows_per_stream, static_cast<T*>(out),
                        rows, capacity, d, heads, slot_stride, row_stride, scale, scratch};
  const decode::Plan plan = decode::plan(d, heads, capacity, sizeof(KV), sizeof(T), false, 1,
                                         false, scratch || blocks_only);
  int blocks = 0;
  const cudaError_t err = decode::grid(temporal_decode_pm_kernel<T, KV>, plan, rows, heads,
                                       capacity, scratch, floats, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_only) return *blocks_only = blocks, 0;
  temporal_decode_pm_kernel<T, KV><<<blocks, decode::kThreads, plan.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int elt(int dtype) { return dtype == SF_FLOAT32 ? 4 : 2; }

// row_major: the caches are (R, C, D), else (C, R, D). q and out of dtype,
// k_new, v_new and the caches of kv_dtype. scratch: null while the scores
// fit a block, else `floats` fp32 for the scratch mode. blocks_only: set it
// to the scratch mode's persistent grid and launch nothing.
int dispatch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
             const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
             int heads, bool row_major, float scale, void* scratch, long long floats, int dtype,
             int kv_dtype, void* stream, int* blocks_only = nullptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long slot_stride = row_major ? d : static_cast<long>(rows) * d;
  const long row_stride = row_major ? static_cast<long>(capacity) * d : d;
#define SF_DECODE(T, KV)                                                                      \
  return launch<T, KV>(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream, out, rows,   \
                       capacity, d, heads, slot_stride, row_stride, scale,                \
                       static_cast<float*>(scratch), floats, st, blocks_only)
  const bool q16 = dtype == SF_BFLOAT16, kv16 = kv_dtype == SF_BFLOAT16;
  if ((!q16 && dtype != SF_FLOAT32) || (!kv16 && kv_dtype != SF_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q16 && kv16) SF_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q16) SF_DECODE(__nv_bfloat16, float);
  if (kv16) SF_DECODE(float, __nv_bfloat16);
  SF_DECODE(float, float);
#undef SF_DECODE
}

}  // namespace

// Shared memory a block needs at width d, heads and capacity, for queries
// of dtype and a cache of kv_dtype (the same on the row-major and the
// pos-major cache), with the scores in shared memory; past a block's the
// wrapper passes a scratch of heads x score_stride(C) floats a block.
extern "C" int sf_temporal_decode_pm_smem_bytes(int d, int heads, int capacity, int dtype,
                                                int kv_dtype) {
  return decode::plan(d, heads, capacity, elt(kv_dtype), elt(dtype), false).total;
}

// The blocks of the scratch mode's persistent grid over `rows` rows (the
// wrapper allocates a slice of the scratch for each), or minus a CUDA error.
extern "C" int sf_temporal_decode_pm_scratch_blocks(int d, int heads, int capacity, int dtype,
                                                    int kv_dtype, int rows) {
  int blocks = 0;
  const int rc = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows, nullptr,
                          rows, capacity, d, heads, false, 0.f, nullptr, 0, dtype, kv_dtype,
                          nullptr, &blocks);
  return rc ? -rc : blocks;
}

// A: one stream, len a single device int32
extern "C" int sf_temporal_decode_pm(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* len, void* out,
                                     int rows, int capacity, int d, int heads, float scale,
                                     void* scratch, long long floats, int dtype, int kv_dtype,
                                     void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, len, rows, out, rows, capacity, d, heads,
                  false, scale, scratch, floats, dtype, kv_dtype, stream);
}

// D: rows / rows_per_stream streams, lens a device int32 vector of that length
extern "C" int sf_temporal_decode_pm_ragged(const void* q, const void* k_new, const void* v_new,
                                            void* k_cache, void* v_cache, const void* lens,
                                            int rows_per_stream, void* out, int rows,
                                            int capacity, int d, int heads, float scale,
                                            void* scratch, long long floats, int dtype,
                                            int kv_dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream, out, rows, capacity,
                  d, heads, false, scale, scratch, floats, dtype, kv_dtype, stream);
}

// J: one stream on the row-major (R, C, D) caches, len a single device int32
extern "C" int sf_temporal_decode_rm(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* len, void* out,
                                     int rows, int capacity, int d, int heads, float scale,
                                     void* scratch, long long floats, int dtype, int kv_dtype,
                                     void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, len, rows, out, rows, capacity, d, heads,
                  true, scale, scratch, floats, dtype, kv_dtype, stream);
}
