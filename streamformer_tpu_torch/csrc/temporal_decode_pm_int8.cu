// t=1 causal temporal attention against the int8 position-major KV cache,
// with the new frame's codes and scales appended in place: one stream
// (kernel F) or a batch of streams, each at its own position (kernel G,
// continuous batching).
//
// Replaces: streamformer_tpu/ops/attention.py fused_temporal_decode_pm_int8
// (F) and fused_temporal_decode_pm_int8_ragged (G), which share the kernel
// body _pm8_decode_kernel. Same function: q is (R, D) float or bf16 with
// heads as dh-wide slices of D; the new frame arrives quantized, codes
// k_new, v_new (R, D) int8 and per-row scales (R,) fp32; the caches are
// (C, R, D) int8 with per-(position, row) fp32 scales, here position-major
// (C, R) so that the append is one contiguous row of scales. lens (device
// int32) holds the position the new frame takes, one per stream; row r
// belongs to stream r / rows_per_stream (F: one stream of all R rows). The
// new frame attends the last min(len, C-1) positions held in the cache and
// itself, dequantized; slot len % C is not read (it is the slot the new
// frame evicts on the ring) and the new codes AND both scales are written
// there afterwards. The TPU kernel leaves the scale writes to its caller and
// pads each stream's rows to 32; here the kernel writes them, and each block
// looks up its own row's length, so rows are not padded.
//
// Dequantization is folded after the reductions, in fp32: the score of key
// i is ((q . codes_i) * k_scale_i) * dh^-0.5, with the dot one sequential
// FMA chain over dh; the value weight is p_i * v_scale_i. Keys are taken in
// position order, the new frame last; softmax max, exp, a sequential sum in
// key order and one multiply by the reciprocal of the sum, as kernel A. F
// and G run one body, so a ragged row equals a lone stream bit for bit.
//
// Design (decode_row.cuh): kernel A's body with one byte a code. A
// persistent grid, each block walking rows, one row across all heads at a
// time; a producer warp stages the query's row and the row's valid prefix
// of codes, K then V (each slot one contiguous run of D bytes, 768 at the
// flagship: a stage holds 23), into two shared-memory stages by bulk
// asynchronous copies, and each chunk's per-(position, row) scales once,
// by 4-byte cp.async on the same barrier. Rows of a width that is not a
// multiple of 16 bytes (D % 16 == 8) are staged with 8-byte loads instead.
// Codes become fp32 by a byte permute and an add, exactly. The new codes
// and both scales are written at slot len % C, which no block reads. Past
// the (heads, C) scores a block holds in shared memory (about C = 3,800 at
// the flagship) the wrapper passes a scratch for them, and any capacity
// runs (decode_row.cuh's scratch mode, the same bits).
#include "decode_row.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(decode::kThreads)
temporal_decode_pm_int8_kernel(const decode::Args<T, int8_t> a) {
  decode::decode_rows<T, int8_t>(a);
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
           const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
           const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
           int heads, float scale, float* scratch, long long floats, cudaStream_t stream,
           int* blocks_only) {
  decode::Args<T, int8_t> a{
      static_cast<const T*>(q), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const float*>(k_new_scale),
      static_cast<const float*>(v_new_scale), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(lens), rows_per_stream, static_cast<T*>(out), rows, capacity, d,
      heads, static_cast<long>(rows) * d, d, scale, scratch};
  const decode::Plan plan =
      decode::plan(d, heads, capacity, 1, sizeof(T), true, 1, false, scratch || blocks_only);
  int blocks = 0;
  const cudaError_t err = decode::grid(temporal_decode_pm_int8_kernel<T>, plan, rows, heads,
                                       capacity, scratch, floats, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_only) return *blocks_only = blocks, 0;
  temporal_decode_pm_int8_kernel<T><<<blocks, decode::kThreads, plan.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
             const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
             const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
             int heads, float scale, void* scratch, long long floats, int dtype, void* stream,
             int* blocks_only = nullptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache,
                                 k_scale, v_scale, lens, rows_per_stream, out, rows, capacity, d,
                                 heads, scale, sp, floats, st, blocks_only);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale,
                         v_scale, lens, rows_per_stream, out, rows, capacity, d, heads, scale,
                         sp, floats, st, blocks_only);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory a block needs at width d, heads and capacity, for q's
// dtype, with the scores in shared memory (past a block's: a scratch of
// heads x score_stride(C) floats a block, passed as `scratch`, `floats`).
extern "C" int sf_temporal_decode_pm_int8_smem_bytes(int d, int heads, int capacity,
                                                     int dtype) {
  const int q_bytes = dtype == SF_FLOAT32 ? 4 : 2;
  return decode::plan(d, heads, capacity, 1, q_bytes, true).total;
}

// The blocks of the scratch mode's persistent grid over `rows` rows (the
// wrapper allocates a slice of the scratch for each), or minus a CUDA error.
extern "C" int sf_temporal_decode_pm_int8_scratch_blocks(int d, int heads, int capacity,
                                                         int dtype, int rows) {
  int blocks = 0;
  const int rc = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, rows, nullptr, rows, capacity, d, heads, 0.f,
                          nullptr, 0, dtype, nullptr, &blocks);
  return rc ? -rc : blocks;
}

// F: one stream, len a single device int32
extern "C" int sf_temporal_decode_pm_int8(const void* q, const void* k_new, const void* v_new,
                                          const void* k_new_scale, const void* v_new_scale,
                                          void* k_cache, void* v_cache, void* k_scale,
                                          void* v_scale, const void* len, void* out, int rows,
                                          int capacity, int d, int heads, float scale,
                                          void* scratch, long long floats, int dtype,
                                          void* stream) {
  return dispatch(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale,
                  len, rows, out, rows, capacity, d, heads, scale, scratch, floats, dtype,
                  stream);
}

// G: rows / rows_per_stream streams, lens a device int32 vector of that length
extern "C" int sf_temporal_decode_pm_int8_ragged(
    const void* q, const void* k_new, const void* v_new, const void* k_new_scale,
    const void* v_new_scale, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d, int heads,
    float scale, void* scratch, long long floats, int dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_new_scale, v_new_scale, k_cache, v_cache, k_scale, v_scale,
                  lens, rows_per_stream, out, rows, capacity, d, heads, scale, scratch, floats,
                  dtype, stream);
}
