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
// never spans two streams; here each warp looks up its own row's length, so
// rows are not padded.
//
// Keys are taken in position order, oldest first and the new frame last,
// with the arithmetic of temporal_fullclip.cu step for step: each score is
// one sequential fp32 FMA chain over dh, then scaled; softmax max, exp,
// a sequential sum in key order, PV as a sequential FMA chain in key order,
// and one multiply by the reciprocal of the sum. So on the linear cache a
// streamed frame's attention output equals, bit for bit, the full clip's
// output for that frame, and streaming reproduces the full clip exactly; J
// runs the same body, so a row-major stream equals the pos-major one.
//
// Bound on the H100: bytes. Each (row, head) does 4*dh operations per cache
// slot on 4*dh bytes (bf16) of K/V, about one operation per byte, far
// below the ~295 operations per byte where the tensor cores would become
// the limit. So the design only has to stream the valid prefix of the
// cache once with many loads in flight: one warp per (row, head); for the
// scores one lane per key, each issuing all dh/8 16-byte loads of its key
// row at once; for PV lanes over element pairs of dh (one 128-byte load per
// key per warp at dh = 64, bf16), eight keys unrolled. Reads stop at the
// valid prefix; len is read on the device, so a step never waits for the
// host. Each warp writes only the (row, head) slice of its own stream's new
// slot, which no warp reads, so the in-place append has no race across
// blocks. D moves the same bytes as A, each stream reading its own valid
// prefix; the per-stream length costs one integer division per warp. On the
// row-major layout consecutive positions of a row lie D elements apart
// instead of R*D, which changes the addresses and nothing else.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // warps per block, one (row, head) each
constexpr int kGroup = 4;  // 8-element chunks of a key row loaded at once

// floats of shared memory per warp: q (dh) and the scores (capacity),
// rounded up to keep every warp's q 16-byte aligned
__host__ __device__ inline int warp_floats(int dh, int capacity) {
  return (dh + capacity + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
temporal_decode_pm_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, T* k_cache, T* v_cache,
                          const int* __restrict__ lens, int rows_per_stream,
                          T* __restrict__ out, int rows, int capacity, int d, int heads,
                          long slot_stride, long row_stride, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long w = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (w >= static_cast<long>(rows) * heads) return;
  const int row = static_cast<int>(w / heads);
  const int head = static_cast<int>(w % heads);
  const int dh = d / heads;
  const int nc = dh / 8;
  const long base = static_cast<long>(row) * d + head * dh;  // in q, k_new, v_new, out
  const long cbase = row * row_stride + head * dh;             // in the caches
  const int len = lens[row / rows_per_stream];
  const int n_old = min(len, capacity - 1);  // cached keys attended
  const int first = len - n_old;             // position of the oldest of them
  const int n_keys = n_old + 1;              // and the new frame, last

  float* qs = smem + warp * warp_floats(dh, capacity);
  float* ps = qs + dh;
  for (int e = lane; e < dh; e += 32) qs[e] = to_f32(q[base + e]);
  __syncwarp();

  // scores, one lane per key
  float m = -INFINITY;
  for (int i = lane; i < n_keys; i += 32) {
    const T* kp = i < n_old
        ? k_cache + ((first + i) % capacity) * slot_stride + cbase
        : k_new + base;
    float s = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kGroup) {  // kGroup loads in flight, then the FMAs
      float kf[kGroup][8];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (c0 + g < nc) load8(kp + 8 * (c0 + g), kf[g]);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g < nc) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qs[8 * (c0 + g) + e], kf[g][e], s);
        }
      }
    }
    s = __fmul_rn(s, scale);
    ps[i] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  __syncwarp();
  for (int i = lane; i < n_keys; i += 32) ps[i] = expf(__fsub_rn(ps[i], m));
  __syncwarp();
  float sum = 0.f;
  for (int i = 0; i < n_keys; ++i) sum = __fadd_rn(sum, ps[i]);  // key order, every lane
  const float inv = __fdiv_rn(1.f, sum);

  // PV, lanes over element pairs: lane holds pairs lane and lane + 32
  const int pairs = dh / 2;
  const bool on0 = lane < pairs;
  const bool on1 = lane + 32 < pairs;
  const long off = 2 * lane;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc0 = zero, acc1 = zero;
#pragma unroll 8
  for (int i = 0; i < n_keys; ++i) {
    const T* vp = i < n_old
        ? v_cache + ((first + i) % capacity) * slot_stride + cbase
        : v_new + base;
    const float p = ps[i];
    const float2 v0 = on0 ? load2(vp + off) : zero;
    const float2 v1 = on1 ? load2(vp + off + 64) : zero;
    acc0.x = fmaf(p, v0.x, acc0.x); acc0.y = fmaf(p, v0.y, acc0.y);
    acc1.x = fmaf(p, v1.x, acc1.x); acc1.y = fmaf(p, v1.y, acc1.y);
  }

  const long new_slot = (len % capacity) * slot_stride + cbase + off;
  const long mine = base + off;
  if (on0) {
    store2(out + mine, make_float2(__fmul_rn(acc0.x, inv), __fmul_rn(acc0.y, inv)));
    copy2(k_cache + new_slot, k_new + mine);
    copy2(v_cache + new_slot, v_new + mine);
  }
  if (on1) {
    store2(out + mine + 64, make_float2(__fmul_rn(acc1.x, inv), __fmul_rn(acc1.y, inv)));
    copy2(k_cache + new_slot + 64, k_new + mine + 64);
    copy2(v_cache + new_slot + 64, v_new + mine + 64);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
           int heads, long slot_stride, long row_stride, float scale, cudaStream_t stream) {
  const long warps = static_cast<long>(rows) * heads;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * warp_floats(d / heads, capacity);
  cudaError_t err = cudaFuncSetAttribute(temporal_decode_pm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_decode_pm_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<const int*>(lens),
      rows_per_stream, static_cast<T*>(out), rows, capacity, d, heads, slot_stride, row_stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// row_major: the caches are (R, C, D), else (C, R, D)
int dispatch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
             const void* lens, int rows_per_stream, void* out, int rows, int capacity, int d,
             int heads, bool row_major, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long slot_stride = row_major ? d : static_cast<long>(rows) * d;
  const long row_stride = row_major ? static_cast<long>(capacity) * d : d;
  if (dtype == SF_BFLOAT16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream, out,
                                 rows, capacity, d, heads, slot_stride, row_stride, scale, st);
  if (dtype == SF_FLOAT32)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream, out, rows,
                         capacity, d, heads, slot_stride, row_stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int sf_temporal_decode_pm_smem_bytes(int dh, int capacity) {
  return static_cast<int>(sizeof(float)) * kWarps * warp_floats(dh, capacity);
}

// A: one stream, len a single device int32
extern "C" int sf_temporal_decode_pm(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* len, void* out,
                                     int rows, int capacity, int d, int heads, float scale,
                                     int dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, len, rows, out, rows, capacity, d, heads,
                  false, scale, dtype, stream);
}

// D: rows / rows_per_stream streams, lens a device int32 vector of that length
extern "C" int sf_temporal_decode_pm_ragged(const void* q, const void* k_new, const void* v_new,
                                            void* k_cache, void* v_cache, const void* lens,
                                            int rows_per_stream, void* out, int rows,
                                            int capacity, int d, int heads, float scale,
                                            int dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, lens, rows_per_stream, out, rows, capacity,
                  d, heads, false, scale, dtype, stream);
}

// J: one stream on the row-major (R, C, D) caches, len a single device int32
extern "C" int sf_temporal_decode_rm(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* len, void* out,
                                     int rows, int capacity, int d, int heads, float scale,
                                     int dtype, void* stream) {
  return dispatch(q, k_new, v_new, k_cache, v_cache, len, rows, out, rows, capacity, d, heads,
                  true, scale, dtype, stream);
}
