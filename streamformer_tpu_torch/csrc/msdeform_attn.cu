// Multi-scale deformable attention (MSDeformAttn), forward and backward
// (kernel M).
//
// Replaces no Pallas kernel: the JAX package computes the op with XLA
// gathers (streamformer_tpu/ops/msdeform_attn.py ms_deform_attn_core) and
// ships it natively only as a CPU oracle (streamformer_tpu/native/
// msdeform.cpp:51 forward, :92 backward), "no CUDA on TPU hosts". The
// reference shipped it as its one CUDA extension; this is the port's, for
// the ViT-Adapter's extractors and the pixel decoder's encoder layers.
//
// Contract (ops/msdeform_attn.py): value (B, S, M, D) with S = sum_l H_l *
// W_l, loc (B, Q, M, L, P, 2) normalized (x, y), weight (B, Q, M, L, P), all
// float or all __nv_bfloat16, contiguous; out (B, Q, M * D) in their type.
// The semantics are grid_sample's (bilinear, zero padding, align_corners =
// false): the sample of loc on a level of H x W is at pixel (x * W - 0.5,
// y * H - 0.5), computed without a fused multiply-add as the CPU oracle
// computes it, and a corner outside the map adds zero. Arithmetic is fp32.
// The backward gives the gradients of the value (into an fp32 buffer the
// caller zeroed, by atomicAdd at the four corners), of the locations and of
// the weights (in the inputs' type).
//
// Bound on the H100: bytes. A (b, q, m, l, p) sample reads 4 corners of D
// elements and does ~3 operations an element read; value, loc and weight
// are read once and out written once in the bound (the corner reads hit L2:
// the OVIS step's value planes are 1-2 MB). The design is the simple one:
// one warp per (b, q, m), its lanes over D, which is contiguous in (B, S, M,
// D), so each corner is one coalesced read of D elements; the warp walks
// (l, p), reading a location and a weight once (a broadcast to the lanes).
// In the backward the same warp owns each of its (l, p) samples, so the
// location and weight gradients are warp-shuffle sums over D written by one
// lane, with no atomics; only the value gradient scatters. The level table
// (H, W, start) rides in the kernel's argument struct up to kMaxLevels
// levels, so a call copies nothing from the host; past that it is a device
// array the caller passes.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 8;  // warps a block, one (b, q, m) each
constexpr int kThreads = 32 * kWarps;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

template <typename T>
struct Args {
  const T* value;         // (B, S, M, D)
  const T* loc;           // (B, Q, M, L, P, 2)
  const T* weight;        // (B, Q, M, L, P)
  const T* grad_out;      // (B, Q, M * D), backward
  T* out;                 // (B, Q, M * D), forward
  float* grad_value;      // (B, S, M, D) fp32, zeroed by the caller; backward
  T* grad_loc;            // backward
  T* grad_weight;         // backward
  const long long* table; // (L, 3) of (H, W, start) on the device past kMaxLevels, else null
  Levels levels;          // the same table by value, up to kMaxLevels levels
  int B, S, M, D, Q, L, P;
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void level(const Args<T>& a, int l, int& h, int& w, long long& start) {
  if (a.table) {
    h = static_cast<int>(a.table[3 * l]);
    w = static_cast<int>(a.table[3 * l + 1]);
    start = a.table[3 * l + 2];
  } else {
    h = a.levels.h[l];
    w = a.levels.w[l];
    start = a.levels.start[l];
  }
}

// A sample's top-left corner (x0, y0), its fractions, and which of its four
// corners lie on the map: bit (2 * dy + dx).
struct Corners {
  int x0, y0;
  float wx, wy;
  unsigned inside;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int h, int w) {
  const float x = __fsub_rn(__fmul_rn(lx, static_cast<float>(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, static_cast<float>(h)), 0.5f);
  const float fx = floorf(x), fy = floorf(y);
  Corners c{static_cast<int>(fx), static_cast<int>(fy), x - fx, y - fy, 0u};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = c.y0 + dy, xx = c.x0 + dx;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) c.inside |= 1u << (2 * dy + dx);
    }
  return c;
}

// The four corners of channel d (zero outside the map); base is the level's
// (H, W, M, D) plane at head m, row the (M * D) stride of a position.
template <typename T>
__device__ __forceinline__ void gather(const T* base, long long row, int w, const Corners& c,
                                       int d, float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0.f;
    if (c.inside & (1u << k)) {
      const long long pos = static_cast<long long>(c.y0 + (k >> 1)) * w + c.x0 + (k & 1);
      v[k] = to_f32(base[pos * row + d]);
    }
  }
}

__device__ __forceinline__ float bilinear(const Corners& c, const float (&v)[4]) {
  return (1.f - c.wy) * ((1.f - c.wx) * v[0] + c.wx * v[1]) +
         c.wy * ((1.f - c.wx) * v[2] + c.wx * v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_attn_kernel(const __grid_constant__ Args<T> a) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (item >= static_cast<long long>(a.B) * a.Q * a.M) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const int m = static_cast<int>(item % a.M);
  const int b = static_cast<int>(item / a.M / a.Q);
  const long long row = static_cast<long long>(a.M) * a.D;
  const T* vb = a.value + static_cast<long long>(b) * a.S * row + static_cast<long long>(m) * a.D;
  for (int d = lane; d < a.D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < a.L; ++l) {
      int h, w;
      long long start;
      level(a, l, h, w, start);
      for (int p = 0; p < a.P; ++p) {
        const long long li = (item * a.L + l) * a.P + p;
        const Corners c = corners(to_f32(a.loc[2 * li]), to_f32(a.loc[2 * li + 1]), h, w);
        float v[4];
        gather(vb + start * row, row, w, c, d, v);
        acc += to_f32(a.weight[li]) * bilinear(c, v);
      }
    }
    store1(a.out + item * a.D + d, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_attn_bwd_kernel(const __grid_constant__ Args<T> a) {
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (item >= static_cast<long long>(a.B) * a.Q * a.M) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const int m = static_cast<int>(item % a.M);
  const int b = static_cast<int>(item / a.M / a.Q);
  const long long row = static_cast<long long>(a.M) * a.D;
  const long long vofs = static_cast<long long>(b) * a.S * row + static_cast<long long>(m) * a.D;
  const T* go = a.grad_out + item * a.D;
  for (int l = 0; l < a.L; ++l) {
    int h, w;
    long long start;
    level(a, l, h, w, start);
    const T* vb = a.value + vofs + start * row;
    float* gvb = a.grad_value + vofs + start * row;
    for (int p = 0; p < a.P; ++p) {
      const long long li = (item * a.L + l) * a.P + p;
      const Corners c = corners(to_f32(a.loc[2 * li]), to_f32(a.loc[2 * li + 1]), h, w);
      const float wgt = to_f32(a.weight[li]);
      const float f[4] = {(1.f - c.wy) * (1.f - c.wx), (1.f - c.wy) * c.wx,
                          c.wy * (1.f - c.wx), c.wy * c.wx};
      float gw = 0.f, gx = 0.f, gy = 0.f;
      for (int d = lane; d < a.D; d += 32) {
        float v[4];
        gather(vb, row, w, c, d, v);
        const float g = to_f32(go[d]);
        const float gs = g * wgt;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.inside & (1u << k)) {
            const long long pos = static_cast<long long>(c.y0 + (k >> 1)) * w + c.x0 + (k & 1);
            atomicAdd(gvb + pos * row + d, gs * f[k]);
          }
        }
        gw += g * bilinear(c, v);
        gx += gs * ((1.f - c.wy) * (v[1] - v[0]) + c.wy * (v[3] - v[2]));
        gy += gs * ((1.f - c.wx) * (v[2] - v[0]) + c.wx * (v[3] - v[1]));
      }
      gw = warp_sum(gw);
      gx = warp_sum(gx);
      gy = warp_sum(gy);
      if (lane == 0) {
        store1(a.grad_weight + li, gw);
        store1(a.grad_loc + 2 * li, gx * static_cast<float>(w));  // d pixel / d loc = W
        store1(a.grad_loc + 2 * li + 1, gy * static_cast<float>(h));
      }
    }
  }
}

// The arguments of a launch; shapes is the host's (L, 2) table of (H, W),
// read here into the argument struct up to kMaxLevels levels; past that
// table must be the device's (L, 3) table of (H, W, start). Returns false
// when neither can serve.
template <typename T>
bool make_args(Args<T>& a, const void* value, const void* loc, const void* weight,
               const int* shapes, const void* table, int B, int S, int M, int D, int Q, int L,
               int P) {
  a = Args<T>{};
  a.value = static_cast<const T*>(value);
  a.loc = static_cast<const T*>(loc);
  a.weight = static_cast<const T*>(weight);
  a.table = static_cast<const long long*>(table);
  a.B = B; a.S = S; a.M = M; a.D = D; a.Q = Q; a.L = L; a.P = P;
  if (a.table) return true;
  if (L > kMaxLevels || !shapes) return false;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    a.levels.h[l] = shapes[2 * l];
    a.levels.w[l] = shapes[2 * l + 1];
    a.levels.start[l] = start;
    start += static_cast<long long>(shapes[2 * l]) * shapes[2 * l + 1];
  }
  return true;
}

unsigned blocks_for(int B, int Q, int M) {
  return static_cast<unsigned>((static_cast<long long>(B) * Q * M + kWarps - 1) / kWarps);
}

template <typename T>
int forward(const void* value, const void* loc, const void* weight, void* out, const int* shapes,
            const void* table, int B, int S, int M, int D, int Q, int L, int P,
            cudaStream_t stream) {
  Args<T> a;
  if (!make_args(a, value, loc, weight, shapes, table, B, S, M, D, Q, L, P))
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<T*>(out);
  msdeform_attn_kernel<T><<<blocks_for(B, Q, M), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* value, const void* loc, const void* weight, const void* grad_out,
             float* grad_value, void* grad_loc, void* grad_weight, const int* shapes,
             const void* table, int B, int S, int M, int D, int Q, int L, int P,
             cudaStream_t stream) {
  Args<T> a;
  if (!make_args(a, value, loc, weight, shapes, table, B, S, M, D, Q, L, P))
    return static_cast<int>(cudaErrorInvalidValue);
  a.grad_out = static_cast<const T*>(grad_out);
  a.grad_value = grad_value;
  a.grad_loc = static_cast<T*>(grad_loc);
  a.grad_weight = static_cast<T*>(grad_weight);
  msdeform_attn_bwd_kernel<T><<<blocks_for(B, Q, M), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M forward: out (B, Q, M * D). B * Q * M > 0 (the wrapper launches nothing
// otherwise).
extern "C" int sf_msdeform_attn(const void* value, const void* loc, const void* weight, void* out,
                                const int* shapes, const void* table, int B, int S, int M, int D,
                                int Q, int L, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SF_FLOAT32)
    return forward<float>(value, loc, weight, out, shapes, table, B, S, M, D, Q, L, P, st);
  if (dtype == SF_BFLOAT16)
    return forward<__nv_bfloat16>(value, loc, weight, out, shapes, table, B, S, M, D, Q, L, P,
                                  st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// M backward: grad_value (B, S, M, D) fp32, zeroed by the caller and added
// into; grad_loc and grad_weight in the inputs' type, written whole.
extern "C" int sf_msdeform_attn_bwd(const void* value, const void* loc, const void* weight,
                                    const void* grad_out, void* grad_value, void* grad_loc,
                                    void* grad_weight, const int* shapes, const void* table,
                                    int B, int S, int M, int D, int Q, int L, int P, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gv = static_cast<float*>(grad_value);
  if (dtype == SF_FLOAT32)
    return backward<float>(value, loc, weight, grad_out, gv, grad_loc, grad_weight, shapes, table,
                           B, S, M, D, Q, L, P, st);
  if (dtype == SF_BFLOAT16)
    return backward<__nv_bfloat16>(value, loc, weight, grad_out, gv, grad_loc, grad_weight,
                                   shapes, table, B, S, M, D, Q, L, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
