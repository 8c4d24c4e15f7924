// Multi-scale deformable attention (MSDeformAttn): the CPU oracle.
//
// An OpenMP-parallel C++ forward and backward with the semantics of torch
// grid_sample(mode=bilinear, padding_mode=zeros, align_corners=false): the
// sample of normalized location (x, y) on a level of H x W is at pixel
// (x * W - 0.5, y * H - 0.5), and a corner outside the map adds zero. It is
// the port's independent second oracle for MSDeformAttn (beside the plain
// PyTorch version in ops/msdeform_attn.py), held in the tests against the
// JAX package's core; on the card the op runs kernel M
// (csrc/msdeform_attn.cu). Exposed extern "C" for ctypes.
//
// Layouts (all float32, C-contiguous):
//   value:   (B, S, M, D)        S = sum_l H_l * W_l
//   shapes:  (L, 2) int32        (H_l, W_l)
//   loc:     (B, Q, M, L, P, 2)  normalized (x, y)
//   weight:  (B, Q, M, L, P)
//   out:     (B, Q, M * D)
// The backward writes all of grad_value, grad_loc and grad_weight (it zeroes
// grad_value before adding into it); its caller need not clear them.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

std::vector<int64_t> level_starts(const int32_t* shapes, int L) {
  std::vector<int64_t> starts(L);
  int64_t off = 0;
  for (int l = 0; l < L; ++l) {
    starts[l] = off;
    off += (int64_t)shapes[2 * l] * shapes[2 * l + 1];
  }
  return starts;
}

// The value of the bilinear sample at pixel (x, y) of one level, channel d of
// head m; v is the level's (H, W, M, D) base.
inline float sample_bilinear(const float* v, int h, int w, int64_t m_stride, int64_t md,
                             float x, float y) {
  const int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
  const float wx = x - x0, wy = y - y0;
  float acc = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy < 0 || yy >= h) continue;
    const float fy = dy ? wy : 1.f - wy;
    for (int dx = 0; dx < 2; ++dx) {
      const int xx = x0 + dx;
      if (xx < 0 || xx >= w) continue;
      const float fx = dx ? wx : 1.f - wx;
      acc += fy * fx * v[((int64_t)yy * w + xx) * m_stride + md];
    }
  }
  return acc;
}

}  // namespace

extern "C" {

void ms_deform_attn_forward(const float* value, const int32_t* shapes, const float* loc,
                            const float* weight, float* out, int B, int S, int M, int D, int Q,
                            int L, int P) {
  const std::vector<int64_t> starts = level_starts(shapes, L);
  const int64_t m_stride = (int64_t)M * D;

#if defined(_OPENMP)
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int b = 0; b < B; ++b) {
    for (int q = 0; q < Q; ++q) {
      float* o = out + ((int64_t)b * Q + q) * m_stride;
      for (int m = 0; m < M; ++m) {
        for (int d = 0; d < D; ++d) {
          float acc = 0.f;
          for (int l = 0; l < L; ++l) {
            const int H = shapes[2 * l], W = shapes[2 * l + 1];
            const float* vbase = value + ((int64_t)b * S + starts[l]) * m_stride;
            for (int p = 0; p < P; ++p) {
              const int64_t li = ((((int64_t)b * Q + q) * M + m) * L + l) * P + p;
              const float x = loc[li * 2 + 0] * W - 0.5f;
              const float y = loc[li * 2 + 1] * H - 0.5f;
              acc += weight[li] *
                     sample_bilinear(vbase, H, W, m_stride, (int64_t)m * D + d, x, y);
            }
          }
          o[(int64_t)m * D + d] = acc;
        }
      }
    }
  }
}

// The gradients with respect to the value, the sampling locations and the
// attention weights, for the output's gradient grad_out.
void ms_deform_attn_backward(const float* value, const int32_t* shapes, const float* loc,
                             const float* weight, const float* grad_out, float* grad_value,
                             float* grad_loc, float* grad_weight, int B, int S, int M, int D,
                             int Q, int L, int P) {
  const std::vector<int64_t> starts = level_starts(shapes, L);
  const int64_t m_stride = (int64_t)M * D;
  std::memset(grad_value, 0, sizeof(float) * (size_t)B * S * M * D);

  // parallel over the batch only: queries of one batch element add into the
  // same grad_value entries
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int b = 0; b < B; ++b) {
    for (int q = 0; q < Q; ++q) {
      const float* go = grad_out + ((int64_t)b * Q + q) * m_stride;
      for (int m = 0; m < M; ++m) {
        for (int l = 0; l < L; ++l) {
          const int H = shapes[2 * l], W = shapes[2 * l + 1];
          const float* vbase = value + ((int64_t)b * S + starts[l]) * m_stride;
          float* gvbase = grad_value + ((int64_t)b * S + starts[l]) * m_stride;
          for (int p = 0; p < P; ++p) {
            const int64_t li = ((((int64_t)b * Q + q) * M + m) * L + l) * P + p;
            const float x = loc[li * 2 + 0] * W - 0.5f;
            const float y = loc[li * 2 + 1] * H - 0.5f;
            const float wgt = weight[li];
            const int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
            const float wx = x - x0, wy = y - y0;
            float gw = 0.f, gx = 0.f, gy = 0.f;
            for (int d = 0; d < D; ++d) {
              const int64_t md = (int64_t)m * D + d;
              const float g = go[md];
              float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [dy][dx], zero outside the map
              for (int dy = 0; dy < 2; ++dy) {
                const int yy = y0 + dy;
                if (yy < 0 || yy >= H) continue;
                const float fy = dy ? wy : 1.f - wy;
                for (int dx = 0; dx < 2; ++dx) {
                  const int xx = x0 + dx;
                  if (xx < 0 || xx >= W) continue;
                  const float fx = dx ? wx : 1.f - wx;
                  const int64_t at = ((int64_t)yy * W + xx) * m_stride + md;
                  v[dy][dx] = vbase[at];
                  gvbase[at] += g * wgt * fy * fx;
                }
              }
              const float sampled = (1 - wy) * ((1 - wx) * v[0][0] + wx * v[0][1]) +
                                    wy * ((1 - wx) * v[1][0] + wx * v[1][1]);
              gw += g * sampled;
              gx += g * wgt * ((1 - wy) * (v[0][1] - v[0][0]) + wy * (v[1][1] - v[1][0]));
              gy += g * wgt * ((1 - wx) * (v[1][0] - v[0][0]) + wx * (v[1][1] - v[0][1]));
            }
            grad_weight[li] = gw;
            grad_loc[li * 2 + 0] = gx * W;  // d pixel / d normalized = W
            grad_loc[li * 2 + 1] = gy * H;
          }
        }
      }
    }
  }
}

}  // extern "C"
