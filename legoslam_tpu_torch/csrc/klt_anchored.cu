// Anchored pyramid KLT: every level coarse to fine, then the ZNCC gate, in
// one launch.
//
// Replaces two Pallas TPU kernels of the JAX reference:
//   legoslam_tpu/ops/klt_pallas.py  klt_level_anchored_tile_pallas
//     (_klt_tile_kernel), which ran the levels of >= 20,000 px, and
//   legoslam_tpu/ops/klt_pallas.py  klt_level_anchored_pallas
//     (_klt_level_kernel), which ran the smaller levels,
// together with the per-level glue of legoslam_tpu/ops/klt.py
// klt_pyramid_anchored (:325-380).  Semantics are those of the XLA path
// (ops/klt.py klt_level_anchored); the plain PyTorch twin is
// legoslam_tpu_torch/kernels/klt.py klt_pyramid_anchored_eager.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A tracking frame
// has 512 lanes; each lane runs at most 10 dependent Gauss-Newton iterations
// per level over a 9x9 bilinear window (324 gathers, ~1.5k FLOPs), so the
// whole launch is ~10 MFLOP and touches ~0.5 MB of pyramid that stays in L2.
// The TPU kernels sampled with one-hot matmuls on the MXU and cut a 32x256
// tile per lane to bound that cost; a GPU gathers from any level directly,
// so there is no tile and no lane fails for leaving one (the XLA semantics).
//
// Design: one thread per keypoint, 128 threads per block (4 blocks at 512
// lanes).  Each lane walks the pyramid on its own: each level gets the
// original `valid`, a failed lane restarts the next level from its initial
// guess, and a lane leaves the GN loop as soon as it stops (inactive lanes
// are frozen in the reference, so a per-lane exit gives the same result as
// its all-lanes exit).  The lane's 9x9 template for the current level is
// staged in shared memory, laid out [element][thread] so the 32 threads of
// a warp read 32 consecutive words.  The current window is sampled one halo
// row at a time through a 3-row register ring, so value, both central
// differences and the six GN sums come out of one pass with no 81-element
// array in registers.  Sampling, clamping, the update rule and every
// threshold follow ops/klt.py and ops/interp.py line for line.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHalfPatch = 3;
constexpr int kPatch = 2 * kHalfPatch + 1;  // 7
constexpr int kHalo = kPatch + 2;           // 9
constexpr int kThreads = 128;
constexpr int kMaxLevels = 8;

struct PyramidGeometry {
  long long offset[kMaxLevels];  // element offset of each level in the packed buffer
  int height[kMaxLevels];
  int width[kMaxLevels];
};

// ops/interp.py axis_taps: clamp to [0, size-1], floor, second tap clamped.
// fmaxf/fminf map a NaN position to 0, as the PyTorch twin does.
__device__ __forceinline__ void axis_tap(float pos, int size, int& i0, int& i1, float& frac) {
  pos = fminf(fmaxf(pos, 0.0f), (float)size - 1.0f);
  const float fl = floorf(pos);
  frac = pos - fl;
  i0 = (int)fl;
  i1 = min(i0 + 1, size - 1);
}

// One halo row of the window whose first sample is (x0 + c, y): rows are
// interpolated first, then columns (ops/interp.py sample_grid).
__device__ __forceinline__ void sample_row(const float* __restrict__ img, int H, int W, float y,
                                           const int (&xi0)[kHalo], const int (&xi1)[kHalo],
                                           const float (&fx)[kHalo], float (&out)[kHalo]) {
  int y0, y1;
  float fy;
  axis_tap(y, H, y0, y1, fy);
  const float* r0 = img + (long long)y0 * W;
  const float* r1 = img + (long long)y1 * W;
#pragma unroll
  for (int c = 0; c < kHalo; ++c) {
    const float left = (1.0f - fy) * __ldg(r0 + xi0[c]) + fy * __ldg(r1 + xi0[c]);
    const float right = (1.0f - fy) * __ldg(r0 + xi1[c]) + fy * __ldg(r1 + xi1[c]);
    out[c] = (1.0f - fx[c]) * left + fx[c] * right;
  }
}

__global__ void __launch_bounds__(kThreads) klt_pyramid_anchored_kernel(
    const float* __restrict__ anchors, int anchor_levels, const float* __restrict__ pyr,
    PyramidGeometry geo, int levels, const float* __restrict__ anchor_uv,
    const float* __restrict__ guess, const uint8_t* __restrict__ valid, int n, int iterations,
    float eps2, float scale, float scale_top, int inverse, float min_zncc,
    float* __restrict__ kp_out, uint8_t* __restrict__ ok_out) {
  // Each thread reads and writes only its own column: no block barrier.
  __shared__ float tpl[kHalo * kHalo][kThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  if (i >= n) return;

  const bool v = valid[i] != 0;
  float k1x = anchor_uv[2 * i] * scale_top, k1y = anchor_uv[2 * i + 1] * scale_top;
  float gx0 = guess[2 * i] * scale_top, gy0 = guess[2 * i + 1] * scale_top;
  float k2x = gx0, k2y = gy0;
  bool succ = v;
  const float half = (float)kHalo * 0.5f - 0.5f;  // (halo - 1) / 2

  for (int level = levels - 1; level >= 0; --level) {
    const float* img = pyr + geo.offset[level];
    const int H = geo.height[level], W = geo.width[level];
    const float* a = anchors + ((long long)i * anchor_levels + level) * (kHalo * kHalo);
#pragma unroll
    for (int k = 0; k < kHalo * kHalo; ++k) tpl[k][tid] = a[k];

    // Inverse compositional: J and H frozen from the template's gradients.
    float H00 = 0.0f, H01 = 0.0f, H11 = 0.0f;
    if (inverse) {
#pragma unroll
      for (int r = 0; r < kPatch; ++r) {
#pragma unroll
        for (int c = 0; c < kPatch; ++c) {
          const float jx = -(0.5f * (tpl[(r + 1) * kHalo + c + 2][tid] - tpl[(r + 1) * kHalo + c][tid]));
          const float jy = -(0.5f * (tpl[(r + 2) * kHalo + c + 1][tid] - tpl[r * kHalo + c + 1][tid]));
          H00 += jx * jx;
          H01 += jx * jy;
          H11 += jy * jy;
        }
      }
    }

    float dx = k2x - k1x, dy = k2y - k1y;
    float last_cost = INFINITY;
    bool s = v, active = v;
    for (int it = 0; it < iterations && active; ++it) {
      const float x0 = (k1x + dx) - half;
      const float y0 = (k1y + dy) - half;
      int xi0[kHalo], xi1[kHalo];
      float fx[kHalo];
#pragma unroll
      for (int c = 0; c < kHalo; ++c) axis_tap(x0 + (float)c, W, xi0[c], xi1[c], fx[c]);

      float ra[kHalo], rb[kHalo], rc[kHalo];
      sample_row(img, H, W, y0, xi0, xi1, fx, ra);
      sample_row(img, H, W, y0 + 1.0f, xi0, xi1, fx, rb);
      float cost = 0.0f, h00 = 0.0f, h01 = 0.0f, h11 = 0.0f, bx = 0.0f, by = 0.0f;
#pragma unroll
      for (int r = 0; r < kPatch; ++r) {
        sample_row(img, H, W, y0 + (float)(r + 2), xi0, xi1, fx, rc);
#pragma unroll
        for (int c = 0; c < kPatch; ++c) {
          const float p2 = rb[c + 1];
          const float err = tpl[(r + 1) * kHalo + c + 1][tid] - p2;
          float jx, jy;
          if (inverse) {
            jx = -(0.5f * (tpl[(r + 1) * kHalo + c + 2][tid] - tpl[(r + 1) * kHalo + c][tid]));
            jy = -(0.5f * (tpl[(r + 2) * kHalo + c + 1][tid] - tpl[r * kHalo + c + 1][tid]));
          } else {
            jx = -(0.5f * (rb[c + 2] - rb[c]));
            jy = -(0.5f * (rc[c + 1] - ra[c + 1]));
            h00 += jx * jx;
            h01 += jx * jy;
            h11 += jy * jy;
          }
          cost += err * err;
          bx += -err * jx;
          by += -err * jy;
        }
#pragma unroll
        for (int c = 0; c < kHalo; ++c) {
          ra[c] = rb[c];
          rb[c] = rc[c];
        }
      }
      if (inverse) {
        h00 = H00;
        h01 = H01;
        h11 = H11;
      }
      const float det = h00 * h11 - h01 * h01;
      const float inv_det = fabsf(det) > 1e-12f ? 1.0f / (det != 0.0f ? det : 1.0f) : 0.0f;
      const float ux = (h11 * bx - h01 * by) * inv_det;
      const float uy = (h00 * by - h01 * bx) * inv_det;
      const bool bad = !(isfinite(ux) && isfinite(uy)) || fabsf(det) <= 1e-12f;
      const bool diverged = last_cost < cost;
      const bool apply = active && !bad && !diverged;
      if (apply) {
        dx += ux;
        dy += uy;
        last_cost = cost;
      }
      s = (active && bad) ? false : (apply ? true : s);
      const bool converged = ux * ux + uy * uy < eps2;
      active = apply && !converged;
    }

    const float kx = k1x + dx, ky = k1y + dy;
    const bool in_img = kx >= 0.0f && kx < (float)W && ky >= 0.0f && ky < (float)H;
    succ = s && in_img && v;
    if (level > 0) {
      // Failed lanes restart from the initial guess (ops/klt.py:366-370).
      k1x = k1x / scale;
      k1y = k1y / scale;
      gx0 = gx0 / scale;
      gy0 = gy0 / scale;
      k2x = succ ? kx / scale : gx0;
      k2y = succ ? ky / scale : gy0;
    } else {
      k2x = kx;
      k2y = ky;
    }
  }

  if (min_zncc > 0.0f) {
    // ZNCC of the level-0 template core against the patch at the result
    // (ops/klt.py:371-379); tpl still holds level 0.
    const float* img = pyr + geo.offset[0];
    const int H = geo.height[0], W = geo.width[0];
    const float hp = (float)kPatch * 0.5f - 0.5f;
    int xi0[kHalo], xi1[kHalo];
    float fx[kHalo];
#pragma unroll
    for (int c = 0; c < kHalo; ++c) axis_tap(k2x - hp + (float)c, W, xi0[c], xi1[c], fx[c]);
    float cur[kPatch][kHalo];  // columns kPatch.. are sampled (in-bounds) and unused
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int r = 0; r < kPatch; ++r) {
      sample_row(img, H, W, k2y - hp + (float)r, xi0, xi1, fx, cur[r]);
#pragma unroll
      for (int c = 0; c < kPatch; ++c) {
        s0 += tpl[(r + 1) * kHalo + c + 1][tid];
        s1 += cur[r][c];
      }
    }
    const float m0 = s0 / (float)(kPatch * kPatch), m1 = s1 / (float)(kPatch * kPatch);
    float num = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int r = 0; r < kPatch; ++r) {
#pragma unroll
      for (int c = 0; c < kPatch; ++c) {
        const float c0 = tpl[(r + 1) * kHalo + c + 1][tid] - m0;
        const float c1 = cur[r][c] - m1;
        num += c0 * c1;
        q0 += c0 * c0;
        q1 += c1 * c1;
      }
    }
    const float den = sqrtf(q0 * q1 + 1e-6f);
    succ = succ && (num / den > min_zncc);
  }
  kp_out[2 * i] = k2x;
  kp_out[2 * i + 1] = k2y;
  ok_out[i] = succ ? 1 : 0;
}

}  // namespace

extern "C" int legoslam_klt_pyramid_anchored(
    const float* anchors, int anchor_levels, const float* pyr, const long long* level_offset,
    const int* level_height, const int* level_width, int levels, const float* anchor_uv,
    const float* guess, const uint8_t* valid, int n, int half_patch, int iterations, float eps2,
    float scale, float scale_top, int inverse, float min_zncc, float* kp_out, uint8_t* ok_out,
    void* stream) {
  if (half_patch != kHalfPatch || levels < 1 || levels > kMaxLevels || levels > anchor_levels ||
      n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  PyramidGeometry geo{};
  for (int l = 0; l < levels; ++l) {
    geo.offset[l] = level_offset[l];
    geo.height[l] = level_height[l];
    geo.width[l] = level_width[l];
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  klt_pyramid_anchored_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      anchors, anchor_levels, pyr, geo, levels, anchor_uv, guess, valid, n, iterations, eps2,
      scale, scale_top, inverse, min_zncc, kp_out, ok_out);
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
