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
// The patch is P x P, P = 2 h + 1, with its gradient halo (P + 2)^2: a
// template parameter, instantiated for every half-patch h = 0..9 the
// reference's Pallas kernels take (halo <= 21, klt_pallas.py:344-351);
// below, sizes are those of the default h = 3 (a 7x7 patch, 9x9 halo).
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A tracking frame
// has 512 lanes; each lane runs at most 10 dependent Gauss-Newton iterations
// per level over a 9x9 bilinear window (324 gathers, ~1.8k FLOPs), so the
// whole launch is ~10 MFLOP and reads ~1.1 MB (anchors and pyramid), whose
// roofline bound is well under a microsecond.  The time is the chain of
// dependent GN iterations of the slowest lane, so the design makes each
// iteration short and spreads the lanes over the whole card.  The TPU
// kernels sampled with one-hot matmuls on the MXU and cut a 32x256 tile per
// lane to bound that cost; a GPU gathers from any level directly, so there
// is no tile and no lane fails for leaving one (the XLA semantics).
//
// Design: one warp per keypoint, 4 warps per block (128 blocks at 512
// lanes, one per SM).  Per level the warp reads the keypoint's 9x9
// template into its own shared memory.  Per GN iteration the 32 lanes
// sample the 81 points of the halo window between them (3 each, bilinear,
// clamped as ops/interp.py), stage them in the warp's shared memory,
// __syncwarp, and then take the 49 residual and gradient terms between them
// (2 at most each) into shared memory; six lanes then add up one quantity
// each over the 49 terms in row-major order and broadcast the six sums, so
// the 2x2 update, the divergence and convergence tests and the early exit
// run redundantly in all lanes and the loop stays warp-uniform.  Each level
// gets the original `valid`, a failed lane restarts the next level from its
// initial guess, and a lane leaves the GN loop as soon as it stops
// (inactive lanes are frozen in the reference, so a per-lane exit gives the
// same result as its all-lanes exit).  The ZNCC gate is computed the same
// way.  Levels arrive as separate pointers; samples are plain loads (the
// texture unit's 8-bit filter weights would be too coarse).  The GN
// iterations summed over lanes and levels go to an optional counter (the
// work count behind the bound).
//
// Rounding is the reference's as XLA compiles it for a CPU (ops/rounding.py,
// ops/interp.py): the 49-term sums in row-major order, one add at a time;
// no contracted multiply-adds (the source is built with -fmad=false), but
// for the bilinear row pass on the levels whose bit is set in
// `Pyramid::fused_rows`, rounded as one fused multiply-add; the ZNCC means
// as a multiply by the float32 reciprocal of P^2 (49).  The ordered sums are
// chains of P^2 - 1 dependent adds, so the launch's time grows with P^2.
//
// Frame mode (klt_pyramid_frame_kernel) is the other path into the same two
// Pallas kernels: legoslam_tpu/ops/klt.py klt_pyramid (:179-226), which
// samples the template from the first image at every level and hands it to
// the level kernels (_pallas_level_kernel, :202-215).  Here the warp samples
// the 9x9 template itself from a second pyramid at kp1's position on that
// level (no extract_anchors pass before the launch), a failed lane restarts
// the next level from kp1 instead of the initial guess, and there is no ZNCC
// gate.  Everything else (the GN loop, `valid` on every level, the in-image
// test) is the shared body below; the plain PyTorch twin is
// legoslam_tpu_torch/kernels/klt.py klt_pyramid_eager.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The sizes of half-patch kH (h = 3: a 7x7 patch, 81 samples, 49 terms).
template <int kH>
struct Geo {
  static constexpr int kPatch = 2 * kH + 1;
  static constexpr int kHalo = kPatch + 2;
  static constexpr int kWindow = kHalo * kHalo;  // samples of the halo window
  static constexpr int kTerms = kPatch * kPatch;  // residuals
  static constexpr int kTermsPerLane = (kTerms + 31) / 32;
};
constexpr int kMaxHalfPatch = 9;  // halo 21, the reference's largest
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
// Levels with a row: 16 covers images up to 2^15 px high.  A Pyramid is a
// __grid_constant__ parameter of 260 bytes.
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Pyramid {
  const float* level[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int fused_rows;  // bit l: level l's row pass is one fused multiply-add (ops/interp.py)
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

// One bilinear sample at (x, y): along y first, then x (ops/interp.py
// sample_grid); `fused`: the row pass is fma(fy, b, (1 - fy) a).
__device__ __forceinline__ float sample(const float* __restrict__ img, int H, int W, float y,
                                        float x, bool fused) {
  int y0, y1, x0, x1;
  float fy, fx;
  axis_tap(y, H, y0, y1, fy);
  axis_tap(x, W, x0, x1, fx);
  const float* r0 = img + (long long)y0 * W;
  const float* r1 = img + (long long)y1 * W;
  const float gy = 1.0f - fy;
  const float a0 = __ldg(r0 + x0), a1 = __ldg(r1 + x0), b0 = __ldg(r0 + x1), b1 = __ldg(r1 + x1);
  const float left = fused ? __fmaf_rn(fy, a1, gy * a0) : gy * a0 + fy * a1;
  const float right = fused ? __fmaf_rn(fy, b1, gy * b0) : gy * b0 + fy * b1;
  return (1.0f - fx) * left + fx * right;
}

// The warp's N sums of `terms` (N rows of kTerms in shared memory), each
// added one term at a time in row-major order by lane q < N, then
// broadcast to every lane.  The caller __syncwarp()s after writing terms.
template <int kTerms, int N>
__device__ __forceinline__ void ordered_sums(const float (*terms)[kTerms], float (&out)[N]) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  if (lane < N) {
    acc = terms[lane][0];
#pragma unroll 7
    for (int t = 1; t < kTerms; ++t) acc += terms[lane][t];
  }
#pragma unroll
  for (int q = 0; q < N; ++q) out[q] = __shfl_sync(kFull, acc, q);
}

// Select one level of a pyramid with constant indices: indexing the parameter
// struct by `level` would copy it to the stack.
__device__ __forceinline__ void select_level(const Pyramid& pyr, int level, const float*& img,
                                             int& H, int& W, bool& fused) {
  fused = (pyr.fused_rows >> level) & 1;
  img = pyr.level[0];
  H = pyr.height[0];
  W = pyr.width[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l == level) {
      img = pyr.level[l];
      H = pyr.height[l];
      W = pyr.width[l];
    }
  }
}

// The whole pyramid for one keypoint per warp.  kFrame = false: templates
// come from `anchors`, failed lanes restart from the guess, ZNCC gate at the
// end.  kFrame = true: templates are sampled from `pyr1` at kp1, failed
// lanes restart from kp1, no gate (`anchors`, `anchor_levels` and `min_zncc`
// are unused).
template <int kH, bool kFrame>
__device__ __forceinline__ void klt_pyramid_body(
    const float* __restrict__ anchors, int anchor_levels, const Pyramid& pyr1, const Pyramid& pyr,
    int levels, const float* __restrict__ anchor_uv, const float* __restrict__ guess,
    const uint8_t* __restrict__ valid, int n, int iterations, float eps2, float scale,
    float scale_top, int inverse, float min_zncc, float* __restrict__ kp_out,
    uint8_t* __restrict__ ok_out, int* __restrict__ gn_iterations) {
  constexpr int kPatch = Geo<kH>::kPatch, kHalo = Geo<kH>::kHalo, kWindow = Geo<kH>::kWindow;
  constexpr int kTerms = Geo<kH>::kTerms, kPerLane = Geo<kH>::kTermsPerLane;
  // Each warp reads and writes only its own rows: no block barrier.  At
  // h = 9 the block's 4 x (2 x 441 + 6 x 361) floats are 48,768 bytes, inside
  // the 48 KB of static shared memory.
  __shared__ float s_tpl[kWarpsPerBlock][kWindow];
  __shared__ float s_win[kWarpsPerBlock][kWindow];
  __shared__ float s_terms[kWarpsPerBlock][6][kTerms];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;  // the whole warp leaves together
  float* tpl = s_tpl[warp];
  float* win = s_win[warp];
  float(*terms)[kTerms] = s_terms[warp];

  const bool v = valid[i] != 0;
  float k1x = anchor_uv[2 * i] * scale_top, k1y = anchor_uv[2 * i + 1] * scale_top;
  float gx0 = guess[2 * i] * scale_top, gy0 = guess[2 * i + 1] * scale_top;
  float k2x = gx0, k2y = gy0;
  bool succ = v;
  int iters = 0;
  const float half = (float)kHalo * 0.5f - 0.5f;  // (halo - 1) / 2

  for (int level = levels - 1; level >= 0; --level) {
    const float* img;
    int H, W;
    bool fused;
    select_level(pyr, level, img, H, W, fused);
    __syncwarp();  // the previous level's reads of tpl are done
    if constexpr (kFrame) {
      // The template is the first image's halo window at kp1 on this level
      // (ops/klt.py:209-210: interp.sample_patches(img1, kp1l, halo)).
      const float* img1;
      int H1, W1;
      bool fused1;
      select_level(pyr1, level, img1, H1, W1, fused1);
      const float tx0 = k1x - half, ty0 = k1y - half;
#pragma unroll
      for (int j = 0; j < (kWindow + 31) / 32; ++j) {
        const int q = lane + 32 * j;
        if (q < kWindow) {
          const int r = q / kHalo, c = q - r * kHalo;
          tpl[q] = sample(img1, H1, W1, ty0 + (float)r, tx0 + (float)c, fused1);
        }
      }
    } else {
      const float* a = anchors + ((long long)i * anchor_levels + level) * kWindow;
      for (int q = lane; q < kWindow; q += 32) tpl[q] = a[q];
    }
    __syncwarp();

    // Inverse compositional: J and H frozen from the template's gradients.
    float Hfix[3] = {0.0f, 0.0f, 0.0f};
    if (inverse) {
      for (int t = lane; t < kTerms; t += 32) {
        const int r = t / kPatch, c = t - r * kPatch;
        const int q = (r + 1) * kHalo + c + 1;
        const float jx = -(0.5f * (tpl[q + 1] - tpl[q - 1]));
        const float jy = -(0.5f * (tpl[q + kHalo] - tpl[q - kHalo]));
        terms[0][t] = jx * jx;
        terms[1][t] = jx * jy;
        terms[2][t] = jy * jy;
      }
      __syncwarp();
      ordered_sums<kTerms>(terms, Hfix);
      __syncwarp();  // terms is rewritten below
    }

    float dx = k2x - k1x, dy = k2y - k1y;
    float last_cost = INFINITY;
    bool s = v, active = v;
    for (int it = 0; it < iterations && active; ++it) {
      ++iters;
      const float x0 = (k1x + dx) - half;
      const float y0 = (k1y + dy) - half;
      // Unrolled so that a lane's gathers (12 at h = 3) are all in flight at once.
#pragma unroll
      for (int j = 0; j < (kWindow + 31) / 32; ++j) {
        const int q = lane + 32 * j;
        if (q < kWindow) {
          const int r = q / kHalo, c = q - r * kHalo;
          win[q] = sample(img, H, W, y0 + (float)r, x0 + (float)c, fused);
        }
      }
      __syncwarp();
      // cost, h00, h01, h11, bx, by: the terms, then their ordered sums
#pragma unroll
      for (int j = 0; j < (kTerms + 31) / 32; ++j) {
        const int t = lane + 32 * j;
        if (t >= kTerms) break;
        const int r = t / kPatch, c = t - r * kPatch;
        const int q = (r + 1) * kHalo + c + 1;
        const float err = tpl[q] - win[q];
        float jx, jy;
        if (inverse) {
          jx = -(0.5f * (tpl[q + 1] - tpl[q - 1]));
          jy = -(0.5f * (tpl[q + kHalo] - tpl[q - kHalo]));
        } else {
          jx = -(0.5f * (win[q + 1] - win[q - 1]));
          jy = -(0.5f * (win[q + kHalo] - win[q - kHalo]));
          terms[1][t] = jx * jx;
          terms[2][t] = jx * jy;
          terms[3][t] = jy * jy;
        }
        terms[0][t] = err * err;
        terms[4][t] = -err * jx;
        terms[5][t] = -err * jy;
      }
      __syncwarp();  // terms are written; win is read no more this iteration
      float sum[6];
      ordered_sums<kTerms>(terms, sum);
      __syncwarp();  // terms and win are rewritten by the next iteration
      const float cost = sum[0];
      const float h00 = inverse ? Hfix[0] : sum[1];
      const float h01 = inverse ? Hfix[1] : sum[2];
      const float h11 = inverse ? Hfix[2] : sum[3];
      const float bx = sum[4], by = sum[5];
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
      // Failed lanes restart from the initial guess (ops/klt.py:366-370);
      // in frame mode from kp1 (ops/klt.py:222-225).
      k1x = k1x / scale;
      k1y = k1y / scale;
      gx0 = gx0 / scale;
      gy0 = gy0 / scale;
      k2x = succ ? kx / scale : (kFrame ? k1x : gx0);
      k2y = succ ? ky / scale : (kFrame ? k1y : gy0);
    } else {
      k2x = kx;
      k2y = ky;
    }
  }

  if (!kFrame && min_zncc > 0.0f) {
    // ZNCC of the level-0 template core against the patch at the result
    // (ops/klt.py zncc_gate); tpl still holds level 0.  Each lane keeps its
    // (at most kPerLane) terms in registers between the two passes.
    const float* img = pyr.level[0];
    const int H = pyr.height[0], W = pyr.width[0];
    const bool fused = pyr.fused_rows & 1;
    const float hp = (float)kPatch * 0.5f - 0.5f;
    float t0[kPerLane], t1[kPerLane];
    __syncwarp();  // the last GN iteration's reads of terms are done
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      t0[j] = t1[j] = 0.0f;
      const int t = lane + 32 * j;
      if (t < kTerms) {
        const int r = t / kPatch, c = t - r * kPatch;
        t0[j] = tpl[(r + 1) * kHalo + c + 1];
        t1[j] = sample(img, H, W, k2y - hp + (float)r, k2x - hp + (float)c, fused);
        terms[0][t] = t0[j];
        terms[1][t] = t1[j];
      }
    }
    __syncwarp();
    float m[2];  // sums of the template core and the patch
    ordered_sums<kTerms>(terms, m);
    __syncwarp();
    const float inv_n = 1.0f / (float)kTerms;  // the mean as XLA takes it: times the reciprocal of P^2
    const float m0 = m[0] * inv_n, m1 = m[1] * inv_n;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int t = lane + 32 * j;
      if (t < kTerms) {
        const float c0 = t0[j] - m0, c1 = t1[j] - m1;
        terms[0][t] = c0 * c1;
        terms[1][t] = c0 * c0;
        terms[2][t] = c1 * c1;
      }
    }
    __syncwarp();
    float q[3];  // num, q0, q1
    ordered_sums<kTerms>(terms, q);
    const float den = sqrtf(q[1] * q[2] + 1e-6f);
    succ = succ && (q[0] / den > min_zncc);
  }
  if (lane == 0) {
    kp_out[2 * i] = k2x;
    kp_out[2 * i + 1] = k2y;
    ok_out[i] = succ ? 1 : 0;
    if (gn_iterations != nullptr) atomicAdd(gn_iterations, iters);
  }
}

template <int kH>
__global__ void __launch_bounds__(kThreads) klt_pyramid_anchored_kernel(
    const float* __restrict__ anchors, int anchor_levels, const __grid_constant__ Pyramid pyr,
    int levels, const float* __restrict__ anchor_uv, const float* __restrict__ guess,
    const uint8_t* __restrict__ valid, int n, int iterations, float eps2, float scale,
    float scale_top, int inverse, float min_zncc, float* __restrict__ kp_out,
    uint8_t* __restrict__ ok_out, int* __restrict__ gn_iterations) {
  klt_pyramid_body<kH, false>(anchors, anchor_levels, pyr, pyr, levels, anchor_uv, guess, valid, n,
                          iterations, eps2, scale, scale_top, inverse, min_zncc, kp_out, ok_out,
                          gn_iterations);
}

template <int kH>
__global__ void __launch_bounds__(kThreads) klt_pyramid_frame_kernel(
    const __grid_constant__ Pyramid pyr1, const __grid_constant__ Pyramid pyr2, int levels,
    const float* __restrict__ kp1,
    const float* __restrict__ guess, const uint8_t* __restrict__ valid, int n, int iterations,
    float eps2, float scale, float scale_top, int inverse, float* __restrict__ kp_out,
    uint8_t* __restrict__ ok_out, int* __restrict__ gn_iterations) {
  klt_pyramid_body<kH, true>(nullptr, 0, pyr1, pyr2, levels, kp1, guess, valid, n, iterations, eps2,
                         scale, scale_top, inverse, 0.0f, kp_out, ok_out, gn_iterations);
}

Pyramid make_pyramid(const float* const* level_ptr, const int* level_height,
                     const int* level_width, int levels, int fused_rows) {
  Pyramid pyr{};
  pyr.fused_rows = fused_rows;
  for (int l = 0; l < levels; ++l) {
    pyr.level[l] = level_ptr[l];
    pyr.height[l] = level_height[l];
    pyr.width[l] = level_width[l];
  }
  return pyr;
}

// Every level must have a row and a column (the reference cannot build one
// without either).
bool levels_ok(const int* height, const int* width, int levels) {
  for (int l = 0; l < levels; ++l)
    if (height[l] < 1 || width[l] < 1) return false;
  return true;
}

}  // namespace

// The instantiations: every half-patch 0..kMaxHalfPatch.
#define LEGOSLAM_KLT_HALF_PATCHES(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9)

extern "C" int legoslam_klt_pyramid_anchored(
    const float* anchors, int anchor_levels, const float* const* level_ptr,
    const int* level_height, const int* level_width, int levels, int fused_rows, const float* anchor_uv,
    const float* guess, const uint8_t* valid, int n, int half_patch, int iterations, float eps2,
    float scale, float scale_top, int inverse, float min_zncc, float* kp_out, uint8_t* ok_out,
    int* gn_iterations, void* stream) {
  if (half_patch < 0 || half_patch > kMaxHalfPatch || levels < 1 || levels > kMaxLevels ||
      levels > anchor_levels || n < 0 || !levels_ok(level_height, level_width, levels)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const Pyramid pyr = make_pyramid(level_ptr, level_height, level_width, levels, fused_rows);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (half_patch) {
#define LEGOSLAM_KLT_ANCHORED(h)                                                                     \
  case h:                                                                                           \
    klt_pyramid_anchored_kernel<h><<<blocks, kThreads, 0, st>>>(                                    \
        anchors, anchor_levels, pyr, levels, anchor_uv, guess, valid, n, iterations, eps2, scale,   \
        scale_top, inverse, min_zncc, kp_out, ok_out, gn_iterations);                               \
    break;
    LEGOSLAM_KLT_HALF_PATCHES(LEGOSLAM_KLT_ANCHORED)
#undef LEGOSLAM_KLT_ANCHORED
  }
  return (int)cudaGetLastError();
}

// Frame mode: both pyramids as per-level pointers (finest first), `levels`
// of each, with their fused-row bits; kp1 are the keypoints in the first
// image, guess their initial positions in the second.
extern "C" int legoslam_klt_pyramid_frame(
    const float* const* level1_ptr, const int* level1_height, const int* level1_width,
    int fused_rows1, const float* const* level2_ptr, const int* level2_height,
    const int* level2_width, int fused_rows2, int levels,
    const float* kp1, const float* guess, const uint8_t* valid, int n, int half_patch,
    int iterations, float eps2, float scale, float scale_top, int inverse, float* kp_out,
    uint8_t* ok_out, int* gn_iterations, void* stream) {
  if (half_patch < 0 || half_patch > kMaxHalfPatch || levels < 1 || levels > kMaxLevels || n < 0 ||
      !levels_ok(level1_height, level1_width, levels) || !levels_ok(level2_height, level2_width, levels)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const Pyramid pyr1 = make_pyramid(level1_ptr, level1_height, level1_width, levels, fused_rows1);
  const Pyramid pyr2 = make_pyramid(level2_ptr, level2_height, level2_width, levels, fused_rows2);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (half_patch) {
#define LEGOSLAM_KLT_FRAME(h)                                                                         \
  case h:                                                                                            \
    klt_pyramid_frame_kernel<h><<<blocks, kThreads, 0, st>>>(pyr1, pyr2, levels, kp1, guess, valid, n, \
                                                             iterations, eps2, scale, scale_top,        \
                                                             inverse, kp_out, ok_out, gn_iterations);   \
    break;
    LEGOSLAM_KLT_HALF_PATCHES(LEGOSLAM_KLT_FRAME)
#undef LEGOSLAM_KLT_FRAME
  }
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
