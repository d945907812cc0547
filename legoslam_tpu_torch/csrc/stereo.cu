// Scanline stereo: every keypoint's match in the right image, in one launch
// (K3).
//
// Replaces no TPU kernel: the JAX reference's legoslam_tpu/ops/stereo.py
// `match` is XLA code.  On the card its plain PyTorch twin
// (legoslam_tpu_torch/kernels/stereo.py match_eager) is ~950 small launches
// and up to `refine_iterations` host reads a call, since every sum it takes
// is a chain of one-element adds (the CPU's order, so that a card and a CPU
// give the same bits); this kernel computes the same function, bit for bit,
// with no host read.
//
// Per keypoint (a lane of the batch): sample the P x P left patch and the
// P x S right strip (S = D + P + 1 columns, D integer disparities from the
// rig's depth gates); the ZNCC cost of every disparity from the patch's
// cross-correlation with the strip and the strip's window sums (prefix sums
// of its column sums); the winner, a uniqueness gate, a parabolic seed;
// Gauss-Newton on the continuous disparity inside the strip; the final ZNCC
// score and the range tests.
//
// What bounds it on an H100: latency.  A keyframe has 512 lanes; a lane's
// work is ~2.5k multiply-adds of cross-correlation (kitti00: D = 28, a 7x7
// patch) and up to 6 dependent GN iterations, each ending in three ordered
// 49-term sums, so the launch is ~5 MFLOP and reads ~0.6 MB of the two
// images, well under a microsecond at the card's roofline.  The time is the
// chain of dependent sums of the slowest lane.  Design: one warp per
// keypoint, 4 warps a block (128 blocks at 512 lanes, one per SM).  The
// warp samples its patch and strip into its own shared memory (dynamic: the
// sizes follow D), then alternates phases that spread over the 32 lanes
// (sampling, per-column sums, per-disparity cost, per-pixel terms) with
// ordered sums that one lane each takes, separated by __syncwarp.  Every
// value a later phase needs lives in the warp's shared memory, and the
// control flow is warp-uniform (every lane reads the GN state from there), so
// the same body, with its lanes run one after the other, compiles for the
// host (LEGOSLAM_STEREO_HOST; tests/stereo_host.py) and is held against the
// plain version on a CPU.  The half-patch (0..9), D and S are run-time
// values: one kernel serves every rig and patch, and builds in seconds.
//
// Rounding is the plain version's (ops/rounding.py, ops/prefix.py,
// ops/interp.py): the patch sums one element at a time in row-major order
// (`patch_sum`); the sums over a patch's rows in the order of `rows_sum`
// for the width they are taken over (D for the cross term, S for the window
// sums); the window sums from the 16-wide chunked prefix scan with its
// recursive carry (`prefix.cumsum`); a division by the patch's pixel count
// as a multiply by the float32 reciprocal (`div_const`); correctly rounded
// square roots; no contracted multiply-adds (built with -fmad=false) but
// the bilinear row pass on the image shapes `interp.fused_rows` names.  The
// winner is the first minimum (torch.min's, on a CPU and on a card), and
// the GN loop runs per lane until the lane stops or `iterations` have run,
// which gives the batched loop's bits (a stopped lane's state never
// changes there).

#ifdef LEGOSLAM_STEREO_HOST
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#define HD inline
#define DEV inline
// A warp's phase: its 32 lanes one after the other.
#define FOR_LANE(lane) for (int lane = 0; lane < 32; ++lane)
#define WARP_SYNC() ((void)0)
#define LOAD(p) (*(p))
#define FMA_RN(a, b, c) fmaf((a), (b), (c))
#define SQRT_RN(x) sqrtf(x)
#else
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#define HD __host__ __device__ __forceinline__
#define DEV __device__ __forceinline__
// A warp's phase: each thread runs it once for its own lane.
#define FOR_LANE(lane) for (int lane = (int)(threadIdx.x & 31), lane##_once = 0; lane##_once < 1; ++lane##_once)
#define WARP_SYNC() __syncwarp()
#define LOAD(p) __ldg(p)
#define FMA_RN(a, b, c) __fmaf_rn((a), (b), (c))
#define SQRT_RN(x) __fsqrt_rn(x)
#endif

namespace {

constexpr int kMaxHalfPatch = 9;  // as K1 (csrc/klt_anchored.cu): a 19x19 patch
// The strip's widest: its prefix scan takes at most two levels of carries
// (16^3 columns), and at half-patch 9 a warp's shared memory stays under
// the card's 227 KB.
constexpr int kMaxStrip = 2048;
constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 16;  // ops/prefix.py's chunk

struct Image {
  const float* px;
  int h, w;
  int fused;  // the bilinear row pass is one fused multiply-add (ops/interp.py fused_rows)
};

struct Params {
  Image left, right;
  const float* kp;       // (n, 2): x, y
  const uint8_t* valid;  // (n,)
  int n;
  int h, P;         // half-patch, patch width 2 h + 1
  int d_hi, D, S, iterations;
  float shift_x;    // the strip's first column is at x + shift_x: -(d_hi + h + 1)
  float u_hi;       // 1 + d_hi: the disparity at strip position u is u_hi - u
  float inv_pp;     // float32 1 / P^2
  float uniqueness, score_max, d_gt, d_lt;  // the gates, rounded to float32
  float* uv_out;    // (n, 2)
  uint8_t* ok_out;  // (n,)
};

// A warp's GN state and the sums its lanes hand each other.
struct State {
  float mean_l, ql, norm_l, u, last_cost, sums[3], mean_r;
  int best, active, ok0;
};

HD int whole_columns(int C) {  // rows_sum's columns summed row by row
  return C >= 8 ? (C / 32) * 32 : (C / 4) * 4;
}

HD int chunks(int n) { return (n + kChunk - 1) / kChunk; }

// Scratch for one prefix scan's carries: the chunk totals of every level.
HD int scan_scratch(int S) { return chunks(S) + kChunk; }

// The warp's shared floats, as offsets from its region's start.
struct Layout {
  int patch, pl0, strip, colsum, colsq, tot_s, tot_q, cross, cost, halo, terms, floats;
};

HD Layout layout(int P, int S, int D) {
  Layout L;
  int o = (int)((sizeof(State) + 15) / 16) * 4;
  L.patch = o;  o += P * P;
  L.pl0 = o;    o += P * P;
  L.strip = o;  o += P * S;
  L.colsum = o; o += S;
  L.colsq = o;  o += S;
  L.tot_s = o;  o += scan_scratch(S);
  L.tot_q = o;  o += scan_scratch(S);
  L.cross = o;  o += D;
  L.cost = o;   o += D;
  L.halo = o;   o += P * (P + 2);
  L.terms = o;  o += 3 * P * P;
  L.floats = (o + 3) / 4 * 4;
  return L;
}

// ops/interp.py axis_taps and sample_grid at one point, as K1 samples.
DEV void axis_tap(float pos, int size, int& i0, int& i1, float& frac) {
  pos = fminf(fmaxf(pos, 0.0f), (float)size - 1.0f);
  const float fl = floorf(pos);
  frac = pos - fl;
  i0 = (int)fl;
  i1 = i0 + 1 < size - 1 ? i0 + 1 : size - 1;
}

DEV float sample(const Image& im, float y, float x) {
  int y0, y1, x0, x1;
  float fy, fx;
  axis_tap(y, im.h, y0, y1, fy);
  axis_tap(x, im.w, x0, x1, fx);
  const float* r0 = im.px + (long long)y0 * im.w;
  const float* r1 = im.px + (long long)y1 * im.w;
  const float gy = 1.0f - fy;
  const float a0 = LOAD(r0 + x0), a1 = LOAD(r1 + x0), b0 = LOAD(r0 + x1), b1 = LOAD(r1 + x1);
  const float left = im.fused ? FMA_RN(fy, a1, gy * a0) : gy * a0 + fy * a1;
  const float right = im.fused ? FMA_RN(fy, b1, gy * b0) : gy * b0 + fy * b1;
  return (1.0f - fx) * left + fx * right;
}

// ops/rounding.py rows_sum over the P rows x(0..P-1) of one column: in a
// column of the whole blocks (`seq`) the rows one at a time from zero (the
// first 16 apart from the rest when P >= 16), elsewhere four partial sums,
// row r in sum r mod 4 and the rows past the last whole four in the first.
template <class F>
DEV float rows_sum(int P, bool seq, F x) {
  float v;
  if (seq) {
    if (P < 16) {
      float a = 0.0f;
      for (int r = 0; r < P; ++r) a = a + x(r);
      v = a;
    } else {
      float a = 0.0f, b = 0.0f;
      for (int r = 16; r < P; ++r) a = a + x(r);
      for (int r = 0; r < 16; ++r) b = b + x(r);
      v = a + (0.0f + b);
    }
  } else {
    const int n4 = P / 4;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
    for (int k = 0; k < n4; ++k) {
      p0 = p0 + x(4 * k);
      p1 = p1 + x(4 * k + 1);
      p2 = p2 + x(4 * k + 2);
      p3 = p3 + x(4 * k + 3);
    }
    for (int r = 4 * n4; r < P; ++r) p0 = p0 + x(r);
    v = ((p0 + p1) + p2) + p3;
  }
  return 0.0f + v;
}

// ops/rounding.py patch_sum: n terms, one add at a time from the first.
DEV float ordered_sum(const float* t, int n) {
  float acc = t[0];
  for (int k = 1; k < n; ++k) acc = acc + t[k];
  return acc;
}

// ops/prefix.py cumsum of x and y (each n long) in place: chunks of 16
// scanned one add at a time, the chunk totals (with the zero padding's
// adds) scanned the same way, recursively, and each chunk's exclusive
// carry added to it (the first chunk's, zero, too).  Depth bounds the
// levels of carries (n <= 16^(Depth + 1)).
template <int Depth>
DEV void scan_pair(float* x, float* y, int n, float* tx, float* ty) {
  if (n <= kChunk) {
    FOR_LANE(lane) {
      float* a = lane == 0 ? x : y;
      if (lane < 2)
        for (int k = 1; k < n; ++k) a[k] = a[k - 1] + a[k];
    }
    WARP_SYNC();
    return;
  }
  if constexpr (Depth > 0) {
    const int m = chunks(n);
    FOR_LANE(lane) {
      for (int q = lane; q < 2 * m; q += 32) {
        float* a = q < m ? x : y;
        float* t = q < m ? tx : ty;
        const int c = q < m ? q : q - m;
        float acc = a[kChunk * c];
        for (int k = 1; k < kChunk; ++k) {
          const int p = kChunk * c + k;
          acc = acc + (p < n ? a[p] : 0.0f);
          if (p < n) a[p] = acc;
        }
        t[c] = acc;
      }
    }
    WARP_SYNC();
    scan_pair<Depth - 1>(tx, ty, m, tx + m, ty + m);
    FOR_LANE(lane) {
      for (int p = lane; p < n; p += 32) {
        const int c = p / kChunk;
        x[p] = x[p] + (c == 0 ? 0.0f : tx[c - 1]);
        y[p] = y[p] + (c == 0 ? 0.0f : ty[c - 1]);
      }
    }
    WARP_SYNC();
  }
}

// The first minimum of cost[0..D) as torch.min takes it (a NaN wins where
// it comes first), the entries within 2 of `skip` (if >= 0) read as +inf.
DEV int first_min(const float* cost, int D, int skip, float& value) {
  const auto at = [&](int j) { return skip >= 0 && abs(j - skip) <= 2 ? INFINITY : cost[j]; };
  int best = 0;
  float v = at(0);
  if (!isnan(v)) {
    for (int j = 1; j < D; ++j) {
      const float c = at(j);
      if (!(c >= v)) {
        v = c;
        best = j;
        if (isnan(c)) break;
      }
    }
  }
  value = v;
  return best;
}

// torch.clamp: NaN stays NaN.
DEV float clamp_keep_nan(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }

// The P x (P + 2) halo window of the strip at continuous position u (the
// plain version's sample_halo): column c at u + c - 1, clamped to the
// strip, linearly interpolated.
DEV void sample_halo(const float* strip, int P, int S, float u, float* halo) {
  const int kW = P + 2;
  FOR_LANE(lane) {
    for (int q = lane; q < P * kW; q += 32) {
      const int r = q / kW, c = q - r * kW;
      const float pos = fminf(fmaxf((u + (float)c) - 1.0f, 0.0f), (float)S - 2.0f);
      const float i0 = floorf(pos);
      const float f = pos - i0;
      const float* row = strip + r * S + (int)i0;
      halo[q] = (1.0f - f) * row[0] + f * row[1];
    }
  }
  WARP_SYNC();
}

// One keypoint's match, by the warp whose shared region `sm` is (the plain
// version: legoslam_tpu_torch/kernels/stereo.py match_eager).
DEV void match_keypoint(const Params& p, int i, float* sm) {
  const int P = p.P, PP = P * P, kW = P + 2;
  const int S = p.S, D = p.D;
  const Layout L = layout(P, S, D);
  State* st = reinterpret_cast<State*>(sm);
  float* patch = sm + L.patch;
  float* pl0 = sm + L.pl0;
  float* strip = sm + L.strip;
  float* colsum = sm + L.colsum;
  float* colsq = sm + L.colsq;
  float* cross = sm + L.cross;
  float* cost = sm + L.cost;
  float* halo = sm + L.halo;
  float* terms = sm + L.terms;
  const float kx = p.kp[2 * i], ky = p.kp[2 * i + 1];
  const float y0 = ky - (float)p.h;  // the patch's and the strip's first row
  const float px0 = kx - (float)p.h, sx0 = kx + p.shift_x;

  // The left patch and the right strip (interp.sample_patches / sample_grid).
  FOR_LANE(lane) {
    for (int q = lane; q < PP; q += 32) {
      const int r = q / P, c = q - r * P;
      patch[q] = sample(p.left, y0 + (float)r, px0 + (float)c);
    }
    for (int q = lane; q < P * S; q += 32) {
      const int r = q / S, c = q - r * S;
      strip[q] = sample(p.right, y0 + (float)r, sx0 + (float)c);
    }
  }
  WARP_SYNC();

  // The patch's mean (patch_mean); the strip's column sums of values and squares.
  FOR_LANE(lane) {
    if (lane == 31) st->mean_l = ordered_sum(patch, PP) * p.inv_pp;
    const int whole = whole_columns(S);
    for (int c = lane; c < S; c += 32) {
      const float* col = strip + c;
      colsum[c] = rows_sum(P, c < whole, [&](int r) { return col[r * S]; });
      colsq[c] = rows_sum(P, c < whole, [&](int r) { return col[r * S] * col[r * S]; });
    }
  }
  WARP_SYNC();
  FOR_LANE(lane) {
    for (int q = lane; q < PP; q += 32) pl0[q] = patch[q] - st->mean_l;
  }
  WARP_SYNC();
  scan_pair<2>(colsum, colsq, S, sm + L.tot_s, sm + L.tot_q);

  // The patch's norm; the cross term of every disparity, patch column by
  // patch column (rows_sum over a width of D).
  FOR_LANE(lane) {
    if (lane == 31) {
      float acc = pl0[0] * pl0[0];
      for (int q = 1; q < PP; ++q) acc = acc + pl0[q] * pl0[q];
      st->ql = acc;
      st->norm_l = SQRT_RN(acc);
    }
    const int whole = whole_columns(D);
    for (int j = lane; j < D; j += 32) {
      float acc = 0.0f;
      for (int k = 0; k < P; ++k) {
        const float* s = strip + 1 + k + j;
        acc = acc + rows_sum(P, j < whole, [&](int r) { return pl0[r * P + k] * s[r * S]; });
      }
      cross[j] = acc;
    }
  }
  WARP_SYNC();

  // The cost of every disparity: 1 - ZNCC from the window sums.
  FOR_LANE(lane) {
    for (int j = lane; j < D; j += 32) {
      const float ws = colsum[P + j] - colsum[j];
      const float wq = colsq[P + j] - colsq[j];
      const float var = clamp_keep_nan(wq - (ws * ws) * p.inv_pp, 0.0f, INFINITY);
      const float den = st->norm_l * SQRT_RN(var) + 1e-6f;
      cost[j] = 1.0f - cross[j] / den;
    }
  }
  WARP_SYNC();

  // The winner, the uniqueness gate and the parabolic seed.
  FOR_LANE(lane) {
    if (lane == 0) {
      float c_best, c_second;
      const int best = first_min(cost, D, -1, c_best);
      first_min(cost, D, best, c_second);
      const bool ambiguous = c_best > p.uniqueness * c_second;
      const float cp = cost[best > 0 ? best - 1 : 0];
      const float cn = cost[best + 1 < D ? best + 1 : D - 1];
      const float denom = (cp - 2.0f * c_best) + cn;
      float off = fabsf(denom) > 1e-9f ? (0.5f * (cp - cn)) / (denom != 0.0f ? denom : 1.0f) : 0.0f;
      off = clamp_keep_nan(off, -1.0f, 1.0f);
      st->best = best;
      st->u = (1.0f + (float)best) + off;
      st->last_cost = INFINITY;
      st->ok0 = p.valid[i] != 0 && !ambiguous;
      st->active = st->ok0;
    }
  }
  WARP_SYNC();

  // Gauss-Newton on u, this lane alone, until it stops.
  for (int it = 0; it < p.iterations; ++it) {
    if (!st->active) break;
    sample_halo(strip, P, S, st->u, halo);
    FOR_LANE(lane) {
      for (int q = lane; q < PP; q += 32) {
        const int r = q / P, c = q - r * P;
        const float* h = halo + r * kW + c;
        const float err = patch[q] - h[1];
        const float gx = 0.5f * (h[2] - h[0]);
        terms[q] = err * err;
        terms[PP + q] = gx * gx;
        terms[2 * PP + q] = err * gx;
      }
    }
    WARP_SYNC();
    FOR_LANE(lane) {
      if (lane < 3) st->sums[lane] = ordered_sum(terms + lane * PP, PP);
    }
    WARP_SYNC();
    FOR_LANE(lane) {
      if (lane == 0) {
        const float c = st->sums[0], h = st->sums[1], b = st->sums[2];
        const float upd = h > 1e-9f ? b / (h > 0.0f ? h : 1.0f) : 0.0f;
        const bool apply = !(st->last_cost < c) && isfinite(upd);
        if (apply) {
          st->u = st->u + upd;
          st->last_cost = c;
        }
        st->active = apply && fabsf(upd) >= 1e-2f;
      }
    }
    WARP_SYNC();
  }

  // The final ZNCC score at u (_zncc: the two means, then the three sums).
  sample_halo(strip, P, S, st->u, halo);
  FOR_LANE(lane) {
    if (lane == 0) {
      float acc = halo[1];
      for (int q = 1; q < PP; ++q) acc = acc + halo[(q / P) * kW + q % P + 1];
      st->mean_r = acc * p.inv_pp;
    }
  }
  WARP_SYNC();
  FOR_LANE(lane) {
    for (int q = lane; q < PP; q += 32) {
      const float pr0 = halo[(q / P) * kW + q % P + 1] - st->mean_r;
      terms[q] = pl0[q] * pr0;
      terms[PP + q] = pr0 * pr0;
    }
  }
  WARP_SYNC();
  FOR_LANE(lane) {
    if (lane < 2) st->sums[lane] = ordered_sum(terms + lane * PP, PP);
  }
  WARP_SYNC();
  FOR_LANE(lane) {
    if (lane == 0) {
      const float den = SQRT_RN(st->ql * st->sums[1] + 1e-6f);
      const float score = 1.0f - st->sums[0] / den;
      const float d = p.u_hi - st->u;
      const float x_r = kx - d;
      const bool in_range = d > p.d_gt && d < p.d_lt && x_r >= 0.0f && x_r < (float)p.right.w;
      p.uv_out[2 * i] = x_r;
      p.uv_out[2 * i + 1] = ky;
      p.ok_out[i] = (st->ok0 && score < p.score_max && in_range) ? 1 : 0;
    }
  }
}

// The arguments of the C entry points, checked: 0, or the reason they are refused.
inline const char* make_params(const float* img_l, int hl, int wl, int fused_l, const float* img_r, int hr, int wr,
                           int fused_r, const float* kp, const uint8_t* valid, int n, int half_patch, int d_hi,
                           int D, int iterations, float uniqueness, float score_max, float d_gt, float d_lt,
                           float* uv_out, uint8_t* ok_out, Params& p) {
  if (half_patch < 0 || half_patch > kMaxHalfPatch) return "half_patch out of 0..9";
  if (hl < 1 || wl < 1 || hr < 1 || wr < 1) return "an image without a row or a column";
  if (D < 3 || n < 0 || iterations < 0) return "bad disparity count, lane count or iterations";
  const int P = 2 * half_patch + 1;
  p.left = Image{img_l, hl, wl, fused_l};
  p.right = Image{img_r, hr, wr, fused_r};
  p.kp = kp;
  p.valid = valid;
  p.n = n;
  p.h = half_patch;
  p.P = P;
  p.d_hi = d_hi;
  p.D = D;
  p.S = D + P + 1;
  if (p.S > kMaxStrip) return "strip wider than 2048 columns";
  p.iterations = iterations;
  p.shift_x = (float)(-(d_hi + half_patch + 1));
  p.u_hi = (float)(1 + d_hi);
  p.inv_pp = 1.0f / (float)(P * P);
  p.uniqueness = uniqueness;
  p.score_max = score_max;
  p.d_gt = d_gt;
  p.d_lt = d_lt;
  p.uv_out = uv_out;
  p.ok_out = ok_out;
  return nullptr;
}

#ifndef LEGOSLAM_STEREO_HOST

__global__ void __launch_bounds__(32 * kWarpsPerBlock) stereo_match_kernel(const __grid_constant__ Params p,
                                                                            int warp_floats) {
  extern __shared__ float smem[];
  const int warp = (int)(threadIdx.x >> 5);
  const int i = (int)blockIdx.x * (int)(blockDim.x >> 5) + warp;
  if (i >= p.n) return;  // the whole warp leaves together
  match_keypoint(p, i, smem + warp * warp_floats);
}

cudaError_t launch(const Params& p, cudaStream_t st) {
  const int floats = layout(p.P, p.S, p.D).floats;
  const size_t warp_bytes = sizeof(float) * (size_t)floats;
  // As many warps as fit the default 48 KB of a block, else one warp and
  // more shared memory asked for.
  int warps = (int)((48 * 1024) / warp_bytes);
  warps = warps < 1 ? 1 : (warps > kWarpsPerBlock ? kWarpsPerBlock : warps);
  const size_t bytes = warp_bytes * warps;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(stereo_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.n + warps - 1) / warps;
  stereo_match_kernel<<<blocks, 32 * warps, bytes, st>>>(p, floats);
  return cudaGetLastError();
}

#endif

}  // namespace

#ifndef LEGOSLAM_STEREO_HOST

// Images are contiguous float32 (h, w); kp (n, 2) float32; valid (n,)
// bytes; D = d_hi - d_lo + 1 integer disparities; the gates as the plain
// version compares them, rounded to float32.  Writes uv_out (n, 2) and
// ok_out (n,).  Returns the launch's cudaError_t (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int legoslam_stereo_match(const float* img_l, int hl, int wl, int fused_l, const float* img_r, int hr,
                                     int wr, int fused_r, const float* kp, const uint8_t* valid, int n,
                                     int half_patch, int d_hi, int D, int iterations, float uniqueness,
                                     float score_max, float d_gt, float d_lt, float* uv_out, uint8_t* ok_out,
                                     void* stream) {
  Params p;
  if (make_params(img_l, hl, wl, fused_l, img_r, hr, wr, fused_r, kp, valid, n, half_patch, d_hi, D, iterations,
                  uniqueness, score_max, d_gt, d_lt, uv_out, ok_out, p) != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  return (int)launch(p, (cudaStream_t)stream);
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else

#include <vector>

// The kernel's body on the host, one keypoint after another (each one warp
// whose lanes run in turn).  Returns null, or why the arguments are refused.
extern "C" const char* legoslam_stereo_match_host(const float* img_l, int hl, int wl, int fused_l,
                                                  const float* img_r, int hr, int wr, int fused_r, const float* kp,
                                                  const uint8_t* valid, int n, int half_patch, int d_hi, int D,
                                                  int iterations, float uniqueness, float score_max, float d_gt,
                                                  float d_lt, float* uv_out, uint8_t* ok_out) {
  Params p;
  const char* why = make_params(img_l, hl, wl, fused_l, img_r, hr, wr, fused_r, kp, valid, n, half_patch, d_hi, D,
                                iterations, uniqueness, score_max, d_gt, d_lt, uv_out, ok_out, p);
  if (why != nullptr) return why;
  std::vector<float> sm(layout(p.P, p.S, p.D).floats);
  for (int i = 0; i < n; ++i) match_keypoint(p, i, sm.data());
  return nullptr;
}

#endif
