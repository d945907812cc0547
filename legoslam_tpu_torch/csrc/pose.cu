// Motion-only pose estimation, the whole of it in one launch.
//
// Replaces the Pallas TPU kernel of the JAX reference
//   legoslam_tpu/solver/pose_pallas.py  estimate_pose_pallas (_pose_kernel),
// and is held to legoslam_tpu/solver/lm.py estimate_pose: `outer` rounds of
// {reset to the prior pose, up to `iterations` Levenberg-Marquardt steps over
// pose-only reprojection edges, reclassify outliers by robust chi2 > chi2_th}
// with Huber (delta = chi2_th) in rounds <= drop_kernel_after.  The accept
// rule is lm.py's: rho > 0, predicted decrease > 0 and a finite candidate
// chi (the Pallas kernel lacks the middle test).  The plain PyTorch twin is
// legoslam_tpu_torch/kernels/pose.py estimate_pose_eager.
//
// What bounds it on an H100: latency.  At E = 512 edges one LM attempt is
// ~190 FLOPs per edge plus a 6x6 solve, and a frame runs some 20-80
// attempts, each of which depends on the one before.  The roofline bound
// (well under a microsecond) is out of reach; the time is the length of one
// attempt's chain times the number of attempts, so the design shortens the
// chain.  Cycle counts of one pass on the H100 (clock64, with every warp
// owning edges and no precomputation): the edges and their reduction ~1400,
// the serial LM step ~1500 (accept rule ~350, Cholesky ~650, retraction
// ~500), the exchange of the sums ~650.
//
// - One block of 9 warps.  The 8 worker warps own the edges (thread w owns
//   w, w + 256, ...), copied once per launch into shared memory (structure
//   of arrays, so a warp reads 32 consecutive words) with a flag byte (bit
//   0 valid, bit 1 outlier of the last round).  Only the owner reads or
//   writes an edge's copy, so neither the copy nor the per-round
//   reclassification needs a barrier, and no attempt reads global memory.
// - A pass: each worker evaluates, at the candidate pose, its edges'
//   residuals, 2x6 Jacobians and Huber weights (with the PSD guard) into 28
//   partial sums (21 upper-triangle terms of H, 6 of b, the robust chi);
//   one warp reduce-scatter (31 shuffles: each exchange halves what a lane
//   holds) leaves lane l with the warp's sum of term l, which it writes to
//   shared memory.  Warp 0 sums each term over the worker warps in warp
//   order, so the order of every add is fixed and runs are reproducible.
// - Warp 0 holds the LM state and runs the serial step in registers: the
//   accept rule, the lambda schedule (Nielsen or strategy1), the stop
//   rules, the damped 6x6 Cholesky (one rsqrt per pivot), the SE(3)
//   exponential and two Newton-polar SO(3) projections (geometry/se3.py).
//   All small arrays are indexed with compile-time indices (packed 21-term
//   H, fully unrolled loops) so they stay in registers: `nvcc -Xptxas -v`
//   reports no stack frame and no spills.
// - Two named barriers hand the pass over: workers `bar.arrive` when their
//   sums are written and `bar.sync` for the next pose; warp 0 does the
//   opposite, so nobody pays a third barrier.
// - Most attempts are rejections (each round ends in a chain of up to 10),
//   and after a rejection H, b and the pose stay and lambda moves by a
//   fixed rule.  So while the workers evaluate a candidate, warp 0 computes
//   the candidate that follows if it is rejected; a rejection then
//   publishes the next pose at once.  The result is the serial chain's, bit
//   for bit.
// - Chi and the candidate's normal equations come from one pass, so a
//   rejected attempt discards its assembly instead of a second pass being
//   paid on every accept.
//
// The number of LM attempts of each round goes to an optional output (the
// work count behind the bound).  Intrinsics are runtime arguments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 9 warps: on the H100, 160 and 544 threads took 1.9x as long (PERF.md).
constexpr int kThreads = 288;
constexpr int kWorkers = kThreads - 32;  // warp 0 runs the LM chain, the rest own the edges
constexpr int kWorkerWarps = kWorkers / 32;
constexpr int kRed = 28;          // 21 upper-H terms, 6 b terms, chi
constexpr int kMaxEdges = 8192;   // shared copy: 5 floats and a flag byte each
constexpr size_t kEdgeBytes = 5 * sizeof(float) + 1;
constexpr uint8_t kValid = 1, kOutlier = 2;
constexpr float kInvPi = 0.318309886183790672f;

struct Intr {
  float fx, fy, cx, cy;
};

struct LMParams {
  int iterations, outer, drop_kernel_after, exclude_outliers, strategy1, false_cnt_threshold;
  float chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda;
};

// Index of H[a][b] in the packed upper triangle (row-major, a <= b).
__host__ __device__ constexpr int up(int a, int b) {
  return a <= b ? 6 * a - a * (a - 1) / 2 + (b - a) : up(b, a);
}
// Index of L[i][j] in the packed lower triangle (j <= i).
__host__ __device__ constexpr int lo(int i, int j) { return i * (i + 1) / 2 + j; }

// Residual and 2x6 Jacobian of one pose-only edge at pose T (R row-major, t)
// (solver/reprojection.py pose_only_edge).
__device__ __forceinline__ void edge_terms(const float (&T)[12], float px, float py, float pz,
                                           float u, float v, const Intr& k, float& ru, float& rv,
                                           float (&Ju)[6], float (&Jv)[6]) {
  const float X = T[0] * px + T[1] * py + T[2] * pz + T[9];
  const float Y = T[3] * px + T[4] * py + T[5] * pz + T[10];
  const float Z = T[6] * px + T[7] * py + T[8] * pz + T[11];
  const float zinv = __fdividef(1.0f, Z + 1e-18f);
  const float zinv2 = zinv * zinv;
  ru = u - (k.fx * X * zinv + k.cx);
  rv = v - (k.fy * Y * zinv + k.cy);
  Ju[0] = -k.fx * zinv;
  Ju[1] = 0.0f;
  Ju[2] = k.fx * X * zinv2;
  Ju[3] = k.fx * X * Y * zinv2;
  Ju[4] = -k.fx - k.fx * X * X * zinv2;
  Ju[5] = k.fx * Y * zinv;
  Jv[0] = 0.0f;
  Jv[1] = -k.fy * zinv;
  Jv[2] = k.fy * Y * zinv2;
  Jv[3] = k.fy + k.fy * Y * Y * zinv2;
  Jv[4] = -k.fy * X * Y * zinv2;
  Jv[5] = -k.fy * X * zinv;
}

// (rho0, rho1, rho2) of solver/robust.py rho for HUBER or TRIVIAL.
__device__ __forceinline__ void huber(float e2, bool robust, float d, float& r0, float& r1,
                                      float& r2) {
  if (!robust) {
    r0 = e2;
    r1 = 1.0f;
    r2 = 0.0f;
    return;
  }
  const float d2 = d * d;
  const float e2c = fmaxf(e2, 1e-20f);
  const float rs = rsqrtf(e2c);  // 1 / sqrt(e2)
  if (e2 <= d2) {
    r0 = e2;
    r1 = 1.0f;
    r2 = 0.0f;
  } else {
    r0 = 2.0f * (e2c * rs) * d - d2;
    r1 = d * rs;
    r2 = -0.5f * r1 * (rs * rs);
  }
}

// One reduce-scatter step: a lane keeps the half of its kOff values that
// its bit kOff selects and adds the partner's copy of that half.
template <int kOff>
__device__ __forceinline__ void rs_step(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// Warp reduce-scatter of 32 values in 16 + 8 + 4 + 2 + 1 = 31 shuffles:
// afterwards v[0] of lane l is the warp's sum of v[l].
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  rs_step<16>(v, lane & 16);
  rs_step<8>(v, lane & 8);
  rs_step<4>(v, lane & 4);
  rs_step<2>(v, lane & 2);
  rs_step<1>(v, lane & 1);
  return v[0];
}

// The launch's edges in shared memory (structure of arrays).
struct Edges {
  float *px, *py, *pz, *u, *v;
  uint8_t* flag;
};

// Named barriers 1 and 2 (0 is __syncthreads) over the whole block: warp 0
// waits at one while the other warps only arrive, and the other way round.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
constexpr int kSumsReady = 1;  // every warp's partial sums are in red[]
constexpr int kPoseReady = 2;  // warp 0 has published the next pose

// A worker's part of one pass at pose T over the edges in use: the sums of
// J^T W J (upper 21), of -rho' J^T r (6) and of rho0 (chi), as
// lm.solve_pose build / chi_fn, reduce-scattered over the warp; lane l
// writes the warp's term l to red[worker warp][l].
__device__ __forceinline__ void partial_sums(const float (&T)[12], const Edges& ed, int E,
                                             uint8_t use_mask, const Intr& k, bool robust,
                                             float delta, float (*red)[32]) {
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
  for (int e = threadIdx.x - 32; e < E; e += kWorkers) {
    if ((ed.flag[e] & use_mask) != kValid) continue;
    float ru, rv, Ju[6], Jv[6];
    edge_terms(T, ed.px[e], ed.py[e], ed.pz[e], ed.u[e], ed.v[e], k, ru, rv, Ju, Jv);
    const float e2 = ru * ru + rv * rv;
    float r0, r1, r2;
    huber(e2, robust, delta, r0, r1, r2);
    const bool keep = r1 + 2.0f * r2 * e2 > 1e-5f * r1;
    const float two_r2 = keep ? 2.0f * r2 : 0.0f;
    const float W00 = r1 + two_r2 * ru * ru;
    const float W01 = two_r2 * ru * rv;
    const float W11 = r1 + two_r2 * rv * rv;
    // Ju[1] == Jv[0] == 0: their products are left out (for finite values
    // they would add exact zeros).
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float jwu = a == 0 ? Ju[0] * W00 : a == 1 ? Jv[1] * W01 : Ju[a] * W00 + Jv[a] * W01;
      const float jwv = a == 0 ? Ju[0] * W01 : a == 1 ? Jv[1] * W11 : Ju[a] * W01 + Jv[a] * W11;
#pragma unroll
      for (int b = a; b < 6; ++b)
        acc[up(a, b)] += b == 0 ? jwu * Ju[0] : b == 1 ? jwv * Jv[1] : jwu * Ju[b] + jwv * Jv[b];
      acc[21 + a] += -(r1 * (a == 0 ? Ju[0] * ru : a == 1 ? Jv[1] * rv : Ju[a] * ru + Jv[a] * rv));
    }
    acc[27] += r0;
  }
  red[(threadIdx.x >> 5) - 1][threadIdx.x & 31] = warp_reduce_scatter(acc);
}

// Warp 0, after kSumsReady: the block's 28 sums in tot[] of every lane.
// Lane l sums term l over the worker warps in warp order, stores it, and
// every lane reads all 28 back as broadcasts (7 float4 loads: cheaper than
// 28 shuffles).
__device__ __forceinline__ void gather_sums(float (*red)[32], float4* s_tot, float (&tot)[kRed]) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWorkerWarps; ++w) s += red[w][lane];
  __syncwarp();  // the previous pass's reads of s_tot are done
  reinterpret_cast<float*>(s_tot)[lane] = s;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kRed / 4; ++q) {
    const float4 t = s_tot[q];
    tot[4 * q] = t.x;
    tot[4 * q + 1] = t.y;
    tot[4 * q + 2] = t.z;
    tot[4 * q + 3] = t.w;
  }
}

// Damped 6x6 solve by Cholesky (lm.solve_pose solve_fn damping).
__device__ __forceinline__ void damped_solve(const float (&H)[21], const float (&b)[6], float lam,
                                             bool strategy1, float (&x)[6]) {
  float L[21], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s;
      if (i == j) {
        const float d = H[up(i, i)];
        s = strategy1 ? d + lam * d : d + lam;
        s += fabsf(d) <= 1e-12f ? 1.0f : 0.0f;
      } else {
        s = H[up(j, i)];
      }
#pragma unroll
      for (int q = 0; q < j; ++q) s -= L[lo(i, q)] * L[lo(j, q)];
      if (i == j) {
        // One rsqrt gives the pivot's reciprocal and, times s, the pivot.
        s = fmaxf(s, 1e-30f);
        inv[i] = rsqrtf(s);
        L[lo(i, i)] = s * inv[i];
      } else {
        L[lo(i, j)] = s * inv[j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[lo(i, q)] * y[q];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s -= L[lo(q, i)] * x[q];
    x[i] = s * inv[i];
  }
}

// geometry/se3.py retract: Exp(dx) @ T, two Newton-polar projections of the
// rotation, a non-finite dx leaves T unchanged.  T and out: 9 R + 3 t.
__device__ __forceinline__ void retract(const float (&T)[12], const float (&dx_in)[6],
                                        float (&out)[12]) {
  bool finite = true;
#pragma unroll
  for (int q = 0; q < 6; ++q) finite = finite && isfinite(dx_in[q]);
  float dx[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) dx[q] = finite ? dx_in[q] : 0.0f;
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float t2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(t2);
  const bool small = t2 < 0.0025f;  // se3._SMALL_ANGLE ** 2
  const float safe = small ? 1.0f : theta;
  const float rsafe = __fdividef(1.0f, safe);
  // sinpif reduces its argument exactly, so unlike sinf it has no
  // Payne-Hanek slow path and needs no stack.
  const float sinc = sinpif(safe * kInvPi) * rsafe;
  const float sinc_half = sinpif(0.5f * safe * kInvPi) * (2.0f * rsafe);
  const float t4 = t2 * t2;
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) + t4 * (1.0f / 120.0f) : sinc;
  const float bb = small ? 0.5f - t2 * (1.0f / 24.0f) + t4 * (1.0f / 720.0f)
                         : 0.5f * sinc_half * sinc_half;
  const float c = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f) + t4 * (1.0f / 5040.0f)
                        : (1.0f - sinc) * (rsafe * rsafe);
  const float K[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float Re[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      Re[i][j] = eye + a * K[i][j] + bb * kk;
      V[i][j] = eye + bb * K[i][j] + c * kk;
    }
  }
  float R[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = Re[i][0] * T[j] + Re[i][1] * T[3 + j] + Re[i][2] * T[6 + j];
    tn[i] = Re[i][0] * T[9] + Re[i][1] * T[10] + Re[i][2] * T[11] + te;
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float S[3][3], Rn[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float m = R[0][i] * R[0][j] + R[1][i] * R[1][j] + R[2][i] * R[2][j];
        S[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * m;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rn[i][j] = R[i][0] * S[0][j] + R[i][1] * S[1][j] + R[i][2] * S[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = R[i][j];
    out[9 + i] = tn[i];
  }
}

__device__ __forceinline__ void copy12(const float (&src)[12], float (&dst)[12]) {
#pragma unroll
  for (int q = 0; q < 12; ++q) dst[q] = src[q];
}

__device__ __forceinline__ void publish(const float (&T)[12], bool go, float4* s_pose, int* s_go) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) s_pose[q] = make_float4(T[4 * q], T[4 * q + 1], T[4 * q + 2], T[4 * q + 3]);
    *s_go = go ? 1 : 0;
  }
  bar_arrive(kPoseReady);
}

__global__ void __launch_bounds__(kThreads, 1) estimate_pose_kernel(
    const float* __restrict__ T_init, const float* __restrict__ pw, const float* __restrict__ uv,
    const uint8_t* __restrict__ valid, int E, Intr k, LMParams prm, float* __restrict__ T_out,
    uint8_t* __restrict__ inlier, int* __restrict__ n_inliers, int* __restrict__ attempts_out) {
  extern __shared__ float smem[];
  __shared__ float red[kWorkerWarps][32];
  __shared__ float4 s_tot[8];   // the pass's 28 sums (warp 0 only)
  __shared__ float4 s_pose[3];  // the pose the next pass evaluates
  __shared__ int s_go;          // 0: s_pose is the round's result
  __shared__ int cnt[kWorkerWarps];
  const int tid = threadIdx.x;
  Edges ed{smem, smem + E, smem + 2 * E, smem + 3 * E, smem + 4 * E,
           reinterpret_cast<uint8_t*>(smem + 5 * E)};
  // An edge is in use if valid, and in rounds after the first, not an outlier.
  const uint8_t use_mask = prm.exclude_outliers ? (kValid | kOutlier) : kValid;
  float T0[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T0[3 * i + j] = T_init[4 * i + j];
    T0[9 + i] = T_init[4 * i + 3];
  }

  if (tid < 32) {
    // Warp 0: the LM chain, the same in each lane.  While the workers
    // evaluate a candidate, it computes the candidate that follows if this
    // one is rejected (H, b and the pose stay, lambda moves by a fixed rule),
    // so a rejection publishes the next candidate at once.  The result is
    // the serial chain's, bit for bit.
    float Tc[12], cand[12], spec[12], H[21], b[6], dx[6], dx_spec[6], tot[kRed];
    copy12(T0, Tc);
    for (int rnd = 0; rnd < prm.outer; ++rnd) {
      bar_sync(kSumsReady);  // the workers evaluated T0
      gather_sums(red, s_tot, tot);
#pragma unroll
      for (int q = 0; q < 21; ++q) H[q] = tot[q];
#pragma unroll
      for (int a = 0; a < 6; ++a) b[a] = tot[21 + a];
      float chi = 0.5f * tot[27];
      copy12(T0, Tc);
      float lam;
      if (prm.strategy1) {
        lam = 1e-5f;
      } else if (prm.init_lambda >= 0.0f) {
        lam = prm.init_lambda;
      } else {
        float md = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a) md = fmaxf(md, fabsf(H[up(a, a)]));
        lam = prm.tau * fminf(md, prm.max_diag_cap);
      }
      float ni = 2.0f, last_chi = 1e20f;
      int it = 0, false_cnt = 0, attempts = 0;
      bool keep_going = it < prm.iterations, have_spec = false;
      while (true) {
        if (!keep_going) {
          publish(Tc, false, s_pose, &s_go);
          break;
        }
        if (have_spec) {
#pragma unroll
          for (int a = 0; a < 6; ++a) dx[a] = dx_spec[a];
          copy12(spec, cand);
        } else {
          damped_solve(H, b, lam, prm.strategy1, dx);
          retract(Tc, dx, cand);
        }
        publish(cand, true, s_pose, &s_go);
        // While the workers evaluate cand: its predicted decrease, and the
        // candidate that follows if it is rejected.
        float scale = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a)
          scale += dx[a] * ((prm.strategy1 ? lam * H[up(a, a)] * dx[a] : lam * dx[a]) + b[a]);
        scale = 0.5f * scale + 1e-10f;
        const float lam_rej = prm.strategy1 ? fminf(lam * 11.0f, 1e7f) : lam * ni;
        damped_solve(H, b, lam_rej, prm.strategy1, dx_spec);
        retract(Tc, dx_spec, spec);

        bar_sync(kSumsReady);
        gather_sums(red, s_tot, tot);
        ++attempts;
        // Evaluate the candidate (lm.py lm_optimize body).
        const float chi_n = 0.5f * tot[27];
        const float rho = __fdividef(chi - chi_n, scale);
        const bool accept = rho > 0.0f && scale > 0.0f && isfinite(chi_n);
        if (!accept) {
          lam = lam_rej;
          ni = prm.strategy1 ? ni : ni * 2.0f;
        } else if (prm.strategy1) {
          lam = fmaxf(lam * (1.0f / 9.0f), 1e-7f);
        } else {
          const float u = 2.0f * rho - 1.0f;
          const float alpha = fminf(1.0f - u * u * u, 2.0f / 3.0f);
          lam = lam * fmaxf(1.0f / 3.0f, alpha);
          ni = 2.0f;
        }
        if (accept) {
#pragma unroll
          for (int q = 0; q < 21; ++q) H[q] = tot[q];
#pragma unroll
          for (int a = 0; a < 6; ++a) b[a] = tot[21 + a];
          copy12(cand, Tc);
          chi = chi_n;
        }
        have_spec = !accept;
        const int false_n = accept ? 0 : false_cnt + 1;
        bool stop = false;
        if (accept || false_n >= prm.false_cnt_threshold) {
          ++it;
          stop = last_chi - chi < prm.diff_chi_threshold;
          last_chi = chi;
          false_cnt = 0;
        } else {
          false_cnt = false_n;
        }
        keep_going = !stop && it < prm.iterations;
      }
      if (attempts_out != nullptr && tid == 0) attempts_out[rnd] = attempts;
    }
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) T_out[4 * i + j] = Tc[3 * i + j];
        T_out[4 * i + 3] = Tc[9 + i];
        T_out[12 + i] = 0.0f;
      }
      T_out[15] = 1.0f;
    }
    __syncthreads();
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWorkerWarps; ++w) total += cnt[w];
      *n_inliers = total;
    }
    return;
  }

  // Workers: each owns the edges tid - 32, tid - 32 + kWorkers, ...
  const int wt = tid - 32;
  for (int e = wt; e < E; e += kWorkers) {
    ed.px[e] = pw[3 * e];
    ed.py[e] = pw[3 * e + 1];
    ed.pz[e] = pw[3 * e + 2];
    ed.u[e] = uv[2 * e];
    ed.v[e] = uv[2 * e + 1];
    ed.flag[e] = valid[e] ? kValid : 0;
  }
  float T[12];
  for (int rnd = 0; rnd < prm.outer; ++rnd) {
    const bool robust = rnd <= prm.drop_kernel_after;
    copy12(T0, T);  // each round starts from the prior
    while (true) {
      partial_sums(T, ed, E, use_mask, k, robust, prm.chi2_th, red);
      bar_arrive(kSumsReady);
      bar_sync(kPoseReady);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 p = s_pose[q];
        T[4 * q] = p.x;
        T[4 * q + 1] = p.y;
        T[4 * q + 2] = p.z;
        T[4 * q + 3] = p.w;
      }
      if (!s_go) break;
    }
    // T is the round's pose.  Reclassify the owned edges by their unmasked
    // robust chi2 there (lm.py pose_edge_chi2); no barrier: only the owner
    // reads an edge's flag.
    for (int e = wt; e < E; e += kWorkers) {
      float ru, rv, Ju[6], Jv[6], r0, r1, r2;
      edge_terms(T, ed.px[e], ed.py[e], ed.pz[e], ed.u[e], ed.v[e], k, ru, rv, Ju, Jv);
      huber(ru * ru + rv * rv, robust, prm.chi2_th, r0, r1, r2);
      ed.flag[e] = (ed.flag[e] & kValid) | (r0 > prm.chi2_th ? kOutlier : 0);
    }
  }
  int c = 0;
  for (int e = wt; e < E; e += kWorkers) {
    const uint8_t in = ed.flag[e] == kValid ? 1 : 0;
    inlier[e] = in;
    c += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if ((tid & 31) == 0) cnt[(tid >> 5) - 1] = c;
  __syncthreads();
}

}  // namespace

extern "C" int legoslam_estimate_pose(const float* T_init, const float* p_world, const float* uv,
                                      const uint8_t* valid, int E, float fx, float fy, float cx,
                                      float cy, float chi2_th, int iterations, int outer,
                                      int drop_kernel_after, int exclude_outliers, int strategy1,
                                      float tau, float max_diag_cap, float diff_chi_threshold,
                                      int false_cnt_threshold, float init_lambda, float* T_out,
                                      uint8_t* inlier, int* n_inliers, int* attempts,
                                      void* stream) {
  if (E < 0 || E > kMaxEdges || outer < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  static bool smem_raised = false;  // above 48 KB only after opting in, once per process
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        estimate_pose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(kMaxEdges * kEdgeBytes));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const Intr k{fx, fy, cx, cy};
  LMParams prm{iterations, outer, drop_kernel_after, exclude_outliers, strategy1,
               false_cnt_threshold, chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda};
  estimate_pose_kernel<<<1, kThreads, E * kEdgeBytes, (cudaStream_t)stream>>>(
      T_init, p_world, uv, valid, E, k, prm, T_out, inlier, n_inliers, attempts);
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
