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
// ~100 FLOPs per edge plus a 6x6 solve, ~60 kFLOP in all, and a frame runs
// at most 4 x 100 attempts, each of which depends on the one before.  The
// time is the chain of block barriers and the serial 6x6 work, so the design
// keeps everything in one block and never returns to the host.
//
// Design: one block of 256 threads; threads stride over the E edges, so any
// E works.  One pass per LM attempt evaluates, at the candidate pose, each
// edge's residual, 2x6 Jacobian and Huber weights (with the PSD guard), and
// reduces the 21 upper-triangle terms of H, the 6 of b and the robust chi in
// a fixed order (warp shuffles, then the 8 warp sums in order), so runs are
// reproducible.  Evaluating chi and the new normal equations in the same
// pass means a rejected attempt discards its assembly instead of a second
// pass being paid on every accept.  Thread 0 then applies the accept rule,
// the lambda schedule (Nielsen or strategy1) and the stop rules, solves the
// damped 6x6 system by Cholesky, retracts with the SE(3) exponential and two
// Newton-polar SO(3) projections (geometry/se3.py), and broadcasts the next
// candidate through shared memory.  Per-edge outlier flags live in the
// inlier output, which doubles as the round's use mask.  Intrinsics are
// runtime arguments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 28;  // 21 upper-H terms, 6 b terms, chi

struct Intr {
  float fx, fy, cx, cy;
};

// Residual and 2x6 Jacobian of one pose-only edge at pose T (R row-major, t)
// (solver/reprojection.py pose_only_edge).
__device__ __forceinline__ void edge_terms(const float* T, const float* pw, const float* uv,
                                           const Intr& k, float& ru, float& rv, float (&Ju)[6],
                                           float (&Jv)[6]) {
  const float X = T[0] * pw[0] + T[1] * pw[1] + T[2] * pw[2] + T[9];
  const float Y = T[3] * pw[0] + T[4] * pw[1] + T[5] * pw[2] + T[10];
  const float Z = T[6] * pw[0] + T[7] * pw[1] + T[8] * pw[2] + T[11];
  const float z = Z + 1e-18f;
  ru = uv[0] - (k.fx * X / z + k.cx);
  rv = uv[1] - (k.fy * Y / z + k.cy);
  const float zinv = 1.0f / z;
  const float zinv2 = zinv * zinv;
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
  const float sqrte = sqrtf(fmaxf(e2, 1e-20f));
  if (e2 <= d2) {
    r0 = e2;
    r1 = 1.0f;
    r2 = 0.0f;
  } else {
    r0 = 2.0f * sqrte * d - d2;
    r1 = d / sqrte;
    r2 = -0.5f * (d / sqrte) / fmaxf(e2, 1e-20f);
  }
}

// Fixed-order block sum of kRed partials; result in tot[] on every thread.
__device__ __forceinline__ void block_reduce(float (&acc)[kRed], float (*red)[kRed], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRed; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRed) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// One pass at pose T over the edges in use: sum of J^T W J (upper 21), of
// -rho' J^T r (6) and of rho0 (chi), as lm.solve_pose build / chi_fn.
__device__ void assemble(const float* T, const float* __restrict__ pw,
                         const float* __restrict__ uv, const uint8_t* __restrict__ use, int E,
                         const Intr& k, bool robust, float delta, float (*red)[kRed], float* tot) {
  float acc[kRed];
#pragma unroll
  for (int q = 0; q < kRed; ++q) acc[q] = 0.0f;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    if (!use[e]) continue;
    float ru, rv, Ju[6], Jv[6];
    edge_terms(T, pw + 3 * e, uv + 2 * e, k, ru, rv, Ju, Jv);
    const float e2 = ru * ru + rv * rv;
    float r0, r1, r2;
    huber(e2, robust, delta, r0, r1, r2);
    const bool keep = r1 + 2.0f * r2 * e2 > 1e-5f * r1;
    const float two_r2 = keep ? 2.0f * r2 : 0.0f;
    const float W00 = r1 + two_r2 * ru * ru;
    const float W01 = two_r2 * ru * rv;
    const float W11 = r1 + two_r2 * rv * rv;
    int q = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float jwu = Ju[a] * W00 + Jv[a] * W01;
      const float jwv = Ju[a] * W01 + Jv[a] * W11;
#pragma unroll
      for (int b = a; b < 6; ++b) acc[q++] += jwu * Ju[b] + jwv * Jv[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += -(r1 * (Ju[a] * ru + Jv[a] * rv));
    acc[27] += r0;
  }
  block_reduce(acc, red, tot);
}

// Damped 6x6 solve by Cholesky (lm.solve_pose solve_fn damping).
__device__ void damped_solve(const float (&H)[6][6], const float (&b)[6], float lam,
                             bool strategy1, float (&x)[6]) {
  float A[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) A[i][j] = H[i][j];
  for (int i = 0; i < 6; ++i) {
    const float d = H[i][i];
    float dd = strategy1 ? d + lam * d : d + lam;
    dd += fabsf(d) <= 1e-12f ? 1.0f : 0.0f;
    A[i][i] = dd;
  }
  float L[6][6] = {};
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
      for (int q = 0; q < j; ++q) s -= L[i][q] * L[j][q];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
}

// geometry/se3.py retract: Exp(dx) @ T, two Newton-polar projections of the
// rotation, a non-finite dx leaves T unchanged.  T and out: 9 R + 3 t.
__device__ void retract(const float* T, const float (&dx_in)[6], float* out) {
  float dx[6];
  bool finite = true;
  for (int q = 0; q < 6; ++q) finite = finite && isfinite(dx_in[q]);
  for (int q = 0; q < 6; ++q) dx[q] = finite ? dx_in[q] : 0.0f;
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float t2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(t2);
  const bool small = t2 < 0.0025f;  // se3._SMALL_ANGLE ** 2
  const float safe = small ? 1.0f : theta;
  const float half = 0.5f * safe;
  const float sinc = sinf(safe) / safe;
  const float sinc_half = sinf(half) / half;
  const float t4 = t2 * t2;
  const float a = small ? 1.0f - t2 / 6.0f + t4 / 120.0f : sinc;
  const float bb = small ? 0.5f - t2 / 24.0f + t4 / 720.0f : 0.5f * sinc_half * sinc_half;
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f + t4 / 5040.0f : (1.0f - sinc) / (safe * safe);
  const float K[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      Re[i][j] = eye + a * K[i][j] + bb * kk;
      V[i][j] = eye + bb * K[i][j] + c * kk;
    }
  }
  float te[3], R[3][3], tn[3];
  for (int i = 0; i < 3; ++i) te[i] = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      R[i][j] = Re[i][0] * T[j] + Re[i][1] * T[3 + j] + Re[i][2] * T[6 + j];
    tn[i] = Re[i][0] * T[9] + Re[i][1] * T[10] + Re[i][2] * T[11] + te[i];
  }
  for (int pass = 0; pass < 2; ++pass) {
    float S[3][3], Rn[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float m = R[0][i] * R[0][j] + R[1][i] * R[1][j] + R[2][i] * R[2][j];
        S[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * m;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Rn[i][j] = R[i][0] * S[0][j] + R[i][1] * S[1][j] + R[i][2] * S[2][j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) out[3 * i + j] = R[i][j];
    out[9 + i] = tn[i];
  }
}

struct LMParams {
  int iterations, outer, drop_kernel_after, exclude_outliers, strategy1, false_cnt_threshold;
  float chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda;
};

__global__ void __launch_bounds__(kThreads) estimate_pose_kernel(
    const float* __restrict__ T_init, const float* __restrict__ pw, const float* __restrict__ uv,
    const uint8_t* __restrict__ valid, int E, Intr k, LMParams prm, float* __restrict__ T_out,
    uint8_t* __restrict__ inlier, int* __restrict__ n_inliers) {
  __shared__ float sT[12];  // pose the next pass evaluates
  __shared__ float red[kWarps][kRed];
  __shared__ float tot[kRed];
  __shared__ int go;
  const int tid = threadIdx.x;

  // inlier[] is the use mask of the round: valid & ~outlier (round 0: valid).
  for (int e = tid; e < E; e += kThreads) inlier[e] = valid[e];
  const uint8_t* use = prm.exclude_outliers ? inlier : valid;

  // Thread 0's LM state.
  float T0[12], Tc[12], cand[12], H[6][6], b[6], dx[6];
  float chi = 0.0f, lam = 0.0f, ni = 2.0f, last_chi = 1e20f;
  int it = 0, false_cnt = 0;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) T0[3 * i + j] = T_init[4 * i + j];
      T0[9 + i] = T_init[4 * i + 3];
    }
  }

  for (int rnd = 0; rnd < prm.outer; ++rnd) {
    const bool robust = rnd <= prm.drop_kernel_after;
    if (tid == 0)
      for (int q = 0; q < 12; ++q) sT[q] = T0[q];
    __syncthreads();
    assemble(sT, pw, uv, use, E, k, robust, prm.chi2_th, red, tot);
    bool fresh = true;  // this pass evaluated T0 (the round's start), not a candidate
    while (true) {
      if (tid == 0) {
        float Hn[6][6], bn[6];
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int bq = a; bq < 6; ++bq) {
            Hn[a][bq] = tot[q];
            Hn[bq][a] = tot[q];
            ++q;
          }
        for (int a = 0; a < 6; ++a) bn[a] = tot[21 + a];
        const float chi_n = 0.5f * tot[27];
        bool keep_going;
        if (fresh) {
          for (int a = 0; a < 6; ++a) {
            b[a] = bn[a];
            for (int bq = 0; bq < 6; ++bq) H[a][bq] = Hn[a][bq];
          }
          for (int q2 = 0; q2 < 12; ++q2) Tc[q2] = T0[q2];
          chi = chi_n;
          if (prm.strategy1) {
            lam = 1e-5f;
          } else if (prm.init_lambda >= 0.0f) {
            lam = prm.init_lambda;
          } else {
            float md = 0.0f;
            for (int a = 0; a < 6; ++a) md = fmaxf(md, fabsf(H[a][a]));
            lam = prm.tau * fminf(md, prm.max_diag_cap);
          }
          ni = 2.0f;
          last_chi = 1e20f;
          it = 0;
          false_cnt = 0;
          keep_going = it < prm.iterations;
        } else {
          // Evaluate the candidate (lm.py lm_optimize body).
          float scale = 0.0f;
          for (int a = 0; a < 6; ++a)
            scale += dx[a] * ((prm.strategy1 ? lam * H[a][a] * dx[a] : lam * dx[a]) + b[a]);
          scale = 0.5f * scale + 1e-10f;
          const float rho = (chi - chi_n) / scale;
          const bool accept = rho > 0.0f && scale > 0.0f && isfinite(chi_n);
          if (prm.strategy1) {
            lam = accept ? fmaxf(lam / 9.0f, 1e-7f) : fminf(lam * 11.0f, 1e7f);
          } else if (accept) {
            const float u = 2.0f * rho - 1.0f;
            const float alpha = fminf(1.0f - u * u * u, 2.0f / 3.0f);
            lam = lam * fmaxf(1.0f / 3.0f, alpha);
            ni = 2.0f;
          } else {
            lam = lam * ni;
            ni = ni * 2.0f;
          }
          if (accept) {
            for (int a = 0; a < 6; ++a) {
              b[a] = bn[a];
              for (int bq = 0; bq < 6; ++bq) H[a][bq] = Hn[a][bq];
            }
            for (int q2 = 0; q2 < 12; ++q2) Tc[q2] = cand[q2];
            chi = chi_n;
          }
          const int false_n = accept ? 0 : false_cnt + 1;
          const bool outer_done = accept || false_n >= prm.false_cnt_threshold;
          bool stop = false;
          if (outer_done) {
            ++it;
            stop = last_chi - chi < prm.diff_chi_threshold;
            last_chi = chi;
            false_cnt = 0;
          } else {
            false_cnt = false_n;
          }
          keep_going = !stop && it < prm.iterations;
        }
        if (keep_going) {
          damped_solve(H, b, lam, prm.strategy1, dx);
          retract(Tc, dx, cand);
          for (int q2 = 0; q2 < 12; ++q2) sT[q2] = cand[q2];
        } else {
          for (int q2 = 0; q2 < 12; ++q2) sT[q2] = Tc[q2];
        }
        go = keep_going ? 1 : 0;
      }
      __syncthreads();
      if (!go) break;
      assemble(sT, pw, uv, use, E, k, robust, prm.chi2_th, red, tot);
      fresh = false;
    }
    // sT holds the round's pose; reclassify every edge by its unmasked
    // robust chi2 (lm.py pose_edge_chi2), then inlier = valid & ~outlier.
    for (int e = tid; e < E; e += kThreads) {
      float ru, rv, Ju[6], Jv[6], r0, r1, r2;
      edge_terms(sT, pw + 3 * e, uv + 2 * e, k, ru, rv, Ju, Jv);
      huber(ru * ru + rv * rv, robust, prm.chi2_th, r0, r1, r2);
      inlier[e] = (valid[e] && !(r0 > prm.chi2_th)) ? 1 : 0;
    }
    __syncthreads();
  }

  int cnt = 0;
  for (int e = tid; e < E; e += kThreads) cnt += inlier[e];
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) red[tid >> 5][0] = (float)cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += (int)red[w][0];
    *n_inliers = total;
    const float* T = prm.outer > 0 ? Tc : T0;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) T_out[4 * i + j] = T[3 * i + j];
      T_out[4 * i + 3] = T[9 + i];
      T_out[12 + i] = 0.0f;
    }
    T_out[15] = 1.0f;
  }
}

}  // namespace

extern "C" int legoslam_estimate_pose(const float* T_init, const float* p_world, const float* uv,
                                      const uint8_t* valid, int E, float fx, float fy, float cx,
                                      float cy, float chi2_th, int iterations, int outer,
                                      int drop_kernel_after, int exclude_outliers, int strategy1,
                                      float tau, float max_diag_cap, float diff_chi_threshold,
                                      int false_cnt_threshold, float init_lambda, float* T_out,
                                      uint8_t* inlier, int* n_inliers, void* stream) {
  if (E < 0 || outer < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  const Intr k{fx, fy, cx, cy};
  LMParams prm{iterations, outer, drop_kernel_after, exclude_outliers, strategy1,
               false_cnt_threshold, chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda};
  estimate_pose_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(T_init, p_world, uv, valid, E, k,
                                                                 prm, T_out, inlier, n_inliers);
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
