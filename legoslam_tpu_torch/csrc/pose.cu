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
// Rounding: the plain version's, bit for bit.  Built with -fmad=false
// (kernels/_build.py), so every expression rounds as written, left to
// right, as the plain version's single elementwise torch ops do, with
// __fmaf_rn where it fuses (the pose composition, the sums of H): IEEE
// division and sqrtf wherever it divides or takes a root, sinf where it
// calls torch.sin, the edge sums in ops/rounding.py pose_sums' order (the
// reference's: H in four lanes of fused multiply-adds, b and chi one add
// at a time) and the damped 6x6 system solved by lm.lu_solve's LU.
//
// What bounds it on an H100: latency.  At E = 512 edges one LM attempt is
// ~200 FLOPs per edge plus a 6x6 solve, and a frame runs some 20-80
// attempts, each of which depends on the one before.  The roofline bound
// (well under a microsecond) is out of reach; the time is the length of one
// attempt's chain times the number of attempts.  The reference's sums are
// sequential: b's is a chain of 2E dependent adds, ~4 cycles each, which
// bounds a pass from below (~2 us at E = 512).
//
// - One block of 9 warps.  The 8 worker warps own the edges (thread w owns
//   w, w + 256, ...), copied once per launch into shared memory (structure
//   of arrays, so a warp reads 32 consecutive words) with a flag byte (bit
//   0 valid, bit 1 outlier of the last round).  Only the owner reads or
//   writes an edge's copy, so neither the copy nor the per-round
//   reclassification needs a barrier, and no attempt reads global memory.
// - A pass (pass_sums): each worker evaluates, at the candidate pose, its
//   edges' residuals, 2x6 Jacobians, Huber weights (with the PSD guard),
//   the rows of J^T W, the b terms and chi's term into a chunk buffer in
//   shared memory; then 151 workers each carry one of the sums through the
//   chunk's edges in order (144 lanes of H, 6 of b, chi; each kind in warps
//   of its own), and 43 of them write H, -b and chi.  Barriers over the
//   workers alone split the phases.
// - Warp 0 holds the LM state and runs the serial step in registers: the
//   accept rule, the lambda schedule (Nielsen or strategy1), the stop
//   rules, the damped 6x6 LU with partial pivoting, the SE(3)
//   exponential and two Newton-polar SO(3) projections (geometry/se3.py).
//   All small arrays are indexed with compile-time indices (fully unrolled
//   loops, row swaps as selects) so they stay in registers; the only stack
//   frame is sinf's slow path (see retract).
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
// work count behind the bound).  Intrinsics are runtime arguments.  With
// `verification` (the loop closer's rounds) each round starts from the
// last round's pose, not the prior, and an edge stays where its raw chi2 is
// <= chi2_th (lm.estimate_pose).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 9 warps: on the H100, 160 and 544 threads took 1.9x as long (PERF.md).
constexpr int kThreads = 288;
constexpr int kWorkers = kThreads - 32;  // warp 0 runs the LM chain, the rest own the edges
constexpr int kWorkerWarps = kWorkers / 32;
constexpr int kMaxEdges = 4096;   // shared copy: 5 floats and a flag byte each
constexpr size_t kEdgeBytes = 5 * sizeof(float) + 1;
// Per-edge terms of one chunk of the pass: J^T W rows (12), J rows (12), b
// terms (12), chi term (1); the frontend's 512 lanes are one chunk.
constexpr int kChunk = 2 * kWorkers;
constexpr size_t kChunkBytes = size_t(kChunk) * 37 * sizeof(float);
// The sums' chains (rounding.pose_sums), each carried by one worker: H in 4
// lanes x 36 entries (workers 0..143), b's 6 entries (workers 160..165) and
// chi (worker 192), the three kinds in warps of their own, since a warp
// runs its lanes' branches one after the other.
constexpr int kHChains = 4 * 36, kChains = kHChains + 6 + 1;
constexpr int kBWorker = 160, kChiWorker = 192;
constexpr uint8_t kValid = 1, kOutlier = 2;

struct Intr {
  float fx, fy, cx, cy;
};

struct LMParams {
  int iterations, outer, drop_kernel_after, exclude_outliers, verification, strategy1, false_cnt_threshold;
  float chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda;
};

// Residual and 2x6 Jacobian of one pose-only edge at pose T (R row-major, t)
// (solver/reprojection.py pose_only_edge: project, then _pose_jacobian).
__device__ __forceinline__ void edge_terms(const float (&T)[12], float px, float py, float pz,
                                           float u, float v, const Intr& k, float& ru, float& rv,
                                           float (&Ju)[6], float (&Jv)[6]) {
  const float X = T[0] * px + T[1] * py + T[2] * pz + T[9];
  const float Y = T[3] * px + T[4] * py + T[5] * pz + T[10];
  const float Z = T[6] * px + T[7] * py + T[8] * pz + T[11];
  const float z = Z + 1e-18f;
  ru = u - (k.fx * X / z + k.cx);
  rv = v - (k.fy * Y / z + k.cy);
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

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): a NaN stays NaN
// (fmaxf and fminf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// (rho0, rho1, rho2) of solver/robust.py rho for HUBER or TRIVIAL.
__device__ __forceinline__ void huber(float e2, bool robust, float d, float& r0, float& r1,
                                      float& r2) {
  if (!robust || e2 <= d * d) {
    r0 = e2;
    r1 = 1.0f;
    r2 = 0.0f;
    return;
  }
  const float e2c = clamp_min(e2, 1e-20f);
  const float sqrte = sqrtf(e2c);
  r0 = 2.0f * sqrte * d - d * d;
  r1 = d / sqrte;
  r2 = -0.5f * (d / sqrte) / e2c;
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
// Named barrier 3 over the worker warps alone.
__device__ __forceinline__ void bar_sync_workers() {
  asm volatile("bar.sync 3, %0;" ::"n"(kWorkers) : "memory");
}
constexpr int kSumsReady = 1;  // the pass's sums are in s_tot
constexpr int kPoseReady = 2;  // warp 0 has published the next pose

// One edge's terms at pose T (lm.pose_pass), for slot i of the chunk: the
// rows j of J^T W (jw), of J, the b terms J_i rho' r_i (bt) and rho (m).
__device__ __forceinline__ void edge_pass_terms(const float (&T)[12], float px, float py, float pz, float u,
                                                float v, const Intr& k, bool robust, float delta, float* jw,
                                                float* J, float* bt, float& m) {
  float ru, rv, Ju[6], Jv[6];
  edge_terms(T, px, py, pz, u, v, k, ru, rv, Ju, Jv);
  const float e2 = ru * ru + rv * rv;
  float r0, r1, r2;
  huber(e2, robust, delta, r0, r1, r2);
  const bool keep = r1 + 2.0f * r2 * e2 > 1e-5f * r1;
  const float two_r2 = keep ? 2.0f * r2 : 0.0f;
  const float W00 = r1 + two_r2 * ru * ru;
  const float W01 = two_r2 * ru * rv;
  const float W10 = two_r2 * rv * ru;
  const float W11 = r1 + two_r2 * rv * rv;
  const float t0 = r1 * ru, t1 = r1 * rv;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    jw[a] = Ju[a] * W00 + Jv[a] * W10;
    jw[6 + a] = Ju[a] * W01 + Jv[a] * W11;
    J[a] = Ju[a];
    J[6 + a] = Jv[a];
    bt[a] = Ju[a] * t0;
    bt[6 + a] = Jv[a] * t1;
  }
  m = r0;
}

// The workers' part of one pass at pose T over the edges in use, in
// rounding.pose_sums' order: per chunk of kChunk edges, each worker writes
// its edge's terms (zeros for an edge not in use; chunk_terms), then
// kChains workers each carry one sum through the chunk's edges in turn
// (chunk_chain; acc keeps it from chunk to chunk), and combine_sums leaves
// the pass's 43 sums in s_tot.  The three phases are split by barriers
// over the workers.
__device__ __forceinline__ void chunk_terms(int wt, int c0, int n, const float (&T)[12], const Edges& ed,
                                            uint8_t use_mask, const Intr& k, bool robust, float delta,
                                            float* cjw, float* cJ, float* cbt, float* cm) {
  for (int i = wt; i < n; i += kWorkers) {  // edge c0 + i, which worker wt owns
    const int e = c0 + i;
    if ((ed.flag[e] & use_mask) == kValid) {
      edge_pass_terms(T, ed.px[e], ed.py[e], ed.pz[e], ed.u[e], ed.v[e], k, robust, delta, cjw + 12 * i,
                      cJ + 12 * i, cbt + 12 * i, cm[i]);
    } else {
#pragma unroll
      for (int q = 0; q < 12; ++q) cjw[12 * i + q] = cJ[12 * i + q] = cbt[12 * i + q] = 0.0f;
      cm[i] = 0.0f;
    }
  }
}

// A sequential sum acc + x[0] + x[s] + x[2s] + ... over `count` terms from
// shared memory (fused: acc = fma(x, y, acc) with y beside x), in blocks of
// kBlock whose loads issue before the block's dependent adds.
template <int kBlock, bool kFused>
__device__ __forceinline__ float chain(const float* x, const float* y, int stride, int count, float acc) {
  int i = 0;
  for (; i + kBlock <= count; i += kBlock) {
    float xs[kBlock], ys[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      xs[u] = x[stride * (i + u)];
      if (kFused) ys[u] = y[stride * (i + u)];
    }
#pragma unroll
    for (int u = 0; u < kBlock; ++u) acc = kFused ? __fmaf_rn(xs[u], ys[u], acc) : acc + xs[u];
  }
  for (; i < count; ++i) acc = kFused ? __fmaf_rn(x[stride * i], y[stride * i], acc) : acc + x[stride * i];
  return acc;
}

// Chain wt through a chunk of n edges: wt < 144, lane l = wt / 36 = 2
// (e mod 2) + j of H[a][b] (q = wt mod 36 = 6 a + b) as fused multiply-adds
// jw[e][j][a] J[e][j][b]; workers kBWorker + a, b[a] over k = 2e + i;
// worker kChiWorker, chi.
__device__ __forceinline__ float chunk_chain(int wt, int n, const float* cjw, const float* cJ,
                                             const float* cbt, const float* cm, float acc) {
  if (wt < kHChains) {
    const int l = wt / 36, q = wt % 36, j = l & 1, first = l >> 1;
    const int off = 12 * first + 6 * j;
    return chain<16, true>(cjw + off + q / 6, cJ + off + q % 6, 24, (n - first + 1) / 2, acc);
  }
  if (wt >= kBWorker && wt < kBWorker + 6) return chain<32, false>(cbt + wt - kBWorker, nullptr, 6, 2 * n, acc);
  if (wt == kChiWorker) return chain<32, false>(cm, nullptr, 1, n, acc);
  return acc;
}

// Where worker wt's chain sum goes in s_part: H lanes, then b, then chi.
__device__ __forceinline__ int chain_slot(int wt) {
  return wt < kHChains ? wt
         : wt >= kBWorker && wt < kBWorker + 6 ? kHChains + wt - kBWorker
         : wt == kChiWorker ? kChains - 1 : -1;
}

// s_tot from the chains' sums: H row-major with its lanes added (l0 + l1) +
// (l2 + l3), then -b, then chi's sum.
__device__ __forceinline__ void combine_sums(int wt, const float* s_part, float* s_tot) {
  if (wt < 36) {
    s_tot[wt] = (s_part[wt] + s_part[36 + wt]) + (s_part[72 + wt] + s_part[108 + wt]);
  } else if (wt < 42) {
    s_tot[wt] = -s_part[kHChains + wt - 36];
  } else if (wt == 42) {
    s_tot[42] = s_part[kChains - 1];
  }
}

__device__ __forceinline__ void pass_sums(const float (&T)[12], const Edges& ed, int E, uint8_t use_mask,
                                          const Intr& k, bool robust, float delta, float* cjw, float* cJ,
                                          float* cbt, float* cm, float* s_part, float* s_tot) {
  const int wt = threadIdx.x - 32;
  float acc = 0.0f;
  for (int c0 = 0; c0 < E; c0 += kChunk) {
    const int n = min(kChunk, E - c0);
    chunk_terms(wt, c0, n, T, ed, use_mask, k, robust, delta, cjw, cJ, cbt, cm);
    bar_sync_workers();
    acc = chunk_chain(wt, n, cjw, cJ, cbt, cm, acc);
    bar_sync_workers();  // the chunk's terms are read
  }
  const int slot = chain_slot(wt);
  if (slot >= 0) s_part[slot] = acc;
  bar_sync_workers();
  combine_sums(wt, s_part, s_tot);
}

// Warp 0, after kSumsReady: the pass's sums from s_tot into tot.
__device__ __forceinline__ void gather_sums(const float4* s_tot, float (&tot)[44]) {
#pragma unroll
  for (int q = 0; q < 11; ++q) {
    const float4 t = s_tot[q];
    tot[4 * q] = t.x;
    tot[4 * q + 1] = t.y;
    tot[4 * q + 2] = t.z;
    tot[4 * q + 3] = t.w;
  }
}

// The damped 6x6 system solved as lm.solve_pose solve_fn / lm.lu_solve
// do: the damping, then LU with partial pivoting (the first row of largest
// magnitude pivots; whole rows swap), the column below scaled by the
// pivot's reciprocal, the unit lower solve subtracting in increasing order
// and the upper one in decreasing order.
__device__ __forceinline__ void damped_solve(const float (&H)[36], const float (&b)[6], float lam,
                                             bool strategy1, float (&x)[6]) {
  float A[6][6], y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = H[6 * i + j];
    const float d = H[7 * i];
    A[i][i] = (strategy1 ? d + lam * d : d + lam) + (fabsf(d) <= 1e-12f ? 1.0f : 0.0f);
    y[i] = b[i];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    float best = fabsf(A[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const float v = fabsf(A[i][j]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float aj = A[j][k], ai = A[i][k];
        A[j][k] = sw ? ai : aj;
        A[i][k] = sw ? aj : ai;
      }
      const float yj = y[j], yi = y[i];
      y[j] = sw ? yi : yj;
      y[i] = sw ? yj : yi;
    }
    const float r = 1.0f / A[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      A[i][j] = A[i][j] * r;
#pragma unroll
      for (int k = j + 1; k < 6; ++k) A[i][k] = A[i][k] - A[i][j] * A[j][k];
    }
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int i = q + 1; i < 6; ++i) y[i] = y[i] - A[i][q] * y[q];
  }
#pragma unroll
  for (int q = 5; q >= 0; --q) {
    x[q] = y[q] / A[q][q];
#pragma unroll
    for (int i = 0; i < q; ++i) y[i] = y[i] - A[i][q] * x[q];
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
  const float half = 0.5f * safe;
  // se3._rot_coeffs, its constant divisions as reciprocal multiplies
  // (rounding.div_const).  sinf is torch.sin's CUDA function; its slow
  // path for large arguments puts a stack frame here, which angles below
  // pi never enter.  Below the small angle the trig forms are not read
  // (the plain version computes and discards them).
  float sinc = 0.0f, sinc_half = 0.0f;
  if (!small) {
    sinc = sinf(safe) / safe;
    sinc_half = sinf(half) / half;
  }
  const float t4 = t2 * t2;
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) + t4 * (1.0f / 120.0f) : sinc;
  const float bb = small ? 0.5f - t2 * (1.0f / 24.0f) + t4 * (1.0f / 720.0f)
                         : 0.5f * sinc_half * sinc_half;
  const float c = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f) + t4 * (1.0f / 5040.0f)
                        : (1.0f - sinc) / (safe * safe);
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
  // se3.compose(Exp(dx), T), a 4x4 product with each product after the
  // first fused (rounding.small_matmul fused): row i of Exp(dx) is
  // (Re[i], te), T's last row (0, 0, 0, 1).
  float R[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = __fmaf_rn(te, 0.0f, __fmaf_rn(Re[i][2], T[6 + j], __fmaf_rn(Re[i][1], T[3 + j], Re[i][0] * T[j])));
    tn[i] = __fmaf_rn(te, 1.0f, __fmaf_rn(Re[i][2], T[11], __fmaf_rn(Re[i][1], T[10], Re[i][0] * T[9])));
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
  __shared__ float s_part[kChains];  // each chain's sum
  __shared__ float4 s_tot[11];       // the pass's 43 sums
  __shared__ float4 s_pose[3];  // the pose the next pass evaluates
  __shared__ int s_go;          // 0: s_pose is the round's result
  __shared__ int cnt[kWorkerWarps];
  const int tid = threadIdx.x;
  Edges ed{smem, smem + E, smem + 2 * E, smem + 3 * E, smem + 4 * E,
           reinterpret_cast<uint8_t*>(smem + 5 * E)};
  // The chunk's per-edge terms after the edges (16-byte aligned).
  float* cjw = smem + ((E * kEdgeBytes + 15) / 16) * 4;
  float* cJ = cjw + 12 * kChunk;
  float* cbt = cJ + 12 * kChunk;
  float* cm = cbt + 12 * kChunk;
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
    float Tc[12], cand[12], spec[12], H[36], b[6], dx[6], dx_spec[6], tot[44];
    copy12(T0, Tc);
    for (int rnd = 0; rnd < prm.outer; ++rnd) {
      bar_sync(kSumsReady);  // the workers evaluated T0
      gather_sums(s_tot, tot);
#pragma unroll
      for (int q = 0; q < 36; ++q) H[q] = tot[q];
#pragma unroll
      for (int a = 0; a < 6; ++a) b[a] = tot[36 + a];
      float chi = 0.5f * tot[42];
      copy12(T0, Tc);
      float lam;
      if (prm.strategy1) {
        lam = 1e-5f;
      } else if (prm.init_lambda >= 0.0f) {
        lam = prm.init_lambda;
      } else {
        float md = fabsf(H[0]);  // torch.max: a NaN wins
#pragma unroll
        for (int a = 1; a < 6; ++a) {
          const float v = fabsf(H[7 * a]);
          md = v > md || v != v ? v : md;
        }
        lam = prm.tau * clamp_max(md, prm.max_diag_cap);
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
          scale += dx[a] * ((prm.strategy1 ? lam * H[7 * a] * dx[a] : lam * dx[a]) + b[a]);
        scale = 0.5f * scale + 1e-10f;
        const float lam_rej = prm.strategy1 ? clamp_max(lam * 11.0f, 1e7f) : lam * ni;
        damped_solve(H, b, lam_rej, prm.strategy1, dx_spec);
        retract(Tc, dx_spec, spec);

        bar_sync(kSumsReady);
        gather_sums(s_tot, tot);
        ++attempts;
        // Evaluate the candidate (lm.py lm_optimize body).
        const float chi_n = 0.5f * tot[42];
        const float rho = (chi - chi_n) / scale;
        const bool accept = rho > 0.0f && scale > 0.0f && isfinite(chi_n);
        if (!accept) {
          lam = lam_rej;
          ni = prm.strategy1 ? ni : ni * 2.0f;
        } else if (prm.strategy1) {
          lam = clamp_min(lam * (1.0f / 9.0f), 1e-7f);
        } else {
          const float u = 2.0f * rho - 1.0f;
          const float alpha = clamp_max(1.0f - u * u * u, 2.0f / 3.0f);
          lam = lam * clamp_min(alpha, 1.0f / 3.0f);
          ni = 2.0f;
        }
        if (accept) {
#pragma unroll
          for (int q = 0; q < 36; ++q) H[q] = tot[q];
#pragma unroll
          for (int a = 0; a < 6; ++a) b[a] = tot[36 + a];
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
      if (prm.verification) copy12(Tc, T0);
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
      pass_sums(T, ed, E, use_mask, k, robust, prm.chi2_th, cjw, cJ, cbt, cm, s_part,
                reinterpret_cast<float*>(s_tot));
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
    // robust chi2 there (lm.py pose_edge_chi2), or their raw chi2 under
    // `verification`; no barrier: only the owner reads an edge's flag.
    if (prm.verification) copy12(T, T0);
    for (int e = wt; e < E; e += kWorkers) {
      float ru, rv, Ju[6], Jv[6], r0, r1, r2;
      edge_terms(T, ed.px[e], ed.py[e], ed.pz[e], ed.u[e], ed.v[e], k, ru, rv, Ju, Jv);
      const float e2 = ru * ru + rv * rv;
      huber(e2, robust, prm.chi2_th, r0, r1, r2);
      const bool out = prm.verification ? !(e2 <= prm.chi2_th) : r0 > prm.chi2_th;
      ed.flag[e] = (ed.flag[e] & kValid) | (out ? kOutlier : 0);
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
                                      int drop_kernel_after, int exclude_outliers, int verification, int strategy1,
                                      float tau, float max_diag_cap, float diff_chi_threshold,
                                      int false_cnt_threshold, float init_lambda, float* T_out,
                                      uint8_t* inlier, int* n_inliers, int* attempts,
                                      void* stream) {
  if (E < 0 || E > kMaxEdges || outer < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  static bool smem_raised = false;  // above 48 KB only after opting in, once per process
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(estimate_pose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)(kMaxEdges * kEdgeBytes + 16 + kChunkBytes));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const Intr k{fx, fy, cx, cy};
  LMParams prm{iterations, outer, drop_kernel_after, exclude_outliers, verification, strategy1,
               false_cnt_threshold, chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda};
  const size_t smem = ((E * kEdgeBytes + 15) / 16) * 16 + kChunkBytes;
  estimate_pose_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      T_init, p_world, uv, valid, E, k, prm, T_out, inlier, n_inliers, attempts);
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
