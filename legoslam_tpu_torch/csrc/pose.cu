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
// sequential: b's is a chain of 2E dependent adds, chi's of E, each add
// ~4 cycles, and they bound a pass from below.
//
// The design (one block of 12 warps, each warp one role):
// - Producers (warps 4..11) own the edges: chunk c of kChunk = 32 edges
//   belongs to producer c mod kProducers, its lane i to edge 32 c + i, for
//   the copy into shared memory (structure of arrays with a flag byte: bit 0
//   valid, bit 1 outlier of the last round), the per-edge terms of every
//   pass and the reclassification.  Only the owner reads or writes an
//   edge's copy, so none of that needs a barrier.  The copy holds as many
//   edges as the opt-in shared memory leaves beside the ring (some 6,700 on
//   an H100, `legoslam_pose_shared_edges`); above that a second
//   instantiation (kGlobal) reads each edge from the caller's arrays in
//   global memory in every pass (through the read-only cache; 16,384 edges
//   are 344 KB, which stay in L2), and the flags lie in a global scratch of
//   E bytes that the caller allocates.  Where an edge is stored changes no
//   sum: every order is set by the edge's index.
// - A pass writes each chunk's terms (rows of J^T W and J, the b terms, the
//   chi term) into a ring of kSlots slots in shared memory, laid out as the
//   chains read them: along k = 2e + j for b, along e for chi, and for each
//   lane l = k mod 4 of H along its own k; each chunk's chi terms first,
//   since chi alone decides an attempt.  The chain warps take the ring
//   a unit of four chunks (128 edges) at a time: mbarriers per unit hand it
//   from its producers to the three chain warps (chi_full after its chi
//   terms, full after the rest) and back (empty, one arrival per reading
//   lane), so a chain starts on unit
//   0 while later units are being written, waits only for the unit it
//   needs, and pays the hand-over's bookkeeping once per 128 edges, outside
//   its adds.
// - Chain warps: warp 1 carries b's six chains (one lane each, one 16-byte
//   load per four dependent adds), warp 3 chi's, warp 2 H's 144 chains (a
//   lane per (l, row a) with its six columns' chains side by side, the
//   lanes combined (l0 + l1) + (l2 + l3) by shuffles).  Each chain's
//   accumulator carries from chunk to chunk, so chunking changes no order.
//   The H and b warps publish their sums with a release store of the pass's
//   number (warp 0 reads them only after an acceptance).
// - Warp 0 holds the LM state and runs the serial step in registers: the
//   accept rule, the lambda schedule (Nielsen or strategy1), the stop
//   rules, the damped 6x6 LU with partial pivoting, the SE(3) exponential
//   and two Newton-polar SO(3) projections (geometry/se3.py).  All small
//   arrays are indexed with compile-time indices (fully unrolled loops, row
//   swaps as selects) so they stay in registers; the only stack frame is
//   sinf's slow path (see retract).
// - Chi alone decides an attempt, and chi's chain is half as long as b's.
//   After a rejection H, b and the pose stay and lambda moves by a fixed
//   rule, so warp 0 computes the candidate that follows a rejection while
//   the pass runs, publishes it as soon as chi rejects, and tells the H and
//   b warps to skip the rest of the pass.  After an acceptance it factors
//   the damped H as soon as H's sums are in and waits for b only for the
//   two triangular solves and the retraction.  The result is the serial
//   chain's, bit for bit.
// - Named barriers hand each new pose from warp 0 to the producers and
//   each pass's chi from the chi warp to warp 0 (faster than an mbarrier).
//   Chain warps waiting for a unit spin on
//   mbarrier.test_wait (idle otherwise, and it answers sooner than
//   try_wait's suspension).
//
// The number of LM attempts of each round goes to an optional output (the
// work count behind the bound).  Intrinsics are runtime arguments.  With
// `verification` (the loop closer's rounds) each round starts from the
// last round's pose, not the prior, and an edge stays where its raw chi2 is
// <= chi2_th (lm.estimate_pose).  scripts/pose_kernel_cycles.py builds this
// file with POSE_CYCLES defined to count cycles by phase (CYCLES_* below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef POSE_CYCLES
// Counted in shared memory (a global atomic before a release would hold
// the release up; 32-bit shared atomics are native, 64-bit ones are not)
// and added to the global array once, at the end.  The compiler does not
// keep a clock read in place around a barrier, so a span that ends at one
// is approximate.
__device__ unsigned long long g_cycles[17];
__shared__ unsigned int s_cycles[17];
#define CYCLES_START(t) const long long t = clock64()
#define CYCLES_ADD(slot, t) atomicAdd(&s_cycles[slot], (unsigned int)(clock64() - (t)))
#define CYCLES_COUNT(slot) atomicAdd(&s_cycles[slot], 1u)
#define CYCLES_INIT()                                          \
  do {                                                         \
    for (int q = threadIdx.x; q < 17; q += blockDim.x) s_cycles[q] = 0; \
  } while (0)
#define CYCLES_FLUSH()                                                                   \
  do {                                                                                   \
    for (int q = 0; q < 17; ++q) atomicAdd(&g_cycles[q], (unsigned long long)s_cycles[q]); \
  } while (0)
#else
#define CYCLES_START(t) [[maybe_unused]] const long long t = 0
#define CYCLES_ADD(slot, t) ((void)0)
#define CYCLES_COUNT(slot) ((void)0)
#define CYCLES_INIT() ((void)0)
#define CYCLES_FLUSH() ((void)0)
#endif

namespace {

constexpr int kCtrlWarp = 0, kBWarp = 1, kHWarp = 2, kChiWarp = 3, kFirstProducer = 4;
constexpr int kProducers = 8;
constexpr int kThreads = 32 * (kFirstProducer + kProducers);
constexpr size_t kEdgeBytes = 5 * sizeof(float) + 1;  // shared copy: 5 floats and a flag byte an edge
// The ring of chunks.  A slot: b's six rows along k (64 terms, padded so
// the six lanes' 16-byte loads fall in distinct banks), chi's row along e,
// then for each H lane l and row a the row of J^T W along that lane's k
// (16 terms), and for each l and column c the row of J (padded alike).
constexpr int kChunk = 32;
constexpr int kSlots = 16;
constexpr int kBRow = 2 * kChunk + 4;
constexpr int kHRow = kChunk / 2 + 4;
constexpr int kSlotB = 0, kSlotChi = 6 * kBRow, kSlotJw = kSlotChi + kChunk, kSlotJ = kSlotJw + 24 * kHRow;
constexpr int kSlotFloats = kSlotJ + 24 * kHRow;
constexpr size_t kRingBytes = size_t(kSlots) * kSlotFloats * sizeof(float);
// The chain warps take the ring a unit of kUnit chunks at a time: one
// full/empty pair of mbarriers a unit, so the hand-over's bookkeeping is
// paid once per 128 edges, outside the adds.
constexpr int kUnit = 4;
constexpr int kUnits = kSlots / kUnit;
// Named barriers (0 is __syncthreads): warp 0 hands each new pose to the
// producers (warp 0 arrives, they wait), the chi warp each pass's chi to
// warp 0 (the other way round); a named barrier hands over in about a
// third of the time an mbarrier takes.
constexpr int kPoseBar = 1, kPoseBarThreads = 32 * (1 + kProducers);
constexpr int kChiBar = 2, kChiBarThreads = 64;
constexpr uint8_t kValid = 1, kOutlier = 2;

struct Intr {
  float fx, fy, cx, cy;
};

struct LMParams {
  int iterations, outer, drop_kernel_after, exclude_outliers, verification, strategy1, false_cnt_threshold;
  float chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda;
};

// One pose-only edge at pose T (R row-major, t) (solver/reprojection.py
// pose_only_edge: project, then _pose_jacobian), in two halves: the
// residual, which chi needs, and the 2x6 Jacobian from the same X, Y, z.
struct EdgeAt {
  float X, Y, z, ru, rv;
};

__device__ __forceinline__ EdgeAt edge_residual(const float (&T)[12], float px, float py, float pz, float u, float v,
                                                const Intr& k) {
  EdgeAt a;
  a.X = T[0] * px + T[1] * py + T[2] * pz + T[9];
  a.Y = T[3] * px + T[4] * py + T[5] * pz + T[10];
  const float Z = T[6] * px + T[7] * py + T[8] * pz + T[11];
  a.z = Z + 1e-18f;
  a.ru = u - (k.fx * a.X / a.z + k.cx);
  a.rv = v - (k.fy * a.Y / a.z + k.cy);
  return a;
}

__device__ __forceinline__ void edge_jacobian(const EdgeAt& a, const Intr& k, float (&Ju)[6], float (&Jv)[6]) {
  const float X = a.X, Y = a.Y;
  const float zinv = 1.0f / a.z;
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

// (rho0, rho1, rho2) of solver/robust.py rho for HUBER or TRIVIAL, rho0
// apart: a producer computes chi's rho0 first.
__device__ __forceinline__ bool huber_linear(float e2, bool robust, float d) { return robust && !(e2 <= d * d); }

__device__ __forceinline__ float huber_rho0(float e2, bool robust, float d) {
  if (!huber_linear(e2, robust, d)) return e2;
  const float sqrte = sqrtf(clamp_min(e2, 1e-20f));
  return 2.0f * sqrte * d - d * d;
}

__device__ __forceinline__ void huber_rho12(float e2, bool robust, float d, float& r1, float& r2) {
  if (!huber_linear(e2, robust, d)) {
    r1 = 1.0f;
    r2 = 0.0f;
    return;
  }
  const float e2c = clamp_min(e2, 1e-20f);
  const float sqrte = sqrtf(e2c);
  r1 = d / sqrte;
  r2 = -0.5f * (d / sqrte) / e2c;
}

// The launch's edges: the copy in shared memory (structure of arrays), or
// under kGlobal the caller's p_world (E, 3) and uv (E, 2); the flags in
// shared memory or in the global scratch.
struct Edges {
  float *px, *py, *pz, *u, *v;
  const float *pw, *uv;
  uint8_t* flag;
};

struct EdgeIn {
  float px, py, pz, u, v;
};

template <bool kGlobal>
__device__ __forceinline__ EdgeIn load_edge(const Edges& ed, int e) {
  if constexpr (kGlobal) {
    return EdgeIn{__ldg(ed.pw + 3 * e), __ldg(ed.pw + 3 * e + 1), __ldg(ed.pw + 3 * e + 2), __ldg(ed.uv + 2 * e),
                  __ldg(ed.uv + 2 * e + 1)};
  } else {
    return EdgeIn{ed.px[e], ed.py[e], ed.pz[e], ed.u[e], ed.v[e]};
  }
}

// A producer lane's edge in a pass (lm.pose_pass), in two halves so that
// chi's chain starts before the Jacobians are done: produce_chi writes the
// edge's chi term rho (zero for an edge not in use or past the last) at i
// in the slot's chi row, produce_rest the b terms J_i rho' r_i on b[a]'s row
// at k = 2i + j, and for H lane l = 2 (i mod 2) + j the row j of J^T W and
// of J at position i / 2 in the lane's rows.
struct EdgePass {
  EdgeAt at;
  float e2;
  bool use;
};

template <bool kGlobal>
__device__ __forceinline__ EdgePass produce_chi(const float (&T)[12], const Edges& ed, int e, int E,
                                                uint8_t use_mask, const Intr& k, bool robust, float delta,
                                                float* slot, int i) {
  EdgePass p;
  p.use = e < E && (ed.flag[e] & use_mask) == kValid;
  float r0 = 0.0f;
  if (p.use) {
    const EdgeIn in = load_edge<kGlobal>(ed, e);
    p.at = edge_residual(T, in.px, in.py, in.pz, in.u, in.v, k);
    p.e2 = p.at.ru * p.at.ru + p.at.rv * p.at.rv;
    r0 = huber_rho0(p.e2, robust, delta);
  }
  slot[kSlotChi + i] = r0;
  return p;
}

__device__ __forceinline__ void produce_rest(const EdgePass& p, const Intr& k, bool robust, float delta,
                                             float* slot, int i) {
  float jw[12], J[12], bt[12];
  if (p.use) {
    const float ru = p.at.ru, rv = p.at.rv;
    float r1, r2, Ju[6], Jv[6];
    huber_rho12(p.e2, robust, delta, r1, r2);
    edge_jacobian(p.at, k, Ju, Jv);
    const bool keep = r1 + 2.0f * r2 * p.e2 > 1e-5f * r1;
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
  } else {
#pragma unroll
    for (int q = 0; q < 12; ++q) jw[q] = J[q] = bt[q] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a)
    *reinterpret_cast<float2*>(slot + kSlotB + a * kBRow + 2 * i) = make_float2(bt[a], bt[6 + a]);
  const int h = i & 1, pos = i >> 1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int row = (2 * h + j) * 6 + a;
      slot[kSlotJw + row * kHRow + pos] = jw[6 * j + a];
      slot[kSlotJ + row * kHRow + pos] = J[6 * j + a];
    }
}

// A sequential chain's group of kG float4, loaded, then added one at a time.
template <int kG>
__device__ __forceinline__ void load_group(const float* p, float4 (&q)[kG]) {
#pragma unroll
  for (int u = 0; u < kG; ++u) q[u] = reinterpret_cast<const float4*>(p)[u];
}

template <int kG>
__device__ __forceinline__ float add_group(float acc, const float4 (&q)[kG]) {
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    acc = acc + q[u].x;
    acc = acc + q[u].y;
    acc = acc + q[u].z;
    acc = acc + q[u].w;
  }
  return acc;
}

// H lane r = 6 l + a, group `grp` (positions 4 grp .. 4 grp + 3 of lane l's
// k in a chunk): four terms of J^T W's row a, and of J's six columns.
struct HGroup {
  float4 w, J[6];
};

__device__ __forceinline__ void load_h(const float* slot, int r, int grp, HGroup& g) {
  const int l = r / 6;
  g.w = reinterpret_cast<const float4*>(slot + kSlotJw + r * kHRow)[grp];
#pragma unroll
  for (int c = 0; c < 6; ++c) g.J[c] = reinterpret_cast<const float4*>(slot + kSlotJ + (6 * l + c) * kHRow)[grp];
}

// Lane l's chains of H[a][0..5], four steps in k order: fused multiply-adds.
__device__ __forceinline__ void add_h(float (&acc)[6], const HGroup& g) {
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = __fmaf_rn(g.w.x, g.J[c].x, acc[c]);
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = __fmaf_rn(g.w.y, g.J[c].y, acc[c]);
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = __fmaf_rn(g.w.z, g.J[c].z, acc[c]);
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = __fmaf_rn(g.w.w, g.J[c].w, acc[c]);
}

// H's four lanes of one entry, added as rounding.pose_sums adds them.
__device__ __forceinline__ float combine_lanes(float l0, float l1, float l2, float l3) {
  return (l0 + l1) + (l2 + l3);
}

// The damped 6x6 system solved as lm.solve_pose solve_fn / lm.lu_solve
// do: the damping, then LU with partial pivoting (the first row of largest
// magnitude pivots; whole rows swap), the column below scaled by the
// pivot's reciprocal, the unit lower solve subtracting in increasing order
// and the upper one in decreasing order.  lu_factor needs H alone, so warp
// 0 runs it before b's chain ends; lu_solve replays the row swaps on b.
__device__ __forceinline__ void lu_factor(const float (&H)[36], float lam, bool strategy1, float (&A)[6][6],
                                          int (&piv)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = H[6 * i + j];
    const float d = H[7 * i];
    A[i][i] = (strategy1 ? d + lam * d : d + lam) + (fabsf(d) <= 1e-12f ? 1.0f : 0.0f);
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
    piv[j] = p;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float aj = A[j][k], ai = A[i][k];
        A[j][k] = sw ? ai : aj;
        A[i][k] = sw ? aj : ai;
      }
    }
    const float r = 1.0f / A[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      A[i][j] = A[i][j] * r;
#pragma unroll
      for (int k = j + 1; k < 6; ++k) A[i][k] = A[i][k] - A[i][j] * A[j][k];
    }
  }
}

__device__ __forceinline__ void lu_solve(const float (&A)[6][6], const int (&piv)[6], const float (&b)[6],
                                         float (&x)[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = b[i];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const bool sw = piv[j] == i;
      const float yj = y[j], yi = y[i];
      y[j] = sw ? yi : yj;
      y[i] = sw ? yj : yi;
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

__device__ __forceinline__ void damped_solve(const float (&H)[36], const float (&b)[6], float lam,
                                             bool strategy1, float (&x)[6]) {
  float A[6][6];
  int piv[6];
  lu_factor(H, lam, strategy1, A, piv);
  lu_solve(A, piv, b, x);
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

// --- Synchronisation --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Has the phase of parity `parity` completed?  Does not block.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

// Warp 0 waits until a chain warp has published pass `pass`'s sums.
__device__ __forceinline__ void wait_tag(const int* tag, int pass) {
  while (ld_acquire(tag) < pass) {
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(n) : "memory");
}

// Wait for a phase by testing it again and again: the warps that spin are
// idle otherwise, and a test answers sooner than try_wait's suspension.
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity) {
  while (!mbar_test(bar, parity)) {
  }
}

// Ring chunk g lies in slot g mod kSlots, unit g / kUnit; a unit's slot in
// the ring and the parity of its turn there.
__device__ __forceinline__ uint32_t unit_slot(uint32_t u) { return u % kUnits; }
__device__ __forceinline__ uint32_t unit_parity(uint32_t u) { return (u / kUnits) & 1; }
__device__ __forceinline__ const float* unit_base(const float* ring, uint32_t u) {
  return ring + unit_slot(u) * kUnit * kSlotFloats;
}

// The ring and the state the warps share.
struct Shared {
  // Per unit: chi_full and full, the kUnit producers' arrivals after its
  // chi terms and after the rest; empty, the kReaders lanes' releases.
  uint64_t chi_full[kUnits], full[kUnits], empty[kUnits];
  float4 pose[3];  // the pose the next pass evaluates
  float H[36], b[6], chi;
  int go;          // 0: pose is the round's result
  int end;         // set with the ring's last unit: the chain warps leave
  int skip;        // the newest pass whose H and b warp 0 will not read
  int tag_h, tag_b;  // the newest pass whose sums are published
  int cnt[kProducers];
};

// Unit u's empty barrier counts one arrival from each lane that reads the
// ring (b's 6, H's 24, chi's 1): a lane releases the unit once its last
// loads of it are issued, and the release orders them before the arrival,
// so no warp-wide synchronisation is needed.
constexpr int kReaders = 6 + 24 + 1;
__device__ __forceinline__ void release(Shared& s, uint32_t u, bool active) {
  if (active) mbar_arrive(&s.empty[unit_slot(u)]);
}

// The rest of a pass whose H and b warp 0 will not read, units u to end:
// each is handed back once its producers are done (the ring's count of
// arrivals must stay in order).
__device__ __forceinline__ void drain(Shared& s, uint64_t* full, uint32_t u, uint32_t end, bool active) {
  for (; u < end; ++u) {
    mbar_spin(&full[unit_slot(u)], unit_parity(u));
    release(s, u, active);
  }
}

// Group j of a unit for a chain whose rows start at `row` in each slot,
// kGC groups of kG float4 a chunk.
template <int kG, int kGC>
__device__ __forceinline__ const float* unit_group(const float* base, int row, int j) {
  return base + (j / kGC) * kSlotFloats + row + (j % kGC) * 4 * kG;
}

// A sequential chain (b's rows, chi's) over the `nu` units of one pass
// from unit u on, unit u already complete.  Inside a unit there is no
// synchronisation, and each group's loads issue one group ahead of its
// adds (32 adds, more than a loaded word's latency); the next unit's first
// group is loaded before this unit's last adds when its producers are done
// (tested at the unit's start, so the test does not stall the adds).
// kWaitSlot: the cycle counter of the warp's waits for a unit.
template <int kG, int kGC, int kWaitSlot, bool kSkippable>
__device__ __forceinline__ float seq_chain_pass(const float* ring, int row, bool active, Shared& s, uint64_t* full,
                                                uint32_t u, int nu, int pass) {
  constexpr int kNG = kUnit * kGC;  // groups a unit (even)
  const uint32_t end = u + nu;
  float acc = 0.0f;
  float4 X[2][kG] = {};  // zeros in the lanes that load nothing
  if (active) load_group<kG>(unit_group<kG, kGC>(unit_base(ring, u), row, 0), X[0]);
  for (; u < end; ++u) {
    const bool more = u + 1 < end;
    const bool ready = more && mbar_test(&full[unit_slot(u + 1)], unit_parity(u + 1));
    const int skip_from = kSkippable ? *reinterpret_cast<volatile int*>(&s.skip) : -1;
    const float* cur = unit_base(ring, u);
    const float* nxt = unit_base(ring, u + 1);
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      if (j + 1 < kNG) {
        if (active) load_group<kG>(unit_group<kG, kGC>(cur, row, j + 1), X[(j + 1) & 1]);
      } else {
        release(s, u, active);  // this unit's loads are all issued
        if (ready && active) load_group<kG>(unit_group<kG, kGC>(nxt, row, 0), X[0]);
      }
      acc = add_group<kG>(acc, X[j & 1]);
    }
    if (kSkippable && skip_from >= pass) {
      drain(s, full, u + 1, end, active);
      break;
    }
    if (more && !ready) {
      CYCLES_START(t0);
      mbar_spin(&full[unit_slot(u + 1)], unit_parity(u + 1));
      if ((threadIdx.x & 31) == 0) CYCLES_ADD(kWaitSlot, t0);
      if (active) load_group<kG>(unit_group<kG, kGC>(nxt, row, 0), X[0]);
    }
  }
  return acc;
}

// H's chains over one pass, as seq_chain_pass with four groups a chunk,
// each loaded kHDepth - 1 groups ahead of its fused multiply-adds.
constexpr int kHDepth = 2;
__device__ __forceinline__ void h_chain_pass(const float* ring, int r, bool active, Shared& s, uint32_t u, int nu,
                                             int pass, float (&acc)[6]) {
  constexpr int kNG = kUnit * 4;
  static_assert(kNG % kHDepth == 0, "the next unit's groups must land in the buffers its first groups read");
  const uint32_t end = u + nu;
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = 0.0f;
  HGroup X[kHDepth] = {};
  const float* base = unit_base(ring, u);
#pragma unroll
  for (int d = 0; d + 1 < kHDepth; ++d)
    if (active) load_h(base + (d / 4) * kSlotFloats, r, d % 4, X[d]);
  for (; u < end; ++u) {
    const bool more = u + 1 < end;
    const bool ready = more && mbar_test(&s.full[unit_slot(u + 1)], unit_parity(u + 1));
    const int skip_from = *reinterpret_cast<volatile int*>(&s.skip);
    const float* cur = unit_base(ring, u);
    const float* nxt = unit_base(ring, u + 1);
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      const int jl = j + kHDepth - 1;  // the group loaded now
      if (jl < kNG) {
        if (active) load_h(cur + (jl / 4) * kSlotFloats, r, jl % 4, X[jl % kHDepth]);
      } else {
        if (jl == kNG) release(s, u, active);  // this unit's loads are all issued
        if (ready && active) load_h(nxt + ((jl - kNG) / 4) * kSlotFloats, r, (jl - kNG) % 4, X[jl % kHDepth]);
      }
      add_h(acc, X[j % kHDepth]);
    }
    if (skip_from >= pass) {
      drain(s, s.full, u + 1, end, active);
      break;
    }
    if (more && !ready) {
      CYCLES_START(t0);
      mbar_spin(&s.full[unit_slot(u + 1)], unit_parity(u + 1));
      if ((threadIdx.x & 31) == 0) CYCLES_ADD(4, t0);
#pragma unroll
      for (int d = 0; d + 1 < kHDepth; ++d)
        if (active) load_h(nxt + (d / 4) * kSlotFloats, r, d % 4, X[d]);
    }
  }
}

__device__ __forceinline__ void publish(const float (&T)[12], bool go, Shared& s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) s.pose[q] = make_float4(T[4 * q], T[4 * q + 1], T[4 * q + 2], T[4 * q + 3]);
    s.go = go ? 1 : 0;
  }
  bar_arrive(kPoseBar, kPoseBarThreads);
}

__device__ __forceinline__ void skip_pass(Shared& s, int pass) {
  if (threadIdx.x == 0) *reinterpret_cast<volatile int*>(&s.skip) = pass;
}

template <bool kGlobal>
__device__ __forceinline__ void estimate_pose_body(
    const float* __restrict__ T_init, const float* __restrict__ pw, const float* __restrict__ uv,
    const uint8_t* __restrict__ valid, int E, Intr k, LMParams prm, float* __restrict__ T_out,
    uint8_t* __restrict__ inlier, int* __restrict__ n_inliers, int* __restrict__ attempts_out,
    uint8_t* __restrict__ flag_scratch) {
  extern __shared__ float4 smem4[];  // 16-byte aligned: the ring's loads are float4
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ Shared s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Edges ed{nullptr, nullptr, nullptr, nullptr, nullptr, pw, uv, flag_scratch};
  float* ring = smem;
  if constexpr (!kGlobal) {
    ed = Edges{smem, smem + E, smem + 2 * E, smem + 3 * E, smem + 4 * E, pw, uv,
               reinterpret_cast<uint8_t*>(smem + 5 * E)};
    ring = smem + ((E * kEdgeBytes + 15) / 16) * 4;  // the ring after the edges (16-byte aligned)
  }
  // Units a pass (E = 0: one unit of zeros); the chunks past E hold zeros.
  const int nu = E > 0 ? (E + kUnit * kChunk - 1) / (kUnit * kChunk) : 1;
  const int nch = nu * kUnit;
  if (tid == 0) {
    for (int q = 0; q < kUnits; ++q) {
      mbar_init(&s.chi_full[q], kUnit);
      mbar_init(&s.full[q], kUnit);
      mbar_init(&s.empty[q], kReaders);
    }
    s.end = 0;
    s.skip = s.tag_h = s.tag_b = -1;
  }
  CYCLES_INIT();
  __syncthreads();
  // An edge is in use if valid, and in rounds after the first, not an outlier.
  const uint8_t use_mask = prm.exclude_outliers ? (kValid | kOutlier) : kValid;
  float T0[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T0[3 * i + j] = T_init[4 * i + j];
    T0[9 + i] = T_init[4 * i + 3];
  }

  if (warp == kCtrlWarp) {
    // Warp 0: the LM chain, the same in each lane.  Passes are numbered in
    // the order the producers run them: each round's first, then one per
    // candidate published.
    float Tc[12], cand[12], spec[12], H[36], b[6], dx[6], dx_spec[6], A[6][6];
    int piv[6];
    int pass = 0;
    for (int rnd = 0; rnd < prm.outer; ++rnd, ++pass) {
      // The round's first pass evaluates T0.
      bar_sync(kChiBar, kChiBarThreads);
      float chi = 0.5f * s.chi;
      wait_tag(&s.tag_h, pass);
#pragma unroll
      for (int q = 0; q < 36; ++q) H[q] = s.H[q];
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
      bool keep_going = it < prm.iterations;
      if (keep_going) {
        lu_factor(H, lam, prm.strategy1, A, piv);
        wait_tag(&s.tag_b, pass);
#pragma unroll
        for (int a = 0; a < 6; ++a) b[a] = s.b[a];
        lu_solve(A, piv, b, dx);
        retract(Tc, dx, cand);
      } else {
        skip_pass(s, pass);
      }
      while (keep_going) {
        CYCLES_START(t_pass);
        publish(cand, true, s);
        ++pass;
        // While the workers evaluate cand: its predicted decrease, and the
        // candidate that follows if it is rejected.
        CYCLES_START(t_spec);
        float scale = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a)
          scale += dx[a] * ((prm.strategy1 ? lam * H[7 * a] * dx[a] : lam * dx[a]) + b[a]);
        scale = 0.5f * scale + 1e-10f;
        const float lam_rej = prm.strategy1 ? clamp_max(lam * 11.0f, 1e7f) : lam * ni;
        damped_solve(H, b, lam_rej, prm.strategy1, dx_spec);
        retract(Tc, dx_spec, spec);
        if (tid == 0) CYCLES_ADD(12, t_spec);

        CYCLES_START(t_chi);
        bar_sync(kChiBar, kChiBarThreads);
        if (tid == 0) CYCLES_ADD(9, t_chi);
        ++attempts;
        // Evaluate the candidate (lm.py lm_optimize body).
        const float chi_n = 0.5f * s.chi;
        const float rho = (chi - chi_n) / scale;
        const bool accept = rho > 0.0f && scale > 0.0f && isfinite(chi_n);
        if (!accept) {
          if (tid == 0) CYCLES_COUNT(16);
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
          copy12(cand, Tc);
          chi = chi_n;
        }
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
        if (accept && keep_going) {
          // The next candidate from this pass's H and b.
          wait_tag(&s.tag_h, pass);
#pragma unroll
          for (int q = 0; q < 36; ++q) H[q] = s.H[q];
          lu_factor(H, lam, prm.strategy1, A, piv);
          CYCLES_START(t_b);
          wait_tag(&s.tag_b, pass);
          if (tid == 0) CYCLES_ADD(10, t_b);
          CYCLES_START(t_step);
#pragma unroll
          for (int a = 0; a < 6; ++a) b[a] = s.b[a];
          lu_solve(A, piv, b, dx);
          retract(Tc, dx, cand);
          if (tid == 0) {
            CYCLES_ADD(11, t_step);
            CYCLES_COUNT(13);
          }
        } else {
          skip_pass(s, pass);  // H and b of this pass are not needed
          if (keep_going) {
#pragma unroll
            for (int a = 0; a < 6; ++a) dx[a] = dx_spec[a];
            copy12(spec, cand);
          }
        }
        if (tid == 0) CYCLES_ADD(14, t_pass);
      }
      publish(Tc, false, s);
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
      for (int w = 0; w < kProducers; ++w) total += s.cnt[w];
      *n_inliers = total;
      CYCLES_FLUSH();
    }
    return;
  }

  if (warp < kFirstProducer) {
    // A chain warp: pass after pass until the producers close the ring.
    // H lane r = 6 l + a, b's row a: lanes past them load nothing (fewer
    // shared-memory wavefronts) and add what their registers hold.
    const int hr = lane < 24 ? lane : 23, ba = lane < 6 ? lane : 5;
    uint64_t* full = warp == kChiWarp ? s.chi_full : s.full;  // chi reads its row before the rest is written
    uint32_t u = 0;
    for (int pass = 0;; ++pass, u += nu) {
      mbar_spin(&full[unit_slot(u)], unit_parity(u));
      if (*reinterpret_cast<volatile int*>(&s.end)) break;
      CYCLES_START(t0);
      if (warp == kBWarp) {
        const float acc = seq_chain_pass<8, 2, 3, true>(ring, kSlotB + ba * kBRow, lane < 6, s, full, u, nu, pass);
        if (lane < 6) s.b[lane] = -acc;
        __syncwarp();
        if (lane == 0) {
          st_release(&s.tag_b, pass);
          CYCLES_ADD(6, t0);
        }
      } else if (warp == kChiWarp) {
        const float acc = seq_chain_pass<8, 1, 5, false>(ring, kSlotChi, lane == 0, s, full, u, nu, pass);
        if (lane == 0) s.chi = acc;
        bar_arrive(kChiBar, kChiBarThreads);  // the whole warp: bar.arrive is warp-aligned
        if (lane == 0) CYCLES_ADD(8, t0);
      } else if (warp == kHWarp) {
        float acc[6];
        h_chain_pass(ring, hr, lane < 24, s, u, nu, pass, acc);
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float l1 = __shfl_sync(0xffffffffu, acc[c], lane + 6);
          const float l2 = __shfl_sync(0xffffffffu, acc[c], lane + 12);
          const float l3 = __shfl_sync(0xffffffffu, acc[c], lane + 18);
          if (lane < 6) s.H[6 * lane + c] = combine_lanes(acc[c], l1, l2, l3);
        }
        __syncwarp();
        if (lane == 0) {
          st_release(&s.tag_h, pass);
          CYCLES_ADD(7, t0);
        }
      }
    }
    __syncthreads();
    return;
  }

  // Producers: producer p owns chunks p, p + kProducers, ... of each pass.
  const int p = warp - kFirstProducer;
  for (int c = p; c < nch; c += kProducers) {
    const int e = kChunk * c + lane;
    if (e < E) {
      if constexpr (!kGlobal) {
        ed.px[e] = pw[3 * e];
        ed.py[e] = pw[3 * e + 1];
        ed.pz[e] = pw[3 * e + 2];
        ed.u[e] = uv[2 * e];
        ed.v[e] = uv[2 * e + 1];
      }
      ed.flag[e] = valid[e] ? kValid : 0;
    }
  }
  float T[12];
  int g0 = 0;  // the ring chunk of the pass's chunk 0
  for (int rnd = 0; rnd < prm.outer; ++rnd) {
    const bool robust = rnd <= prm.drop_kernel_after;
    copy12(T0, T);  // each round starts from the prior
    while (true) {
      for (int c = p; c < nch; c += kProducers) {
        const uint32_t g = g0 + c, u = g / kUnit;
        CYCLES_START(t_empty);
        mbar_spin(&s.empty[unit_slot(u)], unit_parity(u) ^ 1);
        if (lane == 0) CYCLES_ADD(1, t_empty);
        CYCLES_START(t_terms);
        float* slot = ring + (g % kSlots) * kSlotFloats;
        const EdgePass ep = produce_chi<kGlobal>(T, ed, kChunk * c + lane, E, use_mask, k, robust, prm.chi2_th, slot, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.chi_full[unit_slot(u)]);
        produce_rest(ep, k, robust, prm.chi2_th, slot, lane);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&s.full[unit_slot(u)]);
          CYCLES_ADD(0, t_terms);
          CYCLES_COUNT(15);
        }
      }
      g0 += nch;
      CYCLES_START(t_pose);
      bar_sync(kPoseBar, kPoseBarThreads);
      if (p == 0 && lane == 0) CYCLES_ADD(2, t_pose);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = s.pose[q];
        T[4 * q] = v.x;
        T[4 * q + 1] = v.y;
        T[4 * q + 2] = v.z;
        T[4 * q + 3] = v.w;
      }
      if (!s.go) break;
    }
    // T is the round's pose.  Reclassify the owned edges by their unmasked
    // robust chi2 there (lm.py pose_edge_chi2), or their raw chi2 under
    // `verification`; no barrier: only the owner reads an edge's flag.
    if (prm.verification) copy12(T, T0);
    for (int c = p; c < nch; c += kProducers) {
      const int e = kChunk * c + lane;
      if (e >= E) continue;
      const EdgeIn in = load_edge<kGlobal>(ed, e);
      const EdgeAt a = edge_residual(T, in.px, in.py, in.pz, in.u, in.v, k);
      const float e2 = a.ru * a.ru + a.rv * a.rv;
      const float r0 = huber_rho0(e2, robust, prm.chi2_th);
      const bool out = prm.verification ? !(e2 <= prm.chi2_th) : r0 > prm.chi2_th;
      ed.flag[e] = (ed.flag[e] & kValid) | (out ? kOutlier : 0);
    }
  }
  if (p == 0) {
    // Close the ring: one more chunk, which tells the chain warps to leave.
    const uint32_t u = g0 / kUnit;
    mbar_spin(&s.empty[unit_slot(u)], unit_parity(u) ^ 1);
    if (lane == 0) {
      *reinterpret_cast<volatile int*>(&s.end) = 1;
      mbar_arrive_n(&s.chi_full[unit_slot(u)], kUnit);
      mbar_arrive_n(&s.full[unit_slot(u)], kUnit);
    }
  }
  int cnt = 0;
  for (int c = p; c < nch; c += kProducers) {
    const int e = kChunk * c + lane;
    if (e >= E) continue;
    const uint8_t in = ed.flag[e] == kValid ? 1 : 0;
    inlier[e] = in;
    cnt += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) s.cnt[p] = cnt;
  __syncthreads();
}

// Two entries of one body: tracking's and the loop verifier's
// (`verification`), under names of their own, so a profiler's trace tells
// the verifier's launches from tracking's.
#define POSE_ENTRY(name)                                                                                    \
  template <bool kGlobal>                                                                                   \
  __global__ void __launch_bounds__(kThreads, 1) name(                                                      \
      const float* __restrict__ T_init, const float* __restrict__ pw, const float* __restrict__ uv,         \
      const uint8_t* __restrict__ valid, int E, Intr k, LMParams prm, float* __restrict__ T_out,            \
      uint8_t* __restrict__ inlier, int* __restrict__ n_inliers, int* __restrict__ attempts_out,            \
      uint8_t* __restrict__ flag_scratch) {                                                                 \
    estimate_pose_body<kGlobal>(T_init, pw, uv, valid, E, k, prm, T_out, inlier, n_inliers, attempts_out,   \
                                flag_scratch);                                                              \
  }
POSE_ENTRY(estimate_pose_kernel)
POSE_ENTRY(loop_verify_pose_kernel)
#undef POSE_ENTRY

// Per device: the edges the shared copy holds, what the opt-in shared
// memory per block leaves beside the static block and the ring; each
// entry's two instantiations are allowed their dynamic shared memory once.
constexpr int kMaxDevices = 64;

cudaError_t shared_edges(int* capacity) {
  static int cap[kMaxDevices] = {};
  static bool ready[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, estimate_pose_kernel<false>);
    cudaFuncAttributes fv;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fv, loop_verify_pose_kernel<false>);
    if (err != cudaSuccess) return err;
    const long dynamic = (long)optin - (long)(fa.sharedSizeBytes > fv.sharedSizeBytes ? fa.sharedSizeBytes
                                                                                       : fv.sharedSizeBytes);
    const long room = ((dynamic - (long)kRingBytes) / 16) * 16;  // the edges are padded to 16 bytes
    if (room < 0) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(estimate_pose_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dynamic);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(loop_verify_pose_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dynamic);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(estimate_pose_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kRingBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(loop_verify_pose_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kRingBytes);
    if (err != cudaSuccess) return err;
    cap[dev] = (int)(room / (long)kEdgeBytes);
    ready[dev] = true;
  }
  *capacity = cap[dev];
  return cudaSuccess;
}

}  // namespace

// The most edges a launch keeps in shared memory on the current device;
// above it the caller passes a scratch of E bytes.
extern "C" int legoslam_pose_shared_edges(int* capacity) { return (int)shared_edges(capacity); }

extern "C" int legoslam_estimate_pose(const float* T_init, const float* p_world, const float* uv,
                                      const uint8_t* valid, int E, float fx, float fy, float cx,
                                      float cy, float chi2_th, int iterations, int outer,
                                      int drop_kernel_after, int exclude_outliers, int verification, int strategy1,
                                      float tau, float max_diag_cap, float diff_chi_threshold,
                                      int false_cnt_threshold, float init_lambda, float* T_out,
                                      uint8_t* inlier, int* n_inliers, int* attempts, uint8_t* flag_scratch,
                                      void* stream) {
  if (E < 0 || outer < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  int capacity;
  const cudaError_t err = shared_edges(&capacity);
  if (err != cudaSuccess) return (int)err;
  const bool global = E > capacity;
  if (global && flag_scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Intr k{fx, fy, cx, cy};
  LMParams prm{iterations, outer, drop_kernel_after, exclude_outliers, verification, strategy1,
               false_cnt_threshold, chi2_th, tau, max_diag_cap, diff_chi_threshold, init_lambda};
  const size_t smem = global ? kRingBytes : ((E * kEdgeBytes + 15) / 16) * 16 + kRingBytes;
  uint8_t* scratch = global ? flag_scratch : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (verification && global) {
    loop_verify_pose_kernel<true><<<1, kThreads, smem, st>>>(T_init, p_world, uv, valid, E, k, prm, T_out, inlier,
                                                             n_inliers, attempts, scratch);
  } else if (verification) {
    loop_verify_pose_kernel<false><<<1, kThreads, smem, st>>>(T_init, p_world, uv, valid, E, k, prm, T_out,
                                                              inlier, n_inliers, attempts, scratch);
  } else if (global) {
    estimate_pose_kernel<true><<<1, kThreads, smem, st>>>(T_init, p_world, uv, valid, E, k, prm, T_out, inlier,
                                                          n_inliers, attempts, scratch);
  } else {
    estimate_pose_kernel<false><<<1, kThreads, smem, st>>>(T_init, p_world, uv, valid, E, k, prm, T_out, inlier,
                                                           n_inliers, attempts, scratch);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* legoslam_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
