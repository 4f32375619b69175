// The SQP stage QPs of the nonlinear planners, hand-written for Hopper
// (sm_90a), FP32 on CUDA cores (FP64 where the plain version's forward-mode
// tangents are FP64): one launch builds every stage QP of one SQP iteration.
//
// Replaces no Pallas kernel. In JAX these builds are plain XLA, fused by
// jit around the solver:
// * cmpc_nl_qp: colaborativempc_tpu/planners/nl.py:80-94 _linearize_horizon
//   (jax.jacfwd of the Euler-discretised bicycle under vmap) and :97
//   build_nl_qp (the [x; u_prev] lift of planners/lpv.py:83-95, the track
//   lookups of geometry/frenet.py, the cost and every row, for the eu, hp
//   and hp_opt couplings);
// * cmpc_mpcc_qp: colaborativempc_tpu/planners/mpcc.py:132 build_mpcc_qp
//   with dynamics/pacejka.py:110 linearize_pacejka and the tyre-row jacfwd
//   of mpcc.py:215-221.
// The port's plain versions (planners/nl.py build_nl_qp_plain,
// planners/mpcc.py build_mpcc_qp_plain) run these as eager torch: several
// hundred small launches per build (the Jacobians' ~60 elementwise ops and
// stacks, ~40 slice assignments, torch.func's vmap of jacfwd twice for
// MPCC).
//
// What bounds it on the H100. Each build reads a few floats per stage and
// writes every field of the StageQP, ~1.7 KB per stage (NL eu: nz=11, nc=2,
// m=6): at the NL Monte-Carlo's 192 QPs x N=20, ~6.5 MB, 2 us at 3.35 TB/s;
// a few hundred FP32 operations per stage are far below that. So the bound
// is bytes, and at these sizes the real time is the launch and one pass of
// dependent arithmetic per stage.
//
// What the design does about it.
// * One block per 8 stages of one problem (grid: stage groups x problems),
//   4 warps. Phase 1: each warp builds one stage at a time, with its lanes
//   spread over the stage's pieces (NL: lane i the row i of the Jacobians
//   and of the discrete model; MPCC: lane j the Jacobian column j, i.e. one
//   forward-mode tangent), into a compact record in shared memory.
//   Phase 2: the block's 128 threads write each output field of its 8
//   stages as one contiguous range, neighbouring threads on neighbouring
//   addresses, so the stores coalesce; no thread writes a stage alone.
// * Order of operations: bit for bit the plain version's on the card. Every
//   operation is an explicit round-to-nearest intrinsic in the plain
//   version's order, so nvcc contracts nothing into an FMA it did not have.
//   PyTorch's CUDA ops are followed where they differ from the obvious: a
//   tensor divided by a Python number is multiplied by the float32
//   reciprocal; 1 / t is a correctly rounded reciprocal; maximum, minimum
//   and clamp propagate NaN; searchsorted's upper bound sends NaN past the
//   last segment. The batched matrix-vector products (A x, Ad x, Bd u, the
//   tyre rows' gx x and gu u) follow the card's cuBLAS order, read off this
//   build (scripts/matvec_order.py). It depends on the layout (the NL
//   matrices are row-major, torch.func's MPCC Jacobians column-major) and
//   on the batch size, so the wrapper names it per build (MatvecOrder
//   below); every term is taken, zero coefficients included, so NaN
//   spreads as in the library.
// * MPCC's Jacobians are the forward-mode tangents that torch.func.jacfwd
//   computes, rule by rule (atan2, atan, sin, cos, maximum with a halved
//   tangent at a tie, mul, div), with their dtypes: a tangent that meets a
//   Python number turns float64 (the number's zero tangent is a 0-dim
//   float64 tensor), so those parts run in double and are rounded to
//   float32 once at the end, as `.to(x.dtype)` does.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrappers (ops/cuda_sqp.py) check. Plain C interface for ctypes: arrays of
// device pointers, of double constants and of ints; the entry launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 8;  // stages per block
constexpr int kNX = 9, kNZ = 11;

// The orders of the card's batched matrix-vector products (ops/cuda_sqp.py
// matvec_order picks one per build): two fused multiply-add chains from
// zero over the halves [0, ceil(n/2)) and the rest, or over the even and
// the odd terms, then their sum; or chains over the quarters [0, 4), [4,
// 8), [8, ...) summed as a butterfly, (q0 + q2) + (q1 + q3).
enum MatvecOrder { kHalves = 0, kEvenOdd = 1, kQuarters = 2 };

// ---- rounding-explicit helpers -------------------------------------------

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.maximum / torch.minimum / clamp: NaN in, NaN out
__device__ __forceinline__ float nanmax(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float nanmin(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// sum over l in [l0, l1) step dl of a[l] x[l], one fused multiply-add per
// term from zero
__device__ __forceinline__ float fma_chain(const float* a, const float* x,
                                           int l0, int l1, int dl) {
  float acc = 0.f;
  for (int l = l0; l < l1; l += dl) acc = fmaf(a[l], x[l], acc);
  return acc;
}

// A row a . x of n terms (n <= 12) in the card's batched order `order`.
__device__ __forceinline__ float mv(const float* a, const float* x, int n,
                                    int order) {
  if (order == kHalves) {
    const int h = (n + 1) / 2;
    return fadd(fma_chain(a, x, 0, h, 1), fma_chain(a, x, h, n, 1));
  }
  if (order == kEvenOdd)
    return fadd(fma_chain(a, x, 0, n, 2), fma_chain(a, x, 1, n, 2));
  float q[4];
  for (int c = 0; c < 4; ++c)
    q[c] = fma_chain(a, x, 4 * c, min(n, 4 * c + 4), 1);
  return fadd(fadd(q[0], q[2]), fadd(q[1], q[3]));
}

// ---- the track lookups (geometry/frenet.py) -------------------------------

struct TrackArgs {
  const float *s0, *curv, *hw, *length;  // (lanes, nseg) x3, (lanes,)
  const unsigned char* open;             // scalar bool
  int nseg;
};

// Segment of arc length s on a lane: wrap_s (clamp at 0 keeping NaN, then
// the closed track's remainder or the open track's one-lap subtraction),
// searchsorted(right=True) as torch's upper bound, clamp(idx - 1).
__device__ inline int segment(const TrackArgs& t, int lane, float s) {
  const float L = t.length[lane];
  const float s1 = isnan(s) ? s : fmaxf(s, 0.f);
  float sw;
  if (*t.open) {
    sw = (s1 >= L) ? fsub(s1, L) : s1;
  } else {
    float mod = fmodf(s1, L);
    if (mod != 0.f && ((L < 0.f) != (mod < 0.f))) mod = fadd(mod, L);
    sw = mod;
  }
  const float* row = t.s0 + (size_t)lane * t.nseg;
  int start = 0, end = t.nseg;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(row[mid] > sw)) start = mid + 1;
    else end = mid;
  }
  const int idx = start - 1;
  return idx < 0 ? 0 : (idx > t.nseg - 1 ? t.nseg - 1 : idx);
}

// ---- the stage record in shared memory ------------------------------------

// Floats of one stage's record: Ad (9x9), Bd (9x2), rd (9), the rows' D
// (m x 11) and E (m x nc), lo, hi, soft_lo, soft_hi (m each), q (11), r
// (nc), and 32 words of scratch.
__host__ __device__ inline int record_floats(int nc, int m) {
  return 81 + 18 + 9 + m * (kNZ + nc + 4) + kNZ + nc + 32;
}

struct Rec {
  float *Ad, *Bd, *rd, *D, *E, *lo, *hi, *slo, *shi, *q, *r, *scr;
};

__device__ inline Rec rec_at(float* base, int i, int nc, int m) {
  Rec s;
  float* p = base + (size_t)i * record_floats(nc, m);
  s.Ad = p;  p += 81;
  s.Bd = p;  p += 18;
  s.rd = p;  p += 9;
  s.D = p;   p += m * kNZ;
  s.E = p;   p += m * nc;
  s.lo = p;  p += m;
  s.hi = p;  p += m;
  s.slo = p; p += m;
  s.shi = p; p += m;
  s.q = p;   p += kNZ;
  s.r = p;   p += nc;
  s.scr = p;
  return s;
}

// Row i of the lifted dynamics: F = [[Ad, Bd], [0, I]], G = [[Bd, 0], [I,
// 0]] (the extra columns of hp_opt's plane controls are zero).
__device__ __forceinline__ float F_entry(const Rec& s, int i, int c) {
  if (i < kNX) return c < kNX ? s.Ad[i * kNX + c] : s.Bd[i * 2 + c - kNX];
  return (c == i) ? 1.f : 0.f;
}
__device__ __forceinline__ float G_entry(const Rec& s, int i, int c) {
  if (c >= 2) return 0.f;
  if (i < kNX) return s.Bd[i * 2 + c];
  return (c == i - kNX) ? 1.f : 0.f;
}

struct Out {
  float *F, *G, *d, *Q, *q, *R, *r, *S, *D, *E, *lo, *hi, *slo, *shi;
};

// Per-problem scalars (gains, limits), each a number shared by every
// problem or an entry of a tensor: ptr[i] points at problem 0's entry and
// stride[i] steps to the next problem (0: shared); a null ptr[i] stands
// for value[i]. The wrapper fills them without packing a tensor.
constexpr int kNLSlots = 16 + 9, kMPCCSlots = 10;

template <int K>
struct Slots {
  const float* ptr[K];
  int stride[K];
  float value[K];
  __device__ __forceinline__ float get(int i, int p) const {
    return ptr[i] ? ptr[i][(size_t)p * stride[i]] : value[i];
  }
};

template <int K>
inline void slots_from(Slots<K>& s, void* const* ptrs, const int* strides,
                       const double* values) {
  for (int i = 0; i < K; ++i) {
    s.ptr[i] = (const float*)ptrs[i];
    s.stride[i] = strides[i];
    s.value[i] = (float)values[i];
  }
}

// Phase 2: the block's stages [k0, k0 + ns) of problem p, field by field,
// each field one contiguous range of the output.
__device__ void write_stages(const Out& o, float* recs, const float* Qdiag,
                             const float* Rdiag, int p, int k0, int ns,
                             int N, int nc, int m) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t st = (size_t)p * N + k0;         // (P, N, ...) fields
  const size_t st1 = (size_t)p * (N + 1) + k0 + 1;  // (P, N+1, ...) fields
#define CMPC_FIELD(ptr, base, size, expr)                        \
  for (int e = tid; e < ns * (size); e += nt) {                  \
    const int k = e / (size), o_ = e - k * (size);               \
    const Rec s = rec_at(recs, k, nc, m);                        \
    (void)s;                                                     \
    (void)o_;                                                    \
    (ptr)[(base) * (size) + e] = (expr);                         \
  }
  CMPC_FIELD(o.F, st, kNZ * kNZ, F_entry(s, o_ / kNZ, o_ % kNZ))
  CMPC_FIELD(o.G, st, kNZ * nc, G_entry(s, o_ / nc, o_ % nc))
  CMPC_FIELD(o.d, st, kNZ, o_ < kNX ? s.rd[o_] : 0.f)
  CMPC_FIELD(o.Q, st1, kNZ * kNZ,
             (o_ / kNZ == o_ % kNZ) ? Qdiag[o_ / kNZ] : 0.f)
  CMPC_FIELD(o.q, st1, kNZ, s.q[o_])
  CMPC_FIELD(o.R, st, nc * nc, (o_ / nc == o_ % nc) ? Rdiag[o_ / nc] : 0.f)
  CMPC_FIELD(o.r, st, nc, s.r[o_])
  CMPC_FIELD(o.S, st, kNZ * nc, 0.f)
  CMPC_FIELD(o.D, st, m * kNZ, s.D[o_])
  CMPC_FIELD(o.E, st, m * nc, s.E[o_])
  CMPC_FIELD(o.lo, st, m, s.lo[o_])
  CMPC_FIELD(o.hi, st, m, s.hi[o_])
  CMPC_FIELD(o.slo, st, m, s.slo[o_])
  CMPC_FIELD(o.shi, st, m, s.shi[o_])
#undef CMPC_FIELD
  if (k0 == 0) {  // stage 0 of the (N+1)-stage cost: zero
    const size_t s0 = (size_t)p * (N + 1);
    for (int e = tid; e < kNZ * kNZ; e += nt) o.Q[s0 * kNZ * kNZ + e] = 0.f;
    for (int e = tid; e < kNZ; e += nt) o.q[s0 * kNZ + e] = 0.f;
  }
}

// Default rows: unbounded, hard, D and E zero.
__device__ inline void clear_rows(const Rec& s, int nc, int m, int lane) {
  for (int e = lane; e < m * kNZ; e += 32) s.D[e] = 0.f;
  for (int e = lane; e < m * nc; e += 32) s.E[e] = 0.f;
  for (int e = lane; e < m; e += 32) {
    s.lo[e] = -INFINITY;
    s.hi[e] = INFINITY;
    s.slo[e] = INFINITY;
    s.shi[e] = INFINITY;
  }
  for (int e = lane; e < kNZ; e += 32) s.q[e] = 0.f;
  for (int e = lane; e < nc; e += 32) s.r[e] = 0.f;
}

// ============================================================================
// NL: planners/nl.py build_nl_qp_plain
// ============================================================================

// Constants, in order (Python doubles, as the plain version's expressions
// form them; the kernel rounds each to float32 where a float32 op takes it).
enum NLConst {
  kLowVel, kNegMu, kA, kNegA, kLf, kCf, kCr, kM, kI, kLfCf, kLrCr, kLf2Cf,
  kLr2Cr, kBk, kDt, kEps, kPriceScale, kUt0, kUt1, kTrustTheta, kTrustB,
  kPlaneR, kNLConsts
};

struct NLArgs {
  const float *x, *u, *lam, *neigh, *mmask, *planes;
  const int* lane;  // null: every problem on lane_const
  TrackArgs track;
  Out out;
  float c[kNLConsts];
  float rcp_m, rcp_I;
  int P, N, nb, coupling, trust, order, lane_const;
  Slots<kNLSlots> slots;  // the gains (16) and the limits (9)
};

// the slots: gains q (9), r (2), dr (2), qs (3, capped), then the
// SysLimits fields in order
enum Lim { kVxRef, kMinDist, kMaxVel, kMinVel, kMaxRs, kMaxLs, kMaxAc,
           kMaxDc, kSm };
enum Coupling { kEu = 0, kHp = 1, kHpOpt = 2 };

// Row i (< 9) of the analytic Jacobians of f_continuous (planners/nl.py
// _jacobians) and of the LPV matrices (dynamics/bicycle.py lpv_coeffs) at
// one stage, then the row of Ad, Bd and rd (planners/nl.py
// _linearize_horizon).
__device__ void nl_row(const NLArgs& a, int i, const float* x,
                       const float* u, float kappa, const Rec& s) {
  const float* c = a.c;
  const float vx = x[0], vy = x[1], wz = x[2], ey = x[3];
  const float delta = u[0];
  const bool low = vx < c[kLowVel];
  const float vs = low ? 1.f : vx;
  const float inv = fdiv(1.f, vs);
  const float inv2 = fmul(inv, inv);
  const float sd = sinf(delta), cd = cosf(delta);
  const float se = sinf(x[4]), ce = cosf(x[4]);
  const float st = sinf(x[5]), ct = cosf(x[5]);
  const float den = fsub(1.f, fmul(ey, kappa));
  const float den2 = fmul(den, den);
  const float a_ = c[kA], lf = c[kLf], Cf = c[kCf], Cr = c[kCr];
  const float vlw = fadd(vy, fmul(lf, wz));  // vy + lf wz
#define GATE(v) (low ? 0.f : (v))
  float J[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float Ju[2] = {0.f, 0.f};
  float A[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float B[2] = {0.f, 0.f};
  const float mvs = fmul(vs, c[kM]), Ivs = fmul(vs, c[kI]);
  const float lfcd = fsub(fmul(c[kLfCf], cd), c[kLrCr]);  // lf Cf cd - lr Cr
  switch (i) {
    case 0: {
      J[0] = fadd(GATE(fmul(fmul(fmul(c[kNegA], sd), vlw), inv2)),
                  c[kNegMu]);
      J[1] = GATE(fadd(fmul(fmul(a_, sd), inv), wz));
      J[2] = GATE(fadd(fmul(fmul(fmul(a_, sd), lf), inv), vy));
      Ju[0] = fadd(GATE(fmul(fmul(fmul(a_, cd), vlw), inv)),
                   GATE(fmul(c[kNegA], fadd(fmul(cd, delta), sd))));
      Ju[1] = 1.f;
      A[0] = c[kNegMu];
      A[1] = GATE(fdiv(fmul(sd, Cf), mvs));
      A[2] = GATE(fadd(fdiv(fmul(fmul(sd, Cf), lf), mvs), vy));
      B[0] = GATE(fmul(fmul(-sd, Cf), a.rcp_m));
      B[1] = 1.f;
      break;
    }
    case 1: {
      const float g1 = fmul(fadd(fmul(Cf, cd), Cr), a.rcp_m);
      const float h1 = fmul(lfcd, a.rcp_m);
      J[0] = GATE(fsub(fmul(fadd(fmul(g1, vy), fmul(h1, wz)), inv2), wz));
      J[1] = GATE(fmul(-g1, inv));
      J[2] = GATE(fsub(fmul(-h1, inv), vx));
      Ju[0] = fadd(GATE(fmul(fmul(fmul(fmul(Cf, sd), a.rcp_m), vlw), inv)),
                   fmul(a_, fsub(cd, fmul(sd, delta))));
      A[1] = GATE(fdiv(-fadd(fmul(Cf, cd), Cr), mvs));
      A[2] = GATE(fsub(fdiv(-lfcd, mvs), vx));
      B[0] = fmul(fmul(cd, Cf), a.rcp_m);
      break;
    }
    case 2: {
      const float g2 = fmul(lfcd, a.rcp_I);
      const float h2 = fmul(fadd(fmul(c[kLf2Cf], cd), c[kLr2Cr]), a.rcp_I);
      const float bk = c[kBk];
      J[0] = GATE(fmul(fadd(fmul(g2, vy), fmul(h2, wz)), inv2));
      J[1] = GATE(fmul(-g2, inv));
      J[2] = GATE(fmul(-h2, inv));
      Ju[0] = fadd(GATE(fmul(fmul(fmul(bk, sd), vlw), inv)),
                   fmul(bk, fsub(cd, fmul(sd, delta))));
      A[1] = GATE(fdiv(-lfcd, Ivs));
      A[2] = GATE(fdiv(-fadd(fmul(c[kLf2Cf], cd), c[kLr2Cr]), Ivs));
      B[0] = fmul(fmul(c[kLfCf], cd), a.rcp_I);
      break;
    }
    case 3:
      J[0] = se;
      J[1] = ce;
      J[4] = fsub(fmul(ce, vx), fmul(se, vy));
      A[0] = se;
      A[1] = ce;
      break;
    case 4: {
      const float e4 = fmul(kappa, fsub(fmul(se, vy), fmul(ce, vx)));
      J[0] = fdiv(fmul(-ce, kappa), den);
      J[1] = fdiv(fmul(se, kappa), den);
      J[2] = 1.f;
      J[3] = fdiv(fmul(e4, kappa), den2);
      J[4] = fdiv(fmul(kappa, fadd(fmul(se, vx), fmul(ce, vy))), den);
      A[0] = J[0];
      A[1] = J[1];
      A[2] = 1.f;
      break;
    }
    case 5:
      J[2] = 1.f;
      A[2] = 1.f;
      break;
    case 6: {
      const float e6 = fsub(fmul(ce, vx), fmul(se, vy));
      J[0] = fdiv(ce, den);
      J[1] = fdiv(-se, den);
      J[3] = fdiv(fmul(e6, kappa), den2);
      J[4] = -fdiv(fadd(fmul(se, vx), fmul(ce, vy)), den);
      A[0] = J[0];
      A[1] = J[1];
      break;
    }
    case 7:
      J[0] = ct;
      J[1] = -st;
      J[5] = fsub(fmul(-st, vx), fmul(ct, vy));
      A[0] = ct;
      A[1] = -st;
      break;
    default:  // 8
      J[0] = st;
      J[1] = ct;
      J[5] = fsub(fmul(ct, vx), fmul(st, vy));
      A[0] = st;
      A[1] = ct;
      break;
  }
#undef GATE
  const float dt = c[kDt];
  // f_i = (A x)_i + (B u)_i; fd_i = x_i + dt f_i
  const float f = fadd(mv(A, x, 9, a.order), mv(B, u, 2, a.order));
  const float fd = fadd(x[i], fmul(dt, f));
  float Ad[9], Bd[2];
  for (int l = 0; l < 9; ++l)
    Ad[l] = fadd(l == i ? 1.f : 0.f, fmul(dt, J[l]));
  Bd[0] = fmul(dt, Ju[0]);
  Bd[1] = fmul(dt, Ju[1]);
  for (int l = 0; l < 9; ++l) s.Ad[i * 9 + l] = Ad[l];
  s.Bd[i * 2] = Bd[0];
  s.Bd[i * 2 + 1] = Bd[1];
  s.rd[i] = fsub(fsub(fd, mv(Ad, x, 9, a.order)), mv(Bd, u, 2, a.order));
}

__global__ void __launch_bounds__(kThreads)
    nl_qp_kernel(const NLArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, nb = a.nb, p = blockIdx.y;
  const bool hp_opt = a.coupling == kHpOpt;
  const int nc = 2 + (hp_opt ? 2 * nb : 0);
  const int m = 4 + (hp_opt ? 3 * nb : nb);
  const int k0 = blockIdx.x * kStages;
  const int ns = min(kStages, N - k0);
  float* Qdiag = smem;            // 11
  float* Rdiag = smem + kNZ;      // nc
  float* recs = smem + kNZ + 32;  // the stage records
  __shared__ float g[kNLSlots];  // this problem's gains, then its limits
  const float* lim = g + 16;
  if (threadIdx.x < kNLSlots) {
    float v = a.slots.get(threadIdx.x, p);
    // qs is capped at SOFT_WEIGHT_CAP as torch.clamp_max does it
    if (threadIdx.x >= 13 && threadIdx.x < 16) v = nanmin(v, 1e4f);
    g[threadIdx.x] = v;
  }
  __syncthreads();
  const float* c = a.c;
  if (threadIdx.x < kNZ) Qdiag[threadIdx.x] = fmul(2.f, g[threadIdx.x]);
  if (threadIdx.x < nc)
    Rdiag[threadIdx.x] = threadIdx.x < 2 ? fmul(2.f, g[11 + threadIdx.x])
                                         : c[kPlaneR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ln = a.lane ? a.lane[p] : a.lane_const;
  for (int kk = warp; kk < ns; kk += kThreads / 32) {
    const int k = k0 + kk;
    const Rec s = rec_at(recs, kk, nc, m);
    const float* xk = a.x + ((size_t)p * (N + 1) + k) * kNX;
    float x[9], u[2];
    for (int l = 0; l < 9; ++l) x[l] = xk[l];
    u[0] = a.u[((size_t)p * N + k) * 2];
    u[1] = a.u[((size_t)p * N + k) * 2 + 1];
    const int seg = segment(a.track, ln, x[6]);
    const float kappa = a.track.curv[(size_t)ln * a.track.nseg + seg];
    clear_rows(s, nc, m, lane);
    __syncwarp();
    if (lane < kNX) nl_row(a, lane, x, u, kappa, s);
    __syncwarp();
    const float px = xk[kNX + 7], py = xk[kNX + 8];  // stage k+1's position
    if (lane == 9) {
      // velocity band and lateral band, soft both sides; input boxes, hard,
      // intersected with the SQP trust region
      const float qs0 = g[13];
      for (int l = 0; l < kNZ; ++l) {
        s.D[l] = F_entry(s, 0, l);
        s.D[kNZ + l] = F_entry(s, 3, l);
      }
      for (int l = 0; l < nc; ++l) {
        s.E[l] = G_entry(s, 0, l);
        s.E[nc + l] = G_entry(s, 3, l);
      }
      s.lo[0] = fsub(lim[kMinVel], s.rd[0]);
      s.hi[0] = fsub(lim[kMaxVel], s.rd[0]);
      s.slo[0] = s.shi[0] = qs0;
      const float ey_ub = fmul(
          a.track.hw[(size_t)ln * a.track.nseg + seg], lim[kSm]);
      s.lo[1] = fsub(-ey_ub, s.rd[3]);
      s.hi[1] = fsub(ey_ub, s.rd[3]);
      s.slo[1] = s.shi[1] = qs0;
      s.D[2 * kNZ + kNX] = 1.f;
      s.E[2 * nc] = 1.f;
      s.D[3 * kNZ + kNX + 1] = 1.f;
      s.E[3 * nc + 1] = 1.f;
      if (a.trust) {
        s.lo[2] = nanmax(-lim[kMaxLs], fsub(u[0], c[kUt0]));
        s.hi[2] = nanmin(lim[kMaxRs], fadd(u[0], c[kUt0]));
        s.lo[3] = nanmax(-lim[kMaxDc], fsub(u[1], c[kUt1]));
        s.hi[3] = nanmin(lim[kMaxAc], fadd(u[1], c[kUt1]));
      } else {
        s.lo[2] = -lim[kMaxLs];
        s.hi[2] = lim[kMaxRs];
        s.lo[3] = -lim[kMaxDc];
        s.hi[3] = lim[kMaxAc];
      }
      s.q[0] = fmul(fmul(-2.f, g[0]), lim[kVxRef]);
    }
    if (lane >= 10 && lane < 10 + nb) {
      // coupling rows: the position of x_{k+1} along the distance gradient
      // (eu, hp) or the plane normal (hp_opt)
      const int j = lane - 10;
      const float qs2 = g[15];
      const float* nxy = a.neigh + (((size_t)p * (N + 1) + k + 1) * nb + j) * 2;
      const float dx = fsub(px, nxy[0]), dy = fsub(py, nxy[1]);
      const float dist =
          __fsqrt_rn(fadd(fadd(fmul(dx, dx), fmul(dy, dy)), c[kEps]));
      const float ghx = fdiv(dx, dist), ghy = fdiv(dy, dist);
      const float mm = a.mmask[(size_t)p * nb + j];
      const float lam = fmul(
          fmul(c[kPriceScale], a.lam[((size_t)p * nb + j) * N + k]), mm);
      const bool mrow = mm > 0.f;
      float gx = ghx, gy = ghy, th = 0.f, b = 0.f, sth = 0.f, cth = 0.f;
      if (hp_opt) {
        const float* pl = a.planes + (((size_t)p * nb + j) * N + k) * 2;
        th = pl[0];
        b = pl[1];
        sth = sinf(th);
        cth = cosf(th);
        gx = cth;
        gy = sth;
      }
      const int row = 4 + j;
      for (int l = 0; l < kNZ; ++l)
        s.D[row * kNZ + l] = fadd(fmul(gx, F_entry(s, 7, l)),
                                  fmul(gy, F_entry(s, 8, l)));
      for (int l = 0; l < nc; ++l)
        s.E[row * nc + l] = fadd(fmul(gx, G_entry(s, 7, l)),
                                 fmul(gy, G_entry(s, 8, l)));
      const float dds = fadd(fmul(gx, s.rd[7]), fmul(gy, s.rd[8]));
      if (hp_opt) {
        // price on the plane controls; own side of the plane, linearised in
        // (p, dtheta, db); hard trust boxes on the plane perturbations
        const float ap_pn = fadd(fmul(-sth, nxy[0]), fmul(cth, nxy[1]));
        s.r[2 + j] = fmul(-lam, ap_pn);
        s.r[2 + nb + j] = -lam;
        const float ap_p = fadd(fmul(-sth, px), fmul(cth, py));
        s.E[row * nc + 2 + j] = mrow ? ap_p : 0.f;
        s.E[row * nc + 2 + nb + j] = mrow ? 1.f : 0.f;
        s.E[(row + nb) * nc + 2 + j] = 1.f;
        s.E[(row + 2 * nb) * nc + 2 + nb + j] = 1.f;
        const float dth2 = fmul(lim[kMinDist], 0.5f);
        s.hi[row] = mrow ? fsub(fsub(-dth2, b), dds) : INFINITY;
        s.lo[row] = mrow ? -INFINITY : fsub(fsub(dth2, b), dds);
        s.shi[row] = mrow ? qs2 : INFINITY;
        s.slo[row] = mrow ? INFINITY : qs2;
        const float tr_th = mrow ? c[kTrustTheta] : 0.f;
        const float tr_b = mrow ? c[kTrustB] : 0.f;
        s.lo[row + nb] = -tr_th;
        s.hi[row + nb] = tr_th;
        s.lo[row + 2 * nb] = -tr_b;
        s.hi[row + 2 * nb] = tr_b;
      } else {
        s.scr[2 * j] = fmul(lam, ghx);
        s.scr[2 * j + 1] = fmul(lam, ghy);
        float bound;
        if (a.coupling == kHp) {
          const float mx = fmul(0.5f, fadd(px, nxy[0]));
          const float my = fmul(0.5f, fadd(py, nxy[1]));
          bound = fsub(fadd(fmul(lim[kMinDist], 0.5f),
                            fadd(fmul(ghx, mx), fmul(ghy, my))), dds);
        } else {
          const float b0 = fsub(lim[kMinDist], dist);
          bound = fsub(fadd(b0, fadd(fmul(ghx, px), fmul(ghy, py))), dds);
          if (!(fsub(1.f, mm) > 0.f)) bound = -INFINITY;  // master pair
        }
        s.lo[row] = bound;
        s.slo[row] = qs2;
      }
    }
    __syncwarp();
    if (lane == 0 && !hp_opt) {
      // master coupling price on (X, Y): q += -sum_j lam_j g_hat_j
      float sx = 0.f, sy = 0.f;
      for (int j = 0; j < nb; ++j) {
        sx = fadd(sx, s.scr[2 * j]);
        sy = fadd(sy, s.scr[2 * j + 1]);
      }
      s.q[7] = fadd(0.f, -sx);
      s.q[8] = fadd(0.f, -sy);
    }
  }
  __syncthreads();
  write_stages(a.out, recs, Qdiag, Rdiag, p, k0, ns, N, nc, m);
}

// ============================================================================
// MPCC: planners/mpcc.py build_mpcc_qp_plain with dynamics/pacejka.py
// ============================================================================

enum MPCCConst {
  kPLf, kPLr, kPBf, kPCf, kPDf, kPBr, kPCr, kPDr, kPCm1, kPCm2, kPCr0,
  kPCr2, kPM, kPI, kPLong, kPEll2, kPMaxAlpha, kPNegMaxAlpha, kPDt,
  kPTrustDelta, kPTrustDrive, kPNegDeltaMax, kPDeltaMax, kPDriveMin,
  kPDriveMax, kPVxMin, kPFloor, kPSm, kMPCCConsts
};

struct MPCCArgs {
  const float *x, *u;
  TrackArgs track;
  Out out;
  double c[kMPCCConsts];
  int P, N, order;
  Slots<kMPCCSlots> slots;  // the gains
};

// the slots: MPCCGains in order
enum MG { kQProgress, kQContour, kQHeading, kQVy, kQWz, kRDelta, kRDrive,
          kDrDelta, kDrDrive, kWSoft };

// A forward-mode tangent: its value and dtype (0: undefined, 1: float32,
// 2: float64); a float32 tangent holds a float32 value exactly.
struct Tg {
  double v;
  int k;
};

__device__ __forceinline__ Tg tg_add(Tg a, Tg b) {
  if (!a.k) return b;
  if (!b.k) return a;
  if (a.k == 2 || b.k == 2) return {__dadd_rn(a.v, b.v), 2};
  return {(double)fadd((float)a.v, (float)b.v), 1};
}
__device__ __forceinline__ Tg tg_neg(Tg a) { return {-a.v, a.k}; }
// tangent times a float32 primal, in the tangent's dtype
__device__ __forceinline__ Tg tg_mulp(Tg t, float p) {
  if (!t.k) return t;
  if (t.k == 2) return {__dmul_rn(t.v, (double)p), 2};
  return {(double)fmul((float)t.v, p), 1};
}
__device__ __forceinline__ Tg tg_divp(Tg t, float p) {
  if (t.k == 2) return {__ddiv_rn(t.v, (double)p), 2};
  return {(double)fdiv((float)t.v, p), 1};
}

struct Du {
  float p;
  Tg t;
};

// the ops of the Pacejka model with their forward-mode rules; a Python
// number's zero tangent is float64, so a tangent meeting one turns float64
__device__ __forceinline__ Du d_mul_s(Du a, double s) {  // a * number
  Tg t = a.t;
  if (t.k == 1) t = {(double)fmul((float)t.v, (float)s), 2};
  else if (t.k == 2) t = {__dmul_rn(t.v, s), 2};
  return {fmul(a.p, (float)s), t};
}
__device__ __forceinline__ Du d_div_s(Du a, double s) {  // a / number
  // the card: the primal times the float32 reciprocal, the float64 tangent
  // times the float64 reciprocal
  const float r32 = fdiv(1.f, (float)s);
  Tg t = a.t;
  if (t.k) t = {__dmul_rn(t.v, __ddiv_rn(1.0, s)), 2};
  return {fmul(a.p, r32), t};
}
__device__ __forceinline__ Du d_sub_s(Du a, double s) {  // a - number
  Tg t = a.t;
  if (t.k) t.k = 2;
  return {fsub(a.p, (float)s), t};
}
__device__ __forceinline__ Du d_rsub_s(double s, Du a) {  // number - a
  return {fsub((float)s, a.p), tg_neg(a.t)};
}
__device__ __forceinline__ Du d_neg(Du a) { return {-a.p, tg_neg(a.t)}; }
__device__ __forceinline__ Du d_add(Du a, Du b) {
  return {fadd(a.p, b.p), tg_add(a.t, b.t)};
}
__device__ __forceinline__ Du d_sub(Du a, Du b) {
  return {fsub(a.p, b.p), tg_add(a.t, tg_neg(b.t))};
}
__device__ __forceinline__ Du d_mul(Du a, Du b) {
  return {fmul(a.p, b.p), tg_add(tg_mulp(b.t, a.p), tg_mulp(a.t, b.p))};
}
__device__ __forceinline__ Du d_div(Du a, Du b) {  // (a' - b' r) / b
  const float r = fdiv(a.p, b.p);
  Tg t = a.t;
  if (a.t.k || b.t.k) t = tg_divp(tg_add(a.t, tg_neg(tg_mulp(b.t, r))), b.p);
  return {r, t};
}
__device__ __forceinline__ Du d_sin(Du a) {
  return {sinf(a.p), tg_mulp(a.t, cosf(a.p))};
}
__device__ __forceinline__ Du d_cos(Du a) {
  return {cosf(a.p), tg_mulp(a.t, -sinf(a.p))};
}
__device__ __forceinline__ Du d_atan(Du a) {  // a' / (a a + 1)
  const float den = fadd(fmul(a.p, a.p), 1.f);
  return {atanf(a.p), a.t.k ? tg_divp(a.t, den) : a.t};
}
__device__ __forceinline__ Du d_atan2(Du y, Du x) {
  // (-y x' + x y') / (y^2 + x^2)
  const float den = fadd(fmul(y.p, y.p), fmul(x.p, x.p));
  const Tg num = tg_add(tg_mulp(x.t, -y.p), tg_mulp(y.t, x.p));
  return {atan2f(y.p, x.p), num.k ? tg_divp(num, den) : num};
}
__device__ __forceinline__ Du d_max_c(Du a, float cst) {
  // torch.maximum against a constant: the tangent halved at a tie
  const float fac = (a.p == cst) ? 0.5f : ((a.p > cst) ? 1.f : 0.f);
  return {nanmax(a.p, cst), tg_mulp(a.t, fac)};
}
__device__ __forceinline__ Du d_pow2(Du a) {
  return {fmul(a.p, a.p), tg_mulp(a.t, fmul(2.f, a.p))};
}

// The continuous Pacejka dynamics (dynamics/pacejka.py
// f_continuous_pacejka) and the three tyre residuals (friction ellipse, two
// slip-angle rows), with the tangents of one Jacobian column.
__device__ void pacejka(const double* c, const Du* x, const Du* u, float kap,
                        Du* f, Du* rows) {
  const Du vx0 = x[0], vy = x[1], wz = x[2], ey = x[3];
  const Du delta = u[0];
  const Du kappa = {kap, {0.0, 0}};
  const Du vxc = d_max_c(vx0, (float)c[kPFloor]);
  const Du af = d_add(d_neg(d_atan2(d_add(vy, d_mul_s(wz, c[kPLf])), vxc)),
                      delta);
  const Du ar = d_neg(d_atan2(d_sub(vy, d_mul_s(wz, c[kPLr])), vxc));
  const Du F_fy = d_mul_s(
      d_sin(d_mul_s(d_atan(d_mul_s(af, c[kPBf])), c[kPCf])), c[kPDf]);
  const Du F_ry = d_mul_s(
      d_sin(d_mul_s(d_atan(d_mul_s(ar, c[kPBr])), c[kPCr])), c[kPDr]);
  const Du vx = vx0;
  Du F_rx = d_sub_s(d_sub(d_mul_s(u[1], c[kPCm1]),
                          d_mul(d_mul_s(u[1], c[kPCm2]), vx)),
                    c[kPCr0]);
  F_rx = d_sub(F_rx, d_mul(d_mul_s(vx, c[kPCr2]), vx));
  const double m = c[kPM];
  f[0] = d_div_s(d_add(d_sub(F_rx, d_mul(F_fy, d_sin(delta))),
                       d_mul(d_mul_s(vy, m), wz)), m);
  f[1] = d_div_s(d_sub(d_add(F_ry, d_mul(F_fy, d_cos(delta))),
                       d_mul(d_mul_s(vx, m), wz)), m);
  f[2] = d_div_s(d_sub(d_mul(d_mul_s(F_fy, c[kPLf]), d_cos(delta)),
                       d_mul_s(F_ry, c[kPLr])), c[kPI]);
  const Du se = d_sin(x[4]), ce = d_cos(x[4]);
  const Du st = d_sin(x[5]), ct = d_cos(x[5]);
  const Du den = d_rsub_s(1.0, d_mul(ey, kappa));
  f[3] = d_add(d_mul(se, vx), d_mul(ce, vy));
  f[4] = d_add(d_add(d_mul(d_div(d_mul(d_neg(ce), kappa), den), vx),
                     d_mul(d_div(d_mul(se, kappa), den), vy)), wz);
  f[5] = wz;
  f[6] = d_add(d_mul(d_div(ce, den), vx), d_mul(d_div(d_neg(se), den), vy));
  f[7] = d_sub(d_mul(ct, vx), d_mul(st, vy));
  f[8] = d_add(d_mul(st, vx), d_mul(ct, vy));
  rows[0] = d_sub_s(d_add(d_pow2(d_mul_s(F_rx, c[kPLong])), d_pow2(F_ry)),
                    c[kPEll2]);
  rows[1] = d_sub_s(af, c[kPMaxAlpha]);
  rows[2] = d_rsub_s(c[kPNegMaxAlpha], af);
}

__global__ void __launch_bounds__(kThreads)
    mpcc_qp_kernel(const MPCCArgs a) {
  extern __shared__ float smem[];
  constexpr int nc = 2, m = 7;
  const int N = a.N, p = blockIdx.y;
  const int k0 = blockIdx.x * kStages;
  const int ns = min(kStages, N - k0);
  float* Qdiag = smem;
  float* Rdiag = smem + kNZ;
  float* recs = smem + kNZ + 32;
  __shared__ float g[kMPCCSlots];  // this race's gains
  if (threadIdx.x < kMPCCSlots) g[threadIdx.x] = a.slots.get(threadIdx.x, p);
  __syncthreads();
  const double* c = a.c;
  if (threadIdx.x < kNZ) {
    const int i = threadIdx.x;
    const int src[kNZ] = {-1, kQVy, kQWz, kQContour, kQHeading, -1, -1, -1,
                          -1, kRDelta, kRDrive};
    Qdiag[i] = src[i] < 0 ? 0.f : fmul(2.f, g[src[i]]);
  }
  if (threadIdx.x < nc) Rdiag[threadIdx.x] = fmul(2.f, g[kDrDelta + threadIdx.x]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int order = a.order;
  for (int kk = warp; kk < ns; kk += kThreads / 32) {
    const int k = k0 + kk;
    const Rec s = rec_at(recs, kk, nc, m);
    const float* xk = a.x + ((size_t)p * (N + 1) + k) * kNX;
    float x[9], u[2];
    for (int l = 0; l < 9; ++l) x[l] = xk[l];
    u[0] = a.u[((size_t)p * N + k) * 2];
    u[1] = a.u[((size_t)p * N + k) * 2 + 1];
    const int seg = segment(a.track, 0, x[6]);
    const float kappa = a.track.curv[seg];
    clear_rows(s, nc, m, lane);
    __syncwarp();
    float* fd = s.scr;         // 9: the discrete model at the stage
    float* vals = s.scr + 9;   // 3: the tyre residuals
    if (lane < kNZ) {
      // Jacobian column `lane` (x for 0..8, u for 9..10): the jvp along
      // that basis vector, as jacfwd computes it
      Du xd[9], ud[2], f[9], rows[3];
      for (int l = 0; l < 9; ++l) xd[l] = {x[l], {l == lane ? 1.0 : 0.0, 1}};
      for (int l = 0; l < 2; ++l)
        ud[l] = {u[l], {9 + l == lane ? 1.0 : 0.0, 1}};
      pacejka(c, xd, ud, kappa, f, rows);
      // fd = x + dt f: the stacked tangents in their common dtype
      bool f64 = false;
      for (int i = 0; i < 9; ++i) f64 = f64 || f[i].t.k == 2;
      const double dt = c[kPDt];
      for (int i = 0; i < 9; ++i) {
        const double seed = (i == lane) ? 1.0 : 0.0;
        float v;
        if (f64) v = __double2float_rn(__dadd_rn(seed, __dmul_rn(f[i].t.v, dt)));
        else v = fadd((float)seed, fmul((float)f[i].t.v, (float)dt));
        if (lane < 9) s.Ad[i * 9 + lane] = v;
        else s.Bd[i * 2 + lane - 9] = v;
      }
      bool r64 = false;
      for (int r = 0; r < 3; ++r) r64 = r64 || rows[r].t.k == 2;
      for (int r = 0; r < 3; ++r) {
        const float v = r64 ? __double2float_rn(rows[r].t.v)
                            : (float)rows[r].t.v;
        s.D[(3 + r) * kNZ + lane] = v;
        if (lane >= 9) s.E[(3 + r) * nc + lane - 9] = v;
      }
      if (lane == 0) {
        for (int i = 0; i < 9; ++i)
          fd[i] = fadd(x[i], fmul((float)dt, f[i].p));
        for (int r = 0; r < 3; ++r) vals[r] = rows[r].p;
      }
    }
    __syncwarp();
    if (lane < kNX) {
      s.rd[lane] = fsub(fsub(fd[lane], mv(s.Ad + lane * 9, x, 9, order)),
                        mv(s.Bd + lane * 2, u, 2, order));
    } else if (lane < kNX + 3) {
      // tyre rows: g.x + gu.u <= g.x_bar + gu.u_bar - value
      const int r = lane - kNX;
      s.hi[3 + r] = fadd(fadd(-vals[r], mv(s.D + (3 + r) * kNZ, x, 9, order)),
                         mv(s.D + (3 + r) * kNZ + kNX, u, 2, order));
      s.shi[3 + r] = g[kWSoft];
    }
    __syncwarp();
    if (lane == 0) {
      const float w = g[kWSoft];
      // track corridor on ey_{k+1}, soft both sides
      for (int l = 0; l < kNZ; ++l) {
        s.D[l] = F_entry(s, 3, l);
        s.D[6 * kNZ + l] = F_entry(s, 0, l);
      }
      for (int l = 0; l < nc; ++l) {
        s.E[l] = G_entry(s, 3, l);
        s.E[6 * nc + l] = G_entry(s, 0, l);
      }
      const float ey_ub = fmul(a.track.hw[seg], (float)c[kPSm]);
      s.lo[0] = fsub(-ey_ub, s.rd[3]);
      s.hi[0] = fsub(ey_ub, s.rd[3]);
      s.slo[0] = s.shi[0] = w;
      // input boxes with the SQP trust region
      s.D[kNZ + kNX] = 1.f;
      s.E[nc] = 1.f;
      s.lo[1] = nanmax(fsub(u[0], (float)c[kPTrustDelta]),
                       (float)c[kPNegDeltaMax]);
      s.hi[1] = nanmin(fadd(u[0], (float)c[kPTrustDelta]),
                       (float)c[kPDeltaMax]);
      s.D[2 * kNZ + kNX + 1] = 1.f;
      s.E[2 * nc + 1] = 1.f;
      s.lo[2] = nanmax(fsub(u[1], (float)c[kPTrustDrive]),
                       (float)c[kPDriveMin]);
      s.hi[2] = nanmin(fadd(u[1], (float)c[kPTrustDrive]),
                       (float)c[kPDriveMax]);
      // vx >= vx_min, soft
      s.lo[6] = fsub((float)c[kPVxMin], s.rd[0]);
      s.slo[6] = w;
      s.q[6] = fmul(-2.f, g[kQProgress]);
    }
  }
  __syncthreads();
  write_stages(a.out, recs, Qdiag, Rdiag, p, k0, ns, N, nc, m);
}

inline Out out_from(void* const* o) {
  Out r;
  float** f = (float**)o;
  r.F = f[0]; r.G = f[1]; r.d = f[2]; r.Q = f[3]; r.q = f[4]; r.R = f[5];
  r.r = f[6]; r.S = f[7]; r.D = f[8]; r.E = f[9]; r.lo = f[10];
  r.hi = f[11]; r.slo = f[12]; r.shi = f[13];
  return r;
}

inline TrackArgs track_from(void* const* t, int nseg) {
  return {(const float*)t[0], (const float*)t[1], (const float*)t[2],
          (const float*)t[3], (const unsigned char*)t[4], nseg};
}

inline size_t smem_bytes(int nc, int m) {
  return sizeof(float) * (kNZ + 32 + (size_t)kStages * record_floats(nc, m));
}

}  // namespace

// inputs: x_bar (P,N+1,9), u_bar (P,N,2), lambdas (P,nb,N), neigh_xy
// (P,N+1,nb,2), master_mask (P,nb), planes0 (P,nb,N,2) or null, lane (P,)
// int32 or null; track: s0, curv, halfwidth (lanes, nseg), track_length
// (lanes,), open_flag (bool); outputs: F, G, d, Q, q, R, r, S, D, E, lo,
// hi, soft_lo, soft_hi; slots: the gains q (9), r (2), dr (2), qs (3)
// and the 9 limits (Slots: pointers, then strides in ints, values in
// consts). consts: the NLConst values, then the slots' values. ints: P,
// N, nb, coupling, trust, order, nseg, the lane a null lane stands for,
// then the slots' strides.
extern "C" int cmpc_nl_qp(void* const* in, void* const* track,
                          void* const* out, void* const* slots,
                          const double* consts, const int* ints,
                          void* stream) {
  NLArgs a;
  a.x = (const float*)in[0];
  a.u = (const float*)in[1];
  a.lam = (const float*)in[2];
  a.neigh = (const float*)in[3];
  a.mmask = (const float*)in[4];
  a.planes = (const float*)in[5];
  a.lane = (const int*)in[6];
  a.P = ints[0];
  a.N = ints[1];
  a.nb = ints[2];
  a.coupling = ints[3];
  a.trust = ints[4];
  a.order = ints[5];
  a.track = track_from(track, ints[6]);
  a.lane_const = ints[7];
  a.out = out_from(out);
  for (int i = 0; i < kNLConsts; ++i) a.c[i] = (float)consts[i];
  slots_from(a.slots, slots, ints + 8, consts + kNLConsts);
  a.rcp_m = 1.f / (float)consts[kM];
  a.rcp_I = 1.f / (float)consts[kI];
  if (a.P <= 0 || a.N <= 0 || a.nb < 0 || a.nb > 8 || a.coupling < 0 ||
      a.coupling > 2 || (a.coupling == kHpOpt && !a.planes))
    return (int)cudaErrorInvalidValue;
  const int nc = 2 + (a.coupling == kHpOpt ? 2 * a.nb : 0);
  const int m = 4 + (a.coupling == kHpOpt ? 3 * a.nb : a.nb);
  // at most 8 neighbours: the records of 8 stages stay within the 48 KB a
  // block takes without opting in
  const size_t smem = smem_bytes(nc, m);
  const dim3 grid((a.N + kStages - 1) / kStages, a.P);
  nl_qp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// inputs: x_bar (P,N+1,9), u_bar (P,N,2); track as cmpc_nl_qp (lane 0);
// outputs as cmpc_nl_qp; slots: the 10 gains. consts: the MPCCConst
// values, then the slots' values; ints: P, N, order, nseg, then the slots'
// strides.
extern "C" int cmpc_mpcc_qp(void* const* in, void* const* track,
                            void* const* out, void* const* slots,
                            const double* consts, const int* ints,
                            void* stream) {
  MPCCArgs a;
  a.x = (const float*)in[0];
  a.u = (const float*)in[1];
  a.P = ints[0];
  a.N = ints[1];
  a.order = ints[2];
  a.track = track_from(track, ints[3]);
  a.out = out_from(out);
  for (int i = 0; i < kMPCCConsts; ++i) a.c[i] = consts[i];
  slots_from(a.slots, slots, ints + 4, consts + kMPCCConsts);
  if (a.P <= 0 || a.N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(2, 7);
  const dim3 grid((a.N + kStages - 1) / kStages, a.P);
  mpcc_qp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
