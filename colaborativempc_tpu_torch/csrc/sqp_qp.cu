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
// is bytes, and at these sizes the real time is the launch, one block's
// chain of dependent arithmetic and the ~400 stores per stage.
//
// What the design does about it. One block of 256 threads per 8 stages of
// one problem (NL: fewer where the image of 8 stages does not fit in
// shared memory, as with many neighbours; grid: stage groups x problems),
// four or five phases
// separated by block barriers, every stage of the block at once. (Split by
// scripts/sqp_qp_split.py, a design that built two stages in turn per warp,
// lane i on row i, spent 36-62% of a block's cycles in the rows, the row
// switch serialised nine ways, and 26-44% in an output pass that paid two
// integer divisions per entry.)
// * Any neighbour count: where one stage's image and neighbour arrays do
//   not fit in shared memory (NL hp_opt from 71 agents, eu from ~1,900),
//   the plan (ops/cuda_sqp.py sqp_qp_plan) puts them, at 8 stages per
//   block, into a per-block global scratch; the neighbour arrays are then
//   copied in by plain loads and stores, the copy-out pass reads the image
//   from there, and the arithmetic and the bits are those of the shared-
//   memory launch.
// * Load: the block's rows of x_bar and u_bar, its neighbours' positions,
//   prices, planes and master flags and its lane's track rows are copied
//   into shared memory by cp.async, every copy in flight at once; the slots
//   (gains, limits) are read meanwhile and stored after the rows.
// * Rows. NL: a thread per (row, stage) on four warps builds row i of the
//   discrete linearisation (Ad, Bd, rd) of stage s; the rows are dealt so
//   that a warp runs at most three cases of the row switch, each on eight
//   stages at once, and computes only the sines its rows use. The other
//   four warps compute each (stage, neighbour) pair's scalars (distance,
//   gradient, price, plane) and each stage's corridor half-width. The
//   neighbour arrays are sized by the neighbour count in dynamic shared
//   memory, after the image (neighbour_floats). MPCC: two
//   threads per (Jacobian column, stage), one for the tyre-force rows and
//   one for the kinematic rows, run the Pacejka model's forward-mode
//   tangent along that column (the tangents' dtypes are types, fixed when
//   the kernel is compiled; 1 / m and 1 / I come from the host); then a
//   thread per (row, stage) computes rd and the tyre rows' bounds.
// * Image: the block builds every output field of its stages in shared
//   memory, in the output's order (the rows phase writes F's rows 0-8 and
//   rd there directly); the other rows are tasks, a thread per (kind,
//   stage, row), each writing its row's entries in turn, every entry once
//   (no field is zeroed and written again). A task's stage and row come
//   from a float reciprocal, exact over these ranges.
// * Copy out: one warp copies each field's range of the image to the
//   output as one contiguous run, its lanes on neighbouring addresses, the
//   eight warps on different fields at once (on the card this beat every
//   thread taking the fields in turn, and 16-byte vector stores).
// * Order of operations: bit for bit the plain version's on the card. Every
//   operation is an explicit round-to-nearest intrinsic in the plain
//   version's order, so nvcc contracts nothing into an FMA it did not have.
//   PyTorch's CUDA ops are followed where they differ from the obvious: a
//   tensor divided by a Python number is multiplied by the float32
//   reciprocal; 1 / t is a correctly rounded reciprocal; maximum, minimum
//   and clamp propagate NaN; searchsorted's upper bound sends NaN past the
//   last segment; the sum over the neighbours (eu and hp's price on the
//   position) takes torch.sum's order on the card for its layout
//   (neighbour_sum). The batched matrix-vector products (A x, Ad x, Bd u,
//   the tyre rows' gx x and gu u) follow the card's cuBLAS order, read off
//   this build (scripts/library_order.py). It depends on the layout (the NL
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
// Built with -DCMPC_SQP_QP_CLOCKS (ops/_build.py load_sqp_qp_clocks, a
// library of its own), each kernel also stamps clock64() at its barriers
// and its end: thread 0's arrival and the arrival of the block's last warp,
// into a buffer the caller passes (cmpc_nl_qp_clocked,
// cmpc_mpcc_qp_clocked; scripts/sqp_qp_split.py reads it). The default
// build has no stamps.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrappers (ops/cuda_sqp.py) check. Plain C interface for ctypes: an array
// of device pointers, arrays of the double constants, of the slots' numbers
// and of ints; the entry launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// stages per block: MPCC's, and NL's where the block's image fits (the
// wrapper's plan takes fewer where it does not)
constexpr int kStages = 8;
constexpr int kNX = 9, kNZ = 11;
// a lane's track rows are staged in shared memory up to this many segments
// (24 KB beside the kernels' < 8 KB of static shared memory); a longer
// track is searched where it lies
constexpr int kMaxSeg = 2048;

// Stamp labels, in the order of cmpc_sqp_qp_clock_names: a block stamps its
// start (the reference), each barrier and its end.
enum Label { kStart = 0, kLoaded, kRowsDone, kTailsDone, kWritten };
constexpr int kStamps = 5;

#ifdef CMPC_SQP_QP_CLOCKS
struct Clocks {
  long long* out;  // (P * groups, stamps, 3): label, thread 0's, last warp's
  int stamps;
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Stamp n of this block: thread 0's clock when it gets there, and the
// clock of the block's last warp to get there. Every warp of the block
// calls it, lanes converged.
__device__ __forceinline__ void stamp(const Clocks& c, unsigned* arrivals,
                                      int n) {
  long long* s =
      c.out + (((size_t)blockIdx.y * gridDim.x + blockIdx.x) * c.stamps + n) *
                  3;
  if (threadIdx.x == 0) {
    s[0] = n;
    s[1] = clock64();
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0 && atomicAdd(arrivals + n, 1u) == kWarps - 1)
    s[2] = clock64();
}

// The block's last stamp row: (-2 - its SM, its start and its end in ns of
// the global timer), so a reader sees which blocks ran at once.
__device__ __forceinline__ void stamp_block(const Clocks& c, long long t0) {
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* s = c.out + (((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                c.stamps + c.stamps - 1) * 3;
    s[0] = -2 - (long long)sm;
    s[1] = t0;
    s[2] = global_ns();
  }
}
#define CLOCK_SETUP()                                       \
  __shared__ unsigned clk_arrivals[kStamps];                \
  if (threadIdx.x < kStamps) clk_arrivals[threadIdx.x] = 0; \
  const long long clk_t0 = global_ns();                     \
  __syncthreads();                                          \
  stamp(a.clocks, clk_arrivals, kStart)
#define CLOCK_STAMP(n) stamp(a.clocks, clk_arrivals, (n))
#define CLOCK_END()        \
  CLOCK_STAMP(kWritten);   \
  stamp_block(a.clocks, clk_t0)
#else
#define CLOCK_SETUP()
#define CLOCK_STAMP(n)
#define CLOCK_END()
#endif

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

// floor(e / d) for 0 <= e < 2^16 and 1 <= d <= 2^10, from rcp = 1.f / d:
// (e + 1/2) / d lies at least 1 / (2 d) from an integer, far beyond the
// float product's error.
__device__ __forceinline__ int div_small(int e, float rcp) {
  return __float2int_rz(((float)e + 0.5f) * rcp);
}

// ---- the track lookups (geometry/frenet.py) -------------------------------

struct TrackArgs {
  const float *s0, *curv, *hw, *length;  // (lanes, nseg) x3, (lanes,)
  const unsigned char* open;             // scalar bool
  int nseg;
};

// A lane's track rows where the block reads them: staged in shared memory
// (nseg <= kMaxSeg) or in the tables themselves.
struct LaneRows {
  const float *s0, *curv, *hw;
  float L;
  int nseg;
  bool open;
};

// Segment of arc length s on a lane: wrap_s (clamp at 0 keeping NaN, then
// the closed track's remainder or the open track's one-lap subtraction),
// searchsorted(right=True) as torch's upper bound, clamp(idx - 1).
__device__ __forceinline__ int segment(const LaneRows& t, float s) {
  const float L = t.L;
  const float s1 = isnan(s) ? s : fmaxf(s, 0.f);
  float sw;
  if (t.open) {
    sw = (s1 >= L) ? fsub(s1, L) : s1;
  } else {
    float mod = fmodf(s1, L);
    if (mod != 0.f && ((L < 0.f) != (mod < 0.f))) mod = fadd(mod, L);
    sw = mod;
  }
  int start = 0, end = t.nseg;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(t.s0[mid] > sw)) start = mid + 1;
    else end = mid;
  }
  const int idx = start - 1;
  return idx < 0 ? 0 : (idx > t.nseg - 1 ? t.nseg - 1 : idx);
}

// ---- staging --------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One float of src into dst: by cp.async into shared memory, or (kPlain)
// by a plain load and store into global memory.
template <bool kPlain>
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  if (kPlain)
    *dst = *src;
  else
    cp_async4(dst, src);
}

// Copy n floats of src to dst, the block's threads in turn.
template <bool kPlain = false>
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads)
    copy4<kPlain>(dst + e, src + e);
}

// Stage lane ln's track rows into `rows` (3 nseg floats) where they fit;
// the caller waits and syncs.
__device__ __forceinline__ LaneRows stage_lane(const TrackArgs& t, int ln,
                                               float* rows) {
  const size_t off = (size_t)ln * t.nseg;
  LaneRows r;
  r.nseg = t.nseg;
  r.L = t.length[ln];
  r.open = *t.open;
  if (t.nseg <= kMaxSeg) {
    stage(rows, t.s0 + off, t.nseg);
    stage(rows + t.nseg, t.curv + off, t.nseg);
    stage(rows + 2 * t.nseg, t.hw + off, t.nseg);
    r.s0 = rows;
    r.curv = rows + t.nseg;
    r.hw = rows + 2 * t.nseg;
  } else {
    r.s0 = t.s0 + off;
    r.curv = t.curv + off;
    r.hw = t.hw + off;
  }
  return r;
}

// ---- the output image in shared memory -----------------------------------

// The block builds every output field of its stages in shared memory, in
// the output's order, then copies each field's range out as one contiguous
// run. A field's stages lie back to back; per stage, in floats:
enum Field { fF, fG, fd, fQ, fq, fR, fr, fS, fD, fE, flo, fhi, fslo, fshi,
             kFields };
__host__ __device__ inline int field_floats(int f, int nc, int m) {
  switch (f) {
    case fF: case fQ: return kNZ * kNZ;
    case fd: case fq: return kNZ;
    case fG: case fS: return kNZ * nc;
    case fR: return nc * nc;
    case fr: return nc;
    case fD: return m * kNZ;
    case fE: return m * nc;
    default: return m;  // lo, hi, soft_lo, soft_hi
  }
}
// Floats of a block's image: S stages of every field.
__host__ __device__ inline int image_floats(int nc, int m, int S) {
  return S * (2 * kNZ * kNZ + 2 * kNZ + 2 * kNZ * nc + nc * nc + nc +
              m * (kNZ + nc + 4));
}

// Floats of the NL kernel's neighbour arrays for nb neighbours and S
// stages: positions (2 per stage), prices, hp_opt's planes (2 per stage),
// the master flags, each pair's scalars (kPair per stage) and the plane
// controls' cost diagonal (nc = 2 + 2 nb; hp_opt only).
constexpr int kPair = 9;
__host__ __device__ inline int neighbour_floats(int nb, bool hp_opt, int S) {
  return nb * (S * (3 + kPair) + 1) + (hp_opt ? 2 * nb * S + 2 * nb : 0) +
         2;
}

// Dynamic shared memory of a launch: the image, the neighbour arrays
// (NL), then the lane's three track rows where they fit.
__host__ __device__ inline int smem_bytes(int nc, int m, int nseg,
                                          int extra, int S) {
  return 4 * (image_floats(nc, m, S) + extra +
              (nseg <= kMaxSeg ? 3 * nseg : 0));
}

// The StageQP's fields in the kernel's order (Field).
struct Out {
  float* field[kFields];
};

// Each field's offset in the image, in floats.
struct Layout {
  int off[kFields];
};
__device__ __forceinline__ Layout layout(int nc, int m, int S) {
  Layout L;
  int o = 0;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    L.off[f] = o;
    o += S * field_floats(f, nc, m);
  }
  return L;
}

// Copy the image of the block's stages [k0, k0 + ns) out: each field one
// contiguous range, copied by one warp, its lanes on neighbouring addresses
// (Q and q from stage k0 + 1 of their N + 1); the warps take their fields
// side by side (F, Q, D, G, S, E and the rest spread over the eight), so no
// thread runs the fields' loops one after another. Stage 0 of the
// (N+1)-stage cost (Q, q) is zero.
__device__ __forceinline__ void copy_out(const Out& o, const float* img,
                                         const Layout& L, int nc, int m,
                                         int p, int N, int k0, int ns) {
  // the warp of each field: F, G, d, Q, q, R, r, S, D, E, lo, hi, slo, shi
  constexpr int kOwner[kFields] = {0, 3, 6, 1, 6, 7, 7, 4, 2, 5, 5, 3, 4, 2};
  const size_t st = (size_t)p * N + k0;
  const size_t st1 = (size_t)p * (N + 1) + k0 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    if (warp != kOwner[f] % kWarps) continue;
    const int size = field_floats(f, nc, m);
    float* out = o.field[f] + (f == fQ || f == fq ? st1 : st) * size;
    const float* src = img + L.off[f];
    for (int e = lane; e < ns * size; e += 32) out[e] = src[e];
  }
  if (k0 == 0) {
    const size_t s0 = (size_t)p * (N + 1);
    for (int e = threadIdx.x; e < kNZ * kNZ; e += kThreads)
      o.field[fQ][s0 * kNZ * kNZ + e] = 0.f;
    if (threadIdx.x < kNZ) o.field[fq][s0 * kNZ + threadIdx.x] = 0.f;
  }
}

// Stage s's row i of the lifted dynamics F = [[Ad, Bd], [0, I]] (F's image
// holds rows 0-8 from the rows phase) and of G = [[Bd, 0], [I, 0]] (the
// extra columns of hp_opt's plane controls are zero).
__device__ __forceinline__ float G_entry(const float* Fs, int i, int c) {
  if (c >= 2) return 0.f;
  if (i < kNX) return Fs[i * kNZ + kNX + c];
  return (c == i - kNX) ? 1.f : 0.f;
}

// The rows that are the same for both kernels: F's lifted rows, d's zero
// tail, G, Q (diagonal Qd), R (diagonal Rd), S (zero). Task (kind, row)
// of stage s: kind 0 F's lifted rows (i < 2), 1 G, 2 Q, 3 R, 4 S.
__device__ __forceinline__ void common_row(float* img, const Layout& L,
                                           int kind, int s, int i, int nc,
                                           const float* Qd,
                                           const float* Rd) {
  const float* Fs = img + L.off[fF] + s * kNZ * kNZ;
  if (kind == 0) {  // F's lifted rows 9, 10
    float* out = img + L.off[fF] + s * kNZ * kNZ + (kNX + i) * kNZ;
    for (int c = 0; c < kNZ; ++c) out[c] = (c == kNX + i) ? 1.f : 0.f;
    img[L.off[fd] + s * kNZ + kNX + i] = 0.f;  // d's tail
  } else if (kind == 1) {
    float* out = img + L.off[fG] + (s * kNZ + i) * nc;
    for (int c = 0; c < nc; ++c) out[c] = G_entry(Fs, i, c);
  } else if (kind == 2) {
    float* out = img + L.off[fQ] + (s * kNZ + i) * kNZ;
    for (int c = 0; c < kNZ; ++c) out[c] = (c == i) ? Qd[i] : 0.f;
  } else if (kind == 3) {
    float* out = img + L.off[fR] + (s * nc + i) * nc;
    for (int c = 0; c < nc; ++c) out[c] = (c == i) ? Rd[i] : 0.f;
  } else {
    float* out = img + L.off[fS] + (s * kNZ + i) * nc;
    for (int c = 0; c < nc; ++c) out[c] = 0.f;
  }
}

// Task t (< ns (35 + nc)) of the rows both kernels share, kind-major (F's
// lifted rows 2 per stage, G 11, Q 11, R nc, S 11): its kind, stage and
// row, from rnc = 1.f / nc.
struct Task {
  int kind, s, i;
};
__device__ __forceinline__ Task common_task(int t, int ns, int nc,
                                            float rnc) {
  const int n0 = 2 * ns, n1 = n0 + kNZ * ns, n2 = n1 + kNZ * ns,
            n3 = n2 + nc * ns;
  if (t < n0) return {0, t >> 1, t & 1};
  const int kind = t < n1 ? 1 : t < n2 ? 2 : t < n3 ? 3 : 4;
  const int base = kind == 1 ? n0 : kind == 2 ? n1 : kind == 3 ? n2 : n3;
  const int width = kind == 3 ? nc : kNZ;
  const int s = div_small(t - base, kind == 3 ? rnc : 1.f / kNZ);
  return {kind, s, t - base - s * width};
}

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
  float* scratch;   // the spill's per-block image and neighbour arrays
  TrackArgs track;
  Out out;
  float c[kNLConsts];
  float rcp_m, rcp_I;
  int P, N, nb, coupling, trust, order, lane_const;
  int S;                  // stages per block
  Slots<kNLSlots> slots;  // the gains (16) and the limits (9)
#ifdef CMPC_SQP_QP_CLOCKS
  Clocks clocks;
#endif
};

// the slots: gains q (9), r (2), dr (2), qs (3, capped), then the
// SysLimits fields in order
enum Lim { kVxRef, kMinDist, kMaxVel, kMinVel, kMaxRs, kMaxLs, kMaxAc,
           kMaxDc, kSm };
enum Coupling { kEu = 0, kHp = 1, kHpOpt = 2 };

// The row that each group of eight row threads builds (a thread per
// stage), or -1: the four row warps take rows {0, 1}, {2, 3}, {4, 6},
// {7, 8, 5}, so that a warp runs at most three cases of the row switch and
// at most two pairs of sines.
__device__ __forceinline__ int row_of(int group) {
  // group g's row + 1 in nibble g: {0, 1, -, -, 2, 3, -, -, 4, 6, -, -,
  // 7, 8, 5, -}
  constexpr unsigned long long kRows = 0x0698007500430021ull;
  return (int)((kRows >> (4 * group)) & 15) - 1;
}

// Row i (< 9) of the analytic Jacobians of f_continuous (planners/nl.py
// _jacobians) and of the LPV matrices (dynamics/bicycle.py lpv_coeffs) at
// one stage, then the row of Ad, Bd and rd (planners/nl.py
// _linearize_horizon): F's row i (Ad's, then Bd's) and rd_i; x and u in
// shared memory. Each sine is taken only for the rows that use it.
__device__ __forceinline__ void nl_row(const NLArgs& a, int i,
                                       const float* x, const float* u,
                                       float kappa, float* Frow, float* rd) {
  const float* c = a.c;
  const float vx = x[0], vy = x[1], wz = x[2], ey = x[3];
  const float delta = u[0];
  const bool low = vx < c[kLowVel];
  const float vs = low ? 1.f : vx;
  float sd = 0.f, cd = 0.f, se = 0.f, ce = 0.f, st = 0.f, ct = 0.f;
  float inv = 0.f, inv2 = 0.f, den = 0.f, den2 = 0.f;
  if (i <= 2) {
    sd = sinf(delta);
    cd = cosf(delta);
    inv = fdiv(1.f, vs);
    inv2 = fmul(inv, inv);
  } else if (i == 3 || i == 4 || i == 6) {
    se = sinf(x[4]);
    ce = cosf(x[4]);
    den = fsub(1.f, fmul(ey, kappa));
    den2 = fmul(den, den);
  } else if (i >= 7) {
    st = sinf(x[5]);
    ct = cosf(x[5]);
  }
  const float a_ = c[kA], lf = c[kLf], Cf = c[kCf], Cr = c[kCr];
  const float vlw = fadd(vy, fmul(lf, wz));  // vy + lf wz
#define GATE(v) (low ? 0.f : (v))
  float J[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float Ju[2] = {0.f, 0.f};
  float A[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float B[2] = {0.f, 0.f};
  switch (i) {
    case 0: {
      const float mvs = fmul(vs, c[kM]);
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
      const float mvs = fmul(vs, c[kM]);
      const float lfcd = fsub(fmul(c[kLfCf], cd), c[kLrCr]);
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
      const float Ivs = fmul(vs, c[kI]);
      const float lfcd = fsub(fmul(c[kLfCf], cd), c[kLrCr]);
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
  const float fdi = fadd(x[i], fmul(dt, f));
  float Adr[9], Bdr[2];
  for (int l = 0; l < 9; ++l)
    Adr[l] = fadd(l == i ? 1.f : 0.f, fmul(dt, J[l]));
  Bdr[0] = fmul(dt, Ju[0]);
  Bdr[1] = fmul(dt, Ju[1]);
  for (int l = 0; l < 9; ++l) Frow[l] = Adr[l];
  Frow[kNX] = Bdr[0];
  Frow[kNX + 1] = Bdr[1];
  *rd = fsub(fsub(fdi, mv(Adr, x, 9, a.order)), mv(Bdr, u, 2, a.order));
}

// The scalars of one (stage, neighbour) pair, as the plain version forms
// them: the direction (gx, gy) of the coupling row (the distance gradient
// for eu and hp, the plane normal for hp_opt), what the row's bound takes
// beside the limits (pb: eu the distance, hp the midpoint's projection,
// hp_opt the plane's offset; pb2: eu the position's projection), and
// * eu / hp: f0, f1 the pair's price on (X, Y) (lam g_hat), f2 1 on eu's
//   master pair (the row unbounded);
// * hp_opt: f0, f1 the row's plane-control entries, f2 1 where the row is
//   the master's (mrow), ra, rb the plane controls' prices.
// The rows phase runs before the limits are in: pair_bound takes them.
enum PairField { kGx, kGy, kPb, kPb2, kF0, kF1, kF2, kRa, kRb };

template <bool HP_OPT>
__device__ __forceinline__ void nl_pair(const NLArgs& a, const float* x,
                                        const float* nxy, float lam_raw,
                                        float mm, const float* pl,
                                        float* out) {
  const float* c = a.c;
  const float px = x[kNX + 7], py = x[kNX + 8];  // stage k+1's position
  const float lam = fmul(fmul(c[kPriceScale], lam_raw), mm);
  const bool mrow = mm > 0.f;
  if (HP_OPT) {
    // price on the plane controls; own side of the plane, linearised in
    // (p, dtheta, db)
    const float th = pl[0], b = pl[1];
    const float sth = sinf(th), cth = cosf(th);
    const float ap_pn = fadd(fmul(-sth, nxy[0]), fmul(cth, nxy[1]));
    const float ap_p = fadd(fmul(-sth, px), fmul(cth, py));
    out[kGx] = cth;
    out[kGy] = sth;
    out[kPb] = b;
    out[kF0] = mrow ? ap_p : 0.f;
    out[kF1] = mrow ? 1.f : 0.f;
    out[kF2] = mrow ? 1.f : 0.f;
    out[kRa] = fmul(-lam, ap_pn);
    out[kRb] = -lam;
  } else {
    // the position of x_{k+1} along the distance gradient
    const float dx = fsub(px, nxy[0]), dy = fsub(py, nxy[1]);
    const float dist =
        __fsqrt_rn(fadd(fadd(fmul(dx, dx), fmul(dy, dy)), c[kEps]));
    const float ghx = fdiv(dx, dist), ghy = fdiv(dy, dist);
    if (a.coupling == kHp) {
      const float mx = fmul(0.5f, fadd(px, nxy[0]));
      const float my = fmul(0.5f, fadd(py, nxy[1]));
      out[kPb] = fadd(fmul(ghx, mx), fmul(ghy, my));
    } else {
      out[kPb] = dist;
      out[kPb2] = fadd(fmul(ghx, px), fmul(ghy, py));
    }
    out[kGx] = ghx;
    out[kGy] = ghy;
    out[kF0] = fmul(lam, ghx);
    out[kF1] = fmul(lam, ghy);
    out[kF2] = (a.coupling == kEu && !(fsub(1.f, mm) > 0.f)) ? 1.f : 0.f;
  }
}

// The pair's bound before dds is taken off it: eu (min_dist - dist) + g.p,
// hp min_dist / 2 + g.m, hp_opt -+ min_dist / 2 - b on the master's / the
// other's side.
template <bool HP_OPT>
__device__ __forceinline__ float pair_bound(const NLArgs& a,
                                            const float* pair,
                                            const float* lim) {
  if (HP_OPT) {
    const float dth2 = fmul(lim[kMinDist], 0.5f);
    return pair[kF2] != 0.f ? fsub(-dth2, pair[kPb]) : fsub(dth2, pair[kPb]);
  }
  if (a.coupling == kHp)
    return fadd(fmul(lim[kMinDist], 0.5f), pair[kPb]);
  return fadd(fsub(lim[kMinDist], pair[kPb]), pair[kPb2]);
}

// Stage s's sum over the neighbours j of pair field f, in the order of
// the plain version's torch.sum on the card (read off it by
// scripts/library_order.py): the product it sums keeps the neighbours'
// axis off the fastest stride, so each output is one thread's, over four
// accumulators: terms 4g + i into accumulator i while whole groups of four
// remain, the rest into accumulators 0, 1, ..., then ((a0 + a1) + a2) + a3.
__device__ __forceinline__ float neighbour_sum(const float* pair, int s,
                                               int nb, int f) {
  const float* t = pair + s * nb * kPair + f;  // term j at t[j * kPair]
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 3 < nb; j += 4) {
    a0 = fadd(a0, t[j * kPair]);
    a1 = fadd(a1, t[(j + 1) * kPair]);
    a2 = fadd(a2, t[(j + 2) * kPair]);
    a3 = fadd(a3, t[(j + 3) * kPair]);
  }
  if (j < nb) a0 = fadd(a0, t[j * kPair]);
  if (j + 1 < nb) a1 = fadd(a1, t[(j + 1) * kPair]);
  if (j + 2 < nb) a2 = fadd(a2, t[(j + 2) * kPair]);
  return fadd(fadd(fadd(a0, a1), a2), a3);
}

// At most 51 registers: five blocks of 256 threads on an SM, so the NL
// Monte-Carlo's 192 QPs x N=20 (576 blocks) run in one wave. SF: the
// stages per block when the kernel is compiled (kStages), or 0, a.S's.
// kSpill: the image and the neighbour arrays in the block's share of
// a.scratch, the track rows alone in dynamic shared memory.
template <bool HP_OPT, int SF, bool kSpill>
__global__ void __launch_bounds__(kThreads, 5)
    nl_qp_kernel(const __grid_constant__ NLArgs a) {
  // the output image, the neighbour arrays, then the lane's track rows
  extern __shared__ __align__(16) float dyn[];
  __shared__ float g[kNLSlots];   // this problem's gains, then its limits
  __shared__ float Qd[kNZ];
  __shared__ float xs[(kStages + 1) * kNX], us[kStages * 2];
  __shared__ float hws[kStages];  // the corridor's half-width per stage
  CLOCK_SETUP();
  const int N = a.N, nb = a.nb, p = blockIdx.y, tid = threadIdx.x;
  const int S = SF > 0 ? SF : a.S;
  const int nc = HP_OPT ? 2 + 2 * nb : 2;
  const int m = 4 + (HP_OPT ? 3 * nb : nb);
  const int k0 = blockIdx.x * S;
  const int ns = min(S, N - k0);
  const float* c = a.c;
  float* img =
      kSpill ? a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                               (image_floats(nc, m, S) +
                                neighbour_floats(nb, HP_OPT, S))
             : dyn;
  const Layout L = layout(nc, m, S);
  // the neighbour arrays (neighbour_floats): positions at stage k+1,
  // prices and hp_opt's planes by neighbour then stage, master flags,
  // each (stage, neighbour) pair's scalars, the cost's R diagonal
  float* nxy = img + image_floats(nc, m, S);
  float* lams = nxy + S * nb * 2;
  float* pls = lams + nb * S;
  float* mms = pls + (HP_OPT ? nb * S * 2 : 0);
  float* pair = mms + nb;
  float* Rd = pair + S * nb * kPair;

  // ---- load ----
  stage(xs, a.x + ((size_t)p * (N + 1) + k0) * kNX, (ns + 1) * kNX);
  stage(us, a.u + ((size_t)p * N + k0) * 2, ns * 2);
  stage<kSpill>(nxy, a.neigh + ((size_t)p * (N + 1) + k0 + 1) * nb * 2,
                ns * nb * 2);
  stage<kSpill>(mms, a.mmask + (size_t)p * nb, nb);
  for (int e = tid; e < nb * ns; e += kThreads) {
    const int j = e / ns, s = e - j * ns;
    copy4<kSpill>(lams + j * S + s,
                  a.lam + ((size_t)p * nb + j) * N + k0 + s);
    if (HP_OPT) {
      const float* src = a.planes + (((size_t)p * nb + j) * N + k0 + s) * 2;
      copy4<kSpill>(pls + (j * S + s) * 2, src);
      copy4<kSpill>(pls + (j * S + s) * 2 + 1, src + 1);
    }
  }
  // the slots: read now, needed after the rows (threads < 25 are row
  // threads, which store them when their row is done)
  const float slot = tid < kNLSlots ? a.slots.get(tid, p) : 0.f;
  const int ln = a.lane ? a.lane[p] : a.lane_const;
  const LaneRows tr = stage_lane(a.track, ln, kSpill ? dyn : Rd + nc);
  cp_async_wait_all();
  __syncthreads();
  CLOCK_STAMP(kLoaded);
  const float* lim = g + 16;

  // ---- rows: a thread per (row, stage) on the first four warps; on the ----
  // ---- others a thread per (stage, neighbour) pair, then per stage     ----
  constexpr int kRowThreads = 4 * 32;
  constexpr int kPairThreads = kThreads - kRowThreads - kStages;
  if (tid < kRowThreads) {
    const int i = row_of(tid >> 3), s = tid & 7;
    if (i >= 0 && s < ns) {
      const float* x = xs + s * kNX;
      nl_row(a, i, x, us + 2 * s, tr.curv[segment(tr, x[6])],
             img + L.off[fF] + (s * kNZ + i) * kNZ,
             img + L.off[fd] + s * kNZ + i);
    }
    if (tid < kNLSlots) {
      // qs is capped at SOFT_WEIGHT_CAP as torch.clamp_max does it
      const float v = (tid >= 13 && tid < 16) ? nanmin(slot, 1e4f) : slot;
      g[tid] = v;
      if (tid < kNZ) Qd[tid] = fmul(2.f, v);
      if (tid == 11 || tid == 12) Rd[tid - 11] = fmul(2.f, v);
    }
    for (int e = tid; e < nc; e += kRowThreads)
      if (e >= 2) Rd[e] = c[kPlaneR];
  } else if (tid < kRowThreads + kPairThreads) {
    for (int e = tid - kRowThreads; e < ns * nb; e += kPairThreads) {
      const int s = e / nb, j = e - s * nb;
      nl_pair<HP_OPT>(a, xs + s * kNX, nxy + (s * nb + j) * 2,
                      lams[j * S + s], mms[j],
                      HP_OPT ? pls + (j * S + s) * 2 : nullptr,
                      pair + (s * nb + j) * kPair);
    }
  } else {
    const int s = tid - (kRowThreads + kPairThreads);
    if (s < ns) hws[s] = tr.hw[segment(tr, xs[s * kNX + 6])];
  }
  __syncthreads();
  CLOCK_STAMP(kRowsDone);

  // ---- the image's other rows: a thread per (kind, stage, row) ----
  const float rnc = 1.f / nc, rm = 1.f / m;
  const float qs0 = g[13], qs2 = g[15];
  const bool trust = a.trust;
  auto pf = [&](int s, int j, int f) {
    return pair[(s * nb + j) * kPair + f];
  };
  // tasks per stage: F's lifted rows 2, G 11, Q 11, R nc, S 11, q 1, r 1,
  // D m, E m, bounds m
  const int n4 = (2 + 3 * kNZ + nc) * ns, n5 = n4 + ns, n6 = n5 + ns,
            n7 = n6 + m * ns, n8 = n7 + m * ns, n9 = n8 + m * ns;
  for (int t = tid; t < n9; t += kThreads) {
    if (t < n4) {  // the rows both kernels share
      const Task k = common_task(t, ns, nc, rnc);
      common_row(img, L, k.kind, k.s, k.i, nc, Qd, Rd);
      continue;
    }
    if (t < n5) {  // q: the tracking term, and eu / hp's price on (X, Y)
      const int s = t - n4;
      float* out = img + L.off[fq] + s * kNZ;
      out[0] = fmul(fmul(-2.f, g[0]), lim[kVxRef]);
      for (int e = 1; e < kNZ; ++e) out[e] = 0.f;
      if (!HP_OPT) {
        // master coupling price on (X, Y): q += -sum_j lam_j g_hat_j
        out[7] = fadd(0.f, -neighbour_sum(pair, s, nb, kF0));
        out[8] = fadd(0.f, -neighbour_sum(pair, s, nb, kF1));
      }
      continue;
    }
    if (t < n6) {  // r: hp_opt's prices on the plane controls
      const int s = t - n5;
      float* out = img + L.off[fr] + s * nc;
      out[0] = out[1] = 0.f;
      for (int j = 0; j < nc - 2; ++j)
        out[2 + j] = j < nb ? pf(s, j, kRa) : pf(s, j - nb, kRb);
      continue;
    }
    const int base = t < n7 ? n6 : (t < n8 ? n7 : n8);
    const int s = div_small(t - base, rm), row = t - base - s * m;
    const float* Fs = img + L.off[fF] + s * kNZ * kNZ;
    const float* rd = img + L.off[fd] + s * kNZ;
    const int j = row - 4;
    if (t < n7) {  // D
      float* out = img + L.off[fD] + (s * m + row) * kNZ;
      if (row == 0 || row == 1) {  // the velocity band, the lateral band
        const float* Fr = Fs + (row == 0 ? 0 : 3) * kNZ;
        for (int col = 0; col < kNZ; ++col) out[col] = Fr[col];
      } else if (row < 4 || j >= nb) {  // the input boxes; hp_opt's trust
        for (int col = 0; col < kNZ; ++col)
          out[col] = (row < 4 && col == kNX + row - 2) ? 1.f : 0.f;
      } else {  // coupling: the position of x_{k+1} along (gx, gy)
        const float gx = pf(s, j, kGx), gy = pf(s, j, kGy);
        for (int col = 0; col < kNZ; ++col)
          out[col] = fadd(fmul(gx, Fs[7 * kNZ + col]),
                          fmul(gy, Fs[8 * kNZ + col]));
      }
    } else if (t < n8) {  // E
      float* out = img + L.off[fE] + (s * m + row) * nc;
      if (row == 0 || row == 1) {
        for (int col = 0; col < nc; ++col)
          out[col] = G_entry(Fs, row == 0 ? 0 : 3, col);
      } else if (row < 4) {
        for (int col = 0; col < nc; ++col)
          out[col] = col == row - 2 ? 1.f : 0.f;
      } else if (j < nb) {
        const float gx = pf(s, j, kGx), gy = pf(s, j, kGy);
        for (int col = 0; col < nc; ++col)
          out[col] = fadd(fmul(gx, G_entry(Fs, 7, col)),
                          fmul(gy, G_entry(Fs, 8, col)));
        if (HP_OPT) {  // the row's plane controls
          out[2 + j] = pf(s, j, kF0);
          out[2 + nb + j] = pf(s, j, kF1);
        }
      } else {
        // hp_opt's trust rows on the plane perturbations: theta of pair
        // j - nb, then b of pair j - 2 nb (column 2 + nb + that pair)
        for (int col = 0; col < nc; ++col)
          out[col] = col == 2 + j - nb ? 1.f : 0.f;
      }
    } else {  // the row's bounds and soft weights
      float lo, hi, slo = INFINITY, shi = INFINITY;
      if (row < 2) {  // velocity band and lateral band, soft both sides
        const float eyub = fmul(hws[s], lim[kSm]);
        lo = row == 0 ? fsub(lim[kMinVel], rd[0]) : fsub(-eyub, rd[3]);
        hi = row == 0 ? fsub(lim[kMaxVel], rd[0]) : fsub(eyub, rd[3]);
        slo = shi = qs0;
      } else if (row == 2) {  // input boxes, hard, with the trust region
        const float u0 = us[2 * s];
        lo = trust ? nanmax(-lim[kMaxLs], fsub(u0, c[kUt0])) : -lim[kMaxLs];
        hi = trust ? nanmin(lim[kMaxRs], fadd(u0, c[kUt0])) : lim[kMaxRs];
      } else if (row == 3) {
        const float u1 = us[2 * s + 1];
        lo = trust ? nanmax(-lim[kMaxDc], fsub(u1, c[kUt1])) : -lim[kMaxDc];
        hi = trust ? nanmin(lim[kMaxAc], fadd(u1, c[kUt1])) : lim[kMaxAc];
      } else if (j < nb) {
        const float gx = pf(s, j, kGx), gy = pf(s, j, kGy);
        const float b = fsub(
            pair_bound<HP_OPT>(a, pair + (s * nb + j) * kPair, lim),
            fadd(fmul(gx, rd[7]), fmul(gy, rd[8])));
        const bool flag = pf(s, j, kF2) != 0.f;
        if (HP_OPT) {  // own side of the plane, the master's row above
          hi = flag ? b : INFINITY;
          lo = flag ? -INFINITY : b;
          shi = flag ? qs2 : INFINITY;
          slo = flag ? INFINITY : qs2;
        } else {  // eu's master pair unbounded
          lo = flag ? -INFINITY : b;
          hi = INFINITY;
          slo = qs2;
        }
      } else {  // hp_opt's hard trust boxes on the plane perturbations
        const bool theta = j < 2 * nb;
        const float tr = pf(s, theta ? j - nb : j - 2 * nb, kF2) != 0.f
                             ? c[theta ? kTrustTheta : kTrustB]
                             : 0.f;
        lo = -tr;
        hi = tr;
      }
      const int e = s * m + row;
      img[L.off[flo] + e] = lo;
      img[L.off[fhi] + e] = hi;
      img[L.off[fslo] + e] = slo;
      img[L.off[fshi] + e] = shi;
    }
  }
  __syncthreads();
  CLOCK_STAMP(kTailsDone);
  copy_out(a.out, img, L, nc, m, p, N, k0, ns);
  CLOCK_END();
}

// ============================================================================
// MPCC: planners/mpcc.py build_mpcc_qp_plain with dynamics/pacejka.py
// ============================================================================

// The last four: 1 / m and 1 / I in float64, then in float32 (each as the
// float32 division of 1 by the number in float32 rounds it).
enum MPCCConst {
  kPLf, kPLr, kPBf, kPCf, kPDf, kPBr, kPCr, kPDr, kPCm1, kPCm2, kPCr0,
  kPCr2, kPM, kPLong, kPEll2, kPMaxAlpha, kPNegMaxAlpha, kPDt,
  kPTrustDelta, kPTrustDrive, kPNegDeltaMax, kPDeltaMax, kPDriveMin,
  kPDriveMax, kPVxMin, kPFloor, kPSm, kPRcpM, kPRcpI, kPRcpMf, kPRcpIf,
  kMPCCConsts
};

struct MPCCArgs {
  const float *x, *u;
  TrackArgs track;
  Out out;
  double c[kMPCCConsts];
  int P, N, order;
  Slots<kMPCCSlots> slots;  // the gains
#ifdef CMPC_SQP_QP_CLOCKS
  Clocks clocks;
#endif
};

// the slots: MPCCGains in order
enum MG { kQProgress, kQContour, kQHeading, kQVy, kQWz, kRDelta, kRDrive,
          kDrDelta, kDrDrive, kWSoft };

// Forward-mode tangents by dtype, fixed at compile time: TU undefined (a
// constant's), TF float32, TD float64.
struct TU {};
struct TF {
  float v;
};
struct TD {
  double v;
};

__device__ __forceinline__ double dv(TF t) { return (double)t.v; }
__device__ __forceinline__ double dv(TD t) { return t.v; }

template <class T> struct IsTD { static constexpr bool value = false; };
template <> struct IsTD<TD> { static constexpr bool value = true; };

// tangent + tangent: an undefined side gives the other; a float64 side
// makes the sum float64 (the rules the Pacejka model instantiates: a
// constant's tangent meets only float32 ones)
__device__ __forceinline__ TF tadd(TU, TF b) { return b; }
__device__ __forceinline__ TF tadd(TF a, TF b) { return {fadd(a.v, b.v)}; }
__device__ __forceinline__ TD tadd(TF a, TD b) {
  return {__dadd_rn((double)a.v, b.v)};
}
__device__ __forceinline__ TD tadd(TD a, TF b) {
  return {__dadd_rn(a.v, (double)b.v)};
}
__device__ __forceinline__ TD tadd(TD a, TD b) {
  return {__dadd_rn(a.v, b.v)};
}
__device__ __forceinline__ TF tneg(TF t) { return {-t.v}; }
__device__ __forceinline__ TD tneg(TD t) { return {-t.v}; }
// tangent times or over a float32 primal, in the tangent's dtype
__device__ __forceinline__ TU tmulp(TU t, float) { return t; }
__device__ __forceinline__ TF tmulp(TF t, float p) { return {fmul(t.v, p)}; }
__device__ __forceinline__ TD tmulp(TD t, float p) {
  return {__dmul_rn(t.v, (double)p)};
}
__device__ __forceinline__ TF tdivp(TF t, float p) { return {fdiv(t.v, p)}; }
__device__ __forceinline__ TD tdivp(TD t, float p) {
  return {__ddiv_rn(t.v, (double)p)};
}

template <class T>
struct Du {
  float p;
  T t;
};
template <class T>
__device__ __forceinline__ Du<T> du(float p, T t) {
  return {p, t};
}

// the ops of the Pacejka model with their forward-mode rules; a Python
// number's zero tangent is float64, so a tangent meeting one turns float64
__device__ __forceinline__ Du<TD> d_mul_s(Du<TF> a, double s) {
  return {fmul(a.p, (float)s), {(double)fmul(a.t.v, (float)s)}};
}
__device__ __forceinline__ Du<TD> d_mul_s(Du<TD> a, double s) {
  return {fmul(a.p, (float)s), {__dmul_rn(a.t.v, s)}};
}
// a / number on the card: the primal times the float32 reciprocal r32,
// the float64 tangent times the float64 reciprocal r64
template <class T>
__device__ __forceinline__ Du<TD> d_div_s(Du<T> a, float r32, double r64) {
  return {fmul(a.p, r32), {__dmul_rn(dv(a.t), r64)}};
}
template <class T>
__device__ __forceinline__ Du<TD> d_sub_s(Du<T> a, double s) {
  return {fsub(a.p, (float)s), {dv(a.t)}};
}
template <class T>
__device__ __forceinline__ Du<T> d_rsub_s(double s, Du<T> a) {
  return {fsub((float)s, a.p), tneg(a.t)};
}
template <class T>
__device__ __forceinline__ Du<T> d_neg(Du<T> a) {
  return {-a.p, tneg(a.t)};
}
template <class A, class B>
__device__ __forceinline__ auto d_add(Du<A> a, Du<B> b) {
  return du(fadd(a.p, b.p), tadd(a.t, b.t));
}
template <class A, class B>
__device__ __forceinline__ auto d_sub(Du<A> a, Du<B> b) {
  return du(fsub(a.p, b.p), tadd(a.t, tneg(b.t)));
}
template <class A, class B>
__device__ __forceinline__ auto d_mul(Du<A> a, Du<B> b) {
  return du(fmul(a.p, b.p), tadd(tmulp(b.t, a.p), tmulp(a.t, b.p)));
}
// (a' - b' r) / b
template <class A, class B>
__device__ __forceinline__ auto d_div(Du<A> a, Du<B> b) {
  const float r = fdiv(a.p, b.p);
  return du(r, tdivp(tadd(a.t, tneg(tmulp(b.t, r))), b.p));
}
template <class T>
__device__ __forceinline__ Du<T> d_sin(Du<T> a) {
  return {sinf(a.p), tmulp(a.t, cosf(a.p))};
}
template <class T>
__device__ __forceinline__ Du<T> d_cos(Du<T> a) {
  return {cosf(a.p), tmulp(a.t, -sinf(a.p))};
}
template <class T>
__device__ __forceinline__ Du<T> d_atan(Du<T> a) {  // a' / (a a + 1)
  const float den = fadd(fmul(a.p, a.p), 1.f);
  return {atanf(a.p), tdivp(a.t, den)};
}
template <class Y, class X>
__device__ __forceinline__ auto d_atan2(Du<Y> y, Du<X> x) {
  // (-y x' + x y') / (y^2 + x^2)
  const float den = fadd(fmul(y.p, y.p), fmul(x.p, x.p));
  return du(atan2f(y.p, x.p),
            tdivp(tadd(tmulp(x.t, -y.p), tmulp(y.t, x.p)), den));
}
template <class T>
__device__ __forceinline__ Du<T> d_max_c(Du<T> a, float cst) {
  // torch.maximum against a constant: the tangent halved at a tie
  const float fac = (a.p == cst) ? 0.5f : ((a.p > cst) ? 1.f : 0.f);
  return {nanmax(a.p, cst), tmulp(a.t, fac)};
}
template <class T>
__device__ __forceinline__ Du<T> d_pow2(Du<T> a) {
  return {fmul(a.p, a.p), tmulp(a.t, fmul(2.f, a.p))};
}

// Floats of one MPCC stage's record beside the image: the discrete model
// fd (9), the tyre residuals (3), the tyre rows (3 x 11) and their upper
// bounds (3).
constexpr int kMFd = 0, kMVals = kMFd + 9, kMTyre = kMVals + 3,
              kMTyreHi = kMTyre + 3 * kNZ, kMRec = kMTyreHi + 3;

// an entry of fd = x + dt f's Jacobian: the seed plus dt times the
// tangent, in the stacked tangents' common dtype
template <class T>
__device__ __forceinline__ float fd_entry(float seed, T t, double dt,
                                          bool f64) {
  return f64 ? __double2float_rn(__dadd_rn(seed, __dmul_rn(dv(t), dt)))
             : fadd(seed, fmul((float)dv(t), (float)dt));
}
template <class T>
__device__ __forceinline__ float row_entry(T t, bool r64) {
  return r64 ? __double2float_rn(dv(t)) : (float)dv(t);
}

// Jacobian column `col` (x for 0..8, u for 9..10) of the continuous Pacejka
// dynamics (dynamics/pacejka.py f_continuous_pacejka) and of the three
// tyre residuals (friction ellipse, two slip-angle rows) at one stage: the
// jvp along that basis vector, as jacfwd computes it. Two threads share a
// column: PART 0 the tyre-force rows f0-f2 and the tyre residuals, PART 1
// the kinematic rows f3-f8 (the two share only the inputs). Each writes
// its rows of F's column col (into the stage's image Fs) and of the tyre
// rows (into the stage's record); column 0 also writes fd and the
// residuals.
template <int PART>
__device__ __forceinline__ void pacejka_column(const double* c,
                                               const float* xv,
                                               const float* uv, float kap,
                                               int col, float* Fs,
                                               float* rec) {
  Du<TF> x[9], u[2];
  for (int l = 0; l < 9; ++l) x[l] = {xv[l], {l == col ? 1.f : 0.f}};
  for (int l = 0; l < 2; ++l) u[l] = {uv[l], {9 + l == col ? 1.f : 0.f}};
  const Du<TF> vx0 = x[0], vy = x[1], wz = x[2], ey = x[3];
  const Du<TF> delta = u[0];
  const Du<TU> kappa = {kap, {}};
  const Du<TF> vx = vx0;
  const double dt = c[kPDt];
  // fd = x + dt f: the stacked tangents in their common dtype, float64
  // since f0-f2 are (the static_assert below)
  constexpr bool f64 = true;
  if constexpr (PART == 0) {
    const auto vxc = d_max_c(vx0, (float)c[kPFloor]);
    const auto af = d_add(
        d_neg(d_atan2(d_add(vy, d_mul_s(wz, c[kPLf])), vxc)), delta);
    const auto ar = d_neg(d_atan2(d_sub(vy, d_mul_s(wz, c[kPLr])), vxc));
    const auto F_fy = d_mul_s(
        d_sin(d_mul_s(d_atan(d_mul_s(af, c[kPBf])), c[kPCf])), c[kPDf]);
    const auto F_ry = d_mul_s(
        d_sin(d_mul_s(d_atan(d_mul_s(ar, c[kPBr])), c[kPCr])), c[kPDr]);
    const auto F_rx0 = d_sub_s(d_sub(d_mul_s(u[1], c[kPCm1]),
                                     d_mul(d_mul_s(u[1], c[kPCm2]), vx)),
                               c[kPCr0]);
    const auto F_rx = d_sub(F_rx0, d_mul(d_mul_s(vx, c[kPCr2]), vx));
    const double mass = c[kPM];
    const float rm32 = (float)c[kPRcpMf], rI32 = (float)c[kPRcpIf];
    const auto f0 = d_div_s(d_add(d_sub(F_rx, d_mul(F_fy, d_sin(delta))),
                                  d_mul(d_mul_s(vy, mass), wz)),
                            rm32, c[kPRcpM]);
    const auto f1 = d_div_s(d_sub(d_add(F_ry, d_mul(F_fy, d_cos(delta))),
                                  d_mul(d_mul_s(vx, mass), wz)),
                            rm32, c[kPRcpM]);
    const auto f2 = d_div_s(
        d_sub(d_mul(d_mul_s(F_fy, c[kPLf]), d_cos(delta)),
              d_mul_s(F_ry, c[kPLr])),
        rI32, c[kPRcpI]);
    static_assert(IsTD<decltype(f0.t)>::value &&
                      IsTD<decltype(f1.t)>::value &&
                      IsTD<decltype(f2.t)>::value,
                  "a / number makes the tangent float64");
    const auto row0 = d_sub_s(
        d_add(d_pow2(d_mul_s(F_rx, c[kPLong])), d_pow2(F_ry)), c[kPEll2]);
    const auto row1 = d_sub_s(af, c[kPMaxAlpha]);
    const auto row2 = d_rsub_s(c[kPNegMaxAlpha], af);
    Fs[0 * kNZ + col] = fd_entry(col == 0 ? 1.f : 0.f, f0.t, dt, f64);
    Fs[1 * kNZ + col] = fd_entry(col == 1 ? 1.f : 0.f, f1.t, dt, f64);
    Fs[2 * kNZ + col] = fd_entry(col == 2 ? 1.f : 0.f, f2.t, dt, f64);
    constexpr bool r64 = IsTD<decltype(row0.t)>::value ||
                         IsTD<decltype(row1.t)>::value ||
                         IsTD<decltype(row2.t)>::value;
    rec[kMTyre + col] = row_entry(row0.t, r64);
    rec[kMTyre + kNZ + col] = row_entry(row1.t, r64);
    rec[kMTyre + 2 * kNZ + col] = row_entry(row2.t, r64);
    if (col == 0) {
      const float dtf = (float)dt;
      rec[kMFd + 0] = fadd(xv[0], fmul(dtf, f0.p));
      rec[kMFd + 1] = fadd(xv[1], fmul(dtf, f1.p));
      rec[kMFd + 2] = fadd(xv[2], fmul(dtf, f2.p));
      rec[kMVals] = row0.p;
      rec[kMVals + 1] = row1.p;
      rec[kMVals + 2] = row2.p;
    }
  } else {
    const auto se = d_sin(x[4]), ce = d_cos(x[4]);
    const auto st = d_sin(x[5]), ct = d_cos(x[5]);
    const auto den = d_rsub_s(1.0, d_mul(ey, kappa));
    const auto f3 = d_add(d_mul(se, vx), d_mul(ce, vy));
    const auto f4 =
        d_add(d_add(d_mul(d_div(d_mul(d_neg(ce), kappa), den), vx),
                    d_mul(d_div(d_mul(se, kappa), den), vy)), wz);
    const auto f5 = wz;
    const auto f6 = d_add(d_mul(d_div(ce, den), vx),
                          d_mul(d_div(d_neg(se), den), vy));
    const auto f7 = d_sub(d_mul(ct, vx), d_mul(st, vy));
    const auto f8 = d_add(d_mul(st, vx), d_mul(ct, vy));
    Fs[3 * kNZ + col] = fd_entry(col == 3 ? 1.f : 0.f, f3.t, dt, f64);
    Fs[4 * kNZ + col] = fd_entry(col == 4 ? 1.f : 0.f, f4.t, dt, f64);
    Fs[5 * kNZ + col] = fd_entry(col == 5 ? 1.f : 0.f, f5.t, dt, f64);
    Fs[6 * kNZ + col] = fd_entry(col == 6 ? 1.f : 0.f, f6.t, dt, f64);
    Fs[7 * kNZ + col] = fd_entry(col == 7 ? 1.f : 0.f, f7.t, dt, f64);
    Fs[8 * kNZ + col] = fd_entry(col == 8 ? 1.f : 0.f, f8.t, dt, f64);
    if (col == 0) {
      const float dtf = (float)dt;
      const float fp[6] = {f3.p, f4.p, f5.p, f6.p, f7.p, f8.p};
      for (int i = 0; i < 6; ++i)
        rec[kMFd + 3 + i] = fadd(xv[3 + i], fmul(dtf, fp[i]));
    }
  }
}

// The gain of the cost's diagonal entry i: q_vy, q_wz, q_contour, q_heading
// on states 1-4, r_delta and r_drive on the lifted inputs; -1: none.
__device__ __forceinline__ int mpcc_q_slot(int i) {
  return i == 1 ? kQVy : i == 2 ? kQWz : i == 3 ? kQContour
       : i == 4 ? kQHeading : i == 9 ? kRDelta : i == 10 ? kRDrive : -1;
}

// At most 64 registers: four blocks of 256 threads on an SM.
__global__ void __launch_bounds__(kThreads, 4)
    mpcc_qp_kernel(const __grid_constant__ MPCCArgs a) {
  // the output image, then the track's rows
  extern __shared__ __align__(16) float dyn[];
  __shared__ float g[kMPCCSlots];  // this race's gains
  __shared__ float Qd[kNZ], Rd[2];
  __shared__ float xs[kStages * kNX], us[kStages * 2];
  __shared__ float recs[kStages * kMRec];
  __shared__ float eyub[kStages];  // the corridor's half-width per stage
  CLOCK_SETUP();
  constexpr int nc = 2, m = 7;
  const int N = a.N, p = blockIdx.y, tid = threadIdx.x;
  const int k0 = blockIdx.x * kStages;
  const int ns = min(kStages, N - k0);
  const double* c = a.c;
  const int order = a.order;
  float* img = dyn;
  const Layout L = layout(nc, m, kStages);

  // ---- load ----
  stage(xs, a.x + ((size_t)p * (N + 1) + k0) * kNX, ns * kNX);
  stage(us, a.u + ((size_t)p * N + k0) * 2, ns * 2);
  if (tid < kMPCCSlots) g[tid] = a.slots.get(tid, p);
  const LaneRows tr =
      stage_lane(a.track, 0, dyn + image_floats(nc, m, kStages));
  cp_async_wait_all();
  __syncthreads();
  CLOCK_STAMP(kLoaded);
  if (tid < kNZ) {
    const int q = mpcc_q_slot(tid);
    Qd[tid] = q < 0 ? 0.f : fmul(2.f, g[q]);
  }
  if (tid < nc) Rd[tid] = fmul(2.f, g[kDrDelta + tid]);

  // ---- the Jacobian columns: two threads per (column, stage) ----
  constexpr int kColThreads = kNZ * kStages;
  if (tid < 2 * kColThreads) {
    const int t = tid < kColThreads ? tid : tid - kColThreads;
    const int col = t >> 3, s = t & 7;
    if (s < ns) {
      const float* x = xs + s * kNX;
      const float kap = tr.curv[segment(tr, x[6])];
      float* Fs = img + L.off[fF] + s * kNZ * kNZ;
      if (tid < kColThreads)
        pacejka_column<0>(c, x, us + 2 * s, kap, col, Fs, recs + s * kMRec);
      else
        pacejka_column<1>(c, x, us + 2 * s, kap, col, Fs, recs + s * kMRec);
    }
  } else if (tid < 2 * kColThreads + kStages) {
    const int s = tid - 2 * kColThreads;
    if (s < ns)
      eyub[s] = fmul(tr.hw[segment(tr, xs[s * kNX + 6])], (float)c[kPSm]);
  }
  __syncthreads();
  CLOCK_STAMP(kRowsDone);

  // ---- rd and the tyre rows' bounds: a thread per (row, stage); the ----
  // ---- image's other rows: a thread per (kind, stage, row)         ----
  const float r7 = 1.f / m;
  const float w = g[kWSoft];
  if (tid < (kNX + 3) * kStages) {
    const int i = tid >> 3, s = tid & 7;
    if (s < ns) {
      const float* rec = recs + s * kMRec;
      const float* Fs = img + L.off[fF] + s * kNZ * kNZ;
      const float* x = xs + s * kNX;
      const float* u = us + 2 * s;
      if (i < kNX) {
        img[L.off[fd] + s * kNZ + i] =
            fsub(fsub(rec[kMFd + i], mv(Fs + i * kNZ, x, 9, order)),
                 mv(Fs + i * kNZ + kNX, u, 2, order));
      } else {
        // tyre rows: g.x + gu.u <= g.x_bar + gu.u_bar - value
        const int r = i - kNX;
        const float* gr = rec + kMTyre + r * kNZ;
        recs[s * kMRec + kMTyreHi + r] =
            fadd(fadd(-rec[kMVals + r], mv(gr, x, 9, order)),
                 mv(gr + kNX, u, 2, order));
      }
    }
  }
  // tasks per stage: F's lifted rows 2, G 11, Q 11, R 2, S 11, q 1, r 1,
  // D 7, E 7 (the rows that need neither rd nor the tyre bounds)
  const int n4 = (2 + 3 * kNZ + nc) * ns, n5 = n4 + ns, n6 = n5 + ns,
            n7 = n6 + m * ns, n8 = n7 + m * ns;
  for (int t = tid; t < n8; t += kThreads) {
    if (t < n4) {  // the rows both kernels share
      const Task k = common_task(t, ns, nc, 1.f / nc);
      common_row(img, L, k.kind, k.s, k.i, nc, Qd, Rd);
    } else if (t < n5) {  // q: the progress reward on s
      float* out = img + L.off[fq] + (t - n4) * kNZ;
      for (int e = 0; e < kNZ; ++e)
        out[e] = e == 6 ? fmul(-2.f, g[kQProgress]) : 0.f;
    } else if (t < n6) {
      float* out = img + L.off[fr] + (t - n5) * nc;
      out[0] = out[1] = 0.f;
    } else {
      const int base = t < n7 ? n6 : n7;
      const int s = div_small(t - base, r7), row = t - base - s * m;
      const float* Fs = img + L.off[fF] + s * kNZ * kNZ;
      const float* tyre = recs + s * kMRec + kMTyre + max(row - 3, 0) * kNZ;
      if (t < n7) {  // D
        float* out = img + L.off[fD] + (s * m + row) * kNZ;
        if (row == 0 || row == 6) {  // corridor on ey_{k+1}; vx >= vx_min
          const float* Fr = Fs + (row == 0 ? 3 : 0) * kNZ;
          for (int col = 0; col < kNZ; ++col) out[col] = Fr[col];
        } else if (row < 3) {  // the input boxes
          for (int col = 0; col < kNZ; ++col)
            out[col] = col == kNX + row - 1 ? 1.f : 0.f;
        } else {  // the tyre rows
          for (int col = 0; col < kNZ; ++col) out[col] = tyre[col];
        }
      } else {  // E
        float* out = img + L.off[fE] + (s * m + row) * nc;
        for (int col = 0; col < nc; ++col)
          out[col] = (row == 0 || row == 6)
                         ? G_entry(Fs, row == 0 ? 3 : 0, col)
                     : row < 3 ? (col == row - 1 ? 1.f : 0.f)
                               : tyre[kNX + col];
      }
    }
  }
  __syncthreads();
  CLOCK_STAMP(kTailsDone);
  // ---- the bounds and soft weights (they read rd and the tyre bounds) ----
  for (int t = tid; t < m * ns; t += kThreads) {
    const int s = div_small(t, r7), row = t - s * m;
    const float* rd = img + L.off[fd] + s * kNZ;
    float lo = -INFINITY, hi = INFINITY, slo = INFINITY, shi = INFINITY;
    if (row == 0) {  // track corridor on ey_{k+1}, soft both sides
      lo = fsub(-eyub[s], rd[3]);
      hi = fsub(eyub[s], rd[3]);
      slo = shi = w;
    } else if (row == 1) {  // input boxes with the SQP trust region
      lo = nanmax(fsub(us[2 * s], (float)c[kPTrustDelta]),
                  (float)c[kPNegDeltaMax]);
      hi = nanmin(fadd(us[2 * s], (float)c[kPTrustDelta]),
                  (float)c[kPDeltaMax]);
    } else if (row == 2) {
      lo = nanmax(fsub(us[2 * s + 1], (float)c[kPTrustDrive]),
                  (float)c[kPDriveMin]);
      hi = nanmin(fadd(us[2 * s + 1], (float)c[kPTrustDrive]),
                  (float)c[kPDriveMax]);
    } else if (row < 6) {  // the tyre rows, soft above
      hi = recs[s * kMRec + kMTyreHi + row - 3];
      shi = w;
    } else {  // vx >= vx_min, soft
      lo = fsub((float)c[kPVxMin], rd[0]);
      slo = w;
    }
    img[L.off[flo] + t] = lo;
    img[L.off[fhi] + t] = hi;
    img[L.off[fslo] + t] = slo;
    img[L.off[fshi] + t] = shi;
  }
  __syncthreads();
  copy_out(a.out, img, L, nc, m, p, N, k0, ns);
  CLOCK_END();
}

inline Out out_from(void* const* o) {
  Out r;
  for (int f = 0; f < kFields; ++f) r.field[f] = (float*)o[f];
  return r;
}

inline TrackArgs track_from(void* const* t, int nseg) {
  return {(const float*)t[0], (const float*)t[1], (const float*)t[2],
          (const float*)t[3], (const unsigned char*)t[4], nseg};
}

// A launch's dynamic shared memory beyond the 48 KB a block takes without
// opting in (the kernels' static shared memory is under 8 KB).
template <class Kernel>
cudaError_t fit_smem(Kernel kernel, int smem) {
  if (smem <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool HP_OPT, int SF, bool kSpill = false>
cudaError_t nl_launch_with(const NLArgs& a, dim3 grid, int smem,
                           cudaStream_t s) {
  const cudaError_t e = fit_smem(nl_qp_kernel<HP_OPT, SF, kSpill>, smem);
  if (e != cudaSuccess) return e;
  nl_qp_kernel<HP_OPT, SF, kSpill><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// ptrs: the inputs (7), the track (5), the outputs (14), the slots (25),
// the spill's scratch (or null). The caller's smem_bytes and stages per
// block (1..kStages) must be the kernel's: the block's image takes kStages
// stages where it fits; with a scratch, kStages stages and only the track
// rows in shared memory.
int nl_launch(NLArgs& a, void* const* ptrs, const double* consts,
              const double* values, const int* ints, void* stream) {
  a.x = (const float*)ptrs[0];
  a.u = (const float*)ptrs[1];
  a.lam = (const float*)ptrs[2];
  a.neigh = (const float*)ptrs[3];
  a.mmask = (const float*)ptrs[4];
  a.planes = (const float*)ptrs[5];
  a.lane = (const int*)ptrs[6];
  a.scratch = (float*)ptrs[26 + kNLSlots];
  a.P = ints[0];
  a.N = ints[1];
  a.nb = ints[2];
  a.coupling = ints[3];
  a.trust = ints[4];
  a.order = ints[5];
  a.track = track_from(ptrs + 7, ints[6]);
  a.lane_const = ints[7];
  const int smem = ints[8];
  a.S = ints[9];
  a.out = out_from(ptrs + 12);
  for (int i = 0; i < kNLConsts; ++i) a.c[i] = (float)consts[i];
  slots_from(a.slots, ptrs + 26, ints + 10, values);
  a.rcp_m = 1.f / (float)consts[kM];
  a.rcp_I = 1.f / (float)consts[kI];
  if (a.P <= 0 || a.N <= 0 || a.nb < 0 || a.coupling < 0 ||
      a.coupling > 2 || (a.coupling == kHpOpt && !a.planes) ||
      a.track.nseg <= 0 || a.S < 1 || a.S > kStages)
    return (int)cudaErrorInvalidValue;
  const bool hp_opt = a.coupling == kHpOpt;
  const int nc = 2 + (hp_opt ? 2 * a.nb : 0);
  const int m = 4 + (hp_opt ? 3 * a.nb : a.nb);
  const int staged = a.track.nseg <= kMaxSeg ? 3 * a.track.nseg : 0;
  if (a.scratch ? (smem != 4 * staged || a.S != kStages)
                : smem != smem_bytes(nc, m, a.track.nseg,
                                     neighbour_floats(a.nb, hp_opt, a.S),
                                     a.S))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + a.S - 1) / a.S, a.P);
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.scratch)
    return (int)(hp_opt ? nl_launch_with<true, kStages, true>(a, grid, smem, s)
                        : nl_launch_with<false, kStages, true>(a, grid, smem,
                                                               s));
  if (a.S == kStages)
    return (int)(hp_opt ? nl_launch_with<true, kStages>(a, grid, smem, s)
                        : nl_launch_with<false, kStages>(a, grid, smem, s));
  return (int)(hp_opt ? nl_launch_with<true, 0>(a, grid, smem, s)
                      : nl_launch_with<false, 0>(a, grid, smem, s));
}

// ptrs: the inputs (2), the track (5), the outputs (14), the slots (10).
int mpcc_launch(MPCCArgs& a, void* const* ptrs, const double* consts,
                const double* values, const int* ints, void* stream) {
  a.x = (const float*)ptrs[0];
  a.u = (const float*)ptrs[1];
  a.P = ints[0];
  a.N = ints[1];
  a.order = ints[2];
  a.track = track_from(ptrs + 2, ints[3]);
  const int smem = ints[4];
  a.out = out_from(ptrs + 7);
  for (int i = 0; i < kMPCCConsts; ++i) a.c[i] = consts[i];
  slots_from(a.slots, ptrs + 21, ints + 5, values);
  if (a.P <= 0 || a.N <= 0 || a.track.nseg <= 0 ||
      smem != smem_bytes(2, 7, a.track.nseg, 0, kStages))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = fit_smem(mpcc_qp_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + kStages - 1) / kStages, a.P);
  mpcc_qp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define SQP_QP_PARAMS                                                   \
  void *const *ptrs, const double *consts, const double *values,        \
      const int *ints, void *stream
#define SQP_QP_FIELDS ptrs, consts, values, ints, stream

#ifndef CMPC_SQP_QP_CLOCKS
// ptrs: x_bar (P,N+1,9), u_bar (P,N,2), lambdas (P,nb,N), neigh_xy
// (P,N+1,nb,2), master_mask (P,nb), planes0 (P,nb,N,2) or null, lane (P,)
// int32 or null; the track's s0, curv, halfwidth (lanes, nseg),
// track_length (lanes,), open_flag (bool); the outputs F, G, d, Q, q, R,
// r, S, D, E, lo, hi, soft_lo, soft_hi; the slots' pointers: the gains q
// (9), r (2), dr (2), qs (3) and the 9 limits (Slots). consts: the NLConst
// values; values: the slots' numbers; ints: P, N, nb, coupling, trust,
// order, nseg, the lane a null lane stands for, the dynamic shared memory
// (smem_bytes), the stages per block, then the slots' strides.
extern "C" int cmpc_nl_qp(SQP_QP_PARAMS) {
  NLArgs a;
  return nl_launch(a, SQP_QP_FIELDS);
}

// ptrs: x_bar (P,N+1,9), u_bar (P,N,2); the track as cmpc_nl_qp (lane 0);
// the outputs as cmpc_nl_qp; the 10 gains' pointers. consts: the
// MPCCConst values; values: the slots' numbers; ints: P, N, order, nseg,
// the dynamic shared memory (smem_bytes), then the slots' strides.
extern "C" int cmpc_mpcc_qp(SQP_QP_PARAMS) {
  MPCCArgs a;
  return mpcc_launch(a, SQP_QP_FIELDS);
}
#else
// The clock-stamped build: the arguments of cmpc_nl_qp / cmpc_mpcc_qp, then
// the stamps (P * stage groups, stamps, 3) int64, each (label, thread 0's
// clock, the last warp's clock), in the block's order.
extern "C" int cmpc_nl_qp_clocked(SQP_QP_PARAMS, long long* clocks,
                                  int stamps) {
  NLArgs a;
  a.clocks = {clocks, stamps};
  if (stamps != kStamps + 1) return (int)cudaErrorInvalidValue;
  return nl_launch(a, SQP_QP_FIELDS);
}

extern "C" int cmpc_mpcc_qp_clocked(SQP_QP_PARAMS, long long* clocks,
                                    int stamps) {
  MPCCArgs a;
  a.clocks = {clocks, stamps};
  if (stamps != kStamps + 1) return (int)cudaErrorInvalidValue;
  return mpcc_launch(a, SQP_QP_FIELDS);
}

// Stamps per block: the labelled ones and the block's row.
extern "C" int cmpc_sqp_qp_clock_stamps() { return kStamps + 1; }

extern "C" const char* cmpc_sqp_qp_clock_names() {
  return "-;slots, staged inputs;Jacobian rows, pairs;image rows;"
         "bounds, copy out";
}
#endif
