// The fixed data of one ADMM epoch, hand-written for Hopper (sm_90a), FP32
// on CUDA cores: the rho-augmented cost, the backward Riccati pass over its
// quadratic terms and the soft-row prox factors, for a batch of stage QPs.
//
// Replaces no Pallas kernel. In JAX this is colaborativempc_tpu/ops/
// admm.py:159 admm_epoch_inputs, plain XLA that the solver's compiled
// while_loop fuses (row mask, build_admm_cost :118-130, lqr_factorize of
// ops/lqr.py:71-101, the Quu inverse and the prox factors). The port's
// plain version (ops/admm.py admm_epoch_inputs_plain) runs it as eager
// torch, about 11 small batched ops per stage plus a Cholesky: some 220
// launches per epoch at N=20. cmpc_epoch_data computes every field of
// ops/admm.py ADMMEpochData that is not a QP tensor of its own in one
// launch: K, Quu_inv, Qxu, m, the masked D and E, rv, fac_lo and fac_hi.
//
// What bounds it on the H100. Each input read once and each output written
// once is ~34 MB at the LPV headline (768 QPs, N=20, nz=11, nc=2, mr=6),
// 0.010 ms at 3.35 TB/s; its ~7,000 FP32 operations per stage are 0.0016 ms
// at 67 TFLOP/s. So the bound is bytes, but the real time is set by the
// latency of the Riccati chain: N dependent stage steps per QP, each a few
// short products separated by barriers, and at a large batch by the SM's
// issue rate over the resident blocks. The design is laid out from the
// split of the first version (PERF.md section 6; clock stamps of
// scripts/epoch_data_split.py): one thread per nz x nz entry, every loop
// strided from thread 0, five barriers per stage, ~13,500-14,700 cycles per
// stage, every interval slow: rows with P F, P G, m ~5,300-5,900; Qxx, Qxu,
// Quu ~3,800-4,100; the Cholesky on thread 0 ~1,550 (nc=6: ~6,900); the
// solve from a local array ~1,800; P ~1,000.
//
// What the design does about it.
// * Everything that does not depend on P_{k+1} leaves the chain. Stages
//   stream through shared memory in chunks of up to 8 stages (two slots;
//   cp.async brings the next chunk while this one runs, each matrix
//   transposed on the way in). On arrival, one pass over the chunk forms
//   the rows (rv, fac_lo, fac_hi, written out), the masked rows Dm, Em
//   (written out) and their rv-weighted copies Dw, Ew; a second pass forms
//   the augmentations Q + Dw'Dm, S + Dw'Em and R + Ew'Em in place of Q, S
//   and R. Both passes run over the chunk's stages at once: three barriers
//   per chunk (arrival, rows, augmentations), not per stage.
// * The chain runs three barrier intervals per stage, each kind of entry
//   on warps of its own (no warp runs two kinds one after the other):
//   (1) P F, P G and m = P d (192 threads at nz=11, nc=2);
//   (2) Qxx, Qxu and Quu, each one sum added to its precomputed base;
//   (3) up to nc = 8, every thread that needs K factors the small Quu
//       itself, in the same order (so the same bits): the thread of P_k's
//       entry (i, j), i <= j, solves K's columns i and j and writes P_k
//       (i, j) and (j, i) (the two are the same sum); the diagonal thread
//       writes K's column; nc more threads solve Quu_inv's columns. The
//       factor, the right-hand sides and the solves live in registers: the
//       kernel is instantiated for nc <= 2 and nc <= 8, the loops over nc
//       unrolled to that bound. Above nc = 8 (NL hp_opt from five agents)
//       the factor lives in shared memory: warp 0 factors Quu in place
//       (the rows of a column on its lanes), then a thread per gain column
//       and per Quu_inv column solves it in the stage's R and S slots
//       (consumed by then), then a thread per entry of P_k's upper
//       triangle forms it: three barriers where the small case has one.
// * Every product is a sum along two rows of shared memory: P, F', G',
//   (P F)', (P G)', D', E' and their weighted copies are kept a row per
//   vector, the entries at the row's end after zeros. Up to 32 in every
//   dimension a row is 12 floats wide (nz, mr <= 12) or 32, both kinds
//   alike; beyond, a vector of nz entries takes 12 floats (nz <= 12) or
//   nz rounded up to whole float4s, and one of mr entries mr rounded up
//   (the widths are then runtime values). A row is read as float4s, and
//   the leading zeros add fmaf(0, 0, +0) = +0 to a sum that is still +0,
//   so the sums need no select. m's two halves are sums along P's rows and
//   d kept a second time split into halves the same way.
// * __launch_bounds__ hold the nc <= 2 kernel to 72 registers (4 blocks of
//   192 threads per SM) and the nc <= 8 one to 96 (rows of 12 floats).
// * Order of operations: bit for bit the plain version's on the card. In
//   float32 the MPCC planner's QPs cancel so much (Qxu ~ 7e4 out of far
//   larger terms) that two summation orders land ~1e-3 of scale apart, so
//   only the same order agrees with the plain version. The kernel follows
//   the order of the card's batched library routines that the plain
//   version calls (cuBLAS batched GEMM, cuSOLVER batched Cholesky, MAGMA
//   batched solves), read off this build's results on the H100
//   (scripts/library_order.py, PERF.md): a matrix product sums its terms
//   as fused multiply-adds in index order from zero (dot_row; also over
//   more than 32 rows); a matrix-vector product (m = P d) sums two halves,
//   [0, ceil(n/2)) and the rest, and adds them; the Cholesky factor goes
//   column by column, L_jj = sqrt(a_jj - ...), L_ij = (a_ij - ...) * (1 /
//   L_jj), where the earlier columns' terms come in panels: the columns of
//   the current panel of 16 as fused multiply-adds onto a_ij, each earlier
//   panel of 16 within the current block of 64, and each earlier block of
//   64, as a sum of its own from zero, subtracted (up to nc = 16: one
//   chain); the solves split the rows recursively, a bottom part of the
//   largest 16 * 2^k below the rows, down to blocks of at most 16 rows,
//   which go forward with the terms in index order and back with them in
//   reverse, each row times 1 / L_ii; a part's rows take the other part's
//   terms as a sum of their own from zero in index order, subtracted. (At
//   nc = 17 the library's back solve orders row 0 otherwise; nc is 2 or
//   even in every family.) Separate terms are added as
//   the plain formulas group them: rv = (rho * mask) * rho_scale; Dw = Dm
//   * rv, Ew = Em * rv; Qxx = (Q + Dw'Dm) + F'(P F); Quu = (R + Ew'Em) +
//   G'(P G); Qxu = (S + Dw'Em) + F'(P G); Quu <- 0.5 (Quu + Quu') + reg I;
//   P <- 0.5 (M + M'), M = Qxx + Qxu K. Every other operation is an
//   explicit round-to-nearest intrinsic, so nvcc contracts nothing else.
//   For a single QP the libraries take other routines, so a single QP is
//   compared with the plain version as a batch of two (the QP twice).
// * A Quu that is not positive definite (a pivot that is not > 0, or NaN)
//   makes that stage's whole Cholesky factor NaN, as JAX's cholesky does,
//   so K, Quu_inv and every earlier stage's data come out NaN.
//
// Built with -DCMPC_EPOCH_DATA_CLOCKS (ops/_build.py
// load_epoch_data_clocks, a library of its own), the kernel also stamps
// clock64() at each barrier: thread 0's arrival and the last warp's, per
// block, into a buffer the caller passes (cmpc_epoch_data_clocked). The
// default build has no stamps.
//
// * Any fleet: where the block's layout does not fit in shared memory even
//   at one stage per chunk (rows of runtime width: NL hp_opt from 36
//   agents, LPV from ~930), the plan (ops/cuda_lqr.py epoch_data_plan)
//   puts the whole layout (the slots, P, its halves, (P F)', (P G)', Qxx,
//   Qxu, Quu, rho_scale, the reciprocal diagonal) into a per-block global
//   scratch, one stage per chunk; staging is then plain loads and stores
//   (kSpill) in place of cp.async, and __syncthreads orders them within
//   the block as before. The arithmetic and its order are those of the
//   shared-memory launch, so the bits are too.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrapper (ops/cuda_lqr.py epoch_data_batched) checks; rho_scale is
// (P, mr); soft_lo / soft_hi may be null (every row hard). Plain C
// interface for ctypes; the entry checks the launch plan (ops/cuda_lqr.py
// epoch_data_plan: threads, chunk, shared bytes, the spill's scratch),
// launches on the given stream and returns cudaGetLastError(). Any nz, nc
// and mr: the block's layout in shared memory where it fits, else in the
// scratch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#ifdef CMPC_EPOCH_DATA_CLOCKS
struct Clocks {
  long long* out;  // (P, stamps, 3): label, thread 0's clock, last warp's
  int stamps;
};

// Stamp n of this block: thread 0's arrival at the barrier that follows,
// and the arrival of the block's last warp (the barrier's release).
__device__ __forceinline__ void stamp(const Clocks& c, unsigned* arrivals,
                                      int& n, int label) {
  if (n < c.stamps) {
    long long* s = c.out + ((size_t)blockIdx.x * c.stamps + n) * 3;
    if (threadIdx.x == 0) {
      s[0] = label;
      s[1] = clock64();
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const unsigned warps = (blockDim.x + 31) / 32;
      if (atomicAdd(arrivals, 1u) % warps == warps - 1) s[2] = clock64();
    }
  }
  ++n;
}
#define CLOCK_STAMP(label) stamp(a.clocks, &clk_arrivals, clk_n, (label))

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block's last stamp row: (-2 - its SM, its start and its end in ns of
// the global timer), so a reader sees which blocks ran at once.
__device__ __forceinline__ void stamp_block(const Clocks& c, long long t0) {
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* s = c.out + ((size_t)blockIdx.x * c.stamps + c.stamps - 1) * 3;
    s[0] = -2 - (long long)sm;
    s[1] = t0;
    s[2] = global_ns();
  }
}
#else
#define CLOCK_STAMP(label)
#endif

// Stamp labels, in the order of cmpc_epoch_data_clock_names.
enum Label { kChain1 = 1, kChain2, kChain3, kArrival, kRows, kAugment };

struct DataArgs {
  const float *F, *G, *d, *Q, *R, *S, *D, *E, *lo, *hi, *slo, *shi, *rs;
  float *K, *Qi, *Qxu, *m, *Dm, *Em, *rv, *flo, *fhi;
  float* scratch;  // the spill's per-block layouts (or null)
  int P, N, nz, nc, mr, chunk;
  float rho, reg;
#ifdef CMPC_EPOCH_DATA_CLOCKS
  Clocks clocks;
#endif
};

// n rounded up to whole float4s: every field and row in shared memory
// starts on 16 bytes.
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Controls up to which the factor and the solves live in registers; above,
// in shared memory.
constexpr int kRegNC = 8;

// The widths of the rows in shared memory, in floats: wz for a vector of
// nz entries, wr for one of mr entries; the entries sit at the row's end,
// after zeros. Up to 32 in every dimension both are 12 (nz, mr <= 12) or
// 32 (the kernel's DIM); beyond ("wide"), wz is 12 (nz <= 12) or nz and wr
// mr, each rounded up to whole float4s.
__host__ __device__ inline bool wide_dims(int nz, int nc, int mr) {
  return nz > 32 || nc > 32 || mr > 32;
}

__host__ __device__ inline int width_z(int nz, int nc, int mr) {
  if (!wide_dims(nz, nc, mr)) return nz <= 12 && mr <= 12 ? 12 : 32;
  return nz <= 12 ? 12 : round4(nz);
}

__host__ __device__ inline int width_r(int nz, int nc, int mr) {
  if (!wide_dims(nz, nc, mr)) return nz <= 12 && mr <= 12 ? 12 : 32;
  return round4(mr);
}

// Floats of one stage in a chunk slot: F and G transposed (a row per
// column) and d's two halves (a row each), rows of wz; Q, R, S; D and E
// transposed and the rv-weighted D' and E' (a row per column), rows of wr;
// lo, hi, soft_lo, soft_hi. Q, S and R become the augmentations in place,
// D' and E' the masked rows.
__host__ __device__ inline int stage_floats_of(int nz, int nc, int mr,
                                               int wz, int wr) {
  return wz == wr ? (3 * (nz + nc) + 2) * wz + round4(nz * nz) +
                        round4(nc * nc) + round4(nz * nc) + 4 * round4(mr)
                  : (nz + nc + 2) * wz + 2 * (nz + nc) * wr + round4(nz * nz) +
                        round4(nc * nc) + round4(nz * nc) + 4 * round4(mr);
}

__host__ __device__ inline int data_stage_floats(int nz, int nc, int mr) {
  return stage_floats_of(nz, nc, mr, width_z(nz, nc, mr),
                         width_r(nz, nc, mr));
}

// Floats of one block's shared memory: two slots of `chunk` stages, the
// value Hessian P, the two halves of its rows, (P F)' (a row each per row
// or column), (P G)', Qxx, Qxu, Quu, rho_scale and, above kRegNC controls,
// 1 / L_jj of the factor.
__host__ __device__ inline int data_block_floats(int nz, int nc, int mr,
                                                 int chunk) {
  return 2 * chunk * data_stage_floats(nz, nc, mr) +
         (4 * nz + nc) * width_z(nz, nc, mr) + round4(nz * nz) +
         round4(nz * nc) + round4(nc * nc) + round4(mr) +
         round4(nc > kRegNC ? nc : 0);
}

// Whole warps: each kind of entry of an interval starts on a warp of its
// own, so no warp runs two kinds of chain one after the other.
__host__ __device__ inline int warps_of(int n) { return (n + 31) / 32 * 32; }

// The threads of a block: the largest of the three chain intervals (P F,
// P G, m; Qxx, Qxu, Quu; P's upper triangle, Quu_inv's columns), each
// kind of entry in whole warps, at most 1024. The chunk's passes stride
// over them.
__host__ __device__ inline int data_threads(int nz, int nc) {
  const int one = warps_of(nz * nz) + warps_of(nz * nc) + warps_of(nz);
  const int two = warps_of(nz * nz) + warps_of(nz * nc) + warps_of(nc * nc);
  const int three = warps_of(nz * (nz + 1) / 2) + warps_of(nc);
  int t = one > two ? one : two;
  t = t > three ? t : three;
  return t < 1024 ? t : 1024;
}

// floor(o / n) from inv = 1 / n in single precision: exact for 0 <= o <
// 2^20 and n <= 1024 (the quotient's distance from an integer, at least
// 0.5 / n, outweighs the rounding, at most ~1.2e-7 (o + 0.5) / n).
__device__ __forceinline__ int div_small(int o, float inv) {
  return (int)(((float)o + 0.5f) * inv);
}

// A chunk slot holds each field for its `chunk` stages, stage after stage.
struct Slot {
  float *Ft, *Gt, *Q, *R, *S, *d, *Dt, *Et, *Dwt, *Ewt, *lo, *hi, *slo, *shi;
};

// The kernel's widths (width_z, width_r): fixed when it is compiled up to
// 32 in every dimension, runtime values beyond.
struct Widths {
  int z, r;
};

__device__ inline Slot slot_at(float* base, int half, int C, int nz, int nc,
                               int mr, Widths w) {
  const int Wz = w.z, Wr = w.r;
  Slot s;
  float* p = base + (size_t)half * C * stage_floats_of(nz, nc, mr, Wz, Wr);
  s.Ft = p;   p += C * nz * Wz;
  s.Gt = p;   p += C * nc * Wz;
  s.Q = p;    p += C * round4(nz * nz);
  s.R = p;    p += C * round4(nc * nc);
  s.S = p;    p += C * round4(nz * nc);
  s.d = p;    p += 2 * C * Wz;  // d's halves [0, ceil(nz/2)), the rest
  s.Dt = p;   p += C * nz * Wr;
  s.Et = p;   p += C * nc * Wr;
  s.Dwt = p;  p += C * nz * Wr;
  s.Ewt = p;  p += C * nc * Wr;
  s.lo = p;   p += C * round4(mr);
  s.hi = p;   p += C * round4(mr);
  s.slo = p;  p += C * round4(mr);
  s.shi = p;
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
#endif
}

// One float from global memory into the block's layout: asynchronously
// into shared memory, or, where the layout is spilled (kSpill), a plain
// load and store into the global scratch.
template <bool kSpill>
__device__ __forceinline__ void stage4(float* dst, const float* src) {
  if (kSpill)
    *dst = *src;
  else
    cp_async4(dst, src);
}

// n stages of a (rows x cols) row-major field into the slot as stage after
// stage of the transpose, each column a row of W floats ending in its
// entries.
template <bool kSpill>
__device__ inline void load_transposed(float* dst, const float* src, int n,
                                       int rows, int cols, int W) {
  const float inv_cols = 1.f / cols, inv_rows = 1.f / rows;
  dst += W - rows;
  for (int o = threadIdx.x; o < n * rows * cols; o += blockDim.x) {
    const int r = div_small(o, inv_cols), c = o - r * cols;  // r = t rows + i
    const int t = div_small(r, inv_rows), i = r - t * rows;
    stage4<kSpill>(dst + (t * cols + c) * W + i, src + o);
  }
}

// n stages of `per` floats each into stage slots of `stride` floats.
template <bool kSpill>
__device__ inline void load_padded(float* dst, const float* src, int n,
                                   int per, int stride) {
  const float inv = 1.f / per;
  for (int o = threadIdx.x; o < n * per; o += blockDim.x) {
    const int t = div_small(o, inv);
    stage4<kSpill>(dst + t * stride + (o - t * per), src + o);
  }
}

__device__ inline void fill_padded(float* dst, float v, int n, int per,
                                   int stride) {
  const float inv = 1.f / per;
  for (int o = threadIdx.x; o < n * per; o += blockDim.x) {
    const int t = div_small(o, inv);
    dst[t * stride + (o - t * per)] = v;
  }
}

// Stages [k0, k1) of problem p into a slot, asynchronously as one group
// (kSpill: plain loads and stores); absent soft weights are +inf (hard
// rows).
template <bool kSpill>
__device__ inline void load_chunk(const DataArgs& a, const Slot& s, int p,
                                  int k0, int k1, Widths w) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr, n = k1 - k0;
  const int Wz = w.z, Wr = w.r, lr = round4(mr);
  const size_t st = (size_t)p * N + k0;
  load_transposed<kSpill>(s.Ft, a.F + st * nz * nz, n, nz, nz, Wz);
  load_transposed<kSpill>(s.Gt, a.G + st * nz * nc, n, nz, nc, Wz);
  load_padded<kSpill>(s.Q, a.Q + ((size_t)p * (N + 1) + k0) * nz * nz, n,
                      nz * nz, round4(nz * nz));
  load_padded<kSpill>(s.R, a.R + st * nc * nc, n, nc * nc, round4(nc * nc));
  load_padded<kSpill>(s.S, a.S + st * nz * nc, n, nz * nc, round4(nz * nc));
  const int h = (nz + 1) / 2;
  const float inv_nz = 1.f / nz;
  for (int o = threadIdx.x; o < n * nz; o += blockDim.x) {
    const int t = div_small(o, inv_nz), l = o - t * nz;
    stage4<kSpill>(
        s.d + 2 * t * Wz + (l < h ? Wz - h + l : 2 * Wz - nz + l),
        a.d + st * nz + o);
  }
  load_transposed<kSpill>(s.Dt, a.D + st * mr * nz, n, mr, nz, Wr);
  load_transposed<kSpill>(s.Et, a.E + st * mr * nc, n, mr, nc, Wr);
  load_padded<kSpill>(s.lo, a.lo + st * mr, n, mr, lr);
  load_padded<kSpill>(s.hi, a.hi + st * mr, n, mr, lr);
  if (a.slo)
    load_padded<kSpill>(s.slo, a.slo + st * mr, n, mr, lr);
  else
    fill_padded(s.slo, INFINITY, n, mr, lr);
  if (a.shi)
    load_padded<kSpill>(s.shi, a.shi + st * mr, n, mr, lr);
  else
    fill_padded(s.shi, INFINITY, n, mr, lr);
  if (!kSpill) cp_async_commit();
}

// Row j's mask (a finite bound on either side), as the plain version forms
// it; rv = (rho * mask) * rho_scale.
__device__ __forceinline__ float row_mask(const float* lo, const float* hi,
                                          int j) {
  return (isfinite(lo[j]) || isfinite(hi[j])) ? 1.f : 0.f;
}

// The sum over a row of W entries of a[l] * b[l], one fused multiply-add
// per term in index order from zero (the order of the card's batched GEMM),
// a and b rows in shared memory on 16 bytes, read as float4s. A row's
// leading zeros add fmaf(0, 0, +0) = +0 to the sum while it is still +0,
// so the sum is that of the entries alone, with no select. W > 0 fixes
// the width when the kernel is compiled; W = 0 takes it from w.
template <int W>
__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int w) {
  float acc = 0.f;
  const int quads = (W > 0 ? W : w) / 4;
#pragma unroll
  for (int q = 0; q < quads; ++q) {
    const float4 u = reinterpret_cast<const float4*>(a)[q];
    const float4 v = reinterpret_cast<const float4*>(b)[q];
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
    acc = fmaf(u.z, v.z, acc);
    acc = fmaf(u.w, v.w, acc);
  }
  return acc;
}

// The loops over nc below run to NC and skip what lies at or past nc; up
// to NC = 8 they are unrolled, so the factor, the right-hand sides and the
// solves stay in registers. Up to 16 controls the card's routines take no
// panels, so these are their order.

// The Cholesky factor of 0.5 (Quu + Quu') + reg I (Quu row-major nc x nc
// in shared memory) into registers, column by column as the card's batched
// routine; all NaN unless every pivot is > 0 (the plain version's NaN for
// a failed cholesky_ex, as JAX's cholesky). rcp[j] = 1 / L_jj.
template <int NC>
__device__ __forceinline__ void factor(const float* Quu, float reg, int nc,
                                       float (&L)[NC][NC], float (&rcp)[NC]) {
  bool ok = true;
#pragma unroll(NC <= 8 ? NC : 1)
  for (int j = 0; j < NC; ++j) {
#pragma unroll(NC <= 8 ? NC : 1)
    for (int i = j; i < NC; ++i) {
      if (i < nc) {
        float v =
            __fmul_rn(0.5f, __fadd_rn(Quu[i * nc + j], Quu[j * nc + i]));
        v = __fadd_rn(v, i == j ? reg : 0.f);
#pragma unroll(NC <= 8 ? NC : 1)
        for (int l = 0; l < j; ++l) v = fmaf(-L[i][l], L[j][l], v);
        if (i == j) {
          if (!(v > 0.f)) ok = false;
          L[j][j] = __fsqrt_rn(v);
          rcp[j] = __frcp_rn(L[j][j]);
        } else {
          L[i][j] = __fmul_rn(v, rcp[j]);
        }
      }
    }
  }
  if (!ok) {
#pragma unroll(NC <= 8 ? NC : 1)
    for (int i = 0; i < NC; ++i) {
      rcp[i] = NAN;
#pragma unroll(NC <= 8 ? NC : 1)
      for (int j = 0; j <= i; ++j) L[i][j] = NAN;
    }
  }
}

// Solve L L' x = b in place (b of length nc, in registers): forward with
// the terms in index order, back with them in reverse, each row times
// 1 / L_ii, as the card's batched solve.
template <int NC>
__device__ __forceinline__ void chol_solve(const float (&L)[NC][NC],
                                           const float (&rcp)[NC],
                                           float (&x)[NC], int nc) {
#pragma unroll(NC <= 8 ? NC : 1)
  for (int i = 0; i < NC; ++i) {
    if (i < nc) {
      float s = x[i];
#pragma unroll(NC <= 8 ? NC : 1)
      for (int j = 0; j < i; ++j) s = fmaf(-L[i][j], x[j], s);
      x[i] = __fmul_rn(s, rcp[i]);
    }
  }
#pragma unroll(NC <= 8 ? NC : 1)
  for (int i = NC - 1; i >= 0; --i) {
    if (i < nc) {
      float s = x[i];
#pragma unroll(NC <= 8 ? NC : 1)
      for (int j = NC - 1; j > i; --j)
        if (j < nc) s = fmaf(-L[j][i], x[j], s);
      x[i] = __fmul_rn(s, rcp[i]);
    }
  }
}

// K's column c: -(Quu^-1 Qxu')[:, c], from Qxu's row c.
template <int NC>
__device__ __forceinline__ void gain_column(const float (&L)[NC][NC],
                                            const float (&rcp)[NC],
                                            const float* Qxu, int c, int nc,
                                            float (&k)[NC]) {
#pragma unroll(NC <= 8 ? NC : 1)
  for (int u = 0; u < NC; ++u) k[u] = u < nc ? Qxu[c * nc + u] : 0.f;
  chol_solve<NC>(L, rcp, k, nc);
#pragma unroll(NC <= 8 ? NC : 1)
  for (int u = 0; u < NC; ++u) k[u] = -k[u];
}

// Qxx[i][j] + sum over u of Qxu[i][u] K[u][j], the terms in index order.
template <int NC>
__device__ __forceinline__ float closed_loop(const float* Qxx,
                                             const float* Qxu,
                                             const float (&kj)[NC], int i,
                                             int j, int nz, int nc) {
  float acc = 0.f;
#pragma unroll(NC <= 8 ? NC : 1)
  for (int u = 0; u < NC; ++u)
    if (u < nc) acc = fmaf(Qxu[i * nc + u], kj[u], acc);
  return __fadd_rn(Qxx[i * nz + j], acc);
}

// Above kRegNC controls: the factor in shared memory, in the card's
// batched Cholesky's order (the header). Warp 0 factors 0.5 (A + A') + reg
// I in place (A row-major nc x nc), a column at a time, its lanes on the
// column's rows; the lower triangle becomes the factor, rcp[j] = 1 / L_jj;
// all NaN unless every pivot is > 0. Entry (i, j) reads its own a_ij, the
// upper a_ji and the factor's earlier columns, so the loads and stores of
// one column never meet.
__device__ void factor_shared(float* A, float* rcp, float reg, int nc,
                              int lane) {
  bool ok = true;
  for (int j = 0; j < nc; ++j) {
    const int O = j & ~63, J0 = j & ~15;
    float d = 0.f;
    for (int i0 = j; i0 < nc; i0 += 32) {
      const int i = i0 + lane;
      float v = 0.f;
      if (i < nc) {
        const float* Li = A + i * nc;
        const float* Lj = A + j * nc;
        v = __fmul_rn(0.5f, __fadd_rn(Li[j], A[j * nc + i]));
        v = __fadd_rn(v, i == j ? reg : 0.f);
        // earlier blocks of 64, then earlier panels of 16, each a sum of
        // its own from zero; then the current panel onto the entry
        for (int p0 = 0; p0 < J0; p0 += p0 < O ? 64 : 16) {
          const int p1 = p0 + (p0 < O ? 64 : 16);
          float acc = 0.f;
          for (int l = p0; l < p1; ++l) acc = fmaf(Li[l], Lj[l], acc);
          v = __fsub_rn(v, acc);
        }
        for (int l = J0; l < j; ++l) v = fmaf(-Li[l], Lj[l], v);
      }
      if (i0 == j) d = __shfl_sync(0xffffffffu, v, 0);
      const float Ljj = __fsqrt_rn(d), r = __frcp_rn(Ljj);
      if (i < nc) A[i * nc + j] = i == j ? Ljj : __fmul_rn(v, r);
      if (i0 == j) {
        if (!(d > 0.f)) ok = false;
        if (lane == 0) rcp[j] = r;
      }
    }
    __syncwarp();
  }
  if (!ok) {
    for (int o = lane; o < nc * nc; o += 32) {
      const int i = o / nc, j = o - i * nc;
      if (j <= i) A[o] = NAN;
    }
    for (int j = lane; j < nc; j += 32) rcp[j] = NAN;
  }
  __syncwarp();
}

// Rows of the top part of a triangular solve of m > 16 rows: the bottom
// part is the largest 16 * 2^k below m.
__device__ __forceinline__ int solve_split(int m) {
  int b = 16;
  while (2 * b < m) b *= 2;
  return m - b;
}

// Solve L L' x = x in place, L the factor in A's lower triangle (nc x nc)
// and rcp its diagonal's reciprocals, x[u * ld] the thread's right-hand
// side, in the card's batched solve's order (the header): the rows split
// recursively down to blocks of at most 16, the other part's terms a sum
// of their own from zero, subtracted; in a block, forward in index order,
// back in reverse, each row times 1 / L_ii.
__device__ void solve_shared(const float* A, const float* rcp, float* x,
                             int ld, int nc) {
  for (int i = 0; i < nc; ++i) {
    float v = x[i * ld];
    int s = 0, e = nc;
    while (e - s > 16) {
      const int m1 = solve_split(e - s);
      if (i >= s + m1) {
        float acc = 0.f;
        for (int j = s; j < s + m1; ++j)
          acc = fmaf(A[i * nc + j], x[j * ld], acc);
        v = __fsub_rn(v, acc);
        s += m1;
      } else {
        e = s + m1;
      }
    }
    for (int j = s; j < i; ++j) v = fmaf(-A[i * nc + j], x[j * ld], v);
    x[i * ld] = __fmul_rn(v, rcp[i]);
  }
  for (int i = nc - 1; i >= 0; --i) {
    float v = x[i * ld];
    int s = 0, e = nc;
    while (e - s > 16) {
      const int m1 = solve_split(e - s);
      if (i < s + m1) {
        float acc = 0.f;
        for (int j = s + m1; j < e; ++j)
          acc = fmaf(A[j * nc + i], x[j * ld], acc);
        v = __fsub_rn(v, acc);
        e = s + m1;
      } else {
        s += m1;
      }
    }
    for (int j = e - 1; j > i; --j) v = fmaf(-A[j * nc + i], x[j * ld], v);
    x[i * ld] = __fmul_rn(v, rcp[i]);
  }
}

// The kinds of entry of one pass, each starting on a warp of its own: o
// falls in kind 0, 1 or 2 at index q of that kind (or past every kind).
__device__ __forceinline__ int kind_of(int o, int n0, int n1, int n2,
                                       int& q) {
  const int w0 = warps_of(n0), w1 = warps_of(n1);
  q = o < w0 ? o : (o < w0 + w1 ? o - w0 : o - w0 - w1);
  const int kind = o < w0 ? 0 : (o < w0 + w1 ? 1 : 2);
  return q < (kind == 0 ? n0 : (kind == 1 ? n1 : n2)) ? kind : 3;
}

// Entry o of a pass of three kinds (n0, n1, n2 entries, rows of c0, c1,
// c2 columns): its kind (3 past every kind), row i and column j.
struct Entry {
  int kind, q, i, j;
};

__device__ __forceinline__ Entry entry_of(int o, int n0, int c0, int n1,
                                          int c1, int n2, int c2) {
  Entry e;
  e.kind = kind_of(o, n0, n1, n2, e.q);
  const int cols = e.kind == 0 ? c0 : (e.kind == 1 ? c1 : c2);
  e.i = e.kind < 3 ? e.q / cols : 0;
  e.j = e.q - e.i * cols;
  return e;
}

// Entry o of the last interval: P's upper-triangle entry (i, j), i <= j,
// row by row (kind 0), or Quu_inv's column q (kind 1).
__device__ __forceinline__ Entry last_entry_of(int o, int nz, int nc) {
  Entry e;
  e.kind = kind_of(o, nz * (nz + 1) / 2, nc, 0, e.q);
  int i = 0, j = e.kind == 0 ? e.q : 0;
  while (j >= nz - i) {
    j -= nz - i;
    ++i;
  }
  e.i = i;
  e.j = i + j;
  return e;
}

// Stages per chunk, at most.
constexpr int kMaxChunk = 8;

// DIM > 0: up to 32 in every dimension, rows of DIM floats (12 or 32) for
// both kinds of vector; DIM = 0: rows of width_z / width_r floats, runtime
// values. NC >= nc (2 or 8) bounds the loops of the factor and the solves
// in registers; NC = 0: the factor in shared memory (nc > kRegNC). kSpill:
// the block's layout in its share of a.scratch (DIM = 0 only).
template <int NC, int DIM, bool kSpill>
__global__ void __launch_bounds__(
    NC == 2 && DIM == 12 ? 224 : (NC == 8 && DIM == 12 ? 320 : 1024),
    NC == 2 && DIM == 12 ? 4 : (NC == 8 && DIM == 12 ? 2 : 1))
    epoch_data_kernel(DataArgs a) {
  extern __shared__ __align__(16) float dyn[];
  const int p = blockIdx.x;
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr, C = a.chunk;
  float* const smem =
      kSpill ? a.scratch + (size_t)p * data_block_floats(nz, nc, mr, C) : dyn;
  const int tid = threadIdx.x, T = blockDim.x;
  // a row: zeros, then its entries; Wz for nz entries, Wr for mr
  const int Wz = DIM > 0 ? DIM : width_z(nz, nc, mr);
  const int Wr = DIM > 0 ? DIM : width_r(nz, nc, mr);
  const int pz = Wz - nz, pr = Wr - mr, lr = round4(mr), h = (nz + 1) / 2;
#ifdef CMPC_EPOCH_DATA_CLOCKS
  __shared__ unsigned clk_arrivals;
  int clk_n = 0;
  if (tid == 0) clk_arrivals = 0;
  const long long clk_t0 = global_ns();
#endif

  const Widths ws = {Wz, Wr};
  float* w = smem + 2 * C * stage_floats_of(nz, nc, mr, Wz, Wr);
  float* Pm = w;   w += nz * Wz;           // value Hessian P_{k+1}, rows
  float* Plo = w;  w += nz * Wz;           // its rows' halves, as d's
  float* Phi = w;  w += nz * Wz;
  float* PFt = w;  w += nz * Wz;           // (P F)', a row per column
  float* PGt = w;  w += nc * Wz;           // (P G)'
  float* Qxx = w;  w += round4(nz * nz);   // row-major
  float* Qxu = w;  w += round4(nz * nc);
  float* Quu = w;  w += round4(nc * nc);   // NC = 0: then the factor
  float* rsc = w;

  // the rows' leading zeros: nothing writes them after this
  const int zero4 = data_block_floats(nz, nc, mr, C) / 4;
  for (int o = tid; o < zero4; o += T)
    reinterpret_cast<float4*>(smem)[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // P_N = Q_N (the terminal cost is not augmented), rho_scale, chunk 0
  const float inv_nz = 1.f / nz;
  for (int o = tid; o < nz * nz; o += T) {
    const int i = div_small(o, inv_nz), j = o - i * nz;
    const float v = a.Q[((size_t)p * (N + 1) + N) * nz * nz + o];
    Pm[i * Wz + pz + j] = v;
    (j < h ? Plo : Phi)[i * Wz + (j < h ? Wz - h : Wz - nz) + j] = v;
  }
  for (int o = tid; o < mr; o += T) rsc[o] = a.rs[(size_t)p * mr + o];
  load_chunk<kSpill>(a, slot_at(smem, 0, C, nz, nc, mr, ws), p,
                     N > C ? N - C : 0, N, ws);

  const int chunks = (N + C - 1) / C;
  const int tri = nz * (nz + 1) / 2;
  // each thread's entry of every pass, where the pass needs no more
  // threads than the block has (the others decode as they stride)
  const Entry e1 = entry_of(tid, nz * nz, nz, nz * nc, nc, nz, 1);
  const Entry e2 = entry_of(tid, nz * nz, nz, nz * nc, nc, nc * nc, nc);
  const Entry e3 = last_entry_of(tid, nz, nc);
  const float inv_mr = 1.f / mr;
  for (int c = 0; c < chunks; ++c) {
    const int k1 = N - c * C, k0 = k1 > C ? k1 - C : 0, n = k1 - k0;
    const Slot s = slot_at(smem, c & 1, C, nz, nc, mr, ws);
    // the next chunk streams into the other slot while this one runs
    if (c + 1 < chunks) {
      load_chunk<kSpill>(a, slot_at(smem, (c + 1) & 1, C, nz, nc, mr, ws), p,
                         k0 > C ? k0 - C : 0, k0, ws);
      if (!kSpill) cp_async_wait<1>();
    } else {
      if (!kSpill) cp_async_wait<0>();
    }
    CLOCK_STAMP(kArrival);
    __syncthreads();

    // rows of the chunk: rv and the prox factors, one thread per row and
    // stage (written out); the masked rows Dm, Em (written out, and in
    // place of D', E') and Dw = Dm rv, Ew = Em rv, one thread per entry
    // over the chunk's stages
    const size_t st0 = (size_t)p * N + k0;
    for (int o = tid; o < warps_of(C * mr) + warps_of(mr * nz) +
                              warps_of(mr * nc);
         o += T) {
      int q;
      const int kind = kind_of(o, C * mr, mr * nz, mr * nc, q);
      if (kind == 0) {
        const int t = div_small(q, inv_mr), j = q - t * mr;
        if (t < n) {
          const int e = t * lr + j;
          const float r = __fmul_rn(
              __fmul_rn(a.rho, row_mask(s.lo, s.hi, e)), rsc[j]);
          const float safe = r > 0.f ? r : 1.f;
          const float sl = s.slo[e], sh = s.shi[e];
          a.rv[st0 * mr + q] = r;
          a.flo[st0 * mr + q] =
              isinf(sl) ? 0.f
                        : __fdiv_rn(safe, __fadd_rn(safe, __fmul_rn(2.f, sl)));
          a.fhi[st0 * mr + q] =
              isinf(sh) ? 0.f
                        : __fdiv_rn(safe, __fadd_rn(safe, __fmul_rn(2.f, sh)));
        }
      } else if (kind < 3) {
        // q = row * width + col, the order of the global rows
        const int width = kind == 1 ? nz : nc;
        const int j = kind == 1 ? div_small(q, inv_nz) : q / nc;
        const int col = q - j * width;
        float* src = (kind == 1 ? s.Dt : s.Et) + col * Wr + pr + j;
        float* wgt = (kind == 1 ? s.Dwt : s.Ewt) + col * Wr + pr + j;
        float* out = (kind == 1 ? a.Dm + st0 * mr * nz
                                : a.Em + st0 * mr * nc) + q;
        const int stride = width * Wr, gstride = mr * width;
        const float rj = rsc[j];
        for (int t = 0; t < n; ++t) {
          const float mask = row_mask(s.lo, s.hi, t * lr + j);
          const float v = __fmul_rn(src[t * stride], mask);
          src[t * stride] = v;
          wgt[t * stride] = __fmul_rn(v, __fmul_rn(__fmul_rn(a.rho, mask), rj));
          out[t * gstride] = v;
        }
      }
    }
    CLOCK_STAMP(kRows);
    __syncthreads();

    // the augmentations of the chunk, in place, one thread per entry over
    // the chunk's stages: Q + Dw'Dm, S + Dw'Em, R + Ew'Em
    for (int o = tid; o < warps_of(nz * nz) + warps_of(nz * nc) +
                              warps_of(nc * nc);
         o += T) {
      const Entry e =
          o == tid ? e2 : entry_of(o, nz * nz, nz, nz * nc, nc, nc * nc, nc);
      if (e.kind == 3) continue;
      const float* lhs = (e.kind == 2 ? s.Ewt : s.Dwt) + e.i * Wr;
      const float* rhs = (e.kind == 0 ? s.Dt : s.Et) + e.j * Wr;
      const int lw = (e.kind == 2 ? nc : nz) * Wr;
      const int rw = (e.kind == 0 ? nz : nc) * Wr;
      float* base = (e.kind == 0 ? s.Q : (e.kind == 1 ? s.S : s.R)) + e.q;
      const int per = e.kind == 0 ? round4(nz * nz)
                                  : (e.kind == 1 ? round4(nz * nc)
                                                 : round4(nc * nc));
      // four stages at a time: their sums, then their stores (a past-the-
      // end stage repeats the last one and is not stored)
      for (int t0 = 0; t0 < n; t0 += 4) {
        float r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int tt = t0 + u < n ? t0 + u : n - 1;
          r[u] = dot_row<DIM>(lhs + tt * lw, rhs + tt * rw, Wr);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t0 + u < n)
            base[(t0 + u) * per] = __fadd_rn(base[(t0 + u) * per], r[u]);
      }
    }
    CLOCK_STAMP(kAugment);
    __syncthreads();

    for (int k = k1 - 1; k >= k0; --k) {
      const int t = k - k0;
      const size_t st = (size_t)p * N + k;
      const float* Ft = s.Ft + t * nz * Wz;
      const float* Gt = s.Gt + t * nc * Wz;

      // (1) P F, P G (both kept transposed) and m = P d (two halves,
      //     then their sum)
      for (int o = tid; o < warps_of(nz * nz) + warps_of(nz * nc) +
                                warps_of(nz);
           o += T) {
        const Entry e =
            o == tid ? e1 : entry_of(o, nz * nz, nz, nz * nc, nc, nz, 1);
        if (e.kind == 0) {
          PFt[e.j * Wz + pz + e.i] =
              dot_row<DIM>(Pm + e.i * Wz, Ft + e.j * Wz, Wz);
        } else if (e.kind == 1) {
          PGt[e.j * Wz + pz + e.i] =
              dot_row<DIM>(Pm + e.i * Wz, Gt + e.j * Wz, Wz);
        } else if (e.kind == 2) {
          const float* dk = s.d + 2 * t * Wz;
          a.m[st * nz + e.q] =
              __fadd_rn(dot_row<DIM>(Plo + e.q * Wz, dk, Wz),
                        dot_row<DIM>(Phi + e.q * Wz, dk + Wz, Wz));
        }
      }
      CLOCK_STAMP(kChain1);
      __syncthreads();

      // (2) Qxx = (Q + Dw'Dm) + F'(PF), Qxu = (S + Dw'Em) + F'(PG),
      //     Quu = (R + Ew'Em) + G'(PG)
      for (int o = tid; o < warps_of(nz * nz) + warps_of(nz * nc) +
                                warps_of(nc * nc);
           o += T) {
        const Entry e =
            o == tid ? e2 : entry_of(o, nz * nz, nz, nz * nc, nc, nc * nc, nc);
        if (e.kind == 0) {
          Qxx[e.q] = __fadd_rn(s.Q[t * round4(nz * nz) + e.q],
                               dot_row<DIM>(Ft + e.i * Wz, PFt + e.j * Wz,
                                            Wz));
        } else if (e.kind == 1) {
          const float v = __fadd_rn(
              s.S[t * round4(nz * nc) + e.q],
              dot_row<DIM>(Ft + e.i * Wz, PGt + e.j * Wz, Wz));
          Qxu[e.q] = v;
          a.Qxu[st * nz * nc + e.q] = v;
        } else if (e.kind == 2) {
          Quu[e.q] = __fadd_rn(s.R[t * round4(nc * nc) + e.q],
                               dot_row<DIM>(Gt + e.i * Wz, PGt + e.j * Wz,
                                            Wz));
        }
      }
      CLOCK_STAMP(kChain2);
      __syncthreads();

      if constexpr (NC > 0) {
        // (3) each thread factors Quu itself; P_k = 0.5 (M + M'), M = Qxx +
        //     Qxu K, over the upper triangle (i <= j), K's columns i and j
        //     solved by that thread (the diagonal thread writes K's
        //     column); then Quu_inv's columns
        for (int o = tid; o < warps_of(tri) + warps_of(nc); o += T) {
          const Entry e = o == tid ? e3 : last_entry_of(o, nz, nc);
          if (e.kind > 1) continue;
          float L[NC][NC], rcp[NC], ki[NC];
          factor<NC>(Quu, a.reg, nc, L, rcp);
          if (e.kind == 0) {
            const int i = e.i, j = e.j;
            float kj[NC];
            gain_column<NC>(L, rcp, Qxu, i, nc, ki);
            gain_column<NC>(L, rcp, Qxu, j, nc, kj);
            const float mij = closed_loop<NC>(Qxx, Qxu, kj, i, j, nz, nc);
            const float mji = closed_loop<NC>(Qxx, Qxu, ki, j, i, nz, nc);
            const float v = __fmul_rn(0.5f, __fadd_rn(mij, mji));
            Pm[i * Wz + pz + j] = v;
            Pm[j * Wz + pz + i] = v;
            (j < h ? Plo : Phi)[i * Wz + (j < h ? Wz - h : Wz - nz) + j] = v;
            (i < h ? Plo : Phi)[j * Wz + (i < h ? Wz - h : Wz - nz) + i] = v;
            if (i == j) {
#pragma unroll
              for (int u = 0; u < NC; ++u)
                if (u < nc) a.K[st * nc * nz + u * nz + i] = ki[u];
            }
          } else {
#pragma unroll
            for (int u = 0; u < NC; ++u) ki[u] = u == e.q ? 1.f : 0.f;
            chol_solve<NC>(L, rcp, ki, nc);
#pragma unroll
            for (int u = 0; u < NC; ++u)
              if (u < nc) a.Qi[st * nc * nc + u * nc + e.q] = ki[u];
          }
        }
      } else {
        float* rcps = rsc + round4(mr);  // 1 / L_jj
        // (3a) warp 0 factors Quu in place
        if (tid < 32) factor_shared(Quu, rcps, a.reg, nc, tid);
        __syncthreads();
        // (3b) K = -Quu^-1 Qxu' a column per thread, in the stage's S slot
        //      (row-major nc x nz, as K), and Quu_inv a column per thread
        //      in its R slot (row-major nc x nc); both slots are spent
        float* Ks = s.S + t * round4(nz * nc);
        float* Xi = s.R + t * round4(nc * nc);
        for (int o = tid; o < nz + nc; o += T) {
          if (o < nz) {
            for (int u = 0; u < nc; ++u) Ks[u * nz + o] = Qxu[o * nc + u];
            solve_shared(Quu, rcps, Ks + o, nz, nc);
            for (int u = 0; u < nc; ++u) Ks[u * nz + o] = -Ks[u * nz + o];
          } else {
            const int q = o - nz;
            for (int u = 0; u < nc; ++u) Xi[u * nc + q] = u == q ? 1.f : 0.f;
            solve_shared(Quu, rcps, Xi + q, nc, nc);
          }
        }
        __syncthreads();
        // (3c) K and Quu_inv out; P_k over the upper triangle
        for (int o = tid; o < nc * nz; o += T) a.K[st * nc * nz + o] = Ks[o];
        for (int o = tid; o < nc * nc; o += T) a.Qi[st * nc * nc + o] = Xi[o];
        for (int o = tid; o < tri; o += T) {
          const Entry e = last_entry_of(o, nz, 0);
          const int i = e.i, j = e.j;
          float mij = 0.f, mji = 0.f;
          for (int u = 0; u < nc; ++u) {
            mij = fmaf(Qxu[i * nc + u], Ks[u * nz + j], mij);
            mji = fmaf(Qxu[j * nc + u], Ks[u * nz + i], mji);
          }
          mij = __fadd_rn(Qxx[i * nz + j], mij);
          mji = __fadd_rn(Qxx[j * nz + i], mji);
          const float v = __fmul_rn(0.5f, __fadd_rn(mij, mji));
          Pm[i * Wz + pz + j] = v;
          Pm[j * Wz + pz + i] = v;
          (j < h ? Plo : Phi)[i * Wz + (j < h ? Wz - h : Wz - nz) + j] = v;
          (i < h ? Plo : Phi)[j * Wz + (i < h ? Wz - h : Wz - nz) + i] = v;
        }
      }
      CLOCK_STAMP(kChain3);
      __syncthreads();
    }
  }
#ifdef CMPC_EPOCH_DATA_CLOCKS
  stamp_block(a.clocks, clk_t0);
#endif
}

template <int NC, int DIM, bool kSpill = false>
cudaError_t launch_with(const DataArgs& a, int threads, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        epoch_data_kernel<NC, DIM, kSpill>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  epoch_data_kernel<NC, DIM, kSpill><<<a.P, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for the dimensions: up to 32 in every dimension rows
// of 12 or 32 floats, fixed; beyond, runtime widths. Up to kRegNC controls
// the factor in registers (nc <= 2, nc <= 8), above in shared memory.
// With a scratch the layout is spilled (runtime widths only; no shared
// memory, one stage per chunk).
int launch(const DataArgs& a, int threads, int smem_bytes, void* stream) {
  const int nz = a.nz, nc = a.nc, mr = a.mr;
  if (a.P <= 0 || a.N <= 0 || nz <= 0 || nc <= 0 || mr <= 0 ||
      a.chunk <= 0 || a.chunk > kMaxChunk || a.chunk > a.N ||
      threads != data_threads(nz, nc))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wide = wide_dims(nz, nc, mr);
  if (a.scratch) {
    if (smem_bytes != 0 || a.chunk != 1 || !(wide || nc > kRegNC))
      return (int)cudaErrorInvalidValue;
    if (nc > kRegNC) return (int)launch_with<0, 0, true>(a, threads, 0, s);
    return (int)(nc <= 2 ? launch_with<2, 0, true>(a, threads, 0, s)
                         : launch_with<8, 0, true>(a, threads, 0, s));
  }
  const size_t smem =
      sizeof(float) * (size_t)data_block_floats(nz, nc, mr, a.chunk);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  if (nc > kRegNC) return (int)launch_with<0, 0>(a, threads, smem, s);
  const bool narrow = !wide && width_z(nz, nc, mr) == 12;
  if (nc <= 2)
    return (int)(wide     ? launch_with<2, 0>(a, threads, smem, s)
                 : narrow ? launch_with<2, 12>(a, threads, smem, s)
                          : launch_with<2, 32>(a, threads, smem, s));
  return (int)(wide     ? launch_with<8, 0>(a, threads, smem, s)
               : narrow ? launch_with<8, 12>(a, threads, smem, s)
                        : launch_with<8, 32>(a, threads, smem, s));
}

}  // namespace

#define EPOCH_DATA_PARAMS                                                   \
  const float *F, const float *G, const float *d, const float *Q,           \
      const float *R, const float *S, const float *D, const float *E,       \
      const float *lo, const float *hi, const float *soft_lo,               \
      const float *soft_hi, const float *rho_scale, float *K,               \
      float *Quu_inv, float *Qxu, float *m, float *D_out, float *E_out,     \
      float *rv, float *fac_lo, float *fac_hi, float *scratch, int P,       \
      int N, int nz, int nc, int mr, float rho, float reg, int threads,     \
      int chunk, int smem_bytes, void *stream
#define EPOCH_DATA_FIELDS                                                   \
  F, G, d, Q, R, S, D, E, lo, hi, soft_lo, soft_hi, rho_scale, K, Quu_inv,  \
      Qxu, m, D_out, E_out, rv, fac_lo, fac_hi, scratch, P, N, nz, nc, mr,  \
      chunk, rho, reg

#ifndef CMPC_EPOCH_DATA_CLOCKS
extern "C" int cmpc_epoch_data(EPOCH_DATA_PARAMS) {
  const DataArgs a = {EPOCH_DATA_FIELDS};
  return launch(a, threads, smem_bytes, stream);
}
#else
// The clock-stamped build: stamps (P, stamps, 3) int64, each (label, thread
// 0's clock, the last warp's clock) at one barrier, in the block's order.
extern "C" int cmpc_epoch_data_clocked(EPOCH_DATA_PARAMS, long long* clocks,
                                       int stamps) {
  const DataArgs a = {EPOCH_DATA_FIELDS, {clocks, stamps}};
  return launch(a, threads, smem_bytes, stream);
}

// Stamps per block: three per chunk, three per stage, and the block's row.
extern "C" int cmpc_epoch_data_clock_stamps(int N, int chunk) {
  return 3 * ((N + chunk - 1) / chunk) + 3 * N + 1;
}

extern "C" const char* cmpc_epoch_data_clock_names() {
  return "-;PF PG m;Qxx Qxu Quu;factor K P Quu_inv;chunk arrival;"
         "rows;augmentations";
}
#endif
