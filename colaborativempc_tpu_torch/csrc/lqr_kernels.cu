// Batched LQR affine sweeps and the whole ADMM epoch, hand-written for
// Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the two Pallas TPU kernels of colaborativempc_tpu/ops/pallas_lqr.py:
//   cmpc_admm_epoch  -> _admm_epoch_kernel (via admm_epoch_batched): one whole
//                       ADMM epoch of `epoch_len` iterations with a fixed
//                       Riccati factorisation;
//   cmpc_lqr_affine  -> _affine_kernel (via lqr_affine_solve_batched): one
//                       batched affine LQR solve with fixed factors.
// Both entries run the same device code (solve); the affine solve is one
// iteration without constraint rows.
//
// What bounds it on the H100. One ADMM iteration is a serial chain of 2*N
// dependent stage steps (costate sweep back, closed-loop rollout forward).
// Reading each input once (29.9 KB per QP at N=20, nc=2, mr=6) and the FP32
// operations (~1,100 per stage per iteration) bound an epoch of 768 QPs at
// N=20 to ~6.8 us, so the kernel is bound by the latency of that chain and
// of the work around it inside one warp. The first port kept the fixed data
// in global memory (L2 at best), so every stage step waited on those loads:
// ~2.5 us per step, 2.0 ms per epoch at that shape. Through shared memory
// (below) a stage step still took 1,000-1,300 cycles (the clocked split,
// scripts/admm_epoch_split.py): each step went through shared memory and a
// __syncwarp four times in a row (tt, Qu, kff; z, c), the stage's fixed data
// was read after each barrier, and its F' tt (F z) products waited for the
// warp sums. The register chain (below) takes 280-300 cycles a step at the
// port's widths: one xor-tree warp sum (~146 cycles for its two sums, 5
// shuffle levels of ~24 cycles and an add), the products, kff and the
// loads' address arithmetic. PERF.md has both designs' times.
//
// What the design does about it.
// * Fixed data in shared memory, loaded by cp.async into a ring of stage
//   slots. The stages form chunks of `ring` stages; the sweeps visit the
//   chunks back then forth (C-1..0, 0..C-1, C-1..0, ...), and while one
//   chunk is processed the next one loads into the other slot. A chunk is
//   loaded only when it is not resident, so when the ring holds the whole
//   horizon (ring >= N: one slot) the data loads once per launch. cp.async
//   moves 4 bytes per lane per instruction: per-QP slices of q ((N+1)*nz
//   floats) and of most fields at N % 4 != 0 are not 16-byte aligned, and
//   one mechanism serves every field.
// * The chain keeps only what depends on it. Per stage the backward step
//   forms tt = p + m, Qu = r + E't + G'tt (warp sums), kff = -Quu_inv Qu and
//   p = (q + D't) + F'tt + Qxu kff; the forward step c = K z + kff (warp
//   sums) and z' = d + F z + G c. The rest is computed for a whole chunk of
//   stages at once, before or after the chain runs through it, with the 32
//   lanes over (stage, row) pairs: t = rv (y - w) and q + D't before the
//   backward chain; the rows' v = D z + E c, over-relaxation, prox, dual
//   update and residuals after the forward chain.
// * The register chain, at the port's widths (nz = 11 states, nc = 2
//   controls; kRegZ, kRegC) and up to 32 rows: lane i owns state row i,
//   control i and row i, and a lane's share of a stage's fixed data (its F
//   column or row, its G, E, Qxu rows, K column, m, d, q + D't, t, r,
//   Quu_inv, kff) is loaded into registers one stage ahead, two register
//   sets in turn. tt and z reach the other lanes by __shfl_sync; after the
//   xor tree every lane holds the same sums, so each lane forms Qu, kff and
//   c itself; the F' tt (F z) products run under the warp sums' shuffles.
//   kff and c are stored, and z written to hist, off the chain, for the
//   forward sweep and the row pass. The widths are compile-time, so a step
//   has no branch and no guard per entry. Other widths (hp_opt's controls,
//   any other state count) take the chain through shared memory, the
//   earlier design, unchanged: its loops take runtime widths.
// * The arithmetic of every value, and its order, is that of the first
//   port's kernel: sequential sums and the same xor-tree warp sums (two at
//   a time, so their shuffles overlap), so the results are bit for bit
//   those of the kernel the port's checks were accepted with, in both
//   chains. The closed-loop form (A_cl = F + G K, one matvec per chain
//   step) was measured faster and rejected: it moves rounding, and the NL
//   hp_opt / Gauss-Seidel check of chip_smoke.py then left its tolerance
//   (PERF.md).
// * Lanes and banks. Lane i owns state row i. The column read of F' tt
//   (consecutive addresses) and the row read of F z (stride nz = 11,
//   coprime to the 32 banks) are conflict-free; in the chain through shared
//   memory tt and z are broadcast from their hist row.
// * Any control and row count. A control or a constraint row past the
//   32nd goes to lane (index mod 32), which owns indices i, i + 32, i + 64,
//   ...: the warp sums over rows take each lane's rows in turn before the
//   shuffles, the Quu_inv Qu product and the rows' pass loop over them.
//   Two instantiations: up to 32 controls and rows the first kernel's code
//   (lane i alone owns index i; a lane owns row i of several stages and
//   keeps its residual maxima in registers), with the register chain at
//   the port's widths; past 32 controls or rows the loops above (a lane
//   owns its rows over every stage and keeps their maxima in the outputs)
//   and the chain through shared memory. Lane i owns state row i
//   throughout. The one limit is nz <= 32.
// * Any horizon and fleet: where one QP does not fit in a block's shared
//   memory, the plan (ops/cuda_lqr.py kernel_plan) moves arrays to global
//   memory, level by level (Spill below): first w, y and kff over the
//   horizon (w and y worked on in place in the w and y outputs, kff in a
//   (P, N, nc) scratch), then the ring (a chunk's slot then points straight
//   into the inputs, which lie in the slot's own order, and nothing is
//   copied), last the chunk scratch (a per-QP scratch). The arithmetic and
//   its order are the same at every level, so a spilled launch gives the
//   bits the same launch gives from shared memory; what fits keeps the
//   code of level 0.
// * One warp per QP, `qps_per_block` warps per block, independent: warps
//   sync with __syncwarp only, never the block, so a warp of the ragged last
//   block returns early without deadlock. The launch plan (QPs per block,
//   ring depth, shared-memory bytes) is chosen in Python
//   (ops/cuda_lqr.py kernel_plan) and checked here against the carve.
//
// Built with -DCMPC_ADMM_EPOCH_CLOCKS (ops/_build.py load_admm_epoch_clocks,
// a library of its own), the epoch kernel also stamps clock64() in each
// QP's warp after each part of its solve (the ring's first load, feeds and
// waits, the backward pre-pass, the chains, the row pass) into a buffer the
// caller passes (cmpc_admm_epoch_clocked). The default build has no stamps.
//
// Semantics match the Pallas kernel: residuals come from the last iteration
// only, mask = (rv > 0), the soft-row prox shrinks by fac_lo / fac_hi toward
// [lo, hi] (fac = 0 makes a hard row a clip), and lo / hi may be +-inf. The
// prox BRANCHES instead of blending: hi + fac_hi*(wbar - hi) is NaN on a row
// with hi = +inf and must never be evaluated into the result. The max over
// stages propagates NaN, as jnp.max does. Build without --use_fast_math: the
// prox relies on inf comparisons and the Riccati chain is sensitive to
// rounding. nz <= 32.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrapper (ops/cuda_lqr.py) checks. Plain C interface for ctypes; each entry
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Stamp labels, in the order of cmpc_admm_epoch_clock_names.
enum Label {
  kStart = 0, kFirstLoad, kPrePass, kBackChain, kFwdChain, kRowPass, kFeed,
  kWait
};

#ifdef CMPC_ADMM_EPOCH_CLOCKS
struct Clocks {
  long long* out;  // (P, stamps, 3): label, the warp's clock (twice)
  int stamps;
};
#endif

struct EpochArgs {
  const float *F, *G, *d, *K, *Quu_inv, *Qxu, *m, *q, *r;
  const float *D, *E, *lo, *hi, *rv, *fac_lo, *fac_hi;
  const float *z0, *w0, *y0;
  float *z_out, *c_out, *w_out, *y_out, *rp_out, *rd_out;
  float *kff, *work;  // global scratch of the spill levels (or null)
  int P, N, nz, nc, mr, epoch_len, qpb, ring, spill;
  float alpha;
#ifdef CMPC_ADMM_EPOCH_CLOCKS
  Clocks clocks;
#endif
};

#ifdef CMPC_ADMM_EPOCH_CLOCKS
// Stamp n of QP p, once the warp has converged: the label and the warp's
// clock64() in both clock columns (one warp per QP: its own last warp).
__device__ __forceinline__ void stamp(const Clocks& c, int p, int lane,
                                      int& n, int label) {
  __syncwarp();
  if (c.out && n < c.stamps - 1 && lane == 0) {
    long long* s = c.out + ((size_t)p * c.stamps + n) * 3;
    const long long t = clock64();
    s[0] = label;
    s[1] = t;
    s[2] = t;
  }
  ++n;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The QP's last stamp row: (-2 - its SM, its start and its end in ns of
// the global timer), so a reader sees which QPs ran at once.
__device__ __forceinline__ void stamp_qp(const Clocks& c, int p, int lane,
                                         long long t0) {
  if (c.out && lane == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* s = c.out + ((size_t)p * c.stamps + c.stamps - 1) * 3;
    s[0] = -2 - (long long)sm;
    s[1] = t0;
    s[2] = global_ns();
  }
}
#define CLOCK_STAMP(label) stamp(a.clocks, p, lane, clk_n, (label))
#else
#define CLOCK_STAMP(label)
#endif

// What a launch keeps in global memory (ops/cuda_lqr.py SPILLS): nothing;
// w, y and kff over the horizon; those and the ring; those and the chunk
// scratch (then no shared memory at all).
enum Spill { kInShared = 0, kHorizon = 1, kRing = 2, kAll = 3 };

// Floats of one stage's fixed data in a ring slot: F, G, d, K, Quu_inv,
// Qxu, m, q, r, D, E, lo, hi, rv, fac_lo, fac_hi.
__host__ __device__ inline int stage_floats(int nz, int nc, int mr) {
  return nz * nz + 3 * nz * nc + nc * nc + 3 * nz + nc + mr * (nz + nc + 5);
}

// Floats of one QP's work at a spill level: w, y and kff over the horizon
// (below kHorizon), one chunk's scratch (hist, g, t, c, and qu) and the
// ring slots (below kRing: one when the ring holds the horizon, else two).
// In shared memory, or in global memory at kAll.
__host__ __device__ inline int qp_floats(int N, int ring, int nz, int nc,
                                         int mr, int spill) {
  const int S = ring < N ? ring : N;
  const int slots = spill >= kRing ? 0 : (ring < N ? 2 : 1);
  const int horizon = spill >= kHorizon ? 0 : 2 * N * mr + N * nc;
  return horizon + (S + 1) * nz + S * (nz + mr + nc) + nc +
         slots * S * stage_floats(nz, nc, mr);
}

// One ring slot: S stages of each field, field after field, each in the
// input's own (stage, row, column) order.
struct Slot {
  float *F, *G, *d, *K, *Qi, *Qxu, *m, *q, *r, *D, *E, *lo, *hi, *rv, *flo,
      *fhi;
};

// Slot `i` of the ring that starts at `slots`.
__device__ inline Slot slot_at(float* slots, int i, int S, int nz, int nc,
                               int mr) {
  Slot sl;
  float* s = slots + (size_t)i * S * stage_floats(nz, nc, mr);
  sl.F = s;   s += S * nz * nz;
  sl.G = s;   s += S * nz * nc;
  sl.d = s;   s += S * nz;
  sl.K = s;   s += S * nc * nz;
  sl.Qi = s;  s += S * nc * nc;
  sl.Qxu = s; s += S * nz * nc;
  sl.m = s;   s += S * nz;
  sl.q = s;   s += S * nz;
  sl.r = s;   s += S * nc;
  sl.D = s;   s += S * mr * nz;
  sl.E = s;   s += S * mr * nc;
  sl.lo = s;  s += S * mr;
  sl.hi = s;  s += S * mr;
  sl.rv = s;  s += S * mr;
  sl.flo = s; s += S * mr;
  sl.fhi = s;
  return sl;
}

// From kRing: the slot of stages [k0, ...) of problem p where they lie in
// the inputs, whose (stage, row, column) order is the slot's (read only).
__device__ inline Slot input_slot(const EpochArgs& a, int p, int k0) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  const size_t st = (size_t)p * N + k0;
  auto at = [](const float* f, size_t o) { return const_cast<float*>(f) + o; };
  Slot sl;
  sl.F = at(a.F, st * nz * nz);
  sl.G = at(a.G, st * nz * nc);
  sl.d = at(a.d, st * nz);
  sl.K = at(a.K, st * nc * nz);
  sl.Qi = at(a.Quu_inv, st * nc * nc);
  sl.Qxu = at(a.Qxu, st * nz * nc);
  sl.m = at(a.m, st * nz);
  sl.q = at(a.q, ((size_t)p * (N + 1) + k0) * nz);
  sl.r = at(a.r, st * nc);
  sl.D = at(a.D, st * mr * nz);
  sl.E = at(a.E, st * mr * nc);
  sl.lo = at(a.lo, st * mr);
  sl.hi = at(a.hi, st * mr);
  sl.rv = at(a.rv, st * mr);
  sl.flo = at(a.fac_lo, st * mr);
  sl.fhi = at(a.fac_hi, st * mr);
  return sl;
}

// 4-byte asynchronous copy global -> shared (cp.async, Ampere and later).
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

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Issue the copies of `count` floats of one field from `src` into the
// slot; the warp's lanes take consecutive floats.
__device__ inline void load_field(float* dst, const float* src, int count,
                                  int lane) {
  for (int o = lane; o < count; o += kWarp) cp_async4(dst + o, src + o);
}

// Stages [k0, k0 + n) of problem p into slot `sl`, asynchronously.
__device__ inline void load_chunk(const EpochArgs& a, const Slot& sl, int p,
                                  int k0, int n, int lane) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  const size_t st = (size_t)p * N + k0;  // first stage, (P, N, ...) fields
  load_field(sl.F, a.F + st * nz * nz, n * nz * nz, lane);
  load_field(sl.G, a.G + st * nz * nc, n * nz * nc, lane);
  load_field(sl.d, a.d + st * nz, n * nz, lane);
  load_field(sl.K, a.K + st * nc * nz, n * nc * nz, lane);
  load_field(sl.Qi, a.Quu_inv + st * nc * nc, n * nc * nc, lane);
  load_field(sl.Qxu, a.Qxu + st * nz * nc, n * nz * nc, lane);
  load_field(sl.m, a.m + st * nz, n * nz, lane);
  load_field(sl.q, a.q + ((size_t)p * (N + 1) + k0) * nz, n * nz, lane);
  load_field(sl.r, a.r + st * nc, n * nc, lane);
  if (mr > 0) {
    load_field(sl.D, a.D + st * mr * nz, n * mr * nz, lane);
    load_field(sl.E, a.E + st * mr * nc, n * mr * nc, lane);
    load_field(sl.lo, a.lo + st * mr, n * mr, lane);
    load_field(sl.hi, a.hi + st * mr, n * mr, lane);
    load_field(sl.rv, a.rv + st * mr, n * mr, lane);
    load_field(sl.flo, a.fac_lo + st * mr, n * mr, lane);
    load_field(sl.fhi, a.fac_hi + st * mr, n * mr, lane);
  }
  cp_async_commit();
}

// Wait for the warp's copies and make them visible to the whole warp.
__device__ __forceinline__ void arrive() {
  cp_async_wait_all();
  __syncwarp();
}

// Two independent xor-tree warp sums, level by level, so that their
// shuffles overlap; each sum's arithmetic is that of a tree of its own.
__device__ __forceinline__ void warp_sum2(float& u, float& v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float su = __shfl_xor_sync(kFull, u, off);
    const float sv = __shfl_xor_sync(kFull, v, off);
    u += su;
    v += sv;
  }
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

// A lane's place in the chunk phases, for rows of one width (nz or mr):
// lane = g * width + i works on row i of stages g, g + G, g + 2G, ...
// (G = 32 / width); lanes past G * width sit out (g = kIdle).
constexpr int kIdle = 1 << 20;
struct RowLane {
  int g, i, G;
};

__device__ inline RowLane row_lane(int lane, int width) {
  RowLane r;
  r.G = kWarp / width;
  r.g = lane / width;
  r.i = lane - r.g * width;
  if (r.g >= r.G) r.g = kIdle;
  return r;
}

// Per-QP iterates and per-chunk scratch in shared memory.
struct Work {
  float *w, *y;   // (N, mr) splitting variable and scaled dual
  float *kff;     // (N, nc) feedforward of the current iteration
  float *hist;    // (S+1, nz) the chunk's tt (backward) or z_k (forward)
  float *g;       // (S, nz) q + D' t of each stage
  float *t;       // (S, mr) rv * (y - w)
  float *c;       // (S, nc) the chunk's controls
  float *qu;      // (nc) Qu of the current stage
};

// Backward sweep through one resident chunk [k0, k0+n), before the chain:
// every stage's t and q + D' t.
template <bool kRows>
__device__ void backward_prepass(const Slot& sl, const Work& wk, int k0,
                                 int n, int nz, int mr, int lane) {
  const RowLane L = row_lane(lane, nz);
  if (kRows) {
    for (int o = lane; o < n * mr; o += kWarp)
      wk.t[o] = sl.rv[o] * (wk.y[k0 * mr + o] - wk.w[k0 * mr + o]);
    __syncwarp();
  }
  for (int kk = L.g; kk < n; kk += L.G) {
    float acc = sl.q[kk * nz + L.i];
    if (kRows)
      for (int j = 0; j < mr; ++j)
        acc += sl.D[(kk * mr + j) * nz + L.i] * wk.t[kk * mr + j];
    wk.g[kk * nz + L.i] = acc;
  }
  __syncwarp();
}

// The chain through shared memory, at widths the register chain does not
// take. The backward chain through the chunk carries the costate p (lane i
// holds row i) from p_{k0+n} down to p_{k0} and leaves kff of each stage.
template <bool kRows, bool kWideR>
__device__ void backward_chain(const Slot& sl, const Work& wk, int k0, int n,
                               int nz, int nc, int mr, int lane, float& p) {
  for (int kk = n - 1; kk >= 0; --kk) {
    const int k = k0 + kk;
    float* tt = wk.hist + (kk + 1) * nz;
    float ttl = 0.f;
    if (lane < nz) {
      ttl = p + sl.m[kk * nz + lane];
      tt[lane] = ttl;
    }
    __syncwarp();
    // Qu_a = r_a + sum over lanes of G[lane][a] tt_lane + E[j][a] t_j (each
    // lane its rows j in turn), two controls at a time (a lone last one
    // sums beside a zero)
    for (int a = 0; a < nc; a += 2) {
      const int b = a + 1 < nc ? a + 1 : a;
      float u = lane < nz ? sl.G[(kk * nz + lane) * nc + a] * ttl : 0.f;
      float v = lane < nz ? sl.G[(kk * nz + lane) * nc + b] * ttl : 0.f;
      if (kRows && kWideR) {
        for (int j = lane; j < mr; j += kWarp) {
          const float tl = wk.t[kk * mr + j];
          u += sl.E[(kk * mr + j) * nc + a] * tl;
          v += sl.E[(kk * mr + j) * nc + b] * tl;
        }
      } else if (kRows && lane < mr) {
        const float tl = wk.t[kk * mr + lane];
        u += sl.E[(kk * mr + lane) * nc + a] * tl;
        v += sl.E[(kk * mr + lane) * nc + b] * tl;
      }
      warp_sum2(u, v);
      if (lane == 0) {
        wk.qu[a] = sl.r[kk * nc + a] + u;
        wk.qu[b] = sl.r[kk * nc + b] + v;
      }
    }
    __syncwarp();
    auto kff_row = [&](int i) {
      float acc = 0.f;
      for (int b = 0; b < nc; ++b)
        acc += sl.Qi[(kk * nc + i) * nc + b] * wk.qu[b];
      wk.kff[k * nc + i] = -acc;
    };
    if (kWideR)
      for (int i = lane; i < nc; i += kWarp) kff_row(i);
    else if (lane < nc)
      kff_row(lane);
    __syncwarp();
    if (lane < nz) {
      float acc = wk.g[kk * nz + lane];
#pragma unroll 4
      for (int l = 0; l < nz; ++l)
        acc += sl.F[(kk * nz + l) * nz + lane] * tt[l];
      for (int a = 0; a < nc; ++a)
        acc += sl.Qxu[(kk * nz + lane) * nc + a] * wk.kff[k * nc + a];
      p = acc;
    }
    __syncwarp();  // qu is rewritten by the next stage
  }
}

// The forward chain through one resident chunk: it carries the state z
// from z_{k0} to z_{k0+n}, c_k = K z_k + kff_k by warp sums, and leaves
// each stage's z in hist and c in c.
template <bool kWideR>
__device__ void forward_chain(const Slot& sl, const Work& wk, int k0, int n,
                              int nz, int nc, int lane, float& z) {
  for (int kk = 0; kk < n; ++kk) {
    const int k = k0 + kk;
    float* zk = wk.hist + kk * nz;
    if (lane < nz) zk[lane] = z;
    __syncwarp();
    // c_a = sum over lanes of K[a][lane] z_lane, plus kff_a, two at a time
    for (int a = 0; a < nc; a += 2) {
      const int b = a + 1 < nc ? a + 1 : a;
      float u = lane < nz ? sl.K[(kk * nc + a) * nz + lane] * z : 0.f;
      float v = lane < nz ? sl.K[(kk * nc + b) * nz + lane] * z : 0.f;
      warp_sum2(u, v);
      if (lane == 0) {
        wk.c[kk * nc + a] = u + wk.kff[k * nc + a];
        wk.c[kk * nc + b] = v + wk.kff[k * nc + b];
      }
    }
    __syncwarp();
    if (lane < nz) {
      float acc = sl.d[kk * nz + lane];
#pragma unroll 4
      for (int l = 0; l < nz; ++l)
        acc += sl.F[(kk * nz + lane) * nz + l] * zk[l];
      for (int a = 0; a < nc; ++a)
        acc += sl.G[(kk * nz + lane) * nc + a] * wk.c[kk * nc + a];
      z = acc;
    }
  }
  __syncwarp();
}

// The register chain (the note at the top): nz = kRegZ states and nc =
// kRegC controls, the port's stage QPs, and any row count up to 32. Every
// value's expression and order are those of the chain through shared memory
// above, so the two give the same bits.
constexpr int kRegZ = 11, kRegC = 2;

template <bool kRows>
struct BackStage {
  float F[kRegZ], G[kRegC], E[kRegC], r[kRegC], Qx[kRegC], Qi[kRegC * kRegC];
  float m, g, t;
  __device__ __forceinline__ void load(const Slot& sl, const Work& wk,
                                       int kk, int mr, int lane) {
    constexpr int nz = kRegZ, nc = kRegC;
    const bool z = lane < nz, row = kRows && lane < mr;
    m = z ? sl.m[kk * nz + lane] : 0.f;
    g = z ? wk.g[kk * nz + lane] : 0.f;
    t = row ? wk.t[kk * mr + lane] : 0.f;
#pragma unroll
    for (int l = 0; l < nz; ++l)
      F[l] = z ? sl.F[(kk * nz + l) * nz + lane] : 0.f;
#pragma unroll
    for (int a = 0; a < nc; ++a) {
      G[a] = z ? sl.G[(kk * nz + lane) * nc + a] : 0.f;
      E[a] = row ? sl.E[(kk * mr + lane) * nc + a] : 0.f;
      r[a] = sl.r[kk * nc + a];
      Qx[a] = z ? sl.Qxu[(kk * nz + lane) * nc + a] : 0.f;
#pragma unroll
      for (int j = 0; j < nc; ++j)
        Qi[j * nc + a] = sl.Qi[(kk * nc + j) * nc + a];
    }
  }
};

// One backward stage step from p_{k+1} (lane i: row i) to p_k; stores kff_k
// at kff.
template <bool kRows>
__device__ __forceinline__ void back_step(const BackStage<kRows>& s, float& p,
                                          float* kff, int mr, int lane) {
  constexpr int nz = kRegZ, nc = kRegC;
  const float ttl = lane < nz ? p + s.m : 0.f;
  // p = (q + D't) + F' tt + Qxu kff: the F' tt terms under the warp sums
  float acc = s.g;
#pragma unroll
  for (int l = 0; l < nz; ++l)
    acc += s.F[l] * __shfl_sync(kFull, ttl, l);
  // Qu_a = r_a + sum over lanes of G[lane][a] tt_lane + E[lane][a] t_lane,
  // two controls at a time; kff's numerators take Quu_inv's columns in the
  // controls' order
  float num[nc];
#pragma unroll
  for (int j = 0; j < nc; ++j) num[j] = 0.f;
#pragma unroll
  for (int a = 0; a < nc; a += 2) {
    float u = lane < nz ? s.G[a] * ttl : 0.f;
    float v = lane < nz ? s.G[a + 1] * ttl : 0.f;
    if (kRows) {
      const float su = u + s.E[a] * s.t, sv = v + s.E[a + 1] * s.t;
      u = lane < mr ? su : u;
      v = lane < mr ? sv : v;
    }
    warp_sum2(u, v);
    const float qa = s.r[a] + u, qb = s.r[a + 1] + v;
#pragma unroll
    for (int j = 0; j < nc; ++j) {
      num[j] += s.Qi[j * nc + a] * qa;
      num[j] += s.Qi[j * nc + a + 1] * qb;
    }
  }
  // kff = -Quu_inv Qu, then the Qxu kff terms
#pragma unroll
  for (int a = 0; a < nc; ++a) {
    const float kf = -num[a];
    acc += s.Qx[a] * kf;
    if (lane == 0) kff[a] = kf;
  }
  if (lane < nz) p = acc;
}

struct FwdStage {
  float F[kRegZ], K[kRegC], G[kRegC], kf[kRegC];
  float d;
  __device__ __forceinline__ void load(const Slot& sl, const Work& wk,
                                       int k0, int kk, int lane) {
    constexpr int nz = kRegZ, nc = kRegC;
    const bool z = lane < nz;
    d = z ? sl.d[kk * nz + lane] : 0.f;
#pragma unroll
    for (int l = 0; l < nz; ++l)
      F[l] = z ? sl.F[(kk * nz + lane) * nz + l] : 0.f;
#pragma unroll
    for (int a = 0; a < nc; ++a) {
      K[a] = z ? sl.K[(kk * nc + a) * nz + lane] : 0.f;
      G[a] = z ? sl.G[(kk * nz + lane) * nc + a] : 0.f;
      kf[a] = wk.kff[(k0 + kk) * nc + a];
    }
  }
};

// One forward stage step from z_k (lane i: row i) to z_{k+1}; writes z_k to
// zk and c_k to ck.
__device__ __forceinline__ void fwd_step(const FwdStage& s, float& z,
                                         float* zk, float* ck, int lane) {
  constexpr int nz = kRegZ, nc = kRegC;
  if (lane < nz) zk[lane] = z;
  // z' = d + F z + G c: the F z terms under the warp sums
  float acc = s.d;
#pragma unroll
  for (int l = 0; l < nz; ++l)
    acc += s.F[l] * __shfl_sync(kFull, z, l);
  // c_a = sum over lanes of K[a][lane] z_lane, plus kff_a, two at a time
  float c[nc];
#pragma unroll
  for (int a = 0; a < nc; a += 2) {
    float u = lane < nz ? s.K[a] * z : 0.f;
    float v = lane < nz ? s.K[a + 1] * z : 0.f;
    warp_sum2(u, v);
    c[a] = u + s.kf[a];
    c[a + 1] = v + s.kf[a + 1];
  }
#pragma unroll
  for (int a = 0; a < nc; ++a) {
    acc += s.G[a] * c[a];
    if (lane == 0) ck[a] = c[a];
  }
  if (lane < nz) z = acc;
}

// The register chains through a chunk: the stages in two register sets in
// turn, each loaded while the other one's step runs (at the chunk's last
// step the next load repeats a stage, unused, so that no branch parts the
// loads from the step).
template <bool kRows>
__device__ void backward_chain_regs(const Slot& sl, const Work& wk, int k0,
                                    int n, int mr, int lane, float& p) {
  BackStage<kRows> s0, s1;
  s0.load(sl, wk, n - 1, mr, lane);
  for (int kk = n - 1; kk >= 0; kk -= 2) {
    s1.load(sl, wk, kk > 0 ? kk - 1 : 0, mr, lane);
    back_step(s0, p, wk.kff + (k0 + kk) * kRegC, mr, lane);
    if (kk == 0) break;
    s0.load(sl, wk, kk > 1 ? kk - 2 : 0, mr, lane);
    back_step(s1, p, wk.kff + (k0 + kk - 1) * kRegC, mr, lane);
  }
  __syncwarp();
}

__device__ void forward_chain_regs(const Slot& sl, const Work& wk, int k0,
                                   int n, int lane, float& z) {
  FwdStage s0, s1;
  s0.load(sl, wk, k0, 0, lane);
  for (int kk = 0; kk < n; kk += 2) {
    s1.load(sl, wk, k0, kk + 1 < n ? kk + 1 : kk, lane);
    fwd_step(s0, z, wk.hist + kk * kRegZ, wk.c + kk * kRegC, lane);
    if (kk + 1 == n) break;
    s0.load(sl, wk, k0, kk + 2 < n ? kk + 2 : kk + 1, lane);
    fwd_step(s1, z, wk.hist + (kk + 1) * kRegZ, wk.c + (kk + 1) * kRegC,
             lane);
  }
  __syncwarp();
}

struct Out {
  float *z, *c;    // this problem's rows of z_out, c_out
  float *rp, *rd;  // its rows of rp_out, rd_out (mr > 32: the maxima)
};

// One constraint row o of the chunk (stage kk): v = D z + E c,
// over-relaxation, prox and dual update; returns the row's primal and dual
// residual terms through rpo, rdo.
__device__ __forceinline__ void row_update(const Slot& sl, const Work& wk,
                                           int k0, int kk, int o, int nz,
                                           int nc, int mr, float alpha,
                                           float& rpo, float& rdo) {
  const int g = k0 * mr + o;
  float v = 0.f;
  for (int i = 0; i < nz; ++i) v += sl.D[o * nz + i] * wk.hist[kk * nz + i];
  for (int a = 0; a < nc; ++a) v += sl.E[o * nc + a] * wk.c[kk * nc + a];
  const float w = wk.w[g];
  const float y = wk.y[g];
  const float vhat = alpha * v + (1.f - alpha) * w;
  const float wbar = vhat + y;
  const float hi = sl.hi[o];
  const float lo = sl.lo[o];
  float wn = wbar;
  if (wbar > hi) wn = hi + sl.fhi[o] * (wbar - hi);
  if (wbar < lo) wn = lo + sl.flo[o] * (wbar - lo);
  wk.y[g] = y + vhat - wn;
  wk.w[g] = wn;
  const float msk = sl.rv[o] > 0.f ? 1.f : 0.f;
  rpo = fabsf(msk * (v - wn));
  rdo = fabsf(msk * (wn - w));
}

// After the forward chain through the chunk: every row's v = D z + E c,
// over-relaxation, prox and dual update, and in the last iteration (kLast)
// the partial residual maxima (up to 32 rows one per lane over its
// stages, in rp and rd; above, each row's in out.rp and out.rd) and the
// outputs z, c.
template <bool kRows, bool kLast, bool kWideR>
__device__ void row_pass(const Slot& sl, const Work& wk, int k0, int n,
                         int nz, int nc, int mr, int lane, float alpha,
                         const Out& out, float& rp, float& rd) {
  if (kRows && !kWideR) {
    const RowLane L = row_lane(lane, mr);
    for (int kk = L.g; kk < n; kk += L.G) {
      float rpo, rdo;
      row_update(sl, wk, k0, kk, kk * mr + L.i, nz, nc, mr, alpha, rpo, rdo);
      if (kLast) {
        rp = nan_max(rp, rpo);
        rd = nan_max(rd, rdo);
      }
    }
  } else if (kRows) {
    for (int kk = 0; kk < n; ++kk)
      for (int j = lane; j < mr; j += kWarp) {
        float rpo, rdo;
        row_update(sl, wk, k0, kk, kk * mr + j, nz, nc, mr, alpha, rpo, rdo);
        if (kLast) {
          out.rp[j] = nan_max(out.rp[j], rpo);
          out.rd[j] = nan_max(out.rd[j], rdo);
        }
      }
  }
  if (kLast) {
    for (int o = lane; o < n * nz; o += kWarp) out.z[k0 * nz + o] = wk.hist[o];
    for (int o = lane; o < n * nc; o += kWarp) out.c[k0 * nc + o] = wk.c[o];
  }
  __syncwarp();
}

// One problem, one warp: `epoch_len` iterations of backward then forward
// sweeps over the chunks of the horizon, with the ring of slots fed ahead
// of the visits (below kRing; from kRing a chunk is read where it lies).
// The affine solve is epoch_len = 1 without rows. `base` is the QP's work
// (qp_floats at kSpill).
template <bool kRows, bool kWideR, int kSpill>
__device__ void solve(const EpochArgs& a, float* base, int p, int lane) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = kRows ? a.mr : 0;
  const int S = a.ring < N ? a.ring : N;
  const int n_slots = a.ring < N ? 2 : 1;
  const int C = (N + S - 1) / S;  // chunks
  const int nw = N * mr;

  Work wk;
  if (kSpill >= kHorizon) {
    // w and y in place in the outputs, kff in its scratch
    wk.w = kRows ? a.w_out + (size_t)p * nw : nullptr;
    wk.y = kRows ? a.y_out + (size_t)p * nw : nullptr;
    wk.kff = a.kff + (size_t)p * N * nc;
    wk.hist = base;
  } else {
    wk.w = base;
    wk.y = wk.w + N * mr;
    wk.kff = wk.y + N * mr;
    wk.hist = wk.kff + N * nc;
  }
  wk.g = wk.hist + (S + 1) * nz;
  wk.t = wk.g + S * nz;
  wk.c = wk.t + S * mr;
  wk.qu = wk.c + S * nc;
  float* const slots = wk.qu + nc;  // n_slots ring slots of S stages

  for (int o = lane; o < nw; o += kWarp) {
    wk.w[o] = a.w0[(size_t)p * nw + o];
    wk.y[o] = a.y0[(size_t)p * nw + o];
  }
  const float p_term =
      lane < nz ? a.q[((size_t)p * (N + 1) + N) * nz + lane] : 0.f;
  const float z_init = lane < nz ? a.z0[(size_t)p * nz + lane] : 0.f;
  Out out = {a.z_out + (size_t)p * (N + 1) * nz,
             a.c_out + (size_t)p * N * nc, nullptr, nullptr};
  if (kRows && kWideR) {
    out.rp = a.rp_out + (size_t)p * mr;
    out.rd = a.rd_out + (size_t)p * mr;
    for (int j = lane; j < mr; j += kWarp) out.rp[j] = out.rd[j] = 0.f;
  }

  // visit v of an iteration: 0..C-1 backward over chunks C-1..0, C..2C-1
  // forward over chunks 0..C-1
  auto chunk_of = [C](int v) { return v < C ? C - 1 - v : v - C; };
  auto stages_of = [N, S](int c) { return c * S + S <= N ? S : N - c * S; };
  const int visits = 2 * C * a.epoch_len;
  // the register chain at the port's widths, up to 32 rows
  const bool regs = !kWideR && nz == kRegZ && nc == kRegC;
  int held0 = C - 1, held1 = -1;  // the chunk each slot holds
#ifdef CMPC_ADMM_EPOCH_CLOCKS
  int clk_n = 0;
  const long long clk_t0 = global_ns();
  CLOCK_STAMP(kStart);
#endif
  if (kSpill >= kRing) {
    __syncwarp();  // w and y in place before any lane reads them
  } else {
    load_chunk(a, slot_at(slots, 0, S, nz, nc, mr), p, held0 * S,
               stages_of(held0), lane);
    arrive();
  }
  CLOCK_STAMP(kFirstLoad);

  float pc = 0.f, z = 0.f, rp = 0.f, rd = 0.f;
  for (int v = 0; v < visits; ++v) {
    const int it = v / (2 * C), vi = v - it * 2 * C;
    const int c = chunk_of(vi);
    const int cur = held0 == c ? 0 : 1;
    // feed the ring ahead of the sweep: the next visit's chunk goes into
    // the other slot unless a slot holds it already
    bool fed = false;
    if (kSpill < kRing && v + 1 < visits && n_slots == 2) {
      const int nxt = chunk_of((v + 1) % (2 * C));
      if (nxt != held0 && nxt != held1) {
        fed = true;
        if (cur == 0) held1 = nxt; else held0 = nxt;
        load_chunk(a, slot_at(slots, 1 - cur, S, nz, nc, mr), p, nxt * S,
                   stages_of(nxt), lane);
        CLOCK_STAMP(kFeed);
      }
    }
    const Slot sl = kSpill >= kRing ? input_slot(a, p, c * S)
                                    : slot_at(slots, cur, S, nz, nc, mr);
    const int k0 = c * S, n = stages_of(c);
    if (vi < C) {
      if (vi == 0) pc = p_term;
      backward_prepass<kRows>(sl, wk, k0, n, nz, mr, lane);
      CLOCK_STAMP(kPrePass);
      if (regs)
        backward_chain_regs<kRows>(sl, wk, k0, n, mr, lane, pc);
      else
        backward_chain<kRows, kWideR>(sl, wk, k0, n, nz, nc, mr, lane, pc);
      CLOCK_STAMP(kBackChain);
    } else {
      if (vi == C) z = z_init;
      if (regs)
        forward_chain_regs(sl, wk, k0, n, lane, z);
      else
        forward_chain<kWideR>(sl, wk, k0, n, nz, nc, lane, z);
      CLOCK_STAMP(kFwdChain);
      if (it == a.epoch_len - 1)
        row_pass<kRows, true, kWideR>(sl, wk, k0, n, nz, nc, mr, lane,
                                      a.alpha, out, rp, rd);
      else
        row_pass<kRows, false, kWideR>(sl, wk, k0, n, nz, nc, mr, lane,
                                       a.alpha, out, rp, rd);
      CLOCK_STAMP(kRowPass);
    }
    if (fed) {
      arrive();
      CLOCK_STAMP(kWait);
    }
  }
  if (lane < nz) out.z[N * nz + lane] = z;
  if (kSpill < kHorizon) {
    for (int o = lane; o < nw; o += kWarp) {
      a.w_out[(size_t)p * nw + o] = wk.w[o];
      a.y_out[(size_t)p * nw + o] = wk.y[o];
    }
  }
  if (kRows && !kWideR) {
    // row o's residual: the max of the partial maxima of lanes g * mr + o
    const RowLane L = row_lane(lane, mr);
    const float rp_lane = rp, rd_lane = rd;
    for (int g = 1; g < L.G; ++g) {
      const int src = g * mr + (lane < mr ? lane : 0);
      rp = nan_max(rp, __shfl_sync(kFull, rp_lane, src));
      rd = nan_max(rd, __shfl_sync(kFull, rd_lane, src));
    }
    if (lane < mr) {
      a.rp_out[(size_t)p * mr + lane] = rp;
      a.rd_out[(size_t)p * mr + lane] = rd;
    }
  }
#ifdef CMPC_ADMM_EPOCH_CLOCKS
  stamp_qp(a.clocks, p, lane, clk_t0);
#endif
}

// The work of this warp's QP: its share of the block's shared memory, or
// at kAll its share of the global scratch.
template <int kSpill>
__device__ __forceinline__ float* qp_work(const EpochArgs& a, float* smem,
                                          int warp, int p, int mr) {
  const size_t qpf = qp_floats(a.N, a.ring, a.nz, a.nc, mr, kSpill);
  return kSpill == kAll ? a.work + (size_t)p * qpf : smem + (size_t)warp * qpf;
}

// kWideR: controls or rows past 32 (each lane takes indices i, i + 32,
// ...), else the lane of index i alone, as the first kernel. kSpill: what
// lies in global memory (Spill).
template <bool kWideR, int kSpill>
__global__ void admm_epoch_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * a.qpb + warp;
  if (p >= a.P) return;  // whole warp leaves; no block-wide barrier exists
  solve<true, kWideR, kSpill>(a, qp_work<kSpill>(a, smem, warp, p, a.mr), p,
                              lane);
}

template <bool kWideR, int kSpill>
__global__ void affine_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * a.qpb + warp;
  if (p >= a.P) return;  // whole warp leaves; no block-wide barrier exists
  solve<false, kWideR, kSpill>(a, qp_work<kSpill>(a, smem, warp, p, 0), p,
                               lane);
}

// Launches kernel<kWideR, kSpill> of an entry (epoch or affine) with the
// dynamic shared memory it takes.
template <bool kWideR, int kSpill>
cudaError_t launch_with(bool epoch, const EpochArgs& a, size_t smem,
                        cudaStream_t s) {
  const void* fn = epoch ? (const void*)admm_epoch_kernel<kWideR, kSpill>
                         : (const void*)affine_kernel<kWideR, kSpill>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.P + a.qpb - 1) / a.qpb);
  const dim3 block(a.qpb * kWarp);
  if (epoch)
    admm_epoch_kernel<kWideR, kSpill><<<grid, block, smem, s>>>(a);
  else
    affine_kernel<kWideR, kSpill><<<grid, block, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kWideR>
cudaError_t launch_spill(bool epoch, const EpochArgs& a, size_t smem,
                         cudaStream_t s) {
  switch (a.spill) {
    case kInShared: return launch_with<kWideR, kInShared>(epoch, a, smem, s);
    case kHorizon: return launch_with<kWideR, kHorizon>(epoch, a, smem, s);
    case kRing: return launch_with<kWideR, kRing>(epoch, a, smem, s);
    default: return launch_with<kWideR, kAll>(epoch, a, smem, s);
  }
}

// Launches the epoch kernel (epoch) or the affine kernel (!epoch): one warp
// per problem, a.qpb problems per block, smem_bytes of dynamic shared
// memory, which must equal the carve of the plan (0 at kAll). Up to 32
// controls and rows the instantiation of the first kernel's arithmetic;
// past 32 the lanes loop over them. From kHorizon a.kff, at kAll a.work
// are the global scratch.
int launch(bool epoch, const EpochArgs& a, int smem_bytes, void* stream) {
  if (a.P <= 0 || a.N <= 0 || a.nz <= 0 || a.nz > kWarp ||
      a.nc <= 0 || a.mr < 0 || a.epoch_len <= 0 || a.qpb <= 0 ||
      a.qpb > kWarp || a.ring <= 0 || a.spill < kInShared ||
      a.spill > kAll || (a.spill >= kHorizon && !a.kff) ||
      (a.spill == kAll && !a.work))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      a.spill == kAll ? 0
                      : sizeof(float) * (size_t)a.qpb *
                            (size_t)qp_floats(a.N, a.ring, a.nz, a.nc, a.mr,
                                              a.spill);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.nc > kWarp || a.mr > kWarp)
    return (int)launch_spill<true>(epoch, a, smem, s);
  return (int)launch_spill<false>(epoch, a, smem, s);
}

}  // namespace

#define ADMM_EPOCH_PARAMS                                                   \
  const float *F, const float *G, const float *d, const float *K,           \
      const float *Quu_inv, const float *Qxu, const float *m,               \
      const float *q, const float *r, const float *D, const float *E,       \
      const float *lo, const float *hi, const float *rv,                    \
      const float *fac_lo, const float *fac_hi, const float *z0,            \
      const float *w0, const float *y0, float *z_out, float *c_out,         \
      float *w_out, float *y_out, float *rp_out, float *rd_out, float *kff, \
      float *work, int P, int N, int nz, int nc, int mr, int epoch_len,     \
      float alpha, int qps_per_block, int ring, int spill, int smem_bytes,  \
      void *stream
#define ADMM_EPOCH_FIELDS                                                   \
  F, G, d, K, Quu_inv, Qxu, m, q, r, D, E, lo, hi, rv, fac_lo, fac_hi, z0,  \
      w0, y0, z_out, c_out, w_out, y_out, rp_out, rd_out, kff, work, P, N,  \
      nz, nc, mr, epoch_len, qps_per_block, ring, spill, alpha

#ifndef CMPC_ADMM_EPOCH_CLOCKS
extern "C" int cmpc_admm_epoch(ADMM_EPOCH_PARAMS) {
  if (mr <= 0) return (int)cudaErrorInvalidValue;
  const EpochArgs a = {ADMM_EPOCH_FIELDS};
  return launch(true, a, smem_bytes, stream);
}

extern "C" int cmpc_lqr_affine(
    const float* F, const float* G, const float* d, const float* K,
    const float* Quu_inv, const float* Qxu, const float* m, const float* q,
    const float* r, const float* z0, float* z_out, float* c_out, float* kff,
    float* work, int P, int N, int nz, int nc, int qps_per_block, int ring,
    int spill, int smem_bytes, void* stream) {
  EpochArgs a = {F,       G,       d,       K,       Quu_inv, Qxu,
                 m,       q,       r,       nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, z0,      nullptr,
                 nullptr, z_out,   c_out,   nullptr, nullptr, nullptr,
                 nullptr, kff,     work,    P,       N,       nz,
                 nc,      0,       1,       qps_per_block,    ring,
                 spill,   0.f};
  return launch(false, a, smem_bytes, stream);
}
#else
// The clock-stamped build: stamps (P, stamps, 3) int64, each (label, the
// QP's warp's clock twice) at one point of its solve, in order; the last
// row is the QP's SM, start and end (stamp_qp).
extern "C" int cmpc_admm_epoch_clocked(ADMM_EPOCH_PARAMS, long long* clocks,
                                       int stamps) {
  if (mr <= 0) return (int)cudaErrorInvalidValue;
  const EpochArgs a = {ADMM_EPOCH_FIELDS, {clocks, stamps}};
  return launch(true, a, smem_bytes, stream);
}

// Stamps per QP, at most: the start and the first load, four per visit of
// a chunk (the feed, two phases, the wait), and the QP's row.
extern "C" int cmpc_admm_epoch_clock_stamps(int N, int ring, int epoch_len) {
  const int S = ring < N ? ring : N;
  return 2 + 4 * 2 * ((N + S - 1) / S) * epoch_len + 1;
}

extern "C" const char* cmpc_admm_epoch_clock_names() {
  return "-;first load;pre-pass t g;backward chain;forward chain;"
         "row pass;ring feed;ring wait";
}
#endif
