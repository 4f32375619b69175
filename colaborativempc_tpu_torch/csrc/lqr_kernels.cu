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
// ~2.5 us per step, 2.0 ms per epoch at that shape. PERF.md has this
// design's times.
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
// * The arithmetic of every value, and its order, is that of the first
//   port's kernel: sequential sums and the same xor-tree warp sums (two at
//   a time, so their shuffles overlap), so the results are bit for bit
//   those of the kernel the port's checks were accepted with. The
//   closed-loop form (A_cl = F + G K, one matvec per chain step) was
//   measured faster and rejected: it moves rounding, and the NL hp_opt /
//   Gauss-Seidel check of chip_smoke.py then left its tolerance (PERF.md).
// * Lanes and banks. Lane i owns state row i. The column read of F' tt
//   (consecutive addresses) and the row read of F z (stride nz = 11,
//   coprime to the 32 banks) are conflict-free; tt and z are broadcast from
//   their hist row.
// * One warp per QP, `qps_per_block` warps per block, independent: warps
//   sync with __syncwarp only, never the block, so a warp of the ragged last
//   block returns early without deadlock. The launch plan (QPs per block,
//   ring depth, shared-memory bytes) is chosen in Python
//   (ops/cuda_lqr.py kernel_plan) and checked here against the carve.
//
// Semantics match the Pallas kernel: residuals come from the last iteration
// only, mask = (rv > 0), the soft-row prox shrinks by fac_lo / fac_hi toward
// [lo, hi] (fac = 0 makes a hard row a clip), and lo / hi may be +-inf. The
// prox BRANCHES instead of blending: hi + fac_hi*(wbar - hi) is NaN on a row
// with hi = +inf and must never be evaluated into the result. The max over
// stages propagates NaN, as jnp.max does. Build without --use_fast_math: the
// prox relies on inf comparisons and the Riccati chain is sensitive to
// rounding. nz, nc, mr <= 32.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrapper (ops/cuda_lqr.py) checks. Plain C interface for ctypes; each entry
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

struct EpochArgs {
  const float *F, *G, *d, *K, *Quu_inv, *Qxu, *m, *q, *r;
  const float *D, *E, *lo, *hi, *rv, *fac_lo, *fac_hi;
  const float *z0, *w0, *y0;
  float *z_out, *c_out, *w_out, *y_out, *rp_out, *rd_out;
  int P, N, nz, nc, mr, epoch_len, qpb, ring;
  float alpha;
};

// Floats of one stage's fixed data in a ring slot: F, G, d, K, Quu_inv,
// Qxu, m, q, r, D, E, lo, hi, rv, fac_lo, fac_hi.
__host__ __device__ inline int stage_floats(int nz, int nc, int mr) {
  return nz * nz + 3 * nz * nc + nc * nc + 3 * nz + nc + mr * (nz + nc + 5);
}

// Floats of one QP's shared memory: w, y and kff over the horizon, one
// chunk's scratch (hist, g, t, c, and qu) and the ring slots (one when the
// ring holds the horizon, else two).
__host__ __device__ inline int qp_floats(int N, int ring, int nz, int nc,
                                         int mr) {
  const int S = ring < N ? ring : N;
  const int slots = ring < N ? 2 : 1;
  return 2 * N * mr + N * nc + (S + 1) * nz + S * (nz + mr + nc) + nc +
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

// Backward sweep through one resident chunk [k0, k0+n): before the chain,
// every stage's t and q + D' t; the chain carries the costate p (lane i
// holds row i) from p_{k0+n} down to p_{k0} and leaves kff of each stage.
template <bool kRows>
__device__ void backward_chunk(const Slot& sl, const Work& wk, int k0, int n,
                               int nz, int nc, int mr, int lane, float& p) {
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
  for (int kk = n - 1; kk >= 0; --kk) {
    const int k = k0 + kk;
    float* tt = wk.hist + (kk + 1) * nz;
    float ttl = 0.f;
    if (lane < nz) {
      ttl = p + sl.m[kk * nz + lane];
      tt[lane] = ttl;
    }
    __syncwarp();
    // Qu_a = r_a + sum over lanes of G[lane][a] tt_lane + E[lane][a] t_lane,
    // two controls at a time (a lone last one sums beside a zero)
    for (int a = 0; a < nc; a += 2) {
      const int b = a + 1 < nc ? a + 1 : a;
      float u = lane < nz ? sl.G[(kk * nz + lane) * nc + a] * ttl : 0.f;
      float v = lane < nz ? sl.G[(kk * nz + lane) * nc + b] * ttl : 0.f;
      if (kRows && lane < mr) {
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
    if (lane < nc) {
      float acc = 0.f;
      for (int b = 0; b < nc; ++b)
        acc += sl.Qi[(kk * nc + lane) * nc + b] * wk.qu[b];
      wk.kff[k * nc + lane] = -acc;
    }
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

struct Out {
  float *z, *c;  // this problem's rows of z_out, c_out
};

// Forward sweep through one resident chunk: the chain carries the state z
// from z_{k0} to z_{k0+n}, c_k = K z_k + kff_k by warp sums; after it, every
// row's v = D z + E c, over-relaxation, prox and dual update, and in the
// last iteration (kLast) the partial residual maxima (one per lane, over
// its stages) and the outputs z, c.
template <bool kRows, bool kLast>
__device__ void forward_chunk(const Slot& sl, const Work& wk, int k0, int n,
                              int nz, int nc, int mr, int lane, float alpha,
                              float& z, const Out& out, float& rp,
                              float& rd) {
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
  if (kRows) {
    const RowLane L = row_lane(lane, mr);
    for (int kk = L.g; kk < n; kk += L.G) {
      const int o = kk * mr + L.i, g = k0 * mr + o;
      float v = 0.f;
      for (int i = 0; i < nz; ++i)
        v += sl.D[o * nz + i] * wk.hist[kk * nz + i];
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
      if (kLast) {
        const float msk = sl.rv[o] > 0.f ? 1.f : 0.f;
        rp = nan_max(rp, fabsf(msk * (v - wn)));
        rd = nan_max(rd, fabsf(msk * (wn - w)));
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
// of the visits. The affine solve is epoch_len = 1 without rows.
template <bool kRows>
__device__ void solve(const EpochArgs& a, float* base, int p, int lane) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = kRows ? a.mr : 0;
  const int S = a.ring < N ? a.ring : N;
  const int n_slots = a.ring < N ? 2 : 1;
  const int C = (N + S - 1) / S;  // chunks

  Work wk;
  wk.w = base;
  wk.y = wk.w + N * mr;
  wk.kff = wk.y + N * mr;
  wk.hist = wk.kff + N * nc;
  wk.g = wk.hist + (S + 1) * nz;
  wk.t = wk.g + S * nz;
  wk.c = wk.t + S * mr;
  wk.qu = wk.c + S * nc;
  float* const slots = wk.qu + nc;  // n_slots ring slots of S stages

  const int nw = N * mr;
  for (int o = lane; o < nw; o += kWarp) {
    wk.w[o] = a.w0[(size_t)p * nw + o];
    wk.y[o] = a.y0[(size_t)p * nw + o];
  }
  const float p_term =
      lane < nz ? a.q[((size_t)p * (N + 1) + N) * nz + lane] : 0.f;
  const float z_init = lane < nz ? a.z0[(size_t)p * nz + lane] : 0.f;
  const Out out = {a.z_out + (size_t)p * (N + 1) * nz,
                   a.c_out + (size_t)p * N * nc};

  // visit v of an iteration: 0..C-1 backward over chunks C-1..0, C..2C-1
  // forward over chunks 0..C-1
  auto chunk_of = [C](int v) { return v < C ? C - 1 - v : v - C; };
  auto stages_of = [N, S](int c) { return c * S + S <= N ? S : N - c * S; };
  const int visits = 2 * C * a.epoch_len;
  int held0 = C - 1, held1 = -1;  // the chunk each slot holds
  load_chunk(a, slot_at(slots, 0, S, nz, nc, mr), p, held0 * S,
             stages_of(held0), lane);
  arrive();

  float pc = 0.f, z = 0.f, rp = 0.f, rd = 0.f;
  for (int v = 0; v < visits; ++v) {
    const int it = v / (2 * C), vi = v - it * 2 * C;
    const int c = chunk_of(vi);
    const int cur = held0 == c ? 0 : 1;
    // feed the ring ahead of the sweep: the next visit's chunk goes into
    // the other slot unless a slot holds it already
    bool fed = false;
    if (v + 1 < visits && n_slots == 2) {
      const int nxt = chunk_of((v + 1) % (2 * C));
      if (nxt != held0 && nxt != held1) {
        fed = true;
        if (cur == 0) held1 = nxt; else held0 = nxt;
        load_chunk(a, slot_at(slots, 1 - cur, S, nz, nc, mr), p, nxt * S,
                   stages_of(nxt), lane);
      }
    }
    const Slot sl = slot_at(slots, cur, S, nz, nc, mr);
    if (vi < C) {
      if (vi == 0) pc = p_term;
      backward_chunk<kRows>(sl, wk, c * S, stages_of(c), nz, nc, mr, lane,
                            pc);
    } else {
      if (vi == C) z = z_init;
      if (it == a.epoch_len - 1)
        forward_chunk<kRows, true>(sl, wk, c * S, stages_of(c), nz, nc, mr,
                                   lane, a.alpha, z, out, rp, rd);
      else
        forward_chunk<kRows, false>(sl, wk, c * S, stages_of(c), nz, nc, mr,
                                    lane, a.alpha, z, out, rp, rd);
    }
    if (fed) arrive();
  }
  if (lane < nz) out.z[N * nz + lane] = z;
  for (int o = lane; o < nw; o += kWarp) {
    a.w_out[(size_t)p * nw + o] = wk.w[o];
    a.y_out[(size_t)p * nw + o] = wk.y[o];
  }
  if (kRows) {
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
}

__global__ void admm_epoch_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * a.qpb + warp;
  if (p >= a.P) return;  // whole warp leaves; no block-wide barrier exists
  solve<true>(a,
              smem + (size_t)warp * qp_floats(a.N, a.ring, a.nz, a.nc, a.mr),
              p, lane);
}

__global__ void affine_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * a.qpb + warp;
  if (p >= a.P) return;  // whole warp leaves; no block-wide barrier exists
  solve<false>(a, smem + (size_t)warp * qp_floats(a.N, a.ring, a.nz, a.nc, 0),
               p, lane);
}

// Launches the epoch kernel (epoch) or the affine kernel (!epoch): one warp
// per problem, a.qpb problems per block, smem_bytes of dynamic shared
// memory, which must equal the carve of the plan.
int launch(bool epoch, const EpochArgs& a, int smem_bytes, void* stream) {
  if (a.P <= 0 || a.N <= 0 || a.nz <= 0 || a.nz > kWarp || a.nc <= 0 ||
      a.nc > kWarp || a.mr < 0 || a.mr > kWarp || a.epoch_len <= 0 ||
      a.qpb <= 0 || a.qpb > kWarp || a.ring <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)a.qpb *
                      (size_t)qp_floats(a.N, a.ring, a.nz, a.nc, a.mr);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  const void* fn = epoch ? (const void*)admm_epoch_kernel
                         : (const void*)affine_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.P + a.qpb - 1) / a.qpb);
  const dim3 block(a.qpb * kWarp);
  if (epoch)
    admm_epoch_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  else
    affine_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cmpc_admm_epoch(
    const float* F, const float* G, const float* d, const float* K,
    const float* Quu_inv, const float* Qxu, const float* m, const float* q,
    const float* r, const float* D, const float* E, const float* lo,
    const float* hi, const float* rv, const float* fac_lo,
    const float* fac_hi, const float* z0, const float* w0, const float* y0,
    float* z_out, float* c_out, float* w_out, float* y_out, float* rp_out,
    float* rd_out, int P, int N, int nz, int nc, int mr, int epoch_len,
    float alpha, int qps_per_block, int ring, int smem_bytes, void* stream) {
  if (mr <= 0) return (int)cudaErrorInvalidValue;
  EpochArgs a = {F,      G,      d,      K,      Quu_inv, Qxu,   m,
                 q,      r,      D,      E,      lo,      hi,    rv,
                 fac_lo, fac_hi, z0,     w0,     y0,      z_out, c_out,
                 w_out,  y_out,  rp_out, rd_out, P,       N,     nz,
                 nc,     mr,     epoch_len, qps_per_block, ring, alpha};
  return launch(true, a, smem_bytes, stream);
}

extern "C" int cmpc_lqr_affine(
    const float* F, const float* G, const float* d, const float* K,
    const float* Quu_inv, const float* Qxu, const float* m, const float* q,
    const float* r, const float* z0, float* z_out, float* c_out, int P, int N,
    int nz, int nc, int qps_per_block, int ring, int smem_bytes,
    void* stream) {
  EpochArgs a = {F,       G,       d,       K,       Quu_inv, Qxu,
                 m,       q,       r,       nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, z0,      nullptr,
                 nullptr, z_out,   c_out,   nullptr, nullptr, nullptr,
                 nullptr, P,       N,       nz,      nc,      0,
                 1,       qps_per_block,    ring,    0.f};
  return launch(false, a, smem_bytes, stream);
}
