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
// Riccati chain: N dependent stage steps per QP, each a few 11x11 products
// separated by barriers.
//
// What the design does about it.
// * One block per QP, one thread per entry of an nz x nz matrix (128
//   threads at nz=11), so each product of a stage step is one short chain
//   of fused multiply-adds per thread and the step is a handful of
//   barriers deep.
//   768 blocks of 4 warps are resident on the card at once.
// * Stage inputs stream through shared memory: while stage k runs, cp.async
//   brings stage k-1 into the other of two slots, so the chain never waits
//   on device memory after the first stage.
// * The work that does not depend on P_{k+1} (row mask, rv, masked rows,
//   the augmentation D'diag(rv)D, E'diag(rv)E, D'diag(rv)E, the prox
//   factors) runs in the same barrier intervals as the products with
//   P_{k+1}, on the same threads, so it adds no barrier to the chain.
// * Order of operations: bit for bit the plain version's on the card. In
//   float32 the MPCC planner's QPs cancel so much (Qxu ~ 7e4 out of far
//   larger terms) that two summation orders land ~1e-3 of scale apart, so
//   only the same order agrees with the plain version. The kernel follows
//   the order of the card's batched library routines that the plain
//   version calls (cuBLAS batched GEMM, cuSOLVER / MAGMA batched Cholesky
//   and solve), read off this build's results on the H100
//   (PERF.md): a matrix product sums its terms as fused multiply-adds in
//   index order from zero (fma_dot); a matrix-vector product (m = P d)
//   sums two halves, [0, ceil(n/2)) and the rest, and adds them; the
//   Cholesky factor goes column by column, L_jj = sqrt(a_jj - ...) with
//   the updates as fused multiply-adds, L_ij = (a_ij - ...) * (1 / L_jj);
//   the solves go forward with the terms in index order and back with
//   them in reverse, each row times 1 / L_ii. Separate terms are added as
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
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrapper (ops/cuda_lqr.py epoch_data_batched) checks; rho_scale is
// (P, mr); soft_lo / soft_hi may be null (every row hard). Plain C
// interface for ctypes; the entry launches on the given stream and returns
// cudaGetLastError(). nz, nc, mr <= 32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDim = 32;

struct DataArgs {
  const float *F, *G, *d, *Q, *R, *S, *D, *E, *lo, *hi, *slo, *shi, *rs;
  float *K, *Qi, *Qxu, *m, *Dm, *Em, *rv, *flo, *fhi;
  int P, N, nz, nc, mr;
  float rho, reg;
};

// Floats of one stage's inputs in a slot: F, G, Q, R, S, d, D, E, lo, hi,
// soft_lo, soft_hi.
__host__ __device__ inline int data_stage_floats(int nz, int nc, int mr) {
  return 2 * nz * nz + 2 * nz * nc + nc * nc + nz + mr * (nz + nc + 4);
}

// Floats of one block's shared memory: two stage slots, the value Hessian
// P, the products P F and P G, Qxx, Qxu, Quu, its factor L and the
// reciprocals of its diagonal, the gains K, and per row rv, rho_scale, Dm,
// Dw = Dm rv, Em and Ew = Em rv.
__host__ __device__ inline int data_block_floats(int nz, int nc, int mr) {
  return 2 * data_stage_floats(nz, nc, mr) + 3 * nz * nz + 2 * nz * nc +
         2 * nc * nc + nc + nc * nz + mr * (2 + 2 * nz + 2 * nc);
}

struct Slot {
  float *F, *G, *Q, *R, *S, *d, *D, *E, *lo, *hi, *slo, *shi;
};

__device__ inline Slot slot_at(float* base, int i, int nz, int nc, int mr) {
  Slot s;
  float* p = base + (size_t)i * data_stage_floats(nz, nc, mr);
  s.F = p;   p += nz * nz;
  s.G = p;   p += nz * nc;
  s.Q = p;   p += nz * nz;
  s.R = p;   p += nc * nc;
  s.S = p;   p += nz * nc;
  s.d = p;   p += nz;
  s.D = p;   p += mr * nz;
  s.E = p;   p += mr * nc;
  s.lo = p;  p += mr;
  s.hi = p;  p += mr;
  s.slo = p; p += mr;
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

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

__device__ inline void load_field(float* dst, const float* src, int count) {
  for (int o = threadIdx.x; o < count; o += blockDim.x)
    cp_async4(dst + o, src + o);
}

// Stage k of problem p into slot s, asynchronously; absent soft weights
// are +inf (hard rows).
__device__ inline void load_stage(const DataArgs& a, const Slot& s, int p,
                                  int k) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  const size_t st = (size_t)p * N + k;
  load_field(s.F, a.F + st * nz * nz, nz * nz);
  load_field(s.G, a.G + st * nz * nc, nz * nc);
  load_field(s.Q, a.Q + ((size_t)p * (N + 1) + k) * nz * nz, nz * nz);
  load_field(s.R, a.R + st * nc * nc, nc * nc);
  load_field(s.S, a.S + st * nz * nc, nz * nc);
  load_field(s.d, a.d + st * nz, nz);
  load_field(s.D, a.D + st * mr * nz, mr * nz);
  load_field(s.E, a.E + st * mr * nc, mr * nc);
  load_field(s.lo, a.lo + st * mr, mr);
  load_field(s.hi, a.hi + st * mr, mr);
  if (a.slo) {
    load_field(s.slo, a.slo + st * mr, mr);
  } else {
    for (int o = threadIdx.x; o < mr; o += blockDim.x) s.slo[o] = INFINITY;
  }
  if (a.shi) {
    load_field(s.shi, a.shi + st * mr, mr);
  } else {
    for (int o = threadIdx.x; o < mr; o += blockDim.x) s.shi[o] = INFINITY;
  }
  cp_async_commit();
}

// Row j's mask (a finite bound on either side) and its rv = (rho * mask)
// * rho_scale, as the plain version forms them.
__device__ __forceinline__ float row_mask(const Slot& s, int j) {
  return (isfinite(s.lo[j]) || isfinite(s.hi[j])) ? 1.f : 0.f;
}

__device__ __forceinline__ float row_rv(const Slot& s, const float* rsc,
                                        float rho, int j) {
  return __fmul_rn(__fmul_rn(rho, row_mask(s, j)), rsc[j]);
}

// acc + sum over l in [l0, l1) of a[l sa] * b[l sb], one fused multiply-add
// per term in index order (the order of the card's batched GEMM).
__device__ __forceinline__ float fma_dot(const float* a, int sa,
                                         const float* b, int sb, int l0,
                                         int l1, float acc) {
  for (int l = l0; l < l1; ++l) acc = fmaf(a[l * sa], b[l * sb], acc);
  return acc;
}

// Solve L L' x = b in place (b of length n; L lower triangular, row-major
// n x n; rcp[i] = 1 / L_ii): forward with the terms in index order, back
// with them in reverse, as the card's batched solve.
__device__ inline void chol_solve(const float* L, const float* rcp, float* x,
                                  int n) {
  for (int i = 0; i < n; ++i) {
    float s = x[i];
    for (int j = 0; j < i; ++j) s = fmaf(-L[i * n + j], x[j], s);
    x[i] = __fmul_rn(s, rcp[i]);
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i];
    for (int j = n - 1; j > i; --j) s = fmaf(-L[j * n + i], x[j], s);
    x[i] = __fmul_rn(s, rcp[i]);
  }
}

__global__ void epoch_data_kernel(DataArgs a) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  const int tid = threadIdx.x, T = blockDim.x;

  float* base = smem;
  float* w = base + 2 * data_stage_floats(nz, nc, mr);
  float* Pm = w;   w += nz * nz;   // value Hessian P_{k+1}
  float* PF = w;   w += nz * nz;
  float* Qxx = w;  w += nz * nz;
  float* PG = w;   w += nz * nc;
  float* Qxu = w;  w += nz * nc;
  float* Quu = w;  w += nc * nc;
  float* L = w;    w += nc * nc;
  float* rcp = w;  w += nc;        // 1 / L_jj
  float* Kg = w;   w += nc * nz;
  float* rvs = w;  w += mr;
  float* rsc = w;  w += mr;
  float* Dm = w;   w += mr * nz;
  float* Dw = w;   w += mr * nz;
  float* Em = w;   w += mr * nc;
  float* Ew = w;

  // P_N = Q_N (the terminal cost is not augmented), rho_scale, stage N-1
  for (int o = tid; o < nz * nz; o += T)
    Pm[o] = a.Q[((size_t)p * (N + 1) + N) * nz * nz + o];
  for (int o = tid; o < mr; o += T) rsc[o] = a.rs[(size_t)p * mr + o];
  load_stage(a, slot_at(base, (N - 1) & 1, nz, nc, mr), p, N - 1);
  cp_async_wait_all();
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    const Slot s = slot_at(base, k & 1, nz, nc, mr);
    // the next stage streams into the other slot while this one runs
    if (k > 0) load_stage(a, slot_at(base, (k - 1) & 1, nz, nc, mr), p, k - 1);
    const size_t st = (size_t)p * N + k;

    // (1) rows: rv, prox factors, the masked rows and their rv-weighted
    //     copies; P F, P G and m = P d
    for (int o = tid; o < mr; o += T) {
      const float r = row_rv(s, rsc, a.rho, o);
      const float safe = r > 0.f ? r : 1.f;
      const float sl = s.slo[o], sh = s.shi[o];
      rvs[o] = r;
      a.rv[st * mr + o] = r;
      a.flo[st * mr + o] =
          isinf(sl) ? 0.f
                    : __fdiv_rn(safe, __fadd_rn(safe, __fmul_rn(2.f, sl)));
      a.fhi[st * mr + o] =
          isinf(sh) ? 0.f
                    : __fdiv_rn(safe, __fadd_rn(safe, __fmul_rn(2.f, sh)));
    }
    for (int o = tid; o < mr * nz; o += T) {
      const int j = o / nz;
      const float v = __fmul_rn(s.D[o], row_mask(s, j));
      Dm[o] = v;
      Dw[o] = __fmul_rn(v, row_rv(s, rsc, a.rho, j));
      a.Dm[st * mr * nz + o] = v;
    }
    for (int o = tid; o < mr * nc; o += T) {
      const int j = o / nc;
      const float v = __fmul_rn(s.E[o], row_mask(s, j));
      Em[o] = v;
      Ew[o] = __fmul_rn(v, row_rv(s, rsc, a.rho, j));
      a.Em[st * mr * nc + o] = v;
    }
    for (int o = tid; o < nz * nz; o += T) {
      const int i = o / nz, j = o - i * nz;
      PF[o] = fma_dot(Pm + i * nz, 1, s.F + j, nz, 0, nz, 0.f);
    }
    for (int o = tid; o < nz * nc; o += T) {
      const int i = o / nc, c = o - i * nc;
      PG[o] = fma_dot(Pm + i * nz, 1, s.G + c, nc, 0, nz, 0.f);
    }
    for (int i = tid; i < nz; i += T) {
      const int h = (nz + 1) / 2;  // m = P d: two halves, then their sum
      a.m[st * nz + i] =
          __fadd_rn(fma_dot(Pm + i * nz, 1, s.d, 1, 0, h, 0.f),
                    fma_dot(Pm + i * nz, 1, s.d, 1, h, nz, 0.f));
    }
    __syncthreads();

    // (2) Qxx = (Q + Dw'Dm) + F'(PF), Qxu = (S + Dw'Em) + F'(PG),
    //     Quu = (R + Ew'Em) + G'(PG), Ew = Em rv
    for (int o = tid; o < nz * nz; o += T) {
      const int i = o / nz, j = o - i * nz;
      const float qa =
          __fadd_rn(s.Q[o], fma_dot(Dw + i, nz, Dm + j, nz, 0, mr, 0.f));
      Qxx[o] = __fadd_rn(qa, fma_dot(s.F + i, nz, PF + j, nz, 0, nz, 0.f));
    }
    for (int o = tid; o < nz * nc; o += T) {
      const int i = o / nc, c = o - i * nc;
      const float sa =
          __fadd_rn(s.S[o], fma_dot(Dw + i, nz, Em + c, nc, 0, mr, 0.f));
      const float v =
          __fadd_rn(sa, fma_dot(s.F + i, nz, PG + c, nc, 0, nz, 0.f));
      Qxu[o] = v;
      a.Qxu[st * nz * nc + o] = v;
    }
    for (int o = tid; o < nc * nc; o += T) {
      const int c = o / nc, b = o - c * nc;
      const float ra =
          __fadd_rn(s.R[o], fma_dot(Ew + c, nc, Em + b, nc, 0, mr, 0.f));
      Quu[o] = __fadd_rn(ra, fma_dot(s.G + c, nc, PG + b, nc, 0, nz, 0.f));
    }
    __syncthreads();

    // (3) L = chol(0.5 (Quu + Quu') + reg I) column by column, all NaN
    //     unless every pivot is > 0 (the plain version's NaN for a failed
    //     cholesky_ex, as JAX's cholesky)
    if (tid == 0) {
      bool ok = true;
      for (int j = 0; j < nc; ++j) {
        for (int i = j; i < nc; ++i) {
          float v = __fmul_rn(0.5f, __fadd_rn(Quu[i * nc + j],
                                              Quu[j * nc + i]));
          v = __fadd_rn(v, i == j ? a.reg : 0.f);
          for (int l = 0; l < j; ++l)
            v = fmaf(-L[i * nc + l], L[j * nc + l], v);
          if (i == j) {
            if (!(v > 0.f)) ok = false;
            L[j * nc + j] = __fsqrt_rn(v);
            rcp[j] = __frcp_rn(L[j * nc + j]);
          } else {
            L[i * nc + j] = __fmul_rn(v, rcp[j]);
          }
        }
        for (int i = 0; i < j; ++i) L[i * nc + j] = 0.f;
      }
      if (!ok)
        for (int i = 0; i < nc; ++i) {
          rcp[i] = NAN;
          for (int j = 0; j <= i; ++j) L[i * nc + j] = NAN;
        }
    }
    __syncthreads();

    // (4) K = -Quu^-1 Qxu' (one column per thread), Quu_inv = Quu^-1
    if (tid < nz + nc) {
      float x[kMaxDim];
      const bool gain = tid < nz;
      const int col = gain ? tid : tid - nz;
      for (int c = 0; c < nc; ++c)
        x[c] = gain ? Qxu[col * nc + c] : (c == col ? 1.f : 0.f);
      chol_solve(L, rcp, x, nc);
      for (int c = 0; c < nc; ++c) {
        if (gain) {
          Kg[c * nz + col] = -x[c];
          a.K[st * nc * nz + c * nz + col] = -x[c];
        } else {
          a.Qi[st * nc * nc + c * nc + col] = x[c];
        }
      }
    }
    __syncthreads();

    // (5) P_k = 0.5 (M + M'), M = Qxx + Qxu K
    for (int o = tid; o < nz * nz; o += T) {
      const int i = o / nz, j = o - i * nz;
      const float mij = __fadd_rn(
          Qxx[o], fma_dot(Qxu + i * nc, 1, Kg + j, nz, 0, nc, 0.f));
      const float mji = __fadd_rn(
          Qxx[j * nz + i], fma_dot(Qxu + j * nc, 1, Kg + i, nz, 0, nc, 0.f));
      Pm[o] = __fmul_rn(0.5f, __fadd_rn(mij, mji));
    }
    // the next stage's slot has arrived, and every thread is past (5)
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace

extern "C" int cmpc_epoch_data(
    const float* F, const float* G, const float* d, const float* Q,
    const float* R, const float* S, const float* D, const float* E,
    const float* lo, const float* hi, const float* soft_lo,
    const float* soft_hi, const float* rho_scale, float* K, float* Quu_inv,
    float* Qxu, float* m, float* D_out, float* E_out, float* rv,
    float* fac_lo, float* fac_hi, int P, int N, int nz, int nc, int mr,
    float rho, float reg, int threads, int smem_bytes, void* stream) {
  if (P <= 0 || N <= 0 || nz <= 0 || nz > kMaxDim || nc <= 0 ||
      nc > kMaxDim || mr <= 0 || mr > kMaxDim || threads <= 0 ||
      threads % 32 != 0 || threads > 1024 || nz + nc > threads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)data_block_floats(nz, nc, mr);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        epoch_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  DataArgs a = {F,  G,     d,     Q,      R,     S,   D,  E,  lo,  hi,
                soft_lo, soft_hi, rho_scale, K, Quu_inv, Qxu, m, D_out, E_out,
                rv, fac_lo, fac_hi, P, N, nz, nc, mr, rho, reg};
  epoch_data_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
