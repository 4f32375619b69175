// Batched LQR affine sweeps and the whole ADMM epoch, hand-written for
// Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the two Pallas TPU kernels of colaborativempc_tpu/ops/pallas_lqr.py:
//   cmpc_admm_epoch  -> _admm_epoch_kernel (via admm_epoch_batched): one whole
//                       ADMM epoch of `epoch_len` iterations with a fixed
//                       Riccati factorisation;
//   cmpc_lqr_affine  -> _affine_kernel (via lqr_affine_solve_batched): one
//                       batched affine LQR solve with fixed factors.
// Both entries run the same two __device__ sweeps (backward_sweep,
// forward_sweep); the epoch adds the constraint rows to them.
//
// What bounds it on the H100: each ADMM iteration is a serial chain of 2*N
// dependent stage steps (costate sweep back, closed-loop rollout forward),
// each an 11x11 matvec plus a few 2-wide reductions. The work per stage is
// tiny, so the kernel is bound by the latency of that chain (loads from L2
// and warp shuffles), not by bytes or FLOPs. At the headline shape (768 QPs,
// N=20, nz=11, nc=2, mr=6) the fixed epoch data is ~29 KB per QP, ~22 MB in
// all, which stays resident in the 50 MB L2 for the whole epoch.
//
// What the design does about it: one warp per problem (so 768 QPs give 768
// independent chains in flight), lanes over the nz state rows and the mr
// constraint rows, warp shuffles for the small reductions, and the whole
// epoch in one launch so no iterate leaves the chip between iterations. The
// iterates (z, c, w, y, kff and the costate scratch) live in shared memory:
// ((N+1)*nz + 2*N*nc + 2*N*mr + nz + mr + nc) floats per QP, about 13.6 KB
// even at N=125, so every horizon the solver runs fits and no shape gate or
// fallback exists. The fixed data is read from global memory (L2-resident);
// staging it in shared memory, TMA and wgmma are left for later work.
//
// Semantics match the Pallas kernel exactly: residuals come from the last
// iteration only, mask = (rv > 0), the soft-row prox shrinks by fac_lo /
// fac_hi toward [lo, hi] (fac = 0 makes a hard row a clip), and lo / hi may
// be +-inf. The prox BRANCHES instead of blending: hi + fac_hi*(wbar - hi)
// is NaN on a row with hi = +inf and must never be evaluated into the result.
// Build without --use_fast_math: the prox relies on inf comparisons and the
// Riccati chain is sensitive to rounding.
//
// Layout: row-major (P, N, ...) float32 tensors, contiguous, as the PyTorch
// wrapper (ops/cuda_lqr.py) checks. Plain C interface for ctypes; each entry
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kProblemsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct EpochArgs {
  const float *F, *G, *d, *K, *Quu_inv, *Qxu, *m, *q, *r;
  const float *D, *E, *lo, *hi, *rv, *fac_lo, *fac_hi;
  const float *z0, *w0, *y0;
  float *z_out, *c_out, *w_out, *y_out, *rp_out, *rd_out;
  int P, N, nz, nc, mr, epoch_len;
  float alpha;
};

// One problem's fixed data, offset to that problem.
struct Problem {
  const float *F, *G, *d, *K, *Quu_inv, *Qxu, *m, *q, *r;
  const float *D, *E, *lo, *hi, *rv, *fac_lo, *fac_hi;
  const float *z0;
};

// One problem's iterates in shared memory.
struct Smem {
  float *z;    // (N+1, nz) rollout of the current iteration
  float *c;    // (N, nc)
  float *kff;  // (N, nc) feedforward from the costate sweep
  float *w;    // (N, mr) splitting variable
  float *y;    // (N, mr) scaled dual
  float *tt;   // (nz) costate + drift of the current stage
  float *t;    // (mr) rho-weighted dual gap of the current stage
  float *qu;   // (nc)
};

__host__ __device__ inline int smem_floats(int N, int nz, int nc, int mr) {
  return (N + 1) * nz + 2 * N * nc + 2 * N * mr + nz + mr + nc;
}

__device__ inline Smem carve(float* base, int N, int nz, int nc, int mr) {
  Smem s;
  s.z = base;
  s.c = s.z + (N + 1) * nz;
  s.kff = s.c + N * nc;
  s.w = s.kff + N * nc;
  s.y = s.w + N * mr;
  s.tt = s.y + N * mr;
  s.t = s.tt + nz;
  s.qu = s.t + mr;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

// Backward costate sweep with fixed K, Quu_inv, Qxu, m; writes kff.
//   tt = p + m_k;  Qu = r_k + r_pen_k + G_k' tt;  kff_k = -Quu_inv_k Qu
//   p <- q_k + q_pen_k + F_k' tt + Qxu_k kff_k
// With kRows the penalty terms q_pen = D't, r_pen = E't, t = rv*(y - w) are
// folded in stage by stage.
template <bool kRows>
__device__ void backward_sweep(const Problem& pb, const Smem& s, int N,
                               int nz, int nc, int mr, int lane) {
  float p = lane < nz ? pb.q[N * nz + lane] : 0.f;
  for (int k = N - 1; k >= 0; --k) {
    if (lane < nz) s.tt[lane] = p + pb.m[k * nz + lane];
    if (kRows && lane < mr) {
      const int o = k * mr + lane;
      s.t[lane] = pb.rv[o] * (s.y[o] - s.w[o]);
    }
    __syncwarp();
    for (int a = 0; a < nc; ++a) {
      float v = lane < nz ? pb.G[(k * nz + lane) * nc + a] * s.tt[lane] : 0.f;
      if (kRows && lane < mr) v += pb.E[(k * mr + lane) * nc + a] * s.t[lane];
      v = warp_sum(v);
      if (lane == 0) s.qu[a] = pb.r[k * nc + a] + v;
    }
    __syncwarp();
    if (lane < nc) {
      float acc = 0.f;
      for (int b = 0; b < nc; ++b)
        acc += pb.Quu_inv[(k * nc + lane) * nc + b] * s.qu[b];
      s.kff[k * nc + lane] = -acc;
    }
    __syncwarp();
    if (lane < nz) {
      float acc = pb.q[k * nz + lane];
      if (kRows)
        for (int j = 0; j < mr; ++j)
          acc += pb.D[(k * mr + j) * nz + lane] * s.t[j];
#pragma unroll 4
      for (int l = 0; l < nz; ++l)
        acc += pb.F[(k * nz + l) * nz + lane] * s.tt[l];
      for (int a = 0; a < nc; ++a)
        acc += pb.Qxu[(k * nz + lane) * nc + a] * s.kff[k * nc + a];
      p = acc;
    }
    __syncwarp();  // tt, t and qu are rewritten by the next stage
  }
}

// Forward closed-loop rollout: c_k = K_k z_k + kff_k,
// z_{k+1} = F_k z_k + G_k c_k + d_k. With kRows each stage also evaluates
// its constraint rows v = D z + E c and applies over-relaxation, the prox
// and the dual update to (w, y) in place, tracking the per-row-class
// residuals max|mask (v - w_new)| and max|mask (w_new - w)| over stages.
template <bool kRows>
__device__ void forward_sweep(const Problem& pb, const Smem& s, int N, int nz,
                              int nc, int mr, int lane, float alpha,
                              float& rp, float& rd) {
  float z = lane < nz ? pb.z0[lane] : 0.f;
  for (int k = 0; k < N; ++k) {
    if (lane < nz) s.z[k * nz + lane] = z;
    __syncwarp();
    for (int a = 0; a < nc; ++a) {
      float v = lane < nz ? pb.K[(k * nc + a) * nz + lane] * z : 0.f;
      v = warp_sum(v);
      if (lane == 0) s.c[k * nc + a] = v + s.kff[k * nc + a];
    }
    __syncwarp();
    if (lane < nz) {
      float acc = pb.d[k * nz + lane];
#pragma unroll 4
      for (int l = 0; l < nz; ++l)
        acc += pb.F[(k * nz + lane) * nz + l] * s.z[k * nz + l];
      for (int a = 0; a < nc; ++a)
        acc += pb.G[(k * nz + lane) * nc + a] * s.c[k * nc + a];
      z = acc;
    }
    if (kRows && lane < mr) {
      const int o = k * mr + lane;
      float v = 0.f;
      for (int i = 0; i < nz; ++i) v += pb.D[o * nz + i] * s.z[k * nz + i];
      for (int a = 0; a < nc; ++a) v += pb.E[o * nc + a] * s.c[k * nc + a];
      const float w = s.w[o];
      const float y = s.y[o];
      const float vhat = alpha * v + (1.f - alpha) * w;
      const float wbar = vhat + y;
      const float hi = pb.hi[o];
      const float lo = pb.lo[o];
      float wn = wbar;
      if (wbar > hi) wn = hi + pb.fac_hi[o] * (wbar - hi);
      if (wbar < lo) wn = lo + pb.fac_lo[o] * (wbar - lo);
      s.y[o] = y + vhat - wn;
      s.w[o] = wn;
      const float msk = pb.rv[o] > 0.f ? 1.f : 0.f;
      rp = nan_max(rp, fabsf(msk * (v - wn)));
      rd = nan_max(rd, fabsf(msk * (wn - w)));
    }
    __syncwarp();
  }
  if (lane < nz) s.z[N * nz + lane] = z;
}

__device__ inline Problem problem_at(const EpochArgs& a, int p) {
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  Problem pb = {};
  pb.F = a.F + (size_t)p * N * nz * nz;
  pb.G = a.G + (size_t)p * N * nz * nc;
  pb.d = a.d + (size_t)p * N * nz;
  pb.K = a.K + (size_t)p * N * nc * nz;
  pb.Quu_inv = a.Quu_inv + (size_t)p * N * nc * nc;
  pb.Qxu = a.Qxu + (size_t)p * N * nz * nc;
  pb.m = a.m + (size_t)p * N * nz;
  pb.q = a.q + (size_t)p * (N + 1) * nz;
  pb.r = a.r + (size_t)p * N * nc;
  pb.z0 = a.z0 + (size_t)p * nz;
  if (mr > 0) {
    pb.D = a.D + (size_t)p * N * mr * nz;
    pb.E = a.E + (size_t)p * N * mr * nc;
    pb.lo = a.lo + (size_t)p * N * mr;
    pb.hi = a.hi + (size_t)p * N * mr;
    pb.rv = a.rv + (size_t)p * N * mr;
    pb.fac_lo = a.fac_lo + (size_t)p * N * mr;
    pb.fac_hi = a.fac_hi + (size_t)p * N * mr;
  }
  return pb;
}

__device__ inline void store_zc(const EpochArgs& a, const Smem& s, int p,
                                int lane) {
  const int nzt = (a.N + 1) * a.nz, nct = a.N * a.nc;
  for (int o = lane; o < nzt; o += kWarp)
    a.z_out[(size_t)p * nzt + o] = s.z[o];
  for (int o = lane; o < nct; o += kWarp)
    a.c_out[(size_t)p * nct + o] = s.c[o];
}

__global__ void admm_epoch_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kProblemsPerBlock + warp;
  if (p >= a.P) return;  // whole warp leaves; the block never syncs
  const int N = a.N, nz = a.nz, nc = a.nc, mr = a.mr;
  const Smem s = carve(smem + warp * smem_floats(N, nz, nc, mr), N, nz, nc, mr);
  const Problem pb = problem_at(a, p);
  const int nw = N * mr;
  for (int o = lane; o < nw; o += kWarp) {
    s.w[o] = a.w0[(size_t)p * nw + o];
    s.y[o] = a.y0[(size_t)p * nw + o];
  }
  __syncwarp();
  float rp = 0.f, rd = 0.f;
  for (int it = 0; it < a.epoch_len; ++it) {
    rp = 0.f;  // residuals of the last iteration only
    rd = 0.f;
    backward_sweep<true>(pb, s, N, nz, nc, mr, lane);
    forward_sweep<true>(pb, s, N, nz, nc, mr, lane, a.alpha, rp, rd);
  }
  __syncwarp();
  store_zc(a, s, p, lane);
  for (int o = lane; o < nw; o += kWarp) {
    a.w_out[(size_t)p * nw + o] = s.w[o];
    a.y_out[(size_t)p * nw + o] = s.y[o];
  }
  if (lane < mr) {
    a.rp_out[(size_t)p * mr + lane] = rp;
    a.rd_out[(size_t)p * mr + lane] = rd;
  }
}

__global__ void affine_kernel(EpochArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kProblemsPerBlock + warp;
  if (p >= a.P) return;
  const int N = a.N, nz = a.nz, nc = a.nc;
  const Smem s = carve(smem + warp * smem_floats(N, nz, nc, 0), N, nz, nc, 0);
  const Problem pb = problem_at(a, p);
  float unused_rp = 0.f, unused_rd = 0.f;
  backward_sweep<false>(pb, s, N, nz, nc, 0, lane);
  forward_sweep<false>(pb, s, N, nz, nc, 0, lane, 0.f, unused_rp, unused_rd);
  __syncwarp();
  store_zc(a, s, p, lane);
}

// Launches the epoch kernel (epoch) or the affine kernel (!epoch): one warp
// per problem, kProblemsPerBlock problems per block.
int launch(bool epoch, const EpochArgs& a, void* stream) {
  if (a.P <= 0 || a.N <= 0 || a.nz <= 0 || a.nz > kWarp || a.nc <= 0 ||
      a.nc > kWarp || a.mr < 0 || a.mr > kWarp)
    return (int)cudaErrorInvalidValue;
  const void* fn = epoch ? (const void*)admm_epoch_kernel
                         : (const void*)affine_kernel;
  const size_t smem = sizeof(float) * kProblemsPerBlock *
                      (size_t)smem_floats(a.N, a.nz, a.nc, a.mr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.P + kProblemsPerBlock - 1) / kProblemsPerBlock);
  const dim3 block(kProblemsPerBlock * kWarp);
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
    float alpha, void* stream) {
  EpochArgs a = {F,     G,     d,     K,      Quu_inv, Qxu,    m,
                 q,     r,     D,     E,      lo,      hi,     rv,
                 fac_lo, fac_hi, z0,  w0,     y0,      z_out,  c_out,
                 w_out, y_out, rp_out, rd_out, P,      N,      nz,
                 nc,    mr,    epoch_len, alpha};
  if (mr <= 0 || epoch_len <= 0) return (int)cudaErrorInvalidValue;
  return launch(true, a, stream);
}

extern "C" int cmpc_lqr_affine(
    const float* F, const float* G, const float* d, const float* K,
    const float* Quu_inv, const float* Qxu, const float* m, const float* q,
    const float* r, const float* z0, float* z_out, float* c_out, int P, int N,
    int nz, int nc, void* stream) {
  EpochArgs a = {F,       G,       d,       K,       Quu_inv, Qxu,
                 m,       q,       r,       nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, z0,      nullptr,
                 nullptr, z_out,   c_out,   nullptr, nullptr, nullptr,
                 nullptr, P,       N,       nz,      nc,      0,
                 0,       0.f};
  return launch(false, a, stream);
}
