// Fused HMC sampling loop for Hopper (sm_90a): the hand-written
// counterpart of the Pallas TPU kernel rainier_tpu/ops/hmc_pallas.py::
// fused_hmc, with its resident-column and row-tiled branches
// (hmc_pallas.py:157-222, 280, 302-381, 483-491).  See
// rainier_tpu_torch/ops/fused_hmc.py for the wrapper, the plain PyTorch
// version and the notes on what bounds this kernel.
//
// One thread owns one chain for the whole sampling phase.  Its position,
// momentum, gradient and proposal live in registers as float[RT_DIM];
// nothing touches device memory between the load of q0 and the final
// stores except the collected draws, written as
// samples[it / collect_every][d][chain] so neighbouring threads write
// neighbouring addresses, and the data columns.  The model's density and
// gradient come from the generated rt_model.h (compute/emit_cuda.py),
// evaluated in natural coordinates; the loop runs in standardized
// coordinates q' = q / sqrt(S) for the adapted mass diagonal S, exactly
// as hmc_pallas.py:224-240 does.
//
// Data columns.  A model with RowSum likelihoods adds, in every density
// call, the sum over all rows of the generated per-row function rt_row.
// The rows are walked in tiles of RT_TILE rows: the threads of a block
// copy a tile of every column into shared memory together (coalesced),
// pass a barrier, each accumulate the tile's rows for their own chain,
// and pass a second barrier before the next tile is loaded.  Fixed-step
// HMC gives every chain the same number of density calls (n_steps per
// iteration, plus one), so all threads of a block reach every barrier
// together; the accept branch holds no barrier and may diverge.  Threads
// past the last chain (the ragged edge of the last block) therefore do
// not return early: they run a copy of the last chain, load their share
// of every tile, pass every barrier, and store nothing.  All threads of a
// warp read the same row of the tile, a broadcast without bank
// conflicts.  Rows at or past n_rows are skipped, not padded.
//
// Integer index columns.  The generated RtCols holds each column with its
// own type (int32 for an IntColumn), and the loader keeps an index's bits
// in its float slot of the tile.  A gather of a row-invariant vector by
// that index reads the chain's inv[] at a per-row offset, and its adjoint
// adds into the chain's ainv[] there; with a dynamic index both arrays
// live in local memory (RT_NINV floats each, capped by the emitter).
//
// Summation error.  Each tile's rows are summed in f32 (the error of a
// sequential sum of R terms is at most about R·u·Σ|terms|, u = 6e-8, and
// typically √R·u·Σ|terms|), and the tile totals of lp and of every
// row-invariant adjoint are accumulated in f64, so the error does not
// grow with the number of tiles beyond a random walk of the per-tile
// errors.  For the 100k-row logistic regression (R = 256, ~0.3 nats a
// row) that is ~1e-4 per tile and ~2e-3 nats in all, plus half an ulp
// (~2e-3) when the f64 total is rounded to f32, against a per-chain f32
// running sum's O(0.1).
//
// The same file compiles as host C++ (no __CUDACC__): rt_fused_hmc_host
// then runs the chains one after another through the same tile loop, with
// the "block" one thread, which is how the CPU tests check the loop and
// the generated adjoints without a card.
#include "philox.cuh"
#include "rt_model.h"

#define RT_WORDS (2 * RT_DIM + 1)
#define RT_GROUPS ((RT_WORDS + 3) / 4)

// the block's threads in device code; one thread in host code (and in
// nvcc's host pass over the __host__ __device__ functions)
#ifdef __CUDA_ARCH__
#define RT_TILE_SYNC() __syncthreads()
#define RT_TID ((int)threadIdx.x)
#define RT_NTHREADS ((int)blockDim.x)
#else
#define RT_TILE_SYNC()
#define RT_TID 0
#define RT_NTHREADS 1
#endif

// log-density and gradient at natural coordinates x for one chain: the
// column-free terms, then the row terms over every tile of the columns
RT_HD float rt_density(const float* x, float* g, const RtCols& cols,
                       int n_rows, float* tile) {
  float lp = rt_logp_grad(x, g);
#if RT_ROW_W > 0
  float inv[RT_NINV_ALLOC], ainv[RT_NINV_ALLOC];
  double ainv_acc[RT_NINV_ALLOC];
  double lp_acc = 0.0;
  rt_rows_pre(x, inv);
#pragma unroll
  for (int k = 0; k < RT_NINV_ALLOC; ++k) ainv_acc[k] = 0.0;
  for (int row0 = 0; row0 < n_rows; row0 += RT_TILE) {
    const int rows = n_rows - row0 < RT_TILE ? n_rows - row0 : RT_TILE;
    rt_fill_tile(tile, cols, row0, rows, RT_TID, RT_NTHREADS);
    RT_TILE_SYNC();
    float lp_t = 0.0f;
#pragma unroll
    for (int k = 0; k < RT_NINV_ALLOC; ++k) ainv[k] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r)
      lp_t += rt_row(tile + r * RT_ROW_W, inv, ainv);
    lp_acc += (double)lp_t;
#pragma unroll
    for (int k = 0; k < RT_NINV_ALLOC; ++k) ainv_acc[k] += (double)ainv[k];
    RT_TILE_SYNC();
  }
#pragma unroll
  for (int k = 0; k < RT_NINV_ALLOC; ++k) ainv[k] = (float)ainv_acc[k];
  rt_rows_post(x, ainv, g);
  lp += (float)lp_acc;
#endif
  return lp;
}

// density + gradient at standardized q: x = q * sc, grad = sc * dlogp/dx
RT_HD float rt_lp_grad(const float* q, const float* sc, float* g,
                       const RtCols& cols, int n_rows, float* tile) {
  float x[RT_DIM];
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) x[d] = q[d] * sc[d];
  const float lp = rt_density(x, g, cols, n_rows, tile);
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) g[d] = sc[d] * g[d];
  return lp;
}

// chain c of n; c >= n runs a copy of chain n - 1 and stores nothing
RT_HD void rt_hmc_chain(int c, int n, const float* q0, const float* scale,
                        int scale_per_chain, const float* eps_in,
                        const float* p_noise, const float* u_noise,
                        float* qf, float* samples, float* acc_out,
                        float* div_out, int n_iterations, int n_steps,
                        int collect_every, uint32_t seed, const RtCols& cols,
                        int n_rows, float* tile) {
  const bool live = c < n;
  if (!live) c = n - 1;
  float sc[RT_DIM], q[RT_DIM], g[RT_DIM], qn[RT_DIM], gn[RT_DIM],
      p[RT_DIM];
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) {
    sc[d] = scale == 0 ? 1.0f
                       : scale[scale_per_chain ? (size_t)d * n + c : d];
    q[d] = q0[(size_t)d * n + c] / sc[d];
  }
  const float eps = eps_in[c];
  float lp = rt_lp_grad(q, sc, g, cols, n_rows, tile);
  float acc = 0.0f, div = 0.0f;

  for (int it = 0; it < n_iterations; ++it) {
    // momentum refresh and the Metropolis uniform
    float u;
    if (p_noise != 0) {
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d)
        p[d] = p_noise[((size_t)it * RT_DIM + d) * n + c];
      u = u_noise[(size_t)it * n + c];
    } else {
      uint32_t w[4 * RT_GROUPS];
#pragma unroll
      for (int k = 0; k < RT_GROUPS; ++k) {
        uint32_t ctr[4] = {(uint32_t)it, (uint32_t)k, 0u, 0u};
        rt_philox4x32_10(ctr, seed, (uint32_t)c);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[4 * k + j] = ctr[j];
      }
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d)
        p[d] = rt_box_muller(rt_uniform_from_bits(w[2 * d]),
                             rt_uniform_from_bits(w[2 * d + 1]));
      u = rt_uniform_from_bits(w[2 * RT_DIM]);
    }
    float k0 = 0.0f;
#pragma unroll
    for (int d = 0; d < RT_DIM; ++d) k0 += p[d] * p[d];
    const float h0 = -lp + 0.5f * k0;

    // kick-drift-kick leapfrog, the order of hmc_pallas.py:395-408
#pragma unroll
    for (int d = 0; d < RT_DIM; ++d) {
      p[d] = p[d] + 0.5f * eps * g[d];
      qn[d] = q[d] + eps * p[d];
    }
    float lpn = rt_lp_grad(qn, sc, gn, cols, n_rows, tile);
    for (int s = 1; s < n_steps; ++s) {
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d) {
        p[d] = p[d] + eps * gn[d];
        qn[d] = qn[d] + eps * p[d];
      }
      lpn = rt_lp_grad(qn, sc, gn, cols, n_rows, tile);
    }
    float k1 = 0.0f;
#pragma unroll
    for (int d = 0; d < RT_DIM; ++d) {
      p[d] = p[d] + 0.5f * eps * gn[d];
      k1 += p[d] * p[d];
    }
    const float h1 = -lpn + 0.5f * k1;

    // any non-finite energy rejects (sampler/leapfrog.py:63-76), not
    // only NaN as the TPU kernel does
    float la = fminf(-(h1 - h0), 0.0f);
    if (!(isfinite(h0) && isfinite(h1))) la = -INFINITY;
    if (logf(u) < la) {
      lp = lpn;
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d) {
        q[d] = qn[d];
        g[d] = gn[d];
      }
    }
    acc += expf(la);
    div += isinf(la) ? 1.0f : 0.0f;

    if (live && collect_every > 0 &&
        it % collect_every == collect_every - 1) {
      const size_t o = (size_t)(it / collect_every);
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d)
        samples[(o * RT_DIM + d) * n + c] = q[d] * sc[d];
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) qf[(size_t)d * n + c] = q[d] * sc[d];
  acc_out[c] = acc / (float)n_iterations;
  div_out[c] = div;
}

// the check entry: lp and gradient at column c of q (dim, n), through
// the same density function and tile loop as the sampler
RT_HD void rt_logp_grad_chain(int c, int n, const float* q, float* lp,
                              float* g, const RtCols& cols, int n_rows,
                              float* tile) {
  const bool live = c < n;
  if (!live) c = n - 1;
  float x[RT_DIM], gx[RT_DIM];
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) x[d] = q[(size_t)d * n + c];
  const float l = rt_density(x, gx, cols, n_rows, tile);
  if (!live) return;
  lp[c] = l;
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) g[(size_t)d * n + c] = gx[d];
}

#define RT_SMEM_BYTES (RT_ROW_W * RT_TILE * (int)sizeof(float))

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    fused_hmc_kernel(int n, const float* q0, const float* scale,
                     int scale_per_chain, const float* eps,
                     const float* p_noise, const float* u_noise, float* qf,
                     float* samples, float* acc, float* div,
                     int n_iterations, int n_steps, int collect_every,
                     uint32_t seed, RtCols cols, int n_rows) {
  extern __shared__ float tile[];
  rt_hmc_chain(blockIdx.x * blockDim.x + threadIdx.x, n, q0, scale,
               scale_per_chain, eps, p_noise, u_noise, qf, samples, acc, div,
               n_iterations, n_steps, collect_every, seed, cols, n_rows,
               tile);
}

__global__ void __launch_bounds__(128)
    logp_grad_kernel(int n, const float* q, float* lp, float* g,
                     RtCols cols, int n_rows) {
  extern __shared__ float tile[];
  rt_logp_grad_chain(blockIdx.x * blockDim.x + threadIdx.x, n, q, lp, g,
                     cols, n_rows, tile);
}

// A tile above the 48 KB default needs the opt-in attribute
template <typename K>
static int rt_smem_opt_in(K kernel) {
  if (RT_SMEM_BYTES <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RT_SMEM_BYTES);
}

// Both launches go on `stream` and return cudaGetLastError(): a refused
// launch never runs, so the wrapper raises on any nonzero code.
extern "C" int rt_fused_hmc_launch(int n, const float* q0,
                                   const float* scale, int scale_per_chain,
                                   const float* eps, const float* p_noise,
                                   const float* u_noise, float* qf,
                                   float* samples, float* acc, float* div,
                                   int n_iterations, int n_steps,
                                   int collect_every, uint32_t seed,
                                   const void* const* cols, int n_rows,
                                   int threads, void* stream) {
  const int rc = rt_smem_opt_in(fused_hmc_kernel);
  if (rc != 0) return rc;
  const int blocks = (n + threads - 1) / threads;
  fused_hmc_kernel<<<blocks, threads, RT_SMEM_BYTES, (cudaStream_t)stream>>>(
      n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf, samples, acc,
      div, n_iterations, n_steps, collect_every, seed, rt_cols(cols), n_rows);
  return (int)cudaGetLastError();
}

extern "C" int rt_logp_grad_launch(int n, const float* q, float* lp,
                                   float* g, const void* const* cols,
                                   int n_rows, int threads, void* stream) {
  const int rc = rt_smem_opt_in(logp_grad_kernel);
  if (rc != 0) return rc;
  const int blocks = (n + threads - 1) / threads;
  logp_grad_kernel<<<blocks, threads, RT_SMEM_BYTES, (cudaStream_t)stream>>>(
      n, q, lp, g, rt_cols(cols), n_rows);
  return (int)cudaGetLastError();
}

#else

#include <vector>

extern "C" int rt_fused_hmc_host(int n, const float* q0, const float* scale,
                                 int scale_per_chain, const float* eps,
                                 const float* p_noise, const float* u_noise,
                                 float* qf, float* samples, float* acc,
                                 float* div, int n_iterations, int n_steps,
                                 int collect_every, uint32_t seed,
                                 const void* const* cols, int n_rows) {
  std::vector<float> tile(RT_ROW_W * RT_TILE + 1);
  const RtCols c_cols = rt_cols(cols);
  for (int c = 0; c < n; ++c)
    rt_hmc_chain(c, n, q0, scale, scale_per_chain, eps, p_noise, u_noise,
                 qf, samples, acc, div, n_iterations, n_steps, collect_every,
                 seed, c_cols, n_rows, tile.data());
  return 0;
}

extern "C" int rt_logp_grad_host(int n, const float* q, float* lp, float* g,
                                 const void* const* cols, int n_rows) {
  std::vector<float> tile(RT_ROW_W * RT_TILE + 1);
  const RtCols c_cols = rt_cols(cols);
  for (int c = 0; c < n; ++c)
    rt_logp_grad_chain(c, n, q, lp, g, c_cols, n_rows, tile.data());
  return 0;
}

#endif
