// Fused HMC sampling loop for Hopper (sm_90a): the hand-written
// counterpart of the Pallas TPU kernel rainier_tpu/ops/hmc_pallas.py::
// fused_hmc.  See rainier_tpu_torch/ops/fused_hmc.py for the wrapper, the
// plain PyTorch version and the notes on what bounds this kernel.
//
// One thread owns one chain for the whole sampling phase.  Its position,
// momentum, gradient and proposal live in registers as float[RT_DIM];
// nothing touches device memory between the load of q0 and the final
// stores except the collected draws, written as
// samples[it / collect_every][d][chain] so neighbouring threads write
// neighbouring addresses.  The model's density and gradient come from the
// generated rt_model.h (compute/emit_cuda.py), evaluated in natural
// coordinates; the loop runs in standardized coordinates q' = q / sqrt(S)
// for the adapted mass diagonal S, exactly as hmc_pallas.py:224-240 does.
//
// The same file compiles as host C++ (no __CUDACC__): rt_fused_hmc_host
// then runs the chains one after another, which is how the CPU tests
// check the loop and the generated adjoints without a card.
#include "philox.cuh"
#include "rt_model.h"

#define RT_WORDS (2 * RT_DIM + 1)
#define RT_GROUPS ((RT_WORDS + 3) / 4)

// density + gradient at standardized q: x = q * sc, grad = sc * dlogp/dx
RT_HD float rt_lp_grad(const float* q, const float* sc, float* g) {
  float x[RT_DIM];
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) x[d] = q[d] * sc[d];
  const float lp = rt_logp_grad(x, g);
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) g[d] = sc[d] * g[d];
  return lp;
}

RT_HD void rt_hmc_chain(int c, int n, const float* q0, const float* scale,
                        int scale_per_chain, const float* eps_in,
                        const float* p_noise, const float* u_noise,
                        float* qf, float* samples, float* acc_out,
                        float* div_out, int n_iterations, int n_steps,
                        int collect_every, uint32_t seed) {
  float sc[RT_DIM], q[RT_DIM], g[RT_DIM], qn[RT_DIM], gn[RT_DIM],
      p[RT_DIM];
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) {
    sc[d] = scale == 0 ? 1.0f
                       : scale[scale_per_chain ? (size_t)d * n + c : d];
    q[d] = q0[(size_t)d * n + c] / sc[d];
  }
  const float eps = eps_in[c];
  float lp = rt_lp_grad(q, sc, g);
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
    float lpn = rt_lp_grad(qn, sc, gn);
    for (int s = 1; s < n_steps; ++s) {
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d) {
        p[d] = p[d] + eps * gn[d];
        qn[d] = qn[d] + eps * p[d];
      }
      lpn = rt_lp_grad(qn, sc, gn);
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

    if (collect_every > 0 && it % collect_every == collect_every - 1) {
      const size_t o = (size_t)(it / collect_every);
#pragma unroll
      for (int d = 0; d < RT_DIM; ++d)
        samples[(o * RT_DIM + d) * n + c] = q[d] * sc[d];
    }
  }
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d) qf[(size_t)d * n + c] = q[d] * sc[d];
  acc_out[c] = acc / (float)n_iterations;
  div_out[c] = div;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    fused_hmc_kernel(int n, const float* q0, const float* scale,
                     int scale_per_chain, const float* eps,
                     const float* p_noise, const float* u_noise, float* qf,
                     float* samples, float* acc, float* div,
                     int n_iterations, int n_steps, int collect_every,
                     uint32_t seed) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  rt_hmc_chain(c, n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf,
               samples, acc, div, n_iterations, n_steps, collect_every,
               seed);
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the wrapper raises on any nonzero code.
extern "C" int rt_fused_hmc_launch(int n, const float* q0,
                                   const float* scale, int scale_per_chain,
                                   const float* eps, const float* p_noise,
                                   const float* u_noise, float* qf,
                                   float* samples, float* acc, float* div,
                                   int n_iterations, int n_steps,
                                   int collect_every, uint32_t seed,
                                   int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  fused_hmc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf, samples, acc,
      div, n_iterations, n_steps, collect_every, seed);
  return (int)cudaGetLastError();
}

#else

extern "C" int rt_fused_hmc_host(int n, const float* q0, const float* scale,
                                 int scale_per_chain, const float* eps,
                                 const float* p_noise, const float* u_noise,
                                 float* qf, float* samples, float* acc,
                                 float* div, int n_iterations, int n_steps,
                                 int collect_every, uint32_t seed) {
  for (int c = 0; c < n; ++c)
    rt_hmc_chain(c, n, q0, scale, scale_per_chain, eps, p_noise, u_noise,
                 qf, samples, acc, div, n_iterations, n_steps, collect_every,
                 seed);
  return 0;
}

extern "C" float rt_logp_grad_host(const float* q, float* g) {
  return rt_logp_grad(q, g);
}

#endif
