// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out by hand for the fused HMC kernel.  It replaces
// the TPU's on-core PRNG (rainier_tpu/ops/hmc_pallas.py:64-79): counter
// based, so every chain draws its own stream from (seed, chain) with no
// state in device memory.  ops/fused_hmc.py reproduces the same bits in
// PyTorch (philox4x32 there), which lets the kernel and its plain version
// be compared trajectory by trajectory.
//
// Streams: key = (seed, chain); counter = (iteration, word group, 0, 0).
// Each call yields 4 words.  Iteration `it` of a chain with `dim`
// parameters uses words 2d, 2d+1 for the Box-Muller normal of
// coordinate d and word 2*dim for the Metropolis uniform.
#pragma once

#include "rt_math.cuh"

#define RT_PHILOX_M0 0xD2511F53u
#define RT_PHILOX_M1 0xCD9E8D57u
#define RT_PHILOX_W0 0x9E3779B9u
#define RT_PHILOX_W1 0xBB67AE85u

RT_HD uint32_t rt_mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * (uint64_t)b) >> 32);
#endif
}

RT_HD void rt_philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += RT_PHILOX_W0;
      k1 += RT_PHILOX_W1;
    }
    const uint32_t hi0 = rt_mulhi(RT_PHILOX_M0, c[0]);
    const uint32_t lo0 = RT_PHILOX_M0 * c[0];
    const uint32_t hi1 = rt_mulhi(RT_PHILOX_M1, c[2]);
    const uint32_t lo1 = RT_PHILOX_M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// uint32 -> f32 uniform in (0, 1): exponent forced to [1, 2), the
// hmc_pallas.py::_uniform_from_bits trick
RT_HD float rt_uniform_from_bits(uint32_t bits) {
  union {
    uint32_t u;
    float f;
  } v;
  v.u = (bits >> 9) | 0x3F800000u;
  return (v.f - 1.0f) + 1.1920929e-7f;
}

// Box-Muller, cosine branch only (hmc_pallas.py::_normals)
RT_HD float rt_box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2);
}
