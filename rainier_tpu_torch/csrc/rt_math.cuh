// Scalar math helpers shared by the generated density (rt_model.h) and the
// fused HMC kernel.  Host and device compile the same code: RT_HD expands
// to __host__ __device__ under nvcc and to `inline` under a host C++
// compiler, which is how the CPU tests check the generated adjoints.
//
// Every helper follows the derivative convention of jax.grad, which is the
// reference the port is held against (rainier_tpu/compute/interp.py).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef RT_HD
#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif
#endif

// sign with sign(0) = 0 (the Compare node)
RT_HD float rt_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// logistic without overflow on either side
RT_HD float rt_sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  float e = expf(x);
  return e / (1.0f + e);
}

// softplus = logaddexp(x, 0), the form jax.nn.softplus uses
RT_HD float rt_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// float index -> int32 by truncation toward zero (jnp astype(int32));
// NaN maps to 0 and out-of-range values saturate, as the device
// conversion does
RT_HD int rt_f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483520.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return (int)x;
}

// an int32 index carried bit for bit in a float slot of the row tile, so
// every int32 value is exact (an index never passes through a float
// conversion)
RT_HD float rt_int_bits(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
#endif
}

RT_HD int rt_bits_int(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
#endif
}

// i clamped to [lo, hi]: the gather's mode="clip"
RT_HD int rt_clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// digamma, the derivative of lgamma (CUDA has no device digamma):
// reflection for x < 0, recurrence up to x >= 6, then the asymptotic
// series ln x - 1/(2x) - sum B_2k / (2k x^2k) through x^-10
RT_HD float rt_digamma(float x) {
  const float pi = 3.14159265358979f;
  if (x <= 0.0f && floorf(x) == x) return NAN;
  float r = 0.0f;
  if (x < 0.0f) {
    r = -pi / tanf(pi * x);
    x = 1.0f - x;
  }
  while (x < 6.0f) {
    r -= 1.0f / x;
    x += 1.0f;
  }
  float f = 1.0f / (x * x);
  float t = f * (-1.0f / 12.0f +
            f * (1.0f / 120.0f +
            f * (-1.0f / 252.0f +
            f * (1.0f / 240.0f +
            f * (-1.0f / 132.0f)))));
  return r + logf(x) - 0.5f / x + t;
}
