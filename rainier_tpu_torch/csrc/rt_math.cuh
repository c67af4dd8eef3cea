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

// e / s for a LogSumExp's shifted exponential e = exp(x - max), in [0, 1]
// or NaN, and the sum s of its terms' (at least 1 where the max is
// finite, else NaN), with the bits of the IEEE f32 division.  On the card
// the f32 division takes its slow path, a call that the whole warp waits
// for, whenever a lane's e is tiny (a term far below the max, as in most
// rows of a mixture whose components lie apart): the marginalized
// mixture's kernel took 767.5 ms so and 159.1 ms with this form (H100,
// PERF.md §6).  This form has no branch: a reciprocal from rcp.approx,
// two Newton steps, the quotient and one correction, all in f64, rounded
// to f32 once.  The exact quotient of two floats lies at least 2^-50 of
// itself from any f32 rounding boundary, and the f64 one within 2^-60 of
// it, so the rounding gives the correctly rounded f32 quotient; a NaN e
// or s gives NaN.  Host code divides.
RT_HD float rt_lse_share(float e, float s) {
#ifdef __CUDA_ARCH__
  const double sd = s, ed = e;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(sd));
  r = fma(r, fma(-sd, r, 1.0), r);
  r = fma(r, fma(-sd, r, 1.0), r);
  const double q = ed * r;
  return (float)fma(r, fma(-sd, q, ed), q);
#else
  return e / s;
#endif
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

// Asynchronous 4-byte copies from device memory into shared memory, for
// streamed row tiles: cp.async on the card (each thread's copies since its
// last commit form one group; a thread waits for its own groups, and a
// barrier then shows every thread's copies to the block), a plain copy in
// host code, where commit and wait do nothing.  The bytes are copied as
// they are, so an int32 index keeps its bits in its float slot.
RT_HD void rt_copy_async(float* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, sizeof(float));
#endif
}

RT_HD void rt_copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most the newest group of this thread's copies is in flight
RT_HD void rt_copy_wait_prior1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// wait until every group of this thread's copies has landed
RT_HD void rt_copy_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Lanes.  A chain with rows runs on the RT_LANES = 32 lanes of one warp
// (the kernel defines RT_LANES, or a workspace model's header does: 1 to
// 32 for a model without rows, whose chain is one thread or an aligned
// group of a warp's lanes): each lane takes every 32nd row of a tile,
// and in a workspace model every RT_LANES-th element of each pass over
// the chain's arrays (RT_LANE, RT_LSTEP).  The lanes'
// partial sums meet in an xor butterfly: each stage adds a pair of
// values in both of its lanes, and f32 addition commutes, so every lane
// ends with the same bits.  Host code is one lane that walks every
// element (RT_LANE 0, RT_LSTEP 1) and keeps each lane's partial sum in an
// array, added up in the butterfly's order (rt_lane_tree), so the host
// build sums in the card's order.  The macros expand where they are
// used, after RT_LANES is defined.
#ifdef __CUDA_ARCH__
#define RT_LANE ((int)threadIdx.x % RT_LANES)
#define RT_LSTEP RT_LANES
#define RT_WARP_SYNC()                 \
  do {                                 \
    if (RT_LANES > 1) __syncwarp();    \
  } while (0)
// a lane's partial sum `name` of values v of elements i, then the sum
// over the lanes in every lane; element j's value, broadcast from its lane
#define RT_PART(T, name) T name = 0
#define RT_ADD(name, i, v) name += (v)
#define RT_SUM(name) name = rt_warp_sum<RT_LANES>(name)
#define RT_BCAST(name, j) name = rt_lane_bcast<RT_LANES>(name, (j) % RT_LANES)
#else
#define RT_LANE 0
#define RT_LSTEP 1
#define RT_WARP_SYNC() \
  do {                 \
  } while (0)
#define RT_PART(T, name) \
  T name##_l[RT_LANES] = {}; \
  T name = 0
#define RT_ADD(name, i, v) name##_l[(i) % RT_LANES] += (v)
#define RT_SUM(name) name = rt_lane_tree<RT_LANES>(name##_l)
#define RT_BCAST(name, j) (void)(j)
#endif

// the sum of L lanes' values v[0, L) in the butterfly's order (v is
// overwritten): after the stage of offset o, v[l] for l < o holds what
// lane l holds on the card
template <int L, typename T>
RT_HD T rt_lane_tree(T* v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int l = 0; l < o; ++l) v[l] = v[l] + v[l + o];
  }
  return v[0];
}

// x summed over an aligned group of L lanes of a warp (xor offsets below
// L stay inside it), the same bits in every lane (host code: x)
template <int L, typename T>
RT_HD T rt_warp_sum(T x) {
#ifdef __CUDA_ARCH__
  if constexpr (L > 1) {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      x = x + __shfl_xor_sync(0xffffffffu, x, o);
  }
#endif
  return x;
}

// lane src's x in every lane of the aligned group of L lanes, src
// counted within the group (host code: x)
template <int L, typename T>
RT_HD T rt_lane_bcast(T x, int src) {
#ifdef __CUDA_ARCH__
  if constexpr (L > 1) return __shfl_sync(0xffffffffu, x, src, L);
#endif
  (void)src;
  return x;
}

// The f64 adjoint sums, by source entry, of a gather by an index column
// read whole, in a loop split over the lanes (compute/emit_cuda.py,
// _gather_sums): each lane adds its elements' adjoints into sums of its
// own, and the lanes' sums of an entry meet in the butterfly's order, so
// the result has fixed bits without atomics.  RT_EPART(name, k) declares
// a lane's k sums, a per-thread array (in local memory, L1-cached: a
// select over the k entries that would keep them in registers gave its
// last entry every element's adjoint on an H100, PERF.md §6);
// RT_EADD(name, k, i, j, v) adds element i's v at entry j; RT_ESUM(name,
// k) leaves every entry's sum over the lanes in name[e] of every lane.
// Host code keeps each lane's sums apart (lane i mod RT_LANES) and adds
// them in the butterfly's order.  RT_EADD_SLOT(name, i, j, v) adds to the
// lanes' copies in the chain's slot, entry e of lane l at e·RT_LANES + l,
// which the flush sums by rt_lane_tree.
#ifdef __CUDA_ARCH__
#define RT_EPART(name, k) \
  double name[k];         \
  _Pragma("unroll") for (int e_ = 0; e_ < (k); ++e_) name[e_] = 0.0
#define RT_EADD(name, k, i, j, v) name[j] += (v)
#define RT_ESUM(name, k)                              \
  _Pragma("unroll") for (int e_ = 0; e_ < (k); ++e_) \
    name[e_] = rt_warp_sum<RT_LANES>(name[e_])
#define RT_EADD_SLOT(name, i, j, v) name[(j) * RT_LANES + RT_LANE] += (v)
#else
#define RT_EPART(name, k) \
  double name[k] = {};    \
  double name##_l[RT_LANES][k] = {}
#define RT_EADD(name, k, i, j, v) name##_l[(i) % RT_LANES][j] += (v)
#define RT_ESUM(name, k)                        \
  for (int e_ = 0; e_ < (k); ++e_) {            \
    double v_[RT_LANES];                        \
    for (int l_ = 0; l_ < RT_LANES; ++l_)       \
      v_[l_] = name##_l[l_][e_];                \
    name[e_] = rt_lane_tree<RT_LANES>(v_);      \
  }
#define RT_EADD_SLOT(name, i, j, v) \
  name[(j) * RT_LANES + (i) % RT_LANES] += (v)
#endif

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
