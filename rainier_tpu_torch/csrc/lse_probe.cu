// A check, not a kernel of the sampler: the two shares of a LogSumExp of
// two terms as the emitted rows compute them on the card
// (rt_lse_pair_share over rt_recip, csrc/rt_math.cuh), against the IEEE
// f32 quotients __fdiv_rn(e, s) and __fdiv_rn(1, s), s = 1 + e in f32, for
// every f32 e in [0, 1], denormals included: 1,065,353,217 values, a thread
// each in a grid-stride loop.  The f64 form (rt_lse_share) is counted
// beside them as a control.  tools/kernel_ab.py lse-probe builds and runs
// it (nvcc, a plain C interface), and chip_smoke.py's phase "LogSumExp
// pair shares" holds its counts.
//
// out[0..2]: how many e give other bits than the quotient, for e / s, 1 / s
// and the f64 form's e / s; out[3..5] the least such e's bits, out[6..8]
// the most (0xffffffff and 0 where none differs).
#include "rt_math.cuh"

#define RT_PROBE_TOP 0x3f800000u

__device__ __forceinline__ void rt_probe_count(unsigned* out, int k, bool bad,
                                               unsigned bits) {
  if (!bad) return;
  atomicAdd(out + k, 1u);
  atomicMin(out + 3 + k, bits);
  atomicMax(out + 6 + k, bits);
}

__global__ void rt_lse_probe_kernel(unsigned* out) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= RT_PROBE_TOP;
       b += stride) {
    const float e = __uint_as_float(b);
    const float s = 1.0f + e;
    const float r = rt_recip(s);
    const float other = rt_lse_pair_share(e, s, r);
    const float top = rt_lse_pair_share(1.0f, s, r);
    rt_probe_count(out, 0,
                   __float_as_uint(other) != __float_as_uint(__fdiv_rn(e, s)),
                   b);
    rt_probe_count(out, 1,
                   __float_as_uint(top) != __float_as_uint(__fdiv_rn(1.0f, s)),
                   b);
    rt_probe_count(out, 2,
                   __float_as_uint(rt_lse_share(e, s)) !=
                       __float_as_uint(__fdiv_rn(e, s)),
                   b);
  }
}

// `out`: 9 unsigned ints on the card, which this sets before the kernel
// runs on `stream`; returns cudaGetLastError()
extern "C" int rt_lse_probe_launch(unsigned* out, void* stream) {
  const unsigned init[9] = {0u, 0u, 0u, 0xffffffffu, 0xffffffffu,
                            0xffffffffu, 0u, 0u, 0u};
  cudaMemcpyAsync(out, init, sizeof init, cudaMemcpyHostToDevice,
                  (cudaStream_t)stream);
  rt_lse_probe_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
