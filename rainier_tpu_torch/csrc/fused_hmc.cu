// Fused HMC sampling loop for Hopper (sm_90a): the hand-written
// counterpart of the Pallas TPU kernel rainier_tpu/ops/hmc_pallas.py::
// fused_hmc, with its resident-column, row-tiled, streamed-column and
// untiled branches (hmc_pallas.py:157-222, 280-381, 483-497).  See
// rainier_tpu_torch/ops/fused_hmc.py for the wrapper, the plain PyTorch
// version and the notes on what bounds this kernel.
//
// One thread owns one chain for the whole sampling phase.  For a model of
// up to 256 parameters and row-invariant values (emit_cuda.
// LOCAL_STATE_MAX) its position, momentum, gradient and proposal are
// per-thread arrays float[RT_DIM] in registers and local memory, and
// nothing touches device memory between the load of q0 and the final
// stores except the collected draws, written as
// samples[it / collect_every][j][chain] for the j-th collected
// coordinate so neighbouring threads write neighbouring addresses, and
// the data columns.  The model's density and gradient come from the
// generated rt_model.h (compute/emit_cuda.py),
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
// Streamed columns (stream_cols, the counterpart of hmc_pallas.py:186-191,
// 305-351, 484-486, 492-497).  Columns larger than the card's L2 are read
// from device memory again in every density call, so a launch may stream
// them: the shared memory holds two tile slots, each thread issues its
// share of tile t + 1's copies as cp.async into the other slot before it
// waits for tile t's, and the rows of tile t are computed while tile
// t + 1 is in flight.  Every thread commits one group per tile (an empty
// one after the last), the ragged edge's copies included, so that each
// thread's wait counts the same groups.  Both tile loops sum a tile's
// rows with one function, rt_tile_rows, reading the tile's slot, so a
// streamed launch gives the synchronous launch's results bit for bit.  The
// synchronous loop keeps its own form, and each kernel is compiled once
// for each flag (below): a loop shared by both flags, with the slot chosen
// per tile, made the synchronous kernel 13% slower on the 100k-row
// logistic regression, and both loops in one kernel 8% slower
// (rainier_tpu_torch/tools/kernel_ab.py tiles, H100).
//
// Row spaces and columns read whole (the untiled branch,
// hmc_pallas.py:282-291, 300-301, which evaluates the density over whole
// columns of any lengths).  The top-level RowSum likelihoods whose columns
// have one length form a row space; rt_density runs one tile loop per
// space, over the space's own rows, in its own tile (RtSpace<s>: kW floats
// a row, kTile rows), through the same two slots, sized for the widest
// space.  lp and the dense row-invariant adjoints are summed in f32 per
// tile and in f64 across the tiles of every space.  Every thread runs every
// space's loop, so the barriers and, when streaming, the copy groups of a
// thread stay those of every other.  A column that no row reads row by row
// (an MVNormal's Cholesky factor, a data vector dotted with a latent one)
// is read whole by the column-free and row-invariant functions, from its
// pointer in RtCols, at every call.
//
// Integer index columns.  The generated RtCols holds each column with its
// own type (int32 for an IntColumn), and the loader keeps an index's bits
// in its float slot of the tile.  A gather of a row-invariant vector by
// that index reads the chain's inv[] at a per-row offset, and its adjoint
// adds into the chain's ainv[] there.
//
// Larger models (the header defines RT_WS_FLOATS) keep every per-chain
// array in a workspace in device memory that the wrapper allocates: one
// slot of RT_WS_FLOATS floats per thread, the ragged edge's copies
// included, holding the seven state arrays and inv/ainv contiguously.
// The loops over the state and the emitted vector loops then run over
// memory, not unrolled registers.  A thread walks its own arrays in
// order, so one 128-byte line brought into L1 serves 32 elements; an
// interleaved layout, where a warp's 32 chains share each line, was
// slower on the card, since every element is then a line of its own and
// one warp per SM has few loads in flight.  What bounds the kernel is the
// latency of those passes (about 25 over arrays of RT_DIM floats per
// density call) and of the rows, with one warp on each SM: the wrapper
// launches blocks of fewer threads for such models, spreading the chains
// over every SM.
//
// Summation error.  Each tile's rows are summed in f32 (the error of a
// sequential sum of R terms is at most about R·u·Σ|terms|, u = 6e-8, and
// typically √R·u·Σ|terms|), and the tile totals of lp and of every
// row-invariant adjoint that all rows read (the first RT_NINV_DENSE of
// inv) are accumulated in f64, so the error does not grow with the
// number of tiles beyond a random walk of the per-tile errors.  For the
// 100k-row logistic regression (R = 256, ~0.3 nats a row) that is ~1e-4
// per tile and ~2e-3 nats in all, plus half an ulp (~2e-3) when the f64
// total is rounded to f32, against a per-chain f32 running sum's O(0.1).
// A model with its state in the workspace sums its rows in f64
// (rt_row_sum) and rounds lp once: at glmm_large's 50,000 rows and
// |lp| ~ 1e5, f32 tile sums and two roundings drift by a few ulps of lp.
// The register models keep f32 tile sums: f64 row sums made
// GLMMPoisson2's kernel 7% slower and the README regression's 2% on an
// H100 (rainier_tpu_torch/tools/kernel_ab.py row-sums).  The adjoint of
// a block that only a per-row gather reads accumulates in place in f32:
// each entry receives its own rows only (5 a group effect in glmm_large,
// 40 or 100 in GLMMPoisson2), and flushing every entry each tile would
// cost more than the rows.
//
// The same file compiles as host C++ (no __CUDACC__): rt_fused_hmc_host
// then runs every slot of the launch's blocks one after another through
// the same tile loop, with the "block" one thread, which is how the CPU
// tests check the loop, the ragged edge and the generated adjoints
// without a card.
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

#if RT_ROW_W > 0
#define RT_WS_NINV RT_NINV_ALLOC
#ifndef RT_NINV_DENSE
#define RT_NINV_DENSE RT_NINV
#define RT_NINV_DENSE_ALLOC RT_NINV_ALLOC
#endif
#else
#define RT_WS_NINV 0
#endif

// Row spaces.  A header with one row space names its row function and
// tile loaders rt_row, rt_fill_tile and rt_fill_tile_async; one with
// several defines RT_SPACES and an RtSpace<s> for each.  The tile loops
// read a space through RtSpace<s>: kW floats a row, kTile rows a tile.
#if RT_ROW_W > 0 && !defined(RT_SPACES)
#define RT_SPACES 1
template <int S>
struct RtSpace;
template <>
struct RtSpace<0> {
  enum { kW = RT_ROW_W, kTile = RT_TILE };
  static RT_HD float row(const float* x, const float* inv, float* ainv) {
    return rt_row(x, inv, ainv);
  }
  static RT_HD void fill(float* tile, const RtCols& cols, int row0, int rows,
                         int tid, int nt) {
    rt_fill_tile(tile, cols, row0, rows, tid, nt);
  }
  static RT_HD void fill_async(float* tile, const RtCols& cols, int row0,
                               int rows, int tid, int nt) {
    rt_fill_tile_async(tile, cols, row0, rows, tid, nt);
  }
};
#endif
#ifndef RT_SPACES
#define RT_SPACES 1
#endif

// the rows of each row space, as the launch gives them (null: none)
struct RtRows {
  int n[RT_SPACES];
};

static inline RtRows rt_rows(const int* n_rows) {
  RtRows out = {};
  for (int s = 0; s < RT_SPACES && n_rows != 0; ++s) out.n[s] = n_rows[s];
  return out;
}

// A density that reads columns whole, outside the rows (RT_WHOLE_COLS),
// takes them in its column-free and row-invariant functions too.
#ifdef RT_WHOLE_COLS
#define RT_WHOLE(cols) , cols
#else
#define RT_WHOLE(cols)
#endif

// A chain's arrays: per-thread arrays, fully unrolled loops over them; or
// arrays in the thread's slot of the workspace at offset `off`, loops
// unrolled by four.  RT_STATE(name, n, off) declares one.
#ifdef RT_WS_FLOATS
static_assert(RT_WS_FLOATS >= 7 * RT_DIM + 2 * RT_WS_NINV,
              "the workspace slot holds every per-chain array");
#define RT_UNROLL _Pragma("unroll 4")
#define RT_STATE(name, n, off) float* name = ws + (off)
typedef double rt_row_sum;
#else
#define RT_UNROLL _Pragma("unroll")
#define RT_STATE(name, n, off) float name[n]
typedef float rt_row_sum;
#endif
#define RT_OFF_X (6 * RT_DIM)
#define RT_OFF_INV (7 * RT_DIM)

// The loops over a chain's arrays take pointers that do not alias, so
// that over the workspace the loads of later elements may be issued
// before the stores of earlier ones.

// out = a * b
RT_HD void rt_mul(float* __restrict__ out, const float* __restrict__ a,
                  const float* __restrict__ b) {
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) out[d] = a[d] * b[d];
}

// g = b * g
RT_HD void rt_mul_in(float* __restrict__ g, const float* __restrict__ b) {
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) g[d] = b[d] * g[d];
}

// the first leapfrog step's kick and drift: p += h * g, qn = q + eps * p
RT_HD void rt_kick_drift(float* __restrict__ p, float* __restrict__ qn,
                         const float* __restrict__ q,
                         const float* __restrict__ g, float h, float eps) {
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    p[d] = p[d] + h * g[d];
    qn[d] = q[d] + eps * p[d];
  }
}

// a later step's: p += eps * gn, qn += eps * p
RT_HD void rt_kick_drift_in(float* __restrict__ p, float* __restrict__ qn,
                            const float* __restrict__ gn, float eps) {
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    p[d] = p[d] + eps * gn[d];
    qn[d] = qn[d] + eps * p[d];
  }
}

// the last half kick, p += h * gn; returns p·p
RT_HD float rt_kick_energy(float* __restrict__ p,
                           const float* __restrict__ gn, float h) {
  float k = 0.0f;
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    p[d] = p[d] + h * gn[d];
    k += p[d] * p[d];
  }
  return k;
}

// the accept: q = qn, g = gn
RT_HD void rt_take(float* __restrict__ q, float* __restrict__ g,
                   const float* __restrict__ qn,
                   const float* __restrict__ gn) {
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    q[d] = qn[d];
    g[d] = gn[d];
  }
}

// one draw of chain c of n into out[j * n + c]: for a model with its
// state in the workspace, the coordinates collect_pos names (all where it
// is null); otherwise every coordinate, which the wrapper slices (a load
// and a branch per coordinate here changed the code of the whole chain
// loop and slowed the row-tiled kernels on the card)
RT_HD void rt_collect(float* __restrict__ out, const float* __restrict__ q,
                      const float* __restrict__ sc,
                      const int* __restrict__ collect_pos, int n, int c) {
#ifdef RT_WS_FLOATS
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    const int j = collect_pos == 0 ? d : collect_pos[d];
    if (j >= 0) out[(size_t)j * n + c] = q[d] * sc[d];
  }
#else
  (void)collect_pos;
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) out[(size_t)d * n + c] = q[d] * sc[d];
#endif
}

#define RT_TILE_FLOATS (RT_TILE * RT_ROW_W)

#if RT_ROW_W > 0
// rows [row0, row0 + kTile) of space S's columns, cut at n_rows, as this
// thread's asynchronous copies into `slot`, committed as one group (an
// empty group past the last row)
template <int S>
RT_HD void rt_stream_tile(float* slot, const RtCols& cols, int row0,
                          int n_rows) {
  typedef RtSpace<S> Sp;
  if (row0 < n_rows)
    Sp::fill_async(slot, cols, row0,
                   n_rows - row0 < Sp::kTile ? n_rows - row0 : Sp::kTile,
                   RT_TID, RT_NTHREADS);
  rt_copy_commit();
}

// the rows of one tile of space S, read from `slot`, for this chain: lp
// and the dense row-invariant adjoints summed per tile (rt_row_sum) and
// added to the f64 totals.  Both tile loops, synchronous and streamed,
// sum their rows here, so the two give the same results bit for bit.
template <int S>
RT_HD void rt_tile_rows(const float* slot, int rows, const float* inv,
                        float* ainv, double& lp_acc, double* ainv_acc) {
  rt_row_sum lp_t = 0.0f;
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k) ainv[k] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < rows; ++r)
    lp_t += RtSpace<S>::row(slot + r * RtSpace<S>::kW, inv, ainv);
  lp_acc += (double)lp_t;
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k)
    ainv_acc[k] += (double)ainv[k];
}

// every tile of space S's n_rows rows, then of the spaces after it.
// `tile`: the block's shared memory, two slots of RT_TILE_FLOATS floats
// where `stream_cols` is set.  Each space's loops pass the same barriers
// in every thread, and a streamed loop commits one group a tile in every
// thread, so the waits of the next space count the same groups.
template <int S>
RT_HD void rt_space_rows(const RtCols& cols, const RtRows& rows,
                         int stream_cols, float* tile, const float* inv,
                         float* ainv, double& lp_acc, double* ainv_acc) {
  const int n_rows = rows.n[S], kTile = RtSpace<S>::kTile;
  if (stream_cols) {
    // tile t is in slot t & 1: tile 0 before the loop, then tile t + 1
    // into the other slot, whose last reader passed the barrier that
    // ended tile t - 1, before the wait for tile t's copies
    rt_stream_tile<S>(tile, cols, 0, n_rows);
    for (int t = 0, row0 = 0; row0 < n_rows; ++t, row0 += kTile) {
      rt_stream_tile<S>(tile + ((t + 1) & 1) * RT_TILE_FLOATS, cols,
                        row0 + kTile, n_rows);
      rt_copy_wait_prior1();
      RT_TILE_SYNC();
      rt_tile_rows<S>(tile + (t & 1) * RT_TILE_FLOATS,
                      n_rows - row0 < kTile ? n_rows - row0 : kTile, inv,
                      ainv, lp_acc, ainv_acc);
      RT_TILE_SYNC();
    }
  } else {
    for (int row0 = 0; row0 < n_rows; row0 += kTile) {
      const int n = n_rows - row0 < kTile ? n_rows - row0 : kTile;
      RtSpace<S>::fill(tile, cols, row0, n, RT_TID, RT_NTHREADS);
      RT_TILE_SYNC();
      rt_tile_rows<S>(tile, n, inv, ainv, lp_acc, ainv_acc);
      RT_TILE_SYNC();
    }
  }
  if constexpr (S + 1 < RT_SPACES)
    rt_space_rows<S + 1>(cols, rows, stream_cols, tile, inv, ainv, lp_acc,
                         ainv_acc);
}
#endif

// log-density and gradient at natural coordinates x for one chain: the
// column-free terms, then the row terms over every tile of each row
// space.  `tile`: the block's shared memory; `ws`: the thread's base in
// the workspace (unused for small models)
RT_HD float rt_density(const float* x, float* g, const RtCols& cols,
                       const RtRows& rows, int stream_cols, float* tile,
                       float* ws) {
  float lp = rt_logp_grad(x, g RT_WHOLE(cols));
#if RT_ROW_W > 0
  RT_STATE(inv, RT_NINV_ALLOC, RT_OFF_INV);
  RT_STATE(ainv, RT_NINV_ALLOC, RT_OFF_INV + RT_NINV_ALLOC);
  double ainv_acc[RT_NINV_DENSE_ALLOC];
  double lp_acc = 0.0;
  rt_rows_pre(x, inv RT_WHOLE(cols));
  // the gathered blocks' adjoints accumulate over every tile
  RT_UNROLL
  for (int k = RT_NINV_DENSE; k < RT_NINV; ++k) ainv[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k) ainv_acc[k] = 0.0;
  rt_space_rows<0>(cols, rows, stream_cols, tile, inv, ainv, lp_acc,
                   ainv_acc);
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k)
    ainv[k] = (float)ainv_acc[k];
  rt_rows_post(x, ainv, g RT_WHOLE(cols));
#ifdef RT_WS_FLOATS
  lp = (float)((double)lp + lp_acc);
#else
  lp += (float)lp_acc;
#endif
#else
  (void)cols, (void)rows, (void)stream_cols, (void)tile, (void)ws;
#endif
  return lp;
}

// density + gradient at standardized q: x = q * sc, grad = sc * dlogp/dx
RT_HD float rt_lp_grad(const float* q, const float* sc, float* g,
                       const RtCols& cols, const RtRows& rows,
                       int stream_cols, float* tile, float* ws) {
  RT_STATE(x, RT_DIM, RT_OFF_X);
  rt_mul(x, q, sc);
  const float lp = rt_density(x, g, cols, rows, stream_cols, tile, ws);
  rt_mul_in(g, sc);
  return lp;
}

// chain c of n; c >= n runs a copy of chain n - 1 and stores nothing.
// collect_pos (dim) is the slot of coordinate d among the n_collect
// collected ones, or -1; null collects every coordinate in order.
RT_HD void rt_hmc_chain(int c, int n, const float* q0, const float* scale,
                        int scale_per_chain, const float* eps_in,
                        const float* p_noise, const float* u_noise,
                        float* qf, float* samples, float* acc_out,
                        float* div_out, int n_iterations, int n_steps,
                        int collect_every, const int* collect_pos,
                        int n_collect, uint32_t seed, const RtCols& cols,
                        const RtRows& rows, int stream_cols, float* tile,
                        float* ws) {
  const bool live = c < n;
  if (!live) c = n - 1;
  RT_STATE(sc, RT_DIM, 0);
  RT_STATE(q, RT_DIM, RT_DIM);
  RT_STATE(g, RT_DIM, 2 * RT_DIM);
  RT_STATE(qn, RT_DIM, 3 * RT_DIM);
  RT_STATE(gn, RT_DIM, 4 * RT_DIM);
  RT_STATE(p, RT_DIM, 5 * RT_DIM);
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) {
    sc[d] = scale == 0
                      ? 1.0f
                      : scale[scale_per_chain ? (size_t)d * n + c : d];
    q[d] = q0[(size_t)d * n + c] / sc[d];
  }
  const float eps = eps_in[c];
  float lp = rt_lp_grad(q, sc, g, cols, rows, stream_cols, tile, ws);
  float acc = 0.0f, div = 0.0f;

  for (int it = 0; it < n_iterations; ++it) {
    // momentum refresh and the Metropolis uniform
    float u = 0.0f;
    if (p_noise != 0) {
      RT_UNROLL
      for (int d = 0; d < RT_DIM; ++d)
        p[d] = p_noise[((size_t)it * RT_DIM + d) * n + c];
      u = u_noise[(size_t)it * n + c];
    } else {
      // Philox words 4k..4k+3 of (it, k): words 2d and 2d + 1 make p[d],
      // word 2 * RT_DIM the uniform
      RT_UNROLL
      for (int k = 0; k < RT_GROUPS; ++k) {
        uint32_t w[4] = {(uint32_t)it, (uint32_t)k, 0u, 0u};
        rt_philox4x32_10(w, seed, (uint32_t)c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = 2 * k + j;
          if (d < RT_DIM)
            p[d] = rt_box_muller(rt_uniform_from_bits(w[2 * j]),
                                       rt_uniform_from_bits(w[2 * j + 1]));
          else if (d == RT_DIM)
            u = rt_uniform_from_bits(w[2 * j]);
        }
      }
    }
    float k0 = 0.0f;
    RT_UNROLL
    for (int d = 0; d < RT_DIM; ++d) k0 += p[d] * p[d];
    const float h0 = -lp + 0.5f * k0;

    // kick-drift-kick leapfrog, the order of hmc_pallas.py:395-408
    rt_kick_drift(p, qn, q, g, 0.5f * eps, eps);
    float lpn = rt_lp_grad(qn, sc, gn, cols, rows, stream_cols, tile, ws);
    for (int s = 1; s < n_steps; ++s) {
      rt_kick_drift_in(p, qn, gn, eps);
      lpn = rt_lp_grad(qn, sc, gn, cols, rows, stream_cols, tile, ws);
    }
    const float k1 = rt_kick_energy(p, gn, 0.5f * eps);
    const float h1 = -lpn + 0.5f * k1;

    // any non-finite energy rejects (sampler/leapfrog.py:63-76), not
    // only NaN as the TPU kernel does
    float la = fminf(-(h1 - h0), 0.0f);
    if (!(isfinite(h0) && isfinite(h1))) la = -INFINITY;
    if (logf(u) < la) {
      lp = lpn;
      rt_take(q, g, qn, gn);
    }
    acc += expf(la);
    div += isinf(la) ? 1.0f : 0.0f;

    if (live && collect_every > 0 &&
        it % collect_every == collect_every - 1)
      rt_collect(samples + (size_t)(it / collect_every) * n_collect * n, q,
                 sc, collect_pos, n, c);
  }
  if (!live) return;
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d)
    qf[(size_t)d * n + c] = q[d] * sc[d];
  acc_out[c] = acc / (float)n_iterations;
  div_out[c] = div;
}

// the check entry: lp and gradient at column c of q (dim, n), through
// the same density function and tile loop as the sampler
RT_HD void rt_logp_grad_chain(int c, int n, const float* q, float* lp,
                              float* g, const RtCols& cols,
                              const RtRows& rows, int stream_cols,
                              float* tile, float* ws) {
  const bool live = c < n;
  if (!live) c = n - 1;
  RT_STATE(x, RT_DIM, RT_OFF_X);
  RT_STATE(gx, RT_DIM, 2 * RT_DIM);
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) x[d] = q[(size_t)d * n + c];
  const float l = rt_density(x, gx, cols, rows, stream_cols, tile, ws);
  if (!live) return;
  lp[c] = l;
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d) g[(size_t)d * n + c] = gx[d];
}

// bytes of one tile slot of shared memory; a streamed launch takes two
#define RT_SMEM_BYTES (RT_TILE_FLOATS * (int)sizeof(float))

#ifdef __CUDACC__

// the thread's slot of the workspace
static __device__ __forceinline__ float* rt_slot(float* ws) {
#ifdef RT_WS_FLOATS
  return ws + ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * RT_WS_FLOATS;
#else
  return ws;
#endif
}

// Each kernel is instantiated once for each value of the streaming flag,
// a constant there, so that the other tile loop is compiled out (the note
// on streamed columns above says why); the launch picks one at run time.
template <int kStream>
__global__ void __launch_bounds__(128)
    fused_hmc_kernel(int n, const float* q0, const float* scale,
                     int scale_per_chain, const float* eps,
                     const float* p_noise, const float* u_noise, float* qf,
                     float* samples, float* acc, float* div,
                     int n_iterations, int n_steps, int collect_every,
                     const int* collect_pos, int n_collect, uint32_t seed,
                     RtCols cols, RtRows rows, float* ws) {
  extern __shared__ float tile[];
  rt_hmc_chain(blockIdx.x * blockDim.x + threadIdx.x, n, q0, scale,
               scale_per_chain, eps, p_noise, u_noise, qf, samples, acc, div,
               n_iterations, n_steps, collect_every, collect_pos, n_collect,
               seed, cols, rows, kStream, tile, rt_slot(ws));
}

template <int kStream>
__global__ void __launch_bounds__(128)
    logp_grad_kernel(int n, const float* q, float* lp, float* g,
                     RtCols cols, RtRows rows, float* ws) {
  extern __shared__ float tile[];
  rt_logp_grad_chain(blockIdx.x * blockDim.x + threadIdx.x, n, q, lp, g,
                     cols, rows, kStream, tile, rt_slot(ws));
}

// the instantiation for the flag `s` (a column-free model has one)
#if RT_ROW_W > 0
#define RT_PICK(kernel, s) ((s) ? kernel<1> : kernel<0>)
#else
#define RT_PICK(kernel, s) (kernel<0>)
#endif

// A block's shared memory: one tile slot, or two when streaming.  Above
// the 48 KB default it needs the opt-in attribute.
template <typename K>
static int rt_smem_opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Both launches go on `stream` and return cudaGetLastError(): a refused
// launch never runs, so the wrapper raises on any nonzero code.  `ws`
// holds RT_WS_FLOATS floats for each of blocks × threads slots (null for
// a model without a workspace).  `stream_cols` streams the column tiles
// through two slots of shared memory.
extern "C" int rt_fused_hmc_launch(int n, const float* q0,
                                   const float* scale, int scale_per_chain,
                                   const float* eps, const float* p_noise,
                                   const float* u_noise, float* qf,
                                   float* samples, float* acc, float* div,
                                   int n_iterations, int n_steps,
                                   int collect_every, const int* collect_pos,
                                   int n_collect, uint32_t seed,
                                   const void* const* cols,
                                   const int* n_rows, float* ws,
                                   int threads, int stream_cols,
                                   void* stream) {
  const auto kernel = RT_PICK(fused_hmc_kernel, stream_cols);
  const int smem = (stream_cols ? 2 : 1) * RT_SMEM_BYTES;
  const int rc = rt_smem_opt_in(kernel, smem);
  if (rc != 0) return rc;
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf, samples, acc,
      div, n_iterations, n_steps, collect_every, collect_pos, n_collect, seed,
      rt_cols(cols), rt_rows(n_rows), ws);
  return (int)cudaGetLastError();
}

extern "C" int rt_logp_grad_launch(int n, const float* q, float* lp,
                                   float* g, const void* const* cols,
                                   const int* n_rows, float* ws,
                                   int threads, int stream_cols,
                                   void* stream) {
  const auto kernel = RT_PICK(logp_grad_kernel, stream_cols);
  const int smem = (stream_cols ? 2 : 1) * RT_SMEM_BYTES;
  const int rc = rt_smem_opt_in(kernel, smem);
  if (rc != 0) return rc;
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      n, q, lp, g, rt_cols(cols), rt_rows(n_rows), ws);
  return (int)cudaGetLastError();
}

#else

#include <vector>

// The host entries run every slot of the launch's `threads`-thread blocks
// one after another, the ragged edge's copies included, each in its own
// slot of the workspace (blocks × threads slots, as on the card), with two
// tile slots for `stream_cols`.

// slot c of the workspace
static float* rt_slot(float* ws, int c) {
#ifdef RT_WS_FLOATS
  return ws + (size_t)c * RT_WS_FLOATS;
#else
  (void)c;
  return ws;
#endif
}

static int rt_slots(int n, int threads) {
  return (n + threads - 1) / threads * threads;
}

extern "C" int rt_fused_hmc_host(int n, const float* q0, const float* scale,
                                 int scale_per_chain, const float* eps,
                                 const float* p_noise, const float* u_noise,
                                 float* qf, float* samples, float* acc,
                                 float* div, int n_iterations, int n_steps,
                                 int collect_every, const int* collect_pos,
                                 int n_collect, uint32_t seed,
                                 const void* const* cols,
                                 const int* n_rows, float* ws, int threads,
                                 int stream_cols) {
  std::vector<float> tile(2 * RT_TILE_FLOATS + 1);
  const RtCols c_cols = rt_cols(cols);
  const RtRows rows = rt_rows(n_rows);
  for (int c = 0; c < rt_slots(n, threads); ++c)
    rt_hmc_chain(c, n, q0, scale, scale_per_chain, eps, p_noise, u_noise,
                 qf, samples, acc, div, n_iterations, n_steps, collect_every,
                 collect_pos, n_collect, seed, c_cols, rows, stream_cols,
                 tile.data(), rt_slot(ws, c));
  return 0;
}

extern "C" int rt_logp_grad_host(int n, const float* q, float* lp, float* g,
                                 const void* const* cols,
                                 const int* n_rows, float* ws, int threads,
                                 int stream_cols) {
  std::vector<float> tile(2 * RT_TILE_FLOATS + 1);
  const RtCols c_cols = rt_cols(cols);
  const RtRows rows = rt_rows(n_rows);
  for (int c = 0; c < rt_slots(n, threads); ++c)
    rt_logp_grad_chain(c, n, q, lp, g, c_cols, rows, stream_cols,
                       tile.data(), rt_slot(ws, c));
  return 0;
}

#endif
