// Fused HMC sampling loop for Hopper (sm_90a): the hand-written
// counterpart of the Pallas TPU kernel rainier_tpu/ops/hmc_pallas.py::
// fused_hmc, with its resident-column, row-tiled, streamed-column and
// untiled branches (hmc_pallas.py:157-222, 280-381, 483-497).  See
// rainier_tpu_torch/ops/fused_hmc.py for the wrapper, the plain PyTorch
// version and the notes on what bounds this kernel.
//
// Chains and lanes.  A model with rows runs each chain on one warp, its
// RT_LANES = 32 lanes, and a block holds W chains, one warp each (the
// wrapper's threads_per_block sets W).  A model without rows runs each
// chain on RT_LANES = L lanes, an aligned group of a warp's lanes, 32 / L
// chains a warp (below, "Chains without rows").  The model's
// density and gradient come from the generated rt_model.h
// (compute/emit_cuda.py), evaluated in natural coordinates; the loop runs
// in standardized coordinates q' = q / sqrt(S) for the adapted mass
// diagonal S, exactly as hmc_pallas.py:224-240 does.
//
// A model of up to 32 parameters and row-invariant values (emit_cuda.
// LANE_STATE_MAX: the README regression and the logistics) keeps its
// chain's position, momentum, gradient and proposal in per-thread arrays
// float[RT_DIM] in registers and local memory, and every lane holds all
// of them (past it, a slot: below): whatever lies
// outside the rows (the column-free terms, the row-invariant passes
// rt_rows_pre and rt_rows_post, the leapfrog and the accept) runs
// redundantly in every lane, with no broadcast.  The lanes split the
// rows and, where there are several, the Philox groups (rt_lane_momenta).
// The design rests on one invariant: every value that decides control
// flow (lp, lpn, k0, k1, u and the accept) has the same bits in the lanes
// of a chain, so the lanes never part, and every shuffle and barrier is
// reached by all of them.  Each stored element is stored by one lane
// (rt_mine: element d by lane d mod RT_LANES), the scalars by lane 0;
// nothing
// touches device memory between the load of q0 and the final stores
// except the collected draws, samples[it / collect_every][j][chain] for
// the j-th collected coordinate, and the data columns.
//
// Data columns.  A model with RowSum likelihoods adds, in every density
// call, the sum over all rows of the generated per-row function rt_row.
// The rows are walked in tiles of RT_TILE rows, as many as two tiles of
// the row's floats fit in a block's shared memory, up to 4096
// (emit_cuda.tile_rows): a tile's copies, barriers and waits cost the same
// however few rows it holds.  The W x 32 threads of a block copy a tile of
// every column into shared memory together (coalesced; the tile loader,
// emitted, takes a batch of rows a thread and issues every load before any
// store), pass a barrier, and every chain of the block reads that one
// tile: lane l takes the tile's rows l, l + 32, l + 64, ..., summing its
// rows' lp and dense row-invariant adjoints in f32 and adding those sums
// to f64 sums of its own once a tile.  A row of many operations and few
// floats is summed several rows a step (RtSpace<s>::kStep, the emitted
// rt_row_step): the steps' rows' forward passes are one block of
// straight-line code, so that their dependent chains overlap, and their
// reverse passes add the adjoints in row order, so the bits are those of
// one row at a time.  At the end of the density call an xor butterfly
// (five __shfl_xor_sync stages, rt_acc_sums) adds the lanes' f64 sums
// (a resident register model: one reduce-scatter of them all, with the
// same bits).  Each stage adds a pair of values in both of its lanes,
// and addition commutes, so every lane ends with the same bits.  A
// second barrier ends the tile.
// Fixed-step
// HMC gives every chain the same number of density calls (n_steps per
// iteration, plus one), so all warps of a block reach every barrier
// together; the accept branch holds no barrier.  Warps past the last
// chain (the ragged edge of the last block) therefore do not return
// early: they run a copy of the last chain, load their share of every
// tile, pass every barrier, and store nothing.  Rows at or past n_rows
// are skipped, not padded.  A tile is row-major, kW floats a row
// (RtSpace<s>), so lane l reads shared-memory word l·kW + f: no bank
// conflicts for an odd kW (the logistic's 11), 2-way for glmm_large's 2,
// 4-way for the README regression's and GLMMPoisson2's 4 (the stride is
// not padded: what padding would save is not measured).
//
// Streamed columns (stream_cols, the counterpart of hmc_pallas.py:186-191,
// 305-351, 484-486, 492-497).  A launch may stream its tiles: the shared
// memory holds two tile slots, each thread issues its share of tile
// t + 1's copies as cp.async into the other slot before it waits for tile
// t's, and the rows of tile t are computed while tile t + 1 is in flight.
// The wrapper streams every launch of a model with rows unless told not
// to: on the H100 the streamed loop beat the synchronous one on every such
// model, its columns inside L2 or past it (ops/fused_hmc.py, streams).
// Every thread commits one group per tile (an empty
// one after the last), the ragged edge's copies included, so that each
// thread's wait counts the same groups.  Both tile loops sum a tile's
// rows with one function, rt_tile_rows, through the same lanes, so a
// streamed launch gives the synchronous launch's results bit for bit.  The
// synchronous loop keeps its own form, and each kernel is compiled once
// for each flag (below): a loop shared by both flags, with the slot chosen
// per tile, made the synchronous kernel 13% slower on the 100k-row
// logistic regression, and both loops in one kernel 8% slower
// (rainier_tpu_torch/tools/kernel_ab.py tiles, H100, one thread a chain).
// A block of W chains reads each tile once for all of them, so W divides
// the bytes a streamed density call moves through L2.
//
// Row spaces and columns read whole (the untiled branch,
// hmc_pallas.py:282-291, 300-301, which evaluates the density over whole
// columns of any lengths).  The top-level RowSum likelihoods whose columns
// have one length form a row space; rt_density runs one tile loop per
// space, over the space's own rows, in its own tile (RtSpace<s>: kW floats
// a row, kTile rows), through the same two slots, sized for the widest
// space.  Every warp runs every space's loop, so the barriers and, when
// streaming, the copy groups of a thread stay those of every other.  A
// column that no row reads row by row (an MVNormal's Cholesky factor, a
// data vector dotted with a latent one) is read whole by the column-free
// and row-invariant functions, from its pointer in RtCols, at every call.
//
// The forms the density takes since the latent GP and the row forms
// (compute/emit_cuda.py says how each is emitted): a vector that a node
// reads whole past the unroll (L·z of an MVNormal of 17 or more dimensions;
// the source of a gather by an index column read whole) is held in the
// density's scratch, RT_SCRATCH floats a call, per thread in a register
// model and in the chain's slot at RT_OFF_SCR in a workspace model, where
// the lanes split the passes over it; the f64 sums of such a gather's
// adjoints lie there too past a source of emit_cuda.ENTRY_LOCAL_MAX
// entries, so it starts at an even offset.  The loops over an index column
// read whole split over the chain's lanes even in a register model, each
// lane summing its elements' adjoints by entry in an array of its own, and
// the lanes' sums meet in the butterfly: no atomics, so such a kernel gives
// the same bits in every launch.  A row that reads a vector of the rows'
// length by element reads it at the row's index, which the tile loader
// writes after the columns, and adds its adjoint at that entry, which no
// other row has; over the workspace a parameter vector, or an elementwise
// function of one, is read from the chain's state x and its adjoint added
// to g there (RT_ROW_STATE, RT_ROWQ), with no copy in inv or ainv.  A row
// that reads a source varying by row at another row's index rebuilds it
// there from fields of the tile, which the loader fills at the clamped
// index, one random read a row for the block's chains.  What bounds
// these: the product's 2·n·p multiply-adds a density
// call, split over the lanes (the 64-input GP: 8,192), read from L staged
// in shared memory (below, RT_SMEM_MATS), the index column's loops (n / 32
// int loads and f64 adds a lane, three passes a call), and the
// 100,000-element state of a vector per row, bytes of the workspace.
//
// Integer index columns.  The generated RtCols holds each column with its
// own type (int32 for an IntColumn), and the loader keeps an index's bits
// in its float slot of the tile.  A gather of a row-invariant vector by
// that index reads the chain's inv[] at a per-row offset, and its adjoint
// adds into ainv[] there.  The lanes of a warp hit one entry together
// (GLMMPoisson2's year index is the same in 32 neighbouring rows,
// glmm_large's group in 5), and the adjoints are summed without atomics,
// in a fixed order, so that every launch and both tile loops give the
// same bits: in a register model each lane adds into its own per-thread
// copy of ainv, and at the end of the density call each gathered entry is
// summed over the lanes by the butterfly (rt_gathered_sum); in a slot
// model (GLMMPoisson2, glmm_large), where 32 copies of glmm_large's 10,000
// entries would be 1.3 MB a chain to clear and sum in every call, a row
// hands its gathers' adjoints back and the warp adds each step of 32 rows
// into the chain's one ainv: the lanes with one entry form a group
// (__match_any_sync), a fixed tree over the group's lanes in order sums
// their values, and its lowest lane adds the sum (rt_scatter).  Over a
// slot in device memory the warp runs several steps at once
// (RtSpace<s>::kStep, emit_cuda.gather_step): each lane's rows of the
// steps issue their gathers together, and the steps' sums of an entry
// are merged before one read-modify-write of it (rt_scatter_steps).
//
// Larger models (the header defines RT_WS_FLOATS) keep every per-chain
// array in a slot of RT_WS_FLOATS floats a chain, holding the seven state
// arrays, inv, ainv, and the 32 lanes' copies of the adjoints that every
// row reads (RT_OFF_LANES): in the block's shared memory where its slots
// fit beside its tiles, up to 256 parameters (RT_WS_SHARED,
// emit_cuda.shared_slot: GLMMPoisson2's 8 slots of 5.6 KB beside its
// 64 KB tile), else in a workspace in device memory that the wrapper
// allocates, one slot a chain, the ragged edge's copies included
// (glmm_large's 360 KB a chain).  Every pass
// over the state (the kicks and drifts, rt_take, rt_collect) and
// every emitted loop over a vector splits its elements over the lanes,
// lane l taking l, l + 32, ... (RT_FOR), so a warp's access is one
// 128-byte line; p·p and every emitted sum are lane partials and a
// butterfly, identical in every lane; the Philox groups are split the
// same way, and the uniform comes from the lane that owns its group by a
// shuffle.  Scalar adjoints of parameters are added to g by lane 0 alone.
// A __syncwarp (RT_WS_SYNC) separates two passes where a lane reads what
// another wrote: the natural coordinates x before the density, inv
// before the rows, ainv after each step's scatter and before
// rt_rows_post, the gradient before the next kick.  The drift writes x
// beside qn, and the kicks scale the gradient as they read it
// (rt_gs), so no pass of its own does either.  What bounds such a model
// is latency, with 8 warps on an SM: of the rows' scatters and gathers
// (GLMMPoisson2's scatters were 91% of its time with its slot in device
// memory and the leader's loop of shuffles, glmm_large's 47%, its rows'
// gathers 15%) and of the passes (about 23 over arrays of RT_DIM floats
// per density call, 313 elements a lane for glmm_large: 21% of its time;
// tools/kernel_ab.py split, H100, PERF.md §6).
//
// Chains without rows (the column-free branch, hmc_pallas.py:257-301 with
// no columns).  With one thread a chain (L = 1), the chain's state in
// registers and everything in one thread, the iteration is one dependent
// path of some 1,700 operations for the 10-dim funnel, more than half of
// them Philox and Box-Muller, and 1024 chains are 32 warps on 32 of the
// card's 132 SMs, one each: the card idles, held up by the latency of
// that path.  Spreading a chain over lanes shortens it and brings in more
// SMs, so a chain runs on L lanes, 32 / L chains a warp, as many lanes as
// keep the launch within the threads that fill the card (ops/fused_hmc.py,
// lanes_per_chain; one thread a chain where the chains alone fill it, as
// at bench.py's 524,288).  Up to 32 parameters (emit_cuda.LANE_STATE_MAX) every
// lane holds the whole state in registers, as a register model with rows
// does: the lanes split the Philox groups (rt_lane_momenta) and run the
// rest redundantly, since splitting the funnel's passes and density over
// the lanes (the layout below) costs more in shuffles, __syncwarp and
// shared-memory latency than it saves (tools/kernel_ab.py columnfree,
// PERF.md §6).  Past 32 parameters the state is in a slot of the
// workspace layout above, a warp a chain (L = 32), as for the models with
// rows: in the block's shared memory (RT_WS_SHARED, RT_SLOT_STRIDE floats
// a chain) up to 256 parameters, in the device workspace past them, where
// a warp's access is one 128-byte line; the lanes split the passes over
// the state, the Philox groups and every emitted vector loop.  Either way the
// Philox counters are the one-thread kernel's, so the momenta are its
// bits, and the density's scalars run in every lane with the same bits.
// The xor offsets of rt_warp_sum<L> and the width of rt_lane_bcast<L>
// stay inside a chain's group of lanes; every lane of the warp reaches
// every shuffle and __syncwarp, since the chains of a warp make the same
// calls in the same order (the accept branch holds neither), so the full
// mask is right.
//
// Summation error.  Each lane sums its rows of a tile in f32 (the error of
// a sequential sum of R terms is at most about R·u·Σ|terms|, u = 6e-8, and
// typically √R·u·Σ|terms|), adds that to its own f64 sums, and the
// butterfly adds the lanes' f64 sums, of lp and of every row-invariant
// adjoint that all rows read (the first RT_NINV_DENSE of inv), once a
// call, so the error does not grow with the number of tiles beyond a
// random walk of the per-tile errors.  For the 100k-row logistic
// regression (R = 2048 rows a tile, 64 a lane, ~0.3 nats a row) that is
// about 1e-5 nats a lane's tile and ~4e-4 nats in all, plus half an ulp
// (~2e-3) when the f64 total is rounded to f32, against a per-chain f32
// running sum's O(0.1).  A model with its state in
// the workspace sums its rows in f64 (rt_row_sum) and rounds lp once: at
// glmm_large's 50,000 rows and |lp| ~ 1e5, f32 tile sums and two roundings
// drift by a few ulps of lp.  The register models keep f32 tile sums: f64
// row sums made GLMMPoisson2's kernel 7% slower and the README
// regression's 2% on an H100 with one thread a chain
// (rainier_tpu_torch/tools/kernel_ab.py row-sums); but one whose rows
// leave data-only terms to the pass once a launch adds f32 sums of
// RT_ROW_GROUP rows in f64 and rounds lp once (below).  The adjoint of a block
// that only a per-row gather reads accumulates in f32, in each lane's copy
// or through rt_scatter: each entry receives its own rows only (5 a group
// effect in glmm_large, 40 or 100 in GLMMPoisson2).
//
// The same file compiles as host C++ (no __CUDACC__): rt_fused_hmc_host
// then runs every chain slot of the launch's blocks one after another,
// the ragged edge's copies included, with the tile's "block" one thread.
// It emulates the lanes: each lane's rows of a tile are walked in turn
// with the card's steps, or, where rows hand gathers back, the rows in
// steps of 32 (kStep of them at once where the card runs so), lane by
// lane within a step, the gather adjoints added as rt_scatter and
// rt_scatter_steps add them; each lane's partial sums and adjoint copy
// are kept apart, and the lanes' sums added in the butterfly's order
// (rt_lane_tree); a
// workspace model's passes walk every element and keep each lane's
// partial sums (RT_PART).
// So the host build sums in the card's order, which is how the CPU tests
// check the lanes, the loop, the ragged edge and the generated adjoints
// without a card.  A chain without rows of L lanes sums in the order of
// its L lanes (rt_lane_tree<L>).  A slot in shared memory is a host
// buffer, filled with NaN so that a read before a write shows.
#include <utility>

#include "philox.cuh"
#include "rt_model.h"

#define RT_WORDS (2 * RT_DIM + 1)
#define RT_GROUPS ((RT_WORDS + 3) / 4)

// the lanes of a chain: a warp for a model with rows; for one without,
// the L lanes the build defines (ops/fused_hmc.py, build), else a warp
// over a slot (the header defines RT_LANES) and a thread over registers
#if RT_ROW_W > 0
#ifndef RT_LANES
#define RT_LANES 32
#endif
static_assert(RT_LANES == 32, "a chain with rows is one warp");
#else
#ifndef RT_LANES
#define RT_LANES 1
#endif
static_assert(RT_LANES > 0 && RT_LANES <= 32 &&
                  (RT_LANES & (RT_LANES - 1)) == 0,
              "a chain without rows is an aligned group of a warp's lanes");
#endif

// the most threads a block may have: the wrapper's rule gives a model
// with rows at most 8 chains a block, one without at most 128 threads
// (ops/fused_hmc.py, threads_per_block)
#define RT_MAX_THREADS (RT_LANES > 1 ? 256 : 128)

// A slot in shared memory: RT_SLOT_STRIDE floats a chain, a multiple of
// 32 plus RT_LANES, so that the lanes of the 32 / RT_LANES chains of a
// warp that read element d of their slots hit distinct banks
#ifdef RT_WS_SHARED
#define RT_SLOT_STRIDE ((RT_WS_FLOATS + 31) / 32 * 32 + RT_LANES % 32)
#endif

// the block's barrier in device code; nothing in host code (and in nvcc's
// host pass over the __host__ __device__ functions), where the block is
// one thread that runs each thread's share of a tile's copies in turn
// (rt_block_fill), the launch's threads a block many
#ifdef __CUDA_ARCH__
#define RT_TILE_SYNC() __syncthreads()
#else
#define RT_TILE_SYNC()
static int rt_host_threads = 1;
#endif

#if RT_ROW_W > 0
#define RT_WS_NINV RT_NINV_ALLOC
#ifndef RT_NINV_DENSE
#define RT_NINV_DENSE RT_NINV
#define RT_NINV_DENSE_ALLOC RT_NINV_ALLOC
#endif
#define RT_WS_NDENSE RT_NINV_DENSE_ALLOC
#else
#define RT_WS_NINV 0
#define RT_WS_NDENSE 0
#endif

// Row spaces.  A header with one row space names its row function and
// tile loader rt_row and rt_fill_tile; one with
// several defines RT_SPACES and an RtSpace<s> for each.  The tile loops
// read a space through RtSpace<s>: kW floats a row, kTile rows a tile.
// A row that rebuilds a source at another row inside a rebuilt source (a
// Gather whose source varies by row, nested) reads columns from their
// device pointers, so its function takes them (RT_ROW_COLS).
#ifdef RT_ROW_COLS
#define RT_ROWC(cols) , cols
#else
#define RT_ROWC(cols)
#endif
// A row that reads a vector of the rows' length at its own index adds its
// adjoint at that entry, which no other row of the space has: a parameter
// vector (or an elementwise function of one) it reads from the chain's
// natural coordinates q and adds to g, any other vector it reads from inv
// and adds to the chain's own ainv, not to the lane's copy of the dense
// adjoints that its `ainv` is over the workspace; so its function takes
// them (RT_ROW_STATE, RT_ROWQ).
#ifdef RT_ROW_STATE
#define RT_ROWQ(q, g, a) , q, g, a
#else
#define RT_ROWQ(q, g, a)
#endif
// A row space sums RtSpace<s>::kStep rows of a lane at a time where
// kStep > 1, through `step` (a header of one space: rt_row_step,
// RT_ROW_STEP rows); over the workspace, where its rows hand gathers back,
// `step` hands back each row's pairs, row k's gather g at k·kGathers + g
// of sidx and sval (RT_STEPG)
#if defined(RT_WS_FLOATS) && RT_GATHERS > 0
#define RT_STEPG(sidx, sval) , sidx, sval
#else
#define RT_STEPG(sidx, sval)
#endif
#if RT_ROW_W > 0 && !defined(RT_SPACES)
#define RT_SPACES 1
#ifndef RT_ROW_STEP
#define RT_ROW_STEP 1
#endif
template <int S>
struct RtSpace;
template <>
struct RtSpace<0> {
#ifdef RT_WS_FLOATS
  enum { kW = RT_ROW_W, kTile = RT_TILE, kGathers = RT_GATHERS,
         kStep = RT_ROW_STEP };
  static RT_HD float row(const float* x, const float* inv, float* ainv,
                         int* sidx, float* sval RT_ROWC(const RtCols& cols)
                             RT_ROWQ(const float* q, float* g, float* cainv)) {
    return rt_row(x, inv, ainv, sidx, sval RT_ROWC(cols) RT_ROWQ(q, g, cainv));
  }
#else
  enum { kW = RT_ROW_W, kTile = RT_TILE, kStep = RT_ROW_STEP };
  static RT_HD float row(const float* x, const float* inv,
                         float* ainv RT_ROWC(const RtCols& cols)
                             RT_ROWQ(const float* q, float* g, float* cainv)) {
    return rt_row(x, inv, ainv RT_ROWC(cols) RT_ROWQ(q, g, cainv));
  }
#endif
  static RT_HD void step(const float* x, int stride, const float* inv,
                         float* ainv RT_STEPG(int* sidx, float* sval)
                             RT_ROWC(const RtCols& cols)
                             RT_ROWQ(const float* q, float* g, float* cainv),
                         float* out) {
#if RT_ROW_STEP > 1
    rt_row_step(x, stride, inv, ainv RT_STEPG(sidx, sval) RT_ROWC(cols)
                    RT_ROWQ(q, g, cainv), out);
#else
    (void)x, (void)stride, (void)inv, (void)ainv, (void)out;
#endif
  }
  static RT_HD void fill(float* tile, const RtCols& cols, int row0, int rows,
                         int tid, int nt) {
    rt_fill_tile(tile, cols, row0, rows, tid, nt);
  }
#ifdef RT_ROW_CONSTS
  static RT_HD float row_const(const RtCols& cols, int i) {
    return rt_row_const(cols, i);
  }
#endif
};
#endif
#ifndef RT_SPACES
#define RT_SPACES 1
#endif

// the rows of each row space, as the launch gives them (null: none), and
// the sums of their data-only terms, one double a space (below)
struct RtRows {
  int n[RT_SPACES];
  const double* c;
};

static inline RtRows rt_rows(const int* n_rows) {
  RtRows out = {};
  for (int s = 0; s < RT_SPACES && n_rows != 0; ++s) out.n[s] = n_rows[s];
  return out;
}

// The rows' data-only terms (RT_ROW_CONSTS).  Where a row's log-density
// has additive terms that read the columns and literals alone (a count
// likelihood's lgamma(x + 1), with the literals beside it), the emitter
// leaves them out of the row functions and writes them as
// RtSpace<s>::row_const(cols, i), and each launch sums them over every
// space's rows once, before the sampling kernel, on the launch's stream,
// into a double a space that rt_density adds to its rows' f64 sum in
// every call: lp stays the whole log-density, from the launch's own
// columns, and a zoo launch's 4·10^10 rows call no lgammaf (the negative
// binomial's kernel 336.4 → 17.1 ms on an H100, kernel_ab.py tiles,
// PERF.md §6).  The pass is one block of RT_CONST_THREADS
// threads: thread t sums rows t, t + RT_CONST_THREADS, ... of a space in
// f64, and a tree adds the threads' sums in a fixed order, so every
// launch gives the same bits; the host build sums in that order.
#ifdef RT_ROW_CONSTS
#define RT_CONST_THREADS 512

// thread t's f64 sum of space S's rows t, t + RT_CONST_THREADS, ...
template <int S>
RT_HD double rt_const_part(const RtCols& cols, int n_rows, int t) {
  double s = 0.0;
  for (int i = t; i < n_rows; i += RT_CONST_THREADS)
    s += (double)RtSpace<S>::row_const(cols, i);
  return s;
}

// the sum over the spaces of their data-only terms
RT_HD double rt_consts_sum(const RtRows& rows) {
  double s = 0.0;
  for (int k = 0; k < RT_SPACES; ++k) s += rows.c[k];
  return s;
}
#endif

// A density that reads columns whole, outside the rows (RT_WHOLE_COLS),
// takes them in its column-free and row-invariant functions too.
#ifdef RT_WHOLE_COLS
#define RT_WHOLE(cols) , cols
#else
#define RT_WHOLE(cols)
#endif

// A density that holds vectors in a scratch array (a MatVec of a matrix
// read whole by a vector past the unroll, held for its readers and its
// transpose; a vector that an index column read whole gathers from)
// takes it in those functions too: RT_SCRATCH floats, per thread in a
// register model, in the chain's slot (at RT_OFF_SCR) in a workspace
// model, where the lanes split its passes.
#ifdef RT_SCRATCH
#define RT_SCR(scr) , scr
#else
#define RT_SCR(scr)
#define RT_SCRATCH 0
#endif

// A workspace model's product passes (a MatVec past the unroll: L·z of an
// MVNormal of 17 or more dimensions) read L, n x p, through RT_MAT<c>:
// lane r of the forward pass reads row r, lane j of the transpose column
// j.  Read so from device memory, a load of the forward pass touched 32
// cache lines, one a lane (the 64-input GP's kernel: 8.18 ms for 1024
// chains x 25 iterations of HMC(12), ~27 us a density call, against 2.13
// ms staged as below; NVIDIA H100 80GB HBM3 at 700 W, tools/kernel_ab.py
// forms, PERF.md §6).  Where it fits beside the block's slots or tiles, L is
// copied into the block's shared memory once a launch (rt_stage_mats,
// RT_SMEM_MATS floats after them) at a row stride of p + 1 floats, so
// that both passes' lanes hit distinct banks; else the passes read it in
// tiles of its rows at that stride, through two slots there (RT_SMEM_MATS
// floats, which rt_stage_mats points at) that the block's threads fill
// with cp.async as each pass runs, tile t + 1 in flight while tile t is
// read (rt_mat_tile, csrc/rt_math.cuh): each tile crosses L2 once for the
// block's chains, where each chain's warp read all of L from a transposed
// copy (the 256-input GP's kernel: L's reads 8.3 of its 11.9 ms,
// tools/kernel_ab.py gp-split, PERF.md §6).  Every warp of a block runs
// every pass, so the tiles' barriers are reached by all
// (compute/emit_cuda.py, _mat_layout, _tiled_pass).
#ifndef RT_SMEM_MATS
#define RT_SMEM_MATS 0
#endif

// A chain's arrays: per-thread arrays, fully unrolled loops over every
// element in every lane; or arrays in the chain's slot of the workspace
// at offset `off`, each pass over them split over the lanes (RT_FOR),
// unrolled by four, with a pass's sum a lane partial and a butterfly
// (RT_PASS_*) and a __syncwarp where a lane reads what another wrote
// (RT_WS_SYNC).  RT_STATE(name, n, off) declares one.
#ifdef RT_WS_FLOATS
#define RT_UNROLL _Pragma("unroll 4")
#define RT_STATE(name, n, off) float* name = ws + (off)
#define RT_FOR(d, n) for (int d = RT_LANE; d < (n); d += RT_LSTEP)
#define RT_PASS_PART(T, name) RT_PART(T, name)
#define RT_PASS_ADD(name, d, v) RT_ADD(name, d, v)
#define RT_PASS_SUM(name) RT_SUM(name)
#define RT_WS_SYNC() RT_WARP_SYNC()
typedef double rt_row_sum;
#else
#define RT_UNROLL _Pragma("unroll")
#define RT_STATE(name, n, off) float name[n]
#define RT_FOR(d, n) for (int d = 0; d < (n); ++d)
#define RT_PASS_PART(T, name) T name = 0
#define RT_PASS_ADD(name, d, v) name += (v)
#define RT_PASS_SUM(name) (void)0
#define RT_WS_SYNC() \
  do {               \
  } while (0)
#ifdef RT_ROW_CONSTS
typedef double rt_row_sum;
#else
typedef float rt_row_sum;
#endif
#endif
// A register model whose rows leave data-only terms out (RT_ROW_CONSTS)
// sums what remains in f64: those terms cancelled much of each row's
// value (the large Poisson's x·log λ − λ against lgamma(x + 1), ~360 nats
// each at λ ~ 100), and a lane's f32 sum of 128 such rows of a tile
// rounds at ~0.004 nats where the whole row's would round at 4e-5.  Its
// lanes add RT_ROW_GROUP rows in f32, then that partial sum to their f64
// sum, which costs a conversion and an f64 add every RT_ROW_GROUP rows
// (rt_lane_rows): the large Poisson's kernel took 20.1 ms so, 31.7 with
// every row added in f64 and 16.2 in f32 (kernel_ab.py counts, PERF.md §6)
#ifdef RT_ROW_CONSTS
#define RT_ROW_GROUP 8
#else
#define RT_ROW_GROUP 1
#endif
#define RT_OFF_X (6 * RT_DIM)
#define RT_OFF_INV (7 * RT_DIM)
#define RT_OFF_AINV (RT_OFF_INV + RT_WS_NINV)
#define RT_OFF_LANES (RT_OFF_AINV + RT_WS_NINV)
// the scratch at an even offset: it holds f64 sums
#define RT_OFF_SCR ((RT_OFF_LANES + RT_LANES * RT_WS_NDENSE + 1) / 2 * 2)
#ifdef RT_WS_FLOATS
static_assert(RT_WS_FLOATS >= RT_OFF_SCR + RT_SCRATCH,
              "the workspace slot holds every per-chain array");
#endif

// whether this lane stores element d of a register model's arrays, which
// every lane holds (every element in host code and without rows)
RT_HD bool rt_mine(int d) { return d % RT_LSTEP == RT_LANE; }

// The loops over a chain's arrays take pointers that do not alias, so
// that over the workspace the loads of later elements may be issued
// before the stores of earlier ones.

// out = a * b
RT_HD void rt_mul(float* __restrict__ out, const float* __restrict__ a,
                  const float* __restrict__ b) {
  RT_UNROLL
  RT_FOR(d, RT_DIM) out[d] = a[d] * b[d];
}

// g = b * g
RT_HD void rt_mul_in(float* __restrict__ g, const float* __restrict__ b) {
  RT_UNROLL
  RT_FOR(d, RT_DIM) g[d] = b[d] * g[d];
}

// Over the workspace the gradient in the state arrays stays as the
// density leaves it, dlogp/dx, and a kick scales it by sc as it reads it;
// a drift writes the natural coordinates x = qn·sc beside qn, where the
// density reads them.  That saves two passes over RT_DIM floats a
// leapfrog step (x = q·sc before the density, g = sc·g after it), with
// the same bits: a product rounds the same wherever it is taken.  A
// chain with its state in registers scales and multiplies in rt_lp_grad.
#ifdef RT_WS_FLOATS
#define RT_LAZY_SCALE 1
#endif

// element d of the gradient in standardized coordinates
RT_HD float rt_gs(const float* __restrict__ g, const float* __restrict__ sc,
                  int d) {
#ifdef RT_LAZY_SCALE
  return sc[d] * g[d];
#else
  (void)sc;
  return g[d];
#endif
}

// x[d] = qn[d]·sc[d] where the drift writes x (over the workspace)
RT_HD void rt_put_x(float* __restrict__ x, const float* __restrict__ qn,
                    const float* __restrict__ sc, int d) {
#ifdef RT_LAZY_SCALE
  x[d] = qn[d] * sc[d];
#else
  (void)x, (void)qn, (void)sc, (void)d;
#endif
}

// the first leapfrog step's kick and drift: p += h * g, qn = q + eps * p
RT_HD void rt_kick_drift(float* __restrict__ p, float* __restrict__ qn,
                         float* __restrict__ x, const float* __restrict__ q,
                         const float* __restrict__ g,
                         const float* __restrict__ sc, float h, float eps) {
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    p[d] = p[d] + h * rt_gs(g, sc, d);
    qn[d] = q[d] + eps * p[d];
    rt_put_x(x, qn, sc, d);
  }
}

// a later step's: p += eps * gn, qn += eps * p
RT_HD void rt_kick_drift_in(float* __restrict__ p, float* __restrict__ qn,
                            float* __restrict__ x,
                            const float* __restrict__ gn,
                            const float* __restrict__ sc, float eps) {
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    p[d] = p[d] + eps * rt_gs(gn, sc, d);
    qn[d] = qn[d] + eps * p[d];
    rt_put_x(x, qn, sc, d);
  }
}

// p·p
RT_HD float rt_energy(const float* __restrict__ p) {
  RT_PASS_PART(float, k);
  RT_UNROLL
  RT_FOR(d, RT_DIM) RT_PASS_ADD(k, d, p[d] * p[d]);
  RT_PASS_SUM(k);
  return k;
}

// the last half kick, p += h * gn; returns p·p
RT_HD float rt_kick_energy(float* __restrict__ p,
                           const float* __restrict__ gn,
                           const float* __restrict__ sc, float h) {
  RT_PASS_PART(float, k);
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    p[d] = p[d] + h * rt_gs(gn, sc, d);
    RT_PASS_ADD(k, d, p[d] * p[d]);
  }
  RT_PASS_SUM(k);
  return k;
}

// the accept: q = qn, g = gn
RT_HD void rt_take(float* __restrict__ q, float* __restrict__ g,
                   const float* __restrict__ qn,
                   const float* __restrict__ gn) {
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    q[d] = qn[d];
    g[d] = gn[d];
  }
}

// one draw of chain c of n into out[j * n + c]: for a model with its
// state in the workspace, the coordinates collect_pos names (all where it
// is null); otherwise every coordinate, which the wrapper slices (a load
// and a branch per coordinate here changed the code of the whole chain
// loop and slowed the row-tiled kernels on the card).  A model with rows
// stores element d from lane d mod 32 (rt_mine), a branch a coordinate.
// Without rows, where every lane holds the state, lane l stores
// coordinates l, l + RT_LSTEP, ..., each picked by a select over the
// unrolled coordinates, so that one store serves all the lanes: the
// branches parted the lanes of a warp at every store (the funnel's kernel
// at 16 lanes a chain, 1024 chains x 1000 draws: 1.247 ms against 0.889
// ms, H100, PERF.md §6), while the select form slowed the streamed
// 2M-row logistic's kernel by 8% (tools/kernel_ab.py tiles)
RT_HD void rt_collect(float* __restrict__ out, const float* __restrict__ q,
                      const float* __restrict__ sc,
                      const int* __restrict__ collect_pos, int n, int c) {
#ifdef RT_WS_FLOATS
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    const int j = collect_pos == 0 ? d : collect_pos[d];
    if (j >= 0) out[(size_t)j * n + c] = q[d] * sc[d];
  }
#elif RT_ROW_W > 0
  (void)collect_pos;
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d)
    if (rt_mine(d)) out[(size_t)d * n + c] = q[d] * sc[d];
#else
  (void)collect_pos;
#pragma unroll
  for (int d0 = 0; d0 < RT_DIM; d0 += RT_LSTEP) {
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < RT_LSTEP && d0 + j < RT_DIM; ++j)
      v = j == RT_LANE ? q[d0 + j] * sc[d0 + j] : v;
    if (d0 + RT_LANE < RT_DIM) out[(size_t)(d0 + RT_LANE) * n + c] = v;
  }
#endif
}

#define RT_TILE_FLOATS (RT_TILE * RT_ROW_W)

#if RT_ROW_W > 0
// rows [row0, row0 + rows) of space S's columns into `slot`, this
// thread's share of the copies; in host code every thread's share in
// turn, so that the host build runs the loader's partition of a tile over
// the threads of the launch's blocks
template <int S>
RT_HD void rt_block_fill(float* slot, const RtCols& cols, int row0,
                         int rows) {
#ifdef __CUDA_ARCH__
  RtSpace<S>::fill(slot, cols, row0, rows, threadIdx.x, blockDim.x);
#else
  for (int tid = 0; tid < rt_host_threads; ++tid)
    RtSpace<S>::fill(slot, cols, row0, rows, tid, rt_host_threads);
#endif
}

// rows [row0, row0 + kTile) of space S's columns, cut at n_rows, as this
// thread's asynchronous copies into `slot`, committed as one group (an
// empty group past the last row)
template <int S>
RT_HD void rt_stream_tile(float* slot, const RtCols& cols, int row0,
                          int n_rows) {
  typedef RtSpace<S> Sp;
  if (row0 < n_rows)
    rt_block_fill<S>(slot, cols, row0,
                     n_rows - row0 < Sp::kTile ? n_rows - row0 : Sp::kTile);
  rt_copy_commit();
}

// The lanes' own copies of the row-invariant adjoints, which their rows
// add into.  A register model's lane holds a whole copy, its per-thread
// `ainv` on the card (`lanes` is that array), and the gathered blocks'
// entries are summed over the lanes once a density call
// (rt_gathered_sum); host code keeps all RT_LANES copies, lane l's at
// lanes + l * RT_NINV_ALLOC.  A slot model's lanes keep copies of the
// dense adjoints only (RT_NINV_DENSE_ALLOC floats each, at RT_OFF_LANES
// of the slot): a row hands its per-row gathers' adjoints back, and the
// warp adds them into the chain's one ainv (rt_scatter, rt_scatter_steps),
// so 32 copies of glmm_large's 10,000 gathered entries are neither
// written nor summed.
#ifdef RT_WS_FLOATS
#define RT_LANE_COPY RT_NINV_DENSE_ALLOC
#else
#define RT_LANE_COPY RT_NINV_ALLOC
#endif

// A workspace model whose rows read every row-invariant value densely
// (no per-row gather), and at most emit_cuda.INV_REGS_MAX of them, keeps
// them and each lane's adjoints of them in registers over a tile's rows
// (rt_tile_rows); its state stays in the slot.  The header defines
// RT_INV_REGS for such a model.
#ifndef RT_INV_REGS
#define RT_INV_REGS 0
#endif

// the gathered blocks' adjoints [RT_NINV_DENSE, RT_NINV) set to 0: every
// lane's copy of them, or the chain's ainv over the workspace (lane l
// clears entries l, l + 32, ...)
RT_HD void rt_gathered_zero(float* lanes, float* ainv) {
#if defined(RT_WS_FLOATS)
  (void)lanes;
  for (int k = RT_NINV_DENSE + RT_LANE; k < RT_NINV; k += RT_LSTEP)
    ainv[k] = 0.0f;
#elif defined(__CUDA_ARCH__)
  (void)ainv;
  RT_UNROLL
  for (int k = RT_NINV_DENSE; k < RT_NINV; ++k) lanes[k] = 0.0f;
#else
  (void)ainv;
  for (int l = 0; l < RT_LANES; ++l)
    for (int k = RT_NINV_DENSE; k < RT_NINV; ++k)
      lanes[(size_t)l * RT_LANE_COPY + k] = 0.0f;
#endif
}

// the gathered blocks' adjoints in ainv: each entry of the lanes' copies
// summed in the butterfly's order, the same bits in every lane (a
// register model's lane sums its copy in place, ainv being that copy);
// over the workspace rt_scatter has added them there already
RT_HD void rt_gathered_sum(float* lanes, float* ainv) {
#if defined(RT_WS_FLOATS)
  (void)lanes, (void)ainv;
#elif defined(__CUDA_ARCH__)
  (void)ainv;
  for (int k = RT_NINV_DENSE; k < RT_NINV; ++k)
    lanes[k] = rt_warp_sum<RT_LANES>(lanes[k]);
#else
  for (int k = RT_NINV_DENSE; k < RT_NINV; ++k) {
    float v[RT_LANES];
    for (int l = 0; l < RT_LANES; ++l)
      v[l] = lanes[(size_t)l * RT_LANE_COPY + k];
    ainv[k] = rt_lane_tree<RT_LANES>(v);
  }
#endif
}

// One step's per-row gather adjoints, value v at entry k of this lane's
// row (k < 0: a lane past the tile's rows), added into the chain's ainv:
// the lanes with one k form a group (__match_any_sync), ranked in lane
// order, and a fixed tree over the ranks sums each group's values
// (rt_group_sum: ranks r and r + 1 first, then r and r + 2, ..., the
// stages as many as the largest group needs, at most five), which the
// group's lowest lane adds to ainv[k].  Groups hold distinct entries, so
// no two lanes store to one, and the order is fixed: deterministic,
// without atomics.  The tree takes ceil(log2 n) dependent shuffle pairs
// for a group of n where the leader's loop took n - 1 dependent shuffles
// (GLMMPoisson2's year index is the same in the 32 rows of a step: 5
// stages against 31 shuffles).  Host code takes the lanes' k and v as
// arrays and adds in the same order.
#ifdef __CUDA_ARCH__
// this lane's group of one k: returns the tree's sum over the group in
// its lowest lane (others: a partial sum), whether this lane leads, and
// whether the lanes' k are non-decreasing.  Where the k run in lane order,
// each group a run of lanes (k non-decreasing over the lanes, or two such
// runs, the second wholly below the first: an index that wraps), a
// group's ranks are its lanes from the run's first and the tree's partner
// is the lane `off` higher, one __shfl_down_sync a stage: the same adds as
// the general path's, without __match_any_sync and the partner's lane
// (both GLMMs' indices run so: glmm_large's kernel 551.6 → 443.0 ms and
// GLMMPoisson2's 197.4 → 177.3 on an H100 with the merge's run path
// below, the same bits; tools/kernel_ab.py gather-paths, PERF.md §6)
__device__ __forceinline__ float rt_group_sum(int k, float v, bool& lead,
                                              bool& sorted) {
  const unsigned full = 0xffffffffu;
  const int lane = RT_LANE;
  const int prev = __shfl_up_sync(full, k, 1);
  const unsigned down = __ballot_sync(full, lane > 0 && k < prev);
  const int k0 = __shfl_sync(full, k, 0), k31 = __shfl_sync(full, k, 31);
  sorted = down == 0u;
  float s = v;
  if (sorted || (__popc(down) == 1 && k31 < k0)) {
    const bool head = lane == 0 || k != prev;
    const unsigned heads = __ballot_sync(full, head);
    const unsigned after = lane == 31 ? 0u : heads & (0xfffffffeu << lane);
    const int first = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
    const int r = lane - first,
              n = (after != 0u ? __ffs(after) - 1 : 32) - first;
    const int stages = (int)__reduce_max_sync(full, (unsigned)n);
    for (int off = 1; off < stages; off <<= 1) {
      const float o = __shfl_down_sync(full, s, off);
      if ((r & (2 * off - 1)) == 0 && r + off < n) s = s + o;
    }
    lead = head;
    return s;
  }
  const unsigned m = __match_any_sync(full, k);
  const int r = __popc(m & ((1u << lane) - 1u)), n = __popc(m);
  // the lane of rank r + off (off = 1, 2, 4, ...) where there is one:
  // the next member's lane, then doubled by a shuffle each stage
  const unsigned above = lane == 31 ? 0u : m & (0xfffffffeu << lane);
  int next = above != 0u ? __ffs(above) - 1 : lane;
  const int stages = (int)__reduce_max_sync(full, (unsigned)n);
  for (int off = 1; off < stages; off <<= 1) {
    const float o = __shfl_sync(full, s, next);
    if ((r & (2 * off - 1)) == 0 && r + off < n) s = s + o;
    next = __shfl_sync(full, next, next);
  }
  lead = r == 0;
  return s;
}

__device__ __forceinline__ void rt_scatter(float* ainv, int k, float v) {
  bool lead, sorted;
  const float s = rt_group_sum(k, v, lead, sorted);
  if (lead && k >= 0) ainv[k] += s;
}
#else
// lane l's group of entry k[l] summed by the card's tree over the ranks
// (lanes in order), where l is the group's lowest lane; false otherwise
inline bool rt_group_sum(const int* k, const float* v, int l, float& s) {
  for (int m = 0; m < l; ++m)
    if (k[m] == k[l]) return false;
  float g[RT_LANES];
  int n = 0;
  for (int m = l; m < RT_LANES; ++m)
    if (k[m] == k[l]) g[n++] = v[m];
  for (int off = 1; off < n; off <<= 1)
    for (int r = 0; r + off < n; r += 2 * off) g[r] = g[r] + g[r + off];
  s = g[0];
  return true;
}

inline void rt_scatter(float* ainv, const int* k, const float* v) {
  for (int l = 0; l < RT_LANES; ++l) {
    float s;
    if (rt_group_sum(k, v, l, s) && k[l] >= 0) ainv[k[l]] += s;
  }
}
#endif

// Several steps' gather adjoints (RtSpace<s>::kStep steps of a row space
// whose rows hand gathers back over the workspace): each step's groups
// are summed by the tree, as rt_scatter sums them, and the step sums of
// one entry merged in step order into the sum of the entry's first step,
// whose group's lowest lane (the entry's owner) adds it to ainv[k] with
// one load and one store.  The owners hold distinct entries, so all their
// loads are issued before any store: the steps' read-modify-writes of the
// workspace overlap, where a step at a time each waited on the last
// one's.  Where the steps' entries run in row order (glmm_large's groups
// of 5 rows), only a step's first group can continue the entry of the
// last group before it, and the merge is a shuffle a step; otherwise it
// is a loop over each later step's group leaders in lane order (a
// ballot, then two shuffles a leader), uniform over the warp, which made
// the merge half of glmm_large's scatters on an H100 (PERF.md §6).  Host
// code adds in the same order.  One gather g of kG, the pairs of step j
// at j·kG + g.
#ifdef __CUDA_ARCH__
template <int kK, int kG>
__device__ __forceinline__ void rt_scatter_steps(float* ainv, const int* k,
                                                 const float* v, int g) {
  const unsigned full = 0xffffffffu;
  const int lane = RT_LANE;
  int e[kK];
  float s[kK];
  // whether the steps' k run in row order (each step's non-decreasing,
  // none below the last step's last): then an entry's rows are one run,
  // and only a step's first group can share its entry with the last group
  // before it
  bool runs = __shfl_sync(full, k[g], 0) >= 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    bool lead, sorted;
    s[j] = rt_group_sum(k[j * kG + g], v[j * kG + g], lead, sorted);
    e[j] = lead && k[j * kG + g] >= 0 ? k[j * kG + g] : -1;
    runs = runs && sorted &&
           (j == 0 || __shfl_sync(full, k[j * kG + g], 0) >=
                          __shfl_sync(full, k[(j - 1) * kG + g], 31));
  }
  if (runs) {
    // the entry of the last group so far, and its owner: step ci's lane co
    int ci = 0, ce = __shfl_sync(full, k[g], 31),
        co = 31 - __clz(__ballot_sync(full, e[0] >= 0));
#pragma unroll
    for (int j = 1; j < kK; ++j) {
      const unsigned heads = __ballot_sync(full, e[j] >= 0);
      if (__shfl_sync(full, k[j * kG + g], 0) == ce) {
        const float first = __shfl_sync(full, s[j], 0);
#pragma unroll
        for (int i = 0; i < j; ++i)
          if (i == ci && lane == co) s[i] = s[i] + first;
        if (lane == 0) e[j] = -1;
        if (heads == 1u) continue;     // one group: the owner stays
      }
      ci = j;
      ce = __shfl_sync(full, k[j * kG + g], 31);
      co = 31 - __clz(heads);
    }
  } else {
#pragma unroll
    for (int j = 1; j < kK; ++j)
      for (unsigned lead = __ballot_sync(full, e[j] >= 0); lead != 0u;
           lead &= lead - 1u) {
        const int src = __ffs(lead) - 1;
        const int ej = __shfl_sync(full, e[j], src);
        const float sj = __shfl_sync(full, s[j], src);
        bool hit = false;
#pragma unroll
        for (int i = 0; i < j; ++i)
          if (e[i] == ej) s[i] = s[i] + sj, hit = true;
        if (__any_sync(full, hit) && RT_LANE == src) e[j] = -1;
      }
  }
  float a[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j)
    if (e[j] >= 0) a[j] = ainv[e[j]];
#pragma unroll
  for (int j = 0; j < kK; ++j)
    if (e[j] >= 0) ainv[e[j]] = a[j] + s[j];
}
#else
// k[j][l], v[j][l]: step j's pair of lane l
template <int kK>
inline void rt_scatter_steps(float* ainv, const int (*k)[RT_LANES],
                             const float (*v)[RT_LANES]) {
  int e[kK * RT_LANES];
  float s[kK * RT_LANES];
  int n = 0;
  for (int j = 0; j < kK; ++j)
    for (int l = 0; l < RT_LANES; ++l) {
      float sum;
      if (!rt_group_sum(k[j], v[j], l, sum) || k[j][l] < 0) continue;
      int o = 0;
      while (o < n && e[o] != k[j][l]) ++o;
      if (o < n) {
        s[o] = s[o] + sum;
      } else {
        e[n] = k[j][l], s[n] = sum;
        ++n;
      }
    }
  for (int o = 0; o < n; ++o) ainv[e[o]] += s[o];
}
#endif

// the per-row gathers whose adjoints a row of space S hands back (a
// workspace model's, RtSpace<S>::kGathers), and the row called with
// their pairs (sidx, sval) where it has them
#ifdef RT_WS_FLOATS
template <int S>
struct RtGathers {
  enum { value = RtSpace<S>::kGathers };
};
template <int S>
RT_HD float rt_row_at(const float* x, const float* inv, float* own,
                      int* sidx, float* sval, const RtCols& cols,
                      const float* q, float* g, float* ainv) {
  (void)cols, (void)q, (void)g, (void)ainv;
  return RtSpace<S>::row(x, inv, own, sidx, sval RT_ROWC(cols)
                             RT_ROWQ(q, g, ainv));
}
#else
template <int S>
struct RtGathers {
  enum { value = 0 };
};
template <int S>
RT_HD float rt_row_at(const float* x, const float* inv, float* own,
                      int* sidx, float* sval, const RtCols& cols,
                      const float* q, float* g, float* ainv) {
  (void)sidx, (void)sval, (void)cols, (void)q, (void)g, (void)ainv;
  return RtSpace<S>::row(x, inv, own RT_ROWC(cols) RT_ROWQ(q, g, ainv));
}
#endif

// Whether the lanes sum their rows of a tile with the row-step function
// (RtSpace<s>::kStep rows a step, rt_lane_rows): a register model, and a
// workspace model that keeps its row-invariant values in registers
#if !defined(RT_WS_FLOATS) || RT_INV_REGS
#define RT_ROW_STEPS 1
#else
#define RT_ROW_STEPS 0
#endif

// the rows lane, lane + 32, ... of a tile of space S, read from `slot`,
// their values added to lp and their adjoints to the lane's `own`: kStep
// rows at a time while a step's rows are all in the tile, then one at a
// time, so that every sum takes the rows in the same order either way;
// one row a step, RT_ROW_GROUP rows' f32 sum at a time where there are
// that many
template <int S, typename T>
RT_HD void rt_lane_rows(const float* slot, int rows, int lane,
                        const float* inv, float* own, T& lp,
                        const RtCols& cols, const float* q, float* g,
                        float* ainv) {
  typedef RtSpace<S> Sp;
  int r = lane;
  if constexpr (Sp::kStep > 1 && RtGathers<S>::value == 0) {
    for (; r + (Sp::kStep - 1) * RT_LANES < rows;
         r += Sp::kStep * RT_LANES) {
      float out[Sp::kStep];
      Sp::step(slot + r * Sp::kW, RT_LANES * Sp::kW, inv, own RT_ROWC(cols)
                   RT_ROWQ(q, g, ainv), out);
#pragma unroll
      for (int k = 0; k < Sp::kStep; ++k) lp += out[k];
    }
  }
  if constexpr (Sp::kStep == 1 && RT_ROW_GROUP > 1) {
    for (; r + (RT_ROW_GROUP - 1) * RT_LANES < rows;
         r += RT_ROW_GROUP * RT_LANES) {
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < RT_ROW_GROUP; ++k) {
        int sidx[1];
        float sval[1];
        part += rt_row_at<S>(slot + (r + k * RT_LANES) * Sp::kW, inv, own,
                             sidx, sval, cols, q, g, ainv);
      }
      lp += part;
    }
  }
#pragma unroll 4
  for (; r < rows; r += RT_LANES) {
    int sidx[1];
    float sval[1];
    lp += rt_row_at<S>(slot + r * Sp::kW, inv, own, sidx, sval, cols, q, g,
                       ainv);
  }
}

// The lanes' f64 sums of their rows' lp and dense adjoints over every
// tile of a density call, which the butterfly adds once a call
// (rt_acc_sums): one lane's on the card, lane l's at l (lp) and at
// l·RT_NINV_DENSE_ALLOC + k (adjoint k) in host code.  Summing the lanes
// once a call, not once a tile, saves a tile's butterfly over every
// dense adjoint (the 32-feature MVNormal logistic's kernel: 34 values,
// 170 shuffles a lane a tile, 6% of its time at 256-row tiles on an
// H100, PERF.md §6) and adds the lanes' sums in f64.
#ifdef __CUDA_ARCH__
#define RT_ACC_LANES 1
#else
#define RT_ACC_LANES RT_LANES
#endif

// The lanes' sums of lp (lp[0] on the card, lp[l] in host code) and of
// the dense adjoints (`acc`, RT_NINV_DENSE a lane) over the lanes: tot[0]
// lp, tot[1 + k] adjoint k, the same bits in every lane.  The card adds
// each value in a butterfly (rt_warp_sum), and host code in its order
// (rt_lane_tree).  A register model whose rows are one tile loaded once a
// launch (the README regression) adds them all in one reduce-scatter of
// RT_ACC_P values a lane, the padding zeros (rt_lane_sums), which adds
// the lanes in the butterfly's pairs and so keeps its bits: its density
// call is short, and the butterflies took 28% of the README regression's
// kernel once its rows' divisions were gone.  Given to every model with
// rows in a trial, it made the streamed ones 0.1-49% slower and the
// 32-feature slot model 5.5% (their code laid out anew), so it is not
// theirs (H100, tools/kernel_ab.py split and tiles, PERF.md §6).
#define RT_ACC_N (1 + RT_NINV_DENSE)
#if defined(__CUDA_ARCH__) && defined(RT_RESIDENT) && !defined(RT_WS_FLOATS)
#define RT_LANE_SUMS 1
constexpr int rt_pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * rt_pow2_at_least((n + 1) / 2);
}
#define RT_ACC_P rt_pow2_at_least(RT_ACC_N)
#endif

RT_HD void rt_acc_sums(const double* lp, const double* acc, double* tot) {
#ifdef RT_LANE_SUMS
  double v[RT_ACC_P];
#pragma unroll
  for (int k = 0; k < RT_ACC_P; ++k)
    v[k] = k == 0 ? lp[0] : k < RT_ACC_N ? acc[k - 1] : 0.0;
  rt_lane_sums<RT_LANES, RT_ACC_P, RT_ACC_N>(v, tot);
#elif defined(__CUDA_ARCH__)
#pragma unroll
  for (int k = 0; k < RT_ACC_N; ++k)
    tot[k] = rt_warp_sum<RT_LANES>(k == 0 ? lp[0] : acc[k - 1]);
#else
  double v[RT_LANES];
  for (int k = 0; k < RT_ACC_N; ++k) {
    for (int l = 0; l < RT_LANES; ++l)
      v[l] = k == 0 ? lp[l] : acc[(size_t)l * RT_NINV_DENSE_ALLOC + k - 1];
    tot[k] = rt_lane_tree<RT_LANES>(v);
  }
#endif
}

// the rows of one tile of space S, read from `slot`, for this chain: lane
// l sums rows l, l + 32, ... into its own lp and dense adjoints
// (rt_row_sum) and adds those to its f64 sums (lp_acc, ainv_acc); over
// the workspace, where rows hand gathers back, the lanes walk the rows in
// steps of 32, each step's gather adjoints added into `ainv` by
// rt_scatter.  Both tile loops, synchronous and streamed, sum their rows
// here, so the two give the same results bit for bit.  Host code walks
// each lane's rows in turn, or, where rows hand gathers back, the steps,
// and in each the lanes one after another.
template <int S>
RT_HD void rt_tile_rows(const float* slot, int rows, const float* inv,
                        float* lanes, float* ainv, double* lp_acc,
                        double* ainv_acc, const RtCols& cols,
                        const float* q, float* g) {
  (void)cols, (void)q, (void)g;
  typedef RtSpace<S> Sp;
  enum { kG = RtGathers<S>::value > 0 ? RtGathers<S>::value : 1 };
#ifdef __CUDA_ARCH__
#if RT_INV_REGS
  // every row-invariant value read densely, and few of them: the lane
  // keeps them and its adjoints of them in registers over the tile's
  // rows, where its slot's copies cost a load and a store for every value
  // of every row (the 32-feature MVNormal logistic's kernel, 33 values:
  // 80.7 s for 1024 chains x 200 draws of HMC(5) so, on an H100)
  (void)lanes;
  float inv_r[RT_NINV_ALLOC], own[RT_NINV_ALLOC];
#pragma unroll
  for (int k = 0; k < RT_NINV; ++k) inv_r[k] = inv[k], own[k] = 0.0f;
  rt_row_sum lp_t = 0.0f;
  rt_lane_rows<S>(slot, rows, RT_LANE, inv_r, own, lp_t, cols, q, g, ainv);
#elif defined(RT_WS_FLOATS)
  float* own = lanes + (size_t)RT_LANE * RT_LANE_COPY;
  rt_row_sum lp_t = 0.0f;
  for (int k = 0; k < RT_NINV_DENSE; ++k) own[k] = 0.0f;
  int r0 = 0;
  if constexpr (Sp::kStep > 1 && RtGathers<S>::value > 0) {
    // kK steps' rows with their gathers in flight, then their scatters
    enum { kK = Sp::kStep };
    for (; r0 + kK * RT_LANES <= rows; r0 += kK * RT_LANES) {
      int sidx[kK * kG];
      float sval[kK * kG];
      float out[kK];
      Sp::step(slot + (r0 + RT_LANE) * Sp::kW, RT_LANES * Sp::kW, inv,
               own RT_STEPG(sidx, sval) RT_ROWC(cols) RT_ROWQ(q, g, ainv),
               out);
#pragma unroll
      for (int j = 0; j < kK; ++j) lp_t += out[j];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g > 0) RT_WARP_SYNC();
        rt_scatter_steps<kK, kG>(ainv, sidx, sval, g);
      }
      RT_WARP_SYNC();
    }
  }
  for (; r0 < rows; r0 += RT_LANES) {
    const int r = r0 + RT_LANE;
    int sidx[kG];
    float sval[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) sidx[g] = -1, sval[g] = 0.0f;
    if (r < rows)
      lp_t += rt_row_at<S>(slot + r * Sp::kW, inv, own, sidx, sval, cols, q,
                           g, ainv);
#pragma unroll
    for (int g = 0; g < RtGathers<S>::value; ++g) {
      if (g > 0) RT_WARP_SYNC();
      rt_scatter(ainv, sidx[g], sval[g]);
    }
    RT_WARP_SYNC();
  }
#else
  float* own = lanes;
  rt_row_sum lp_t = 0.0f;
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k) own[k] = 0.0f;
  rt_lane_rows<S>(slot, rows, RT_LANE, inv, own, lp_t, cols, q, g, ainv);
#endif
  lp_acc[0] += (double)lp_t;
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k) ainv_acc[k] += (double)own[k];
#else
  rt_row_sum lp_t[RT_LANES] = {};
  for (int l = 0; l < RT_LANES; ++l)
    for (int k = 0; k < RT_NINV_DENSE; ++k)
      lanes[(size_t)l * RT_LANE_COPY + k] = 0.0f;
  if constexpr (RT_ROW_STEPS && RtGathers<S>::value == 0) {
    for (int l = 0; l < RT_LANES; ++l)
      rt_lane_rows<S>(slot, rows, l, inv, lanes + (size_t)l * RT_LANE_COPY,
                      lp_t[l], cols, q, g, ainv);
  } else {
    int r0 = 0;
    if constexpr (Sp::kStep > 1 && RtGathers<S>::value > 0) {
      enum { kK = Sp::kStep };
      for (; r0 + kK * RT_LANES <= rows; r0 += kK * RT_LANES) {
        int sidx[kG][kK][RT_LANES];
        float sval[kG][kK][RT_LANES];
        for (int l = 0; l < RT_LANES; ++l) {
          int si[kK * kG];
          float sv[kK * kG], out[kK];
          Sp::step(slot + (r0 + l) * Sp::kW, RT_LANES * Sp::kW, inv,
                   lanes + (size_t)l * RT_LANE_COPY RT_STEPG(si, sv)
                       RT_ROWC(cols) RT_ROWQ(q, g, ainv),
                   out);
          for (int j = 0; j < kK; ++j) {
            lp_t[l] += out[j];
            for (int g = 0; g < kG; ++g)
              sidx[g][j][l] = si[j * kG + g], sval[g][j][l] = sv[j * kG + g];
          }
        }
        for (int g = 0; g < kG; ++g)
          rt_scatter_steps<kK>(ainv, sidx[g], sval[g]);
      }
    }
    for (; r0 < rows; r0 += RT_LANES) {
      int sidx[kG][RT_LANES];
      float sval[kG][RT_LANES];
      for (int l = 0; l < RT_LANES; ++l) {
        int si[kG];
        float sv[kG];
        for (int g = 0; g < kG; ++g) si[g] = -1, sv[g] = 0.0f;
        if (r0 + l < rows)
          lp_t[l] += rt_row_at<S>(slot + (r0 + l) * Sp::kW, inv,
                                  lanes + (size_t)l * RT_LANE_COPY, si, sv,
                                  cols, q, g, ainv);
        for (int g = 0; g < kG; ++g) sidx[g][l] = si[g], sval[g][l] = sv[g];
      }
      for (int g = 0; g < RtGathers<S>::value; ++g)
        rt_scatter(ainv, sidx[g], sval[g]);
    }
  }
  for (int l = 0; l < RT_LANES; ++l) {
    lp_acc[l] += (double)lp_t[l];
    for (int k = 0; k < RT_NINV_DENSE; ++k)
      ainv_acc[(size_t)l * RT_NINV_DENSE_ALLOC + k] +=
          (double)lanes[(size_t)l * RT_LANE_COPY + k];
  }
#endif
}

// every tile of space S's n_rows rows.  `tile`: the block's shared
// memory, two slots of RT_TILE_FLOATS floats where `stream_cols` is set.
// Each space's loops pass the same barriers in every thread, and a
// streamed loop commits one group a tile in every thread, so the waits of
// the next space count the same groups.
template <int S>
RT_HD void rt_space_rows(const RtCols& cols, const RtRows& rows,
                         int stream_cols, float* tile, const float* inv,
                         float* lanes, float* ainv, double* lp_acc,
                         double* ainv_acc, const float* q, float* g) {
  const int n_rows = rows.n[S], kTile = RtSpace<S>::kTile;
#ifdef RT_RESIDENT
  // the one tile, loaded once a launch (rt_resident)
  (void)stream_cols, (void)kTile;
  rt_tile_rows<S>(tile, n_rows, inv, lanes, ainv, lp_acc, ainv_acc, cols, q,
                  g);
  return;
#endif
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
                      lanes, ainv, lp_acc, ainv_acc, cols, q, g);
      RT_TILE_SYNC();
    }
  } else {
    for (int row0 = 0; row0 < n_rows; row0 += kTile) {
      const int n = n_rows - row0 < kTile ? n_rows - row0 : kTile;
      rt_block_fill<S>(tile, cols, row0, n);
      rt_copy_commit();
      rt_copy_wait_all();
      RT_TILE_SYNC();
      rt_tile_rows<S>(tile, n, inv, lanes, ainv, lp_acc, ainv_acc, cols, q,
                      g);
      RT_TILE_SYNC();
    }
  }
}

// every row space's tiles, space 0 first: a fold over the spaces, so
// that each space's loop is inlined in turn, with no call between spaces
template <int... S>
RT_HD void rt_spaces_rows(std::integer_sequence<int, S...>,
                          const RtCols& cols, const RtRows& rows,
                          int stream_cols, float* tile, const float* inv,
                          float* lanes, float* ainv, double* lp_acc,
                          double* ainv_acc, const float* q, float* g) {
  (rt_space_rows<S>(cols, rows, stream_cols, tile, inv, lanes, ainv, lp_acc,
                    ainv_acc, q, g),
   ...);
}
#endif

// A row space whose rows fit one tile (RT_RESIDENT): its tile loaded once
// a launch, every thread's share, then a barrier, and every density call
// reads it there, with no copy or barrier of its own (the README
// regression's and GLMMPoisson2's rows; the resident columns of
// hmc_pallas.py:186-222)
RT_HD void rt_resident(const RtCols& cols, const RtRows& rows, float* tile) {
#ifdef RT_RESIDENT
  rt_block_fill<0>(tile, cols, 0, rows.n[0]);
  rt_copy_commit();
  rt_copy_wait_all();
  RT_TILE_SYNC();
#else
  (void)cols, (void)rows, (void)tile;
#endif
}

// log-density and gradient at natural coordinates x for one chain: the
// column-free terms, then the row terms over every tile of each row
// space.  `tile`: the block's shared memory; `ws`: the chain's slot of
// the workspace (unused for small models)
RT_HD float rt_density(const float* x, float* g, const RtCols& cols,
                       const RtRows& rows, int stream_cols, float* tile,
                       float* ws) {
#if RT_SCRATCH > 0 && defined(RT_WS_FLOATS)
  float* scr = ws + RT_OFF_SCR;
#elif RT_SCRATCH > 0
  alignas(8) float scr[RT_SCRATCH];   // it holds f64 sums
#endif
  float lp = rt_logp_grad(x, g RT_WHOLE(cols) RT_SCR(scr));
#if RT_ROW_W > 0
  RT_STATE(inv, RT_NINV_ALLOC, RT_OFF_INV);
  // ainv: the adjoints summed over the lanes, which rt_rows_post reads;
  // lanes: the lanes' own copies
#ifdef RT_WS_FLOATS
  float* ainv = ws + RT_OFF_AINV;
  float* lanes = ws + RT_OFF_LANES;
#elif defined(__CUDA_ARCH__)
  float ainv[RT_NINV_ALLOC];
  float* lanes = ainv;
#else
  float ainv[RT_NINV_ALLOC];
  float lanes[RT_LANES * RT_LANE_COPY];
#endif
  // the lanes' f64 sums over every tile (RT_ACC_LANES)
  double ainv_acc[RT_ACC_LANES * RT_NINV_DENSE_ALLOC];
  double lp_lanes[RT_ACC_LANES];
  rt_rows_pre(x, inv RT_WHOLE(cols) RT_SCR(scr));
  // the gathered blocks' adjoints accumulate over every tile
  rt_gathered_zero(lanes, ainv);
  RT_WS_SYNC();
#pragma unroll
  for (int k = 0; k < RT_ACC_LANES * RT_NINV_DENSE_ALLOC; ++k)
    ainv_acc[k] = 0.0;
#pragma unroll
  for (int l = 0; l < RT_ACC_LANES; ++l) lp_lanes[l] = 0.0;
  rt_spaces_rows(std::make_integer_sequence<int, RT_SPACES>(), cols, rows,
                 stream_cols, tile, inv, lanes, ainv, lp_lanes, ainv_acc, x,
                 g);
  RT_WS_SYNC();
  rt_gathered_sum(lanes, ainv);
  // the butterfly, once a call: the lanes' sums in every lane; and the
  // rows' data-only terms, summed once a launch
  double tot[RT_ACC_N];
  rt_acc_sums(lp_lanes, ainv_acc, tot);
#ifdef RT_ROW_CONSTS
  const double lp_acc = tot[0] + rt_consts_sum(rows);
#else
  const double lp_acc = tot[0];
#endif
#pragma unroll
  for (int k = 0; k < RT_NINV_DENSE; ++k) ainv[k] = (float)tot[1 + k];
  RT_WS_SYNC();
  rt_rows_post(x, ainv, g RT_WHOLE(cols) RT_SCR(scr));
#if defined(RT_WS_FLOATS) || defined(RT_ROW_CONSTS)
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
// (over the workspace x is the drift's, and g stays dlogp/dx: the note
// at rt_gs)
RT_HD float rt_lp_grad(const float* q, const float* sc, float* g,
                       const RtCols& cols, const RtRows& rows,
                       int stream_cols, float* tile, float* ws) {
  RT_STATE(x, RT_DIM, RT_OFF_X);
#ifdef RT_LAZY_SCALE
  (void)q, (void)sc;
#else
  rt_mul(x, q, sc);
#endif
  RT_WS_SYNC();
  const float lp = rt_density(x, g, cols, rows, stream_cols, tile, ws);
  RT_WS_SYNC();
#ifndef RT_LAZY_SCALE
  rt_mul_in(g, sc);
#endif
  return lp;
}

// A chain of several lanes, each holding its whole state in registers
// (with rows or without), draws its momenta on the card as the workspace
// does: lane l runs the Philox groups l, l + RT_LANES, ..., and p[d] and u
// come from the lane that drew their group, so every lane holds the bits
// that drawing every group would give, at the cost of one group where
// there are RT_LANES groups or fewer (the host build draws them all, the
// same bits): drawn in every lane of its warp, the README regression's 3
// groups, each 10 Philox rounds and a Box-Muller pair, made its kernel 13%
// slower on an H100 (tools/kernel_ab.py philox-split, PERF.md §6).  A
// model with rows and one group (a parameter) has nothing to split: its
// lanes each draw it, with no shuffle (split, the zoo's large Poisson's
// kernel took 12% longer, its code laid out anew; kernel_ab.py tiles).
#if defined(__CUDA_ARCH__) && !defined(RT_WS_FLOATS) && RT_LANES > 1 && \
    (RT_ROW_W == 0 || RT_GROUPS > 1)
#define RT_LANE_RNG 1
#define RT_LANE_GROUPS ((RT_GROUPS + RT_LANES - 1) / RT_LANES)
__device__ __forceinline__ void rt_lane_momenta(float* p, float& u, int it,
                                                uint32_t seed, uint32_t c) {
  // v[j][h]: the normal of coordinate 2k + h of group k = lane + j·L, or
  // the uniform where 2k + h is RT_DIM
  float v[RT_LANE_GROUPS][2];
#pragma unroll
  for (int j = 0; j < RT_LANE_GROUPS; ++j) {
    const int k = RT_LANE + j * RT_LANES;
    uint32_t w[4] = {(uint32_t)it, (uint32_t)k, 0u, 0u};
    rt_philox4x32_10(w, seed, c);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[j][h] = 2 * k + h < RT_DIM
                    ? rt_box_muller(rt_uniform_from_bits(w[2 * h]),
                                    rt_uniform_from_bits(w[2 * h + 1]))
                    : rt_uniform_from_bits(w[2 * h]);
  }
#pragma unroll
  for (int d = 0; d < RT_DIM; ++d)
    p[d] = rt_lane_bcast<RT_LANES>(v[d / 2 / RT_LANES][d % 2],
                                   d / 2 % RT_LANES);
  u = rt_lane_bcast<RT_LANES>(v[RT_DIM / 2 / RT_LANES][RT_DIM % 2],
                              RT_DIM / 2 % RT_LANES);
}
#endif

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
#ifdef RT_LAZY_SCALE
  float* x = ws + RT_OFF_X;
#else
  float* x = 0;
#endif
  RT_UNROLL
  RT_FOR(d, RT_DIM) {
    sc[d] = scale == 0
                      ? 1.0f
                      : scale[scale_per_chain ? (size_t)d * n + c : d];
    q[d] = q0[(size_t)d * n + c] / sc[d];
    rt_put_x(x, q, sc, d);
  }
  const float eps = eps_in[c];
  float lp = rt_lp_grad(q, sc, g, cols, rows, stream_cols, tile, ws);
  float acc = 0.0f, div = 0.0f;

  for (int it = 0; it < n_iterations; ++it) {
    // momentum refresh and the Metropolis uniform
    float u = 0.0f;
    RT_WS_SYNC();
    if (p_noise != 0) {
      RT_UNROLL
      RT_FOR(d, RT_DIM) p[d] = p_noise[((size_t)it * RT_DIM + d) * n + c];
      u = u_noise[(size_t)it * n + c];
    } else {
#ifdef RT_LANE_RNG
      rt_lane_momenta(p, u, it, seed, (uint32_t)c);
#else
      // Philox words 4k..4k+3 of (it, k): words 2d and 2d + 1 make p[d],
      // word 2 * RT_DIM the uniform; over the workspace lane l takes the
      // groups l, l + RT_LANES, ..., and the uniform comes from its
      // group's lane
      RT_UNROLL
      RT_FOR(k, RT_GROUPS) {
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
#ifdef RT_WS_FLOATS
      u = rt_lane_bcast<RT_LANES>(u, (RT_DIM / 2) % RT_LANES);
#endif
#endif
    }
    RT_WS_SYNC();
    const float k0 = rt_energy(p);
    const float h0 = -lp + 0.5f * k0;

    // kick-drift-kick leapfrog, the order of hmc_pallas.py:395-408
    rt_kick_drift(p, qn, x, q, g, sc, 0.5f * eps, eps);
    float lpn = rt_lp_grad(qn, sc, gn, cols, rows, stream_cols, tile, ws);
    for (int s = 1; s < n_steps; ++s) {
      rt_kick_drift_in(p, qn, x, gn, sc, eps);
      lpn = rt_lp_grad(qn, sc, gn, cols, rows, stream_cols, tile, ws);
    }
    const float k1 = rt_kick_energy(p, gn, sc, 0.5f * eps);
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
  rt_collect(qf, q, sc, 0, n, c);
  if (RT_LANE == 0) {
    acc_out[c] = acc / (float)n_iterations;
    div_out[c] = div;
  }
}

// the check entry: lp and gradient at column c of q (dim, n), through
// the same density function, lanes and tile loop as the sampler
RT_HD void rt_logp_grad_chain(int c, int n, const float* q, float* lp,
                              float* g, const RtCols& cols,
                              const RtRows& rows, int stream_cols,
                              float* tile, float* ws) {
  const bool live = c < n;
  if (!live) c = n - 1;
  RT_STATE(x, RT_DIM, RT_OFF_X);
  RT_STATE(gx, RT_DIM, 2 * RT_DIM);
  RT_UNROLL
  RT_FOR(d, RT_DIM) x[d] = q[(size_t)d * n + c];
  RT_WS_SYNC();
  const float l = rt_density(x, gx, cols, rows, stream_cols, tile, ws);
  RT_WS_SYNC();
  if (!live) return;
  if (RT_LANE == 0) lp[c] = l;
#ifdef RT_WS_FLOATS
  RT_UNROLL
  RT_FOR(d, RT_DIM) g[(size_t)d * n + c] = gx[d];
#else
  RT_UNROLL
  for (int d = 0; d < RT_DIM; ++d)
    if (rt_mine(d)) g[(size_t)d * n + c] = gx[d];
#endif
}

// chain slots of a launch over n chains in blocks of `chains`: the
// chains, then the copies that fill the last block
static inline int rt_slots(int n, int chains) {
  return (n + chains - 1) / chains * chains;
}

// whether `threads` make whole chains within the block limit
static inline bool rt_threads_ok(int threads) {
  return threads > 0 && threads % RT_LANES == 0 &&
         threads <= RT_MAX_THREADS;
}

// the floats of a block's chain slots in its shared memory (RT_WS_SHARED;
// none otherwise), which come first
RT_HD int rt_slot_floats(int threads) {
#ifdef RT_WS_SHARED
  return threads / RT_LANES * RT_SLOT_STRIDE;
#else
  (void)threads;
  return 0;
#endif
}

// the floats of a block's shared memory before its staged matrices: its
// chains' slots where they lie there, then, for a model with rows, one
// tile slot, two when streaming; one for a space loaded once a launch
// (RT_RESIDENT, which leaves room for two of GLMMPoisson2's blocks on an
// SM, its slots beside the tile, where its 136 blocks of a density check
// would otherwise run in two waves)
RT_HD int rt_smem_floats(int threads, int stream_cols) {
#if RT_ROW_W == 0
  (void)stream_cols;
  return rt_slot_floats(threads);
#elif defined(RT_RESIDENT)
  (void)stream_cols;
  return rt_slot_floats(threads) + RT_TILE_FLOATS;
#else
  return rt_slot_floats(threads) + (stream_cols ? 2 : 1) * RT_TILE_FLOATS;
#endif
}

// the dynamic shared memory of a block of `threads`: those floats, then
// the staged matrices
static inline int rt_smem_bytes(int threads, int stream_cols) {
  return (rt_smem_floats(threads, stream_cols) + RT_SMEM_MATS) *
         (int)sizeof(float);
}

#ifdef __CUDACC__

// the chain slot's part of the workspace: its place in the block's shared
// memory `smem`, or in the device workspace `ws`
static __device__ __forceinline__ float* rt_slot(float* ws, float* smem,
                                                 int s) {
#if defined(RT_WS_SHARED)
  (void)ws, (void)s;
  return smem + (threadIdx.x / RT_LANES) * RT_SLOT_STRIDE;
#elif defined(RT_WS_FLOATS)
  (void)smem;
  return ws + (size_t)s * RT_WS_FLOATS;
#else
  (void)smem, (void)s;
  return ws;
#endif
}

// the product passes' matrices copied into the block's shared memory,
// every thread its share, then a barrier (nothing without them); `cols`
// then points at the copies
static __device__ __forceinline__ void rt_stage(RtCols& cols, float* smem,
                                                int stream_cols) {
#if RT_SMEM_MATS > 0
  rt_stage_mats(cols, smem + rt_smem_floats(blockDim.x, stream_cols),
                (int)threadIdx.x, (int)blockDim.x);
  __syncthreads();
#else
  (void)cols, (void)smem, (void)stream_cols;
#endif
}

// this warp's chain slot (this thread's, without rows): a block's chains
// one after another
static __device__ __forceinline__ int rt_chain_slot() {
  return (int)(blockIdx.x * (blockDim.x / RT_LANES) + threadIdx.x / RT_LANES);
}

// Each kernel is instantiated once for each value of the streaming flag,
// a constant there, so that the other tile loop is compiled out (the note
// on streamed columns above says why); the launch picks one at run time.
template <int kStream>
__global__ void __launch_bounds__(RT_MAX_THREADS)
    fused_hmc_kernel(int n, const float* q0, const float* scale,
                     int scale_per_chain, const float* eps,
                     const float* p_noise, const float* u_noise, float* qf,
                     float* samples, float* acc, float* div,
                     int n_iterations, int n_steps, int collect_every,
                     const int* collect_pos, int n_collect, uint32_t seed,
                     RtCols cols, RtRows rows, float* ws) {
  extern __shared__ float smem[];
  float* tile = smem + rt_slot_floats(blockDim.x);
  rt_stage(cols, smem, kStream);
  rt_resident(cols, rows, tile);
  const int s = rt_chain_slot();
  rt_hmc_chain(s, n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf,
               samples, acc, div, n_iterations, n_steps, collect_every,
               collect_pos, n_collect, seed, cols, rows, kStream, tile,
               rt_slot(ws, smem, s));
}

template <int kStream>
__global__ void __launch_bounds__(RT_MAX_THREADS)
    logp_grad_kernel(int n, const float* q, float* lp, float* g,
                     RtCols cols, RtRows rows, float* ws) {
  extern __shared__ float smem[];
  float* tile = smem + rt_slot_floats(blockDim.x);
  rt_stage(cols, smem, kStream);
  rt_resident(cols, rows, tile);
  const int s = rt_chain_slot();
  rt_logp_grad_chain(s, n, q, lp, g, cols, rows, kStream, tile,
                     rt_slot(ws, smem, s));
}

#ifdef RT_ROW_CONSTS
// the pass over space S's rows and those after it: each thread's sum,
// then the tree, into out[S]
template <int S>
__device__ void rt_const_space(const RtCols& cols, const RtRows& rows,
                               double* out, double* part) {
  const int t = (int)threadIdx.x;
  part[t] = rt_const_part<S>(cols, rows.n[S], t);
  __syncthreads();
  for (int w = RT_CONST_THREADS / 2; w > 0; w /= 2) {
    if (t < w) part[t] += part[t + w];
    __syncthreads();
  }
  if (t == 0) out[S] = part[0];
  if constexpr (S + 1 < RT_SPACES) rt_const_space<S + 1>(cols, rows, out, part);
}

__global__ void __launch_bounds__(RT_CONST_THREADS)
    rt_row_consts_kernel(RtCols cols, RtRows rows, double* out) {
  __shared__ double part[RT_CONST_THREADS];
  rt_const_space<0>(cols, rows, out, part);
}
#endif

// The launch's pass over the rows' data-only terms into `consts` (one
// double a space, which the wrapper allocates for each prepared launch),
// on `stream` before the kernel that reads them; `rows` then points at
// them.  Nothing where the rows have none.
static int rt_row_consts(const RtCols& cols, RtRows& rows, double* consts,
                         cudaStream_t stream) {
#ifdef RT_ROW_CONSTS
  if (consts == 0) return (int)cudaErrorInvalidValue;
  rt_row_consts_kernel<<<1, RT_CONST_THREADS, 0, stream>>>(cols, rows,
                                                           consts);
  rows.c = consts;
  return (int)cudaGetLastError();
#else
  (void)cols, (void)rows, (void)consts, (void)stream;
  return 0;
#endif
}

// the instantiation for the flag `s` (a column-free model has one)
#if RT_ROW_W > 0
#define RT_PICK(kernel, s) ((s) ? kernel<1> : kernel<0>)
#else
#define RT_PICK(kernel, s) (kernel<0>)
#endif

// A block's shared memory (rt_smem_bytes): above the 48 KB default it
// needs the opt-in attribute.
template <typename K>
static int rt_smem_opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Both launches go on `stream` and return cudaGetLastError(): a refused
// launch never runs, so the wrapper raises on any nonzero code.  Blocks
// of `threads` threads hold threads / RT_LANES chains each; `ws` holds
// RT_WS_FLOATS floats for each of their chain slots (null for a model
// without a workspace, or with its slots in shared memory).
// `stream_cols` streams the column tiles through two slots of shared
// memory.  `consts` holds a double for each row space, which the pass
// over the rows' data-only terms fills first (rt_row_consts).
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
                                   double* consts, void* stream) {
  if (!rt_threads_ok(threads)) return (int)cudaErrorInvalidValue;
  const auto kernel = RT_PICK(fused_hmc_kernel, stream_cols);
  const int smem = rt_smem_bytes(threads, stream_cols);
  int rc = rt_smem_opt_in(kernel, smem);
  if (rc != 0) return rc;
  const RtCols c_cols = rt_cols(cols);
  RtRows rows = rt_rows(n_rows);
  rc = rt_row_consts(c_cols, rows, consts, (cudaStream_t)stream);
  if (rc != 0) return rc;
  const int blocks = rt_slots(n, threads / RT_LANES) / (threads / RT_LANES);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      n, q0, scale, scale_per_chain, eps, p_noise, u_noise, qf, samples, acc,
      div, n_iterations, n_steps, collect_every, collect_pos, n_collect, seed,
      c_cols, rows, ws);
  return (int)cudaGetLastError();
}

extern "C" int rt_logp_grad_launch(int n, const float* q, float* lp,
                                   float* g, const void* const* cols,
                                   const int* n_rows, float* ws,
                                   int threads, int stream_cols,
                                   double* consts, void* stream) {
  if (!rt_threads_ok(threads)) return (int)cudaErrorInvalidValue;
  const auto kernel = RT_PICK(logp_grad_kernel, stream_cols);
  const int smem = rt_smem_bytes(threads, stream_cols);
  int rc = rt_smem_opt_in(kernel, smem);
  if (rc != 0) return rc;
  const RtCols c_cols = rt_cols(cols);
  RtRows rows = rt_rows(n_rows);
  rc = rt_row_consts(c_cols, rows, consts, (cudaStream_t)stream);
  if (rc != 0) return rc;
  const int blocks = rt_slots(n, threads / RT_LANES) / (threads / RT_LANES);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      n, q, lp, g, c_cols, rows, ws);
  return (int)cudaGetLastError();
}

#else

#include <vector>

// The host entries run every chain slot of the launch's `threads`-thread
// blocks one after another, the ragged edge's copies included, each in
// its own slot of the workspace (as on the card), with two tile slots for
// `stream_cols`.  They return 1 for threads that make no whole chains.

#ifdef RT_WS_SHARED
#define RT_OWN_FLOATS RT_WS_FLOATS
#else
#define RT_OWN_FLOATS 1
#endif

// chain slot s's part of the workspace: `own`, a NaN-filled buffer of
// this call, for a slot in shared memory
static float* rt_slot(float* ws, float* own, int s) {
#if defined(RT_WS_SHARED)
  (void)ws, (void)s;
  for (int i = 0; i < RT_WS_FLOATS; ++i) own[i] = NAN;
  return own;
#elif defined(RT_WS_FLOATS)
  (void)own;
  return ws + (size_t)s * RT_WS_FLOATS;
#else
  (void)own, (void)s;
  return ws;
#endif
}

// the pass over the rows' data-only terms, in the card's order: each of
// the RT_CONST_THREADS threads' sums, then the tree, into `consts` (one
// double a space), at which `rows` then points
#ifdef RT_ROW_CONSTS
template <int S>
static void rt_host_const_space(const RtCols& cols, const RtRows& rows,
                                double* consts) {
  double part[RT_CONST_THREADS];
  for (int t = 0; t < RT_CONST_THREADS; ++t)
    part[t] = rt_const_part<S>(cols, rows.n[S], t);
  for (int w = RT_CONST_THREADS / 2; w > 0; w /= 2)
    for (int t = 0; t < w; ++t) part[t] += part[t + w];
  consts[S] = part[0];
  if constexpr (S + 1 < RT_SPACES)
    rt_host_const_space<S + 1>(cols, rows, consts);
}
#endif

static RtRows rt_host_rows(const RtCols& cols, const int* n_rows,
                           double* consts) {
  RtRows rows = rt_rows(n_rows);
#ifdef RT_ROW_CONSTS
  rt_host_const_space<0>(cols, rows, consts);
  rows.c = consts;
#else
  (void)cols, (void)consts;
#endif
  return rows;
}

// the launch's columns, the staged matrices copied into `mats`
static RtCols rt_host_cols(const void* const* cols, float* mats) {
  RtCols out = rt_cols(cols);
#if RT_SMEM_MATS > 0
  rt_stage_mats(out, mats, 0, 1);
#else
  (void)mats;
#endif
  return out;
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
  if (!rt_threads_ok(threads)) return 1;
  rt_host_threads = threads;
  std::vector<float> tile(2 * RT_TILE_FLOATS + 1), own(RT_OWN_FLOATS);
  std::vector<float> mats(RT_SMEM_MATS + 1);
  const RtCols c_cols = rt_host_cols(cols, mats.data());
  double consts[RT_SPACES];
  const RtRows rows = rt_host_rows(c_cols, n_rows, consts);
  rt_resident(c_cols, rows, tile.data());
  for (int s = 0; s < rt_slots(n, threads / RT_LANES); ++s)
    rt_hmc_chain(s, n, q0, scale, scale_per_chain, eps, p_noise, u_noise,
                 qf, samples, acc, div, n_iterations, n_steps, collect_every,
                 collect_pos, n_collect, seed, c_cols, rows, stream_cols,
                 tile.data(), rt_slot(ws, own.data(), s));
  return 0;
}

extern "C" int rt_logp_grad_host(int n, const float* q, float* lp, float* g,
                                 const void* const* cols,
                                 const int* n_rows, float* ws, int threads,
                                 int stream_cols) {
  if (!rt_threads_ok(threads)) return 1;
  rt_host_threads = threads;
  std::vector<float> tile(2 * RT_TILE_FLOATS + 1), own(RT_OWN_FLOATS);
  std::vector<float> mats(RT_SMEM_MATS + 1);
  const RtCols c_cols = rt_host_cols(cols, mats.data());
  double consts[RT_SPACES];
  const RtRows rows = rt_host_rows(c_cols, n_rows, consts);
  rt_resident(c_cols, rows, tile.data());
  for (int s = 0; s < rt_slots(n, threads / RT_LANES); ++s)
    rt_logp_grad_chain(s, n, q, lp, g, c_cols, rows, stream_cols,
                       tile.data(), rt_slot(ws, own.data(), s));
  return 0;
}

#endif
