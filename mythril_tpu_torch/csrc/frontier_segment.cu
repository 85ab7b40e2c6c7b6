// The frontier segment kernel: up to caps.K lockstep EVM steps of B paths
// in one cooperative launch.
//
// Replaces mythril_tpu/frontier/step.py build_segment -> segment (the
// jitted lax.while_loop over batch_step), bit for bit; the step's body is
// frontier_segment.cuh.  One thread owns one path (blocks of 128 threads,
// ceil(B / 128) blocks, all resident at once: the launch refuses a grid the
// card cannot hold, and the wrapper raises).  Every step runs five phases
// with a grid barrier between them, and the loop, its exit test and the
// fork grant stay on the card:
//
//   0. flags: each block counts its running and its free paths (warp
//      ballots), so that every thread knows its live rank (its arena rows)
//      and free rank, and all threads take the same exit decision;
//   1. the path's step (phase_step): decode, handler, tail, rows, event;
//   2. the grant's sort key (reads the coverage plane the step marked);
//   3. each wanting path counts the keys before its own (the stable
//      argsort's rank) and takes the free slot of that rank;
//   4. each granted child slot copies its parent's row and takes the branch;
//   5. each granted parent takes the fall-through and records E_FORK;
//      denied forks pend.  Then the next step's flags.
//
// Bound: per live path and step the function reads its state slice (the
// scalars, the popped stack words, the memory and storage entries it
// scans), one code-table row, the popped arena rows and writes R = 4 rows
// and at most one event; a fork copies a whole state row.  That is a few
// hundred bytes a path-step, microseconds for a whole segment at 3.35 TB/s,
// and the integer work is as small.  What sets the time is latency: on an
// H100 a step costs about 11 us with one live path (the barriers and the
// flag scan) and about twice that with every path live
// (scripts/torch_frontier_probe.py), more on steps that fork (a child copies
// its parent's row and resets its event buffer in one thread).  chip_smoke.py
// reports each dispatch's time beside its bound (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_segment.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;

// Phase 0: in-block ranks of running and free paths, block totals.
__device__ void scan_flags(const mk::SegArgs& s, int32_t b, int32_t* warp_live,
                           int32_t* warp_free) {
  bool run = false, fr = false;
  if (b < s.B) mk::path_flags(s, b, &run, &fr);
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m_live = __ballot_sync(0xFFFFFFFFu, run), m_free = __ballot_sync(0xFFFFFFFFu, fr);
  const unsigned below = (1u << lane) - 1;
  if (lane == 0) warp_live[warp] = __popc(m_live), warp_free[warp] = __popc(m_free);
  __syncthreads();
  int32_t live = __popc(m_live & below), free = __popc(m_free & below), tl = 0, tf = 0;
  for (unsigned w = 0; w < kBlock / 32; ++w) {
    if (w < warp) live += warp_live[w], free += warp_free[w];
    tl += warp_live[w], tf += warp_free[w];
  }
  if (b < s.B) s.live_rank[b] = live, s.free_rank[b] = free;
  if (threadIdx.x == 0) s.blk_live[blockIdx.x] = tl, s.blk_free[blockIdx.x] = tf;
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock) frontier_segment_kernel(mk::SegArgs s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t warp_live[kBlock / 32], warp_free[kBlock / 32];
  const int32_t b = blockIdx.x * kBlock + threadIdx.x;
  const bool mine = b < s.B;
  scan_flags(s, b, warp_live, warp_free);
  grid.sync();
  int32_t arena_len = s.arena_len0, n_exec = 0, max_live = 0;
  const int32_t k = s.k_limit < s.K ? s.k_limit : s.K;
  for (int32_t t = 0;; ++t) {
    int32_t n_live = 0, n_free = 0, live_before = 0, free_before = 0;
    for (int32_t i = 0; i < (int32_t)gridDim.x; ++i) {
      const int32_t l = __ldcg(s.blk_live + i), f = __ldcg(s.blk_free + i);
      n_live += l, n_free += f;
      if (i < (int32_t)blockIdx.x) live_before += l, free_before += f;
    }
    // the same decision in every thread: no thread leaves a barrier behind
    if (!(t < k && n_live > 0 && mk::wadd(arena_len, mk::wmul(n_live, s.R)) < s.ARENA)) break;
    n_exec = mk::wadd(n_exec, n_live);
    max_live = max_live > n_live ? max_live : n_live;
    if (mine) mk::phase_step(s, b, arena_len, live_before + s.live_rank[b], free_before + s.free_rank[b]);
    grid.sync();
    if (mine) mk::phase_key(s, b);
    grid.sync();
    if (mine) mk::phase_grant(s, b, n_free);
    grid.sync();
    if (mine) mk::phase_child(s, b);
    grid.sync();
    if (mine) mk::phase_parent(s, b);
    arena_len = mk::wadd(arena_len, mk::wmul(n_live, s.R));
    scan_flags(s, b, warp_live, warp_free);
    grid.sync();
  }
  if (b == 0) s.out[0] = arena_len, s.out[1] = n_exec, s.out[2] = max_live;
}

// Blocks of the launch, and the most that can be resident at once.
cudaError_t launch_shape(const mk::SegArgs& s, int* grid, int* max_grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frontier_segment_kernel, kBlock, 0);
  *grid = (s.B + kBlock - 1) / kBlock;
  *max_grid = per_sm * sms;
  return e;
}

}  // namespace

// One segment.  Returns the launch's cudaGetLastError(), or
// cudaErrorCooperativeLaunchTooLarge when B paths do not fit resident.
extern "C" int mk_frontier_segment(const mk::SegArgs* args, void* stream) {
  mk::SegArgs s = *args;
  int grid = 0, max_grid = 0;
  cudaError_t e = launch_shape(s, &grid, &max_grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&s};
  e = cudaLaunchCooperativeKernel((const void*)frontier_segment_kernel, grid, kBlock, params, 0,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch shape mk_frontier_segment takes, for reports and errors:
// threads per block, blocks, and the most blocks that fit resident.
extern "C" int mk_frontier_segment_shape(const mk::SegArgs* args, int* block, int* grid,
                                         int* max_grid) {
  *block = kBlock;
  return (int)launch_shape(*args, grid, max_grid);
}
