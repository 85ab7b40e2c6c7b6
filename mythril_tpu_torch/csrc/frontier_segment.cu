// The frontier segment kernel: up to caps.K lockstep EVM steps of B paths
// in one launch.
//
// Replaces mythril_tpu/frontier/step.py build_segment -> segment (the
// jitted lax.while_loop over batch_step), bit for bit; the step, the fork
// phases and the loop are frontier_segment.cuh (run_segment), written once
// for this kernel and for the host check.  One thread owns one path, in
// blocks of 128 threads; the whole batch is resident, and the launch shape
// is chosen by B alone:
//
//   B <= 128         one block; the barrier is __syncthreads();
//   B <= 1024        one cluster of ceil(B / 128) blocks (cudaLaunchKernelEx
//                    with a cluster dimension); the barrier is
//                    barrier.cluster.arrive.release + wait.acquire, and the
//                    warp counts and the grant list live in shared memory,
//                    written to every block of the cluster through
//                    distributed shared memory before the barrier (and
//                    only after a first barrier at entry, when every block
//                    of the cluster is known to run);
//   B > 1024         a cooperative grid of ceil(B / 128) blocks; the barrier
//                    is grid.sync(), counts and list in global memory.
//
// A shape that cannot be resident is refused, never replaced by another:
// the wrapper raises.
//
// The segment partitioned over shards (frontier_segment_shards, the cuh's
// "segment partitioned over shards"), which replaces GSPMD's partition of
// the same jitted segment over the JAX mesh's path axis
// (mythril_tpu/parallel/mesh.py shard_frontier_inputs): a cooperative grid
// per launch, the shards' state blocks in allocations of their own.  (Not a
// block or a cluster for a small block, as the single launch has: the other
// cards' stores must reach the counts and lists, which therefore live in
// global memory, and the barrier spans launches anyway.)  Over several cards
// each card runs one launch over its own block; the launches meet, at every
// barrier, at a counter in the leader's memory (card_barrier: system-scope
// release and acquire over NVLink, one thread per card, between two grid
// syncs), and the counts, the grant list, the free list and a child's row
// are peer stores made before it.  Logical shards of one card run as ONE
// launch that holds every shard's blocks, its barrier grid.sync() alone.
// The barrier's wait is bounded (ShardArgs.timeout_ns): a card that never
// arrives ends the others in __trap(), a launch failure, never a hang.
// Bound: the same function, so the same bytes as the single launch; what
// sets its time is latency, a grid sync a barrier (where the single launch
// of up to 1024 paths has a block or cluster barrier) and, over cards, a
// round trip over NVLink at every barrier.
//
// Per step: one barrier when no path wants a fork (each lane publishes its
// post-step flags in the step, in count words double-buffered by step
// parity), five when one does (key, grant, child copy, parent).  Within a
// step, a path's chain is short: what it decodes was read before the
// barrier (code row, stack top, popped rows), its scalars stay in
// registers, and nothing goes through local memory (chip_smoke.py prints
// ptxas's stack frame and the LDL/STL count).
//
// Bound: per live path and step the function reads its state slice (the
// scalars, the popped stack words, the memory and storage entries it
// scans), one code-table row, the popped arena rows and writes R = 4 rows
// and at most one event; a fork copies a whole state row and resets the
// child's event buffer.  That is a few hundred bytes a path-step, and the
// integer work is as small: what sets the time is latency (the barriers
// and one path's dependent chain), measured per part by
// scripts/torch_frontier_probe.py; chip_smoke.py reports each dispatch's
// time beside its bound (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_segment.cuh"

namespace cg = cooperative_groups;

namespace {

using mk::I2;
using mk::I4;
using mk::kBlock;
using mk::kWarpsPerBlock;
using mk::Lane;
using mk::SegArgs;

enum Shape { BLOCK, CLUSTER, GRID };
constexpr int kMaxCluster = 8;  // the portable cluster size
// mk_frontier_segment's refusals: the cooperative grid does not fit
// resident, or no cluster of the size B needs can be scheduled
static_assert(cudaErrorCooperativeLaunchTooLarge == 720, "refusal code");
static_assert(mk::kRecTile * mk::GRANT_W <= 2 * mk::kTile, "records fit the list's buffer");
constexpr int kClusterRefused = -1;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ I4 ld_shared4(const int32_t* p) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  return I4{q.x, q.y, q.z, q.w};
}

// run_segment's executor on the card: this thread's lane.  In one block or
// one cluster, every block keeps every block's warp words and the whole
// grant list in its own shared memory: a writer stores to each block of
// the cluster (distributed shared memory) before the barrier, whose
// release/acquire orders those stores, and every read after it is local.
// The grid keeps both in global memory; one warp per block reads the words.
template <int SHAPE>
struct Dev {
  const SegArgs& s;
  Lane l;
  int32_t* cnt_s;      // [2][kMaxCluster][4] the warp words by parity and block
  I2* list_s;          // [kTile] the grant list (the grid: a staged tile of it), then
                       // the staged grant records
  mk::Tally* tally_s;  // the grid: the block's tally of the last counts
  mk::RowMap* map_s;   // the state row's wide fields, for the child copies
  int lane, warp;

  __device__ __forceinline__ void begin() {
    // distributed shared memory may be written only once every block of the
    // cluster has started: the first publish stores to the other blocks
    if constexpr (SHAPE == CLUSTER) cluster_barrier();
    if (threadIdx.x == 0) mk::row_map(s, *map_s);  // read after the first barrier
    mk::lane_begin(s, l);
  }
  __device__ __forceinline__ void step(int32_t arena_len, const mk::Window& w) {
    mk::step(s, l, arena_len, w);
  }
  __device__ __forceinline__ void keys() {
    if (l.fwant) put_key(l.fwant_rank, mk::fork_key(s, l));
  }
  __device__ __forceinline__ void parent() { mk::fork_parent(s, l); }
  __device__ __forceinline__ const Lane& lane0() const { return l; }

  __device__ __forceinline__ void sync() {
    if constexpr (SHAPE == BLOCK)
      __syncthreads();
    else if constexpr (SHAPE == CLUSTER)
      cluster_barrier();
    else
      cg::this_grid().sync();
  }

  __device__ __forceinline__ int32_t* words(int par) { return cnt_s + par * kMaxCluster * kWarpsPerBlock; }

  __device__ __forceinline__ void publish(int par) {
    const uint32_t ml = __ballot_sync(0xFFFFFFFFu, l.run), mf = __ballot_sync(0xFFFFFFFFu, l.free);
    const uint32_t mw = __ballot_sync(0xFFFFFFFFu, l.fwant);
    mk::warp_ranks(l, lane, ml, mf, mw);
    const int32_t word = mk::pack_counts(ml, mf, mw);
    if constexpr (SHAPE == GRID) {
      if (lane == 0) s.cnt[(par * gridDim.x + blockIdx.x) * kWarpsPerBlock + warp] = word;
    } else if constexpr (SHAPE == CLUSTER) {
      if (lane < (int)gridDim.x)  // lane r stores to block r
        *cg::this_cluster().map_shared_rank(words(par) + blockIdx.x * kWarpsPerBlock + warp, lane) =
            word;
    } else {
      if (lane == 0) words(par)[warp] = word;
    }
  }

  __device__ __forceinline__ void counts(int par) {
    if constexpr (SHAPE != GRID) {
      const int32_t* w = words(par);
      const auto blk = [&](int i) { return ld_shared4(w + i * kWarpsPerBlock); };
      mk::lane_counts(l, mk::tally(blk, gridDim.x, blockIdx.x), blk(blockIdx.x), warp);
    } else {
      // one warp reads every block's words at once (lanes split the
      // blocks), adds them up with shuffles, and leaves the tally in
      // shared memory
      const int4* w = reinterpret_cast<const int4*>(s.cnt) + par * gridDim.x;
      if (warp == 0) {
        mk::Tally t = mk::tally([&](int i) {
          const int4 q = __ldcg(w + i);
          return I4{q.x, q.y, q.z, q.w};
        }, gridDim.x, blockIdx.x, lane, mk::kWarp);
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) {
            t.n[f] += __shfl_xor_sync(0xFFFFFFFFu, t.n[f], d);
            t.before[f] += __shfl_xor_sync(0xFFFFFFFFu, t.before[f], d);
          }
        if (lane == 0) *tally_s = t;
      }
      __syncthreads();
      const int4 q = __ldcg(w + blockIdx.x);
      mk::lane_counts(l, *tally_s, I4{q.x, q.y, q.z, q.w}, warp);
    }
  }

  __device__ __forceinline__ void put_key(int32_t r, I2 e) {
    if constexpr (SHAPE == GRID) {
      s.fkeys[2 * r] = e.x, s.fkeys[2 * r + 1] = e.y;
    } else if constexpr (SHAPE == CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      for (unsigned b = 0; b < gridDim.x; ++b) *cluster.map_shared_rank(list_s + r, b) = e;
    } else {
      list_s[r] = e;
    }
  }

  // Every wanting lane counts over the list: in place in one block or
  // cluster; the grid stages it a tile at a time, every thread of the block
  // loading.
  __device__ __forceinline__ void grant() {
    const int32_t n = l.n_fwant;
    const bool counting = l.fwant && l.want;
    int32_t lt = 0, wb = 0;
    if constexpr (SHAPE == GRID) {
      for (int32_t base = 0; base < n; base += mk::kTile) {
        const int32_t m = n - base < mk::kTile ? n - base : mk::kTile;
        for (int32_t i = threadIdx.x; i < m; i += kBlock) {
          const I2 e = mk::ld_cg2(s.fkeys + 2 * (base + i));
          list_s[i] = e;
        }
        __syncthreads();
        if (counting) mk::grant_count(list_s, m, l, lt, wb);
        __syncthreads();
      }
    } else if (counting) {
      mk::grant_count(list_s, n, l, lt, wb);
    }
    if (counting) mk::grant_take(s, l, lt, wb);
  }

  // The copies of the first n granted children: their records staged in
  // shared memory a tile at a time, then the units over every warp of the
  // launch.
  __device__ __forceinline__ void child_items(int32_t n) {
    I4* rec = reinterpret_cast<I4*>(list_s);  // the list is done with
    const int32_t per = mk::child_units(*map_s);
    const int32_t nw = gridDim.x * kWarpsPerBlock, first = blockIdx.x * kWarpsPerBlock + warp;
    for (int32_t g0 = 0; g0 < n; g0 += mk::kRecTile) {
      const int32_t m = n - g0 < mk::kRecTile ? n - g0 : mk::kRecTile;
      for (int32_t i = threadIdx.x; i < 2 * m; i += kBlock)
        rec[i] = mk::ld_cg4(s.grants + (int64_t)mk::GRANT_W * g0 + 4 * i);
      __syncthreads();
      for (int32_t it = first; it < m * per; it += nw)
        mk::child_unit(s, *map_s, rec + 2 * (it / per), it % per, lane);
      __syncthreads();
    }
  }

  __device__ __forceinline__ void finish(int32_t arena_len, int32_t n_exec, int32_t max_live) {
    if (blockIdx.x == 0 && threadIdx.x == 0) s.out[0] = arena_len, s.out[1] = n_exec, s.out[2] = max_live;
    if constexpr (SHAPE == CLUSTER) cluster_barrier();  // no block leaves while another writes its shared memory
  }
};

template <int SHAPE>
__device__ __forceinline__ void segment_body(const SegArgs& s) {
  __shared__ __align__(16) int32_t cnt_s[2 * kMaxCluster * kWarpsPerBlock];
  __shared__ __align__(16) I2 list_s[mk::kTile];
  __shared__ mk::Tally tally_s;
  __shared__ mk::RowMap map_s;
  Dev<SHAPE> x{s, Lane{}, cnt_s, list_s, &tally_s, &map_s, (int)(threadIdx.x & 31),
               (int)(threadIdx.x >> 5)};
  x.l.b = blockIdx.x * kBlock + threadIdx.x;
  mk::run_segment(x, s);
}

__global__ void __launch_bounds__(kBlock, 1) frontier_segment_block(const __grid_constant__ SegArgs s) {
  segment_body<BLOCK>(s);
}
__global__ void __launch_bounds__(kBlock, 1) frontier_segment_cluster(const __grid_constant__ SegArgs s) {
  segment_body<CLUSTER>(s);
}
__global__ void __launch_bounds__(kBlock, 1) frontier_segment_grid(const __grid_constant__ SegArgs s) {
  segment_body<GRID>(s);
}

// What the card can hold, queried once per device: blocks of the grid
// kernel resident at once, and clusters of each size of the cluster kernel.
struct Fit {
  bool known;
  int max_grid;
  int max_clusters[kMaxCluster + 1];
};
constexpr int kMaxDevices = 64;
Fit g_fit[kMaxDevices];

cudaError_t fit_of(Fit** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Fit& f = g_fit[dev];
  if (!f.known) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frontier_segment_grid, kBlock, 0);
    for (int n = 2; n <= kMaxCluster && e == cudaSuccess; ++n) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = n, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(n), cfg.blockDim = dim3(kBlock), cfg.attrs = attr, cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&f.max_clusters[n], frontier_segment_cluster, &cfg);
    }
    if (e != cudaSuccess) return e;
    f.max_grid = per_sm * sms;
    f.known = true;
  }
  *out = &f;
  return cudaSuccess;
}

int blocks_of(const SegArgs& s) { return (s.B + kBlock - 1) / kBlock; }

// ---- the segment partitioned over shards ------------------------------------

__device__ __forceinline__ uint32_t ld_acquire_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier of n launches, one thread of each: a count and a generation
// in the leader's memory.  The last to arrive resets the count, then
// releases the next generation; the others wait for it, at most timeout_ns.
__device__ void card_barrier(uint32_t* bar, uint32_t n, long long timeout_ns) {
  const uint32_t gen = ld_acquire_sys(bar + 1);
  __threadfence_system();
  if (atomicAdd_system(bar, 1u) == n - 1) {
    atomicExch_system(bar, 0u);
    __threadfence_system();
    atomicAdd_system(bar + 1, 1u);
  } else {
    const uint64_t t0 = global_ns();
    while (ld_acquire_sys(bar + 1) == gen) {
      if ((long long)(global_ns() - t0) > timeout_ns) __trap();
      __nanosleep(128);
    }
  }
  __threadfence_system();
}

using mk::ShardArgs;

// run_segment's executor for a block of one shard.  The shards' views and
// row maps live in shared memory (views[j] indexes shard j's block by the
// global slot); the counts, the grant list, the free list and the records
// are read from this shard's own copies, as the grid's are.
struct ShardDev {
  const ShardArgs& a;
  const SegArgs* views;
  const mk::RowMap* maps;
  const SegArgs& s;  // this block's shard's view
  Lane l;
  I2* list_s;
  mk::Tally* tally_s;
  int k, lblock, gblock, blocks, lane, warp;

  __device__ __forceinline__ void sync() {
    if (a.n_launches > 1) __threadfence_system();
    cg::this_grid().sync();
    if (a.n_launches > 1) {
      if (blockIdx.x == 0 && threadIdx.x == 0) card_barrier(a.bar, a.n_launches, a.timeout_ns);
      cg::this_grid().sync();
    }
  }
  __device__ __forceinline__ void begin() {
    sync();  // every launch has started: what its stream queued before it is done
    mk::lane_begin(s, l);
  }
  __device__ __forceinline__ void step(int32_t arena_len, const mk::Window& w) {
    mk::step(s, l, arena_len, w);
  }
  __device__ __forceinline__ void keys() {
    if (l.fwant) {
      const I2 e = mk::fork_key(s, l);
      for (int j = 0; j < a.n_shards; ++j) mk::shard_key(a, j, l.fwant_rank, e);
    }
    for (int j = 0; j < a.n_shards; ++j) mk::shard_free(a, j, l);
  }
  __device__ __forceinline__ void parent() { mk::fork_parent(s, l); }
  __device__ __forceinline__ const Lane& lane0() const { return l; }

  __device__ __forceinline__ void publish(int par) {
    const uint32_t ml = __ballot_sync(0xFFFFFFFFu, l.run), mf = __ballot_sync(0xFFFFFFFFu, l.free);
    const uint32_t mw = __ballot_sync(0xFFFFFFFFu, l.fwant);
    mk::warp_ranks(l, lane, ml, mf, mw);
    const int32_t word = mk::pack_counts(ml, mf, mw);
    if (lane < a.n_shards) mk::shard_word(a, lane, par, blocks, gblock, warp, word);  // lane j to shard j
  }

  __device__ __forceinline__ void counts(int par) {
    const int4* w = reinterpret_cast<const int4*>(s.cnt) + par * blocks;
    if (warp == 0) {
      mk::Tally t = mk::tally([&](int i) {
        const int4 q = __ldcg(w + i);
        return I4{q.x, q.y, q.z, q.w};
      }, blocks, gblock, lane, mk::kWarp);
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          t.n[f] += __shfl_xor_sync(0xFFFFFFFFu, t.n[f], d);
          t.before[f] += __shfl_xor_sync(0xFFFFFFFFu, t.before[f], d);
        }
      if (lane == 0) *tally_s = t;
    }
    __syncthreads();
    const int4 q = __ldcg(w + gblock);
    mk::lane_counts(l, *tally_s, I4{q.x, q.y, q.z, q.w}, warp);
  }

  __device__ __forceinline__ void grant() {
    const int32_t n = l.n_fwant;
    const bool counting = l.fwant && l.want;
    int32_t lt = 0, wb = 0;
    for (int32_t base = 0; base < n; base += mk::kTile) {
      const int32_t m = n - base < mk::kTile ? n - base : mk::kTile;
      for (int32_t i = threadIdx.x; i < m; i += kBlock) list_s[i] = mk::ld_cg2(s.fkeys + 2 * (base + i));
      __syncthreads();
      if (counting) mk::grant_count(list_s, m, l, lt, wb);
      __syncthreads();
    }
    if (counting) mk::grant_take(s, l, lt, wb);
  }

  // This shard's records (its own parents'), the units over its warps; a
  // child's row goes to its slot's shard.
  __device__ __forceinline__ void child_items(int32_t n) {
    I4* rec = reinterpret_cast<I4*>(list_s);
    const int32_t per = mk::child_units(maps[k]);
    const int32_t nw = a.bps * kWarpsPerBlock, first = lblock * kWarpsPerBlock + warp;
    for (int32_t g0 = 0; g0 < n; g0 += mk::kRecTile) {
      const int32_t m = n - g0 < mk::kRecTile ? n - g0 : mk::kRecTile;
      for (int32_t i = threadIdx.x; i < 2 * m; i += kBlock)
        rec[i] = mk::ld_cg4(s.grants + (int64_t)mk::GRANT_W * g0 + 4 * i);
      __syncthreads();
      for (int32_t it = first; it < m * per; it += nw) {
        const I4* r = rec + 2 * (it / per);
        const int j = r[0].x < 0 ? k : mk::shard_of(a, r[0].y);
        mk::child_unit(s, views[j], maps[k], maps[j], r, it % per, lane);
      }
      __syncthreads();
    }
  }

  __device__ __forceinline__ void finish(int32_t arena_len, int32_t n_exec, int32_t max_live) {
    if (k == 0 && lblock == 0 && threadIdx.x == 0) s.out[0] = arena_len, s.out[1] = n_exec, s.out[2] = max_live;
  }
};

__global__ void __launch_bounds__(kBlock, 1) frontier_segment_shards(const __grid_constant__ ShardArgs a) {
  __shared__ SegArgs views[mk::kMaxShards];
  __shared__ mk::RowMap maps[mk::kMaxShards];
  __shared__ __align__(16) I2 list_s[mk::kTile];
  __shared__ mk::Tally tally_s;
  if ((int)threadIdx.x < a.n_shards) {
    mk::shard_view(a, threadIdx.x, views[threadIdx.x]);
    mk::row_map(views[threadIdx.x], maps[threadIdx.x]);
  }
  __syncthreads();
  const int k = a.first + blockIdx.x / a.bps, lblock = blockIdx.x % a.bps;
  ShardDev x{a, views, maps, views[k], Lane{}, list_s, &tally_s, k, lblock, k * a.bps + lblock,
             a.n_shards * a.bps, (int)(threadIdx.x & 31), (int)(threadIdx.x >> 5)};
  x.l.b = mk::shard_slot(a, k, lblock * kBlock + threadIdx.x);
  mk::run_segment(x, views[k]);
}

// blocks of the shard kernel resident at once on each device
int g_shard_grid[kMaxDevices];

cudaError_t shard_grid(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_shard_grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frontier_segment_shards, kBlock, 0);
    if (e != cudaSuccess) return e;
    g_shard_grid[dev] = per_sm * sms;
  }
  *out = g_shard_grid[dev];
  return cudaSuccess;
}

}  // namespace

// One launch of a partitioned segment on the current device: the shards
// [first, first + n_here), bps blocks each, as one cooperative grid.
// Returns the launch's CUDA error; cudaErrorCooperativeLaunchTooLarge when
// the grid does not fit resident.
extern "C" int mk_frontier_segment_shards(const ShardArgs* args, void* stream) {
  const ShardArgs& a = *args;
  if (a.n_shards < 1 || a.n_shards > mk::kMaxShards || a.first < 0 || a.n_here < 1 ||
      a.first + a.n_here > a.n_shards || a.bps * kBlock < a.Bs || a.Bs * a.n_shards != a.s.B)
    return (int)cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t e = shard_grid(&fit);
  if (e != cudaSuccess) return (int)e;
  const int blocks = a.n_here * a.bps;
  if (blocks > fit) return (int)cudaErrorCooperativeLaunchTooLarge;
  ShardArgs copy = a;
  void* params[] = {&copy};
  e = cudaLaunchCooperativeKernel((const void*)frontier_segment_shards, blocks, kBlock, params, 0,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The widest block of paths one launch of the shard kernel holds on the
// current device: its cooperative grid's resident blocks times kBlock.
extern "C" int mk_frontier_shard_max_paths(int* paths) {
  int fit = 0;
  const cudaError_t e = shard_grid(&fit);
  if (e != cudaSuccess) return (int)e;
  *paths = fit * kBlock;
  return 0;
}

// Peer access between every pair of the n devices, which a partitioned
// segment over them needs (peer stores, the barrier's atomics, the
// leader's arena).  Returns 0, a CUDA error, or -2 when a pair cannot
// reach each other's memory (*bad_a, *bad_b: that pair).  Restores the
// current device.
extern "C" int mk_frontier_enable_peers(const int* devs, int n, int* bad_a, int* bad_b) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i)
    for (int j = 0; j < n && rc == 0; ++j) {
      if (devs[i] == devs[j]) continue;
      int ok = 0;
      e = cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]);
      if (e != cudaSuccess) {
        rc = (int)e;
      } else if (!ok) {
        *bad_a = devs[i], *bad_b = devs[j], rc = -2;
      } else if ((e = cudaSetDevice(devs[i])) != cudaSuccess) {
        rc = (int)e;
      } else {
        e = cudaDeviceEnablePeerAccess(devs[j], 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled) (void)cudaGetLastError();
        else if (e != cudaSuccess) rc = (int)e;
      }
    }
  cudaSetDevice(cur);
  return rc;
}

// One segment.  Returns the launch's CUDA error; cudaErrorCooperativeLaunchTooLarge
// when B > 1024 paths do not fit resident, kClusterRefused (-1) when the
// card cannot schedule the cluster that 128 < B <= 1024 paths need.
extern "C" int mk_frontier_segment(const SegArgs* args, void* stream) {
  const SegArgs& s = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_of(s);
  if (blocks <= 1) {
    frontier_segment_block<<<1, kBlock, 0, st>>>(s);
    return (int)cudaGetLastError();
  }
  Fit* fit = nullptr;
  cudaError_t e = fit_of(&fit);
  if (e != cudaSuccess) return (int)e;
  if (blocks <= kMaxCluster) {
    if (fit->max_clusters[blocks] < 1) return kClusterRefused;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks), cfg.blockDim = dim3(kBlock), cfg.stream = st;
    cfg.attrs = attr, cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, frontier_segment_cluster, s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  if (blocks > fit->max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  SegArgs copy = s;
  void* params[] = {&copy};
  e = cudaLaunchCooperativeKernel((const void*)frontier_segment_grid, blocks, kBlock, params, 0, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch shape mk_frontier_segment takes, for reports and errors:
// threads per block, blocks, the cluster size (0 without a cluster), and
// how many such launches the card holds resident (clusters of that size,
// or blocks for the grid; 1 for one block).
extern "C" int mk_frontier_segment_shape(const SegArgs* args, int* block, int* grid, int* cluster,
                                         int* resident) {
  const int blocks = blocks_of(*args);
  *block = kBlock, *grid = blocks, *cluster = 0, *resident = 1;
  if (blocks <= 1) return 0;
  Fit* fit = nullptr;
  const cudaError_t e = fit_of(&fit);
  if (e != cudaSuccess) return (int)e;
  if (blocks <= kMaxCluster)
    *cluster = blocks, *resident = fit->max_clusters[blocks];
  else
    *resident = fit->max_grid;
  return 0;
}

// The widest segment mk_frontier_segment launches on the current device:
// paths up to the first cluster size the card cannot schedule, or, when it
// schedules every cluster size, the cooperative grid's resident blocks
// (fit_of's max_grid) times kBlock.  A wider B is refused at launch.
extern "C" int mk_frontier_max_paths(int* paths) {
  Fit* fit = nullptr;
  const cudaError_t e = fit_of(&fit);
  if (e != cudaSuccess) return (int)e;
  int blocks = 1;
  while (blocks < kMaxCluster && fit->max_clusters[blocks + 1] >= 1) ++blocks;
  if (blocks == kMaxCluster && fit->max_grid > kMaxCluster) blocks = fit->max_grid;
  *paths = blocks * kBlock;
  return 0;
}
