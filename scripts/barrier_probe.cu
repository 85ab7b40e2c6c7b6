// A barrier-only kernel for scripts/torch_frontier_probe.py, which builds it
// into a library of its own: the cost of the frontier segment's barriers at
// its launch shapes, with nothing else in the loop.  Not part of the
// package; it measures what a segment step pays for synchronisation alone.
//
// mode 0: __syncthreads() in one block;
// mode 1: grid.sync() of a cooperative launch of `blocks` blocks;
// mode 2: one cluster of `blocks` blocks (1..8), barrier.cluster.arrive.release
//         + wait.acquire;
// mode 3: as mode 2, then every thread reads each block's count word through
//         distributed shared memory, one block after another;
// mode 4: as mode 1, then every thread reads each block's count word from
//         global memory through L2, one block after another.
// Each thread keeps a running sum so that nothing is optimised away.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__global__ void __launch_bounds__(kBlock) barrier_probe_kernel(int mode, int iters, int32_t* sink,
                                                               int32_t* blk) {
  __shared__ int32_t word;
  if (threadIdx.x == 0) word = blockIdx.x + 1;
  int32_t acc = 0;
  if (mode == 0) {
    for (int i = 0; i < iters; ++i) {
      __syncthreads();
      acc += word;
    }
  } else if (mode == 1 || mode == 4) {
    cg::grid_group grid = cg::this_grid();
    if (threadIdx.x == 0) blk[blockIdx.x] = blockIdx.x + 1;
    for (int i = 0; i < iters; ++i) {
      grid.sync();
      if (mode == 4)
        for (unsigned j = 0; j < gridDim.x; ++j) acc += __ldcg(blk + j);
      else
        acc += word;
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_barrier();
    for (int i = 0; i < iters; ++i) {
      cluster_barrier();
      if (mode == 3)
        for (unsigned j = 0; j < cluster.num_blocks(); ++j) acc += *cluster.map_shared_rank(&word, j);
      else
        acc += word;
    }
    cluster_barrier();  // no block leaves while another reads its shared memory
  }
  if (acc == 0x7FFFFFFF) sink[0] = acc;
}

}  // namespace

// Launch `iters` barriers of `mode` over `blocks` blocks of 128 threads on
// `stream`; -> the launch's CUDA error (0 when it started).
extern "C" int mk_barrier_probe(int mode, int blocks, int iters, int32_t* sink, int32_t* blk,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    barrier_probe_kernel<<<1, kBlock, 0, st>>>(mode, iters, sink, blk);
    return (int)cudaGetLastError();
  }
  if (mode == 1 || mode == 4) {
    void* params[] = {&mode, &iters, &sink, &blk};
    const cudaError_t e = cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel, blocks,
                                                      kBlock, params, 0, st);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks), cfg.blockDim = dim3(kBlock), cfg.stream = st;
  cfg.attrs = attr, cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_probe_kernel, mode, iters, sink, blk);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
