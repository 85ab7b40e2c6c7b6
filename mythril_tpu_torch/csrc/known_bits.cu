// The known-bits kernel of the solver's prefilter: every row of a packed
// batch walks the tape's nodes in one launch.
//
// Replaces mythril_tpu/absdomain/device.py _get_jitted -> _run (lax.scan over
// the node records, lax.switch over absdomain/domains.py KB_KERNELS), bit
// for bit with the host twin domains.eval_kb_host; the body is
// known_bits.cuh (run_row), which the host check also builds.  The JAX
// program pads nodes to 512 or 4096 and rows to 16 or 64 and chunks rows by
// 64; the results are the same per row, so one launch takes every row of a
// pack, unpadded.
//
// Design: one thread per row.  The walk is a dependence chain (a node reads
// its children's results), so the rows are the only parallelism: a thread
// keeps the node's 16-limb result in registers, reads each child's km and
// kv rows from the [N, R, 16] output planes it wrote earlier in its walk
// (at these sizes they stay in L1/L2) and writes its own.
//
// Bound: the function reads the node records (32 B), the width mask and
// constant (128 B) and each override once, and writes km and kv (128 B per
// node and row); its integer work is a few hundred 32-bit operations per
// node and row.  On the real traffic (N <= 530 nodes, R <= 2 rows) either
// is far below a microsecond: one thread's chain of N dependent nodes, each
// reading its children through the cache, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "known_bits.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) known_bits_kernel(mk::kb::KbArgs a) {
  const int32_t r = blockIdx.x * kThreads + threadIdx.x;
  if (r < a.R) mk::kb::run_row(a, r);
}

}  // namespace

// Returns the launch's cudaGetLastError().
extern "C" int mk_known_bits(const mk::kb::KbArgs* args, void* stream) {
  if (args->N <= 0 || args->R <= 0) return 0;
  const int blocks = (args->R + kThreads - 1) / kThreads;
  known_bits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
