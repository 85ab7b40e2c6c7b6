// The devsolver's batched DPLL kernel: one block per query, the whole
// search inside one launch.
//
// Replaces mythril_tpu/devsolver/device.py _get_jitted -> _run (the jitted
// lax.while_loop over devsolver/kernel.py step), bit for bit with the host
// twin kernel.run_host; the loop and its phases are dpll.cuh (run_query),
// which the host check also builds.
//
// Design: a block owns a query.  Its clauses (C x 3 x 4 B, 48 KB at C =
// 4096), decision order, assignment (int8), levels (int16) and the two
// implication bitsets live in shared memory, more than the 48 KB a launch
// gets without asking (cudaFuncSetAttribute raises the limit).  A step's
// phases are split by barriers: the sweep, threads striding over clauses,
// with units OR-ed into the bitsets by shared atomics; the block-wide ORs
// (__syncthreads_or) of its flags; the application, threads striding over
// bitset words; one thread's decision or backtrack choice; the
// unassignment striding over variables.  The JAX loop shares one step
// counter across the batch; a block stops when its own query is decided,
// which gives the same outputs (a decided query never changes).
//
// Bound: the function reads the plane once (12 B a clause, 256 B of
// decision order) and writes V bytes of assignment per query; per step it
// reads each clause's three literals and their variables, so the integer
// work is steps x C x (about 20 operations).  What sets the time is the
// chain of steps, each a few barriers long: latency, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dpll.cuh"

namespace {

constexpr int kThreads = 256;

using mk::dpll::DpllArgs;
using mk::dpll::Query;

// run_query's executor on the card: this thread of the query's block.
struct Block {
  const DpllArgs& a;
  const Query& s;
  int tid;

  __device__ void stage(int32_t q) { mk::dpll::stage(a, q, s, tid, kThreads); }
  __device__ void sync() { __syncthreads(); }
  __device__ int sweep() {
    const int f = mk::dpll::sweep(s, a.C, tid, kThreads);
    const int conflict = __syncthreads_or(f & 1);
    const int open = __syncthreads_or(f & 2);
    return (conflict ? 1 : 0) | (open ? 2 : 0);
  }
  __device__ bool both() { return __syncthreads_or(mk::dpll::both_ways(s, a.V, tid, kThreads)); }
  __device__ bool apply(bool go) {
    return __syncthreads_or(mk::dpll::apply(s, a.V, go, tid, kThreads));
  }
  __device__ void decide() {
    if (tid == 0) mk::dpll::decide(s);
  }
  __device__ void set_sat() {
    if (tid == 0) mk::dpll::set_sat(s);
  }
  __device__ void pick_jump() {
    if (tid == 0) mk::dpll::pick_jump(s);
  }
  __device__ void flip(int32_t j) {
    if (tid == 0) mk::dpll::flip(s, j);
  }
  __device__ void unassign(int32_t j) { mk::dpll::unassign_above(s, a.V, j, tid, kThreads); }
  __device__ void store(int32_t q, int32_t steps) {
    mk::dpll::store(a, q, s, steps, tid, kThreads);
  }
};

__global__ void __launch_bounds__(kThreads) dpll_kernel(DpllArgs a) {
  extern __shared__ __align__(16) char smem[];
  const Query s = mk::dpll::at(smem, a.C, a.V);
  Block x{a, s, (int)threadIdx.x};
  mk::dpll::run_query(x, a, blockIdx.x, s);
}

}  // namespace

// Returns the launch's cudaGetLastError(), or the attribute call's error.
extern "C" int mk_dpll(const DpllArgs* args, void* stream) {
  if (args->Q <= 0) return 0;
  const int64_t bytes = mk::dpll::state_bytes(args->C, args->V);
  const cudaError_t e =
      cudaFuncSetAttribute(dpll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dpll_kernel<<<args->Q, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// The shared memory one query's block needs (bytes), for the wrapper's check.
extern "C" long long mk_dpll_smem_bytes(int C, int V) { return mk::dpll::state_bytes(C, V); }
