// The devsolver's batched DPLL kernel: one block per query, the whole
// search inside one launch.
//
// Replaces mythril_tpu/devsolver/device.py _get_jitted -> _run (the jitted
// lax.while_loop over devsolver/kernel.py step), bit for bit with the host
// twin kernel.run_host; the loop, its layout and its phases are dpll.cuh
// (run_query), which the host check also builds.
//
// Bound: the function reads the plane once (12 B a clause, 256 B of
// decision order) and writes V bytes of assignment per query; per step it
// reads each clause that can be false (the padding and the clauses holding
// an anchor's true literal cannot), so the integer work is steps x those
// clauses x about 20 operations.  What sets the time is the chain of one
// query's steps: latency, not bytes.
//
// What the design does about it (dpll.cuh):
// - staging drops the clauses that are true for the whole run and packs the
//   rest, 6 B a clause (24 KB at C = 4096), so a step sweeps only the real
//   clauses and an empty query (every recorded plane) is one trivial step;
//   a thread keeps its first 4 clauses in registers (the wrapper's block
//   sizes cover the buckets: 256 threads for 512 clauses, 1024 for 4096);
// - the assignment is a bit per literal, a variable's two literals side by
//   side, so a literal's truth is one word read and one funnel shift; the
//   step's implications apply as word ORs, and a backtrack is one AND a word
//   with the snapshot taken at that decision;
// - a step is two barriers: the sweep's flags, OR-ed within each warp
//   (__reduce_or_sync) into the warp's word and then over the words, and the
//   commit's end; every thread keeps the decision stack as two 64-bit masks
//   and takes the same branch, so no thread waits on a one-thread phase;
// - up to 1024 threads a block (4 clauses a thread at C = 4096); the
//   wrapper picks the size from the clause bucket;
// - the dynamic shared-memory limit is raised once per device and size,
//   not at every launch.
//
// What is left sets the step (scripts/torch_dpll_probe.py --parts phases):
// the sweep, three word reads a clause at random banks of one SM's shared
// memory, then the vote and the commit's dependent reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dpll.cuh"

namespace {

using mk::dpll::DpllArgs;
using mk::dpll::Query;

// run_query's executor on the card: this thread of the query's block.
template <int kThreads>
struct Block {
  static constexpr int nt = kThreads;
  int tid;

  __device__ __forceinline__ void sync(uint32_t*) { __syncthreads(); }
  // The warp's OR into its own word, the barrier, every lane one warp's
  // word and the OR over the lanes: no atomic, no word to clear.
  __device__ __forceinline__ uint32_t vote(uint32_t mine, uint32_t* votes) {
    const uint32_t w = __reduce_or_sync(0xFFFFFFFFu, mine);
    const int lane = tid & 31;
    if (lane == 0) votes[tid >> 5] = w;
    __syncthreads();
    return __reduce_or_sync(0xFFFFFFFFu, lane < kThreads / 32 ? votes[lane] : 0u);
  }
  // One shared atomic per warp: the warp's kept clauses take consecutive
  // slots in lane order.
  __device__ __forceinline__ int32_t claim(bool keep, int32_t* n) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
    const int lane = tid & 31;
    int32_t base = 0;
    if (lane == 0 && m) base = atomicAdd(n, __popc(m));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    return base + __popc(m & ((1u << lane) - 1u));
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads) dpll_kernel(DpllArgs a) {
  extern __shared__ __align__(16) char smem[];
  const Query s = mk::dpll::at(smem, a.C, a.V);
  Block<kThreads> x{(int)threadIdx.x};
  mk::dpll::run_query(x, a, blockIdx.x, s);
}

constexpr int kMaxDevices = 64;
constexpr int kSizes = 2;  // 256, 1024 threads
// The dynamic shared memory each size's kernel was allowed, per device.
size_t g_allowed[kMaxDevices][kSizes];

template <int kThreads>
int launch(const DpllArgs& a, int size, cudaStream_t stream) {
  const size_t bytes = (size_t)mk::dpll::state_bytes(a.C, a.V);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  size_t& allowed = g_allowed[dev][size];
  if (bytes > 48 * 1024 && bytes > allowed) {
    e = cudaFuncSetAttribute(dpll_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  dpll_kernel<kThreads><<<a.Q, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Every query of a plane, one block each.  Returns the launch's
// cudaGetLastError(), the attribute call's error, or cudaErrorInvalidValue
// for a block size or a variable count the kernel does not take.
extern "C" int mk_dpll(const DpllArgs* args, void* stream) {
  const DpllArgs& a = *args;
  if (a.Q <= 0) return 0;
  if (a.V < 2 || a.V > mk::dpll::kMaxVars) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a.threads) {
    case 256: return launch<256>(a, 0, st);
    case 1024: return launch<1024>(a, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shared memory one query's block needs (bytes), for the wrapper's check.
extern "C" long long mk_dpll_smem_bytes(int C, int V) { return mk::dpll::state_bytes(C, V); }
