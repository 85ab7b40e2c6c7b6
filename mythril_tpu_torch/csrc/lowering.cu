// The per-conjunction lowering kernel: one thread per candidate walks a
// compiled conjunction's node table.
//
// Replaces mythril_tpu/ops/lowering.py compile_conjunction -> run (the
// jitted function that evaluates a term DAG over a batch of candidates, with
// _lower_node per term).  Here the DAG is a flat table of records assembled
// on the host (ops/lowering.py:LoweringProgram) and every thread evaluates
// one candidate through it (lowering.cuh); the record is the same for every
// thread at each step, so a warp diverges only in the data-dependent loops
// of division and exponentiation and in the branch of a lookup hit.
//
// Layout: every value lives in a limb-major arena [rows, B] int32 in device
// memory, a node's limbs in consecutive rows, so a warp's 32 candidates
// read and write 32 consecutive words per limb.  Constants stay in a pool
// read by every thread alike.  Keccak nodes end a launch: the wrapper hashes
// them with keccak_f1600.cu between launches (one launch per level of
// keccak nesting), as JAX's run calls keccak_jax.keccak256.
//
// Bound: on the recorded traffic (425-984 nodes, widths up to 512, a few
// hundred candidates) the bytes of the inputs and the truth table are a few
// hundred kilobytes, and the integer work a few hundred operations per node
// and candidate; the time is set by neither, but by one thread's chain of
// dependent records, each reading its operands from the arena (L1/L2) and
// writing its result, with few warps per SM to hide the latency.  A warp
// per candidate with the limbs across lanes, the node table in shared
// memory and fewer launches are the ways to a faster kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lowering.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) lowering_kernel(mk::low::LowerArgs a) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b < a.B) mk::low::run_candidate(a, b);
}

}  // namespace

// One segment of the node table.  Returns the launch's cudaGetLastError().
extern "C" int mk_lowering(const mk::low::LowerArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const int blocks = (args->B + kThreads - 1) / kThreads;
  lowering_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
