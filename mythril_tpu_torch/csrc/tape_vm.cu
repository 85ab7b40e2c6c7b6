// The tape VM kernel: one thread per candidate walks the conjunction's tape.
//
// Replaces mythril_tpu/ops/tape_vm.py:_run_tape, the jitted lax.scan over
// the tape whose lax.switch dispatches each step to one of 20 vector ops.
// Here every thread evaluates one candidate assignment (tape_vm.cuh); the
// op is the same for every thread at each step, so a warp diverges only
// inside the data-dependent loops of division and exponentiation.
//
// Layout: the register file is [V+T, 16, B] int32 16-bit limbs in device
// memory, limb-major over the batch so that a warp's limb accesses
// coalesce; rows [0, V) hold the leaf values (constants and variables), row
// V+t the result of step t.  The wrapper allocates it as scratch.  A thread
// packs an operand's limbs into four uint64_t words (bitvec.cuh), computes,
// masks the result with the step's width mask and stores it.
//
// keccak steps (OP_KECCAK32/64) split the tape into segments, one launch
// each: a segment ends by absorbing its keccak step's padded preimage into
// a [B, 25, 4] state; the wrapper then launches keccak_f1600.cu on that
// state, and the next segment starts by squeezing the digest into the
// step's register.  The permutation thus runs in the kernel that replaces
// the Pallas one, where the JAX tape calls keccak_jax.keccak256.
//
// The segment's tape (op, a0, a1, a2, aux and width masks) is staged in
// shared memory: at most 384 steps x 52 bytes.  Bound: operations on
// div/exp-heavy tapes, else memory: a step reads up to three 64-byte
// operands and writes one per candidate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tape_vm.cuh"

namespace {

__global__ void tape_vm_kernel(mk::TapeArgs t) {
  extern __shared__ uint64_t smem[];
  const int n = mk::stage_hi(t) - mk::stage_lo(t);
  uint64_t* s_mask = smem;
  int32_t* s_code = (int32_t*)(smem + 4 * n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) mk::stage_step(t, i, s_mask, s_code);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < t.B) mk::run_candidate(t, s_mask, s_code, b);
}

}  // namespace

// One segment of the tape.  Returns the launch's cudaGetLastError().
extern "C" int mk_tape_vm_segment(const mk::TapeArgs* args, void* stream) {
  const mk::TapeArgs& t = *args;
  if (t.B <= 0) return 0;
  const int n = mk::stage_hi(t) - mk::stage_lo(t);
  const size_t smem = (size_t)(n > 0 ? n : 1) * (4 * sizeof(uint64_t) + 5 * sizeof(int32_t));
  const int threads = 128;
  const int blocks = (t.B + threads - 1) / threads;
  tape_vm_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
