// The tape VM kernel: one thread per candidate walks the conjunction's tape.
//
// Replaces mythril_tpu/ops/tape_vm.py:_run_tape, the jitted lax.scan over
// the tape whose lax.switch dispatches each step to one of 20 vector ops.
// Here every thread evaluates one candidate assignment (tape_vm.cuh); the
// op is the same for every thread at each step, so a warp diverges only
// inside the data-dependent loops of division and exponentiation.
//
// Layout: every value a step reads lives in a slot file in shared memory,
// [S][4][BLK] uint64_t for a block of BLK candidates: slot s of candidate b
// holds one 256-bit word as four 64-bit words, so a warp's accesses to one
// word are 32 consecutive 8-byte words, free of bank conflicts.  The host
// assigns the slots (ops/tape_vm.py:TapePlan): step results that a later
// step reads, a slot reused after its value's last read; then the leaves
// the tape reads, loaded from leaf_vals at the segment's start, all at
// once; then a zero slot if needed.  So an operand is always a slot, read
// without a branch.  A root's truth is written as soon as its row is final.
// The fixture's tapes need at most 35 slots for step values; a block takes
// 32 candidates while its slot file and staged tape fit in the 227 KB a
// block may use, else 16 or 8 (S up to T = 384 plus the leaves), so every
// tape the profiles admit runs.  With regs given, every step's value is
// also stored to a [V+T, 16, B] int32 copy, off the dependency chain; the
// main path passes none.
//
// keccak steps (OP_KECCAK32/64) split the tape into segments, one launch
// each: a segment ends by absorbing its keccak step's padded preimage into
// a [B, 25, 4] state and by spilling the slots live across the step to a
// [n_spill, 4, B] uint64_t scratch (coalesced over the batch); the wrapper
// then launches keccak_f1600.cu on that state, and the next segment reloads
// the spilled slots and squeezes the digest into the step's slot.  So the
// permutation runs in the kernel that replaces the Pallas one, where the JAX
// tape calls keccak_jax.keccak256.
//
// The segment's step records (64 bytes: op, operand and result slots,
// roots, width mask), the root order, the roots no step decides and the
// leaf rows are staged in shared memory with cp.async, all copies in flight
// at once; each thread reads a step's record into registers one step ahead.
//
// Bound: the integer work on div/exp-heavy tapes, else the bytes of the
// inputs read once (leaf values, tables when a SELECT reads them) and the
// truth table.  What sets the time is neither: one thread walks its
// candidate's steps one after another, and a step's dependent chain (record,
// operands from shared memory, the op's dispatch, the op, the result's
// store) is a few hundred cycles, while at the batches the solver sends
// there are one or two warps per SM to hide it (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tape_vm.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // shared memory one block may use (sm_90)

// One block of BLK candidates (one thread each) runs one segment.
template <int BLK>
__global__ void __launch_bounds__(BLK) tape_vm_kernel(mk::TapeArgs t) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_slots = smem;  // [S][4][BLK]
  const mk::Staged staged = mk::staged_at(t, (int32_t*)(s_slots + (long long)4 * t.S * BLK));
  mk::stage(t, staged, threadIdx.x, BLK);
  __syncthreads();
  const int b = blockIdx.x * BLK + threadIdx.x;
  if (b < t.B) mk::run_candidate(t, staged, mk::SlotFile<BLK>{s_slots + threadIdx.x}, b);
}

size_t smem_bytes(const mk::TapeArgs& t, int block) {
  return (size_t)t.S * 4 * sizeof(uint64_t) * block + (size_t)mk::staged_ints(t) * sizeof(int32_t);
}

// Candidates per block: 32 (one warp) while the segment fits, else 16 or 8
// for a large slot file; 0 if none fits.
int block_size(const mk::TapeArgs& t) {
  for (int block = 32; block >= 8; block /= 2)
    if (smem_bytes(t, block) <= (size_t)kMaxSmem) return block;
  return 0;
}

// Once per block size: allow up to kMaxSmem of dynamic shared memory.  (A
// carveout that prefers L1, for the array tables SELECT reads, was slower on
// an H100: fewer blocks fit on an SM, and the split changes between this
// kernel and keccak's.)
template <int BLK>
cudaError_t configure() {
  static const cudaError_t status = cudaFuncSetAttribute(
      tape_vm_kernel<BLK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return status;
}

template <int BLK>
cudaError_t launch(const mk::TapeArgs& t, size_t smem, cudaStream_t stream) {
  const cudaError_t e = configure<BLK>();
  if (e != cudaSuccess) return e;
  tape_vm_kernel<BLK><<<(t.B + BLK - 1) / BLK, BLK, smem, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// One segment of the tape.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue when the segment does not fit in shared memory.
extern "C" int mk_tape_vm_segment(const mk::TapeArgs* args, void* stream) {
  const mk::TapeArgs& t = *args;
  if (t.B <= 0) return 0;
  const int block = block_size(t);
  const size_t smem = smem_bytes(t, block);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block) {
    case 32: return (int)launch<32>(t, smem, st);
    case 16: return (int)launch<16>(t, smem, st);
    case 8: return (int)launch<8>(t, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape mk_tape_vm_segment picks: candidates per block, and
// dynamic shared memory in bytes (for reports).
extern "C" void mk_tape_vm_shape(const mk::TapeArgs* args, int* block, long long* smem) {
  *block = block_size(*args);
  *smem = (long long)smem_bytes(*args, *block);
}
