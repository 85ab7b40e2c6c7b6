// The per-conjunction lowering kernel: a block per candidate walks a
// compiled conjunction's node table level by level, its warps taking the
// level's records and each warp's lanes a record's limbs; one launch per
// call, keccak nodes included.
//
// Replaces mythril_tpu/ops/lowering.py compile_conjunction -> run (the
// jitted function that evaluates a term DAG over a batch of candidates, with
// _lower_node per term and keccak_jax.keccak256 for keccak nodes).  Here the
// DAG is a flat table of records assembled on the host
// (ops/lowering.py:LoweringProgram), ordered by dependency level: a record
// reads only inputs, constants and records of lower levels.
//
// Bound: on the recorded traffic (239-907 records, 35-108 levels deep,
// widths up to 512, B = 48 or 192 candidates) the inputs, the node table
// and the truth table are a few hundred kilobytes and the integer work a
// few hundred operations per record and candidate: 0.0005 ms of the card's
// time at the median call.  Neither binds.  What sets the time is the chain
// of dependent records, 106 deep at the median, each a few dependent loads,
// a few warp exchanges and a barrier.
//
// What the design does about it: it shortens each level of that chain and
// keeps the whole call in one launch.
// - a block owns a candidate: the levels run in order with one
//   __syncthreads() each, the records of a level spread over the 8 warps;
// - a record's limbs lie across the lanes (lowering.cuh): carries of
//   additions and product columns resolve by shuffle and one ballot pair,
//   compares and a table's keys reduce by ballot;
// - the candidate's values, the constant pool, its table rows and the node
//   table sit in dynamic shared memory (61 KB at the median recorded call,
//   77 KB at the largest), so a level costs no round trip to L2; a program
//   that does not fit (more than 227 KB) keeps its values in the global
//   [rows, B] arena and reads the node table from device memory, within
//   the same kernel;
// - keccak nodes are records of their level, hashed by their warp with
//   keccak_f1600_lane (keccak.cuh), one permutation per rate block.
// Division and exponentiation (none in the recorded traffic) run on one
// lane with the scalar code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"
#include "lowering.cuh"

namespace {

constexpr int kThreads = 256;

// A lane value of the card's warp: this lane's own.
template <class T>
struct Lane {
  T v;
  __device__ __forceinline__ T operator[](int) const { return v; }
};

template <class T>
__device__ __forceinline__ T shfl_from(T v, int src) {
  if constexpr (sizeof(T) == 8)
    return (T)__shfl_sync(0xFFFFFFFFu, (unsigned long long)v, src);
  else
    return (T)__shfl_sync(0xFFFFFFFFu, v, src);
}

struct Shfl {
  __device__ __forceinline__ uint64_t operator()(uint64_t v, int src) const {
    return shfl_from(v, src);
  }
};

// lowering.cuh's warp executor on the card: this thread is lane `lane`.
struct Warp {
  int lane;

  template <class F>
  __device__ __forceinline__ auto each(F f) const {
    return Lane<decltype(f(0))>{f(lane)};
  }
  template <class F>
  __device__ __forceinline__ void run(F f) const {
    f(lane);
  }
  __device__ __forceinline__ uint32_t ballot(const Lane<bool>& p) const {
    return __ballot_sync(0xFFFFFFFFu, p.v);
  }
  template <class T, class F>
  __device__ __forceinline__ Lane<T> shfl(const Lane<T>& x, F src) const {
    return {shfl_from(x.v, src(lane))};
  }
  template <class T>
  __device__ __forceinline__ T at(const Lane<T>& x, int src) const {
    return shfl_from(x.v, src);
  }
  // lanes 25..31 run along with a lane index of their own below 25
  __device__ __forceinline__ Lane<uint64_t> permute(const Lane<uint64_t>& a) const {
    Shfl ex;
    return {mk::keccak_f1600_lane(a.v, lane % 25, ex)};
  }
};

__global__ void __launch_bounds__(kThreads) lowering_kernel(mk::low::LowerArgs a) {
  extern __shared__ int32_t smem[];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const mk::low::Cand cand = mk::low::stage(a, smem, b, t, kThreads);
  __syncthreads();
  mk::low::run_levels(Warp{t & 31}, [] { __syncthreads(); }, a, cand, smem, b, t >> 5,
                      kThreads / 32);
  mk::low::finish(a, cand.c, b, t, kThreads);
}

}  // namespace

// The whole node table over every candidate, one block each.  Returns the
// attribute call's or the launch's error.
extern "C" int mk_lowering(const mk::low::LowerArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const size_t bytes = args->in_smem ? (size_t)args->smem_words * sizeof(int32_t) : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lowering_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  lowering_kernel<<<args->B, kThreads, bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
