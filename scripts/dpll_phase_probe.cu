// The DPLL search of mythril_tpu_torch/csrc/dpll.cuh under an executor that
// reads the SM's clock at every barrier, for scripts/torch_dpll_probe.py
// (--parts phases), which builds it into a library of its own.  Not part of
// the package: the kernel's own executor (csrc/dpll.cu) is the same but for
// the clock reads.  Each thread adds up, over its query's steps, the cycles
// of four parts of a step:
//
//   0 sweep: from the end of the last barrier to the vote;
//   1 vote: the warp's OR, its word, the barrier and the OR of the words;
//   2 commit: from the vote's end to the step's second barrier;
//   3 barrier: the second barrier;
//
// and once: 4 the staging (from the start to the staging's last barrier)
// and 5 the whole run (to the end of the store).
//
// out[(q * threads + t) * 6 + part] is thread t's for query q.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dpll.cuh"

namespace {

using mk::dpll::DpllArgs;
using mk::dpll::Query;

template <int kThreads>
struct Timed {
  static constexpr int nt = kThreads;
  int tid;
  long long start, last;
  long long acc[6];

  __device__ __forceinline__ void sync(uint32_t* dead) {
    const long long t0 = clock64();
    __syncthreads();
    const long long t1 = clock64();
    if (dead)
      acc[2] += t0 - last, acc[3] += t1 - t0;  // the step's second barrier
    else
      acc[4] = t1 - start;  // a staging barrier
    last = t1;
  }
  __device__ __forceinline__ uint32_t vote(uint32_t mine, uint32_t* votes) {
    const long long t0 = clock64();
    const uint32_t w = __reduce_or_sync(0xFFFFFFFFu, mine);
    const int lane = tid & 31;
    if (lane == 0) votes[tid >> 5] = w;
    __syncthreads();
    const uint32_t f = __reduce_or_sync(0xFFFFFFFFu, lane < kThreads / 32 ? votes[lane] : 0u);
    const long long t1 = clock64();
    acc[0] += t0 - last, acc[1] += t1 - t0;
    last = t1;
    return f;
  }
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
__global__ void __launch_bounds__(kThreads) dpll_timed(DpllArgs a, long long* out) {
  extern __shared__ __align__(16) char smem[];
  const Query s = mk::dpll::at(smem, a.C, a.V);
  const long long t = clock64();
  Timed<kThreads> x{(int)threadIdx.x, t, t, {0, 0, 0, 0, 0, 0}};
  mk::dpll::run_query(x, a, blockIdx.x, s);
  x.acc[5] = clock64() - x.start;
  for (int i = 0; i < 6; ++i) out[((long long)blockIdx.x * kThreads + threadIdx.x) * 6 + i] = x.acc[i];
}

template <int kThreads>
int launch(const DpllArgs& a, long long* out, cudaStream_t st) {
  const size_t bytes = (size_t)mk::dpll::state_bytes(a.C, a.V);
  const cudaError_t e = cudaFuncSetAttribute(dpll_timed<kThreads>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dpll_timed<kThreads><<<a.Q, kThreads, bytes, st>>>(a, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mk_dpll_timed(const DpllArgs* args, long long* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (args->threads) {
    case 256: return launch<256>(*args, out, st);
    case 1024: return launch<1024>(*args, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
