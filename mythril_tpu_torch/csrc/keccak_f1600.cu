// Batched keccak-f[1600], in two layouts.
//
// Replaces mythril_tpu/ops/keccak_pallas.py:_permute_tile (the
// pl.pallas_call of _kernel).  I/O keeps the JAX layout: [N, 25, 4] int32,
// four little-endian 16-bit limbs per 64-bit lane, 400 bytes per state.
//
// Thread per state (mk_keccak_f1600): a block of 64 threads copies its 64
// states (25.6 KB) into shared memory with consecutive 16-byte loads, each
// thread packs its state's limbs into 25 uint64_t lanes in registers, runs
// the 24 rounds of keccak.cuh unrolled in pairs with immediate round
// constants, and the block writes the limbs back the same way.  A thread's
// 16-byte reads of shared memory are 400 bytes apart, so the eight threads
// of a quarter warp touch eight disjoint groups of four banks: no conflicts.
//
// Warp per state (mk_keccak_f1600_warp): lanes 0..24 of a warp hold one
// lane of the state each and exchange lanes with __shfl_sync for theta, pi
// and chi (keccak.cuh keccak_f1600_lane).  A state's 400 bytes are one
// coalesced warp load.  This shortens the dependent chain of a state, which
// sets the time when there are too few states to fill the card; the wrapper
// (ops/keccak_cuda.py) takes it below a batch size measured on the card.
//
// Bound: operations.  A state moves 800 bytes (400 in, 400 out) and needs
// 24 x 180 = 4320 32-bit integer instructions (LOP3 and funnel shifts, which
// issue only on the integer pipe: 64 per SM per clock), 5.4 per byte against
// the card's 5.0 (132 SMs x 64 x 1.98 GHz over 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr int kStates = 64;  // states (threads) per block, thread per state
constexpr int kWarpBlock = 128;  // threads per block, warp per state: 4 states

__global__ void __launch_bounds__(kStates)
    keccak_f1600_kernel(const int4* __restrict__ in, int4* __restrict__ out, long long n) {
  __shared__ int4 tile[kStates * 25];
  const long long first = (long long)blockIdx.x * kStates;
  const int count = (int)(n - first < kStates ? n - first : kStates);
  const int4* src = in + first * 25;
  for (int i = threadIdx.x; i < count * 25; i += kStates) tile[i] = src[i];
  __syncthreads();
  if (threadIdx.x < count) {
    int4* s = tile + threadIdx.x * 25;
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) a[l] = mk::lane_from_limbs(s[l].x, s[l].y, s[l].z, s[l].w);
    mk::keccak_f1600(a);
#pragma unroll
    for (int l = 0; l < 25; ++l)
      s[l] = make_int4(mk::lane_limb(a[l], 0), mk::lane_limb(a[l], 1), mk::lane_limb(a[l], 2),
                       mk::lane_limb(a[l], 3));
  }
  __syncthreads();
  int4* dst = out + first * 25;
  for (int i = threadIdx.x; i < count * 25; i += kStates) dst[i] = tile[i];
}

// keccak_f1600_lane's exchange on the card: lane src's v, one warp shuffle.
struct WarpExchange {
  __host__ __device__ __forceinline__ uint64_t operator()(uint64_t v, int src) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(0xffffffffu, (unsigned long long)v, src);
#else
    return v;  // the kernel's body exists only on the card
#endif
  }
};

__global__ void __launch_bounds__(kWarpBlock)
    keccak_f1600_warp_kernel(const int4* __restrict__ in, int4* __restrict__ out, long long n) {
  const long long state = ((long long)blockIdx.x * kWarpBlock + threadIdx.x) / 32;
  if (state >= n) return;  // the whole warp: one state per warp
  const int lane = threadIdx.x % 32;
  const int i = lane < 25 ? lane : lane - 25;  // lanes 25..31 shadow 0..6
  const int4 v = in[state * 25 + i];
  WarpExchange ex;
  const uint64_t a = mk::keccak_f1600_lane(mk::lane_from_limbs(v.x, v.y, v.z, v.w), i, ex);
  if (lane < 25)
    out[state * 25 + lane] = make_int4(mk::lane_limb(a, 0), mk::lane_limb(a, 1),
                                       mk::lane_limb(a, 2), mk::lane_limb(a, 3));
}

}  // namespace

// in, out: [n, 25, 4] int32, contiguous, 16-byte aligned.  Each returns the
// launch's cudaGetLastError().
extern "C" int mk_keccak_f1600(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kStates - 1) / kStates;
  keccak_f1600_kernel<<<(unsigned)blocks, kStates, 0, (cudaStream_t)stream>>>(
      (const int4*)in, (int4*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int mk_keccak_f1600_warp(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n * 32 + kWarpBlock - 1) / kWarpBlock;
  keccak_f1600_warp_kernel<<<(unsigned)blocks, kWarpBlock, 0, (cudaStream_t)stream>>>(
      (const int4*)in, (int4*)out, n);
  return (int)cudaGetLastError();
}
