// Batched keccak-f[1600]: one thread per state.
//
// Replaces mythril_tpu/ops/keccak_pallas.py:_permute_tile (the
// pl.pallas_call of _kernel).  I/O keeps the JAX layout: [N, 25, 4] int32,
// four little-endian 16-bit limbs per 64-bit lane.  A thread loads its 100
// limbs as 25 16-byte vector loads (one lane each), packs them into 25
// uint64_t lanes held in registers, runs the 24 rounds of keccak.cuh and
// stores the limbs back.  The state never leaves registers between rounds.
//
// Bound: operations.  A state moves 800 bytes (400 in, 400 out) and needs
// 24 x 180 = 4320 32-bit integer instructions (LOP3 and funnel shifts, which
// issue only on the integer pipe: 64 per SM per clock), 5.4 per byte against
// the card's 5.0 (132 SMs x 64 x 1.98 GHz over 3.35 TB/s).  No tiling through shared memory yet: neighbouring threads read addresses
// 400 bytes apart, so a warp's loads are not coalesced; the lines are reused
// from L1 across the 25 loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

__global__ void keccak_f1600_kernel(const int4* __restrict__ in,
                                    int4* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int4* src = in + i * 25;
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    int4 v = src[l];
    a[l] = mk::lane_from_limbs(v.x, v.y, v.z, v.w);
  }
  mk::keccak_f1600(a);
  int4* dst = out + i * 25;
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    dst[l] = make_int4(mk::lane_limb(a[l], 0), mk::lane_limb(a[l], 1),
                       mk::lane_limb(a[l], 2), mk::lane_limb(a[l], 3));
  }
}

}  // namespace

// in, out: [n, 25, 4] int32, contiguous, 16-byte aligned.  Returns the
// launch's cudaGetLastError().
extern "C" int mk_keccak_f1600(const void* in, void* out, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  keccak_f1600_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)in, (int4*)out, n);
  return (int)cudaGetLastError();
}
