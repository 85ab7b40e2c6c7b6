// keccak-f[1600] on 25 uint64_t lanes held in registers, plus the limb
// packing the kernels share.
//
// Replaces the round body of mythril_tpu/ops/keccak_pallas.py
// (_round_body/_kernel under pl.pallas_call in _permute_tile).  The TPU
// kernel keeps 64-bit lanes as four 16-bit limbs in a (100, B) uint32 tile
// because its vector unit has no 64-bit integers; Hopper has them, so each
// thread holds one whole state as 25 native lanes and the rotations are
// single funnel shifts.  The (100, B) transpose and the static row-gather
// tables of the Pallas kernel exist for the TPU's 8x128 layout and are not
// carried over.
//
// Every function is __host__ __device__ so that the arithmetic also builds
// with a host C++ compiler.
#pragma once

#include <stdint.h>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace mk {

#define MK_KECCAK_RC_LIST                                                   \
  0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,     \
      0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL, \
      0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL, \
      0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL, \
      0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, \
      0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL, \
      0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL, \
      0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL

#if defined(__CUDACC__)
__constant__ static const uint64_t KECCAK_RC_DEV[24] = {MK_KECCAK_RC_LIST};
#endif
static const uint64_t KECCAK_RC_HOST[24] = {MK_KECCAK_RC_LIST};

// Round constant r: constant memory on the card, a plain table on the host.
__host__ __device__ __forceinline__ uint64_t keccak_rc(int r) {
#if defined(__CUDA_ARCH__)
  return KECCAK_RC_DEV[r];
#else
  return KECCAK_RC_HOST[r];
#endif
}

__host__ __device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

__host__ __device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFULL);
  return (x << 32) | (x >> 32);
}

// 24 rounds of theta, rho+pi, chi and iota; lane index x + 5*y.
__host__ __device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: b[y + 5*((2x+3y)%5)] = rotl(a[x + 5y], ROT[x][y])
    b[0] = rotl64(a[0], 0);
    b[16] = rotl64(a[5], 36);
    b[7] = rotl64(a[10], 3);
    b[23] = rotl64(a[15], 41);
    b[14] = rotl64(a[20], 18);
    b[10] = rotl64(a[1], 1);
    b[1] = rotl64(a[6], 44);
    b[17] = rotl64(a[11], 10);
    b[8] = rotl64(a[16], 45);
    b[24] = rotl64(a[21], 2);
    b[20] = rotl64(a[2], 62);
    b[11] = rotl64(a[7], 6);
    b[2] = rotl64(a[12], 43);
    b[18] = rotl64(a[17], 15);
    b[9] = rotl64(a[22], 61);
    b[5] = rotl64(a[3], 28);
    b[21] = rotl64(a[8], 55);
    b[12] = rotl64(a[13], 25);
    b[3] = rotl64(a[18], 21);
    b[19] = rotl64(a[23], 56);
    b[15] = rotl64(a[4], 27);
    b[6] = rotl64(a[9], 20);
    b[22] = rotl64(a[14], 39);
    b[13] = rotl64(a[19], 8);
    b[4] = rotl64(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] =
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    }
    // iota
    a[0] ^= keccak_rc(r);
  }
}

// Four 16-bit limbs (little-endian, held in int32) <-> one 64-bit lane.
__host__ __device__ __forceinline__ uint64_t lane_from_limbs(int32_t l0, int32_t l1,
                                                             int32_t l2, int32_t l3) {
  return (uint64_t)((uint32_t)l0 & 0xFFFFu) |
         ((uint64_t)((uint32_t)l1 & 0xFFFFu) << 16) |
         ((uint64_t)((uint32_t)l2 & 0xFFFFu) << 32) |
         ((uint64_t)((uint32_t)l3 & 0xFFFFu) << 48);
}

__host__ __device__ __forceinline__ int32_t lane_limb(uint64_t lane, int j) {
  return (int32_t)((lane >> (16 * j)) & 0xFFFFu);
}

}  // namespace mk
