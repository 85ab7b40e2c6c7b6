// keccak-f[1600] on 25 uint64_t lanes, held by one thread or spread over
// 25 threads of a warp, plus the limb packing the kernels share.
//
// Replaces the round body of mythril_tpu/ops/keccak_pallas.py
// (_round_body/_kernel under pl.pallas_call in _permute_tile).  The TPU
// kernel keeps 64-bit lanes as four 16-bit limbs in a (100, B) uint32 tile
// because its vector unit has no 64-bit integers; Hopper has them, so a
// lane is one uint64_t and a rotation two funnel shifts.  The (100, B)
// transpose and the static row-gather tables of the Pallas kernel exist for
// the TPU's 8x128 layout and are not carried over.
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

// Round constant r.  Constant-folded where r is known at compile time, as in
// the unrolled rounds below, so the constants are immediates.
__host__ __device__ constexpr uint64_t keccak_rc(int r) {
  switch (r) {
    case 0: return 0x0000000000000001ULL;
    case 1: return 0x0000000000008082ULL;
    case 2: return 0x800000000000808AULL;
    case 3: return 0x8000000080008000ULL;
    case 4: return 0x000000000000808BULL;
    case 5: return 0x0000000080000001ULL;
    case 6: return 0x8000000080008081ULL;
    case 7: return 0x8000000000008009ULL;
    case 8: return 0x000000000000008AULL;
    case 9: return 0x0000000000000088ULL;
    case 10: return 0x0000000080008009ULL;
    case 11: return 0x000000008000000AULL;
    case 12: return 0x000000008000808BULL;
    case 13: return 0x800000000000008BULL;
    case 14: return 0x8000000000008089ULL;
    case 15: return 0x8000000000008003ULL;
    case 16: return 0x8000000000008002ULL;
    case 17: return 0x8000000000000080ULL;
    case 18: return 0x000000000000800AULL;
    case 19: return 0x800000008000000AULL;
    case 20: return 0x8000000080008081ULL;
    case 21: return 0x8000000000008080ULL;
    case 22: return 0x0000000080000001ULL;
    default: return 0x8000000080008008ULL;
  }
}

__host__ __device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

__host__ __device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFULL);
  return (x << 32) | (x >> 32);
}

// One round, theta, rho+pi, chi and iota, from state a into state e (lane
// index x + 5*y).  rho+pi reads a[x + 5y] into b[y + 5*((2x+3y)%5)] rotated
// by rho's offset; the b lanes are named values, not an array.
__host__ __device__ __forceinline__ void keccak_round(const uint64_t (&a)[25], uint64_t (&e)[25],
                                                      uint64_t rc) {
  const uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
  const uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
  const uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
  const uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
  const uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
  const uint64_t d0 = c4 ^ rotl64(c1, 1);
  const uint64_t d1 = c0 ^ rotl64(c2, 1);
  const uint64_t d2 = c1 ^ rotl64(c3, 1);
  const uint64_t d3 = c2 ^ rotl64(c4, 1);
  const uint64_t d4 = c3 ^ rotl64(c0, 1);
  const uint64_t b0 = a[0] ^ d0;
  const uint64_t b1 = rotl64(a[6] ^ d1, 44);
  const uint64_t b2 = rotl64(a[12] ^ d2, 43);
  const uint64_t b3 = rotl64(a[18] ^ d3, 21);
  const uint64_t b4 = rotl64(a[24] ^ d4, 14);
  const uint64_t b5 = rotl64(a[3] ^ d3, 28);
  const uint64_t b6 = rotl64(a[9] ^ d4, 20);
  const uint64_t b7 = rotl64(a[10] ^ d0, 3);
  const uint64_t b8 = rotl64(a[16] ^ d1, 45);
  const uint64_t b9 = rotl64(a[22] ^ d2, 61);
  const uint64_t b10 = rotl64(a[1] ^ d1, 1);
  const uint64_t b11 = rotl64(a[7] ^ d2, 6);
  const uint64_t b12 = rotl64(a[13] ^ d3, 25);
  const uint64_t b13 = rotl64(a[19] ^ d4, 8);
  const uint64_t b14 = rotl64(a[20] ^ d0, 18);
  const uint64_t b15 = rotl64(a[4] ^ d4, 27);
  const uint64_t b16 = rotl64(a[5] ^ d0, 36);
  const uint64_t b17 = rotl64(a[11] ^ d1, 10);
  const uint64_t b18 = rotl64(a[17] ^ d2, 15);
  const uint64_t b19 = rotl64(a[23] ^ d3, 56);
  const uint64_t b20 = rotl64(a[2] ^ d2, 62);
  const uint64_t b21 = rotl64(a[8] ^ d3, 55);
  const uint64_t b22 = rotl64(a[14] ^ d4, 39);
  const uint64_t b23 = rotl64(a[15] ^ d0, 41);
  const uint64_t b24 = rotl64(a[21] ^ d1, 2);
  e[0] = b0 ^ (~b1 & b2) ^ rc;
  e[1] = b1 ^ (~b2 & b3);
  e[2] = b2 ^ (~b3 & b4);
  e[3] = b3 ^ (~b4 & b0);
  e[4] = b4 ^ (~b0 & b1);
  e[5] = b5 ^ (~b6 & b7);
  e[6] = b6 ^ (~b7 & b8);
  e[7] = b7 ^ (~b8 & b9);
  e[8] = b8 ^ (~b9 & b5);
  e[9] = b9 ^ (~b5 & b6);
  e[10] = b10 ^ (~b11 & b12);
  e[11] = b11 ^ (~b12 & b13);
  e[12] = b12 ^ (~b13 & b14);
  e[13] = b13 ^ (~b14 & b10);
  e[14] = b14 ^ (~b10 & b11);
  e[15] = b15 ^ (~b16 & b17);
  e[16] = b16 ^ (~b17 & b18);
  e[17] = b17 ^ (~b18 & b19);
  e[18] = b18 ^ (~b19 & b15);
  e[19] = b19 ^ (~b15 & b16);
  e[20] = b20 ^ (~b21 & b22);
  e[21] = b21 ^ (~b22 & b23);
  e[22] = b22 ^ (~b23 & b24);
  e[23] = b23 ^ (~b24 & b20);
  e[24] = b24 ^ (~b20 & b21);
}

// keccak-f[1600] on 25 lanes held by one thread: 24 rounds unrolled in
// pairs, a -> e -> a, so the lanes are renamed in place and never copied.
__host__ __device__ __forceinline__ void keccak_f1600(uint64_t (&a)[25]) {
  uint64_t e[25];
#pragma unroll
  for (int r = 0; r < 24; r += 2) {
    keccak_round(a, e, keccak_rc(r));
    keccak_round(e, a, keccak_rc(r + 1));
  }
}

// rho's rotation of lane i, and the lane whose value pi moves to lane i.
__host__ __device__ constexpr int keccak_rho(int i) {
  constexpr int rot[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
  return rot[i];
}

__host__ __device__ constexpr int keccak_pi_src(int i) {
  constexpr int src[25] = {0, 6, 12, 18, 24, 3, 9, 10, 16, 22, 1, 7, 13, 19, 20, 4, 5, 11, 17, 23, 2, 8, 14, 15, 21};
  return src[i];
}

// Rotation by an amount known only at run time (one per lane below).
__host__ __device__ __forceinline__ uint64_t rotl64_var(uint64_t x, int n) {
#if defined(__CUDA_ARCH__)
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (n & 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t nhi = __funnelshift_l(lo, hi, n), nlo = __funnelshift_l(hi, lo, n);
  return ((uint64_t)nhi << 32) | nlo;
#else
  return rotl64(x, n & 63);
#endif
}

// keccak-f[1600] with its 25 lanes spread over 25 threads, lane i = x + 5y
// on thread i; ex(v, j) returns thread j's v (on the card __shfl_sync, so
// every thread of the warp calls it, lanes 25..31 included with i < 25 of
// their choosing).  Per round: theta's column parity from four exchanges,
// its D from two, pi one, chi two.
template <class Exchange>
__host__ __device__ __forceinline__ uint64_t keccak_f1600_lane(uint64_t a, int i, Exchange& ex) {
  const int x = i % 5, y = i / 5;
  const int col1 = x + 5 * ((y + 1) % 5), col2 = x + 5 * ((y + 2) % 5);
  const int col3 = x + 5 * ((y + 3) % 5), col4 = x + 5 * ((y + 4) % 5);
  const int row1 = (x + 1) % 5 + 5 * y, row2 = (x + 2) % 5 + 5 * y, row4 = (x + 4) % 5 + 5 * y;
  const int rho = keccak_rho(i), src = keccak_pi_src(i);
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    const uint64_t c = a ^ ex(a, col1) ^ ex(a, col2) ^ ex(a, col3) ^ ex(a, col4);
    a ^= ex(c, row4) ^ rotl64(ex(c, row1), 1);
    const uint64_t b = ex(rotl64_var(a, rho), src);
    a = b ^ (~ex(b, row1) & ex(b, row2));
    if (i == 0) a ^= keccak_rc(r);
  }
  return a;
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
