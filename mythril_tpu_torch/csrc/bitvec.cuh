// 256-bit EVM word arithmetic for the tape VM, one word per thread.
//
// Ports the limb algebra of mythril_tpu/ops/bitvec.py (add, sub, mul,
// _udivmod, sdiv, srem, bvexp, shl, lshr, ashr, eq, ult, mux) at the tape's
// width of 256 bits.  The JAX package keeps 16 limbs of 16 bits because a
// TPU has no 64-bit integers; Hopper has them, so a word is four uint64_t
// and a limb product is one 64x64->128 multiply.  The tape's I/O layout
// stays 16-bit limbs (load/store below).
//
// Semantics are those of smt/concrete_eval.py exactly: x/0 == 0, signed
// division truncates, shifts saturate at >= 256, exponentiation is modular.
// The plain reference is mythril_tpu_torch/ops/bitvec.py.
#pragma once

#include <stdint.h>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace mk {

struct u256 {
  uint64_t w[4];  // little-endian 64-bit words
};

__host__ __device__ __forceinline__ u256 u256_zero() {
  u256 r;
  r.w[0] = r.w[1] = r.w[2] = r.w[3] = 0;
  return r;
}

__host__ __device__ __forceinline__ u256 u256_small(uint64_t v) {
  u256 r = u256_zero();
  r.w[0] = v;
  return r;
}

__host__ __device__ __forceinline__ bool is_zero(const u256& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

__host__ __device__ __forceinline__ bool eq(const u256& a, const u256& b) {
  return ((a.w[0] ^ b.w[0]) | (a.w[1] ^ b.w[1]) | (a.w[2] ^ b.w[2]) |
          (a.w[3] ^ b.w[3])) == 0;
}

__host__ __device__ __forceinline__ bool ult(const u256& a, const u256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  }
  return false;
}

__host__ __device__ __forceinline__ u256 add(const u256& a, const u256& b) {
  u256 r;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t s = a.w[i] + b.w[i];
    uint64_t c1 = s < a.w[i];
    uint64_t s2 = s + carry;
    uint64_t c2 = s2 < s;
    r.w[i] = s2;
    carry = c1 | c2;
  }
  return r;
}

__host__ __device__ __forceinline__ u256 sub(const u256& a, const u256& b) {
  u256 r;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t d = a.w[i] - b.w[i];
    uint64_t b1 = a.w[i] < b.w[i];
    uint64_t d2 = d - borrow;
    uint64_t b2 = d < borrow;
    r.w[i] = d2;
    borrow = b1 | b2;
  }
  return r;
}

__host__ __device__ __forceinline__ u256 neg(const u256& a) {
  return sub(u256_zero(), a);
}

__host__ __device__ __forceinline__ u256 bit_and(const u256& a, const u256& b) {
  u256 r;
  for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] & b.w[i];
  return r;
}

__host__ __device__ __forceinline__ u256 bit_or(const u256& a, const u256& b) {
  u256 r;
  for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] | b.w[i];
  return r;
}

__host__ __device__ __forceinline__ u256 bit_xor(const u256& a, const u256& b) {
  u256 r;
  for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] ^ b.w[i];
  return r;
}

__host__ __device__ __forceinline__ u256 bit_not(const u256& a) {
  u256 r;
  for (int i = 0; i < 4; ++i) r.w[i] = ~a.w[i];
  return r;
}

__host__ __device__ __forceinline__ void mul64(uint64_t a, uint64_t b,
                                               uint64_t* lo, uint64_t* hi) {
#if defined(__CUDA_ARCH__)
  *lo = a * b;
  *hi = __umul64hi(a, b);
#else
  unsigned __int128 p = (unsigned __int128)a * b;
  *lo = (uint64_t)p;
  *hi = (uint64_t)(p >> 64);
#endif
}

// Low 256 bits of a * b (EVM MUL).
__host__ __device__ __forceinline__ u256 mul(const u256& a, const u256& b) {
  u256 r = u256_zero();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 4 - i; ++j) {
      uint64_t lo, hi;
      mul64(a.w[i], b.w[j], &lo, &hi);
      uint64_t t = r.w[i + j] + lo;
      uint64_t c1 = t < lo;
      uint64_t t2 = t + carry;
      uint64_t c2 = t2 < carry;
      r.w[i + j] = t2;
      // r + lo + carry + hi * 2^64 < 2^128, so the new carry fits
      carry = hi + c1 + c2;
    }
  }
  return r;
}

// Shift amount of a 256-bit operand, saturated at 256.
__host__ __device__ __forceinline__ unsigned shift_amount(const u256& s) {
  if (s.w[1] | s.w[2] | s.w[3]) return 256;
  return s.w[0] > 256 ? 256u : (unsigned)s.w[0];
}

// Word j of a (0 outside [0, 4)) for a j known only at run time, by selects:
// indexing a.w with it would put the word in local memory.
__host__ __device__ __forceinline__ uint64_t word_at(const u256& a, int j) {
  const uint64_t lo = j == 0 ? a.w[0] : a.w[1];
  const uint64_t hi = j == 2 ? a.w[2] : a.w[3];
  return (unsigned)j > 3u ? 0 : (j < 2 ? lo : hi);
}

__host__ __device__ __forceinline__ u256 shl(const u256& a, unsigned n) {
  if (n >= 256) return u256_zero();
  const int q = n / 64;
  const unsigned s = n % 64;
  u256 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t hi = word_at(a, i - q), lo = word_at(a, i - q - 1);
    r.w[i] = (hi << s) | (s ? lo >> (64 - s) : 0);
  }
  return r;
}

__host__ __device__ __forceinline__ u256 lshr(const u256& a, unsigned n) {
  if (n >= 256) return u256_zero();
  const int q = n / 64;
  const unsigned s = n % 64;
  u256 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t lo = word_at(a, i + q), hi = word_at(a, i + q + 1);
    r.w[i] = (lo >> s) | (s ? hi << (64 - s) : 0);
  }
  return r;
}

// Arithmetic shift right of a 256-bit word: ~lshr(~a) for a negative word.
__host__ __device__ __forceinline__ u256 ashr(const u256& a, unsigned n) {
  if (a.w[3] >> 63) return bit_not(lshr(bit_not(a), n));
  return lshr(a, n);
}

// Index of the highest set bit of a nonzero word.
__host__ __device__ __forceinline__ int top_bit64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return 63 - __clzll((long long)x);
#else
  return 63 - __builtin_clzll(x);
#endif
}

__host__ __device__ __forceinline__ int highest_bit(const u256& a) {
#pragma unroll
  for (int i = 3; i >= 0; --i)
    if (a.w[i]) return i * 64 + top_bit64(a.w[i]);
  return -1;
}

// Restoring shift-subtract division over the dividend's bits, most
// significant first (bitvec.py:_udivmod); x / 0 == 0 and x % 0 == 0.
// Leading zero bits of the dividend leave quotient and remainder at zero,
// so the loop starts at its highest set bit.  The words are walked in an
// unrolled loop, so that no word is indexed at run time.
__host__ __device__ __forceinline__ void udivmod(const u256& a, const u256& b,
                                                 u256* q, u256* r) {
  *q = u256_zero();
  *r = u256_zero();
  if (is_zero(b)) return;
  bool started = false;
#pragma unroll
  for (int w = 3; w >= 0; --w) {
    const uint64_t aw = a.w[w];
    int top = 63;
    if (!started) {
      if (!aw) continue;  // a leading zero word
      top = top_bit64(aw);
      started = true;
    }
    uint64_t qw = 0;
    for (int i = top; i >= 0; --i) {
      u256 rem = shl(*r, 1);
      rem.w[0] |= (aw >> i) & 1;
      if (!ult(rem, b)) {
        rem = sub(rem, b);
        qw |= 1ULL << i;
      }
      *r = rem;
    }
    q->w[w] = qw;
  }
}

__host__ __device__ __forceinline__ bool sign_bit(const u256& a) {
  return a.w[3] >> 63;
}

__host__ __device__ __forceinline__ u256 sdiv(const u256& a, const u256& b) {
  const bool sa = sign_bit(a), sb = sign_bit(b);
  u256 q, r;
  udivmod(sa ? neg(a) : a, sb ? neg(b) : b, &q, &r);
  return (sa != sb) ? neg(q) : q;
}

__host__ __device__ __forceinline__ u256 srem(const u256& a, const u256& b) {
  const bool sa = sign_bit(a), sb = sign_bit(b);
  u256 q, r;
  udivmod(sa ? neg(a) : a, sb ? neg(b) : b, &q, &r);
  return sa ? neg(r) : r;
}

// a ** e mod 2^256, square-and-multiply over e's bits; stops after e's
// highest set bit, where the remaining squarings no longer change the result.
__host__ __device__ __forceinline__ u256 bvexp(const u256& a, const u256& e) {
  u256 result = u256_small(1), base = a;
  const int top = highest_bit(e);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int last = top - 64 * w;
    if (last < 0) break;
    const uint64_t ew = e.w[w];
    for (int j = 0; j <= (last < 63 ? last : 63); ++j) {
      if ((ew >> j) & 1) result = mul(result, base);
      if (64 * w + j < top) base = mul(base, base);
    }
  }
  return result;
}

}  // namespace mk
