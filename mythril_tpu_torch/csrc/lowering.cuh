// The per-conjunction lowering's evaluator: one candidate walks the node
// table of a compiled conjunction (ops/lowering.py:LoweringProgram).
//
// Values are 16-bit limbs in uint32 (the JAX package's layout, any width),
// bools one limb holding 0 or 1.  A value is a ref: an arena row (limb i of
// candidate b at arena[(ref + i) * B + b], so a warp reads 32 consecutive
// words per limb), or, negative, the constant at pool[-1 - ref].  The limb
// count comes from each record's widths at run time, so there is no width
// cap: multiplication scans columns straight from its operands' rows,
// division and exponentiation keep their remainder, operands and base in
// the arena's scratch rows, and shifts read their source limbs in place.
//
// Semantics are those of smt/concrete_eval.py and ops/bitvec.py: x/0 == 0
// and x%0 == 0, truncated signed division and remainder, exponentiation
// modulo 2^w, shifts by amounts of any width saturating to zero or the sign
// fill, the top limb masked after every op at widths that are not a multiple
// of 16.  The body is __host__ __device__ so that csrc/host_check.cpp builds
// it for the CPU tests.
#pragma once

#include <stdint.h>

#if !defined(__CUDACC__)
#ifndef __host__
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#endif

namespace mk {
namespace low {

enum Op : int32_t {
  ADD, SUB, MUL, UDIV, UREM, SDIV, SREM, EXP, AND, OR, XOR, NOT, NEG, SHL, LSHR, ASHR,
  CONCAT, EXTRACT, ZEXT, SEXT, EQ, ULT, ULE, SLT, SLE, ITE, LOOKUP, KECCAK,
};

// record columns (ops/lowering.py REC_INTS)
constexpr int kRecInts = 12;
enum Col { C_OP, C_W, C_OUT, C_A, C_B, C_C, C_WA, C_WB, C_AUX0, C_AUX1 };
constexpr int kTabMeta = 8;  // idx, val, valid, default offsets; K, Ld, Lr; pad
constexpr uint32_t kM = 0xFFFF;

// Mirror of ops/lowering.py LowerArgs (same field order).
struct LowerArgs {
  const int32_t* rec;       // [n, kRecInts]
  const int32_t* pool;      // constant limbs
  const int32_t* roots;     // [C] refs of the conjuncts
  const int64_t* tab_meta;  // [n_tab, kTabMeta]
  const int32_t* tabs;      // every table's idx, val, valid, default, concatenated
  int32_t* arena;           // [rows, B]
  uint8_t* truth;           // [B, C]
  int32_t B, r_begin, r_end, C, scratch, write_truth;
};

__host__ __device__ __forceinline__ int nl(int w) { return (w + 15) >> 4; }
__host__ __device__ __forceinline__ uint32_t top_mask(int w) {
  return (w & 15) ? (1u << (w & 15)) - 1 : kM;
}

// One candidate's view of the arena and the pool.
struct Cand {
  const LowerArgs& a;
  long long b, B;

  __host__ __device__ uint32_t ld(int32_t ref, int i) const {
    return ref >= 0 ? (uint32_t)a.arena[(long long)(ref + i) * B + b]
                    : (uint32_t)a.pool[-1 - ref + i];
  }
  // limb i of a value of L limbs, zero outside [0, L)
  __host__ __device__ uint32_t ldz(int32_t ref, int i, int L) const {
    return (unsigned)i < (unsigned)L ? ld(ref, i) : 0u;
  }
  __host__ __device__ void st(int32_t row, int i, uint32_t v) const {
    a.arena[(long long)(row + i) * B + b] = (int32_t)v;
  }
};

// Shift amount of an operand of Ls limbs, saturated at w (any bit at or
// above 2^32 means an amount >= w for every width).
__host__ __device__ inline uint32_t amount(const Cand& c, int32_t s, int Ls, int w) {
  bool big = false;
  for (int i = 2; i < Ls; ++i) big |= c.ld(s, i) != 0;
  uint32_t lo = c.ld(s, 0);
  if (Ls > 1) lo |= c.ld(s, 1) << 16;
  return (big || lo > (uint32_t)w) ? (uint32_t)w : lo;
}

// out[i] = bits [16i + n, 16i + n + 16) of x (L limbs, XOR-ed with inv),
// i.e. a right shift by n of the value with zeros above bit 16 L.
__host__ __device__ inline uint32_t shr_limb(const Cand& c, int32_t x, int L, uint32_t top,
                                             uint32_t inv, int i, uint32_t n) {
  const int q = (int)(n >> 4), r = (int)(n & 15);
  auto get = [&](int j) -> uint32_t {
    if ((unsigned)j >= (unsigned)L) return 0u;
    uint32_t v = c.ld(x, j) ^ inv;
    return j == L - 1 ? v & top : v;
  };
  const uint32_t lo = get(i + q), hi = r ? get(i + q + 1) << (16 - r) : 0u;
  return ((lo >> r) | hi) & kM;
}

// out[i] of x << n (x of L limbs, zeros below)
__host__ __device__ inline uint32_t shl_limb(const Cand& c, int32_t x, int L, int i, uint32_t n) {
  const int q = (int)(n >> 4), r = (int)(n & 15);
  const uint32_t hi = c.ldz(x, i - q, L) << r;
  const uint32_t lo = r ? c.ldz(x, i - q - 1, L) >> (16 - r) : 0u;
  return (hi | lo) & kM;
}

__host__ __device__ inline bool ult(const Cand& c, int32_t x, int32_t y, int L, uint32_t flip) {
  bool lt = false;
  for (int i = 0; i < L; ++i) {
    uint32_t xi = c.ld(x, i), yi = c.ld(y, i);
    if (i == L - 1) xi ^= flip, yi ^= flip;
    if (xi != yi) lt = xi < yi;
  }
  return lt;
}

__host__ __device__ inline bool is_zero(const Cand& c, int32_t x, int L) {
  uint32_t any = 0;
  for (int i = 0; i < L; ++i) any |= c.ld(x, i);
  return any == 0;
}

__host__ __device__ inline uint32_t sign_of(const Cand& c, int32_t x, int w) {
  return (c.ld(x, nl(w) - 1) >> ((w - 1) & 15)) & 1u;
}

// dst = -x at width w (dst may be x: limb by limb in place)
__host__ __device__ inline void neg_to(const Cand& c, int32_t x, int w, int32_t dst) {
  const int L = nl(w);
  uint32_t carry = 1;
  for (int i = 0; i < L; ++i) {
    const uint32_t s = (c.ld(x, i) ^ kM) + carry;
    carry = s >> 16;
    c.st(dst, i, i == L - 1 ? s & top_mask(w) : s & kM);
  }
}

// dst = low w bits of x * y, column by column (dst must not be x or y): a
// column is at most 32 products of 16-bit limbs at L = 32, below 2^37.
__host__ __device__ inline void mul_to(const Cand& c, int32_t x, int32_t y, int w, int32_t dst) {
  const int L = nl(w);
  uint64_t acc = 0;
  for (int k = 0; k < L; ++k) {
    for (int i = 0; i <= k; ++i) acc += (uint64_t)c.ld(x, i) * c.ld(y, k - i);
    c.st(dst, k, (uint32_t)(k == L - 1 ? acc & top_mask(w) : acc & kM));
    acc >>= 16;
  }
}

__host__ __device__ inline void copy_to(const Cand& c, int32_t x, int L, int32_t dst) {
  for (int i = 0; i < L; ++i) c.st(dst, i, c.ld(x, i));
}

// Restoring shift-subtract division of x by y at width w, from x's highest
// set bit down: the remainder in rows rem, the quotient in rows q (q < 0:
// not kept).  After i bits the remainder is below 2^i, so its shift never
// loses a bit.  x / 0 == 0 and x % 0 == 0.
__host__ __device__ inline void divmod(const Cand& c, int32_t x, int32_t y, int w, int32_t q,
                                       int32_t rem) {
  const int L = nl(w);
  for (int i = 0; i < L; ++i) {
    c.st(rem, i, 0);
    if (q >= 0) c.st(q, i, 0);
  }
  if (is_zero(c, y, L)) return;
  int top = -1;
  for (int i = L - 1; i >= 0 && top < 0; --i) {
    const uint32_t v = c.ld(x, i);
    if (v)
      for (int j = 15; j >= 0 && top < 0; --j)
        if ((v >> j) & 1u) top = 16 * i + j;
  }
  for (int bit = top; bit >= 0; --bit) {
    uint32_t carry = (c.ld(x, bit >> 4) >> (bit & 15)) & 1u;
    for (int i = 0; i < L; ++i) {
      const uint32_t v = c.ld(rem, i);
      c.st(rem, i, ((v << 1) | carry) & kM);
      carry = v >> 15;
    }
    if (!ult(c, rem, y, L, 0)) {
      uint32_t borrow = 0;
      for (int i = 0; i < L; ++i) {
        const uint32_t s = c.ld(rem, i) + (c.ld(y, i) ^ kM) + 1u - borrow;
        // s = r - y + 2^16 - borrow: a borrow out when below 2^16
        c.st(rem, i, s & kM);
        borrow = s >> 16 ? 0u : 1u;
      }
      if (q >= 0) c.st(q, bit >> 4, c.ld(q, bit >> 4) | (1u << (bit & 15)));
    }
  }
}

// |x| at width w: x itself, or its negation written to rows dst.
__host__ __device__ inline int32_t abs_of(const Cand& c, int32_t x, int w, int32_t dst) {
  if (!sign_of(c, x, w)) return x;
  neg_to(c, x, w, dst);
  return dst;
}

__host__ __device__ inline void lookup(const Cand& c, const int32_t* r, int L) {
  const int64_t* m = c.a.tab_meta + (long long)kTabMeta * r[C_AUX0];
  const int32_t* idx = c.a.tabs + m[0];
  const int32_t* val = c.a.tabs + m[1];
  const int32_t* valid = c.a.tabs + m[2];
  const int32_t* dflt = c.a.tabs + m[3];
  const long long K = m[4], Ld = m[5], Lr = m[6];
  long long hit = -1;
  for (long long k = 0; k < K; ++k) {
    if (!valid[c.b * K + k]) continue;
    bool same = true;
    for (int i = 0; i < Ld; ++i) same &= (uint32_t)idx[(c.b * K + k) * Ld + i] == c.ld(r[C_A], i);
    if (same) hit = k;  // the last hit wins, as in the JAX mux chain
  }
  for (int i = 0; i < L; ++i)
    c.st(r[C_OUT], i, (uint32_t)(hit >= 0 ? val[(c.b * K + hit) * Lr + i] : dflt[c.b * Lr + i]));
}

// One record for one candidate.
__host__ __device__ inline void step(const Cand& c, const int32_t* r) {
  const int w = r[C_W], L = nl(w), wa = r[C_WA];
  const uint32_t tm = top_mask(w);
  const int32_t out = r[C_OUT], x = r[C_A], y = r[C_B], z = r[C_C];
  auto put = [&](int i, uint32_t v) { c.st(out, i, i == L - 1 ? v & tm : v & kM); };
  auto flag = [&](bool v) { c.st(out, 0, v ? 1u : 0u); };
  switch (r[C_OP]) {
    case ADD:
    case SUB:
    case NEG: {
      const uint32_t inv = r[C_OP] == ADD ? 0u : kM;
      uint32_t carry = r[C_OP] == ADD ? 0u : 1u;
      for (int i = 0; i < L; ++i) {
        const uint32_t s = r[C_OP] == NEG ? (c.ld(x, i) ^ kM) + carry
                                          : c.ld(x, i) + (c.ld(y, i) ^ inv) + carry;
        carry = s >> 16;
        put(i, s);
      }
      break;
    }
    case MUL: mul_to(c, x, y, w, out); break;
    case UDIV: divmod(c, x, y, w, out, c.a.scratch); break;
    case UREM: divmod(c, x, y, w, -1, out); break;
    case SDIV:
    case SREM: {
      const int32_t s0 = c.a.scratch, s1 = s0 + L, s2 = s1 + L;
      const uint32_t sx = sign_of(c, x, w), sy = sign_of(c, y, w);
      const int32_t ax = abs_of(c, x, w, s1), ay = abs_of(c, y, w, s2);
      if (r[C_OP] == SDIV) {
        divmod(c, ax, ay, w, out, s0);
        if (sx != sy) neg_to(c, out, w, out);
      } else {
        divmod(c, ax, ay, w, -1, out);
        if (sx) neg_to(c, out, w, out);
      }
      break;
    }
    case EXP: {
      // square-and-multiply over the exponent's bits up to its highest set
      // one; the base in scratch rows s0, each product through s1
      const int32_t s0 = c.a.scratch, s1 = s0 + L;
      int top = -1;
      for (int i = L - 1; i >= 0 && top < 0; --i) {
        const uint32_t v = c.ld(y, i);
        if (v)
          for (int j = 15; j >= 0 && top < 0; --j)
            if ((v >> j) & 1u) top = 16 * i + j;
      }
      for (int i = 0; i < L; ++i) c.st(out, i, i == 0 ? 1u : 0u);
      copy_to(c, x, L, s0);
      for (int j = 0; j <= top; ++j) {
        if ((c.ld(y, j >> 4) >> (j & 15)) & 1u) {
          mul_to(c, out, s0, w, s1);
          copy_to(c, s1, L, out);
        }
        if (j < top) {
          mul_to(c, s0, s0, w, s1);
          copy_to(c, s1, L, s0);
        }
      }
      break;
    }
    case AND:
      for (int i = 0; i < L; ++i) put(i, c.ld(x, i) & c.ld(y, i));
      break;
    case OR:
      for (int i = 0; i < L; ++i) put(i, c.ld(x, i) | c.ld(y, i));
      break;
    case XOR:
      for (int i = 0; i < L; ++i) put(i, c.ld(x, i) ^ c.ld(y, i));
      break;
    case NOT:
      for (int i = 0; i < L; ++i) put(i, c.ld(x, i) ^ kM);
      break;
    case SHL: {
      const uint32_t n = amount(c, y, L, w);
      for (int i = 0; i < L; ++i) put(i, n >= (uint32_t)w ? 0u : shl_limb(c, x, L, i, n));
      break;
    }
    case LSHR:
    case ASHR: {
      const uint32_t n = amount(c, y, L, w);
      // ashr of a negative word: ~lshr(~x, n), the vacated bits filled
      const uint32_t inv = (r[C_OP] == ASHR && sign_of(c, x, w)) ? kM : 0u;
      for (int i = 0; i < L; ++i)
        put(i, (n >= (uint32_t)w ? 0u : shr_limb(c, x, L, tm, inv, i, n)) ^ inv);
      break;
    }
    case CONCAT: {
      // hi (x, width wa) above lo (y, width wb)
      const int wb = r[C_WB];
      for (int i = 0; i < L; ++i) put(i, c.ldz(y, i, nl(wb)) | shl_limb(c, x, nl(wa), i, wb));
      break;
    }
    case EXTRACT:
      for (int i = 0; i < L; ++i) put(i, shr_limb(c, x, nl(wa), top_mask(wa), 0u, i, r[C_AUX0]));
      break;
    case ZEXT:
    case SEXT: {
      const bool fill = r[C_OP] == SEXT && sign_of(c, x, wa);
      for (int i = 0; i < L; ++i) {
        uint32_t v = c.ldz(x, i, nl(wa));
        if (fill && 16 * (i + 1) > wa) v |= 16 * i >= wa ? kM : (kM << (wa - 16 * i)) & kM;
        put(i, v);
      }
      break;
    }
    case EQ: {
      uint32_t diff = 0;
      for (int i = 0; i < nl(wa); ++i) diff |= c.ld(x, i) ^ c.ld(y, i);
      flag(diff == 0);
      break;
    }
    case ULT: flag(ult(c, x, y, nl(wa), 0)); break;
    case ULE: flag(!ult(c, y, x, nl(wa), 0)); break;
    case SLT: flag(ult(c, x, y, nl(wa), 1u << ((wa - 1) & 15))); break;
    case SLE: flag(!ult(c, y, x, nl(wa), 1u << ((wa - 1) & 15))); break;
    case ITE: {
      const int32_t pick = c.ld(x, 0) ? y : z;
      for (int i = 0; i < L; ++i) c.st(out, i, c.ld(pick, i));
      break;
    }
    case LOOKUP: lookup(c, r, L); break;
    default: break;  // KECCAK: hashed by the wrapper between launches
  }
}

// Records [r_begin, r_end) for candidate b, then, in the last launch, the
// truth of every conjunct.
__host__ __device__ inline void run_candidate(const LowerArgs& a, long long b) {
  const Cand c{a, b, a.B};
  for (int32_t n = a.r_begin; n < a.r_end; ++n) step(c, a.rec + (long long)kRecInts * n);
  if (a.write_truth)
    for (int32_t k = 0; k < a.C; ++k) a.truth[b * a.C + k] = c.ld(a.roots[k], 0) != 0;
}

}  // namespace low
}  // namespace mk
