// The per-conjunction lowering's evaluator: one candidate's pass over the
// node table of a compiled conjunction (ops/lowering.py:LoweringProgram),
// level by level, each record taken by one warp with its limbs across the
// warp's lanes.
//
// Values are 16-bit limbs in uint32 (the JAX package's layout, any width),
// bools one limb holding 0 or 1.  A value is a ref: a row of the
// candidate's values (limb i of row r at v[(r + i) * stride]: shared memory,
// stride 1, or the global [rows, B] arena, stride B), or, negative, the
// constant at pool[-1 - ref].  The limb count comes from each record's
// widths at run time, so there is no width cap: a record wider than 32 limbs
// loops over chunks of 32, the carries passed from chunk to chunk.
//
// Semantics are those of smt/concrete_eval.py and ops/bitvec.py: x/0 == 0
// and x%0 == 0, truncated signed division and remainder, exponentiation
// modulo 2^w, shifts by amounts of any width saturating to zero or the sign
// fill, the top limb masked after every op at widths that are not a multiple
// of 16.  Keccak hashes the big-endian bytes of its operand (keccak padding,
// one permutation per 136-byte rate block) as ops/keccak_torch.py does.
//
// The warp code is written against an executor W (the card's warp in
// lowering.cu, a loop over 32 host lanes in host_check.cpp):
//   W::each(f)        a lane value: f(l) on every lane l;
//   W::run(f)         f(l) on every lane, for its stores;
//   W::ballot(p)      the mask of lanes whose p is true;
//   W::shfl(x, src)   lane l gets x of lane src(l); W::at(x, j): x of lane j;
//   W::permute(a)     keccak-f[1600] on the lanes 0..24 of a.
// A lane value x is read as x[l] inside f, l the lane running f.  Everything
// is __host__ __device__ so that csrc/host_check.cpp builds it for the CPU
// tests.
#pragma once

#include <stdint.h>

#include "keccak.cuh"

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
enum Col { C_OP, C_W, C_OUT, C_A, C_B, C_C, C_WA, C_WB, C_AUX0, C_AUX1, C_SCR };
constexpr int kInCols = 4;   // per input: pointer, ints per candidate, limbs, first row
constexpr int kTabCols = 8;  // per table: idx, val, valid, default pointers; K, Ld, Lr; staged at
constexpr int kWarp = 32;
constexpr int kRate = 136;  // keccak-256's rate in bytes
constexpr uint32_t kM = 0xFFFF;

// Mirror of ops/lowering.py LowerArgs (same field order).
struct LowerArgs {
  const int32_t* rec;     // [n_rec, kRecInts], ordered by level
  const int32_t* level;   // [n_levels + 1] each level's first record
  const int32_t* pool;    // constant limbs
  const int32_t* roots;   // [C] refs of the conjuncts
  const int64_t* inputs;  // [n_in, kInCols] the packed candidates
  const int64_t* tabs;    // [n_tab, kTabCols] the packed array tables
  int32_t* arena;         // [rows, B]: the values (in_smem 0), or a copy of them, or null
  uint8_t* truth;         // [B, C]
  int32_t B, C, n_rec, n_levels, rows, n_pool, n_in, n_tab, smem_words, in_smem;
};

__host__ __device__ __forceinline__ int nl(int w) { return (w + 15) >> 4; }
__host__ __device__ __forceinline__ uint32_t top_mask(int w) {
  return (w & 15) ? (1u << (w & 15)) - 1 : kM;
}
__host__ __device__ __forceinline__ int hi_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}
template <class T>
__host__ __device__ __forceinline__ T* ptr(int64_t p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

// One candidate's values and the pool.
struct Vals {
  int32_t* v;          // row r at v[r * stride]
  long long stride;
  const int32_t* pool;
  int32_t* copy;       // the global arena's column of this candidate (stride B), or null
  long long B;

  __host__ __device__ uint32_t ld(int32_t ref, int i) const {
    return ref >= 0 ? (uint32_t)v[(long long)(ref + i) * stride] : (uint32_t)pool[-1 - ref + i];
  }
  // limb i of a value of L limbs, zero outside [0, L)
  __host__ __device__ uint32_t ldz(int32_t ref, int i, int L) const {
    return (unsigned)i < (unsigned)L ? ld(ref, i) : 0u;
  }
  __host__ __device__ void st(int32_t row, int i, uint32_t x) const {
    v[(long long)(row + i) * stride] = (int32_t)x;
    if (copy) copy[(long long)(row + i) * B] = (int32_t)x;
  }
};

// A candidate's rows of one array table.
struct Tab {
  const int32_t *idx, *val, *valid, *dflt;
  int K, Ld, Lr;
};

__host__ __device__ inline Tab table(const LowerArgs& a, const int32_t* smem, long long b, int t) {
  const int64_t* m = a.tabs + (long long)kTabCols * t;
  const int K = (int)m[4], Ld = (int)m[5], Lr = (int)m[6];
  if (a.in_smem) {
    const int32_t* s = smem + m[7];
    return {s, s + K * Ld, s + K * (Ld + Lr), s + K * (Ld + Lr + 1), K, Ld, Lr};
  }
  return {ptr<const int32_t>(m[0]) + b * K * Ld, ptr<const int32_t>(m[1]) + b * K * Lr,
          ptr<const int32_t>(m[2]) + b * K, ptr<const int32_t>(m[3]) + b * Lr, K, Ld, Lr};
}

// A candidate's view: its values, and the node table it walks.
struct Cand {
  Vals c;
  const int32_t* rec;
  const int32_t* level;
};

__host__ __device__ inline void copy_words(int32_t* dst, const int32_t* src, long long n, int t,
                                           int nt) {
  for (long long e = t; e < n; e += nt) dst[e] = src[e];
}

// Thread t of nt: the candidate's inputs into its value rows and, on the
// shared-memory route, the pool, its table rows, the level offsets and the
// records into shared memory (values at [0, rows), the pool at rows, each
// table at its offset, the node table last).  The caller synchronises
// before any record reads them.
__host__ __device__ inline Cand stage(const LowerArgs& a, int32_t* smem, long long b, int t,
                                     int nt) {
  const int32_t rec_at = a.smem_words - a.n_rec * kRecInts, level_at = rec_at - a.n_levels - 1;
  const Cand w = a.in_smem ? Cand{{smem, 1, smem + a.rows, a.arena ? a.arena + b : nullptr, a.B},
                                  smem + rec_at, smem + level_at}
                           : Cand{{a.arena + b, a.B, a.pool, nullptr, a.B}, a.rec, a.level};
  for (int j = 0; j < a.n_in; ++j) {
    const int64_t* m = a.inputs + (long long)kInCols * j;
    const int32_t* src = ptr<const int32_t>(m[0]) + b * m[1];
    for (int e = t; e < m[2]; e += nt) w.c.st((int32_t)m[3], e, (uint32_t)src[e]);
  }
  if (!a.in_smem) return w;
  copy_words(smem + a.rows, a.pool, a.n_pool, t, nt);
  for (int j = 0; j < a.n_tab; ++j) {
    const int64_t* m = a.tabs + (long long)kTabCols * j;
    const long long K = m[4], Ld = m[5], Lr = m[6];
    int32_t* s = smem + m[7];
    copy_words(s, ptr<const int32_t>(m[0]) + b * K * Ld, K * Ld, t, nt);
    copy_words(s + K * Ld, ptr<const int32_t>(m[1]) + b * K * Lr, K * Lr, t, nt);
    copy_words(s + K * (Ld + Lr), ptr<const int32_t>(m[2]) + b * K, K, t, nt);
    copy_words(s + K * (Ld + Lr + 1), ptr<const int32_t>(m[3]) + b * Lr, Lr, t, nt);
  }
  copy_words(smem + level_at, a.level, a.n_levels + 1, t, nt);
  copy_words(smem + rec_at, a.rec, (long long)a.n_rec * kRecInts, t, nt);
  return w;
}

// ---------------------------------------------------------------------------
// Scalar code: division and exponentiation, run by one lane of the warp
// ---------------------------------------------------------------------------

__host__ __device__ inline bool ult(const Vals& c, int32_t x, int32_t y, int L, uint32_t flip) {
  bool lt = false;
  for (int i = 0; i < L; ++i) {
    uint32_t xi = c.ld(x, i), yi = c.ld(y, i);
    if (i == L - 1) xi ^= flip, yi ^= flip;
    if (xi != yi) lt = xi < yi;
  }
  return lt;
}

__host__ __device__ inline bool is_zero(const Vals& c, int32_t x, int L) {
  uint32_t any = 0;
  for (int i = 0; i < L; ++i) any |= c.ld(x, i);
  return any == 0;
}

__host__ __device__ inline uint32_t sign_of(const Vals& c, int32_t x, int w) {
  return (c.ld(x, nl(w) - 1) >> ((w - 1) & 15)) & 1u;
}

// dst = -x at width w (dst may be x: limb by limb in place)
__host__ __device__ inline void neg_to(const Vals& c, int32_t x, int w, int32_t dst) {
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
__host__ __device__ inline void mul_to(const Vals& c, int32_t x, int32_t y, int w, int32_t dst) {
  const int L = nl(w);
  uint64_t acc = 0;
  for (int k = 0; k < L; ++k) {
    for (int i = 0; i <= k; ++i) acc += (uint64_t)c.ld(x, i) * c.ld(y, k - i);
    c.st(dst, k, (uint32_t)(k == L - 1 ? acc & top_mask(w) : acc & kM));
    acc >>= 16;
  }
}

__host__ __device__ inline void copy_to(const Vals& c, int32_t x, int L, int32_t dst) {
  for (int i = 0; i < L; ++i) c.st(dst, i, c.ld(x, i));
}

// Restoring shift-subtract division of x by y at width w, from x's highest
// set bit down: the remainder in rows rem, the quotient in rows q (q < 0:
// not kept).  After i bits the remainder is below 2^i, so its shift never
// loses a bit.  x / 0 == 0 and x % 0 == 0.
__host__ __device__ inline void divmod(const Vals& c, int32_t x, int32_t y, int w, int32_t q,
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
__host__ __device__ inline int32_t abs_of(const Vals& c, int32_t x, int w, int32_t dst) {
  if (!sign_of(c, x, w)) return x;
  neg_to(c, x, w, dst);
  return dst;
}

// UDIV, UREM, SDIV, SREM and EXP, the record's scratch rows at r[C_SCR].
__host__ __device__ inline void scalar_step(const Vals& c, const int32_t* r) {
  const int w = r[C_W], L = nl(w);
  const int32_t out = r[C_OUT], x = r[C_A], y = r[C_B], s0 = r[C_SCR];
  switch (r[C_OP]) {
    case UDIV: divmod(c, x, y, w, out, s0); break;
    case UREM: divmod(c, x, y, w, -1, out); break;
    case SDIV:
    case SREM: {
      const int32_t s1 = s0 + L, s2 = s1 + L;
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
    default: {  // EXP: square-and-multiply over the exponent's bits up to its
                // highest set one; the base in scratch rows s0, each product through s1
      const int32_t s1 = s0 + L;
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
  }
}

// ---------------------------------------------------------------------------
// Warp code: a record's limbs across the lanes
// ---------------------------------------------------------------------------

// out[i] = bits [16i + n, 16i + n + 16) of x (L limbs, XOR-ed with inv),
// i.e. a right shift by n of the value with zeros above bit 16 L.
__host__ __device__ inline uint32_t shr_limb(const Vals& c, int32_t x, int L, uint32_t top,
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
__host__ __device__ inline uint32_t shl_limb(const Vals& c, int32_t x, int L, int i, uint32_t n) {
  const int q = (int)(n >> 4), r = (int)(n & 15);
  const uint32_t hi = c.ldz(x, i - q, L) << r;
  const uint32_t lo = r ? c.ldz(x, i - q - 1, L) >> (16 - r) : 0u;
  return (hi | lo) & kM;
}

// The limbs of sum_l t[l] 2^(16 l) + carry on a chunk of 32 limbs (each
// t[l] below 2^63); carry becomes what passes to the next chunk.  Each lane
// first hands its bits above 16 to the next lane until every lane holds at
// most 2^16, then one ballot pair resolves the remaining one-bit carries
// as a 32-bit addition: lane l generates when it holds 2^16 and propagates
// when it holds 0xFFFF.
template <class W, class T>
__host__ __device__ inline auto carry_limbs(const W& w, const T& t0, uint64_t& carry) {
  auto t = w.each([&](int l) { return t0[l] + (l == 0 ? carry : 0); });
  carry = 0;
  while (w.ballot(w.each([&](int l) { return t[l] > 0x10000u; }))) {
    const auto hi = w.each([&](int l) { return t[l] >> 16; });
    carry += w.at(hi, kWarp - 1);
    const auto below = w.shfl(hi, [](int l) { return l > 0 ? l - 1 : 0; });
    t = w.each([&](int l) { return (t[l] & kM) + (l > 0 ? below[l] : 0); });
  }
  const uint32_t g = w.ballot(w.each([&](int l) { return t[l] > kM; }));
  const uint32_t p = w.ballot(w.each([&](int l) { return t[l] == kM; }));
  const uint64_t prop = (uint64_t)(g | p), sum = prop + g;
  const uint32_t in = (uint32_t)(sum ^ prop ^ g);  // the carry into each lane
  carry += sum >> 32;
  return w.each([&](int l) { return (uint32_t)((t[l] + ((in >> l) & 1u)) & kM); });
}

// x < y over L limbs (the top limb's sign bit flipped for a signed
// compare): the highest differing limb decides, found by ballot from the
// highest chunk down.
template <class W>
__host__ __device__ inline bool ult_w(const W& w, const Vals& c, int32_t x, int32_t y, int L,
                                      uint32_t flip) {
  for (int c0 = (L - 1) / kWarp * kWarp; c0 >= 0; c0 -= kWarp) {
    const auto d = w.each([&](int l) -> int {  // 0 equal, 1 below, 2 above
      const int i = c0 + l;
      if (i >= L) return 0;
      uint32_t xi = c.ld(x, i), yi = c.ld(y, i);
      if (i == L - 1) xi ^= flip, yi ^= flip;
      return xi == yi ? 0 : xi < yi ? 1 : 2;
    });
    const uint32_t ne = w.ballot(w.each([&](int l) { return d[l] != 0; }));
    const uint32_t lt = w.ballot(w.each([&](int l) { return d[l] == 1; }));
    if (ne) return (lt >> hi_bit(ne)) & 1u;
  }
  return false;
}

// Shift amount of an operand of Ls limbs, saturated at w (any bit at or
// above 2^32 means an amount >= w for every width).
template <class W>
__host__ __device__ inline uint32_t amount(const W& w, const Vals& c, int32_t s, int Ls, int wd) {
  uint32_t big = 0;
  for (int c0 = 0; c0 < Ls; c0 += kWarp)
    big |= w.ballot(w.each([&](int l) {
      const int i = c0 + l;
      return i >= 2 && i < Ls && c.ld(s, i) != 0;
    }));
  uint32_t lo = c.ld(s, 0);
  if (Ls > 1) lo |= c.ld(s, 1) << 16;
  return (big || lo > (uint32_t)wd) ? (uint32_t)wd : lo;
}

// The keys across the lanes, the highest valid hit winning (the last hit
// of the JAX mux chain), then the hit's value or the default.
template <class W>
__host__ __device__ inline void lookup(const W& w, const Vals& c, const Tab& t, const int32_t* r,
                                       int L) {
  const int32_t x = r[C_A], out = r[C_OUT];
  int hit = -1;
  for (int k0 = 0; k0 < t.K; k0 += kWarp) {
    const uint32_t h = w.ballot(w.each([&](int l) {
      const int k = k0 + l;
      if (k >= t.K || !t.valid[k]) return false;
      bool same = true;
      for (int i = 0; i < t.Ld; ++i) same &= (uint32_t)t.idx[k * t.Ld + i] == c.ld(x, i);
      return same;
    }));
    if (h) hit = k0 + hi_bit(h);
  }
  const int32_t* src = hit >= 0 ? t.val + hit * t.Lr : t.dflt;
  for (int c0 = 0; c0 < L; c0 += kWarp)
    w.run([&](int l) {
      if (c0 + l < L) c.st(out, c0 + l, (uint32_t)src[c0 + l]);
    });
}

// keccak-256 of the operand's big-endian bytes: lanes 0..16 absorb one
// 64-bit word of each rate block, the warp permutes, lanes 0..15 squeeze
// one limb of the digest each.
template <class W>
__host__ __device__ inline void keccak(const W& w, const Vals& c, const int32_t* r) {
  const int32_t x = r[C_A], out = r[C_OUT];
  const int n = r[C_WA] / 8, blocks = n / kRate + 1;
  auto st = w.each([](int) { return (uint64_t)0; });
  for (int blk = 0; blk < blocks; ++blk) {
    st = w.each([&](int l) -> uint64_t {
      if (l >= kRate / 8) return st[l];
      uint64_t word = 0;
      for (int u = 0; u < 8; ++u) {
        const int p = blk * kRate + 8 * l + u;  // message byte p: the value's byte n - 1 - p
        uint32_t byte = 0;
        if (p < n) byte = (c.ld(x, (n - 1 - p) >> 1) >> (8 * ((n - 1 - p) & 1))) & 0xFFu;
        if (p == n) byte |= 0x01u;
        if (p == blocks * kRate - 1) byte |= 0x80u;
        word |= (uint64_t)byte << (8 * u);
      }
      return st[l] ^ word;
    });
    st = w.permute(st);
  }
  // digest limb i: bytes of lane 3 - i / 4, the word read big-endian
  const auto word = w.shfl(st, [](int l) { return 3 - ((l >> 2) & 3); });
  w.run([&](int l) {
    if (l < 16) c.st(out, l, (uint32_t)(bswap64(word[l]) >> (16 * (l & 3))) & kM);
  });
}

// One record, by one warp.
template <class W>
__host__ __device__ inline void record(const W& w, const LowerArgs& a, const Vals& c,
                                       const int32_t* smem, long long b, const int32_t* r) {
  const int op = r[C_OP], wd = r[C_W], L = nl(wd), wa = r[C_WA];
  const uint32_t tm = top_mask(wd);
  const int32_t out = r[C_OUT], x = r[C_A], y = r[C_B], z = r[C_C];
  auto put = [&](int i, uint32_t v) { c.st(out, i, i == L - 1 ? v & tm : v & kM); };
  // every limb i < L of the result, f(i) by the lane that holds it
  auto limbs = [&](auto f) {
    for (int c0 = 0; c0 < L; c0 += kWarp)
      w.run([&](int l) {
        if (c0 + l < L) put(c0 + l, f(c0 + l));
      });
  };
  auto flag = [&](bool v) {
    w.run([&](int l) {
      if (l == 0) c.st(out, 0, v ? 1u : 0u);
    });
  };
  switch (op) {
    case ADD:
    case SUB:
    case NEG:
    case MUL: {
      // per lane its limb's sum (or its product column), then the carries
      const uint32_t inv = op == ADD ? 0u : kM;
      uint64_t carry = op == SUB || op == NEG ? 1u : 0u;
      for (int c0 = 0; c0 < L; c0 += kWarp) {
        const auto t = w.each([&](int l) -> uint64_t {
          const int k = c0 + l;
          if (k >= L) return 0;
          if (op == NEG) return c.ld(x, k) ^ kM;
          if (op != MUL) return (uint64_t)c.ld(x, k) + (c.ld(y, k) ^ inv);
          uint64_t acc = 0;
          for (int i = 0; i <= k; ++i) acc += (uint64_t)c.ld(x, i) * c.ld(y, k - i);
          return acc;
        });
        const auto s = carry_limbs(w, t, carry);
        w.run([&](int l) {
          if (c0 + l < L) put(c0 + l, s[l]);
        });
      }
      break;
    }
    case UDIV:
    case UREM:
    case SDIV:
    case SREM:
    case EXP:
      w.run([&](int l) {
        if (l == 0) scalar_step(c, r);
      });
      break;
    case AND: limbs([&](int i) { return c.ld(x, i) & c.ld(y, i); }); break;
    case OR: limbs([&](int i) { return c.ld(x, i) | c.ld(y, i); }); break;
    case XOR: limbs([&](int i) { return c.ld(x, i) ^ c.ld(y, i); }); break;
    case NOT: limbs([&](int i) { return c.ld(x, i) ^ kM; }); break;
    case SHL: {
      const uint32_t n = amount(w, c, y, L, wd);
      limbs([&](int i) { return n >= (uint32_t)wd ? 0u : shl_limb(c, x, L, i, n); });
      break;
    }
    case LSHR:
    case ASHR: {
      const uint32_t n = amount(w, c, y, L, wd);
      // ashr of a negative word: ~lshr(~x, n), the vacated bits filled
      const uint32_t inv = (op == ASHR && sign_of(c, x, wd)) ? kM : 0u;
      limbs([&](int i) {
        return (n >= (uint32_t)wd ? 0u : shr_limb(c, x, L, tm, inv, i, n)) ^ inv;
      });
      break;
    }
    case CONCAT: {
      // hi (x, width wa) above lo (y, width wb)
      const int wb = r[C_WB];
      limbs([&](int i) { return c.ldz(y, i, nl(wb)) | shl_limb(c, x, nl(wa), i, wb); });
      break;
    }
    case EXTRACT:
      limbs([&](int i) { return shr_limb(c, x, nl(wa), top_mask(wa), 0u, i, r[C_AUX0]); });
      break;
    case ZEXT:
    case SEXT: {
      const bool fill = op == SEXT && sign_of(c, x, wa);
      limbs([&](int i) {
        uint32_t v = c.ldz(x, i, nl(wa));
        if (fill && 16 * (i + 1) > wa) v |= 16 * i >= wa ? kM : (kM << (wa - 16 * i)) & kM;
        return v;
      });
      break;
    }
    case EQ: {
      const int La = nl(wa);
      uint32_t diff = 0;
      for (int c0 = 0; c0 < La; c0 += kWarp)
        diff |= w.ballot(w.each([&](int l) {
          const int i = c0 + l;
          return i < La && c.ld(x, i) != c.ld(y, i);
        }));
      flag(diff == 0);
      break;
    }
    case ULT: flag(ult_w(w, c, x, y, nl(wa), 0)); break;
    case ULE: flag(!ult_w(w, c, y, x, nl(wa), 0)); break;
    case SLT: flag(ult_w(w, c, x, y, nl(wa), 1u << ((wa - 1) & 15))); break;
    case SLE: flag(!ult_w(w, c, y, x, nl(wa), 1u << ((wa - 1) & 15))); break;
    case ITE: {
      const int32_t pick = c.ld(x, 0) ? y : z;
      for (int c0 = 0; c0 < L; c0 += kWarp)
        w.run([&](int l) {
          if (c0 + l < L) c.st(out, c0 + l, c.ld(pick, c0 + l));
        });
      break;
    }
    case LOOKUP: lookup(w, c, table(a, smem, b, r[C_AUX0]), r, L); break;
    case KECCAK: keccak(w, c, r); break;
    default: break;
  }
}

// The records of every level for one candidate: warp wi of nw takes records
// wi, wi + nw, ... of a level; sync() (the block's barrier) ends the level,
// so a record reads only values of lower levels, all written.
template <class W, class Sync>
__host__ __device__ inline void run_levels(const W& w, Sync sync, const LowerArgs& a,
                                           const Cand& cand, const int32_t* smem, long long b,
                                           int wi, int nw) {
  for (int lv = 0; lv < a.n_levels; ++lv) {
    for (int n = cand.level[lv] + wi; n < cand.level[lv + 1]; n += nw)
      record(w, a, cand.c, smem, b, cand.rec + (long long)kRecInts * n);
    sync();
  }
}

// Thread t of nt: the truth of every conjunct.
__host__ __device__ inline void finish(const LowerArgs& a, const Vals& c, long long b, int t,
                                       int nt) {
  for (int k = t; k < a.C; k += nt) a.truth[b * a.C + k] = c.ld(a.roots[k], 0) != 0;
}

}  // namespace low
}  // namespace mk
