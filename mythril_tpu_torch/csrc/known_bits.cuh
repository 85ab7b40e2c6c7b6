// The known-bits abstract interpreter of the solver's prefilter: one row's
// walk over the packed tape, for the kernel (known_bits.cu) and the host
// check (host_check.cpp).
//
// Replaces the per-row body of mythril_tpu/absdomain/device.py _run (the
// jitted lax.scan over node records, lax.switch over the 31 transfer
// functions of absdomain/domains.py KB_KERNELS), bit for bit with the host
// twin domains.eval_kb_host:
//
//   * a value is 16 uint32 limbs (512 bits); (km, kv): bit j is known iff
//     km's bit j is set, and then equals kv's bit j;
//   * a missing child (index -1) reads zeros, as the host twin does (the
//     jitted twin reads node 0 instead);
//   * an op code outside the table is top;
//   * arithmetic wraps at 32 bits (the ripple carry, the popcount's
//     multiply, every complement);
//   * a row's narrowing override, where the node has one, is met after the
//     transfer function: refuted |= any(k & okm & (v ^ okv)), k |= okm,
//     v = (v | okv) & k.
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
namespace kb {

constexpr int L = 16;  // limbs of 32 bits
constexpr uint32_t ALL = 0xffffffffu;
constexpr int NODE_W = 8;  // int32 fields of a node record

// native/bitblast.py's op codes
enum Op {
  CONST, VAR, EQ, AND, OR, NOT, XOR, ITE, ADD, SUB, MUL, UDIV, UREM, SDIV, SREM, BAND, BOR, BXOR,
  BNOT, NEG, SHL, LSHR, ASHR, CONCAT, EXTRACT, ZEXT, SEXT, ULT, ULE, SLT, SLE,
};

// One pass over N nodes for R rows.  nodes: [N, 8] int32 (op, w, a0, a1, a2,
// x0, x1, override slot or -1); wm, cl: [N, 16] width masks and constant
// payloads; okm, okv: [n_ov, R, 16] the overrides; km, kv: [N, R, 16] out;
// refuted: [R] out (0/1); zero: 16 zero words, the missing child.
struct KbArgs {
  const int32_t* nodes;
  const uint32_t* wm;
  const uint32_t* cl;
  const uint32_t* okm;
  const uint32_t* okv;
  const uint32_t* zero;
  uint32_t* km;
  uint32_t* kv;
  uint8_t* refuted;
  int32_t N, R;
};

// A child's (km, kv) limbs, read in place.
struct Val {
  const uint32_t* k;
  const uint32_t* v;
};

// The node being evaluated: its scalars and its result.
struct Node {
  int32_t w, x0, x1, wa, wb;
  const uint32_t* wm;
  const uint32_t* cl;
  uint32_t k[L], v[L];
};

__host__ __device__ __forceinline__ bool fully_known(const uint32_t* km) {
  bool all = true;
#pragma unroll
  for (int l = 0; l < L; ++l) all = all && km[l] == ALL;
  return all;
}

// Bit length of a limb, 0..32.
__host__ __device__ __forceinline__ int32_t bitlen32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return 32 - __clz(x);
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

// The exact maximal bit length of a value (v <= 2^pbits - 1).
__host__ __device__ __forceinline__ int32_t pbits(Val a) {
  int32_t best = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t x = ~(a.k[l] & ~a.v[l]);  // possibly-one bits
    const int32_t per = x ? bitlen32(x) + 32 * l : 0;
    best = per > best ? per : best;
  }
  return best;
}

// Limb l of the mask of the bits strictly below n.
__host__ __device__ __forceinline__ uint32_t mask_below(int32_t n, int l) {
  int32_t k = n - 32 * l;
  k = k < 0 ? 0 : (k > 32 ? 32 : k);
  return k >= 32 ? ALL : (1u << (k & 31)) - 1u;
}

// Limb l of (src >> s) over 512 bits, src complemented first when inv
// (limbs shifted in from above are zero either way).
__host__ __device__ __forceinline__ uint32_t lshr_limb(const uint32_t* src, bool inv, uint32_t s,
                                                      int l) {
  const uint32_t ls = s >> 5, bs = s & 31u;
  const uint32_t i0 = (uint32_t)l + ls, i1 = i0 + 1;
  const uint32_t v0 = i0 < (uint32_t)L ? (inv ? ~src[i0] : src[i0]) : 0u;
  const uint32_t v1 = i1 < (uint32_t)L ? (inv ? ~src[i1] : src[i1]) : 0u;
  return (v0 >> bs) | (bs ? v1 << (32u - bs) : 0u);
}

// Limb l of (src << s) over 512 bits, as lshr_limb.
__host__ __device__ __forceinline__ uint32_t shl_limb(const uint32_t* src, bool inv, uint32_t s,
                                                     int l) {
  const int64_t ls = s >> 5;
  const uint32_t bs = s & 31u;
  const int64_t i0 = (int64_t)l - ls, i1 = i0 - 1;
  const uint32_t v0 = i0 >= 0 ? (inv ? ~src[i0] : src[i0]) : 0u;
  const uint32_t v1 = i1 >= 0 ? (inv ? ~src[i1] : src[i1]) : 0u;
  return (v0 << bs) | (bs ? v1 >> (32u - bs) : 0u);
}

// Bit pos of a value (numpy's take: a limb index of -16..-1 counts from the
// top, as pos = w - 1 < 0 would give).
__host__ __device__ __forceinline__ bool bit_at(const uint32_t* a, int32_t pos) {
  int32_t li = pos >> 5;
  if (li < 0) li += L;
  return (a[li] >> ((uint32_t)pos & 31u)) & 1u;
}

// Limb l of a + b + cin over 512 bits, as _ripple_add: the carry into limb
// l is carried through carry.
__host__ __device__ __forceinline__ uint32_t add_limb(uint32_t a, uint32_t b, uint32_t& carry) {
  const uint32_t t = a + b;
  const uint32_t c1 = t < a;
  const uint32_t s = t + carry;
  carry = c1 | (s < t);
  return s;
}

__host__ __device__ __forceinline__ void top(Node& n) {
#pragma unroll
  for (int l = 0; l < L; ++l) n.k[l] = ~n.wm[l], n.v[l] = 0;
}

// A bool node: bit 0 known iff decided, then equal to value.
__host__ __device__ __forceinline__ void bool_out(Node& n, bool decided, bool value) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    n.k[l] = ~n.wm[l] | (decided ? n.wm[l] : 0u);
    n.v[l] = decided && value ? n.wm[l] : 0u;
  }
}

// Known where the operands are fully pinned (the value in n.v), else top.
__host__ __device__ __forceinline__ void fullknown(Node& n, bool fully) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    n.k[l] = fully ? ALL : ~n.wm[l];
    n.v[l] = (fully ? n.v[l] & n.wm[l] : 0u) & n.k[l];
  }
}

// (a < b, a == b) from fully known limbs, high to low.
__host__ __device__ __forceinline__ void limb_ult(const uint32_t* va, const uint32_t* vb, bool& lt,
                                                  bool& eq) {
  lt = false, eq = true;
#pragma unroll
  for (int l = L - 1; l >= 0; --l) {
    lt = lt || (eq && va[l] < vb[l]);
    eq = eq && va[l] == vb[l];
  }
}

// (fully known?, clamped shift): any amount >= 1024 acts as 1023.
__host__ __device__ __forceinline__ uint32_t shift_amount(Val b, bool& known) {
  known = fully_known(b.k);
  bool high = false;
#pragma unroll
  for (int l = 1; l < L; ++l) high = high || b.v[l] != 0;
  const uint32_t s = high ? 1023u : b.v[0];
  return s < 1023u ? s : 1023u;
}

__host__ __device__ __forceinline__ void lshr_pair(Node& n, Val a, bool known, uint32_t s) {
  const bool zero = known && (int32_t)s >= n.w;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t km_s = ~lshr_limb(a.k, true, s, l) | ~n.wm[l];
    const uint32_t kv_s = lshr_limb(a.v, false, s, l) & n.wm[l] & km_s;
    n.k[l] = zero ? ALL : (known ? km_s : ~n.wm[l]);
    n.v[l] = zero ? 0u : (known ? kv_s : 0u);
  }
}

// One node's transfer function for one row (domains.py KB_KERNELS).
__host__ __device__ __forceinline__ void transfer(Node& n, int32_t op, Val A, Val B, Val C) {
  switch (op) {
    case CONST:
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = ALL, n.v[l] = n.cl[l];
      return;
    case EQ: {
      uint32_t conflict = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) conflict |= A.k[l] & B.k[l] & (A.v[l] ^ B.v[l]);
      const bool must_true = fully_known(A.k) && fully_known(B.k) && !conflict;
      bool_out(n, conflict || must_true, must_true);
      return;
    }
    case AND:
    case BAND:
#pragma unroll
      for (int l = 0; l < L; ++l) {
        n.k[l] = (A.k[l] & B.k[l]) | (A.k[l] & ~A.v[l]) | (B.k[l] & ~B.v[l]);
        n.v[l] = A.v[l] & B.v[l] & n.k[l];
      }
      return;
    case OR:
    case BOR:
#pragma unroll
      for (int l = 0; l < L; ++l) {
        n.k[l] = (A.k[l] & B.k[l]) | (A.k[l] & A.v[l]) | (B.k[l] & B.v[l]);
        n.v[l] = (A.v[l] | B.v[l]) & n.k[l];
      }
      return;
    case XOR:
    case BXOR:
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = A.k[l] & B.k[l], n.v[l] = (A.v[l] ^ B.v[l]) & n.k[l];
      return;
    case NOT:
    case BNOT:
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = A.k[l], n.v[l] = ~A.v[l] & A.k[l] & n.wm[l];
      return;
    case ITE: {
      const bool ck = A.k[0] & 1u, cv = A.v[0] & 1u;
      const bool then_ = ck && cv, else_ = ck && !cv;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t kmj = B.k[l] & C.k[l] & ~(B.v[l] ^ C.v[l]);
        n.k[l] = then_ ? B.k[l] : (else_ ? C.k[l] : kmj);
        n.v[l] = then_ ? B.v[l] : (else_ ? C.v[l] : B.v[l] & kmj);
      }
      return;
    }
    case ADD: {
      uint32_t carry = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) n.v[l] = add_limb(A.v[l], B.v[l], carry);
      fullknown(n, fully_known(A.k) && fully_known(B.k));
      // leading zeros: a + b < 2^(max(pa, pb) + 1)
      const int32_t pa = pbits(A), pb = pbits(B);
      const int32_t thr = (pa > pb ? pa : pb) + 1;
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] |= ~mask_below(thr, l);
      return;
    }
    case SUB: {
      uint32_t carry = 1;
#pragma unroll
      for (int l = 0; l < L; ++l) n.v[l] = add_limb(A.v[l], ~B.v[l], carry);
      fullknown(n, fully_known(A.k) && fully_known(B.k));
      return;
    }
    case MUL: {
      const int32_t pa = pbits(A), pb = pbits(B);
      const int32_t thr = (pa == 0 || pb == 0) ? 0 : (pa <= 1 ? pb : (pb <= 1 ? pa : pa + pb));
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = ~n.wm[l] | ~mask_below(thr, l), n.v[l] = 0;
      return;
    }
    case UDIV:
    case UREM: {
      const int32_t pa = pbits(A);
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = ~n.wm[l] | ~mask_below(pa, l), n.v[l] = 0;
      return;
    }
    case NEG: {
      uint32_t carry = 1;
#pragma unroll
      for (int l = 0; l < L; ++l) n.v[l] = add_limb(~A.v[l], 0u, carry);
      fullknown(n, fully_known(A.k));
      return;
    }
    case SHL: {
      bool known;
      const uint32_t s = shift_amount(B, known);
      const bool zero = known && (int32_t)s >= n.w;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t km_s = ~shl_limb(A.k, true, s, l) | ~n.wm[l];
        const uint32_t kv_s = shl_limb(A.v, false, s, l) & n.wm[l] & km_s;
        n.k[l] = zero ? ALL : (known ? km_s : ~n.wm[l]);
        n.v[l] = zero ? 0u : (known ? kv_s : 0u);
      }
      return;
    }
    case LSHR: {
      bool known;
      const uint32_t s = shift_amount(B, known);
      lshr_pair(n, A, known, s);
      return;
    }
    case ASHR: {
      // sound only when the sign bit is provably 0 (then ashr == lshr)
      const bool ok = bit_at(A.k, n.w - 1) && !bit_at(A.v, n.w - 1);
      bool known;
      const uint32_t s = shift_amount(B, known);
      lshr_pair(n, A, known, s);
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = ok ? n.k[l] : ~n.wm[l], n.v[l] = ok ? n.v[l] : 0u;
      return;
    }
    case CONCAT: {
      const uint32_t s = (uint32_t)n.wb;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t low = mask_below(n.wb, l);
        n.k[l] = (~shl_limb(A.k, true, s, l) & ~low) | (B.k[l] & low) | ~n.wm[l];
        n.v[l] = ((shl_limb(A.v, false, s, l) & ~low) | (B.v[l] & low)) & n.wm[l] & n.k[l];
      }
      return;
    }
    case EXTRACT: {
      const uint32_t s = (uint32_t)n.x1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        n.k[l] = ~lshr_limb(A.k, true, s, l) | ~n.wm[l];
        n.v[l] = lshr_limb(A.v, false, s, l) & n.wm[l] & n.k[l];
      }
      return;
    }
    case ZEXT:
#pragma unroll
      for (int l = 0; l < L; ++l) n.k[l] = A.k[l], n.v[l] = A.v[l];
      return;
    case SEXT: {
      const bool sk = bit_at(A.k, n.wa - 1), sv = bit_at(A.v, n.wa - 1);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t below = mask_below(n.wa, l), ext = n.wm[l] & ~below;
        n.k[l] = (A.k[l] & below) | ~n.wm[l] | (sk ? ext : 0u);
        n.v[l] = ((A.v[l] & below) | (sk && sv ? ext : 0u)) & n.k[l];
      }
      return;
    }
    case ULT:
    case ULE: {
      bool lt, eq;
      limb_ult(A.v, B.v, lt, eq);
      bool_out(n, fully_known(A.k) && fully_known(B.k), op == ULT ? lt : (lt || eq));
      return;
    }
    default:  // VAR, SDIV, SREM, SLT, SLE and any other code
      top(n);
      return;
  }
}

__host__ __device__ __forceinline__ Val child(const KbArgs& a, int32_t j, int32_t r) {
  if (j < 0) return Val{a.zero, a.zero};
  const int64_t at = ((int64_t)j * a.R + r) * L;
  return Val{a.km + at, a.kv + at};
}

// Row r's walk over every node, in order: each node reads its children's
// results (written earlier in this walk) and writes its own.
__host__ __device__ __forceinline__ void run_row(const KbArgs& a, int32_t r) {
  bool refuted = false;
  for (int32_t i = 0; i < a.N; ++i) {
    const int32_t* rec = a.nodes + (int64_t)NODE_W * i;
    Node n;
    n.w = rec[1], n.x0 = rec[5], n.x1 = rec[6];
    n.wa = rec[2] >= 0 ? a.nodes[(int64_t)NODE_W * rec[2] + 1] : 0;
    n.wb = rec[3] >= 0 ? a.nodes[(int64_t)NODE_W * rec[3] + 1] : 0;
    n.wm = a.wm + (int64_t)L * i;
    n.cl = a.cl + (int64_t)L * i;
    transfer(n, rec[0], child(a, rec[2], r), child(a, rec[3], r), child(a, rec[4], r));
    if (rec[7] >= 0) {
      const int64_t at = ((int64_t)rec[7] * a.R + r) * L;
      const uint32_t* om = a.okm + at;
      const uint32_t* ov = a.okv + at;
      uint32_t clash = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        clash |= n.k[l] & om[l] & (n.v[l] ^ ov[l]);
        n.k[l] |= om[l];
        n.v[l] = (n.v[l] | ov[l]) & n.k[l];
      }
      refuted = refuted || clash;
    }
    uint32_t* k = a.km + ((int64_t)i * a.R + r) * L;
    uint32_t* v = a.kv + ((int64_t)i * a.R + r) * L;
#pragma unroll
    for (int l = 0; l < L; ++l) k[l] = n.k[l], v[l] = n.v[l];
  }
  a.refuted[r] = refuted;
}

}  // namespace kb
}  // namespace mk
