// The known-bits abstract interpreter of the solver's prefilter: one row's
// pass over the packed tape, level by level, each node taken by a group of
// 16 lanes with its limbs across them; for the kernel (known_bits.cu) and
// the host check (host_check.cpp).
//
// Replaces the per-row body of mythril_tpu/absdomain/device.py _run (the
// jitted lax.scan over node records, lax.switch over the 31 transfer
// functions of absdomain/domains.py KB_KERNELS), bit for bit with the host
// twin domains.eval_kb_host:
//
//   * a value is 16 uint32 limbs (512 bits); (km, kv): bit j is known iff
//     km's bit j is set, and then equals kv's bit j;
//   * a missing child (index -1) reads zeros, as the host twin does (the
//     jitted twin reads node 0 instead); so does a child at or after its
//     node, which the host twin reads before it is written;
//   * an op code outside the table is top;
//   * arithmetic wraps at 32 bits (the ripple carry, every complement);
//   * a row's narrowing override, where the node has one, is met after the
//     transfer function: refuted |= any(k & okm & (v ^ okv)), k |= okm,
//     v = (v | okv) & k.
//
// The order: absdomain/device.py level_plan lists the nodes by dependency
// level (a node's children all lie at lower levels) and gives each level's
// first position; the nodes of one level are independent.  Results are
// stored at the node's own index.
//
// The group code is written against an executor W of 16 lanes (half a warp
// in known_bits.cu, a loop over 16 host lanes in host_check.cpp); lane l
// holds limb l:
//   W::each(f)        a lane value: f(l) on every lane l;
//   W::run(f)         f(l) on every lane, for its stores;
//   W::ballot(p)      the mask of lanes whose p is true (bit l: lane l);
//   W::shfl(x, src)   lane l gets x of lane src(l), src(l) in [0, 16);
//   W::at(x, j)       x of lane j, on every lane.
// A lane value x is read as x[l] inside f, l the lane running f.  The
// cross-limb steps of the transfer functions are votes and shuffles: the
// fully-known test an AND vote, EQ's conflict an OR vote, the maximal bit
// length the highest lane with a possibly-one bit, the compares ballots
// from the top limb down, the ripple carry a generate/propagate resolution,
// the shifts shuffles from the source lanes.  Everything is
// __host__ __device__ so that csrc/host_check.cpp builds it for the CPU tests.
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
namespace kb {

constexpr int L = 16;  // limbs of 32 bits, one a lane
constexpr uint32_t ALL = 0xffffffffu;
constexpr uint32_t kLanes = 0xffffu;  // every lane of a group
constexpr int NODE_W = 8;             // int32 fields of a node record
constexpr int kThreads = 512;         // a block: one row
constexpr int kGroups = kThreads / L; // nodes of a level in flight

// native/bitblast.py's op codes
enum Op {
  CONST, VAR, EQ, AND, OR, NOT, XOR, ITE, ADD, SUB, MUL, UDIV, UREM, SDIV, SREM, BAND, BOR, BXOR,
  BNOT, NEG, SHL, LSHR, ASHR, CONCAT, EXTRACT, ZEXT, SEXT, ULT, ULE, SLT, SLE,
};

// A staged node record, in level order: its index, op, width, children
// (-1 where missing or not before the node), x1, override slot, and the
// widths of its first two children.
enum Field { Q_I, Q_OP, Q_W, Q_A0, Q_A1, Q_A2, Q_X1, Q_OV, Q_WA, Q_WB, KREC };

// One pass over N nodes for R rows.  nodes: [N, 8] int32 (op, w, a0, a1, a2,
// x0, x1, override slot or -1); wm, cl: [N, 16] width masks and constant
// payloads; okm, okv: [n_ov, R, 16] the overrides; plan: [N] the node
// indices by level, then [n_levels + 1] each level's first position; km,
// kv: [N, R, 16] out; refuted: [R] out (0/1); zero: 16 zero words, the
// missing child on the global route.  in_smem: the row's values in shared
// memory (else in km and kv themselves); smem_words: the block's shared
// memory, laid out as stage() lays it (absdomain/device.py smem_words).
struct KbArgs {
  const int32_t* nodes;
  const uint32_t* wm;
  const uint32_t* cl;
  const uint32_t* okm;
  const uint32_t* okv;
  const uint32_t* zero;
  const int32_t* plan;
  uint32_t* km;
  uint32_t* kv;
  uint8_t* refuted;
  int32_t N, R, n_levels, in_smem, smem_words;
};

// Bit length of a limb, 0..32.
__host__ __device__ __forceinline__ int32_t bitlen32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return 32 - __clz(x);
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

__host__ __device__ __forceinline__ int hi_bit(uint32_t m) { return bitlen32(m) - 1; }

// A read-only input word.
__host__ __device__ __forceinline__ uint32_t ldg(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// Limb l of the mask of the bits strictly below n.
__host__ __device__ __forceinline__ uint32_t mask_below(int32_t n, int l) {
  int32_t k = n - 32 * l;
  k = k < 0 ? 0 : (k > 32 ? 32 : k);
  return k >= 32 ? ALL : (1u << (k & 31)) - 1u;
}

// ---------------------------------------------------------------------------
// The cross-limb steps
// ---------------------------------------------------------------------------

// Every limb all ones (the AND vote of the fully-known test).
template <class W, class X>
__host__ __device__ __forceinline__ bool all_ones(const W& w, const X& x) {
  return w.ballot(w.each([&](int l) { return x[l] == ALL; })) == kLanes;
}

// Some limb not zero (the OR vote).
template <class W, class X>
__host__ __device__ __forceinline__ bool any_set(const W& w, const X& x) {
  return w.ballot(w.each([&](int l) { return x[l] != 0u; })) != 0u;
}

// The bit length of a 512-bit value: the highest lane with a bit set.
template <class W, class X>
__host__ __device__ __forceinline__ int32_t bit_length(const W& w, const X& x) {
  const uint32_t m = w.ballot(w.each([&](int l) { return x[l] != 0u; }));
  if (!m) return 0;
  const int top = hi_bit(m);
  return bitlen32(w.at(x, top)) + 32 * top;
}

// The exact maximal bit length of a (k, v) value (v <= 2^pbits - 1): the
// bit length of its possibly-one bits.
template <class W, class K, class V>
__host__ __device__ __forceinline__ int32_t pbits(const W& w, const K& k, const V& v) {
  return bit_length(w, w.each([&](int l) -> uint32_t { return ~(k[l] & ~v[l]); }));
}

// (a < b, a == b) over 512 bits: the highest differing limb decides.
template <class W, class A, class B>
__host__ __device__ __forceinline__ void ult_eq(const W& w, const A& a, const B& b, bool& lt,
                                                bool& eq) {
  const uint32_t ne = w.ballot(w.each([&](int l) { return a[l] != b[l]; }));
  const uint32_t below = w.ballot(w.each([&](int l) { return a[l] < b[l]; }));
  eq = ne == 0u;
  lt = !eq && ((below >> hi_bit(ne)) & 1u);
}

// a + b + cin over 512 bits, the carry out of the top limb dropped, as
// _ripple_add: lane l generates when a + b wraps and propagates when it is
// all ones, and the carries into the lanes come out of one 16-bit addition.
template <class W, class A, class B>
__host__ __device__ __forceinline__ auto add_lanes(const W& w, const A& a, const B& b,
                                                   uint32_t cin) {
  const auto t = w.each([&](int l) -> uint32_t { return a[l] + b[l]; });
  const uint32_t g = w.ballot(w.each([&](int l) { return t[l] < a[l]; }));
  const uint32_t p = w.ballot(w.each([&](int l) { return t[l] == ALL; }));
  const uint32_t prop = g | p, in = (prop + g + cin) ^ prop ^ g;
  return w.each([&](int l) -> uint32_t { return t[l] + ((in >> l) & 1u); });
}

// Limb l of (x << s) over 512 bits, zeros shifted in.
template <class W, class X>
__host__ __device__ __forceinline__ auto shl_lanes(const W& w, const X& x, uint32_t s) {
  const int ls = (s >> 5) < 16u ? (int)(s >> 5) : 16;
  const uint32_t bs = s & 31u;
  const auto v0 = w.shfl(x, [&](int l) { return (l - ls) & 15; });
  const auto v1 = w.shfl(x, [&](int l) { return (l - ls - 1) & 15; });
  return w.each([&](int l) -> uint32_t {
    const uint32_t lo = l - ls >= 0 ? v0[l] : 0u, below = l - ls - 1 >= 0 ? v1[l] : 0u;
    return (lo << bs) | (bs ? below >> (32u - bs) : 0u);
  });
}

// Limb l of (x >> s) over 512 bits, zeros shifted in from above.
template <class W, class X>
__host__ __device__ __forceinline__ auto lshr_lanes(const W& w, const X& x, uint32_t s) {
  const int ls = (s >> 5) < 16u ? (int)(s >> 5) : 16;
  const uint32_t bs = s & 31u;
  const auto v0 = w.shfl(x, [&](int l) { return (l + ls) & 15; });
  const auto v1 = w.shfl(x, [&](int l) { return (l + ls + 1) & 15; });
  return w.each([&](int l) -> uint32_t {
    const uint32_t lo = l + ls < L ? v0[l] : 0u, above = l + ls + 1 < L ? v1[l] : 0u;
    return (lo >> bs) | (bs ? above << (32u - bs) : 0u);
  });
}

// Bit pos of a value (numpy's take: a limb index of -16..-1 counts from the
// top, as pos = w - 1 < 0 gives), broadcast from the lane that holds it.
template <class W, class X>
__host__ __device__ __forceinline__ bool bit_at(const W& w, const X& x, int32_t pos) {
  int32_t li = pos >> 5;
  if (li < 0) li += L;
  return (w.at(x, li & 15) >> ((uint32_t)pos & 31u)) & 1u;
}

// (fully known?, clamped shift): any amount >= 1024 acts as 1023.
template <class W, class K, class V>
__host__ __device__ __forceinline__ uint32_t shift_amount(const W& w, const K& k, const V& v,
                                                          bool& known) {
  known = all_ones(w, k);
  const bool high = w.ballot(w.each([&](int l) { return l > 0 && v[l] != 0u; })) != 0u;
  const uint32_t s = high ? 1023u : w.at(v, 0);
  return s < 1023u ? s : 1023u;
}

// ---------------------------------------------------------------------------
// One node, one group
// ---------------------------------------------------------------------------

// Where one row's values live: node j's limbs at k + j * stride, a missing
// child at zero; the width masks by node index.
struct Row {
  uint32_t* k;
  uint32_t* v;
  long long stride;
  const uint32_t* zero;
  const uint32_t* wm;

  __host__ __device__ __forceinline__ const uint32_t* ck(int32_t j) const {
    return j < 0 ? zero : k + j * stride;
  }
  __host__ __device__ __forceinline__ const uint32_t* cv(int32_t j) const {
    return j < 0 ? zero : v + j * stride;
  }
};

// The node of staged record q for row r: its transfer function, the
// override's meet, the stores.  Returns whether the override refuted the
// row.
template <class W>
__host__ __device__ inline bool node(const W& w, const KbArgs& a, const Row& row,
                                     const int32_t* q, int32_t r) {
  const int32_t i = q[Q_I], op = q[Q_OP], wd = q[Q_W], ov = q[Q_OV];
  const uint32_t *pak = row.ck(q[Q_A0]), *pav = row.cv(q[Q_A0]);
  const uint32_t *pbk = row.ck(q[Q_A1]), *pbv = row.cv(q[Q_A1]);
  const uint32_t *pck = row.ck(q[Q_A2]), *pcv = row.cv(q[Q_A2]);
  const uint32_t* pwm = row.wm + (long long)L * i;
  const auto ak = w.each([&](int l) { return pak[l]; });
  const auto av = w.each([&](int l) { return pav[l]; });
  const auto bk = w.each([&](int l) { return pbk[l]; });
  const auto bv = w.each([&](int l) { return pbv[l]; });
  const auto wm = w.each([&](int l) { return pwm[l]; });
  auto k = w.each([&](int l) -> uint32_t { return ~wm[l]; });  // top
  auto v = w.each([](int) -> uint32_t { return 0u; });

  // a bool node: bit 0 known iff decided, then equal to value
  auto bool_out = [&](bool decided, bool value) {
    k = w.each([&](int l) -> uint32_t { return ~wm[l] | (decided ? wm[l] : 0u); });
    v = w.each([&](int l) -> uint32_t { return decided && value ? wm[l] : 0u; });
  };
  // known where the operands are fully pinned (the value in sum), else top
  auto fullknown = [&](bool fully, const decltype(k)& sum) {
    k = w.each([&](int l) -> uint32_t { return fully ? ALL : ~wm[l]; });
    v = w.each([&](int l) -> uint32_t { return (fully ? sum[l] & wm[l] : 0u) & k[l]; });
  };
  // (x << s) or (x >> s) of the first child by the second, its amount known
  // or not
  auto shift_pair = [&](bool left) {
    bool known;
    const uint32_t s = shift_amount(w, bk, bv, known);
    const bool zero = known && (int32_t)s >= wd;
    const auto nk = w.each([&](int l) -> uint32_t { return ~ak[l]; });
    const auto sk = left ? shl_lanes(w, nk, s) : lshr_lanes(w, nk, s);
    const auto sv = left ? shl_lanes(w, av, s) : lshr_lanes(w, av, s);
    k = w.each([&](int l) -> uint32_t {
      return zero ? ALL : (known ? ~sk[l] | ~wm[l] : ~wm[l]);
    });
    v = w.each([&](int l) -> uint32_t {
      return zero ? 0u : (known ? sv[l] & wm[l] & (~sk[l] | ~wm[l]) : 0u);
    });
  };

  switch (op) {
    case CONST: {
      const uint32_t* pcl = a.cl + (long long)L * i;
      k = w.each([](int) -> uint32_t { return ALL; });
      v = w.each([&](int l) { return ldg(pcl + l); });
      break;
    }
    case EQ: {
      const bool conflict =
          any_set(w, w.each([&](int l) -> uint32_t { return ak[l] & bk[l] & (av[l] ^ bv[l]); }));
      const bool must_true = all_ones(w, ak) && all_ones(w, bk) && !conflict;
      bool_out(conflict || must_true, must_true);
      break;
    }
    case AND:
    case BAND:
      k = w.each([&](int l) -> uint32_t {
        return (ak[l] & bk[l]) | (ak[l] & ~av[l]) | (bk[l] & ~bv[l]);
      });
      v = w.each([&](int l) -> uint32_t { return av[l] & bv[l] & k[l]; });
      break;
    case OR:
    case BOR:
      k = w.each([&](int l) -> uint32_t {
        return (ak[l] & bk[l]) | (ak[l] & av[l]) | (bk[l] & bv[l]);
      });
      v = w.each([&](int l) -> uint32_t { return (av[l] | bv[l]) & k[l]; });
      break;
    case XOR:
    case BXOR:
      k = w.each([&](int l) -> uint32_t { return ak[l] & bk[l]; });
      v = w.each([&](int l) -> uint32_t { return (av[l] ^ bv[l]) & k[l]; });
      break;
    case NOT:
    case BNOT:
      k = ak;
      v = w.each([&](int l) -> uint32_t { return ~av[l] & ak[l] & wm[l]; });
      break;
    case ITE: {
      const auto ck = w.each([&](int l) { return pck[l]; });
      const auto cv = w.each([&](int l) { return pcv[l]; });
      const bool known = w.at(ak, 0) & 1u, value = w.at(av, 0) & 1u;
      const bool then_ = known && value, else_ = known && !value;
      k = w.each([&](int l) -> uint32_t {
        return then_ ? bk[l] : (else_ ? ck[l] : bk[l] & ck[l] & ~(bv[l] ^ cv[l]));
      });
      v = w.each([&](int l) -> uint32_t {
        return then_ ? bv[l] : (else_ ? cv[l] : bv[l] & bk[l] & ck[l] & ~(bv[l] ^ cv[l]));
      });
      break;
    }
    case ADD: {
      fullknown(all_ones(w, ak) && all_ones(w, bk), add_lanes(w, av, bv, 0u));
      // leading zeros: a + b < 2^(max(pa, pb) + 1)
      const int32_t pa = pbits(w, ak, av), pb = pbits(w, bk, bv);
      const int32_t thr = (pa > pb ? pa : pb) + 1;
      k = w.each([&](int l) -> uint32_t { return k[l] | ~mask_below(thr, l); });
      break;
    }
    case SUB:
      fullknown(all_ones(w, ak) && all_ones(w, bk),
                add_lanes(w, av, w.each([&](int l) -> uint32_t { return ~bv[l]; }), 1u));
      break;
    case MUL: {
      const int32_t pa = pbits(w, ak, av), pb = pbits(w, bk, bv);
      const int32_t thr = (pa == 0 || pb == 0) ? 0 : (pa <= 1 ? pb : (pb <= 1 ? pa : pa + pb));
      k = w.each([&](int l) -> uint32_t { return ~wm[l] | ~mask_below(thr, l); });
      break;
    }
    case UDIV:
    case UREM: {
      const int32_t pa = pbits(w, ak, av);
      k = w.each([&](int l) -> uint32_t { return ~wm[l] | ~mask_below(pa, l); });
      break;
    }
    case NEG:
      fullknown(all_ones(w, ak),
                add_lanes(w, w.each([&](int l) -> uint32_t { return ~av[l]; }),
                          w.each([](int) -> uint32_t { return 0u; }), 1u));
      break;
    case SHL:
      shift_pair(true);
      break;
    case LSHR:
      shift_pair(false);
      break;
    case ASHR: {
      // sound only when the sign bit is provably 0 (then ashr == lshr)
      const bool ok = bit_at(w, ak, wd - 1) && !bit_at(w, av, wd - 1);
      shift_pair(false);
      if (!ok) {
        k = w.each([&](int l) -> uint32_t { return ~wm[l]; });
        v = w.each([](int) -> uint32_t { return 0u; });
      }
      break;
    }
    case CONCAT: {
      const int32_t wb = q[Q_WB];
      const auto sk = shl_lanes(w, w.each([&](int l) -> uint32_t { return ~ak[l]; }),
                                (uint32_t)wb);
      const auto sv = shl_lanes(w, av, (uint32_t)wb);
      k = w.each([&](int l) -> uint32_t {
        const uint32_t low = mask_below(wb, l);
        return (~sk[l] & ~low) | (bk[l] & low) | ~wm[l];
      });
      v = w.each([&](int l) -> uint32_t {
        const uint32_t low = mask_below(wb, l);
        return ((sv[l] & ~low) | (bv[l] & low)) & wm[l] & k[l];
      });
      break;
    }
    case EXTRACT: {
      const uint32_t s = (uint32_t)q[Q_X1];
      const auto sk = lshr_lanes(w, w.each([&](int l) -> uint32_t { return ~ak[l]; }), s);
      const auto sv = lshr_lanes(w, av, s);
      k = w.each([&](int l) -> uint32_t { return ~sk[l] | ~wm[l]; });
      v = w.each([&](int l) -> uint32_t { return sv[l] & wm[l] & k[l]; });
      break;
    }
    case ZEXT:
      k = ak;
      v = av;
      break;
    case SEXT: {
      const int32_t wa = q[Q_WA];
      const bool sk = bit_at(w, ak, wa - 1), sv = bit_at(w, av, wa - 1);
      k = w.each([&](int l) -> uint32_t {
        const uint32_t below = mask_below(wa, l), ext = wm[l] & ~below;
        return (ak[l] & below) | ~wm[l] | (sk ? ext : 0u);
      });
      v = w.each([&](int l) -> uint32_t {
        const uint32_t below = mask_below(wa, l), ext = wm[l] & ~below;
        return ((av[l] & below) | (sk && sv ? ext : 0u)) & k[l];
      });
      break;
    }
    case ULT:
    case ULE: {
      bool lt, eq;
      ult_eq(w, av, bv, lt, eq);
      bool_out(all_ones(w, ak) && all_ones(w, bk), op == ULT ? lt : (lt || eq));
      break;
    }
    default:  // VAR, SDIV, SREM, SLT, SLE and any other code: top
      break;
  }

  bool refuted = false;
  if (ov >= 0) {
    const long long at = ((long long)ov * a.R + r) * L;
    const auto om = w.each([&](int l) { return ldg(a.okm + at + l); });
    const auto ovv = w.each([&](int l) { return ldg(a.okv + at + l); });
    refuted = any_set(w, w.each([&](int l) -> uint32_t { return k[l] & om[l] & (v[l] ^ ovv[l]); }));
    k = w.each([&](int l) -> uint32_t { return k[l] | om[l]; });
    v = w.each([&](int l) -> uint32_t { return (v[l] | ovv[l]) & k[l]; });
  }
  uint32_t* outk = row.k + i * row.stride;
  uint32_t* outv = row.v + i * row.stride;
  w.run([&](int l) { outk[l] = k[l], outv[l] = v[l]; });
  return refuted;
}

// ---------------------------------------------------------------------------
// The block: staging, levels, write-out
// ---------------------------------------------------------------------------

// Thread t of nt: the records in level order (children remapped, widths of
// the first two children looked up), the level offsets and, on the
// shared-memory route, the zero row and the width masks (the row's km and
// kv lie between them).  Staged in bulk, the masks cost a node no read of
// global memory on the chain of levels.
template <bool kSmem>
__host__ __device__ inline void stage(const KbArgs& a, int32_t* smem, int t, int nt) {
  int32_t* q = smem;
  int32_t* lv = smem + (long long)a.N * KREC;
  for (int32_t p = t; p < a.N; p += nt) {
    const int32_t i = a.plan[p];
    const int32_t* rec = a.nodes + (long long)NODE_W * i;
    int32_t* o = q + (long long)KREC * p;
    const int32_t a0 = rec[2], a1 = rec[3];
    o[Q_I] = i, o[Q_OP] = rec[0], o[Q_W] = rec[1], o[Q_X1] = rec[6], o[Q_OV] = rec[7];
    for (int c = 0; c < 3; ++c) {
      const int32_t j = rec[2 + c];
      o[Q_A0 + c] = j >= 0 && j < i ? j : -1;
    }
    o[Q_WA] = a0 >= 0 ? a.nodes[(long long)NODE_W * a0 + 1] : 0;
    o[Q_WB] = a1 >= 0 ? a.nodes[(long long)NODE_W * a1 + 1] : 0;
  }
  for (int32_t p = t; p <= a.n_levels; p += nt) lv[p] = a.plan[a.N + p];
  if constexpr (kSmem) {
    uint32_t* zero = (uint32_t*)(lv + a.n_levels + 1);
    uint32_t* wm = zero + L + 2LL * a.N * L;
    for (int p = t; p < L; p += nt) zero[p] = 0u;
    for (long long p = t; p < (long long)a.N * L; p += nt) wm[p] = ldg(a.wm + p);
  }
}

// Row r's values: in shared memory after the staged records, or in the
// output planes.
template <bool kSmem>
__host__ __device__ inline Row row_of(const KbArgs& a, int32_t* smem, int32_t r) {
  if constexpr (kSmem) {
    uint32_t* zero = (uint32_t*)(smem + (long long)a.N * KREC + a.n_levels + 1);
    uint32_t* k = zero + L;
    return Row{k, k + (long long)a.N * L, L, zero, k + 2LL * a.N * L};
  } else {
    return Row{a.km + (long long)r * L, a.kv + (long long)r * L, (long long)a.R * L, a.zero,
               a.wm};
  }
}

// Group g of ng: the level's nodes at positions lo + g, lo + g + ng, ...
// Returns whether an override refuted the row.
template <class W>
__host__ __device__ inline bool level(const W& w, const KbArgs& a, const Row& row,
                                      const int32_t* q, int32_t lo, int32_t hi, int32_t r,
                                      int g, int ng) {
  bool refuted = false;
  for (int32_t p = lo + g; p < hi; p += ng)
    refuted = node(w, a, row, q + (long long)KREC * p, r) || refuted;
  return refuted;
}

// Thread t of nt, after the last level: the shared-memory route writes the
// row's km and kv out to [N, R, 16].
template <bool kSmem>
__host__ __device__ inline void finish(const KbArgs& a, const Row& row, int32_t r, int t,
                                       int nt) {
  if constexpr (kSmem) {
    for (long long p = t; p < (long long)a.N * L; p += nt) {
      const long long at = ((p >> 4) * a.R + r) * L + (p & 15);
      a.km[at] = row.k[p], a.kv[at] = row.v[p];
    }
  }
}

}  // namespace kb
}  // namespace mk
