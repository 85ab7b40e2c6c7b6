// The tape VM's per-candidate evaluation, shared by the CUDA kernel
// (tape_vm.cu) and, being __host__ __device__, buildable by a host C++
// compiler for checks without a card.
//
// Replaces the step body of mythril_tpu/ops/tape_vm.py:_run_tape (the
// lax.switch over 20 vector ops inside lax.scan).  See tape_vm.cu for the
// launch structure and the slot-file layout.
#pragma once

#include <stdint.h>

#include "bitvec.cuh"
#include "keccak.cuh"

#if defined(__CUDA_ARCH__)
#include <cuda_pipeline.h>
#endif

namespace mk {

enum {
  OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM, OP_SDIV, OP_SREM, OP_EXP,
  OP_AND, OP_OR, OP_XOR, OP_SHL, OP_LSHR, OP_ASHR,
  OP_EQ, OP_ULT, OP_ITE, OP_SELECT, OP_KECCAK32, OP_KECCAK64,
};

// A step's record in the plan (ops/tape_vm.py:TapePlan.rec), 64 bytes: op,
// the slots of its three operands, aux (select slot), the result's slot (-1:
// nothing reads it), its roots [root_lo, root_hi) of root_order, then the
// width mask as four uint64_t.
enum { REC_INTS = 16, REC_OP = 0, REC_X, REC_Y, REC_Z, REC_AUX, REC_DST, REC_ROOT_LO, REC_ROOT_HI };
// A root decided before any step: its value is a slot's, or constant.
enum { PRE_ZERO = -1, PRE_ONE = -2 };

// Field order and types must match ops/_build.py:TapeArgs.  The plan arrays
// (rec, root_order, pre, leaves, tables, live_in/out) come from TapePlan;
// rec, root_order, pre, leaves and tables are 16-byte aligned.
struct TapeArgs {
  const int32_t* rec;          // [n, 16]: one record per step
  const int32_t* root_order;   // [R]: roots in the order the steps decide them
  const int32_t* pre;          // [n_pre, 2]: (root, slot or PRE_*) decided first
  const int32_t* leaves;       // [n_leaf, 2]: (slot, leaf row) loaded first
  const int32_t* tables;       // [n_table, 2]: (first slot, array) loaded first
  const int32_t* leaf_vals;    // [B, V, 16]
  const int32_t* tab_idx;      // [B, A, K, 16]
  const int32_t* tab_val;      // [B, A, K, 16]
  const uint8_t* tab_valid;    // [B, A, K]
  const int32_t* tab_default;  // [B, A, 16]
  int32_t* kstate;             // [B, 25, 4], for segments next to keccak steps
  uint64_t* spill;             // [n_spill, 4, B]: slots live across a keccak step
  const int32_t* live_in;      // [n_live_in]: slots reloaded from spill first
  const int32_t* live_out;     // [n_live_out]: slots stored to spill last
  uint8_t* truth;              // [B, R] bool
  int32_t* regs;               // [V + T, 16, B] copy of every step's value, or null
  int V, T, A, K, R, B;
  int S;                       // slots per candidate: step values, leaves, zero
  int n_leaf, n_table;         // this segment's leaves and tables
  int zero_slot;               // a slot holding zero, or -1
  int n_pre;                   // pre entries, first segment only
  int t_begin, t_end;          // plain steps [t_begin, t_end) run here
  int squeeze_step;            // keccak step squeezed first, or -1
  int absorb_step;             // keccak step absorbed last, or -1
  int n_live_in, n_live_out;
};

// Steps [lo, hi) a segment stages: the squeezed step through the absorbed one.
__host__ __device__ __forceinline__ int stage_lo(const TapeArgs& t) {
  return t.squeeze_step >= 0 ? t.squeeze_step : t.t_begin;
}

__host__ __device__ __forceinline__ int stage_hi(const TapeArgs& t) {
  return t.absorb_step >= 0 ? t.absorb_step + 1 : t.t_end;
}

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// What a segment stages in shared memory, in int32 and in this order: the
// records of its steps, root_order, pre, leaves, tables, each padded to 16
// bytes.
struct Staged {
  int32_t* rec;
  int32_t* root_order;
  int32_t* pre;
  int32_t* leaves;
  int32_t* tables;
};

__host__ __device__ __forceinline__ int staged_ints(const TapeArgs& t) {
  return (stage_hi(t) - stage_lo(t)) * REC_INTS + pad4(t.R) + pad4(2 * t.n_pre) + pad4(2 * t.n_leaf) +
         pad4(2 * t.n_table);
}

__host__ __device__ __forceinline__ Staged staged_at(const TapeArgs& t, int32_t* base) {
  Staged s;
  s.rec = base;
  s.root_order = s.rec + (stage_hi(t) - stage_lo(t)) * REC_INTS;
  s.pre = s.root_order + pad4(t.R);
  s.leaves = s.pre + pad4(2 * t.n_pre);
  s.tables = s.leaves + pad4(2 * t.n_leaf);
  return s;
}

// Copy n 16-byte words, thread i of n_threads taking every n_threads-th; on
// the card asynchronously (cp.async), completed in stage().
__host__ __device__ __forceinline__ void stage_copy(int32_t* dst, const int32_t* src, int n,
                                                    int i, int n_threads) {
  for (; i < n; i += n_threads) {
#if defined(__CUDA_ARCH__)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
#else
    for (int k = 0; k < 4; ++k) dst[4 * i + k] = src[4 * i + k];
#endif
  }
}

// Thread i's share of staging; the block synchronises after it.
__host__ __device__ __forceinline__ void stage(const TapeArgs& t, const Staged& s, int i,
                                               int n_threads) {
  const int n = stage_hi(t) - stage_lo(t);
  stage_copy(s.rec, t.rec + (long long)stage_lo(t) * REC_INTS, n * REC_INTS / 4, i, n_threads);
  stage_copy(s.root_order, t.root_order, pad4(t.R) / 4, i, n_threads);
  stage_copy(s.pre, t.pre, pad4(2 * t.n_pre) / 4, i, n_threads);
  stage_copy(s.leaves, t.leaves, pad4(2 * t.n_leaf) / 4, i, n_threads);
  stage_copy(s.tables, t.tables, pad4(2 * t.n_table) / 4, i, n_threads);
#if defined(__CUDA_ARCH__)
  __pipeline_commit();
  __pipeline_wait_prior(0);
#endif
}

// One candidate's slot file: word k of slot s at p[(4 * s + k) * STRIDE].  In
// the kernel p points into shared memory laid out [S][4][STRIDE], STRIDE the
// block's candidates, so a warp's accesses to one word are consecutive
// 8-byte words.
template <int STRIDE>
struct SlotFile {
  uint64_t* p;
  __host__ __device__ __forceinline__ u256 load(int s) const {
    const uint64_t* q = p + 4 * STRIDE * s;
    u256 r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = q[k * STRIDE];
    return r;
  }
  __host__ __device__ __forceinline__ void store(int s, const u256& v) const {
    uint64_t* q = p + 4 * STRIDE * s;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k * STRIDE] = v.w[k];
  }
};

// 16 contiguous limbs (one word of leaf_vals or a table) -> u256; on the card
// four 16-byte loads through the read-only path.
__host__ __device__ __forceinline__ u256 load_word16(const int32_t* p) {
  u256 r;
#if defined(__CUDA_ARCH__)
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldg(q + k);
    r.w[k] = lane_from_limbs(v.x, v.y, v.z, v.w);
  }
#else
  for (int k = 0; k < 4; ++k)
    r.w[k] = lane_from_limbs(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
#endif
  return r;
}

// The debug copy of a value in the [V+T, 16, B] int32 layout.
__host__ __device__ __forceinline__ void store_row(const TapeArgs& t, int row, int b,
                                                   const u256& v) {
  int32_t* p = t.regs + (long long)row * 16 * t.B + b;
  const long long B = t.B;
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < 4; ++j) p[(4 * k + j) * B] = lane_limb(v.w[k], j);
}

// Load array a's table for candidate b into slots base .. base + K: the K
// index words, then the mask of its valid rows (bit k: row k) in word 0.
template <class Slots>
__host__ __device__ __forceinline__ void load_table(const TapeArgs& t, const Slots& f, int b,
                                                    int base, int a) {
  const long long row = ((long long)b * t.A + a) * t.K;
  uint64_t valid = 0;
#pragma unroll 4
  for (int k = 0; k < t.K; ++k) {  // unrolled, so that loads overlap
    f.store(base + k, load_word16(t.tab_idx + (row + k) * 16));
    valid |= (uint64_t)(t.tab_valid[row + k] != 0) << k;
  }
  f.store(base + t.K, u256_small(valid));
}

// Array read against the candidate's finite table, whose index words and
// valid mask are in slots base .. base + K (load_table): the first valid row
// whose index equals x, else the default (tape_vm.py br_select; the
// packer's keys are distinct, so at most one row hits).  Only the value
// (and the default) come from device memory.
template <class Slots>
__host__ __device__ inline u256 table_select(const TapeArgs& t, const Slots& f, int b, int a,
                                             int base, const u256& x) {
  const long long row = (long long)b * t.A + a;
  const u256 fallback = load_word16(t.tab_default + row * 16);  // in flight meanwhile
  const uint64_t valid = f.load(base + t.K).w[0];
  int hit = -1;
#pragma unroll 8
  for (int k = t.K - 1; k >= 0; --k)  // no branch between rows: their loads overlap
    if ((int)((valid >> k) & 1) & (int)eq(f.load(base + k), x)) hit = k;
  if (hit < 0) return fallback;
  return load_word16(t.tab_val + (row * t.K + hit) * 16);
}

// Every op but SELECT (table_select) and the keccak steps (split out).
__host__ __device__ inline u256 apply_op(int op, const u256& x, const u256& y, const u256& z) {
  u256 q, r;
  switch (op) {
    case OP_ADD: return add(x, y);
    case OP_SUB: return sub(x, y);
    case OP_MUL: return mul(x, y);
    case OP_UDIV: udivmod(x, y, &q, &r); return q;
    case OP_UREM: udivmod(x, y, &q, &r); return r;
    case OP_SDIV: return sdiv(x, y);
    case OP_SREM: return srem(x, y);
    case OP_EXP: return bvexp(x, y);
    case OP_AND: return bit_and(x, y);
    case OP_OR: return bit_or(x, y);
    case OP_XOR: return bit_xor(x, y);
    case OP_SHL: return shl(x, shift_amount(y));
    case OP_LSHR: return lshr(x, shift_amount(y));
    case OP_ASHR: return ashr(x, shift_amount(y));
    case OP_EQ: return u256_small(eq(x, y) ? 1 : 0);
    case OP_ULT: return u256_small(ult(x, y) ? 1 : 0);
    case OP_ITE: return is_zero(x) ? z : y;
    default: return u256_zero();
  }
}

// A step's record, read from shared memory into registers.
struct Rec {
  int op, x, y, z, aux, dst, root_lo, root_hi;
  u256 mask;
};

__host__ __device__ __forceinline__ Rec load_rec(const int32_t* c) {
  Rec r;
#if defined(__CUDA_ARCH__)
  const int4* q = reinterpret_cast<const int4*>(c);
  const int4 a = q[0], b = q[1], m0 = q[2], m1 = q[3];
  r.op = a.x, r.x = a.y, r.y = a.z, r.z = a.w;
  r.aux = b.x, r.dst = b.y, r.root_lo = b.z, r.root_hi = b.w;
  const int m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#else
  r.op = c[REC_OP], r.x = c[REC_X], r.y = c[REC_Y], r.z = c[REC_Z];
  r.aux = c[REC_AUX], r.dst = c[REC_DST], r.root_lo = c[REC_ROOT_LO], r.root_hi = c[REC_ROOT_HI];
  const int32_t* m = c + 8;
#endif
  for (int k = 0; k < 4; ++k)
    r.mask.w[k] = (uint64_t)(uint32_t)m[2 * k] | ((uint64_t)(uint32_t)m[2 * k + 1] << 32);
  return r;
}

// A step's result is final: keep it in its slot if a later step reads it,
// copy it to the debug register file if there is one, and decide the roots
// whose row it is.
template <class Slots>
__host__ __device__ __forceinline__ void finish(const TapeArgs& t, const Staged& s,
                                                const Slots& f, const Rec& c, int step,
                                                int b, const u256& v) {
  if (c.dst >= 0) f.store(c.dst, v);
  if (t.regs != nullptr) store_row(t, t.V + step, b, v);
  if (c.root_lo < c.root_hi) {
    const uint8_t nz = is_zero(v) ? 0 : 1;
    for (int j = c.root_lo; j < c.root_hi; ++j)
      t.truth[(long long)b * t.R + s.root_order[j]] = nz;
  }
}

// Candidate b's share of one segment, against the staged tape; f is its
// slot file, whose contents do not survive the segment except through the
// spill.  The segment's leaves, array tables and spilled slots are loaded
// first, several at once; then every operand is a slot.
template <class Slots>
__host__ __device__ inline void run_candidate(const TapeArgs& t, const Staged& s,
                                              const Slots& f, int b) {
  const int lo = stage_lo(t);
  const long long B = t.B;

#pragma unroll 4
  for (int i = 0; i < t.n_leaf; ++i)  // unrolled, so that loads overlap
    f.store(s.leaves[2 * i],
            load_word16(t.leaf_vals + ((long long)b * t.V + s.leaves[2 * i + 1]) * 16));
  for (int i = 0; i < t.n_table; ++i) load_table(t, f, b, s.tables[2 * i], s.tables[2 * i + 1]);
  if (t.zero_slot >= 0) f.store(t.zero_slot, u256_zero());
#pragma unroll 4
  for (int i = 0; i < t.n_live_in; ++i) {
    u256 v;
    for (int k = 0; k < 4; ++k) v.w[k] = t.spill[(4 * i + k) * B + b];
    f.store(t.live_in[i], v);
  }
  for (int j = 0; j < t.n_pre; ++j) {  // roots that no step decides
    const int src = s.pre[2 * j + 1];
    const uint8_t v = src >= 0 ? !is_zero(f.load(src)) : src == PRE_ONE;
    t.truth[b * (long long)t.R + s.pre[2 * j]] = v;
  }

  if (t.squeeze_step >= 0) {
    // digest bytes are big-endian into the word: word w[3-l] = bswap(lane l)
    const int32_t* ks = t.kstate + (long long)b * 100;
    const Rec c = load_rec(s.rec + REC_INTS * (t.squeeze_step - lo));
    u256 h;
    for (int l = 0; l < 4; ++l)
      h.w[3 - l] = bswap64(lane_from_limbs(ks[4 * l], ks[4 * l + 1], ks[4 * l + 2],
                                           ks[4 * l + 3]));
    finish(t, s, f, c, t.squeeze_step, b, bit_and(h, c.mask));
  }

  // each step's record is read one step ahead, off the dependent chain
  Rec next;
  if (t.t_begin < t.t_end) next = load_rec(s.rec + REC_INTS * (t.t_begin - lo));
  for (int step = t.t_begin; step < t.t_end; ++step) {
    const Rec c = next;
    if (step + 1 < t.t_end) next = load_rec(s.rec + REC_INTS * (step + 1 - lo));
    const u256 x = f.load(c.x);
    const u256 v = c.op == OP_SELECT ? table_select(t, f, b, c.aux, c.z, x)
                                     : apply_op(c.op, x, f.load(c.y), f.load(c.z));
    finish(t, s, f, c, step, b, bit_and(v, c.mask));
  }

  if (t.absorb_step >= 0) {
    // preimage: big-endian bytes of x (32) or of hi:lo = a1:a0 (64, the low
    // word is a0); lane l is little-endian over message bytes 8l..8l+7
    const Rec c = load_rec(s.rec + REC_INTS * (t.absorb_step - lo));
    const bool wide = c.op == OP_KECCAK64;
    const u256 x = f.load(c.x);
    const u256 y = wide ? f.load(c.y) : u256_zero();
    const u256& first = wide ? y : x;
    int32_t* ks = t.kstate + (long long)b * 100;
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      uint64_t lane = 0;
      if (l < 4) lane = bswap64(first.w[3 - l]);
      if (wide && l >= 4 && l < 8) lane = bswap64(x.w[7 - l]);
      if (l == (wide ? 8 : 4)) lane ^= 0x01ULL;
      if (l == 16) lane ^= 0x80ULL << 56;  // last byte of the 136-byte rate block
      for (int j = 0; j < 4; ++j) ks[4 * l + j] = lane_limb(lane, j);
    }
  }

  for (int i = 0; i < t.n_live_out; ++i) {
    const u256 v = f.load(t.live_out[i]);
    for (int k = 0; k < 4; ++k) t.spill[(4 * i + k) * B + b] = v.w[k];
  }
}

}  // namespace mk
