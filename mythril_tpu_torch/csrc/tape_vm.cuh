// The tape VM's per-candidate evaluation, shared by the CUDA kernel
// (tape_vm.cu) and, being __host__ __device__, buildable by a host C++
// compiler for checks without a card.
//
// Replaces the step body of mythril_tpu/ops/tape_vm.py:_run_tape (the
// lax.switch over 20 vector ops inside lax.scan).  See tape_vm.cu for the
// launch structure and the register-file layout.
#pragma once

#include <stdint.h>

#include "bitvec.cuh"
#include "keccak.cuh"

namespace mk {

enum {
  OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM, OP_SDIV, OP_SREM, OP_EXP,
  OP_AND, OP_OR, OP_XOR, OP_SHL, OP_LSHR, OP_ASHR,
  OP_EQ, OP_ULT, OP_ITE, OP_SELECT, OP_KECCAK32, OP_KECCAK64,
};

// Field order and types must match ops/_build.py:TapeArgs.
struct TapeArgs {
  const int32_t* op;           // [T]
  const int32_t* a0;           // [T]
  const int32_t* a1;           // [T]
  const int32_t* a2;           // [T]
  const int32_t* aux;          // [T]
  const int32_t* wmask;        // [T, 16]
  int32_t* regs;               // [V + T, 16, B]
  const int32_t* tab_idx;      // [B, A, K, 16]
  const int32_t* tab_val;      // [B, A, K, 16]
  const uint8_t* tab_valid;    // [B, A, K]
  const int32_t* tab_default;  // [B, A, 16]
  int32_t* kstate;             // [B, 25, 4], for segments next to keccak steps
  const int32_t* root_rows;    // [R]
  const uint8_t* root_valid;   // [R]
  uint8_t* truth;              // [B, R], written by the last segment only
  int V, T, A, K, R, B;
  int t_begin, t_end;          // plain steps [t_begin, t_end) run here
  int squeeze_step;            // keccak step squeezed first, or -1
  int absorb_step;             // keccak step absorbed last, or -1
};

// Steps [lo, hi) a segment stages: the squeezed step through the absorbed one.
__host__ __device__ __forceinline__ int stage_lo(const TapeArgs& t) {
  return t.squeeze_step >= 0 ? t.squeeze_step : t.t_begin;
}

__host__ __device__ __forceinline__ int stage_hi(const TapeArgs& t) {
  return t.absorb_step >= 0 ? t.absorb_step + 1 : t.t_end;
}

// Staged step i: width mask as four words, then op/a0/a1/a2/aux.
__host__ __device__ __forceinline__ void stage_step(const TapeArgs& t, int i,
                                                    uint64_t* s_mask, int32_t* s_code) {
  const int step = stage_lo(t) + i;
  const int32_t* m = t.wmask + (long long)step * 16;
  for (int k = 0; k < 4; ++k)
    s_mask[4 * i + k] = lane_from_limbs(m[4 * k], m[4 * k + 1], m[4 * k + 2], m[4 * k + 3]);
  s_code[5 * i + 0] = t.op[step];
  s_code[5 * i + 1] = t.a0[step];
  s_code[5 * i + 2] = t.a1[step];
  s_code[5 * i + 3] = t.a2[step];
  s_code[5 * i + 4] = t.aux[step];
}

__host__ __device__ __forceinline__ u256 load_row(const TapeArgs& t, int row, int b) {
  u256 r = u256_zero();
  if (row < 0 || row >= t.V + t.T) return r;  // out-of-range rows read as zero
  const int32_t* p = t.regs + (long long)row * 16 * t.B + b;
  const long long B = t.B;
  for (int k = 0; k < 4; ++k)
    r.w[k] = lane_from_limbs(p[(4 * k) * B], p[(4 * k + 1) * B], p[(4 * k + 2) * B],
                             p[(4 * k + 3) * B]);
  return r;
}

__host__ __device__ __forceinline__ void store_row(const TapeArgs& t, int row, int b,
                                                   const u256& v) {
  int32_t* p = t.regs + (long long)row * 16 * t.B + b;
  const long long B = t.B;
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < 4; ++j) p[(4 * k + j) * B] = lane_limb(v.w[k], j);
}

// 16 contiguous limbs (one table word) -> u256.
__host__ __device__ __forceinline__ u256 load_word16(const int32_t* p) {
  u256 r;
  for (int k = 0; k < 4; ++k)
    r.w[k] = lane_from_limbs(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
  return r;
}

// Array read against the candidate's finite table: the valid row whose
// index equals x, else the default (tape_vm.py br_select; the packer's keys
// are distinct, so at most one row hits).
__host__ __device__ inline u256 table_select(const TapeArgs& t, int b, int slot,
                                             const u256& x) {
  if (slot < 0 || slot >= t.A) return u256_zero();
  const long long row = (long long)b * t.A + slot;
  for (int k = 0; k < t.K; ++k) {
    const long long e = row * t.K + k;
    if (t.tab_valid[e] && eq(load_word16(t.tab_idx + e * 16), x))
      return load_word16(t.tab_val + e * 16);
  }
  return load_word16(t.tab_default + row * 16);
}

__host__ __device__ inline u256 apply_op(const TapeArgs& t, int b, int op, int slot,
                                         const u256& x, const u256& y, const u256& z) {
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
    case OP_SELECT: return table_select(t, b, slot, x);
    default: return u256_zero();  // keccak steps are split out by the wrapper
  }
}

// Candidate b's share of one segment, against the staged tape.
__host__ __device__ inline void run_candidate(const TapeArgs& t, const uint64_t* s_mask,
                                              const int32_t* s_code, int b) {
  const int lo = stage_lo(t);

  if (t.squeeze_step >= 0) {
    // digest bytes are big-endian into the word: word w[3-l] = bswap(lane l)
    const int32_t* ks = t.kstate + (long long)b * 100;
    u256 h;
    for (int l = 0; l < 4; ++l)
      h.w[3 - l] = bswap64(lane_from_limbs(ks[4 * l], ks[4 * l + 1], ks[4 * l + 2],
                                           ks[4 * l + 3]));
    const uint64_t* m = s_mask + 4 * (t.squeeze_step - lo);
    for (int k = 0; k < 4; ++k) h.w[k] &= m[k];
    store_row(t, t.V + t.squeeze_step, b, h);
  }

  for (int step = t.t_begin; step < t.t_end; ++step) {
    const int i = step - lo;
    const int op = s_code[5 * i];
    const u256 x = load_row(t, s_code[5 * i + 1], b);
    const u256 y = load_row(t, s_code[5 * i + 2], b);
    const u256 z = op == OP_ITE ? load_row(t, s_code[5 * i + 3], b) : u256_zero();
    u256 res = apply_op(t, b, op, s_code[5 * i + 4], x, y, z);
    const uint64_t* m = s_mask + 4 * i;
    for (int k = 0; k < 4; ++k) res.w[k] &= m[k];
    store_row(t, t.V + step, b, res);
  }

  if (t.absorb_step >= 0) {
    // preimage: big-endian bytes of x (32) or of hi:lo = a1:a0 (64, the low
    // word is a0); lane l is little-endian over message bytes 8l..8l+7
    const int i = t.absorb_step - lo;
    uint64_t lane[25];
    for (int l = 0; l < 25; ++l) lane[l] = 0;
    const u256 x = load_row(t, s_code[5 * i + 1], b);
    if (s_code[5 * i] == OP_KECCAK64) {
      const u256 y = load_row(t, s_code[5 * i + 2], b);
      for (int l = 0; l < 4; ++l) {
        lane[l] = bswap64(y.w[3 - l]);
        lane[4 + l] = bswap64(x.w[3 - l]);
      }
      lane[8] ^= 0x01ULL;
    } else {
      for (int l = 0; l < 4; ++l) lane[l] = bswap64(x.w[3 - l]);
      lane[4] ^= 0x01ULL;
    }
    lane[16] ^= 0x80ULL << 56;  // last byte of the 136-byte rate block
    int32_t* ks = t.kstate + (long long)b * 100;
    for (int l = 0; l < 25; ++l)
      for (int j = 0; j < 4; ++j) ks[4 * l + j] = lane_limb(lane[l], j);
  }

  if (t.truth != nullptr) {
    for (int r = 0; r < t.R; ++r) {
      uint8_t v = 1;
      if (t.root_valid[r]) v = !is_zero(load_row(t, t.root_rows[r], b));
      t.truth[(long long)b * t.R + r] = v;
    }
  }
}

}  // namespace mk
