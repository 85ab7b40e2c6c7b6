// The frontier segment's body: one EVM step of one path, and the batch
// phases around it, for the kernel (frontier_segment.cu) and the host check.
//
// Replaces the per-path and per-batch halves of the jitted segment in
// mythril_tpu/frontier/step.py (build_segment: path_step, batch_step).
// Semantics are the JAX program's bit for bit, written for one thread per
// path instead of a vmapped lax.switch:
//
//   * one handler runs per path (a switch over the 33 families); a handler
//     that fails its guard becomes halted(kind), as the JAX select does;
//   * a handler's effect is a PathOut: the scalar fields it sets and at most
//     two stack writes and one write each to memory, storage, ctx, cons and
//     loops, applied after the common tail;
//   * gathers clamp their index as XLA does (a negative index wraps once
//     first); scatters drop an index outside the array; int32 arithmetic
//     wraps (done in uint32_t); // and % floor;
//   * the fork grant ranks the wanting paths by (-score, slot): the stable
//     argsort's order, as a count.
//
// State, arena and coverage planes stay in the JAX layout in device memory
// (int32 fields, arena values as [T, 16] 16-bit limbs); a row's value is
// packed into four 64-bit words (bitvec.cuh) when it is read and unpacked
// when a fold is written.  One thread owns one path's state row: only it
// writes the row, and the only cross-path reads are the arena, the coverage
// planes, the scratch of the grant, and a forking parent's row, which its
// child copies.  Those go through ld_cg (L2, not the SM's L1).
//
// Each phase below is a function of the path index; between phases the
// kernel waits on a grid barrier, the host check finishes the phase for
// every path first.
#pragma once

#include <stdint.h>

#include "bitvec.cuh"

namespace mk {

// ---- constants of mythril_tpu_torch/frontier/ops.py and code.py ----------
enum : int32_t {
  A_CONST = 1, A_VARF = 3, A_ADD = 10, A_SUB = 11, A_MUL = 12, A_AND = 17, A_OR = 18,
  A_XOR = 19, A_SHL = 20, A_LSHR = 21, A_ASHR = 22, A_NOT = 30, A_ULT = 40, A_UGT = 41,
  A_SLT = 44, A_SGT = 45, A_EQ = 46, A_NE = 47, A_EQZ = 48, A_BNOT = 50, A_ITEW = 60,
  A_CONCAT = 61, A_KECCAK = 63, A_SELECT = 64, A_STORE = 65, A_CDLOAD = 70, A_SIGNEXT = 73,
  A_BYTE = 74,
};
enum : int32_t {
  F_PARK, F_STOP, F_PUSH, F_DUP, F_SWAP, F_POP, F_BINOP, F_CMP, F_ISZERO, F_NOTOP,
  F_ENVPUSH, F_CALLDATALOAD, F_BALANCE, F_SELFBALANCE, F_SHA3, F_MLOAD, F_MSTORE, F_SLOAD,
  F_SSTORE, F_JUMP, F_JUMPI, F_JUMPDEST, F_LOG, F_RETURN, F_SELFDESTRUCT, F_INVALID,
  F_GASPUSH, F_MSIZE, F_SIGNEXTEND, F_BYTEOP, F_ADDMODOP, F_MSTORE8, F_PAGEFAULT,
};
enum : int32_t {
  H_RUNNING, H_STOP, H_RETURN, H_REVERT, H_SELFDESTRUCT, H_INVALID, H_PARK, H_PENDING_FORK,
  H_DEPTH, H_LOOP, H_PAGE_FAULT,
};
enum : int32_t { E_HOOK = 1, E_FORK = 2, E_TERMINAL = 3, EV_W = 13 };
enum : int32_t { CTX_ADDRESS = 3, CTX_BALANCES = 5, CTX_STORAGE = 6, CTX_SEED = 15, CTX_W = 16 };
enum : int32_t { SEL_DEEP = 1, SEL_SHALLOW = 2, SEL_COVERAGE = 3, SEL_BEAM = 4 };
constexpr int kRowsWritten = 4;  // rows a handler may write (SHA3); caps.R >= 4

// Mirror of FrontierArgs in mythril_tpu_torch/frontier/step.py (same order).
struct SegArgs {
  // state [B, ...] int32, updated in place
  int32_t *pc, *halt, *seed, *code_id, *steps, *score, *stack, *stack_len, *mem_addr, *mem_val,
      *mem_len, *mem_size, *sto_key, *sto_val, *sto_len, *ctx, *cons, *cons_len, *events, *ev_len,
      *gas_min, *gas_max, *depth, *loops, *statc;
  // arena [T] (val [T, 16]), updated in place
  int32_t *a_op, *a_a, *a_b, *a_c, *a_width, *a_val;
  uint8_t* a_isconst;
  uint8_t* visited;  // [3, Cv, Iv]
  // code tables [C, N] (jumpmap [C, A], pbase [C])
  const int32_t *fam, *aux, *arity, *gmin, *gmax;
  const uint8_t* event;
  const int32_t *jumpmap, *loopid;
  const uint8_t *concskip, *valgate;
  const int32_t* pbase;
  // scratch [B] (blk_* [blocks]); out [3]: arena_len, n_exec, max_live
  int32_t *live_rank, *free_rank, *free_list, *want, *key, *child, *src_of, *f_want, *f_target,
      *f_dest, *f_word, *f_cond, *f_ncond, *pre_pc, *pre_gmin, *pre_gmax, *blk_live, *blk_free,
      *out;
  int32_t B, STK, MEM, STO, CON, EVT, R, K, ARENA, NL, T, C, N, A, Cv, Iv;
  int32_t arena_len0, max_depth, loop_bound, row_zero, row_one, sel_mode, k_limit;
};

// ---- XLA's int32 and index rules ------------------------------------------

__host__ __device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wneg(int32_t a) { return (int32_t)(0u - (uint32_t)a); }
// floor division and modulo by a positive constant
__host__ __device__ __forceinline__ int32_t fdiv(int32_t a, int32_t d) {
  const int64_t q = (int64_t)a / d;
  return (int32_t)(((int64_t)a % d != 0 && a < 0) ? q - 1 : q);
}
__host__ __device__ __forceinline__ int32_t fmod_(int32_t a, int32_t d) {
  const int64_t r = (int64_t)a % d;
  return (int32_t)(r < 0 ? r + d : r);
}
__host__ __device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// a gather index: a negative index wraps once, then clamps into [0, n)
__host__ __device__ __forceinline__ int32_t gidx(int32_t i, int32_t n) {
  const int64_t j = i < 0 ? (int64_t)i + n : i;
  return (int32_t)(j < 0 ? 0 : (j > n - 1 ? n - 1 : j));
}
// a scatter index: wrapped once; -1 when it drops
__host__ __device__ __forceinline__ int32_t sidx(int32_t i, int32_t n) {
  const int64_t j = i < 0 ? (int64_t)i + n : i;
  return (j >= 0 && j < n) ? (int32_t)j : -1;
}

// A load of data another thread may have written since the last barrier.
template <typename X>
__host__ __device__ __forceinline__ X ld_cg(const X* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// ---- arena rows ---------------------------------------------------------

__host__ __device__ __forceinline__ u256 limbs_to_u256(const int32_t* v) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#if defined(__CUDA_ARCH__)
    const int4 q = __ldcg(reinterpret_cast<const int4*>(v) + i);
    const int32_t l[4] = {q.x, q.y, q.z, q.w};
#else
    const int32_t* l = v + 4 * i;
#endif
    r.w[i] = (uint64_t)(uint16_t)l[0] | ((uint64_t)(uint16_t)l[1] << 16) |
             ((uint64_t)(uint16_t)l[2] << 32) | ((uint64_t)(uint16_t)l[3] << 48);
  }
  return r;
}

__host__ __device__ __forceinline__ uint32_t u256_limb(const u256& a, int j) {
  return (uint32_t)(a.w[j >> 2] >> (16 * (j & 3))) & 0xFFFFu;
}

struct Row {
  int32_t op, a, b, c, width;
  bool isconst;
  u256 val;
};

__host__ __device__ __forceinline__ Row row0() {
  Row r;
  r.op = 0, r.a = r.b = r.c = -1, r.width = 0, r.isconst = false, r.val = u256_zero();
  return r;
}

__host__ __device__ __forceinline__ Row mkrow(int32_t op, int32_t a = -1, int32_t b = -1,
                                              int32_t c = -1, int32_t width = 256) {
  Row r = row0();
  r.op = op, r.a = a, r.b = b, r.c = c, r.width = width;
  return r;
}

__host__ __device__ __forceinline__ Row const_row(const u256& v) {
  Row r = mkrow(A_CONST);
  r.isconst = true, r.val = v;
  return r;
}

__host__ __device__ __forceinline__ void write_row(const SegArgs& s, int32_t id, const Row& r) {
  const int32_t i = sidx(id, s.T);
  if (i < 0) return;
  s.a_op[i] = r.op, s.a_a[i] = r.a, s.a_b[i] = r.b, s.a_c[i] = r.c, s.a_width[i] = r.width;
  s.a_isconst[i] = r.isconst;
  for (int j = 0; j < 16; ++j) s.a_val[16 * (int64_t)i + j] = (int32_t)u256_limb(r.val, j);
}

// ---- one path's step ------------------------------------------------------

struct PathOut {
  int32_t pc, halt, stack_len, mem_len, mem_size, sto_len, cons_len, gas_min, gas_max, depth;
  int n_stk;
  int32_t stk_i[2], stk_v[2];
  int32_t mem_i, mem_a, mem_v, sto_i, sto_k, sto_v, ctx_storage, cons_i, cons_v, loop_i, loop_v;
  bool ctx_w;
  Row rows[kRowsWritten];
  bool f_want;
  int32_t f_target, f_dest, f_word, f_cond, f_ncond, res;
};

// The incoming path as the handlers see it (the JAX path_step's locals).
struct PathIn {
  int32_t b, pc, halt, stack_len, mem_len, mem_size, sto_len, cons_len, gas_min, gas_max, depth;
  int32_t cid, pcr, fam, aux, arity, ids[kRowsWritten];
  bool infault, underflow;
  int32_t pops[7];
  bool pop_c[7];
  u256 v0, v1;
  bool ok_addr0, ok_addr1, valid0;
  int32_t addr0, addr1, jidx0, lid;
  const int32_t *stack, *mem_addr, *mem_val, *sto_key, *sto_val, *ctx;
};

__host__ __device__ __forceinline__ PathOut base_out(const PathIn& p) {
  PathOut o;
  o.pc = p.pc, o.halt = p.halt, o.stack_len = p.stack_len, o.mem_len = p.mem_len;
  o.mem_size = p.mem_size, o.sto_len = p.sto_len, o.cons_len = p.cons_len;
  o.gas_min = p.gas_min, o.gas_max = p.gas_max, o.depth = p.depth;
  o.n_stk = 0, o.mem_i = o.sto_i = o.cons_i = o.loop_i = -1, o.ctx_w = false;
  for (int k = 0; k < kRowsWritten; ++k) o.rows[k] = row0();
  o.f_want = false, o.f_target = 0, o.f_dest = o.f_word = o.f_cond = o.f_ncond = -1;
  o.res = -1;
  return o;
}

__host__ __device__ __forceinline__ PathOut halted(const PathIn& p, int32_t kind) {
  PathOut o = base_out(p);
  o.halt = kind;
  return o;
}

// stack[clip(len)] = row when len < STK; stack_len = len + 1.  -> ok
__host__ __device__ __forceinline__ bool push1(const SegArgs& s, PathOut& o, int32_t len,
                                               int32_t row) {
  const bool ok = len < s.STK;
  if (ok) {
    o.stk_i[o.n_stk] = clampi(len, 0, s.STK - 1);
    o.stk_v[o.n_stk++] = row;
  }
  o.stack_len = wadd(len, 1);
  return ok;
}

// pop arity, push one row; halted(PARK) on a full stack
__host__ __device__ __forceinline__ PathOut pushed(const SegArgs& s, const PathIn& p, PathOut o,
                                                   int32_t row) {
  if (!push1(s, o, wsub(p.stack_len, p.arity), row)) return halted(p, H_PARK);
  o.res = row;
  return o;
}

__host__ __device__ __forceinline__ int32_t ctx_at(const SegArgs& s, const PathIn& p, int32_t k) {
  return p.ctx[gidx(k, CTX_W)];
}

// first live memory entry at exactly addr (-1 none)
__host__ __device__ __forceinline__ int32_t mem_find(const SegArgs& s, const PathIn& p,
                                                     int32_t addr) {
  for (int32_t i = 0; i < s.MEM; ++i)
    if (i < p.mem_len && p.mem_addr[i] == addr) return i;
  return -1;
}

// a live entry overlaps [addr, addr + 32) without being an exact hit
__host__ __device__ __forceinline__ bool mem_overlap_miss(const SegArgs& s, const PathIn& p,
                                                          int32_t addr) {
  for (int32_t i = 0; i < s.MEM; ++i) {
    if (i >= p.mem_len) continue;
    const int32_t d = wsub(p.mem_addr[i], addr);
    const int32_t ad = d < 0 ? wneg(d) : d;  // |INT32_MIN| stays negative, as in XLA
    if (ad < 32 && p.mem_addr[i] != addr) return true;
  }
  return false;
}

__host__ __device__ __forceinline__ int32_t memgas(int32_t size) {
  const int32_t w = fdiv(size, 32);
  return wadd(wmul(3, w), fdiv(wmul(w, w), 512));
}

__host__ __device__ __forceinline__ void mem_gas(PathOut& o, int32_t addr, int32_t size) {
  const int32_t want = wmul(fdiv(wadd(wadd(addr, size), 31), 32), 32);
  const int32_t new_size = o.mem_size > want ? o.mem_size : want;
  const int32_t cost = wsub(memgas(new_size), memgas(o.mem_size));
  o.mem_size = new_size;
  o.gas_min = wadd(o.gas_min, cost);
  o.gas_max = wadd(o.gas_max, cost);
}

__host__ __device__ __forceinline__ bool below(const u256& v, uint64_t n) {
  return (v.w[1] | v.w[2] | v.w[3]) == 0 && v.w[0] < n;
}

__host__ __device__ inline PathOut h_binop(const SegArgs& s, const PathIn& p) {
  const int32_t opc = p.aux & 0xFF;
  const bool swap = (p.aux & 256) != 0;
  const int32_t left = swap ? p.pops[1] : p.pops[0], right = swap ? p.pops[0] : p.pops[1];
  const bool foldable = opc == A_ADD || opc == A_SUB || opc == A_MUL || opc == A_AND ||
                        opc == A_OR || opc == A_XOR || opc == A_SHL || opc == A_LSHR ||
                        opc == A_ASHR;
  PathOut o = base_out(p);
  if (p.pop_c[0] && p.pop_c[1] && foldable) {
    const u256& x = swap ? p.v1 : p.v0;
    const u256& y = swap ? p.v0 : p.v1;
    u256 f;
    switch (opc) {
      case A_ADD: f = add(x, y); break;
      case A_SUB: f = sub(x, y); break;
      case A_MUL: f = mul(x, y); break;
      case A_AND: f = bit_and(x, y); break;
      case A_OR: f = bit_or(x, y); break;
      case A_XOR: f = bit_xor(x, y); break;
      case A_SHL: f = shl(x, shift_amount(y)); break;
      case A_LSHR: f = lshr(x, shift_amount(y)); break;
      default: f = ashr(x, shift_amount(y)); break;
    }
    o.rows[0] = const_row(f);
  } else {
    o.rows[0] = mkrow(opc, left, right);
  }
  return pushed(s, p, o, p.ids[0]);
}

__host__ __device__ inline PathOut h_cmp(const SegArgs& s, const PathIn& p, int32_t row_zero,
                                         int32_t row_one) {
  PathOut o = base_out(p);
  if (p.pop_c[0] && p.pop_c[1]) {
    bool t = false;
    switch (p.aux) {
      case A_ULT: t = ult(p.v0, p.v1); break;
      case A_UGT: t = ult(p.v1, p.v0); break;
      case A_SLT: t = slt(p.v0, p.v1); break;
      case A_SGT: t = slt(p.v1, p.v0); break;
      case A_EQ: t = eq(p.v0, p.v1); break;
    }
    return pushed(s, p, o, t ? row_one : row_zero);
  }
  o.rows[0] = mkrow(p.aux, p.pops[0], p.pops[1], -1, 0);
  o.rows[1] = mkrow(A_ITEW, p.ids[0], row_one, row_zero);
  return pushed(s, p, o, p.ids[1]);
}

__host__ __device__ inline PathOut h_sha3(const SegArgs& s, const PathIn& p, int32_t row_zero) {
  const int32_t off = p.addr0, ln = p.addr1;
  const int32_t words = fdiv(wadd(ln, 31), 32);
  bool good = p.ok_addr0 && p.ok_addr1 && ln > 0 && fmod_(ln, 32) == 0 && words <= 4;
  int32_t w_rows[4];
  for (int w = 0; w < 4; ++w) {
    const int32_t a = wadd(off, 32 * w);
    const int32_t hit = mem_find(s, p, a);
    w_rows[w] = hit >= 0 ? p.mem_val[hit] : row_zero;
    if (w < words) good = good && !mem_overlap_miss(s, p, a);
  }
  PathOut o = base_out(p);
  int32_t cur = w_rows[0], cur_w = 256;
  for (int w = 1; w < 4; ++w) {
    if (words > w) {
      o.rows[w - 1] = mkrow(A_CONCAT, cur, w_rows[w], -1, wadd(cur_w, 256));
      cur = p.ids[w - 1];
      cur_w = wadd(cur_w, 256);
    }
  }
  o.rows[3] = mkrow(A_KECCAK, cur);
  const int32_t sha_gas = wadd(30, wmul(6, words));
  o.gas_min = wadd(o.gas_min, sha_gas);
  o.gas_max = wadd(o.gas_max, sha_gas);
  mem_gas(o, off, ln);
  good = push1(s, o, wsub(p.stack_len, 2), p.ids[3]) && good;
  o.res = p.ids[3];
  return good ? o : halted(p, H_PARK);
}

__host__ __device__ inline PathOut h_jumpi(const SegArgs& s, const PathIn& p, int32_t row_zero) {
  const int32_t dest_row = p.pops[0], word_row = p.pops[1];
  const bool can_take = p.ok_addr0 && p.valid0;
  const int32_t cond_row = p.ids[0], ncond_row = p.ids[1];
  const int32_t cl = clampi(p.cons_len, 0, s.CON - 1);
  const bool ok_cons = p.cons_len < s.CON;
  PathOut o = base_out(p);
  // constraint rows, written whatever the branch
  o.rows[0] = mkrow(A_NE, word_row, row_zero, -1, 0);
  o.rows[1] = mkrow(A_BNOT, cond_row, -1, -1, 0);
  if (p.pop_c[1]) {  // concrete condition: one branch, no fork
    const bool truth = !is_zero(p.v1);
    const bool take = truth && can_take, dead = truth && !can_take;
    if (ok_cons || dead) {
      o.pc = take ? p.jidx0 : wadd(p.pc, 1);
      o.depth = wadd(p.depth, 1);
      o.stack_len = wsub(p.stack_len, 2);
      if (dead) {
        o.halt = H_INVALID;
      } else {
        o.cons_i = cl, o.cons_v = take ? cond_row : ncond_row;
        o.cons_len = wadd(p.cons_len, 1);
      }
    } else {
      o.halt = H_PARK;
    }
    return o;
  }
  // symbolic condition: the state stays pristine while the taken branch is
  // viable (the batch phase applies both sides); else the fall-through only
  if (can_take) {
    if (!ok_cons) o.halt = H_PARK;
  } else if (ok_cons) {
    o.pc = wadd(p.pc, 1);
    o.depth = wadd(p.depth, 1);
    o.stack_len = wsub(p.stack_len, 2);
    o.cons_i = cl, o.cons_v = ncond_row;
    o.cons_len = wadd(p.cons_len, 1);
  } else {
    o.halt = H_PARK;
  }
  o.f_want = can_take && ok_cons;
  o.f_target = p.jidx0, o.f_dest = dest_row, o.f_word = word_row;
  o.f_cond = cond_row, o.f_ncond = ncond_row;
  return o;
}

__host__ __device__ inline PathOut dispatch(const SegArgs& s, const PathIn& p, const int32_t* loops) {
  const int32_t row_zero = s.row_zero, row_one = s.row_one;
  PathOut o = base_out(p);
  switch (clampi(p.fam, 0, F_PAGEFAULT)) {
    case F_PARK:
    case F_MSTORE8: return halted(p, H_PARK);
    case F_STOP: return halted(p, H_STOP);
    case F_INVALID: return halted(p, H_INVALID);
    case F_PAGEFAULT: return halted(p, H_PAGE_FAULT);
    case F_PUSH: return pushed(s, p, o, p.aux);
    case F_DUP: {
      const int32_t row = p.stack[clampi(wsub(p.stack_len, p.aux), 0, s.STK - 1)];
      if (!push1(s, o, p.stack_len, row)) return halted(p, H_PARK);
      o.res = row;
      return o;
    }
    case F_SWAP: {
      const int32_t i = clampi(wsub(p.stack_len, 1), 0, s.STK - 1);
      const int32_t j = clampi(wsub(wsub(p.stack_len, 1), p.aux), 0, s.STK - 1);
      o.n_stk = 2;
      o.stk_i[0] = i, o.stk_v[0] = p.stack[j];
      o.stk_i[1] = j, o.stk_v[1] = p.stack[i];
      return o;
    }
    case F_POP: o.stack_len = wsub(p.stack_len, 1); return o;
    case F_BINOP: return h_binop(s, p);
    case F_CMP: return h_cmp(s, p, row_zero, row_one);
    case F_ISZERO:
      if (p.pop_c[0]) return pushed(s, p, o, is_zero(p.v0) ? row_one : row_zero);
      o.rows[0] = mkrow(A_EQZ, p.pops[0], -1, -1, 0);
      o.rows[1] = mkrow(A_ITEW, p.ids[0], row_one, row_zero);
      return pushed(s, p, o, p.ids[1]);
    case F_NOTOP:
      o.rows[0] = p.pop_c[0] ? const_row(bit_not(p.v0)) : mkrow(A_NOT, p.pops[0]);
      return pushed(s, p, o, p.ids[0]);
    case F_ENVPUSH: return pushed(s, p, o, ctx_at(s, p, p.aux));
    case F_CALLDATALOAD:
      o.rows[0] = mkrow(A_CDLOAD, p.pops[0], ctx_at(s, p, CTX_SEED));
      return pushed(s, p, o, p.ids[0]);
    case F_BALANCE:
      o.rows[0] = mkrow(A_SELECT, ctx_at(s, p, CTX_BALANCES), p.pops[0]);
      return pushed(s, p, o, p.ids[0]);
    case F_SELFBALANCE:
      o.rows[0] = mkrow(A_SELECT, ctx_at(s, p, CTX_BALANCES), ctx_at(s, p, CTX_ADDRESS));
      return pushed(s, p, o, p.ids[0]);
    case F_GASPUSH:
      o.rows[0] = mkrow(A_VARF, p.pcr);
      return pushed(s, p, o, p.ids[0]);
    case F_MSIZE:
      o.rows[0] = const_row(u256_small((uint32_t)p.mem_size));
      return pushed(s, p, o, p.ids[0]);
    case F_SHA3: return h_sha3(s, p, row_zero);
    case F_MLOAD: {
      const int32_t hit = mem_find(s, p, p.addr0);
      const int32_t row = hit >= 0 ? p.mem_val[hit] : row_zero;
      mem_gas(o, p.addr0, 32);
      const bool ok = push1(s, o, wsub(p.stack_len, 1), row);
      o.res = row;
      return (p.ok_addr0 && ok && !mem_overlap_miss(s, p, p.addr0)) ? o : halted(p, H_PARK);
    }
    case F_MSTORE: {
      const int32_t hit = mem_find(s, p, p.addr0);
      const int32_t idx = hit >= 0 ? hit : p.mem_len;
      o.mem_i = clampi(idx, 0, s.MEM - 1), o.mem_a = p.addr0, o.mem_v = p.pops[1];
      o.mem_len = hit >= 0 ? p.mem_len : wadd(p.mem_len, 1);
      o.stack_len = wsub(p.stack_len, 2);
      mem_gas(o, p.addr0, 32);
      const bool good = p.ok_addr0 && !mem_overlap_miss(s, p, p.addr0) && idx < s.MEM;
      return good ? o : halted(p, H_PARK);
    }
    case F_SLOAD: {
      const int32_t key = p.pops[0];
      int32_t hit = -1;
      for (int32_t i = 0; i < s.STO && hit < 0; ++i)
        if (i < p.sto_len && p.sto_key[i] == key) hit = i;
      const int32_t res = hit >= 0 ? p.sto_val[hit] : p.ids[0];
      const bool ok_cap = hit >= 0 || p.sto_len < s.STO;
      if (hit < 0) {
        o.sto_i = clampi(p.sto_len, 0, s.STO - 1), o.sto_k = key, o.sto_v = p.ids[0];
        o.sto_len = wadd(p.sto_len, 1);
        o.rows[0] = mkrow(A_SELECT, ctx_at(s, p, CTX_STORAGE), key);
      }
      const bool ok = push1(s, o, wsub(p.stack_len, 1), res);
      o.res = res;
      return (ok_cap && ok) ? o : halted(p, H_PARK);
    }
    case F_SSTORE: {
      const int32_t key = p.pops[0], val = p.pops[1];
      o.rows[0] = mkrow(A_STORE, ctx_at(s, p, CTX_STORAGE), key, val, 0);
      int32_t hit = -1;
      for (int32_t i = 0; i < s.STO && hit < 0; ++i)
        if (i < p.sto_len && p.sto_key[i] == key) hit = i;
      const int32_t idx = hit >= 0 ? hit : p.sto_len;
      o.sto_i = clampi(idx, 0, s.STO - 1), o.sto_k = key, o.sto_v = val;
      o.sto_len = hit >= 0 ? p.sto_len : wadd(p.sto_len, 1);
      o.ctx_w = true, o.ctx_storage = p.ids[0];
      o.stack_len = wsub(p.stack_len, 2);
      return idx < s.STO ? o : halted(p, H_PARK);
    }
    case F_JUMP:
      if (!(p.ok_addr0 && p.valid0)) return halted(p, H_INVALID);
      o.pc = p.jidx0, o.depth = wadd(p.depth, 1), o.stack_len = wsub(p.stack_len, 1);
      return o;
    case F_JUMPI: return h_jumpi(s, p, row_zero);
    case F_JUMPDEST: {
      if (p.lid >= 0) {  // ids beyond the loops cap are unbounded
        const int32_t count = wadd(loops[gidx(p.lid, s.NL)], 1);
        if (p.lid < s.NL) o.loop_i = p.lid, o.loop_v = count;
        if (s.loop_bound > 0 && count > s.loop_bound) o.halt = H_LOOP;
      }
      return o;
    }
    case F_LOG: o.stack_len = wsub(p.stack_len, p.arity); return o;
    case F_RETURN:
      o.halt = p.aux == 1 ? H_REVERT : H_RETURN;
      o.stack_len = wsub(p.stack_len, 2);
      return o;
    case F_SELFDESTRUCT:
      o.halt = H_SELFDESTRUCT;
      o.stack_len = wsub(p.stack_len, 1);
      return o;
    case F_SIGNEXTEND: {
      if (p.pop_c[0] && p.pop_c[1]) {
        u256 f = p.v1;
        if (below(p.v0, 31)) {
          const unsigned bits = 8 * ((unsigned)p.v0.w[0] + 1);
          const u256 mask_m1 = sub(shl(u256_small(1), bits), u256_small(1));
          const u256 low = bit_and(p.v1, mask_m1);
          const bool neg = lshr(p.v1, bits - 1).w[0] & 1;
          f = neg ? bit_or(low, bit_not(mask_m1)) : low;
        }
        o.rows[0] = const_row(f);
      } else {
        o.rows[0] = mkrow(A_SIGNEXT, p.pops[0], p.pops[1]);
      }
      return pushed(s, p, o, p.ids[0]);
    }
    case F_BYTEOP: {
      if (p.pop_c[0] && p.pop_c[1]) {
        u256 f = u256_zero();
        if (below(p.v0, 32)) f.w[0] = lshr(p.v1, 8 * (31 - (unsigned)p.v0.w[0])).w[0] & 0xFF;
        o.rows[0] = const_row(f);
      } else {
        o.rows[0] = mkrow(A_BYTE, p.pops[0], p.pops[1]);
      }
      return pushed(s, p, o, p.ids[0]);
    }
    default:  // F_ADDMODOP
      o.rows[0] = mkrow(p.aux, p.pops[0], p.pops[1], p.pops[2]);
      return pushed(s, p, o, p.ids[0]);
  }
}

__host__ __device__ __forceinline__ void mark(const SegArgs& s, int32_t plane, int32_t cid,
                                              int32_t pc) {
  if (cid >= 0 && cid < s.Cv) s.visited[((int64_t)plane * s.Cv + cid) * s.Iv + pc] = 1;
}

// Phase 1: path b's step (ranks are over the running and the free paths
// before b).  Writes the path's new state, its R rows, its fork request.
__host__ __device__ inline void phase_step(const SegArgs& s, int32_t b, int32_t arena_len,
                                           int32_t live_rank, int32_t free_rank) {
  s.f_want[b] = 0, s.f_target[b] = 0, s.f_dest[b] = 0, s.f_word[b] = 0, s.f_cond[b] = 0;
  s.f_ncond[b] = 0, s.child[b] = s.B, s.src_of[b] = -1;
  const int32_t seed = s.seed[b];
  if (seed < 0) s.free_list[free_rank] = b;
  const int32_t halt0 = s.halt[b];
  if (!(halt0 == H_RUNNING && seed >= 0)) {
    // dead slots' ids are caps.ARENA: their zero rows land only when the
    // arena holds more than caps.ARENA rows
    if (s.ARENA < s.T) {
      Row z = row0();
      z.a = z.b = z.c = 0;
      write_row(s, s.ARENA, z);
    }
    return;
  }
  const int64_t sb = b;
  PathIn p;
  p.b = b, p.pc = s.pc[b], p.halt = halt0, p.stack_len = s.stack_len[b];
  p.mem_len = s.mem_len[b], p.mem_size = s.mem_size[b], p.sto_len = s.sto_len[b];
  p.cons_len = s.cons_len[b], p.gas_min = s.gas_min[b], p.gas_max = s.gas_max[b];
  p.depth = s.depth[b];
  p.stack = s.stack + sb * s.STK, p.mem_addr = s.mem_addr + sb * s.MEM;
  p.mem_val = s.mem_val + sb * s.MEM, p.sto_key = s.sto_key + sb * s.STO;
  p.sto_val = s.sto_val + sb * s.STO, p.ctx = s.ctx + sb * CTX_W;
  const int32_t code_id = s.code_id[b];
  s.steps[b] = wadd(s.steps[b], 1);
  // coverage: the instruction plane at the TRUE pc
  const int32_t cid_live = clampi(code_id, 0, s.Cv - 1);
  const int32_t pc_v = clampi(p.pc, 0, s.Iv - 1);
  mark(s, 0, cid_live, pc_v);
  const int32_t base = wadd(arena_len, wmul(live_rank, s.R));
  for (int k = 0; k < kRowsWritten; ++k) p.ids[k] = wadd(base, k);

  // decode against the resident window
  p.cid = clampi(code_id, 0, s.C - 1);
  const int64_t crow = (int64_t)p.cid * s.N;
  const int32_t rel = wsub(p.pc, s.pbase[p.cid]);
  p.infault = rel < 0 || rel >= s.N;
  p.pcr = clampi(rel, 0, s.N - 1);
  p.fam = p.infault ? F_PAGEFAULT : s.fam[crow + p.pcr];
  p.aux = s.aux[crow + p.pcr];
  p.arity = p.infault ? 0 : s.arity[crow + p.pcr];
  p.underflow = p.stack_len < p.arity;
  for (int j = 0; j < 7; ++j) {
    p.pops[j] = j < p.arity ? p.stack[clampi(wsub(wsub(p.stack_len, 1), j), 0, s.STK - 1)] : -1;
    p.pop_c[j] = p.pops[j] >= 0 && ld_cg(s.a_isconst + clampi(p.pops[j], 0, s.T - 1)) != 0;
  }
  p.v0 = limbs_to_u256(s.a_val + 16 * (int64_t)clampi(p.pops[0], 0, s.T - 1));
  p.v1 = limbs_to_u256(s.a_val + 16 * (int64_t)clampi(p.pops[1], 0, s.T - 1));
  // (is a concrete byte address below 2^20, address) of the first two pops
  p.ok_addr0 = p.pop_c[0] && below(p.v0, 1u << 20);
  p.ok_addr1 = p.pop_c[1] && below(p.v1, 1u << 20);
  p.addr0 = (int32_t)(uint32_t)p.v0.w[0];
  p.addr1 = (int32_t)(uint32_t)p.v1.w[0];
  p.jidx0 = s.jumpmap[(int64_t)p.cid * s.A + clampi(p.addr0, 0, s.A - 1)];
  p.valid0 = p.addr0 < s.A && p.jidx0 >= 0;
  p.lid = s.loopid[crow + p.pcr];
  int32_t* loops = s.loops + sb * s.NL;

  PathOut o = dispatch(s, p, loops);
  // STATICCALL write protection, then underflow: the path halts INVALID
  const bool write_viol = s.statc[b] != 0 &&
                          (p.fam == F_SSTORE || p.fam == F_LOG || p.fam == F_SELFDESTRUCT);
  if (write_viol || p.underflow) o = halted(p, H_INVALID);

  // the common tail
  const bool pending = o.f_want;
  const bool terminalish = o.halt != H_RUNNING;
  if (!(pending || terminalish || o.pc != p.pc)) o.pc = wadd(o.pc, 1);
  if (!(terminalish || pending)) {
    o.gas_min = wadd(o.gas_min, s.gmin[crow + p.pcr]);
    o.gas_max = wadd(o.gas_max, s.gmax[crow + p.pcr]);
  }
  if (o.depth > s.max_depth && o.halt == H_RUNNING) o.halt = H_DEPTH;

  // event
  const bool is_jumpi = p.fam == F_JUMPI;
  const int32_t h = o.halt;
  const bool terminal_halt = h == H_STOP || h == H_RETURN || h == H_REVERT ||
                             h == H_SELFDESTRUCT || h == H_INVALID;
  bool all_conc = true;
  for (int j = 0; j < 7; ++j) all_conc = all_conc && (p.arity <= j || p.pop_c[j]);
  const bool panic = p.pop_c[1] && u256_limb(p.v1, 14) == 0x7B71u && u256_limb(p.v1, 15) == 0x4E48u;
  const bool emit = s.event[crow + p.pcr] && !p.infault && !pending && !p.underflow &&
                    !(s.concskip[crow + p.pcr] && all_conc) && !(s.valgate[crow + p.pcr] && !panic) &&
                    h != H_PARK && h != H_PAGE_FAULT && h != H_DEPTH && h != H_LOOP;
  const int32_t ev_len = s.ev_len[b];
  const bool ev_ok = ev_len < s.EVT;
  if (emit && ev_ok) {
    const bool died = h == H_INVALID;
    const int32_t lc = clampi(wsub(o.cons_len, 1), 0, s.CON - 1);
    const int32_t last_cons = lc == o.cons_i ? o.cons_v : s.cons[sb * s.CON + lc];
    int32_t* ev = s.events + (sb * s.EVT + clampi(ev_len, 0, s.EVT - 1)) * EV_W;
    ev[0] = is_jumpi ? E_FORK : (terminal_halt ? E_TERMINAL : E_HOOK);
    ev[1] = p.pc, ev[2] = p.gas_min, ev[3] = p.gas_max;
    for (int j = 0; j < 7; ++j) ev[4 + j] = p.pops[j];
    if (is_jumpi && !died) ev[6] = last_cons;
    ev[11] = is_jumpi ? o.pc : o.res;
    ev[12] = (is_jumpi && died) ? -3 : -1;
    s.ev_len[b] = wadd(ev_len, 1);
  }
  if (emit && !ev_ok && o.halt == H_RUNNING) o.halt = H_PARK;

  // the new state
  s.pc[b] = o.pc, s.halt[b] = o.halt, s.stack_len[b] = o.stack_len, s.mem_len[b] = o.mem_len;
  s.mem_size[b] = o.mem_size, s.sto_len[b] = o.sto_len, s.cons_len[b] = o.cons_len;
  s.gas_min[b] = o.gas_min, s.gas_max[b] = o.gas_max, s.depth[b] = o.depth;
  for (int k = 0; k < o.n_stk; ++k) s.stack[sb * s.STK + o.stk_i[k]] = o.stk_v[k];
  if (o.mem_i >= 0) s.mem_addr[sb * s.MEM + o.mem_i] = o.mem_a, s.mem_val[sb * s.MEM + o.mem_i] = o.mem_v;
  if (o.sto_i >= 0) s.sto_key[sb * s.STO + o.sto_i] = o.sto_k, s.sto_val[sb * s.STO + o.sto_i] = o.sto_v;
  if (o.ctx_w) s.ctx[sb * CTX_W + CTX_STORAGE] = o.ctx_storage;
  if (o.cons_i >= 0) s.cons[sb * s.CON + o.cons_i] = o.cons_v;
  if (o.loop_i >= 0) loops[o.loop_i] = o.loop_v;
  // its rows (rows past the fourth stay empty)
  for (int k = 0; k < s.R; ++k) write_row(s, wadd(base, k), k < kRowsWritten ? o.rows[k] : row0());
  // its fork request, and what the grant needs of the incoming state
  s.f_want[b] = o.f_want, s.f_target[b] = o.f_target, s.f_dest[b] = o.f_dest;
  s.f_word[b] = o.f_word, s.f_cond[b] = o.f_cond, s.f_ncond[b] = o.f_ncond;
  s.pre_pc[b] = p.pc, s.pre_gmin[b] = p.gas_min, s.pre_gmax[b] = p.gas_max;
  // edge coverage of a JUMPI decided in place (a fork marks at its grant)
  const int32_t cl = clampi(cid_live, 0, s.C - 1);
  const int32_t fh = s.fam[(int64_t)cl * s.N + clampi(wsub(p.pc, s.pbase[cl]), 0, s.N - 1)];
  if (fh == F_JUMPI && !o.f_want && o.halt == H_RUNNING)
    mark(s, o.pc == wadd(p.pc, 1) ? 2 : 1, cid_live, pc_v);
}

// Phase 2: the grant's sort key, -score for a path that wants a fork and
// has room for its E_FORK event, else INT32_MAX.  (A wanting path's depth
// and score are its incoming ones: its state stays pristine.)
__host__ __device__ inline void phase_key(const SegArgs& s, int32_t b) {
  const bool want = s.f_want[b] && s.ev_len[b] < s.EVT;
  int32_t score = 0;
  switch (s.sel_mode) {
    case SEL_DEEP: score = s.depth[b]; break;
    case SEL_SHALLOW: score = wneg(s.depth[b]); break;
    case SEL_COVERAGE: {
      const int32_t cid = clampi(s.code_id[b], 0, s.Cv - 1);
      const int32_t t = clampi(s.f_target[b], 0, s.Iv - 1);
      const bool covered = ld_cg(s.visited + (int64_t)cid * s.Iv + t) != 0;
      score = wadd(covered ? 0 : (1 << 20), s.depth[b]);
      break;
    }
    case SEL_BEAM: score = s.score[b]; break;
  }
  s.want[b] = want;
  s.key[b] = want ? wneg(score) : INT32_MAX;
}

// Phase 3: a wanting path's rank in the stable order of keys; the first
// n_free get the free slots in ascending order.
__host__ __device__ inline void phase_grant(const SegArgs& s, int32_t b, int32_t n_free) {
  if (!s.want[b]) return;
  const int32_t kb = s.key[b];
  int32_t rank = 0;
  for (int32_t j = 0; j < s.B; ++j) {
    const int32_t kj = ld_cg(s.key + j);
    rank += (kj < kb) || (kj == kb && j < b);
  }
  if (rank < n_free) {
    const int32_t c = ld_cg(s.free_list + rank);
    s.child[b] = c;
    s.src_of[c] = b;
  }
}

// the JUMPI's static gas and both edges' bookkeeping on slot b, forked
// from the JUMPI at jumpi_true onto branch_pc with branch_row appended
__host__ __device__ __forceinline__ void apply_branch(const SegArgs& s, int32_t b,
                                                      int32_t jumpi_true, int32_t branch_pc,
                                                      int32_t branch_row, int32_t plane) {
  const int64_t sb = b;
  const int32_t cid2 = clampi(s.code_id[b], 0, s.C - 1);
  const int32_t rel = clampi(wsub(jumpi_true, s.pbase[cid2]), 0, s.N - 1);
  mark(s, plane, cid2, clampi(jumpi_true, 0, s.Iv - 1));
  s.pc[b] = branch_pc;
  s.depth[b] = wadd(s.depth[b], 1);
  s.stack_len[b] = wsub(s.stack_len[b], 2);
  s.gas_min[b] = wadd(s.gas_min[b], s.gmin[(int64_t)cid2 * s.N + rel]);
  s.gas_max[b] = wadd(s.gas_max[b], s.gmax[(int64_t)cid2 * s.N + rel]);
  s.cons[sb * s.CON + clampi(s.cons_len[b], 0, s.CON - 1)] = branch_row;
  s.cons_len[b] = wadd(s.cons_len[b], 1);
}

// Phase 4: a granted child slot c copies its parent's new state and takes
// the branch (the parent does not change its row in this phase).
__host__ __device__ inline void phase_child(const SegArgs& s, int32_t c) {
  const int32_t p = s.src_of[c];
  if (p < 0) return;
  const int64_t sc = c, sp = p;
  int32_t* const rows1[] = {s.pc, s.halt, s.seed, s.code_id, s.steps, s.score, s.stack_len,
                            s.mem_len, s.mem_size, s.sto_len, s.cons_len, s.gas_min, s.gas_max,
                            s.depth, s.statc};
  for (int32_t* f : rows1) f[sc] = ld_cg(f + sp);
  struct Wide { int32_t* f; int32_t w; };
  const Wide rows2[] = {{s.stack, s.STK}, {s.mem_addr, s.MEM}, {s.mem_val, s.MEM},
                        {s.sto_key, s.STO}, {s.sto_val, s.STO}, {s.ctx, CTX_W},
                        {s.cons, s.CON}, {s.loops, s.NL}};
  for (const Wide& x : rows2)
    for (int32_t i = 0; i < x.w; ++i) x.f[sc * x.w + i] = ld_cg(x.f + sp * x.w + i);
  for (int64_t i = 0; i < (int64_t)s.EVT * EV_W; ++i) s.events[sc * s.EVT * EV_W + i] = -1;
  s.ev_len[c] = 0, s.steps[c] = 0, s.halt[c] = H_RUNNING;
  apply_branch(s, c, ld_cg(s.pre_pc + p), ld_cg(s.f_target + p), ld_cg(s.f_cond + p), 1);
}

// Phase 5: a granted parent takes the fall-through and records E_FORK with
// its child's slot; a denied fork, or one without room for its event, pends.
__host__ __device__ inline void phase_parent(const SegArgs& s, int32_t b) {
  const int32_t child = s.child[b];
  const int32_t ev_len = s.ev_len[b];
  if ((s.f_want[b] && !(ev_len < s.EVT)) || (s.want[b] && child >= s.B)) s.halt[b] = H_PENDING_FORK;
  if (child >= s.B) return;
  const int32_t jumpi_true = s.pre_pc[b];
  apply_branch(s, b, jumpi_true, wadd(jumpi_true, 1), s.f_ncond[b], 2);
  if (ev_len < s.EVT) {
    int32_t* ev = s.events + ((int64_t)b * s.EVT + clampi(ev_len, 0, s.EVT - 1)) * EV_W;
    const int32_t payload[EV_W] = {E_FORK, jumpi_true, s.pre_gmin[b], s.pre_gmax[b], s.f_dest[b],
                                   s.f_word[b], s.f_cond[b], s.f_ncond[b], s.f_target[b], -1, -1,
                                   -1, child};
    for (int j = 0; j < EV_W; ++j) ev[j] = payload[j];
    s.ev_len[b] = wadd(ev_len, 1);
  } else {
    s.halt[b] = H_PARK;
  }
}

__host__ __device__ __forceinline__ void path_flags(const SegArgs& s, int32_t b, bool* run,
                                                    bool* fr) {
  const int32_t seed = s.seed[b];
  *run = s.halt[b] == H_RUNNING && seed >= 0;
  *fr = seed < 0;
}

}  // namespace mk
