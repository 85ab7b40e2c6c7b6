// The frontier segment's body: one EVM step of one path, the batch phases
// around it and the loop over steps, for the kernel (frontier_segment.cu)
// and the host check (host_check.cpp).
//
// Replaces the per-path and per-batch halves of the jitted segment in
// mythril_tpu/frontier/step.py (build_segment: path_step, batch_step).
// Semantics are the JAX program's bit for bit, written for one thread per
// path instead of a vmapped lax.switch:
//
//   * one handler runs per path (a switch over the 33 families) and writes
//     its effect in place into an Out: the scalar fields it sets, at most
//     two stack writes and one write each to memory, storage, ctx, cons and
//     loops, and four rows; a handler that fails its guard becomes
//     halted(kind), as the JAX select does;
//   * gathers clamp their index as XLA does (a negative index wraps once
//     first); scatters drop an index outside the array; int32 arithmetic
//     wraps (done in uint32_t); // and % floor;
//   * the fork grant ranks the wanting paths by (-score, slot): the stable
//     argsort's order, as a count.
//
// State, arena and coverage planes stay in the JAX layout in device memory
// (int32 fields, arena values as [T, 16] 16-bit limbs).  The code tables
// are read through a port-only packed row per instruction (code_rows, [C,
// N, 8] int32, made by the wrapper from CodeDev): one 32-byte read decodes
// an instruction.
//
// The loop (run_segment) is written once for an executor X that owns some
// lanes (a CUDA thread owns one, the host check all of them):
//
//   X::begin(), X::step(arena_len, window), X::keys(), X::parent()
//                  run a phase (lane_begin, step, fork_key into the list,
//                  fork_parent) on every lane it owns;
//   X::sync()      the barrier (the host check: nothing, each phase has
//                  finished for every lane);
//   X::publish(p)  counts each warp's running, free and fork-wanting lanes
//                  into count buffer p (ballots on the card);
//   X::counts(p)   reads buffer p: totals and every lane's ranks;
//   X::grant, X::child_items: the grant's count over the list and the
//                  cooperative child copy.
//
// A step is:
//
//   step: each running path decodes (from registers read ahead at the end
//     of the previous step), runs its handler, writes its state, rows,
//     event and coverage (a free slot writes its place in the free list);
//     every lane then publishes its post-step flags
//     (running, free, wants a fork) into the count buffer of the step's
//     parity, and reads ahead for the next step;
//   one barrier; every lane reads the counts.  When no path wants a fork
//     (f_want), the flags are final: the next step starts.  Else:
//   key: each fork-wanting path puts (key, slot, want) at its rank in a
//     compact list; barrier;
//   grant: a wanting path counts, over the list in shared memory, the keys
//     before its own (the stable argsort's rank) and, when the rank is
//     below the free count, takes the free slot of that rank and leaves a
//     grant record (parent, child and what the copy needs of the parent) at
//     its rank among the wanting paths; barrier;
//   child: the records are staged in shared memory; warps take units of
//     the copies: a child's scalars with the branch applied and its event
//     buffer reset, then its wide fields 256 words at a time; barrier;
//   parent: a granted parent takes the fall-through and records E_FORK;
//     denied forks pend; a slot that became a child reloads its row; every
//     lane republishes its flags; barrier; counts.
//
// Cross-path data (the arena, the coverage planes, the grant's scratch, a
// row that a child copy wrote) is read through ld_cg (L2, not the SM's L1),
// and so is a path's own row.  Reading ahead before the barrier is safe
// because a path's own row is written only by its thread (a child's by the
// copy, which is followed by a reload), and an arena row is read early only
// when no path can write it in the step (below the step's first new row or
// among the path's own new rows); any other popped row is read again after
// the barrier.
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
// the packed code row (code_rows): fam, aux, arity, gmin | gmax, loopid, flags, 0
enum : int32_t { CODE_ROW_W = 8, CF_EVENT = 1, CF_CONCSKIP = 2, CF_VALGATE = 4 };
// a grant record: what a child's copy needs of its parent, in two 16-byte words
enum : int32_t {
  G_PARENT, G_CHILD, G_PC, G_TARGET, G_COND, G_GMIN, G_GMAX, G_CONS_LEN, GRANT_W,
};
constexpr int kRowsWritten = 4;  // rows a handler may write (SHA3); caps.R >= 4
constexpr int kWarp = 32;
constexpr int kBlock = 128;  // threads per block, one path each
constexpr int kWarpsPerBlock = kBlock / kWarp;
constexpr int kTile = 1024;     // grant-list entries staged in shared memory at a time
constexpr int kRecTile = 256;  // grant records staged in shared memory at a time

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
  // code tables [C, N] (jumpmap [C, A], pbase [C]) and the packed rows
  const int32_t *fam, *aux, *arity, *gmin, *gmax;
  const uint8_t* event;
  const int32_t *jumpmap, *loopid;
  const uint8_t *concskip, *valgate;
  const int32_t* pbase;
  const int32_t* code_rows;  // [C, N, CODE_ROW_W]
  // scratch: free_list [B]; fkeys [B, 2]; grants [B, GRANT_W] (-1 on
  // entry); cnt [2, 4 * blocks]; out [3]: arena_len, n_exec, max_live
  int32_t *free_list, *fkeys, *grants, *cnt, *out;
  // the arena length the segment starts from, read from memory when the
  // segment starts: a chained segment reads its predecessor's out[0], so
  // the host never waits for that value before queueing the launch
  const int32_t* arena_len0;
  int32_t B, STK, MEM, STO, CON, EVT, R, K, ARENA, NL, T, C, N, A, Cv, Iv;
  int32_t max_depth, loop_bound, row_zero, row_one, sel_mode, k_limit;
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

// ---- loads and stores ---------------------------------------------------

struct I2 {
  int32_t x, y;
};
struct I4 {
  int32_t x, y, z, w;
};

// A load of data another thread may have written since the last barrier.
template <typename X>
__host__ __device__ __forceinline__ X ld_cg(const X* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

__host__ __device__ __forceinline__ I2 ld_cg2(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int2 q = __ldcg(reinterpret_cast<const int2*>(p));
  return I2{q.x, q.y};
#else
  return I2{p[0], p[1]};
#endif
}

__host__ __device__ __forceinline__ I4 ld_cg4(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int4 q = __ldcg(reinterpret_cast<const int4*>(p));
  return I4{q.x, q.y, q.z, q.w};
#else
  return I4{p[0], p[1], p[2], p[3]};
#endif
}

__host__ __device__ __forceinline__ void st4(int32_t* p, I4 v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(p) = make_int4(v.x, v.y, v.z, v.w);
#else
  p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
#endif
}

// the code tables, which no thread writes: the read-only path
__host__ __device__ __forceinline__ int32_t ld_ro(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

__host__ __device__ __forceinline__ I4 ld_ro4(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  return I4{q.x, q.y, q.z, q.w};
#else
  return I4{p[0], p[1], p[2], p[3]};
#endif
}

// ---- arena rows ---------------------------------------------------------

__host__ __device__ __forceinline__ u256 limbs_to_u256(const int32_t* v) {
  u256 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#if defined(__CUDA_ARCH__)
    const int4 q = __ldcg(reinterpret_cast<const int4*>(v) + i);
    const uint32_t l0 = q.x, l1 = q.y, l2 = q.z, l3 = q.w;
#else
    const uint32_t l0 = v[4 * i], l1 = v[4 * i + 1], l2 = v[4 * i + 2], l3 = v[4 * i + 3];
#endif
    r.w[i] = (uint64_t)(uint16_t)l0 | ((uint64_t)(uint16_t)l1 << 16) |
             ((uint64_t)(uint16_t)l2 << 32) | ((uint64_t)(uint16_t)l3 << 48);
  }
  return r;
}

__host__ __device__ __forceinline__ uint32_t u256_limb(const u256& a, int j) {
  return (uint32_t)(a.w[j >> 2] >> (16 * (j & 3))) & 0xFFFFu;
}

// A row's columns other than its value.
struct Meta {
  int32_t op, a, b, c, width;
};

__host__ __device__ __forceinline__ Meta meta(int32_t op, int32_t a = -1, int32_t b = -1,
                                              int32_t c = -1, int32_t width = 256) {
  return Meta{op, a, b, c, width};
}

__host__ __device__ __forceinline__ Meta meta0() { return Meta{0, -1, -1, -1, 0}; }

__host__ __device__ __forceinline__ void write_row(const SegArgs& s, int32_t id, const Meta& r,
                                                   bool isconst, const u256& val) {
  const int32_t i = sidx(id, s.T);
  if (i < 0) return;
  s.a_op[i] = r.op, s.a_a[i] = r.a, s.a_b[i] = r.b, s.a_c[i] = r.c, s.a_width[i] = r.width;
  s.a_isconst[i] = isconst;
  int32_t* v = s.a_val + 16 * (int64_t)i;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int32_t l0 = u256_limb(val, 4 * q), l1 = u256_limb(val, 4 * q + 1);
    const int32_t l2 = u256_limb(val, 4 * q + 2), l3 = u256_limb(val, 4 * q + 3);
#if defined(__CUDA_ARCH__)
    reinterpret_cast<int4*>(v)[q] = make_int4(l0, l1, l2, l3);
#else
    v[4 * q] = l0, v[4 * q + 1] = l1, v[4 * q + 2] = l2, v[4 * q + 3] = l3;
#endif
  }
}

__host__ __device__ __forceinline__ void mark(const SegArgs& s, int32_t plane, int32_t cid,
                                              int32_t pc) {
  if (cid >= 0 && cid < s.Cv) s.visited[((int64_t)plane * s.Cv + cid) * s.Iv + pc] = 1;
}

// ---- one lane's registers ---------------------------------------------------

// What a thread keeps across steps and phases for its slot b.
struct Lane {
  int32_t b;  // may be >= B: a thread past the batch takes part in barriers and copies only
  // the slot's scalars (the row holds the same values)
  int32_t pc, halt, seed, code_id, steps, score, stack_len, mem_len, mem_size, sto_len, cons_len,
      gas_min, gas_max, depth, statc, ev_len, pbase;
  // read ahead for the next step: the decoded code row, the top seven stack
  // words and DUP's and SWAP's operands, the popped rows' const flags (bit
  // j) and the first two pops' values; `stale` marks the popped rows to
  // read again after the barrier (bits 0-6 flags, 7 and 8 the values)
  int32_t pcr, fam, fam_raw, aux, arity, gmin, gmax, lid, cflags;
  bool infault;
  int32_t top[7];
  int32_t sdup, sswp;
  uint32_t isc, stale;
  u256 v0, v1;
  // flags after the step, ranks within the warp, and the counts
  bool run, free, fwant;
  int32_t live_w, free_w, fwant_w;
  int32_t n_live, n_free, n_fwant, live_rank, free_rank, fwant_rank;
  // this step's fork request (with the JUMPI's static gas) and its grant
  bool want;
  int32_t f_target, f_dest, f_word, f_cond, f_ncond, pre_pc, pre_gmin, pre_gmax, f_gmin, f_gmax;
  int32_t key, child, wr;
  bool dead_row;  // this slot wrote the dead slots' zero row
};

// Arena rows that are final while a step runs: [0, end) (all, when `all`),
// and the path's own new rows [own, own + R).
struct Window {
  bool all;
  int32_t end;
};

__host__ __device__ __forceinline__ bool row_final(const SegArgs& s, const Window& w,
                                                   int32_t own, int32_t id) {
  if (w.all) return true;
  if (id >= own && (int64_t)id < (int64_t)own + s.R) return true;
  return id >= 0 && id < w.end && !(id == s.ARENA && s.ARENA < s.T);
}

// The popped rows' const flags and the first two values (every pop below
// the arity, whatever the family: the reads have no effect).
__host__ __device__ __forceinline__ void read_pops(const SegArgs& s, Lane& l, const Window& w,
                                                   int32_t own) {
  uint32_t isc = 0, stale = 0;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int32_t id = clampi(l.top[j], 0, s.T - 1);
    if (j < l.arity && l.top[j] >= 0) {
      isc |= (uint32_t)(ld_cg(s.a_isconst + id) != 0) << j;
      stale |= (uint32_t)!row_final(s, w, own, id) << j;
    }
  }
  const int32_t i0 = clampi(l.arity > 0 ? l.top[0] : -1, 0, s.T - 1);
  const int32_t i1 = clampi(l.arity > 1 ? l.top[1] : -1, 0, s.T - 1);
  l.v0 = limbs_to_u256(s.a_val + 16 * (int64_t)i0);
  l.v1 = limbs_to_u256(s.a_val + 16 * (int64_t)i1);
  stale |= (uint32_t)!row_final(s, w, own, i0) << 7 | (uint32_t)!row_final(s, w, own, i1) << 8;
  l.isc = isc, l.stale = stale;
}

// Read ahead what the slot's next step decodes: the code row, the stack's
// top and the popped rows.  `own` is the first of the rows the slot wrote
// in the step that just ran.
__host__ __device__ __forceinline__ void read_ahead(const SegArgs& s, Lane& l, const Window& w,
                                                    int32_t own) {
  if (!(l.halt == H_RUNNING && l.seed >= 0)) return;
  const int32_t cid = clampi(l.code_id, 0, s.C - 1);
  const int32_t rel = wsub(l.pc, l.pbase);
  l.infault = rel < 0 || rel >= s.N;
  l.pcr = clampi(rel, 0, s.N - 1);
  const int32_t* cr = s.code_rows + ((int64_t)cid * s.N + l.pcr) * CODE_ROW_W;
  const I4 r0 = ld_ro4(cr), r1 = ld_ro4(cr + 4);
  const int32_t* stk = s.stack + (int64_t)l.b * s.STK;
#pragma unroll
  for (int j = 0; j < 7; ++j) l.top[j] = ld_cg(stk + clampi(wsub(wsub(l.stack_len, 1), j), 0, s.STK - 1));
  l.fam_raw = r0.x, l.aux = r0.y, l.gmin = r0.w, l.gmax = r1.x, l.lid = r1.y, l.cflags = r1.z;
  l.fam = l.infault ? F_PAGEFAULT : r0.x;
  l.arity = l.infault ? 0 : r0.z;
  if (l.fam == F_DUP || l.fam == F_SWAP) {
    l.sdup = ld_cg(stk + clampi(wsub(l.stack_len, l.aux), 0, s.STK - 1));
    l.sswp = ld_cg(stk + clampi(wsub(wsub(l.stack_len, 1), l.aux), 0, s.STK - 1));
  }
  read_pops(s, l, w, own);
}

// The slot's scalars from its row (at the start, and for a new child).
__host__ __device__ __forceinline__ void load_scalars(const SegArgs& s, Lane& l) {
  const int32_t b = l.b;
  l.pc = ld_cg(s.pc + b), l.halt = ld_cg(s.halt + b), l.seed = ld_cg(s.seed + b);
  l.code_id = ld_cg(s.code_id + b), l.steps = ld_cg(s.steps + b), l.score = ld_cg(s.score + b);
  l.stack_len = ld_cg(s.stack_len + b), l.mem_len = ld_cg(s.mem_len + b);
  l.mem_size = ld_cg(s.mem_size + b), l.sto_len = ld_cg(s.sto_len + b);
  l.cons_len = ld_cg(s.cons_len + b), l.gas_min = ld_cg(s.gas_min + b);
  l.gas_max = ld_cg(s.gas_max + b), l.depth = ld_cg(s.depth + b), l.statc = ld_cg(s.statc + b);
  l.ev_len = ld_cg(s.ev_len + b);
}

__host__ __device__ __forceinline__ void set_flags(Lane& l) {
  l.run = l.halt == H_RUNNING && l.seed >= 0;
  l.free = l.seed < 0;
}

// Before the loop: the slot's scalars, flags and first read-ahead.
__host__ __device__ __forceinline__ void lane_begin(const SegArgs& s, Lane& l) {
  l.run = l.free = l.fwant = l.want = l.dead_row = false;
  l.child = -1, l.wr = -1, l.stale = 0, l.isc = 0;
  if (l.b >= s.B) return;
  load_scalars(s, l);
  l.pbase = ld_ro(s.pbase + clampi(l.code_id, 0, s.C - 1));
  set_flags(l);
  read_ahead(s, l, Window{true, 0}, 0);
}

// ---- one path's step ------------------------------------------------------

// The incoming path as the handlers see it (the JAX path_step's locals).
struct In {
  int64_t sb;  // the slot, as a row offset
  int32_t cid, fam, aux, arity, lid;
  int32_t ids[kRowsWritten];
  int32_t pops[7];
  bool pop_c[7];
  bool ok_addr0, ok_addr1, valid0;
  int32_t addr0, addr1, jidx0;
};

// A handler's effect, written in place.
struct Out {
  int32_t pc, halt, stack_len, mem_len, mem_size, sto_len, cons_len, gas_min, gas_max, depth;
  int32_t n_stk, stk_i0, stk_v0, stk_i1, stk_v1;
  int32_t mem_i, mem_a, mem_v, sto_i, sto_k, sto_v, ctx_storage, cons_i, cons_v, loop_i, loop_v;
  bool ctx_w;
  Meta rows[kRowsWritten];
  bool isconst0;  // only the first row can be a folded constant
  u256 val0;
  bool f_want;
  int32_t f_target, f_dest, f_word, f_cond, f_ncond, res;
};

__host__ __device__ __forceinline__ void base_out(Out& o, const Lane& l) {
  o.pc = l.pc, o.halt = l.halt, o.stack_len = l.stack_len, o.mem_len = l.mem_len;
  o.mem_size = l.mem_size, o.sto_len = l.sto_len, o.cons_len = l.cons_len;
  o.gas_min = l.gas_min, o.gas_max = l.gas_max, o.depth = l.depth;
  o.n_stk = 0, o.stk_i0 = o.stk_v0 = o.stk_i1 = o.stk_v1 = 0;
  o.mem_i = o.sto_i = o.cons_i = o.loop_i = -1;
  o.mem_a = o.mem_v = o.sto_k = o.sto_v = o.ctx_storage = o.cons_v = o.loop_v = 0;
  o.ctx_w = false;
#pragma unroll
  for (int k = 0; k < kRowsWritten; ++k) o.rows[k] = meta0();
  o.isconst0 = false, o.val0 = u256_zero();
  o.f_want = false, o.f_target = 0, o.f_dest = o.f_word = o.f_cond = o.f_ncond = -1;
  o.res = -1;
}

__host__ __device__ __forceinline__ void halted(Out& o, const Lane& l, int32_t kind) {
  base_out(o, l);
  o.halt = kind;
}

__host__ __device__ __forceinline__ void const_row0(Out& o, const u256& v) {
  o.rows[0] = meta(A_CONST);
  o.isconst0 = true, o.val0 = v;
}

// stack[clip(len)] = row when len < STK; stack_len = len + 1.  -> ok
__host__ __device__ __forceinline__ bool push1(const SegArgs& s, Out& o, int32_t len, int32_t row) {
  const bool ok = len < s.STK;
  if (ok) o.n_stk = 1, o.stk_i0 = clampi(len, 0, s.STK - 1), o.stk_v0 = row;
  o.stack_len = wadd(len, 1);
  return ok;
}

// pop arity, push one row; halted(PARK) on a full stack
__host__ __device__ __forceinline__ void pushed(const SegArgs& s, const Lane& l, const In& p, Out& o,
                                                int32_t row) {
  if (!push1(s, o, wsub(l.stack_len, p.arity), row)) return halted(o, l, H_PARK);
  o.res = row;
}

__host__ __device__ __forceinline__ int32_t ctx_at(const SegArgs& s, const In& p, int32_t k) {
  return ld_cg(s.ctx + p.sb * CTX_W + gidx(k, CTX_W));
}

// One pass over the live memory entries for NA addresses: the first entry
// at exactly addr[a] (-1 none), and whether a live entry overlaps [addr[a],
// addr[a] + 32) without being an exact hit.
template <int NA>
__host__ __device__ __forceinline__ void mem_scan(const SegArgs& s, const Lane& l, const In& p,
                                                  const int32_t (&addr)[NA], int32_t (&hit)[NA],
                                                  bool (&miss)[NA]) {
#pragma unroll
  for (int a = 0; a < NA; ++a) hit[a] = -1, miss[a] = false;
  const int32_t n = l.mem_len < s.MEM ? l.mem_len : s.MEM;
  const int32_t* row = s.mem_addr + p.sb * s.MEM;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t m = ld_cg(row + i);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (hit[a] < 0 && m == addr[a]) hit[a] = i;
      const int32_t d = wsub(m, addr[a]);
      const int32_t ad = d < 0 ? wneg(d) : d;  // |INT32_MIN| stays negative, as in XLA
      if (ad < 32 && m != addr[a]) miss[a] = true;
    }
  }
}

// the first live storage entry with this key (-1 none)
__host__ __device__ __forceinline__ int32_t sto_find(const SegArgs& s, const Lane& l, const In& p,
                                                     int32_t key) {
  const int32_t n = l.sto_len < s.STO ? l.sto_len : s.STO;
  const int32_t* row = s.sto_key + p.sb * s.STO;
  for (int32_t i = 0; i < n; ++i)
    if (ld_cg(row + i) == key) return i;
  return -1;
}

__host__ __device__ __forceinline__ int32_t memgas(int32_t size) {
  const int32_t w = fdiv(size, 32);
  return wadd(wmul(3, w), fdiv(wmul(w, w), 512));
}

__host__ __device__ __forceinline__ void mem_gas(Out& o, int32_t addr, int32_t size) {
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

__host__ __device__ __forceinline__ void h_binop(const SegArgs& s, const Lane& l, const In& p,
                                                 Out& o) {
  const int32_t opc = p.aux & 0xFF;
  const bool swap = (p.aux & 256) != 0;
  const bool foldable = opc == A_ADD || opc == A_SUB || opc == A_MUL || opc == A_AND ||
                        opc == A_OR || opc == A_XOR || opc == A_SHL || opc == A_LSHR ||
                        opc == A_ASHR;
  if (p.pop_c[0] && p.pop_c[1] && foldable) {
    // values, not references: a reference picked at run time would keep the
    // lane's registers in local memory
    const u256 x = swap ? l.v1 : l.v0;
    const u256 y = swap ? l.v0 : l.v1;
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
    const_row0(o, f);
  } else {
    o.rows[0] = meta(opc, swap ? p.pops[1] : p.pops[0], swap ? p.pops[0] : p.pops[1]);
  }
  pushed(s, l, p, o, p.ids[0]);
}

__host__ __device__ __forceinline__ void h_cmp(const SegArgs& s, const Lane& l, const In& p,
                                               Out& o) {
  if (p.pop_c[0] && p.pop_c[1]) {
    bool t = false;
    switch (p.aux) {
      case A_ULT: t = ult(l.v0, l.v1); break;
      case A_UGT: t = ult(l.v1, l.v0); break;
      case A_SLT: t = slt(l.v0, l.v1); break;
      case A_SGT: t = slt(l.v1, l.v0); break;
      case A_EQ: t = eq(l.v0, l.v1); break;
    }
    return pushed(s, l, p, o, t ? s.row_one : s.row_zero);
  }
  o.rows[0] = meta(p.aux, p.pops[0], p.pops[1], -1, 0);
  o.rows[1] = meta(A_ITEW, p.ids[0], s.row_one, s.row_zero);
  pushed(s, l, p, o, p.ids[1]);
}

__host__ __device__ __forceinline__ void h_sha3(const SegArgs& s, const Lane& l, const In& p,
                                                Out& o) {
  const int32_t off = p.addr0, ln = p.addr1;
  const int32_t words = fdiv(wadd(ln, 31), 32);
  bool good = p.ok_addr0 && p.ok_addr1 && ln > 0 && fmod_(ln, 32) == 0 && words <= 4;
  const int32_t addr[4] = {off, wadd(off, 32), wadd(off, 64), wadd(off, 96)};
  int32_t hit[4];
  bool miss[4];
  mem_scan<4>(s, l, p, addr, hit, miss);
  int32_t w_rows[4];
  const int32_t* vals = s.mem_val + p.sb * s.MEM;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    w_rows[w] = hit[w] >= 0 ? ld_cg(vals + hit[w]) : s.row_zero;
    if (w < words) good = good && !miss[w];
  }
  int32_t cur = w_rows[0], cur_w = 256;
#pragma unroll
  for (int w = 1; w < 4; ++w) {
    if (words > w) {
      o.rows[w - 1] = meta(A_CONCAT, cur, w_rows[w], -1, wadd(cur_w, 256));
      cur = p.ids[w - 1];
      cur_w = wadd(cur_w, 256);
    }
  }
  o.rows[3] = meta(A_KECCAK, cur);
  const int32_t sha_gas = wadd(30, wmul(6, words));
  o.gas_min = wadd(o.gas_min, sha_gas);
  o.gas_max = wadd(o.gas_max, sha_gas);
  mem_gas(o, off, ln);
  good = push1(s, o, wsub(l.stack_len, 2), p.ids[3]) && good;
  o.res = p.ids[3];
  if (!good) halted(o, l, H_PARK);
}

__host__ __device__ __forceinline__ void h_jumpi(const SegArgs& s, const Lane& l, const In& p,
                                                 Out& o) {
  const int32_t dest_row = p.pops[0], word_row = p.pops[1];
  const bool can_take = p.ok_addr0 && p.valid0;
  const int32_t cond_row = p.ids[0], ncond_row = p.ids[1];
  const int32_t cl = clampi(l.cons_len, 0, s.CON - 1);
  const bool ok_cons = l.cons_len < s.CON;
  // constraint rows, written whatever the branch
  o.rows[0] = meta(A_NE, word_row, s.row_zero, -1, 0);
  o.rows[1] = meta(A_BNOT, cond_row, -1, -1, 0);
  if (p.pop_c[1]) {  // concrete condition: one branch, no fork
    const bool truth = !is_zero(l.v1);
    const bool take = truth && can_take, dead = truth && !can_take;
    if (ok_cons || dead) {
      o.pc = take ? p.jidx0 : wadd(l.pc, 1);
      o.depth = wadd(l.depth, 1);
      o.stack_len = wsub(l.stack_len, 2);
      if (dead) {
        o.halt = H_INVALID;
      } else {
        o.cons_i = cl, o.cons_v = take ? cond_row : ncond_row;
        o.cons_len = wadd(l.cons_len, 1);
      }
    } else {
      o.halt = H_PARK;
    }
    return;
  }
  // symbolic condition: the state stays pristine while the taken branch is
  // viable (the fork phases apply both sides); else the fall-through only
  if (can_take) {
    if (!ok_cons) o.halt = H_PARK;
  } else if (ok_cons) {
    o.pc = wadd(l.pc, 1);
    o.depth = wadd(l.depth, 1);
    o.stack_len = wsub(l.stack_len, 2);
    o.cons_i = cl, o.cons_v = ncond_row;
    o.cons_len = wadd(l.cons_len, 1);
  } else {
    o.halt = H_PARK;
  }
  o.f_want = can_take && ok_cons;
  o.f_target = p.jidx0, o.f_dest = dest_row, o.f_word = word_row;
  o.f_cond = cond_row, o.f_ncond = ncond_row;
}

__host__ __device__ __forceinline__ void dispatch(const SegArgs& s, const Lane& l, const In& p,
                                                  Out& o) {
  const int32_t row_zero = s.row_zero, row_one = s.row_one;
  base_out(o, l);
  switch (clampi(p.fam, 0, F_PAGEFAULT)) {
    case F_PARK:
    case F_MSTORE8: return halted(o, l, H_PARK);
    case F_STOP: return halted(o, l, H_STOP);
    case F_INVALID: return halted(o, l, H_INVALID);
    case F_PAGEFAULT: return halted(o, l, H_PAGE_FAULT);
    case F_PUSH: return pushed(s, l, p, o, p.aux);
    case F_DUP:
      if (!push1(s, o, l.stack_len, l.sdup)) return halted(o, l, H_PARK);
      o.res = l.sdup;
      return;
    case F_SWAP:
      o.n_stk = 2;
      o.stk_i0 = clampi(wsub(l.stack_len, 1), 0, s.STK - 1), o.stk_v0 = l.sswp;
      o.stk_i1 = clampi(wsub(wsub(l.stack_len, 1), p.aux), 0, s.STK - 1), o.stk_v1 = l.top[0];
      return;
    case F_POP: o.stack_len = wsub(l.stack_len, 1); return;
    case F_BINOP: return h_binop(s, l, p, o);
    case F_CMP: return h_cmp(s, l, p, o);
    case F_ISZERO:
      if (p.pop_c[0]) return pushed(s, l, p, o, is_zero(l.v0) ? row_one : row_zero);
      o.rows[0] = meta(A_EQZ, p.pops[0], -1, -1, 0);
      o.rows[1] = meta(A_ITEW, p.ids[0], row_one, row_zero);
      return pushed(s, l, p, o, p.ids[1]);
    case F_NOTOP:
      if (p.pop_c[0])
        const_row0(o, bit_not(l.v0));
      else
        o.rows[0] = meta(A_NOT, p.pops[0]);
      return pushed(s, l, p, o, p.ids[0]);
    case F_ENVPUSH: return pushed(s, l, p, o, ctx_at(s, p, p.aux));
    case F_CALLDATALOAD:
      o.rows[0] = meta(A_CDLOAD, p.pops[0], ctx_at(s, p, CTX_SEED));
      return pushed(s, l, p, o, p.ids[0]);
    case F_BALANCE:
      o.rows[0] = meta(A_SELECT, ctx_at(s, p, CTX_BALANCES), p.pops[0]);
      return pushed(s, l, p, o, p.ids[0]);
    case F_SELFBALANCE:
      o.rows[0] = meta(A_SELECT, ctx_at(s, p, CTX_BALANCES), ctx_at(s, p, CTX_ADDRESS));
      return pushed(s, l, p, o, p.ids[0]);
    case F_GASPUSH:
      o.rows[0] = meta(A_VARF, l.pcr);
      return pushed(s, l, p, o, p.ids[0]);
    case F_MSIZE:
      const_row0(o, u256_small((uint32_t)l.mem_size));
      return pushed(s, l, p, o, p.ids[0]);
    case F_SHA3: return h_sha3(s, l, p, o);
    case F_MLOAD: {
      const int32_t addr[1] = {p.addr0};
      int32_t hit[1];
      bool miss[1];
      mem_scan<1>(s, l, p, addr, hit, miss);
      const int32_t row = hit[0] >= 0 ? ld_cg(s.mem_val + p.sb * s.MEM + hit[0]) : row_zero;
      mem_gas(o, p.addr0, 32);
      const bool ok = push1(s, o, wsub(l.stack_len, 1), row);
      o.res = row;
      if (!(p.ok_addr0 && ok && !miss[0])) halted(o, l, H_PARK);
      return;
    }
    case F_MSTORE: {
      const int32_t addr[1] = {p.addr0};
      int32_t hit[1];
      bool miss[1];
      mem_scan<1>(s, l, p, addr, hit, miss);
      const int32_t idx = hit[0] >= 0 ? hit[0] : l.mem_len;
      o.mem_i = clampi(idx, 0, s.MEM - 1), o.mem_a = p.addr0, o.mem_v = p.pops[1];
      o.mem_len = hit[0] >= 0 ? l.mem_len : wadd(l.mem_len, 1);
      o.stack_len = wsub(l.stack_len, 2);
      mem_gas(o, p.addr0, 32);
      if (!(p.ok_addr0 && !miss[0] && idx < s.MEM)) halted(o, l, H_PARK);
      return;
    }
    case F_SLOAD: {
      const int32_t key = p.pops[0];
      const int32_t hit = sto_find(s, l, p, key);
      const int32_t res = hit >= 0 ? ld_cg(s.sto_val + p.sb * s.STO + hit) : p.ids[0];
      const bool ok_cap = hit >= 0 || l.sto_len < s.STO;
      if (hit < 0) {
        o.sto_i = clampi(l.sto_len, 0, s.STO - 1), o.sto_k = key, o.sto_v = p.ids[0];
        o.sto_len = wadd(l.sto_len, 1);
        o.rows[0] = meta(A_SELECT, ctx_at(s, p, CTX_STORAGE), key);
      }
      const bool ok = push1(s, o, wsub(l.stack_len, 1), res);
      o.res = res;
      if (!(ok_cap && ok)) halted(o, l, H_PARK);
      return;
    }
    case F_SSTORE: {
      const int32_t key = p.pops[0], val = p.pops[1];
      o.rows[0] = meta(A_STORE, ctx_at(s, p, CTX_STORAGE), key, val, 0);
      const int32_t hit = sto_find(s, l, p, key);
      const int32_t idx = hit >= 0 ? hit : l.sto_len;
      o.sto_i = clampi(idx, 0, s.STO - 1), o.sto_k = key, o.sto_v = val;
      o.sto_len = hit >= 0 ? l.sto_len : wadd(l.sto_len, 1);
      o.ctx_w = true, o.ctx_storage = p.ids[0];
      o.stack_len = wsub(l.stack_len, 2);
      if (!(idx < s.STO)) halted(o, l, H_PARK);
      return;
    }
    case F_JUMP:
      if (!(p.ok_addr0 && p.valid0)) return halted(o, l, H_INVALID);
      o.pc = p.jidx0, o.depth = wadd(l.depth, 1), o.stack_len = wsub(l.stack_len, 1);
      return;
    case F_JUMPI: return h_jumpi(s, l, p, o);
    case F_JUMPDEST:
      if (p.lid >= 0) {  // ids beyond the loops cap are unbounded
        const int32_t count = wadd(ld_cg(s.loops + p.sb * s.NL + gidx(p.lid, s.NL)), 1);
        if (p.lid < s.NL) o.loop_i = p.lid, o.loop_v = count;
        if (s.loop_bound > 0 && count > s.loop_bound) o.halt = H_LOOP;
      }
      return;
    case F_LOG: o.stack_len = wsub(l.stack_len, p.arity); return;
    case F_RETURN:
      o.halt = p.aux == 1 ? H_REVERT : H_RETURN;
      o.stack_len = wsub(l.stack_len, 2);
      return;
    case F_SELFDESTRUCT:
      o.halt = H_SELFDESTRUCT;
      o.stack_len = wsub(l.stack_len, 1);
      return;
    case F_SIGNEXTEND: {
      if (p.pop_c[0] && p.pop_c[1]) {
        u256 f = l.v1;
        if (below(l.v0, 31)) {
          const unsigned bits = 8 * ((unsigned)l.v0.w[0] + 1);
          const u256 mask_m1 = sub(shl(u256_small(1), bits), u256_small(1));
          const u256 low = bit_and(l.v1, mask_m1);
          const bool neg = lshr(l.v1, bits - 1).w[0] & 1;
          f = neg ? bit_or(low, bit_not(mask_m1)) : low;
        }
        const_row0(o, f);
      } else {
        o.rows[0] = meta(A_SIGNEXT, p.pops[0], p.pops[1]);
      }
      return pushed(s, l, p, o, p.ids[0]);
    }
    case F_BYTEOP: {
      if (p.pop_c[0] && p.pop_c[1]) {
        u256 f = u256_zero();
        if (below(l.v0, 32)) f.w[0] = lshr(l.v1, 8 * (31 - (unsigned)l.v0.w[0])).w[0] & 0xFF;
        const_row0(o, f);
      } else {
        o.rows[0] = meta(A_BYTE, p.pops[0], p.pops[1]);
      }
      return pushed(s, l, p, o, p.ids[0]);
    }
    default:  // F_ADDMODOP
      o.rows[0] = meta(p.aux, p.pops[0], p.pops[1], p.pops[2]);
      return pushed(s, l, p, o, p.ids[0]);
  }
}

// The arena rows below the step's first new row are final while it runs.
__host__ __device__ __forceinline__ Window step_window(const SegArgs& s, int32_t arena_len,
                                                       int32_t n_live) {
  const bool wraps = arena_len < 0 || (int64_t)arena_len + (int64_t)n_live * s.R > INT32_MAX;
  return Window{false, wraps ? 0 : arena_len};
}

// The step of slot l.b (its ranks are over the running and the free paths
// before it): writes the path's new state, its R rows, its event; leaves
// its post-step flags and fork request in the lane and reads ahead.
__host__ __device__ __forceinline__ void step(const SegArgs& s, Lane& l, int32_t arena_len,
                                              const Window& ahead) {
  l.fwant = false;
  if (l.b >= s.B) return;
  const int32_t b = l.b;
  if (l.seed < 0) s.free_list[l.free_rank] = b;
  if (!(l.halt == H_RUNNING && l.seed >= 0)) {
    // dead slots' ids are caps.ARENA: their zero rows land only when the
    // arena holds more than caps.ARENA rows (the same row every step)
    if (s.ARENA < s.T && !l.dead_row) write_row(s, s.ARENA, Meta{0, 0, 0, 0, 0}, false, u256_zero());
    l.dead_row = true;
    return;
  }
  if (l.stale) read_pops(s, l, Window{true, 0}, 0);  // rows another path wrote last step
  In p;
  p.sb = b;
  const int32_t base = wadd(arena_len, wmul(l.live_rank, s.R));
#pragma unroll
  for (int k = 0; k < kRowsWritten; ++k) p.ids[k] = wadd(base, k);
  l.steps = wadd(l.steps, 1);
  s.steps[b] = l.steps;
  // coverage: the instruction plane at the TRUE pc
  const int32_t cid_live = clampi(l.code_id, 0, s.Cv - 1);
  const int32_t pc_v = clampi(l.pc, 0, s.Iv - 1);
  mark(s, 0, cid_live, pc_v);

  // decode (read ahead) against the resident window
  p.cid = clampi(l.code_id, 0, s.C - 1);
  p.fam = l.fam, p.aux = l.aux, p.arity = l.arity, p.lid = l.lid;
  const bool underflow = l.stack_len < p.arity;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    p.pops[j] = j < p.arity ? l.top[j] : -1;
    p.pop_c[j] = p.pops[j] >= 0 && ((l.isc >> j) & 1);
  }
  // (is a concrete byte address below 2^20, address) of the first two pops
  p.ok_addr0 = p.pop_c[0] && below(l.v0, 1u << 20);
  p.ok_addr1 = p.pop_c[1] && below(l.v1, 1u << 20);
  p.addr0 = (int32_t)(uint32_t)l.v0.w[0];
  p.addr1 = (int32_t)(uint32_t)l.v1.w[0];
  p.jidx0 = -1, p.valid0 = false;
  if (p.fam == F_JUMP || p.fam == F_JUMPI) {
    p.jidx0 = ld_ro(s.jumpmap + (int64_t)p.cid * s.A + clampi(p.addr0, 0, s.A - 1));
    p.valid0 = p.addr0 < s.A && p.jidx0 >= 0;
  }

  Out o;
  dispatch(s, l, p, o);
  // STATICCALL write protection, then underflow: the path halts INVALID
  const bool write_viol = l.statc != 0 &&
                          (p.fam == F_SSTORE || p.fam == F_LOG || p.fam == F_SELFDESTRUCT);
  if (write_viol || underflow) halted(o, l, H_INVALID);

  // the common tail
  const bool pending = o.f_want;
  const bool terminalish = o.halt != H_RUNNING;
  if (!(pending || terminalish || o.pc != l.pc)) o.pc = wadd(o.pc, 1);
  if (!(terminalish || pending)) {
    o.gas_min = wadd(o.gas_min, l.gmin);
    o.gas_max = wadd(o.gas_max, l.gmax);
  }
  if (o.depth > s.max_depth && o.halt == H_RUNNING) o.halt = H_DEPTH;

  // event
  const bool is_jumpi = p.fam == F_JUMPI;
  const int32_t h = o.halt;
  const bool terminal_halt = h == H_STOP || h == H_RETURN || h == H_REVERT ||
                             h == H_SELFDESTRUCT || h == H_INVALID;
  bool all_conc = true;
#pragma unroll
  for (int j = 0; j < 7; ++j) all_conc = all_conc && (p.arity <= j || p.pop_c[j]);
  const bool panic = p.pop_c[1] && u256_limb(l.v1, 14) == 0x7B71u && u256_limb(l.v1, 15) == 0x4E48u;
  const bool emit = (l.cflags & CF_EVENT) && !l.infault && !pending && !underflow &&
                    !((l.cflags & CF_CONCSKIP) && all_conc) && !((l.cflags & CF_VALGATE) && !panic) &&
                    h != H_PARK && h != H_PAGE_FAULT && h != H_DEPTH && h != H_LOOP;
  const bool ev_ok = l.ev_len < s.EVT;
  if (emit && ev_ok) {
    const bool died = h == H_INVALID;
    int32_t* ev = s.events + (p.sb * s.EVT + clampi(l.ev_len, 0, s.EVT - 1)) * EV_W;
    int32_t slot6 = p.pops[2];
    if (is_jumpi && !died) {
      const int32_t lc = clampi(wsub(o.cons_len, 1), 0, s.CON - 1);
      slot6 = lc == o.cons_i ? o.cons_v : ld_cg(s.cons + p.sb * s.CON + lc);
    }
    ev[0] = is_jumpi ? E_FORK : (terminal_halt ? E_TERMINAL : E_HOOK);
    ev[1] = l.pc, ev[2] = l.gas_min, ev[3] = l.gas_max;
    ev[4] = p.pops[0], ev[5] = p.pops[1], ev[6] = slot6, ev[7] = p.pops[3];
    ev[8] = p.pops[4], ev[9] = p.pops[5], ev[10] = p.pops[6];
    ev[11] = is_jumpi ? o.pc : o.res;
    ev[12] = (is_jumpi && died) ? -3 : -1;
    l.ev_len = wadd(l.ev_len, 1);
    s.ev_len[b] = l.ev_len;
  }
  if (emit && !ev_ok && o.halt == H_RUNNING) o.halt = H_PARK;

  // the new state
  s.pc[b] = o.pc, s.halt[b] = o.halt, s.stack_len[b] = o.stack_len, s.mem_len[b] = o.mem_len;
  s.mem_size[b] = o.mem_size, s.sto_len[b] = o.sto_len, s.cons_len[b] = o.cons_len;
  s.gas_min[b] = o.gas_min, s.gas_max[b] = o.gas_max, s.depth[b] = o.depth;
  if (o.n_stk > 0) s.stack[p.sb * s.STK + o.stk_i0] = o.stk_v0;
  if (o.n_stk > 1) s.stack[p.sb * s.STK + o.stk_i1] = o.stk_v1;
  if (o.mem_i >= 0) s.mem_addr[p.sb * s.MEM + o.mem_i] = o.mem_a, s.mem_val[p.sb * s.MEM + o.mem_i] = o.mem_v;
  if (o.sto_i >= 0) s.sto_key[p.sb * s.STO + o.sto_i] = o.sto_k, s.sto_val[p.sb * s.STO + o.sto_i] = o.sto_v;
  if (o.ctx_w) s.ctx[p.sb * CTX_W + CTX_STORAGE] = o.ctx_storage;
  if (o.cons_i >= 0) s.cons[p.sb * s.CON + o.cons_i] = o.cons_v;
  if (o.loop_i >= 0) s.loops[p.sb * s.NL + o.loop_i] = o.loop_v;
  // its rows (rows past the fourth stay empty)
#pragma unroll
  for (int k = 0; k < kRowsWritten; ++k)
    write_row(s, p.ids[k], o.rows[k], k == 0 && o.isconst0, k == 0 ? o.val0 : u256_zero());
  for (int32_t k = kRowsWritten; k < s.R; ++k) write_row(s, wadd(base, k), meta0(), false, u256_zero());
  // edge coverage of a JUMPI decided in place (a fork marks at its grant)
  const int32_t cl = clampi(cid_live, 0, s.C - 1);
  const int32_t fh = cl == p.cid ? l.fam_raw
                                 : ld_ro(s.fam + (int64_t)cl * s.N +
                                         clampi(wsub(l.pc, ld_ro(s.pbase + cl)), 0, s.N - 1));
  if (fh == F_JUMPI && !o.f_want && o.halt == H_RUNNING)
    mark(s, o.pc == wadd(l.pc, 1) ? 2 : 1, cid_live, pc_v);
  // the fork request stays in the lane for the fork phases (the JUMPI's
  // static gas is its code row's: both branches add it)
  if (o.f_want) {
    l.f_target = o.f_target, l.f_dest = o.f_dest, l.f_word = o.f_word;
    l.f_cond = o.f_cond, l.f_ncond = o.f_ncond;
    l.pre_pc = l.pc, l.pre_gmin = l.gas_min, l.pre_gmax = l.gas_max;
    l.f_gmin = l.gmin, l.f_gmax = l.gmax;
  }
  l.fwant = o.f_want;
  l.pc = o.pc, l.halt = o.halt, l.stack_len = o.stack_len, l.mem_len = o.mem_len;
  l.mem_size = o.mem_size, l.sto_len = o.sto_len, l.cons_len = o.cons_len;
  l.gas_min = o.gas_min, l.gas_max = o.gas_max, l.depth = o.depth;
  set_flags(l);
  // a forking path reads ahead after the fork phases
  if (!l.fwant) read_ahead(s, l, ahead, base);
}

// ---- the fork phases ------------------------------------------------------

// A fork-wanting path's entry in the grant list: its sort key (-score for a
// path that wants a fork and has room for its E_FORK event, else
// INT32_MAX), its slot, and bit 31 when it wants.  (A wanting path's depth
// and score are its incoming ones: its state stays pristine.)
__host__ __device__ __forceinline__ I2 fork_key(const SegArgs& s, Lane& l) {
  l.want = l.ev_len < s.EVT;
  int32_t score = 0;
  switch (s.sel_mode) {
    case SEL_DEEP: score = l.depth; break;
    case SEL_SHALLOW: score = wneg(l.depth); break;
    case SEL_COVERAGE: {
      const int32_t cid = clampi(l.code_id, 0, s.Cv - 1);
      const int32_t t = clampi(l.f_target, 0, s.Iv - 1);
      const bool covered = ld_cg(s.visited + (int64_t)cid * s.Iv + t) != 0;
      score = wadd(covered ? 0 : (1 << 20), l.depth);
      break;
    }
    case SEL_BEAM: score = l.score; break;
  }
  l.key = l.want ? wneg(score) : INT32_MAX;
  l.child = -1, l.wr = -1;
  return I2{l.key, (int32_t)((uint32_t)l.b | (l.want ? 0x80000000u : 0u))};
}

// Over one staged tile of the grant list: `lt`, the wanting entries that
// sort before slot l.b (lower key, or the same key at a lower slot), and
// `wb`, the wanting entries at a lower slot.
__host__ __device__ __forceinline__ void grant_count(const I2* tile, int32_t n, const Lane& l,
                                                     int32_t& lt, int32_t& wb) {
  const int32_t kb = l.key, b = l.b;
#pragma unroll 8
  for (int32_t i = 0; i < n; ++i) {
    const I2 e = tile[i];
    const int32_t j = e.y & 0x7FFFFFFF;
    const bool wj = e.y < 0;
    lt += wj && (e.x < kb || (e.x == kb && j < b));
    wb += wj && j < b;
  }
}

// A wanting path's rank in the stable order of all B keys is `lt` plus, at
// key INT32_MAX, the paths that do not want and sit at a lower slot.  The
// first n_free ranks take the free slots in scan order; a granted path's
// `lt` is its place among the granted ones, where it leaves its record.
__host__ __device__ __forceinline__ void grant_take(const SegArgs& s, Lane& l, int32_t lt,
                                                    int32_t wb) {
  const int32_t rank = lt + (l.key == INT32_MAX ? l.b - wb : 0);
  if (rank >= l.n_free) return;
  l.child = ld_cg(s.free_list + rank);
  l.wr = lt;
  int32_t* g = s.grants + (int64_t)GRANT_W * lt;
  st4(g, I4{l.b, l.child, l.pre_pc, l.f_target});
  st4(g + 4, I4{l.f_cond, l.f_gmin, l.f_gmax, l.cons_len});
}

// ---- the child copies ----------------------------------------------------
//
// A child's copy is units of work for a warp: unit 0 copies its scalars
// with the branch applied (lane 0) and resets its event buffer (all lanes);
// the others copy its wide fields, seen as one run of words (RowMap), 256
// words a unit, eight a lane, every load before the stores.  The code is
// the same for every field, and the units of all children spread over
// every warp.  `rec` is the child's grant record (two 16-byte words,
// staged in shared memory); a record whose parent is -1 is no grant.  The
// parent does not change its row in this phase.

constexpr int kChunk = 8 * kWarp;  // wide words one unit copies

// The wide fields of a state row as one run of words: field k is words
// [pre[k], pre[k + 1]) (the card keeps this in shared memory).
struct RowMap {
  int32_t* f[8];
  int32_t w[8], pre[9];
};

__host__ __device__ __forceinline__ void row_map(const SegArgs& s, RowMap& m) {
  int32_t* const f[8] = {s.stack, s.mem_addr, s.mem_val, s.sto_key, s.sto_val, s.ctx, s.cons, s.loops};
  const int32_t w[8] = {s.STK, s.MEM, s.MEM, s.STO, s.STO, CTX_W, s.CON, s.NL};
  m.pre[0] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) m.f[k] = f[k], m.w[k] = w[k], m.pre[k + 1] = m.pre[k] + w[k];
}

// units of one child
__host__ __device__ __forceinline__ int32_t child_units(const RowMap& m) {
  return 1 + (m.pre[8] + kChunk - 1) / kChunk;
}

// The parent's row is read through `s`, the child's written through `d`
// (the same but where a partitioned segment's child lies in another
// shard's block); the coverage planes are `s`'s.
__host__ __device__ __forceinline__ void child_scalars(const SegArgs& s, const SegArgs& d,
                                                      const I4& g0, const I4& g1) {
  const int32_t p = g0.x, c = g0.y;
  int32_t* const f[] = {s.pc, s.halt, s.seed, s.code_id, s.steps, s.score, s.stack_len,
                        s.mem_len, s.mem_size, s.sto_len, s.cons_len, s.gas_min, s.gas_max,
                        s.depth, s.statc};
  int32_t* const g[] = {d.pc, d.halt, d.seed, d.code_id, d.steps, d.score, d.stack_len,
                        d.mem_len, d.mem_size, d.sto_len, d.cons_len, d.gas_min, d.gas_max,
                        d.depth, d.statc};
  int32_t v[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) v[i] = ld_cg(f[i] + p);
#pragma unroll
  for (int i = 0; i < 15; ++i) g[i][c] = v[i];
  // ev_len, steps and halt start afresh; then the branch: the JUMPI's static
  // gas and the taken edge (the wide units write the branch row)
  mark(s, 1, clampi(v[3], 0, s.C - 1), clampi(g0.z, 0, s.Iv - 1));
  d.ev_len[c] = 0, d.steps[c] = 0, d.halt[c] = H_RUNNING;
  d.pc[c] = g0.w;
  d.depth[c] = wadd(v[13], 1);
  d.stack_len[c] = wsub(v[6], 2);
  d.gas_min[c] = wadd(v[11], g1.y);
  d.gas_max[c] = wadd(v[12], g1.z);
  d.cons_len[c] = wadd(v[10], 1);
}

// One unit of a child's copy: the parent's row through `s` and `m`, the
// child's through `d` and `md`.
__host__ __device__ __forceinline__ void child_unit(const SegArgs& s, const SegArgs& d,
                                                   const RowMap& m, const RowMap& md,
                                                   const I4* rec, int32_t u, int lane) {
  const I4 g0 = rec[0], g1 = rec[1];
  if (g0.x < 0) return;
  const int64_t p = g0.x, c = g0.y;
  if (u == 0) {
    if (lane == 0) child_scalars(s, d, g0, g1);
    // the event buffer, reset: the words before its first 16-byte boundary,
    // 16-byte stores, then the words after the last whole one
    int32_t* ev = d.events + c * s.EVT * EV_W;
    const int64_t n = (int64_t)s.EVT * EV_W;
    const int64_t lead = (int64_t)((0 - (reinterpret_cast<uintptr_t>(ev) >> 2)) & 3);
    const int64_t head = lead < n ? lead : n, quads = (n - head) / 4;
    for (int64_t i = lane; i < head; i += kWarp) ev[i] = -1;
    for (int64_t i = lane; i < quads; i += kWarp) st4(ev + head + 4 * i, I4{-1, -1, -1, -1});
    for (int64_t i = head + 4 * quads + lane; i < n; i += kWarp) ev[i] = -1;
    return;
  }
  // the cons word that takes the taken branch's row (at the parent's cons_len)
  const int32_t at = m.pre[6] + clampi(g1.w, 0, s.CON - 1), total = m.pre[8];
  const int32_t v0 = (u - 1) * kChunk + lane;
  int32_t val[8], fk[8], off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int32_t v = v0 + k * kWarp;
    int32_t f = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i) f += v >= m.pre[i];
    fk[k] = f, off[k] = v - m.pre[f];
    if (v < total) val[k] = ld_cg(m.f[f] + p * m.w[f] + off[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int32_t v = v0 + k * kWarp;
    if (v < total) md.f[fk[k]][c * m.w[fk[k]] + off[k]] = v == at ? g1.x : val[k];
  }
}

__host__ __device__ __forceinline__ void child_unit(const SegArgs& s, const RowMap& m,
                                                   const I4* rec, int32_t u, int lane) {
  child_unit(s, s, m, m, rec, u, lane);
}

// After the copies: a granted parent takes the fall-through and records
// E_FORK with its child's slot; a denied fork, or one without room for its
// event, pends; a free slot that became a child reloads its row.  Then the
// lane's flags for the next step.
__host__ __device__ __forceinline__ void fork_parent(const SegArgs& s, Lane& l) {
  if (l.b >= s.B) return;
  const int32_t b = l.b;
  if (l.fwant) {
    l.fwant = false;
    const bool granted = l.child >= 0;
    if (!(l.ev_len < s.EVT) || (l.want && !granted)) l.halt = H_PENDING_FORK;
    if (granted) {
      s.grants[(int64_t)GRANT_W * l.wr] = -1;
      mark(s, 2, clampi(l.code_id, 0, s.C - 1), clampi(l.pre_pc, 0, s.Iv - 1));
      l.pc = wadd(l.pre_pc, 1);
      l.depth = wadd(l.depth, 1);
      l.stack_len = wsub(l.stack_len, 2);
      l.gas_min = wadd(l.gas_min, l.f_gmin);
      l.gas_max = wadd(l.gas_max, l.f_gmax);
      s.cons[(int64_t)b * s.CON + clampi(l.cons_len, 0, s.CON - 1)] = l.f_ncond;
      l.cons_len = wadd(l.cons_len, 1);
      if (l.ev_len < s.EVT) {
        int32_t* ev = s.events + ((int64_t)b * s.EVT + clampi(l.ev_len, 0, s.EVT - 1)) * EV_W;
        ev[0] = E_FORK, ev[1] = l.pre_pc, ev[2] = l.pre_gmin, ev[3] = l.pre_gmax;
        ev[4] = l.f_dest, ev[5] = l.f_word, ev[6] = l.f_cond, ev[7] = l.f_ncond;
        ev[8] = l.f_target, ev[9] = -1, ev[10] = -1, ev[11] = -1, ev[12] = l.child;
        l.ev_len = wadd(l.ev_len, 1);
        s.ev_len[b] = l.ev_len;
      } else {
        l.halt = H_PARK;
      }
      s.pc[b] = l.pc, s.depth[b] = l.depth, s.stack_len[b] = l.stack_len;
      s.gas_min[b] = l.gas_min, s.gas_max[b] = l.gas_max, s.cons_len[b] = l.cons_len;
    }
    s.halt[b] = l.halt;
    set_flags(l);
    read_ahead(s, l, Window{true, 0}, 0);
  } else if (l.seed < 0) {  // a free slot: its row again, which a copy may have filled
    load_scalars(s, l);
    if (l.seed < 0) return;
    l.pbase = ld_ro(s.pbase + clampi(l.code_id, 0, s.C - 1));
    set_flags(l);
    read_ahead(s, l, Window{true, 0}, 0);
  }
}

// ---- the counts ---------------------------------------------------------

__host__ __device__ __forceinline__ int32_t popc32(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// A warp's running, free and fork-wanting lanes in one word, 10 bits each
// (the sum over a block's four warps still fits).
__host__ __device__ __forceinline__ int32_t pack_counts(uint32_t m_live, uint32_t m_free,
                                                        uint32_t m_fwant) {
  return popc32(m_live) | popc32(m_free) << 10 | popc32(m_fwant) << 20;
}

// A lane's ranks within its warp, from the warp's masks.
__host__ __device__ __forceinline__ void warp_ranks(Lane& l, int lane, uint32_t m_live,
                                                    uint32_t m_free, uint32_t m_fwant) {
  const uint32_t below = (1u << lane) - 1;
  l.live_w = popc32(m_live & below), l.free_w = popc32(m_free & below);
  l.fwant_w = popc32(m_fwant & below);
}

// Counts of running, free and fork-wanting paths (n) over the whole batch,
// and over the blocks before one block (before).
struct Tally {
  int32_t n[3], before[3];
};

// adds a packed word (or a sum of at most four) into three counters
__host__ __device__ __forceinline__ void add_word(int32_t (&acc)[3], int32_t word) {
#pragma unroll
  for (int f = 0; f < 3; ++f) acc[f] += (word >> (10 * f)) & 1023;
}

// The tally for `block` from every block's four warp words (blk(i): block
// i's words of one parity); blocks i0, i0 + step, ... only (the card
// splits the blocks over a warp's lanes and adds the lanes' tallies).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Blk>
__host__ __device__ __forceinline__ Tally tally(const Blk& blk, int nblocks, int block, int i0 = 0,
                                                int step = 1) {
  Tally t = {{0, 0, 0}, {0, 0, 0}};
  for (int i = i0; i < nblocks; i += step) {
    const I4 q = blk(i);
    const int32_t sum = q.x + q.y + q.z + q.w;
    add_word(t.n, sum);
    if (i < block) add_word(t.before, sum);
  }
  return t;
}

// A lane's totals and ranks from its block's tally and its block's words.
__host__ __device__ __forceinline__ void lane_counts(Lane& l, const Tally& t, const I4& own,
                                                     int warp) {
  int32_t before[3] = {t.before[0], t.before[1], t.before[2]};
  add_word(before, (warp > 0 ? own.x : 0) + (warp > 1 ? own.y : 0) + (warp > 2 ? own.z : 0));
  l.n_live = t.n[0], l.n_free = t.n[1], l.n_fwant = t.n[2];
  l.live_rank = before[0] + l.live_w, l.free_rank = before[1] + l.free_w;
  l.fwant_rank = before[2] + l.fwant_w;
}

// ---- the loop -------------------------------------------------------------

// Up to min(k_limit, K) steps; stops when no path is live or the arena has
// no room for n_live * R more rows.  Every decision below is taken from the
// counts, the same in every lane.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class X>
__host__ __device__ __forceinline__ void run_segment(X& x, const SegArgs& s) {
  const int32_t k = s.k_limit < s.K ? s.k_limit : s.K;
  // read once begin() has run: a partitioned segment's first barrier is
  // there, after which every card's launch (and what its stream queued
  // before it) has started
  x.begin();
  int32_t arena_len = ld_cg(s.arena_len0), n_exec = 0, max_live = 0;
  x.publish(0);
  x.sync();
  x.counts(0);
  for (int32_t t = 0;; ++t) {
    const int32_t n_live = x.lane0().n_live;
    if (!(t < k && n_live > 0 && wadd(arena_len, wmul(n_live, s.R)) < s.ARENA)) break;
    n_exec = wadd(n_exec, n_live);
    max_live = max_live > n_live ? max_live : n_live;
    const Window ahead = step_window(s, arena_len, n_live);
    x.step(arena_len, ahead);
    arena_len = wadd(arena_len, wmul(n_live, s.R));
    // the post-step flags go to the other parity: the counts of this step
    // are still being read until the barrier
    const int par = (t + 1) & 1;
    x.publish(par);
    x.sync();
    x.counts(par);
    if (x.lane0().n_fwant == 0) continue;  // no fork: the flags are final
    x.keys();
    x.sync();
    x.grant();
    x.sync();
    const int32_t n_free = x.lane0().n_free, n_fwant = x.lane0().n_fwant;
    x.child_items(n_fwant < n_free ? n_fwant : n_free);
    x.sync();
    x.parent();
    x.publish(par);
    x.sync();
    x.counts(par);
  }
  x.finish(arena_len, n_exec, max_live);
}

// ---- the segment partitioned over shards ------------------------------------
//
// A partitioned segment (step.py segment_partitioned) splits the batch into
// n_shards slot blocks of Bs slots: shard k holds slots [k * Bs, (k + 1) *
// Bs), its state in allocations of its own, on its own card (or, for
// logical shards of one card, beside the others).  The arena, the coverage
// planes, out and arena_len0 are the leader's (shard 0's card), the code
// tables each card's copy.  Every lane keeps its global slot, so the ranks,
// the keys, the free list and the grant records are those of the
// unsharded batch and the loop (run_segment) takes the same decisions; an
// executor of the shards (ShardDev on the card, the host check's
// coroutines) does what crosses blocks:
//
//   publish   each warp's count word goes to every shard's count buffer
//             (indexed by the global block), so counts() reads its own;
//   keys      each wanting path's (key, slot, want) goes to every shard's
//             grant list at its rank, and each free slot to every shard's
//             free list (a step writes its own; a wanting path whose key is
//             INT32_MAX ranks among the slots that do not want, so any free
//             rank may be taken);
//   grant     each shard counts over its own copy of the list, takes the
//             free slot of its rank from its own copy of the free list (a
//             slot of any shard) and leaves the grant record in its own
//             record buffer, where only its own parents' records are set;
//   child     each shard copies its own parents' rows into the children's
//             slots, in whichever shard's block they lie;
//   sync      one barrier over every shard.
//
// A shard's view (shard_view) is a SegArgs whose state pointers are its
// block's moved back by its first slot times the field's width, so the
// per-path code indexes by the global slot unchanged; a lane past its
// block's Bs slots gets a slot >= B, which every phase skips.

constexpr int kMaxShards = 8;

// The state fields of a SegArgs in order, with their row widths.
#define MK_STATE_FIELDS(X)                                                                         \
  X(pc, 1) X(halt, 1) X(seed, 1) X(code_id, 1) X(steps, 1) X(score, 1) X(stack, s.STK)              \
  X(stack_len, 1) X(mem_addr, s.MEM) X(mem_val, s.MEM) X(mem_len, 1) X(mem_size, 1)                \
  X(sto_key, s.STO) X(sto_val, s.STO) X(sto_len, 1) X(ctx, CTX_W) X(cons, s.CON) X(cons_len, 1)    \
  X(events, (int64_t)s.EVT * EV_W) X(ev_len, 1) X(gas_min, 1) X(gas_max, 1) X(depth, 1)            \
  X(loops, s.NL) X(statc, 1)

// One shard's allocations: its block's state ([Bs, ...]) and its copies of
// the batch-wide scratch (free_list [B], fkeys [B, 2], grants [B, GRANT_W]
// at -1, cnt [2, 4 * blocks of every shard]).
struct ShardPtrs {
#define MK_PTR(n, w) int32_t* n;
  MK_STATE_FIELDS(MK_PTR)
#undef MK_PTR
  int32_t *free_list, *fkeys, *grants, *cnt;
};

// Mirror of ShardArgs in mythril_tpu_torch/frontier/step.py (same order).
struct ShardArgs {
  SegArgs s;  // B is the whole batch; its state and scratch pointers are unused
  ShardPtrs sh[kMaxShards];
  int32_t n_shards, Bs, bps;  // shards, slots a shard, blocks (of kBlock lanes) a shard
  int32_t first, n_here;      // the shards this launch runs: [first, first + n_here)
  int32_t n_launches;         // launches that meet at each barrier (one per card)
  uint32_t* bar;              // the cross-card barrier's [count, generation] (leader)
  long long timeout_ns;       // how long a card waits at the barrier before it traps
};

__host__ __device__ __forceinline__ void shard_view(const ShardArgs& a, int k, SegArgs& v) {
  const SegArgs& s = a.s;
  v = s;
  const int64_t off = (int64_t)k * a.Bs;
#define MK_VIEW(n, w) v.n = a.sh[k].n - off * (w);
  MK_STATE_FIELDS(MK_VIEW)
#undef MK_VIEW
  v.free_list = a.sh[k].free_list, v.fkeys = a.sh[k].fkeys, v.grants = a.sh[k].grants;
  v.cnt = a.sh[k].cnt;
}

// The global slot of lane j of shard k's block (>= B past the block).
__host__ __device__ __forceinline__ int32_t shard_slot(const ShardArgs& a, int k, int32_t j) {
  return j < a.Bs ? k * a.Bs + j : a.s.B + j;
}

__host__ __device__ __forceinline__ int32_t shard_of(const ShardArgs& a, int32_t slot) {
  return slot / a.Bs;
}

// A warp's count word into every shard's buffer (of `blocks` blocks).
__host__ __device__ __forceinline__ void shard_word(const ShardArgs& a, int shard, int par,
                                                  int blocks, int gblock, int warp, int32_t word) {
  a.sh[shard].cnt[(par * blocks + gblock) * kWarpsPerBlock + warp] = word;
}

// A wanting path's key, and a free slot's place in the free list, into
// shard j's copies.
__host__ __device__ __forceinline__ void shard_key(const ShardArgs& a, int j, int32_t r, I2 e) {
  a.sh[j].fkeys[2 * r] = e.x, a.sh[j].fkeys[2 * r + 1] = e.y;
}
__host__ __device__ __forceinline__ void shard_free(const ShardArgs& a, int j, const Lane& l) {
  if (l.free) a.sh[j].free_list[l.free_rank] = l.b;
}

}  // namespace mk
