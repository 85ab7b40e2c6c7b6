// The devsolver's batched DPLL search: one query's loop of steps, the
// program each thread of the query's block runs, for the kernel (dpll.cu)
// and the host check (host_check.cpp).
//
// Replaces one query's lane of mythril_tpu/devsolver/device.py _run (the
// jitted lax.while_loop over devsolver/kernel.py step), bit for bit with
// the host twin kernel.run_host: the same status, assignment and steps.
// A step is:
//
//   sweep: every clause reads the assignment as it was before the step; a
//     clause with no true literal and none unassigned is a conflict; one
//     with exactly one unassigned literal (occurrences counted, so [x, x, 0]
//     is never a unit) is a unit, which implies its literal; a variable
//     implied both ways is a conflict too;
//   no conflict, a unit: every implied variable takes its value;
//   at the fixpoint: SAT when every clause has a true literal, else one
//     decision, false first, in the fixed order of dec; a slot whose
//     variable is already assigned is marked tried and not assigned; depth
//     64 gives UNKNOWN;
//   on a conflict, a chronological backtrack: j, the highest slot below
//     depth not yet flipped (none: UNSAT); every variable assigned after
//     slot j's decision is unassigned, dec[j] takes the other value, the
//     slots above j are cleared, depth = j + 1.
//
// Layout (shared memory on the card, one query a block):
//
//   - the clause table: at staging a clause holding literal 1 or 2 (the
//     anchors' true literals, assigned at level 0 for the whole run) is
//     dropped and the others are packed to the front, three 16-bit literals
//     a clause (lo: literals 0 and 1, hi: literal 2), n of them; each
//     thread then keeps its first kRegs clauses of the table (tid, tid + nt,
//     ...) in registers, and the sweep runs over the n clauses only, so an
//     empty query costs one trivial step;
//   - the assignment as literal bits: bit l % 32 of lt[l / 32] is set when
//     literal l (2 var, + 1 when negated) is true, so a variable's two bits
//     are neighbours (true, false), a literal's truth is one word read and
//     one rotate, and its falsity the rotate by l ^ 1;
//   - imp, the step's implied literals in the same layout, OR-ed in by the
//     sweep (an atomic whose old word shows the opposite literal: a variable
//     implied both ways);
//   - snap[j], both bits of every variable assigned when slot j's decision
//     was made: exactly those at a level <= j, so the backtrack to j is
//     lt &= snap[j] (it replaces the per-variable levels);
//   - votes[32], the block's vote of a step, a word per warp: each warp
//     writes its own word every step after the last barrier and every
//     thread reads them before the next, so no word needs clearing and no
//     two warps write one word.
//
// The decision stack (dval, dflip: 64-bit masks), depth and status live in
// every thread's registers: the vote hands every thread the same flags, so
// every thread takes the same branch and keeps the same copy, and no thread
// waits on a one-thread phase.  A word of lt, imp and snap has one owner,
// thread w mod nt, which alone writes it after the vote.  A step is two
// barriers: the vote that ends the sweep, and the end of the commit.
//
// The batch's shared step counter of the JAX loop becomes a per-query loop
// of at most max_iters steps: a finished query's state never changes, so
// the outputs are the same.  A query still running after max_iters steps is
// UNKNOWN.
//
// Every function is __host__ __device__ so that the arithmetic also builds
// with a host C++ compiler; the executor X supplies the barrier, the vote
// and the warp's slot claim (run_query).
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
namespace dpll {

constexpr int D = 64;               // decision slots (kernel.MAX_DECISIONS)
constexpr int32_t kMaxVars = 4096;  // the largest variable bucket: literals fit 16 bits
constexpr int kRegs = 4;            // clauses a thread keeps in registers
constexpr int kWarps = 32;          // the largest block's warps: a vote word each
enum Status { RUNNING = 0, SAT = 1, UNSAT = 2, UNKNOWN = 3 };
// The step's vote: a clause conflicts, a clause has no true literal, a
// clause is a unit, a variable is implied both ways.
enum Flag : uint32_t { CONFLICT = 1, OPEN = 2, UNIT = 4, BOTH = 8 };

// lits: [Q, C, 3] int32 (2 * var, + 1 when negated; var < V <= kMaxVars);
// dec: [Q, 64] int32; status: [Q] int8, assign: [Q, V] int8, steps: [Q]
// int32, out; threads: the block's size (dpll.cu instantiates 256 and
// 1024).
struct DpllArgs {
  const int32_t* lits;
  const int32_t* dec;
  int8_t* status;
  int8_t* assign;
  int32_t* steps;
  int32_t Q, C, V, max_iters, threads;
};

// One query's state, in shared memory on the card.
struct Query {
  uint32_t* votes;  // [kWarps]
  int32_t* n;       // clauses kept
  uint16_t* dec;    // [D]
  uint32_t* lt;     // [W] literal bits
  uint32_t* imp;    // [W] the same layout
  uint32_t* snap;   // [D][W]
  uint32_t* lo;     // [C]
  uint16_t* hi;     // [C]
};

// Each thread's copy of the search's scalars.
struct Regs {
  uint64_t dval;   // slot d's value: bit d set when true
  uint64_t dflip;  // slot d tried both ways (or skipped)
  int32_t depth, status;
  bool dec_free;   // slot depth's variable unassigned when the step began
};

// This thread's first kRegs clauses of the table, literal by literal: the
// literal and the index of its word in lt.
struct Mine {
  uint32_t l[kRegs][3];
  uint32_t w[kRegs][3];
  int32_t m;  // how many of them there are
};

// Words of literal bits: 16 variables a word.
__host__ __device__ __forceinline__ int32_t words(int32_t V) { return (V + 15) / 16; }

// Bytes of one query's state; the layout of at().
__host__ __device__ __forceinline__ int64_t state_bytes(int32_t C, int32_t V) {
  return 4 * (kWarps + 1) + 2 * D + 4 * (2 + (int64_t)D) * words(V) + 6 * (int64_t)C;
}

__host__ __device__ __forceinline__ Query at(char* base, int32_t C, int32_t V) {
  const int32_t W = words(V);
  Query s;
  s.votes = (uint32_t*)base;
  s.n = (int32_t*)(s.votes + kWarps);
  s.dec = (uint16_t*)(s.n + 1);
  s.lt = (uint32_t*)(s.dec + D);
  s.imp = s.lt + W;
  s.snap = s.imp + W;
  s.lo = s.snap + (int64_t)D * W;
  s.hi = (uint16_t*)(s.lo + C);
  return s;
}

__host__ __device__ __forceinline__ uint64_t bit(int d) { return (uint64_t)1 << d; }
// The slots below d (all 64 when d is 64).
__host__ __device__ __forceinline__ uint64_t below(int32_t d) {
  return d >= D ? ~(uint64_t)0 : bit(d) - 1;
}

__host__ __device__ __forceinline__ int top_bit(uint64_t m) {
#if defined(__CUDA_ARCH__)
  return 63 - __clzll((long long)m);
#else
  return 63 - __builtin_clzll(m);
#endif
}

// Bit l % 32 of x in bit 0 (one funnel shift on the card).
__host__ __device__ __forceinline__ uint32_t at_bit(uint32_t x, uint32_t l) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, l);
#else
  return x >> (l & 31);
#endif
}

// *p |= bits -> the old word.
__host__ __device__ __forceinline__ uint32_t or_word(uint32_t* p, uint32_t bits) {
#if defined(__CUDA_ARCH__)
  return atomicOr(p, bits);
#else
  const uint32_t old = *p;
  *p = old | bits;
  return old;
#endif
}

// Whether a literal is one of the anchors' true literals (var 0 negated,
// var 1): its clause is satisfied for the whole run.
__host__ __device__ __forceinline__ bool always_true(int32_t lit) { return lit == 1 || lit == 2; }

// Both bits of every assigned variable of a word of literal bits.
__host__ __device__ __forceinline__ uint32_t assigned(uint32_t x) {
  const uint32_t a = (x | x >> 1) & 0x55555555u;
  return a | a << 1;
}

// The query's scalars: nothing kept, the anchors (variable 0 false:
// literal 1; variable 1 true: literal 2) and nothing else assigned, no
// implication, the decision order.
__host__ __device__ __forceinline__ void stage_state(const DpllArgs& a, int32_t q,
                                                     const Query& s, int tid, int nt) {
  if (tid == 0) *s.n = 0;
  for (int32_t w = tid; w < words(a.V); w += nt) {
    s.lt[w] = w == 0 ? 6u : 0u;
    s.imp[w] = 0;
  }
  for (int32_t d = tid; d < D; d += nt) s.dec[d] = (uint16_t)a.dec[(int64_t)q * D + d];
}

// The clauses that can be false, packed to the front (in the order the
// slots are claimed: the sweep does not depend on it).  x.claim(keep, n) is
// collective over the warp, so every thread takes every round.
template <class X>
__host__ __device__ __forceinline__ void stage_clauses(X& x, const DpllArgs& a, int32_t q,
                                                       const Query& s, int tid, int nt) {
  const int32_t* lits = a.lits + (int64_t)q * a.C * 3;
  for (int32_t base = 0; base < a.C; base += nt) {
    const int32_t c = base + tid;
    int32_t l0 = 0, l1 = 0, l2 = 0;
    if (c < a.C) l0 = lits[3 * c], l1 = lits[3 * c + 1], l2 = lits[3 * c + 2];
    const bool keep = c < a.C && !(always_true(l0) || always_true(l1) || always_true(l2));
    const int32_t slot = x.claim(keep, s.n);
    if (keep) {
      s.lo[slot] = (uint32_t)l0 | (uint32_t)l1 << 16;
      s.hi[slot] = (uint16_t)l2;
    }
  }
}

// This thread's first kRegs clauses of the table into registers.
__host__ __device__ __forceinline__ void load_mine(const Query& s, Mine& mine, int tid, int nt) {
  const int32_t n = *s.n;
  mine.m = 0;
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int32_t c = tid + k * nt;
    const uint32_t lo = c < n ? s.lo[c] : 0u;
    mine.l[k][0] = lo & 0xFFFFu;
    mine.l[k][1] = lo >> 16;
    mine.l[k][2] = c < n ? s.hi[c] : 0u;
#pragma unroll
    for (int j = 0; j < 3; ++j) mine.w[k][j] = mine.l[k][j] >> 5;
    mine.m += c < n;
  }
}

// The flags of one clause (literals l, their words w of lt) against the
// assignment before the step, without a branch but for a unit's literal,
// which goes into imp.  Bit 0 of t and u: the literal is true, unassigned;
// of any and two: one, two or more literals unassigned (counted by
// occurrence, as the reference does).
__host__ __device__ __forceinline__ uint32_t clause(const Query& s, uint32_t l0, uint32_t l1,
                                                    uint32_t l2, uint32_t w0, uint32_t w1,
                                                    uint32_t w2) {
  const uint32_t x0 = s.lt[w0], x1 = s.lt[w1], x2 = s.lt[w2];
  const uint32_t t0 = at_bit(x0, l0), t1 = at_bit(x1, l1), t2 = at_bit(x2, l2);
  const uint32_t u0 = ~(t0 | at_bit(x0, l0 ^ 1u)), u1 = ~(t1 | at_bit(x1, l1 ^ 1u)),
                 u2 = ~(t2 | at_bit(x2, l2 ^ 1u));
  const uint32_t open = ~(t0 | t1 | t2) & 1u;
  const uint32_t any = u0 | u1 | u2;
  const uint32_t two = (u0 & u1) | (u0 & u2) | (u1 & u2);
  uint32_t f = open * OPEN | (open & ~any) * CONFLICT;
  if (open & any & ~two) {
    const uint32_t l = u0 & 1u ? l0 : (u1 & 1u ? l1 : l2);
    const uint32_t old = or_word(s.imp + (l >> 5), 1u << (l & 31));
    f |= UNIT | (at_bit(old, l ^ 1u) & 1u ? BOTH : 0u);
  }
  return f;
}

// This thread's clauses: -> its flags.  Also whether slot depth's variable
// is free (read here, before any thread writes the assignment).
__host__ __device__ __forceinline__ uint32_t sweep(const Query& s, const Mine& mine, Regs& r,
                                                   int tid, int nt) {
  uint32_t f = 0;
#pragma unroll
  for (int k = 0; k < kRegs; ++k)
    if (k < mine.m)
      f |= clause(s, mine.l[k][0], mine.l[k][1], mine.l[k][2], mine.w[k][0], mine.w[k][1],
                  mine.w[k][2]);
  for (int32_t c = tid + kRegs * nt, n = *s.n; c < n; c += nt) {
    const uint32_t lo = s.lo[c], l0 = lo & 0xFFFFu, l1 = lo >> 16, l2 = s.hi[c];
    f |= clause(s, l0, l1, l2, l0 >> 5, l1 >> 5, l2 >> 5);
  }
  if (r.depth < D) {
    const uint32_t v = s.dec[r.depth];
    r.dec_free = ((s.lt[v >> 4] >> (2 * v & 31)) & 3u) == 0;
  }
  return f;
}

// The step's outcome from the block's flags f: this thread's registers and
// the words it owns.
__host__ __device__ __forceinline__ void commit(const Query& s, Regs& r, uint32_t f, int32_t V,
                                                int tid, int nt) {
  const int32_t W = words(V);
  if (f & (CONFLICT | BOTH)) {
    const uint64_t cand = ~r.dflip & below(r.depth);
    if (!cand) {
      r.status = UNSAT;
      return;
    }
    const int j = top_bit(cand);
    const uint32_t v = s.dec[j];
    const uint32_t now = 2 * v + (uint32_t)((r.dval >> j) & 1);  // the literal of the other value
    for (int32_t w = tid; w < W; w += nt) {
      s.lt[w] = (s.lt[w] & s.snap[j * W + w]) | (w == (int32_t)(v >> 4) ? 1u << (now & 31) : 0u);
      if (f & UNIT) s.imp[w] = 0;
    }
    r.dval ^= bit(j);
    r.dflip = (r.dflip & below(j)) | bit(j);
    r.depth = j + 1;
  } else if (f & UNIT) {
    for (int32_t w = tid; w < W; w += nt) {
      s.lt[w] |= s.imp[w];
      s.imp[w] = 0;
    }
  } else if (f & OPEN) {
    if (r.depth >= D) {
      r.status = UNKNOWN;
      return;
    }
    if (r.dec_free) {
      const uint32_t v = s.dec[r.depth];
      for (int32_t w = tid; w < W; w += nt) {
        const uint32_t x = s.lt[w];
        s.snap[r.depth * W + w] = assigned(x);
        if (w == (int32_t)(v >> 4)) s.lt[w] = x | 1u << ((2 * v + 1) & 31);  // false first
      }
      r.dval &= ~bit(r.depth);
    } else {
      r.dflip |= bit(r.depth);  // forced already: never flip a non-decision
    }
    ++r.depth;
  } else {
    r.status = SAT;
  }
}

// The assignment (int8: 0 unassigned, 1 true, 2 false: a variable's two
// literal bits), the status (RUNNING becomes UNKNOWN) and the steps taken.
__host__ __device__ __forceinline__ void store(const DpllArgs& a, int32_t q, const Query& s,
                                               int32_t status, int32_t steps, int tid, int nt) {
  int8_t* out = a.assign + (int64_t)q * a.V;
  for (int32_t v = tid; v < a.V; v += nt) out[v] = (int8_t)((s.lt[v >> 4] >> (2 * v & 31)) & 3u);
  if (tid == 0) {
    a.status[q] = (int8_t)(status == RUNNING ? UNKNOWN : status);
    a.steps[q] = steps;
  }
}

// One query's search, as thread x.tid of a block of x.nt runs it.  The
// executor X supplies:
//
//   x.sync(dead)                 the barrier;
//   x.vote(mine, votes)          the OR of every thread's flags: each warp's
//                                OR into its word of votes, the barrier, the
//                                OR of the block's words;
//   x.claim(keep, n)             over the warp: a slot from the counter *n
//                                for each thread that keeps a clause.
//
// dead is the vote words, which no thread reads until the next vote writes
// them again (the host check poisons them at the barrier); the card
// ignores it.
template <class X>
__host__ __device__ __forceinline__ void run_query(X& x, const DpllArgs& a, int32_t q,
                                                   const Query& s) {
  const int tid = x.tid, nt = x.nt;
  stage_state(a, q, s, tid, nt);
  x.sync(nullptr);
  stage_clauses(x, a, q, s, tid, nt);
  x.sync(nullptr);
  Mine mine;
  load_mine(s, mine, tid, nt);
  Regs r{0, 0, 0, RUNNING, false};
  int32_t it = 0;
  for (; it < a.max_iters && r.status == RUNNING; ++it) {
    const uint32_t f = x.vote(sweep(s, mine, r, tid, nt), s.votes);
    commit(s, r, f, a.V, tid, nt);
    x.sync(s.votes);
  }
  store(a, q, s, r.status, it, tid, nt);
}

}  // namespace dpll
}  // namespace mk
