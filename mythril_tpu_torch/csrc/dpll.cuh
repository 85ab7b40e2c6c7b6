// The devsolver's batched DPLL search: one query's loop of steps, written
// as phases over (tid, nthreads), for the kernel (dpll.cu) and the host
// check (host_check.cpp).
//
// Replaces one query's lane of mythril_tpu/devsolver/device.py _run (the
// jitted lax.while_loop over devsolver/kernel.py step), bit for bit with
// the host twin kernel.run_host: the same status and the same assignment.
// A step is:
//
//   sweep: every clause reads the assignment as it was before the step
//     (literal truth 0 unassigned, 1 true, 2 false); a clause with no true
//     literal and none unassigned is a conflict; one with exactly one
//     unassigned literal is a unit, which sets the literal's variable in
//     the imp_t or imp_f bitset (an atomic OR on a shared word);
//   a variable in both bitsets is a conflict too;
//   apply (no conflict): every unassigned variable in exactly one bitset
//     takes that value at the current depth; the bitsets are cleared;
//   at the fixpoint (no conflict, nothing applied): SAT when every clause
//     had a true literal, else one decision, false first, in the fixed
//     order of dec; a slot whose variable is already assigned is marked
//     tried (dflip = 1) and not assigned; depth 64 gives UNKNOWN;
//   on a conflict, a chronological backtrack: j, the highest slot below
//     depth not yet flipped (none: UNSAT); every variable above level j is
//     unassigned, dec[j] takes the other value at level j + 1, the slots
//     above j are cleared, depth = j + 1.
//
// The batch's shared step counter of the JAX loop becomes a per-query loop
// of at most max_iters steps: a finished query's state never changes, so
// the outputs are the same.  A query still running after max_iters steps is
// UNKNOWN.
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
namespace dpll {

constexpr int D = 64;  // decision slots (kernel.MAX_DECISIONS)
enum Status { RUNNING = 0, SAT = 1, UNSAT = 2, UNKNOWN = 3 };
enum Scalar { DEPTH = 0, STATUS = 1, JUMP = 2 };

// lits: [Q, C, 3] int32 (2 * var, + 1 when negated); dec: [Q, 64] int32;
// status: [Q] int8, assign: [Q, V] int8, steps: [Q] int32, out.
struct DpllArgs {
  const int32_t* lits;
  const int32_t* dec;
  int8_t* status;
  int8_t* assign;
  int32_t* steps;
  int32_t Q, C, V, max_iters;
};

// One query's search state, in shared memory on the card.
struct Query {
  int32_t* lits;   // [C * 3]
  int32_t* dec;    // [D]
  int32_t* sc;     // DEPTH, STATUS, JUMP
  uint32_t* imp_t; // [words(V)]
  uint32_t* imp_f;
  int16_t* level;  // [V]
  int8_t* assign;  // [V]
  int8_t* dval;    // [D]
  int8_t* dflip;   // [D]
};

__host__ __device__ __forceinline__ int32_t words(int32_t V) { return (V + 31) / 32; }

// Bytes of one query's state; the layout of at().
__host__ __device__ __forceinline__ int64_t state_bytes(int32_t C, int32_t V) {
  return 4 * (3 * (int64_t)C + D + 4 + 2 * (int64_t)words(V)) + 2 * (int64_t)V + V + 2 * D;
}

__host__ __device__ __forceinline__ Query at(char* base, int32_t C, int32_t V) {
  Query s;
  s.lits = (int32_t*)base;
  s.dec = s.lits + 3 * (int64_t)C;
  s.sc = s.dec + D;
  s.imp_t = (uint32_t*)(s.sc + 4);
  s.imp_f = s.imp_t + words(V);
  s.level = (int16_t*)(s.imp_f + words(V));
  s.assign = (int8_t*)(s.level + V);
  s.dval = s.assign + V;
  s.dflip = s.dval + D;
  return s;
}

__host__ __device__ __forceinline__ void or_word(uint32_t* p, uint32_t bits) {
#if defined(__CUDA_ARCH__)
  atomicOr(p, bits);
#else
  *p |= bits;
#endif
}

// Query q's clauses and decision order into its state; the anchors
// (variable 0 false, 1 true, both at level 0), nothing else assigned.
__host__ __device__ __forceinline__ void stage(const DpllArgs& a, int32_t q, const Query& s,
                                               int tid, int nt) {
  const int32_t* lits = a.lits + (int64_t)q * a.C * 3;
  for (int32_t i = tid; i < 3 * a.C; i += nt) s.lits[i] = lits[i];
  for (int32_t v = tid; v < a.V; v += nt) {
    s.assign[v] = v == 0 ? 2 : (v == 1 ? 1 : 0);
    s.level[v] = 0;
  }
  for (int32_t w = tid; w < words(a.V); w += nt) s.imp_t[w] = s.imp_f[w] = 0;
  for (int32_t d = tid; d < D; d += nt) {
    s.dec[d] = a.dec[(int64_t)q * D + d];
    s.dval[d] = s.dflip[d] = 0;
  }
  if (tid == 0) s.sc[DEPTH] = 0, s.sc[STATUS] = RUNNING, s.sc[JUMP] = -1;
}

// The clause sweep over this thread's clauses: units into the bitsets;
// -> bit 0: a clause conflicts, bit 1: a clause has no true literal.
__host__ __device__ __forceinline__ int sweep(const Query& s, int32_t C, int tid, int nt) {
  int flags = 0;
  for (int32_t c = tid; c < C; c += nt) {
    bool sat = false;
    int n_un = 0;
    int32_t unit = 0;
    for (int k = 0; k < 3; ++k) {
      const int32_t lit = s.lits[3 * c + k];
      const int8_t val = s.assign[lit >> 1];
      const int8_t cv = (lit & 1) ? (val == 0 ? 0 : 3 - val) : val;
      sat = sat || cv == 1;
      if (cv == 0) ++n_un, unit += lit;
    }
    if (sat) continue;
    flags |= 2;
    if (n_un == 0) flags |= 1;
    if (n_un == 1) {
      const int32_t v = unit >> 1;
      or_word(((unit & 1) ? s.imp_f : s.imp_t) + (v >> 5), 1u << (v & 31));
    }
  }
  return flags;
}

// Whether one of this thread's words has a variable implied both ways.
__host__ __device__ __forceinline__ bool both_ways(const Query& s, int32_t V, int tid, int nt) {
  bool any = false;
  for (int32_t w = tid; w < words(V); w += nt) any = any || (s.imp_t[w] & s.imp_f[w]);
  return any;
}

// The implications of this thread's words applied (when go) at the current
// depth, and its words cleared; -> whether it assigned a variable.
__host__ __device__ __forceinline__ bool apply(const Query& s, int32_t V, bool go, int tid,
                                               int nt) {
  bool progressed = false;
  const int16_t depth = (int16_t)s.sc[DEPTH];
  for (int32_t w = tid; w < words(V); w += nt) {
    const uint32_t t = s.imp_t[w], f = s.imp_f[w];
    if (go) {
      for (uint32_t bits = t ^ f; bits; bits &= bits - 1) {
#if defined(__CUDA_ARCH__)
        const int b = __ffs(bits) - 1;
#else
        const int b = __builtin_ctz(bits);
#endif
        const int32_t v = 32 * w + b;
        if (s.assign[v] != 0) continue;
        s.assign[v] = ((t >> b) & 1u) ? 1 : 2;
        s.level[v] = depth;
        progressed = true;
      }
    }
    s.imp_t[w] = s.imp_f[w] = 0;
  }
  return progressed;
}

// At the fixpoint with a clause open (one thread): the next decision.
__host__ __device__ __forceinline__ void decide(const Query& s) {
  const int32_t depth = s.sc[DEPTH];
  if (depth >= D) {
    s.sc[STATUS] = UNKNOWN;
    return;
  }
  const int32_t v = s.dec[depth];
  if (s.assign[v] != 0) {
    s.dflip[depth] = 1;  // forced already: never flip a non-decision
  } else {
    s.dval[depth] = 2;  // false first
    s.assign[v] = 2;
    s.level[v] = (int16_t)(depth + 1);
  }
  s.sc[DEPTH] = depth + 1;
}

// On a conflict (one thread): the slot to flip into sc[JUMP], or UNSAT.
__host__ __device__ __forceinline__ void pick_jump(const Query& s) {
  int32_t j = -1;
  for (int32_t d = (s.sc[DEPTH] < D ? s.sc[DEPTH] : D) - 1; d >= 0; --d)
    if (s.dflip[d] == 0) {
      j = d;
      break;
    }
  s.sc[JUMP] = j;
  if (j < 0) s.sc[STATUS] = UNSAT;
}

// Every variable above level j unassigned (this thread's variables).
__host__ __device__ __forceinline__ void unassign_above(const Query& s, int32_t V, int32_t j,
                                                        int tid, int nt) {
  for (int32_t v = tid; v < V; v += nt)
    if (s.level[v] > j) s.assign[v] = 0, s.level[v] = 0;
}

// The flip of slot j (one thread).
__host__ __device__ __forceinline__ void flip(const Query& s, int32_t j) {
  s.dval[j] = (int8_t)(3 - s.dval[j]);
  const int32_t v = s.dec[j];
  s.assign[v] = s.dval[j];
  s.level[v] = (int16_t)(j + 1);
  s.dflip[j] = 1;
  for (int32_t d = j + 1; d < D; ++d) s.dflip[d] = 0;
  s.sc[DEPTH] = j + 1;
}

__host__ __device__ __forceinline__ void set_sat(const Query& s) { s.sc[STATUS] = SAT; }

// The assignment, the status (RUNNING becomes UNKNOWN) and the steps taken.
__host__ __device__ __forceinline__ void store(const DpllArgs& a, int32_t q, const Query& s,
                                               int32_t steps, int tid, int nt) {
  int8_t* out = a.assign + (int64_t)q * a.V;
  for (int32_t v = tid; v < a.V; v += nt) out[v] = s.assign[v];
  if (tid == 0) {
    a.status[q] = (int8_t)(s.sc[STATUS] == RUNNING ? UNKNOWN : s.sc[STATUS]);
    a.steps[q] = steps;
  }
}

// One query's search.  The executor X runs a phase on the threads it owns
// (a CUDA thread itself, the host check all of them in turn):
//
//   X::stage(q), X::store(q, steps)       stage and store;
//   X::sweep() -> int                     the sweep's flags, OR over the block;
//   X::both() -> bool, X::apply(go) -> bool   OR over the block;
//   X::decide(), X::set_sat(), X::pick_jump(), X::flip(j)   on one thread;
//   X::unassign(j);  X::sync()            the barrier.
//
// Every OR is a barrier too, and every thread sees its result, so all take
// the same branches.
template <class X>
__host__ __device__ __forceinline__ void run_query(X& x, const DpllArgs& a, int32_t q,
                                                   const Query& s) {
  x.stage(q);
  x.sync();
  int32_t it = 0;
  for (; it < a.max_iters && s.sc[STATUS] == RUNNING; ++it) {
    const int flags = x.sweep();
    const bool conflict = (flags & 1) || x.both();
    const bool progressed = x.apply(!conflict);
    if (conflict) {
      x.pick_jump();
      x.sync();
      const int32_t j = s.sc[JUMP];
      if (j < 0) continue;
      x.unassign(j);
      x.sync();
      x.flip(j);
      x.sync();
    } else if (!progressed) {
      if (flags & 2)
        x.decide();
      else
        x.set_sat();
      x.sync();
    }
  }
  x.store(q, it);
}

}  // namespace dpll
}  // namespace mk
