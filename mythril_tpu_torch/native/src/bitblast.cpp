// Native tier-2 solver: bit-blasting CDCL for the probe stack.
//
// The reference leans on Z3 (C++) for every satisfiability question; this
// framework's device probe answers most queries, and this library provides
// the exact fallback for the residue: UNSAT verdicts the probe cannot give,
// and hard SAT instances the directed fuzzer misses.  See
// mythril_tpu/smt/solver.py (tier 2) and mythril_tpu/native/bitblast.py for
// the Python integration; SURVEY.md §2.9 names this component (the z3-solver
// row: "bit-blasted SAT ... kernel + host-side fallback oracle").
//
// Interface: a flat int32 "term tape" (7 ints per node: op, width, a0, a1,
// a2, aux0, aux1) + a little-endian byte pool for constants.  Every node is
// Tseitin-encoded into CNF (LSB-first literal vectors); root nodes are
// asserted true; the CDCL core (two-watched-literal propagation, 1UIP
// learning, VSIDS decisions, Luby restarts, phase saving) decides the
// formula.  Models are returned as packed bits for each VAR node in tape
// order.  Semantics mirror mythril_tpu/smt/concrete_eval.py exactly
// (EVM-style div-by-zero == 0, shifts >= width == 0, ashr saturates).
//
// Build: g++ -O2 -shared -fPIC (driven by mythril_tpu/native/build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CDCL SAT core
// ---------------------------------------------------------------------------

using Lit = int32_t;  // (var << 1) | sign ; var 0 is the constant TRUE var
inline Lit mklit(int v, bool neg) { return (v << 1) | (neg ? 1 : 0); }
inline int var_of(Lit l) { return l >> 1; }
inline bool sign_of(Lit l) { return l & 1; }
inline Lit neg(Lit l) { return l ^ 1; }

const Lit LIT_TRUE = 0;   // var 0 positive
const Lit LIT_FALSE = 1;  // var 0 negated

enum Value : int8_t { V_UNDEF = 0, V_TRUE = 1, V_FALSE = 2 };

struct Clause {
  std::vector<Lit> lits;
  bool learned;
};

struct Watcher {
  Clause* clause;
  Lit blocker;
};

class Solver {
 public:
  Solver() {
    new_var();  // var 0 = constant true
    enqueue(LIT_TRUE, nullptr);
  }

  ~Solver() {
    for (Clause* c : clauses_) delete c;
    for (Clause* c : learned_) delete c;
  }

  int new_var() {
    int v = (int)assigns_.size();
    assigns_.push_back(V_UNDEF);
    level_.push_back(-1);
    reason_.push_back(nullptr);
    activity_.push_back(0.0);
    phase_.push_back(false);
    watches_.emplace_back();
    watches_.emplace_back();
    heap_pos_.push_back(-1);
    heap_insert(v);
    return v;
  }

  size_t num_clauses() const { return clauses_.size() + learned_.size(); }

  Value value(Lit l) const {
    Value v = (Value)assigns_[var_of(l)];
    if (v == V_UNDEF) return V_UNDEF;
    if (sign_of(l)) return v == V_TRUE ? V_FALSE : V_TRUE;
    return v;
  }

  // Add a clause; returns false if the formula became trivially unsat.
  bool add_clause(std::vector<Lit> lits) {
    // top-level simplification: remove false lits, drop satisfied clauses
    std::sort(lits.begin(), lits.end());
    lits.erase(std::unique(lits.begin(), lits.end()), lits.end());
    std::vector<Lit> out;
    for (Lit l : lits) {
      if (std::binary_search(lits.begin(), lits.end(), neg(l)) && var_of(l) != 0)
        return true;  // tautology
      Value v = value(l);
      if (v == V_TRUE && level_[var_of(l)] <= 0) return true;
      if (v == V_FALSE && level_[var_of(l)] <= 0) continue;
      out.push_back(l);
    }
    if (out.empty()) return ok_ = false;
    if (out.size() == 1) {
      if (value(out[0]) == V_FALSE) return ok_ = false;
      if (value(out[0]) == V_UNDEF) enqueue(out[0], nullptr);
      return ok_;
    }
    attach(new_clause(std::move(out), false));
    return ok_;
  }

  // Return to decision level 0 so clauses can be added after a solve()
  // left the trail at a satisfying (or partial) assignment.
  void reset_root() { backtrack(0); }

  // status: 1 sat, 0 unsat (w.r.t. assumptions when given), -1 budget
  // exceeded.  Assumptions are decided first, MiniSat-style (each on its
  // own level; already-true ones get a dummy level) — learned clauses are
  // consequences of the CNF alone, so they persist soundly across calls
  // with different assumption sets (the incremental Optimize session).
  int solve(double deadline_wall, const std::vector<Lit>& assumptions = {}) {
    backtrack(0);
    if (!ok_) return 0;
    if (propagate() != nullptr) return 0;
    int64_t conflicts = 0;
    int restart_idx = 0;
    int64_t restart_budget = luby(restart_idx) * 128;
    for (;;) {
      Clause* confl = propagate();
      if (confl != nullptr) {
        conflicts++;
        if (decision_level() == 0) return 0;
        if (decision_level() <= (int)assumptions.size()) {
          // conflict entirely under the assumption prefix: analyze() would
          // need to flip an assumption — UNSAT under these assumptions.
          // (Learned-clause quality is irrelevant here; just report.)
          backtrack(0);
          return 0;
        }
        std::vector<Lit> learnt;
        int bt;
        analyze(confl, learnt, bt);
        backtrack(bt);
        if (learnt.size() == 1) {
          enqueue(learnt[0], nullptr);
        } else {
          Clause* c = new_clause(std::move(learnt), true);
          attach(c);
          enqueue(c->lits[0], c);
        }
        var_decay();
        if ((conflicts & 1023) == 0) {
          if (wall_now() > deadline_wall) return -1;
          if (num_clauses() > 6000000) return -1;
        }
        if (conflicts > restart_budget) {
          conflicts = 0;
          restart_budget = luby(++restart_idx) * 128;
          backtrack(0);
        }
      } else {
        Lit next = -1;
        while (decision_level() < (int)assumptions.size()) {
          Lit a = assumptions[decision_level()];
          Value v = value(a);
          if (v == V_TRUE) {
            trail_lim_.push_back((int)trail_.size());  // dummy level
            continue;
          }
          if (v == V_FALSE) {
            backtrack(0);
            return 0;  // UNSAT under assumptions
          }
          next = a;
          break;
        }
        if (next == -1) next = decide();
        if (next == -1) return 1;  // all assigned: SAT
        trail_lim_.push_back((int)trail_.size());
        enqueue(next, nullptr);
      }
    }
  }

  bool model_value(int v) const { return assigns_[v] == V_TRUE; }
  bool ok() const { return ok_; }

 private:
  bool ok_ = true;
  std::vector<int8_t> assigns_;
  std::vector<int> level_;
  std::vector<Clause*> reason_;
  std::vector<double> activity_;
  std::vector<bool> phase_;
  std::vector<std::vector<Watcher>> watches_;  // indexed by lit
  std::vector<Lit> trail_;
  std::vector<int> trail_lim_;
  size_t qhead_ = 0;
  std::vector<Clause*> clauses_, learned_;
  double var_inc_ = 1.0;
  // binary max-heap over activity for decisions
  std::vector<int> heap_;
  std::vector<int> heap_pos_;

  static double wall_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
  }

  static int64_t luby(int i) {
    // Luby sequence (1,1,2,1,1,2,4,...)
    int k = 1;
    while ((1 << (k + 1)) - 1 <= i + 1) k++;
    while (i + 1 != (1 << k) - 1) {
      i = i - (1 << (k - 1)) + 1 - 1;
      k--;
      while ((1 << (k + 1)) - 1 <= i + 1) k++;
    }
    return 1ll << (k - 1);
  }

  int decision_level() const { return (int)trail_lim_.size(); }

  Clause* new_clause(std::vector<Lit> lits, bool learned) {
    Clause* c = new Clause{std::move(lits), learned};
    (learned ? learned_ : clauses_).push_back(c);
    return c;
  }

  void attach(Clause* c) {
    watches_[neg(c->lits[0])].push_back({c, c->lits[1]});
    watches_[neg(c->lits[1])].push_back({c, c->lits[0]});
  }

  void enqueue(Lit l, Clause* from) {
    int v = var_of(l);
    assigns_[v] = sign_of(l) ? V_FALSE : V_TRUE;
    level_[v] = decision_level();
    reason_[v] = from;
    phase_[v] = !sign_of(l);
    trail_.push_back(l);
  }

  Clause* propagate() {
    while (qhead_ < trail_.size()) {
      Lit p = trail_[qhead_++];
      auto& ws = watches_[p];
      size_t i = 0, j = 0;
      while (i < ws.size()) {
        Watcher w = ws[i++];
        if (value(w.blocker) == V_TRUE) {
          ws[j++] = w;
          continue;
        }
        Clause& c = *w.clause;
        // make sure c.lits[1] is the false literal (neg(p))
        if (c.lits[0] == neg(p)) std::swap(c.lits[0], c.lits[1]);
        if (value(c.lits[0]) == V_TRUE) {
          ws[j++] = {w.clause, c.lits[0]};
          continue;
        }
        // look for a new watch
        bool found = false;
        for (size_t k = 2; k < c.lits.size(); k++) {
          if (value(c.lits[k]) != V_FALSE) {
            std::swap(c.lits[1], c.lits[k]);
            watches_[neg(c.lits[1])].push_back({w.clause, c.lits[0]});
            found = true;
            break;
          }
        }
        if (found) continue;
        // unit or conflict
        ws[j++] = w;
        if (value(c.lits[0]) == V_FALSE) {
          while (i < ws.size()) ws[j++] = ws[i++];
          ws.resize(j);
          qhead_ = trail_.size();
          return w.clause;
        }
        enqueue(c.lits[0], w.clause);
      }
      ws.resize(j);
    }
    return nullptr;
  }

  void bump(int v) {
    if ((activity_[v] += var_inc_) > 1e100) {
      for (auto& a : activity_) a *= 1e-100;
      var_inc_ *= 1e-100;
    }
    heap_update(v);
  }

  void var_decay() { var_inc_ *= (1.0 / 0.95); }

  void analyze(Clause* confl, std::vector<Lit>& out, int& bt_level) {
    out.clear();
    out.push_back(-1);  // slot for the asserting literal
    std::vector<bool> seen(assigns_.size(), false);
    int counter = 0;
    Lit p = -1;
    size_t idx = trail_.size();
    for (;;) {
      for (size_t k = (p == -1 ? 0 : 1); k < confl->lits.size(); k++) {
        Lit q = confl->lits[k];
        int v = var_of(q);
        if (!seen[v] && level_[v] > 0) {
          seen[v] = true;
          bump(v);
          if (level_[v] >= decision_level())
            counter++;
          else
            out.push_back(q);
        }
      }
      // next literal on trail at current level
      while (!seen[var_of(trail_[--idx])]) {
      }
      p = trail_[idx];
      confl = reason_[var_of(p)];
      seen[var_of(p)] = false;
      if (--counter == 0) break;
    }
    out[0] = neg(p);
    // backtrack level = max level among the rest
    bt_level = 0;
    int max_i = 1;
    for (size_t k = 1; k < out.size(); k++) {
      if (level_[var_of(out[k])] > bt_level) {
        bt_level = level_[var_of(out[k])];
        max_i = (int)k;
      }
    }
    if (out.size() > 1) std::swap(out[1], out[max_i]);
  }

  void backtrack(int lvl) {
    if (decision_level() <= lvl) return;
    for (int i = (int)trail_.size() - 1; i >= trail_lim_[lvl]; i--) {
      int v = var_of(trail_[i]);
      assigns_[v] = V_UNDEF;
      reason_[v] = nullptr;
      heap_insert(v);
    }
    trail_.resize(trail_lim_[lvl]);
    trail_lim_.resize(lvl);
    qhead_ = trail_.size();
  }

  Lit decide() {
    while (!heap_.empty()) {
      int v = heap_pop();
      if (assigns_[v] == V_UNDEF) return mklit(v, !phase_[v]);
    }
    return -1;
  }

  // -- activity heap
  void heap_swap(int i, int j) {
    std::swap(heap_[i], heap_[j]);
    heap_pos_[heap_[i]] = i;
    heap_pos_[heap_[j]] = j;
  }
  void heap_up(int i) {
    while (i > 0) {
      int p = (i - 1) / 2;
      if (activity_[heap_[i]] <= activity_[heap_[p]]) break;
      heap_swap(i, p);
      i = p;
    }
  }
  void heap_down(int i) {
    for (;;) {
      int l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < (int)heap_.size() && activity_[heap_[l]] > activity_[heap_[m]]) m = l;
      if (r < (int)heap_.size() && activity_[heap_[r]] > activity_[heap_[m]]) m = r;
      if (m == i) break;
      heap_swap(i, m);
      i = m;
    }
  }
  void heap_insert(int v) {
    if (heap_pos_[v] != -1) return;
    heap_pos_[v] = (int)heap_.size();
    heap_.push_back(v);
    heap_up(heap_pos_[v]);
  }
  void heap_update(int v) {
    if (heap_pos_[v] != -1) heap_up(heap_pos_[v]);
  }
  int heap_pop() {
    int v = heap_[0];
    heap_swap(0, (int)heap_.size() - 1);
    heap_.pop_back();
    heap_pos_[v] = -1;
    if (!heap_.empty()) heap_down(0);
    return v;
  }
};

// ---------------------------------------------------------------------------
// Tseitin circuit builder with constant folding
// ---------------------------------------------------------------------------

class Circuit {
 public:
  explicit Circuit(Solver& s) : s_(s) {}

  Lit lit_and(Lit a, Lit b) {
    if (a == LIT_FALSE || b == LIT_FALSE) return LIT_FALSE;
    if (a == LIT_TRUE) return b;
    if (b == LIT_TRUE) return a;
    if (a == b) return a;
    if (a == neg(b)) return LIT_FALSE;
    Lit o = mklit(s_.new_var(), false);
    s_.add_clause({neg(a), neg(b), o});
    s_.add_clause({a, neg(o)});
    s_.add_clause({b, neg(o)});
    return o;
  }

  Lit lit_or(Lit a, Lit b) { return neg(lit_and(neg(a), neg(b))); }

  Lit lit_xor(Lit a, Lit b) {
    if (a == LIT_FALSE) return b;
    if (b == LIT_FALSE) return a;
    if (a == LIT_TRUE) return neg(b);
    if (b == LIT_TRUE) return neg(a);
    if (a == b) return LIT_FALSE;
    if (a == neg(b)) return LIT_TRUE;
    Lit o = mklit(s_.new_var(), false);
    s_.add_clause({neg(a), neg(b), neg(o)});
    s_.add_clause({a, b, neg(o)});
    s_.add_clause({neg(a), b, o});
    s_.add_clause({a, neg(b), o});
    return o;
  }

  Lit lit_ite(Lit c, Lit t, Lit e) {
    if (c == LIT_TRUE) return t;
    if (c == LIT_FALSE) return e;
    if (t == e) return t;
    if (t == LIT_TRUE && e == LIT_FALSE) return c;
    if (t == LIT_FALSE && e == LIT_TRUE) return neg(c);
    Lit o = mklit(s_.new_var(), false);
    s_.add_clause({neg(c), neg(t), o});
    s_.add_clause({neg(c), t, neg(o)});
    s_.add_clause({c, neg(e), o});
    s_.add_clause({c, e, neg(o)});
    return o;
  }

  Lit big_and(const std::vector<Lit>& xs) {
    std::vector<Lit> body;
    for (Lit x : xs) {
      if (x == LIT_FALSE) return LIT_FALSE;
      if (x != LIT_TRUE) body.push_back(x);
    }
    if (body.empty()) return LIT_TRUE;
    if (body.size() == 1) return body[0];
    Lit o = mklit(s_.new_var(), false);
    std::vector<Lit> all{o};
    for (Lit x : body) {
      s_.add_clause({x, neg(o)});
      all.push_back(neg(x));
    }
    s_.add_clause(all);
    return o;
  }

  Lit big_or(std::vector<Lit> xs) {
    for (auto& x : xs) x = neg(x);
    return neg(big_and(xs));
  }

  // bit-vector values are LSB-first literal vectors
  using BV = std::vector<Lit>;

  Lit eq(const BV& a, const BV& b) {
    std::vector<Lit> bits;
    for (size_t i = 0; i < a.size(); i++) bits.push_back(neg(lit_xor(a[i], b[i])));
    return big_and(bits);
  }

  BV add(const BV& a, const BV& b, Lit cin = LIT_FALSE) {
    BV out(a.size());
    Lit c = cin;
    for (size_t i = 0; i < a.size(); i++) {
      Lit axb = lit_xor(a[i], b[i]);
      out[i] = lit_xor(axb, c);
      // carry = (a&b) | (c & (a^b))
      c = lit_or(lit_and(a[i], b[i]), lit_and(c, axb));
    }
    return out;
  }

  BV bvnot(const BV& a) {
    BV out(a.size());
    for (size_t i = 0; i < a.size(); i++) out[i] = neg(a[i]);
    return out;
  }

  BV sub(const BV& a, const BV& b) { return add(a, bvnot(b), LIT_TRUE); }

  BV bvneg(const BV& a) { return add(bvnot(a), constant(0, a.size()), LIT_TRUE); }

  Lit ult(const BV& a, const BV& b) {
    Lit lt = LIT_FALSE;
    for (size_t i = 0; i < a.size(); i++) {
      Lit eqb = neg(lit_xor(a[i], b[i]));
      lt = lit_or(lit_and(neg(a[i]), b[i]), lit_and(eqb, lt));
    }
    return lt;
  }

  Lit slt(const BV& a, const BV& b) {
    Lit sa = a.back(), sb = b.back();
    Lit both = neg(lit_xor(sa, sb));
    return lit_or(lit_and(sa, neg(sb)), lit_and(both, ult(a, b)));
  }

  BV mux(Lit c, const BV& t, const BV& e) {
    BV out(t.size());
    for (size_t i = 0; i < t.size(); i++) out[i] = lit_ite(c, t[i], e[i]);
    return out;
  }

  BV mul(const BV& a, const BV& b) {
    // Column-compression (Dadda-style) multiplier: bucket partial products
    // by output column, 3:2 full-adder compression, one final ripple add.
    // Versus row-ripple accumulation this emits ~1.5x fewer adders for
    // zext'd operands (zero partial products fold away entirely) and a far
    // shallower carry structure — the 512-bit overflow-predicate multiply
    // (BVMulNoOverflow on 256-bit EVM words) is the motivating case.
    size_t w = a.size();
    std::vector<std::vector<Lit>> cols(w);
    for (size_t i = 0; i < w; i++) {
      if (b[i] == LIT_FALSE) continue;
      for (size_t j = 0; i + j < w; j++) {
        Lit pp = lit_and(a[j], b[i]);
        if (pp != LIT_FALSE) cols[i + j].push_back(pp);
      }
    }
    BV row0(w, LIT_FALSE), row1(w, LIT_FALSE);
    for (size_t k = 0; k < w; k++) {
      auto& c = cols[k];
      size_t head = 0;
      while (c.size() - head >= 3) {
        Lit x = c[head], y = c[head + 1], z = c[head + 2];
        head += 3;
        Lit xy = lit_xor(x, y);
        c.push_back(lit_xor(xy, z));  // sum stays in this column
        Lit carry = lit_or(lit_and(x, y), lit_and(z, xy));
        if (k + 1 < w && carry != LIT_FALSE) cols[k + 1].push_back(carry);
      }
      if (c.size() - head == 2) {
        // half-adder: defer the pairwise add to the final ripple rows
        row0[k] = c[head];
        row1[k] = c[head + 1];
      } else if (c.size() - head == 1) {
        row0[k] = c[head];
      }
      c.clear();
    }
    return add(row0, row1);
  }

  // q, r as fresh variables constrained by a == q*b + r (2w-bit), r < b;
  // b == 0 yields q = 0, r = 0 (EVM semantics, concrete_eval.py:152-177)
  void udivrem(const BV& a, const BV& b, BV& q, BV& r) {
    size_t w = a.size();
    q = fresh(w);
    r = fresh(w);
    Lit bz = is_zero(b);
    for (size_t i = 0; i < w; i++) {
      s_.add_clause({neg(bz), neg(q[i])});
      s_.add_clause({neg(bz), neg(r[i])});
    }
    BV a2 = zext(a, 2 * w), b2 = zext(b, 2 * w), q2 = zext(q, 2 * w),
       r2 = zext(r, 2 * w);
    BV prod = mul(q2, b2);
    BV sum = add(prod, r2);
    Lit exact = eq(sum, a2);
    Lit bounded = ult(r, b);
    s_.add_clause({bz, exact});
    s_.add_clause({bz, bounded});
  }

  Lit is_zero(const BV& a) {
    std::vector<Lit> bits;
    for (Lit x : a) bits.push_back(neg(x));
    return big_and(bits);
  }

  BV constant(uint64_t v, size_t w) {
    BV out(w);
    for (size_t i = 0; i < w; i++)
      out[i] = (i < 64 && ((v >> i) & 1)) ? LIT_TRUE : LIT_FALSE;
    return out;
  }

  BV from_bytes(const uint8_t* bytes, size_t nbytes, size_t w) {
    BV out(w, LIT_FALSE);
    for (size_t i = 0; i < w && i / 8 < nbytes; i++)
      if ((bytes[i / 8] >> (i % 8)) & 1) out[i] = LIT_TRUE;
    return out;
  }

  BV fresh(size_t w) {
    BV out(w);
    for (size_t i = 0; i < w; i++) out[i] = mklit(s_.new_var(), false);
    return out;
  }

  BV zext(const BV& a, size_t w) {
    BV out = a;
    out.resize(w, LIT_FALSE);
    return out;
  }

  BV sext(const BV& a, size_t w) {
    BV out = a;
    out.resize(w, a.back());
    return out;
  }

  // Barrel shifters; amt semantics follow concrete_eval.py:191-193.
  BV shl(const BV& a, const BV& amt) { return shift(a, amt, false, LIT_FALSE); }
  BV lshr(const BV& a, const BV& amt) { return shift(a, amt, true, LIT_FALSE); }
  BV ashr(const BV& a, const BV& amt) { return shift(a, amt, true, a.back(), true); }

 private:
  BV shift(const BV& a, const BV& amt, bool right, Lit fill, bool saturate = false) {
    size_t w = a.size();
    int stages = 0;
    while ((1u << stages) < w) stages++;
    BV cur = a;
    for (int s = 0; s < stages; s++) {
      size_t k = 1u << s;
      BV shifted(w, fill);
      for (size_t i = 0; i < w; i++) {
        if (right) {
          if (i + k < w) shifted[i] = cur[i + k];
        } else {
          if (i >= k) shifted[i] = cur[i - k];
        }
      }
      cur = mux(amt[s], shifted, cur);
    }
    // out-of-range: any amount bit at or above `stages` set -> amount >= 2^stages >= w
    // (for non-power-of-two widths also compare the in-stage part against w)
    std::vector<Lit> high;
    for (size_t i = stages; i < amt.size(); i++) high.push_back(amt[i]);
    Lit oor = big_or(high);
    if ((1u << stages) != w) {
      // stages cover up to 2^stages-1 >= w: also out of range when the low
      // bits alone reach w
      BV low(amt.begin(), amt.begin() + stages);
      Lit low_ge_w = neg(ult(zext(low, w), constant(w, w)));
      oor = lit_or(oor, low_ge_w);
    }
    BV oob(w, saturate ? fill : LIT_FALSE);
    return mux(oor, oob, cur);
  }

  Solver& s_;
};

// ---------------------------------------------------------------------------
// Tape interpreter
// ---------------------------------------------------------------------------

enum Op : int32_t {
  OP_CONST = 0,
  OP_VAR = 1,
  OP_EQ = 2,
  OP_AND = 3,
  OP_OR = 4,
  OP_NOT = 5,
  OP_XOR = 6,
  OP_ITE = 7,
  OP_ADD = 8,
  OP_SUB = 9,
  OP_MUL = 10,
  OP_UDIV = 11,
  OP_UREM = 12,
  OP_SDIV = 13,
  OP_SREM = 14,
  OP_BAND = 15,
  OP_BOR = 16,
  OP_BXOR = 17,
  OP_BNOT = 18,
  OP_NEG = 19,
  OP_SHL = 20,
  OP_LSHR = 21,
  OP_ASHR = 22,
  OP_CONCAT = 23,
  OP_EXTRACT = 24,
  OP_ZEXT = 25,
  OP_SEXT = 26,
  OP_ULT = 27,
  OP_ULE = 28,
  OP_SLT = 29,
  OP_SLE = 30,
};

const int REC = 7;  // int32s per tape record

// A blasted tape kept alive for incremental solving: the CNF (with all
// learned clauses) persists across bb_solve_assume calls, so a sequence of
// bound queries over the same formula — the Optimize refinement loop — pays
// the circuit construction once instead of once per query.
struct Blasted {
  Solver solver;
  std::vector<Circuit::BV> val;
  std::vector<int32_t> tape;  // copy (REC per node) for model packing
  int64_t n_nodes = 0;
  int status = 1;  // 1 usable, 0 globally unsat, -1 unsupported
};

// Appends `n_new` records to b (argument indices may reference any node
// below the new total) and asserts `roots`; returns 1 ok, 0 unsat, -1
// unsupported.  Called with an empty Blasted this is the original full
// blast; called again via bb_extend it grows an open session in place
// (CEGAR congruence refinement) while keeping all learned clauses.
static int blast_append(Blasted& b, const int32_t* tape, int64_t n_new,
                        const uint8_t* consts, const int32_t* roots,
                        int64_t n_roots) {
  Solver& solver = b.solver;
  Circuit cir(solver);
  const int64_t base = b.n_nodes;
  b.val.resize(base + n_new);
  b.tape.insert(b.tape.end(), tape, tape + n_new * REC);
  b.n_nodes = base + n_new;
  std::vector<Circuit::BV>& val = b.val;
  for (int64_t ii = 0; ii < n_new; ii++) {
    const int64_t i = base + ii;
    const int32_t* r = tape + ii * REC;
    int32_t op = r[0], w = r[1], a0 = r[2], a1 = r[3], a2 = r[4], x0 = r[5],
            x1 = r[6];
    auto A = [&](int32_t k) -> const Circuit::BV& { return val[k]; };
    switch (op) {
      case OP_CONST:
        val[i] = cir.from_bytes(consts + x0, (size_t)x1, w);
        break;
      case OP_VAR:
        val[i] = cir.fresh(w);
        break;
      case OP_EQ:
        val[i] = {cir.eq(A(a0), A(a1))};
        break;
      case OP_AND:
        val[i] = {cir.lit_and(A(a0)[0], A(a1)[0])};
        break;
      case OP_OR:
        val[i] = {cir.lit_or(A(a0)[0], A(a1)[0])};
        break;
      case OP_NOT:
        val[i] = {neg(A(a0)[0])};
        break;
      case OP_XOR:
        val[i] = {cir.lit_xor(A(a0)[0], A(a1)[0])};
        break;
      case OP_ITE:
        val[i] = cir.mux(A(a0)[0], A(a1), A(a2));
        break;
      case OP_ADD:
        val[i] = cir.add(A(a0), A(a1));
        break;
      case OP_SUB:
        val[i] = cir.sub(A(a0), A(a1));
        break;
      case OP_MUL:
        val[i] = cir.mul(A(a0), A(a1));
        break;
      case OP_UDIV:
      case OP_UREM: {
        Circuit::BV q, rr;
        cir.udivrem(A(a0), A(a1), q, rr);
        val[i] = (op == OP_UDIV) ? q : rr;
        break;
      }
      case OP_SDIV:
      case OP_SREM: {
        const Circuit::BV &a = A(a0), &b = A(a1);
        Lit sa = a.back(), sb = b.back();
        Circuit::BV absa = cir.mux(sa, cir.bvneg(a), a);
        Circuit::BV absb = cir.mux(sb, cir.bvneg(b), b);
        Circuit::BV q, rr;
        cir.udivrem(absa, absb, q, rr);
        if (op == OP_SDIV) {
          Lit flip = cir.lit_xor(sa, sb);
          val[i] = cir.mux(flip, cir.bvneg(q), q);
        } else {
          val[i] = cir.mux(sa, cir.bvneg(rr), rr);
        }
        break;
      }
      case OP_BAND:
      case OP_BOR:
      case OP_BXOR: {
        const Circuit::BV &a = A(a0), &b = A(a1);
        Circuit::BV out(w);
        for (int k = 0; k < w; k++)
          out[k] = (op == OP_BAND)  ? cir.lit_and(a[k], b[k])
                   : (op == OP_BOR) ? cir.lit_or(a[k], b[k])
                                    : cir.lit_xor(a[k], b[k]);
        val[i] = out;
        break;
      }
      case OP_BNOT:
        val[i] = cir.bvnot(A(a0));
        break;
      case OP_NEG:
        val[i] = cir.bvneg(A(a0));
        break;
      case OP_SHL:
        val[i] = cir.shl(A(a0), A(a1));
        break;
      case OP_LSHR:
        val[i] = cir.lshr(A(a0), A(a1));
        break;
      case OP_ASHR:
        val[i] = cir.ashr(A(a0), A(a1));
        break;
      case OP_CONCAT: {
        // arg0 is the HIGH part (concrete_eval.py:107-108)
        Circuit::BV out = A(a1);
        out.insert(out.end(), A(a0).begin(), A(a0).end());
        val[i] = out;
        break;
      }
      case OP_EXTRACT: {
        int hi = x0, lo = x1;
        val[i] = Circuit::BV(A(a0).begin() + lo, A(a0).begin() + hi + 1);
        break;
      }
      case OP_ZEXT:
        val[i] = cir.zext(A(a0), w);
        break;
      case OP_SEXT:
        val[i] = cir.sext(A(a0), w);
        break;
      case OP_ULT:
        val[i] = {cir.ult(A(a0), A(a1))};
        break;
      case OP_ULE:
        val[i] = {neg(cir.ult(A(a1), A(a0)))};
        break;
      case OP_SLT:
        val[i] = {cir.slt(A(a0), A(a1))};
        break;
      case OP_SLE:
        val[i] = {neg(cir.slt(A(a1), A(a0)))};
        break;
      default:
        return -1;  // unsupported op
    }
    if (!solver.ok()) return 0;
    if (solver.num_clauses() > 6000000) return -1;
  }

  for (int64_t k = 0; k < n_roots; k++) {
    if (!solver.add_clause({val[roots[k]][0]})) return 0;
  }
  return 1;
}

static int blast(Blasted& b, const int32_t* tape, int64_t n_nodes,
                 const uint8_t* consts, const int32_t* roots, int64_t n_roots) {
  return blast_append(b, tape, n_nodes, consts, roots, n_roots);
}

// Pack VAR models in tape order; returns 1, or -1 if model_cap is short.
static int pack_model(const Blasted& b, uint8_t* model_out, int64_t model_cap) {
  int64_t off = 0;
  for (int64_t i = 0; i < b.n_nodes; i++) {
    const int32_t* r = b.tape.data() + i * REC;
    if (r[0] != OP_VAR) continue;
    int w = r[1];
    int nbytes = (w + 7) / 8;
    if (off + nbytes > model_cap) return -1;
    for (int k = 0; k < nbytes; k++) model_out[off + k] = 0;
    for (int bit = 0; bit < w; bit++) {
      Lit l = b.val[i][bit];
      bool bv;
      if (l == LIT_TRUE)
        bv = true;
      else if (l == LIT_FALSE)
        bv = false;
      else
        bv = sign_of(l) ? !b.solver.model_value(var_of(l))
                        : b.solver.model_value(var_of(l));
      if (bv) model_out[off + bit / 8] |= (1 << (bit % 8));
    }
    off += nbytes;
  }
  return 1;
}

static double wall_deadline(double timeout_s) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9 + timeout_s;
}

}  // namespace

extern "C" {

// status: 1 sat (model filled), 0 unsat, -1 unknown (unsupported op /
// budget / timeout).  model_out receives, for each VAR node in tape order,
// ceil(width/8) bytes little-endian.
int32_t bb_solve(const int32_t* tape, int64_t n_nodes, const uint8_t* consts,
                 int64_t consts_len, const int32_t* roots, int64_t n_roots,
                 double timeout_s, uint8_t* model_out, int64_t model_cap) {
  (void)consts_len;
  Blasted b;
  int st = blast(b, tape, n_nodes, consts, roots, n_roots);
  if (st != 1) return st;
  int status = b.solver.solve(wall_deadline(timeout_s));
  if (status != 1) return status;
  return pack_model(b, model_out, model_cap);
}

// ---------------------------------------------------------------------------
// Incremental session (Optimize bound refinement): blast once, then answer
// many queries under assumptions.  Assumption encoding per int64 element:
// (node_id << 16) | (bit_index << 1) | value — node must be an OP_VAR.
// ---------------------------------------------------------------------------

void* bb_open(const int32_t* tape, int64_t n_nodes, const uint8_t* consts,
              int64_t consts_len, const int32_t* roots, int64_t n_roots) {
  (void)consts_len;
  Blasted* b = new Blasted();
  b->status = blast(*b, tape, n_nodes, consts, roots, n_roots);
  if (b->status == -1) {
    delete b;
    return nullptr;
  }
  return b;
}

// Grow an open session in place: append `n_new` records (congruence pairs
// over EXISTING nodes; no OP_CONST/OP_VAR expected but both are handled)
// and assert `roots`.  Learned clauses persist — they are consequences of
// the original CNF and adding clauses cannot invalidate them.  Returns 1
// ok, 0 formula now unsat, -1 unusable.
int32_t bb_extend(void* handle, const int32_t* tape, int64_t n_new,
                  const uint8_t* consts, int64_t consts_len,
                  const int32_t* roots, int64_t n_roots) {
  (void)consts_len;
  Blasted* b = static_cast<Blasted*>(handle);
  if (b == nullptr || b->status == -1) return -1;
  if (b->status == 0) return 0;
  b->solver.reset_root();
  int st = blast_append(*b, tape, n_new, consts, roots, n_roots);
  if (st != 1) b->status = st;
  return st;
}

int32_t bb_solve_assume(void* handle, const int64_t* assume, int64_t n_assume,
                        double timeout_s, uint8_t* model_out,
                        int64_t model_cap) {
  Blasted* b = static_cast<Blasted*>(handle);
  if (b == nullptr) return -1;
  if (b->status == 0) return 0;  // globally unsat at blast time
  std::vector<Lit> assumptions;
  assumptions.reserve((size_t)n_assume);
  for (int64_t k = 0; k < n_assume; k++) {
    int64_t a = assume[k];
    int64_t node = a >> 16;
    int bit = (int)((a >> 1) & 0x7FFF);
    bool value = (a & 1) != 0;
    if (node < 0 || node >= b->n_nodes) return -1;
    if (b->tape[node * REC] != OP_VAR) return -1;
    if (bit >= (int)b->val[node].size()) return -1;
    Lit l = b->val[node][bit];
    if (l == LIT_TRUE || l == LIT_FALSE) {
      if ((l == LIT_TRUE) != value) return 0;
      continue;
    }
    assumptions.push_back(value ? l : neg(l));
  }
  int status = b->solver.solve(wall_deadline(timeout_s), assumptions);
  if (status != 1) return status;
  return pack_model(*b, model_out, model_cap);
}

void bb_close(void* handle) { delete static_cast<Blasted*>(handle); }

}  // extern "C"
