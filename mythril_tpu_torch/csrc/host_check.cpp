// Host build of the kernels' per-thread code, for checking the CUDA sources'
// arithmetic without a card: a host C++ compiler builds this file with the
// same headers the kernels use (tests/test_torch_csrc_host.py,
// tests/test_torch_frontier_host.py).  Each entry runs the body a CUDA
// thread runs, once per state, candidate, path, row or query.
#include <stdint.h>
#include <string.h>
#include <ucontext.h>

#include <vector>

#include "dpll.cuh"
#include "frontier_segment.cuh"
#include "known_bits.cuh"
#include "lowering.cuh"
#include "tape_vm.cuh"

extern "C" void mk_keccak_f1600_host(const int32_t* in, int32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    uint64_t a[25];
    for (int l = 0; l < 25; ++l) {
      const int32_t* s = in + i * 100 + 4 * l;
      a[l] = mk::lane_from_limbs(s[0], s[1], s[2], s[3]);
    }
    mk::keccak_f1600(a);
    for (int l = 0; l < 25; ++l)
      for (int j = 0; j < 4; ++j) out[i * 100 + 4 * l + j] = mk::lane_limb(a[l], j);
  }
}

// The warp-per-state body with the 25 lanes as coroutines of the caller's
// thread, run phase by phase: every lane runs to its next exchange before
// any goes on.  An exchange publishes the lane's value and yields; once all
// 25 have published, each reads its source's and yields again, as
// __shfl_sync does in one instruction.  One thread, so a loaded host slows
// it down no more than any other single-threaded check.
struct HostWarp {
  ucontext_t main, ctx[25];
  uint64_t buf[25];
  const int32_t* in;
  int32_t* out;
  int done;
  std::vector<char> stacks;
};

thread_local HostWarp* host_warp;

struct HostExchange {
  HostWarp* w;
  int lane;
  uint64_t operator()(uint64_t v, int src) {
    w->buf[lane] = v;
    swapcontext(&w->ctx[lane], &w->main);
    const uint64_t r = w->buf[src];
    swapcontext(&w->ctx[lane], &w->main);
    return r;
  }
};

static void host_warp_lane(int l) {
  HostWarp* w = host_warp;
  HostExchange ex{w, l};
  const int32_t* s = w->in + 4 * l;
  const uint64_t a = mk::keccak_f1600_lane(mk::lane_from_limbs(s[0], s[1], s[2], s[3]), l, ex);
  for (int j = 0; j < 4; ++j) w->out[4 * l + j] = mk::lane_limb(a, j);
  ++w->done;
}

extern "C" void mk_keccak_f1600_warp_host(const int32_t* in, int32_t* out, long long n) {
  constexpr size_t kStack = 64 * 1024;
  HostWarp w;
  w.stacks.resize(25 * kStack);
  host_warp = &w;
  for (long long i = 0; i < n; ++i) {
    w.in = in + i * 100;
    w.out = out + i * 100;
    w.done = 0;
    for (int l = 0; l < 25; ++l) {
      getcontext(&w.ctx[l]);
      w.ctx[l].uc_stack.ss_sp = w.stacks.data() + l * kStack;
      w.ctx[l].uc_stack.ss_size = kStack;
      w.ctx[l].uc_link = &w.main;
      makecontext(&w.ctx[l], (void (*)())host_warp_lane, 1, l);
    }
    // one pass per phase: each lane runs to its next yield (or its end)
    while (w.done < 25)
      for (int l = 0; l < 25; ++l) swapcontext(&w.main, &w.ctx[l]);
  }
  host_warp = nullptr;
}

// One segment, candidate after candidate.  Each candidate's slot file is a
// host array that starts filled with a poison word, as shared memory starts
// with whatever the last block left: a value must come from a step of this
// segment, the leaves or the spill.
extern "C" int mk_tape_vm_segment_host(const mk::TapeArgs* args) {
  const mk::TapeArgs& t = *args;
  std::vector<int32_t> staged_mem(mk::staged_ints(t));
  const mk::Staged staged = mk::staged_at(t, staged_mem.data());
  mk::stage(t, staged, 0, 1);
  std::vector<uint64_t> slots(4 * (t.S > 0 ? t.S : 1));
  for (int b = 0; b < t.B; ++b) {
    for (auto& w : slots) w = 0xA5A5A5A5DEADBEEFULL ^ (uint64_t)b;
    mk::run_candidate(t, staged, mk::SlotFile<1>{slots.data()}, b);
  }
  return 0;
}

// The frontier segment: run_segment (frontier_segment.cuh), the kernel's
// loop itself, with an executor that owns every lane.  Each phase runs for
// every lane before the next (the barrier), lanes are grouped into warps of
// 32 and blocks of 128 as on the card, the warp counts go to the same
// double-buffered words (cnt) as the grid launch's, the grant list is staged
// in tiles, and the child copies run as units over the warps with the
// lanes of each unit one after another.
struct HostExec {
  const mk::SegArgs& s;
  int nblocks, nwarps;
  std::vector<mk::Lane> lanes;
  std::vector<mk::I2> tile;

  explicit HostExec(const mk::SegArgs& a)
      : s(a), nblocks((a.B + mk::kBlock - 1) / mk::kBlock), nwarps(nblocks * mk::kWarpsPerBlock),
        lanes(nblocks * mk::kBlock), tile(mk::kTile) {
    for (size_t i = 0; i < lanes.size(); ++i) lanes[i].b = (int32_t)i;
  }

  void begin() {
    for (auto& l : lanes) mk::lane_begin(s, l);
  }
  void step(int32_t arena_len, const mk::Window& w) {
    for (auto& l : lanes) mk::step(s, l, arena_len, w);
  }
  void keys() {
    for (auto& l : lanes)
      if (l.fwant) put_key(l.fwant_rank, mk::fork_key(s, l));
  }
  void parent() {
    for (auto& l : lanes) mk::fork_parent(s, l);
  }
  const mk::Lane& lane0() const { return lanes[0]; }
  void sync() {}

  void publish(int par) {
    for (int w = 0; w < nwarps; ++w) {
      uint32_t ml = 0, mf = 0, mw = 0;
      for (int i = 0; i < mk::kWarp; ++i) {
        const mk::Lane& l = lanes[w * mk::kWarp + i];
        ml |= (uint32_t)l.run << i, mf |= (uint32_t)l.free << i, mw |= (uint32_t)l.fwant << i;
      }
      for (int i = 0; i < mk::kWarp; ++i) mk::warp_ranks(lanes[w * mk::kWarp + i], i, ml, mf, mw);
      s.cnt[par * nwarps + w] = mk::pack_counts(ml, mf, mw);
    }
  }

  void counts(int par) {
    const int32_t* c = s.cnt + par * nwarps;
    auto blk = [&](int i) { return mk::I4{c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]}; };
    for (int block = 0; block < nblocks; ++block) {
      const mk::Tally t = mk::tally(blk, nblocks, block);
      for (int i = block * mk::kBlock; i < (block + 1) * mk::kBlock; ++i)
        mk::lane_counts(lanes[i], t, blk(block), (i / mk::kWarp) % mk::kWarpsPerBlock);
    }
  }

  void put_key(int32_t r, mk::I2 e) { s.fkeys[2 * r] = e.x, s.fkeys[2 * r + 1] = e.y; }

  void grant() {
    const int32_t n = lanes[0].n_fwant;
    std::vector<int32_t> lt(lanes.size()), wb(lanes.size());
    for (int32_t base = 0; base < n; base += mk::kTile) {
      const int32_t m = n - base < mk::kTile ? n - base : mk::kTile;
      for (int32_t i = 0; i < m; ++i) tile[i] = mk::I2{s.fkeys[2 * (base + i)], s.fkeys[2 * (base + i) + 1]};
      for (auto& l : lanes)
        if (l.fwant && l.want) mk::grant_count(tile.data(), m, l, lt[l.b], wb[l.b]);
    }
    for (auto& l : lanes)
      if (l.fwant && l.want) mk::grant_take(s, l, lt[l.b], wb[l.b]);
  }

  void child_items(int32_t n) {
    mk::RowMap map;
    mk::row_map(s, map);
    const int32_t per = mk::child_units(map);
    std::vector<mk::I4> rec(2 * mk::kRecTile);
    for (int32_t g0 = 0; g0 < n; g0 += mk::kRecTile) {
      const int32_t m = n - g0 < mk::kRecTile ? n - g0 : mk::kRecTile;
      for (int32_t i = 0; i < 2 * m; ++i) rec[i] = mk::ld_cg4(s.grants + (int64_t)mk::GRANT_W * g0 + 4 * i);
      for (int w = 0; w < nwarps; ++w)
        for (int32_t it = w; it < m * per; it += nwarps)
          for (int lane = 0; lane < mk::kWarp; ++lane)
            mk::child_unit(s, map, rec.data() + 2 * (it / per), it % per, lane);
    }
  }

  void finish(int32_t arena_len, int32_t n_exec, int32_t max_live) {
    s.out[0] = arena_len, s.out[1] = n_exec, s.out[2] = max_live;
  }
};

extern "C" int mk_frontier_segment_host(const mk::SegArgs* args) {
  HostExec x(*args);
  mk::run_segment(x, *args);
  return 0;
}

// The DPLL search with each thread of a block of nt as a ucontext coroutine
// of the caller's thread: each runs run_query, the kernel's own per-thread
// program, up to its next barrier; once every thread has arrived, the last
// thread first, they go on to the next.  A phase that read what another
// thread writes in the same phase would see the value before the write, so
// a missing barrier shows.  A vote ORs each thread's flags into its warp's
// sum; at the barrier the sums go to the warps' vote words, and after it
// each thread ORs the words, as the card's lanes do.  At the step's second
// barrier the vote words, read and not yet written again, are poisoned,
// and the query's state starts poisoned, as shared memory starts with
// whatever the last block left.  The threads must arrive at the same
// barrier and leave the loop in the same round, as a block must.
struct DpllFibers {
  const mk::dpll::DpllArgs& a;
  int nt;
  std::vector<ucontext_t> fiber;
  std::vector<char> stacks;
  ucontext_t main;
  // this query's
  int32_t q = 0;
  mk::dpll::Query s{};
  int starting = 0;   // the thread a new fiber runs
  std::vector<int> done;
  std::vector<int> kind;  // the barrier each thread waits at: 1 sync, 2 vote
  std::vector<uint32_t*> dead;
  std::vector<uint32_t> warp_or;  // this round's vote, per warp
  uint32_t* votes = nullptr;      // where this round's vote goes
  bool bad_slot = false;
};

static thread_local DpllFibers* dpll_fibers;
static constexpr size_t kFiberStack = 64 * 1024;

struct HostThread {
  int tid, nt;
  DpllFibers* h;

  void arrive(int k, uint32_t* dead) {
    h->kind[tid] = k;
    h->dead[tid] = dead;
    swapcontext(&h->fiber[tid], &h->main);
  }
  void sync(uint32_t* dead) { arrive(1, dead); }
  uint32_t vote(uint32_t mine, uint32_t* votes) {
    h->warp_or[tid / 32] |= mine;
    h->votes = votes;
    arrive(2, nullptr);
    uint32_t f = 0;
    for (int w = 0; w < (nt + 31) / 32; ++w) f |= votes[w];
    return f;
  }
  // a slot outside the clause table (a counter read before it was set)
  // fails the query instead of writing past the state
  int32_t claim(bool keep, int32_t* n) {
    if (!keep) return -1;
    const int32_t slot = (*n)++;
    if (slot < 0 || slot >= h->a.C) h->bad_slot = true;
    return slot < 0 || slot >= h->a.C ? 0 : slot;
  }
};

static void dpll_fiber() {
  DpllFibers* h = dpll_fibers;
  const int tid = h->starting;
  HostThread x{tid, h->nt, h};
  mk::dpll::run_query(x, h->a, h->q, h->s);
  h->done[tid] = 1;
  swapcontext(&h->fiber[tid], &h->main);  // never resumed
}

// The DPLL search, query after query, as blocks of nt threads.  Returns 0,
// -1 when the threads of a block part ways at a barrier, -2 when a clause
// was given a slot outside the table.
extern "C" int mk_dpll_host(const mk::dpll::DpllArgs* args, int nt) {
  const mk::dpll::DpllArgs& a = *args;
  std::vector<char> mem(mk::dpll::state_bytes(a.C, a.V));
  DpllFibers h{a, nt};
  h.fiber.resize(nt);
  h.stacks.resize((size_t)nt * kFiberStack);
  h.done.resize(nt);
  h.kind.resize(nt);
  h.dead.resize(nt);
  h.warp_or.resize((nt + 31) / 32);
  dpll_fibers = &h;
  int rc = 0;
  for (int32_t q = 0; q < a.Q && rc == 0; ++q) {
    memset(mem.data(), 0xA5, mem.size());
    h.q = q;
    h.s = mk::dpll::at(mem.data(), a.C, a.V);
    for (int t = 0; t < nt; ++t) {
      getcontext(&h.fiber[t]);
      h.fiber[t].uc_stack.ss_sp = h.stacks.data() + (size_t)t * kFiberStack;
      h.fiber[t].uc_stack.ss_size = kFiberStack;
      h.fiber[t].uc_link = nullptr;
      makecontext(&h.fiber[t], dpll_fiber, 0);
      h.done[t] = 0;
    }
    while (rc == 0) {
      for (auto& w : h.warp_or) w = 0;
      for (int t = nt - 1; t >= 0; --t) {
        h.starting = t;
        if (!h.done[t]) swapcontext(&h.main, &h.fiber[t]);
      }
      int finished = 0;
      for (int t = 0; t < nt; ++t) finished += h.done[t];
      if (finished == nt) break;
      bool same = finished == 0;
      for (int t = 1; t < nt && same; ++t)
        same = h.kind[t] == h.kind[0] && h.dead[t] == h.dead[0];
      if (!same) {
        rc = -1;  // the fibers left behind are abandoned with their stacks
        break;
      }
      if (h.kind[0] == 2)
        for (size_t w = 0; w < h.warp_or.size(); ++w) h.votes[w] = h.warp_or[w];
      if (h.dead[0])
        for (int w = 0; w < mk::dpll::kWarps; ++w) h.dead[0][w] = 0xA5A5A5A5u;
    }
    if (h.bad_slot) rc = -2;
  }
  dpll_fibers = nullptr;
  return rc;
}

// The warp executors on the host: N lanes as a loop, each primitive
// between two phases a function over the N entries (lowering.cuh's warp,
// N = 32; known_bits.cuh's half-warp, N = 16).
template <class T, int N>
struct HostLanes {
  T v[N];
  T operator[](int l) const { return v[l]; }
};

template <int N = 32>
struct HostLaneLoop {
  template <class F>
  auto each(F f) const {
    HostLanes<decltype(f(0)), N> o;
    for (int l = 0; l < N; ++l) o.v[l] = f(l);
    return o;
  }
  template <class F>
  void run(F f) const {
    for (int l = 0; l < N; ++l) f(l);
  }
  uint32_t ballot(const HostLanes<bool, N>& p) const {
    uint32_t m = 0;
    for (int l = 0; l < N; ++l) m |= (uint32_t)p.v[l] << l;
    return m;
  }
  template <class T, class F>
  HostLanes<T, N> shfl(const HostLanes<T, N>& x, F src) const {
    HostLanes<T, N> o;
    for (int l = 0; l < N; ++l) o.v[l] = x.v[src(l)];
    return o;
  }
  template <class T>
  T at(const HostLanes<T, N>& x, int src) const {
    return x.v[src];
  }
  // the warp's keccak_f1600_lane is held to mk::keccak_f1600 by
  // test_host_keccak_matches_reference; here the state's 25 lanes go through
  // the one-thread permutation
  HostLanes<uint64_t, N> permute(const HostLanes<uint64_t, N>& a) const {
    uint64_t s[25];
    for (int l = 0; l < 25; ++l) s[l] = a.v[l];
    mk::keccak_f1600(s);
    HostLanes<uint64_t, N> o = a;
    for (int l = 0; l < 25; ++l) o.v[l] = s[l];
    return o;
  }
};

// The lowering, candidate after candidate (a block each on the card): the
// staging, every level's records by one warp in turn (the records of a level
// are independent, so their order does not matter), the truth.  On the
// shared-memory route the candidate's values live in a host array that
// starts poisoned, as shared memory starts with whatever the last block left.
extern "C" int mk_lowering_host(const mk::low::LowerArgs* args) {
  const mk::low::LowerArgs& a = *args;
  std::vector<int32_t> smem(a.in_smem ? a.smem_words : 1);
  for (long long b = 0; b < a.B; ++b) {
    for (auto& x : smem) x = (int32_t)(0xA5A5A5A5u ^ (uint32_t)b);
    const mk::low::Cand cand = mk::low::stage(a, smem.data(), b, 0, 1);
    mk::low::run_levels(HostLaneLoop<32>{}, [] {}, a, cand, smem.data(), b, 0, 1);
    mk::low::finish(a, cand.c, b, 0, 1);
  }
  return 0;
}

// The known-bits pass, row after row (a block each on the card): the
// staging, every level's nodes by the block's kGroups half-warps, the last
// group first, so that a node reading a node of its own level would read a
// value not yet written; the write-out.  On the shared-memory route the
// row's block of shared memory is a host array that starts poisoned, as
// shared memory starts with whatever the last block left.
template <bool kSmem>
static void known_bits_rows(const mk::kb::KbArgs& a) {
  std::vector<int32_t> smem(a.smem_words);
  for (int32_t r = 0; r < a.R; ++r) {
    for (auto& x : smem) x = (int32_t)(0xA5A5A5A5u ^ (uint32_t)r);
    mk::kb::stage<kSmem>(a, smem.data(), 0, 1);
    const mk::kb::Row row = mk::kb::row_of<kSmem>(a, smem.data(), r);
    const int32_t* lv = smem.data() + (long long)a.N * mk::kb::KREC;
    bool refuted = false;
    for (int32_t l = 0; l < a.n_levels; ++l)
      for (int g = mk::kb::kGroups - 1; g >= 0; --g)
        refuted = mk::kb::level(HostLaneLoop<16>{}, a, row, smem.data(), lv[l], lv[l + 1], r, g,
                                mk::kb::kGroups) || refuted;
    mk::kb::finish<kSmem>(a, row, r, 0, 1);
    a.refuted[r] = refuted;
  }
}

extern "C" int mk_known_bits_host(const mk::kb::KbArgs* args) {
  if (args->N <= 0 || args->R <= 0) return 0;
  if (args->in_smem)
    known_bits_rows<true>(*args);
  else
    known_bits_rows<false>(*args);
  return 0;
}

// known_bits.cuh's cross-limb steps on two 512-bit values x and y (16
// limbs each), for tests against plain integers: out[0:16] x + y,
// [16:32] x - y, [32:48] x << s, [48:64] x >> s, then x all ones, x not
// zero, the bit length of x, x < y, x == y and bit pos of x.
extern "C" void mk_kb_steps_host(const uint32_t* x, const uint32_t* y, uint32_t s, int32_t pos,
                                 uint32_t* out) {
  const HostLaneLoop<16> w;
  const auto a = w.each([&](int l) { return x[l]; });
  const auto b = w.each([&](int l) { return y[l]; });
  const auto nb = w.each([&](int l) -> uint32_t { return ~y[l]; });
  const auto parts = {mk::kb::add_lanes(w, a, b, 0u), mk::kb::add_lanes(w, a, nb, 1u),
                      mk::kb::shl_lanes(w, a, s), mk::kb::lshr_lanes(w, a, s)};
  int at = 0;
  for (const auto& p : parts)
    for (int l = 0; l < 16; ++l) out[at++] = p[l];
  bool lt, eq;
  mk::kb::ult_eq(w, a, b, lt, eq);
  out[at++] = mk::kb::all_ones(w, a);
  out[at++] = mk::kb::any_set(w, a);
  out[at++] = (uint32_t)mk::kb::bit_length(w, a);
  out[at++] = lt;
  out[at++] = eq;
  out[at++] = mk::kb::bit_at(w, a, pos);
}
