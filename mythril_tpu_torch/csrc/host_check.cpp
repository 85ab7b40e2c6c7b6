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

// The known-bits walk, row after row (one thread per row on the card).
extern "C" int mk_known_bits_host(const mk::kb::KbArgs* args) {
  for (int32_t r = 0; r < args->R; ++r) mk::kb::run_row(*args, r);
  return 0;
}

// run_query's executor with every thread of a block of nt: each phase runs
// for thread 0, 1, ... in turn, and the ORs are taken over all of them.
struct HostBlock {
  const mk::dpll::DpllArgs& a;
  const mk::dpll::Query& s;
  int nt;

  void stage(int32_t q) {
    for (int t = 0; t < nt; ++t) mk::dpll::stage(a, q, s, t, nt);
  }
  void sync() {}
  int sweep() {
    int f = 0;
    for (int t = 0; t < nt; ++t) f |= mk::dpll::sweep(s, a.C, t, nt);
    return f;
  }
  bool both() {
    bool any = false;
    for (int t = 0; t < nt; ++t) any = mk::dpll::both_ways(s, a.V, t, nt) || any;
    return any;
  }
  bool apply(bool go) {
    bool any = false;
    for (int t = 0; t < nt; ++t) any = mk::dpll::apply(s, a.V, go, t, nt) || any;
    return any;
  }
  void decide() { mk::dpll::decide(s); }
  void set_sat() { mk::dpll::set_sat(s); }
  void pick_jump() { mk::dpll::pick_jump(s); }
  void flip(int32_t j) { mk::dpll::flip(s, j); }
  void unassign(int32_t j) {
    for (int t = 0; t < nt; ++t) mk::dpll::unassign_above(s, a.V, j, t, nt);
  }
  void store(int32_t q, int32_t steps) {
    for (int t = 0; t < nt; ++t) mk::dpll::store(a, q, s, steps, t, nt);
  }
};

// The DPLL search, query after query, as blocks of nt threads.  A query's
// state starts poisoned, as shared memory starts with whatever the last
// block left: every field must be staged.
extern "C" int mk_dpll_host(const mk::dpll::DpllArgs* args, int nt) {
  std::vector<char> mem(mk::dpll::state_bytes(args->C, args->V));
  for (int32_t q = 0; q < args->Q; ++q) {
    memset(mem.data(), 0xA5, mem.size());
    const mk::dpll::Query s = mk::dpll::at(mem.data(), args->C, args->V);
    HostBlock x{*args, s, nt};
    mk::dpll::run_query(x, *args, q, s);
  }
  return 0;
}

// The lowering's records, candidate after candidate (one thread each on the
// card).
extern "C" int mk_lowering_host(const mk::low::LowerArgs* args) {
  for (long long b = 0; b < args->B; ++b) mk::low::run_candidate(*args, b);
  return 0;
}
