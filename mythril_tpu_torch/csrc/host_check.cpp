// Host build of the kernels' per-thread code, for checking the CUDA sources'
// arithmetic without a card: a host C++ compiler builds this file with the
// same headers the kernels use (tests/test_torch_csrc_host.py).  Each entry
// runs the body a CUDA thread runs, once per state or candidate.
#include <stdint.h>

#include <barrier>
#include <thread>
#include <vector>

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

// The warp-per-state body, with 25 host threads in the warp's place: an
// exchange publishes each thread's value, waits for all 25, reads its
// source's and waits again, as __shfl_sync does in one instruction.
struct HostExchange {
  std::barrier<>* bar;
  uint64_t* buf;
  int lane;
  uint64_t operator()(uint64_t v, int src) {
    buf[lane] = v;
    bar->arrive_and_wait();
    const uint64_t r = buf[src];
    bar->arrive_and_wait();
    return r;
  }
};

extern "C" void mk_keccak_f1600_warp_host(const int32_t* in, int32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    std::barrier<> bar(25);
    uint64_t buf[25];
    std::vector<std::thread> lanes;
    for (int l = 0; l < 25; ++l)
      lanes.emplace_back([&, l] {
        HostExchange ex{&bar, buf, l};
        const int32_t* s = in + i * 100 + 4 * l;
        const uint64_t a = mk::keccak_f1600_lane(mk::lane_from_limbs(s[0], s[1], s[2], s[3]), l, ex);
        for (int j = 0; j < 4; ++j) out[i * 100 + 4 * l + j] = mk::lane_limb(a, j);
      });
    for (auto& th : lanes) th.join();
  }
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
