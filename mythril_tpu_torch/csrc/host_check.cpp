// Host build of the kernels' per-thread code, for checking the CUDA sources'
// arithmetic without a card: a host C++ compiler builds this file with the
// same headers the kernels use (tests/test_torch_csrc_host.py).  Each entry
// runs the body a CUDA thread runs, once per state or candidate.
#include <stdint.h>

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

extern "C" int mk_tape_vm_segment_host(const mk::TapeArgs* args) {
  const mk::TapeArgs& t = *args;
  const int n = mk::stage_hi(t) - mk::stage_lo(t);
  std::vector<uint64_t> s_mask(4 * (n > 0 ? n : 1));
  std::vector<int32_t> s_code(5 * (n > 0 ? n : 1));
  for (int i = 0; i < n; ++i) mk::stage_step(t, i, s_mask.data(), s_code.data());
  for (int b = 0; b < t.B; ++b) mk::run_candidate(t, s_mask.data(), s_code.data(), b);
  return 0;
}
