// The known-bits kernel of the solver's prefilter: a block per row walks the
// packed tape level by level, its half-warps taking the level's nodes and
// each half-warp's 16 lanes a node's 16 limbs.
//
// Replaces mythril_tpu/absdomain/device.py _get_jitted -> _run (lax.scan over
// the node records, lax.switch over absdomain/domains.py KB_KERNELS), bit
// for bit with the host twin domains.eval_kb_host; the body is
// known_bits.cuh, which the host check also builds.  The JAX program pads
// nodes to 512 or 4096 and rows to 16 or 64 and chunks rows by 64; the
// results are the same per row, so one launch takes every row of a pack,
// unpadded.
//
// Bound: the function reads the node records (32 B), the width mask and
// constant (128 B) and each override once, and writes km and kv (128 B per
// node and row); its integer work is a few hundred 32-bit operations per
// node and row.  On the recorded traffic (N = 4-556 nodes, R <= 2 rows)
// either is far below a microsecond.  What sets the time is the chain of
// dependent nodes: 37 levels deep at the median pack (39 at most), against
// 277 nodes that one thread per row used to walk one after another.
//
// What the design does about it:
// - a block owns a row: the levels run in order with one __syncthreads()
//   each, the level's nodes spread over the block's 32 half-warps, two
//   nodes a warp;
// - a node's limbs lie across a half-warp's lanes, 32 bits a lane as the
//   [N, R, 16] planes hold them, so a child's value is one 64-byte row and
//   the transfer functions' cross-limb steps are votes and shuffles within
//   the half-warp (known_bits.cuh);
// - the host's level plan (absdomain/device.py level_plan) orders the nodes;
//   the block stages the records in that order, with the widths its
//   children give, and the level offsets in shared memory, and on the
//   shared-memory route also the row's km and kv, a zero row and the width
//   masks (232 B a node: 129 KB at the largest recorded pack; read through
//   the read-only cache instead, the masks cost each level a global read,
//   about 0.13 us, scripts/torch_known_bits_probe.py); a pack past 227 KB
//   keeps the row's values in the output planes themselves, in the same
//   kernel, instantiated for that route (kSmem false);
// - the shared-memory route writes the row's planes out once, at the end,
//   and the overrides' refutations are OR-ed over the block once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "known_bits.cuh"

namespace {

using mk::kb::kThreads;

// A lane value of the card's half-warp: this lane's own.
template <class T>
struct Lane {
  T v;
  __device__ __forceinline__ T operator[](int) const { return v; }
};

// known_bits.cuh's executor on the card: a half-warp, this thread its lane
// `lane`; the other half of the warp may be on another node.
struct Half {
  int lane;       // 0..15
  int base;       // 0 or 16: the half's first lane in the warp
  unsigned mask;  // the half's lanes

  template <class F>
  __device__ __forceinline__ auto each(F f) const {
    return Lane<decltype(f(0))>{f(lane)};
  }
  template <class F>
  __device__ __forceinline__ void run(F f) const {
    f(lane);
  }
  __device__ __forceinline__ uint32_t ballot(const Lane<bool>& p) const {
    return (__ballot_sync(mask, p.v) >> base) & mk::kb::kLanes;
  }
  template <class T, class F>
  __device__ __forceinline__ Lane<T> shfl(const Lane<T>& x, F src) const {
    return {(T)__shfl_sync(mask, x.v, src(lane), 16)};
  }
  template <class T>
  __device__ __forceinline__ T at(const Lane<T>& x, int src) const {
    return (T)__shfl_sync(mask, x.v, src, 16);
  }
};

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) known_bits_kernel(mk::kb::KbArgs a) {
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x;
  const int32_t r = blockIdx.x;
  mk::kb::stage<kSmem>(a, smem, t, kThreads);
  __syncthreads();
  const mk::kb::Row row = mk::kb::row_of<kSmem>(a, smem, r);
  const int32_t* q = smem;
  const int32_t* lv = smem + (long long)a.N * mk::kb::KREC;
  const Half w{t & 15, t & 16, 0xFFFFu << (t & 16)};
  bool refuted = false;
  for (int32_t l = 0; l < a.n_levels; ++l) {
    refuted = mk::kb::level(w, a, row, q, lv[l], lv[l + 1], r, t >> 4, mk::kb::kGroups) || refuted;
    __syncthreads();
  }
  mk::kb::finish<kSmem>(a, row, r, t, kThreads);
  const int any = __syncthreads_or(refuted);
  if (t == 0) a.refuted[r] = (uint8_t)(any != 0);
}

// The largest dynamic shared memory each route's kernel was allowed.
size_t allowed[2] = {48 * 1024, 48 * 1024};

}  // namespace

// Every row of a pack, one block each.  Returns the attribute call's or the
// launch's error.
extern "C" int mk_known_bits(const mk::kb::KbArgs* args, void* stream) {
  if (args->N <= 0 || args->R <= 0) return 0;
  const int route = args->in_smem ? 1 : 0;
  const size_t bytes = (size_t)args->smem_words * sizeof(int32_t);
  void (*kernel)(mk::kb::KbArgs) = route ? known_bits_kernel<true> : known_bits_kernel<false>;
  if (bytes > allowed[route]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed[route] = bytes;
  }
  kernel<<<args->R, kThreads, bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
