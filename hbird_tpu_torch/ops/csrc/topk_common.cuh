// Device code shared by K1 (knn_topk.cu) and K2 (ivf_topk.cu): the 64-bit
// keys of the top-k and the running top set of one query that the wgmma
// kernel's split merge (wgmma_topk.cuh, merge_parts) folds the partial sets
// into. The keys (make_key) are the one definition of the tie order: the
// wgmma kernel's batched select keeps the same keys, so every set is exact
// under "value descending, then index ascending" in any arrival and merge
// order.
// - A candidate is a 64-bit key: the order-preserving bits of its f32 score
//   above the complement of its column, so "larger key" means "higher
//   score, then lower bank index". Keys are unique, so the
//   replace-the-minimum insertion keeps exactly the top set under that
//   order, whatever order candidates arrive in. In particular a candidate
//   that ties the set's minimum value with a lower index has the larger key
//   and goes in: ties (frequent with int8 scores, and arriving out of slot
//   order in K2) never depend on arrival order.
// - A query's running top-(32·S) lives in registers, S slots per lane (S =
//   ceil(k / 32)); slots start at (-inf, index 0), the TPU kernels' _init,
//   and stay so when fewer than k rows are valid.
// - At the end each warp extracts its query's k best keys in order: values
//   descending, then bank index ascending.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAND = 4;  // candidate keys per lane in one merge_row step (128 a warp)
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Order-preserving map of f32 bits to u32 (larger float -> larger u32).
__device__ __forceinline__ unsigned f2ord(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord2f(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// (score, column) -> key; -0 and +0 compare equal, as they do in torch.sort.
__device__ __forceinline__ u64 make_key(float v, int col) {
  v += 0.0f;
  return (static_cast<u64>(f2ord(v)) << 32) | static_cast<u64>(~static_cast<unsigned>(col));
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(FULL, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// Put `g`, a key above the set's minimum `thr`, into a query's running top
// set `keys` (S keys per lane) in place of one slot holding the minimum
// (keys are unique except the identical initial slots, so any holder will
// do), and bring `thr` (warp-uniform) up to date.
template <int S>
__device__ __forceinline__ void insert_key(u64 (&keys)[S], u64& thr, u64 g, int lane) {
  bool holds = false;
#pragma unroll
  for (int s = 0; s < S; ++s) holds |= keys[s] == thr;
  const unsigned who = __ballot_sync(FULL, holds);
  if (lane == __ffs(who) - 1) {
    bool done = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!done && keys[s] == thr) {
        keys[s] = g;
        done = true;
      }
    }
  }
  u64 lmin = keys[0];
#pragma unroll
  for (int s = 1; s < S; ++s) lmin = keys[s] < lmin ? keys[s] : lmin;
  thr = warp_min(lmin);
}

// Insert a query's tile candidates `ck` (CAND keys per lane, 0 for none)
// into its running top set, best first: every candidate above the set's
// minimum at its turn goes in.
template <int S>
__device__ __forceinline__ void merge_row(u64 (&keys)[S], u64& thr, u64 (&ck)[CAND],
                                          int lane) {
  while (true) {
    u64 best = 0;  // every real key is > 0
#pragma unroll
    for (int j = 0; j < CAND; ++j) best = (ck[j] > thr && ck[j] > best) ? ck[j] : best;
    if (!__any_sync(FULL, best != 0)) break;
    const u64 g = warp_max(best);
#pragma unroll
    for (int j = 0; j < CAND; ++j) ck[j] = (ck[j] == g) ? 0 : ck[j];
    insert_key<S>(keys, thr, g, lane);
  }
}

// Running top sets of a warp's ROWS queries (wgmma_topk.cuh's merge of the
// partial sets: one a warp).
template <int S, int ROWS>
struct TopK {
  u64 keys[ROWS][S];
  u64 thr[ROWS];

  __device__ __forceinline__ void init() {
    const u64 empty = make_key(neg_inf(), 0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      thr[r] = empty;
#pragma unroll
      for (int s = 0; s < S; ++s) keys[r][s] = empty;
    }
  }

  // Emit each query's k best keys: value descending, then index ascending.
  __device__ __forceinline__ void emit(float* out_vals, long long* out_idx, int q0, int nq,
                                       int k, int warp, int lane) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + warp * ROWS + r;
      if (qi >= nq) continue;  // warp-uniform
      for (int t = 0; t < k; ++t) {
        u64 lmax = keys[r][0];
#pragma unroll
        for (int s = 1; s < S; ++s) lmax = keys[r][s] > lmax ? keys[r][s] : lmax;
        const u64 g = warp_max(lmax);
        const unsigned who = __ballot_sync(FULL, lmax == g);
        if (lane == __ffs(who) - 1) {
          bool done = false;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (!done && keys[r][s] == g) {
              keys[r][s] = 0;
              done = true;
            }
          }
          const size_t o = static_cast<size_t>(qi) * k + t;
          out_vals[o] = ord2f(static_cast<unsigned>(g >> 32));
          out_idx[o] = static_cast<long long>(~static_cast<unsigned>(g & 0xffffffffull));
        }
      }
    }
  }
};

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
