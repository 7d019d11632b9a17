// Device code shared by K1 (knn_topk.cu) and K2 (ivf_topk.cu): the running
// top-k of 64-bit keys, and the mma.sync score tile (bf16 wider than the
// wgmma kernel takes) fed by a two-stage cp.async ring, with the score
// epilogue of the TPU kernels' forms. The
// keys (make_key) are the one definition of the tie order: the wgmma
// kernel of K1 and K2 (wgmma_topk.cuh, built on hopper.cuh) selects the same
// keys with its batched select and merges its partial sets with merge_row.
//
// The mma_scan kernels give one CTA (256 threads) BQ = 64 queries and walk
// bank tiles of BM = 128 rows: K1's bf16 form wider than the wgmma kernel's
// shared memory walks the whole bank, K2's the rows of the leaf slabs a
// query tile probes. A finished 64×128 f32 score tile goes to
// shared memory (columns past the tile's valid rows score -inf) and is merged
// into the queries' running top sets:
// - Each warp owns 8 queries. A query's running top-(32·S) lives in
//   registers, S slots per lane (S = ceil(k / 32)). A candidate is a 64-bit
//   key: the order-preserving bits of its f32 score above the complement of
//   its column, so "larger key" means "higher score, then lower bank index".
//   Keys are unique, so the replace-the-minimum insertion keeps exactly the
//   top set under that order, whatever order candidates arrive in. In
//   particular a candidate that ties the set's minimum value with a lower
//   index has the larger key and goes in: ties (frequent with int8 scores,
//   and arriving out of slot order in K2) never depend on arrival order.
// - A warp vote skips a query's tile when none of its 128 scores beats the
//   query's current minimum key (the TPU kernels' carry-merge predicate).
// - Slots start at (-inf, index 0), the TPU kernels' _init; they stay so
//   when fewer than k rows are valid.
// - At the end each warp extracts its queries' k best keys in order:
//   values descending, then bank index ascending.
// The epilogue turns an accumulator into a score as the TPU kernels do:
// times the row's scale (row_scale, int8 banks), then minus the row's bias
// (l2), each one f32 rounding, before the valid-row mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // queries per CTA
constexpr int BM = 128;    // bank rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;  // 8 queries per warp
constexpr int LDS = BM + 1;                // score tile [BQ][LDS] (f32)
constexpr int CAND = BM / 32;              // tile columns per lane
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

// Running top sets of a warp's ROWS queries (8 in the mma.sync tile, 16 in
// K1's wgmma tile, 1 in its merge of split partials).
template <int S, int ROWS = ROWS_PER_WARP>
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

  // Merge the score tile `st` (bank rows m0..m0+BM) into the warp's queries.
  __device__ __forceinline__ void merge_tile(const float* st, int q0, int nq, int m0,
                                             int warp, int lane) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = warp * ROWS + r;
      if (q0 + row < nq) {  // warp-uniform
        u64 ck[CAND];
#pragma unroll
        for (int j = 0; j < CAND; ++j) {
          const int c = lane + 32 * j;
          ck[j] = make_key(st[row * LDS + c], m0 + c);
        }
        merge_row<S>(keys[r], thr[r], ck, lane);
      }
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

// The score of an accumulator for bank row `row` (see the header): scale,
// then bias, when given; __fmul_rn/__fsub_rn keep the two roundings apart.
__device__ __forceinline__ float epilogue(float v, int row, const float* __restrict__ scale,
                                          const float* __restrict__ bias) {
  if (scale != nullptr) v = __fmul_rn(v, scale[row]);
  if (bias != nullptr) v = __fsub_rn(v, bias[row]);
  return v;
}

// ---------------------------------------------------------------------------
// Tensor-core score tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The form of the tensor-core tile: bf16 × bf16, mma.sync m16n8k16, f32
// accumulators. A depth chunk of DEPTH elements is staged as QBYTES bytes of
// each query row and BBYTES of each bank row, the rows padded by 16 bytes so
// ldmatrix's eight 16-byte rows hit distinct banks. Warps tile the 64×128
// score tile as 2 (queries) × 4 (bank rows), 32×32 each: 2 m16 × 4 n8 mma
// tiles.
struct FormBf16 {
  typedef __nv_bfloat16 TQ;
  typedef __nv_bfloat16 TB;
  typedef float Acc;
  static constexpr int DEPTH = 64, QBYTES = 128, BBYTES = 128;
};

template <class F>
struct Ring {
  static constexpr int LQ = F::QBYTES + 16;  // bytes of a staged query row
  static constexpr int LB = F::BBYTES + 16;  // bytes of a staged bank row
  static constexpr int STAGE = BQ * LQ + BM * LB;  // bytes of one pipeline stage
  static constexpr size_t SMEM = 2 * STAGE + BQ * LDS * sizeof(float);  // ring + score tile
};

// Issue the async copies of one depth chunk: query rows [q0, q0 + BQ) and
// bank rows [m0, m0 + BM), depth [k0, k0 + DEPTH), into one pipeline stage.
// Query rows at or past nq, bank rows at or past m and depths past d are
// zero-filled; d is a multiple of the elements of a 16-byte vector (8 bf16,
// 16 int8), so a vector is wholly in or out.
template <class F>
__device__ __forceinline__ void load_chunk(const typename F::TQ* __restrict__ q,
                                           const typename F::TB* __restrict__ bank,
                                           unsigned char* stage, int q0, int nq, int m0, int m,
                                           int d, int k0) {
  constexpr int QV = F::QBYTES / 16, BV = F::BBYTES / 16;  // vectors per staged row
  constexpr int QE = 16 / sizeof(typename F::TQ), BE = 16 / sizeof(typename F::TB);
  for (int i = threadIdx.x; i < BQ * QV; i += THREADS) {
    const int r = i / QV, v = i % QV;
    const bool ok = q0 + r < nq && k0 + v * QE < d;
    const typename F::TQ* src = ok ? q + static_cast<size_t>(q0 + r) * d + k0 + v * QE : q;
    cp_async16(stage + r * Ring<F>::LQ + v * 16, src, ok ? 16 : 0);
  }
  unsigned char* bs = stage + BQ * Ring<F>::LQ;
  for (int i = threadIdx.x; i < BM * BV; i += THREADS) {
    const int r = i / BV, v = i % BV;
    const bool ok = m0 + r < m && k0 + v * BE < d;
    const typename F::TB* src = ok ? bank + static_cast<size_t>(m0 + r) * d + k0 + v * BE : bank;
    cp_async16(bs + r * Ring<F>::LB + v * 16, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename Acc>
__device__ __forceinline__ void zero_mma_acc(Acc (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Accumulate one staged depth chunk into the warp's 32×32 part of the tile
// (query rows wm.., bank rows wn..).
template <class F>
__device__ __forceinline__ void mma_chunk(typename F::Acc (&acc)[2][4][4],
                                          const unsigned char* stage, int wm, int wn, int lane) {
  constexpr int LQ = Ring<F>::LQ, LB = Ring<F>::LB;
  const unsigned char* qs = stage;
  const unsigned char* bs = stage + BQ * LQ;
#pragma unroll
  for (int kb = 0; kb < F::QBYTES; kb += 32) {  // one k-step per 32 bytes
    unsigned a[2][4];
    unsigned b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // matrices: rows 0-7 | 8-15 of the m16 tile × bytes 0-15 | 16-31
      const int row = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a[i], qs + row * LQ + kb + (lane >> 4) * 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // matrices: (n8 tile 2j, bytes 0-15 | 16-31), (n8 tile 2j+1, ...)
      unsigned r[4];
      const int row = wn + j * 16 + (lane >> 4) * 8 + (lane & 7);
      ldmatrix_x4(r, bs + row * LB + kb + ((lane >> 3) & 1) * 16);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// Write the warp's accumulators to the score tile st[BQ][LDS] through the
// epilogue (the tile's first bank row is row0); columns at or past `n_cols`
// score -inf. Accumulator layout: (row lane/4, cols 2·(lane%4) + {0,1}),
// and row + 8.
template <typename Acc>
__device__ __forceinline__ void store_mma_tile(float* st, const Acc (&acc)[2][4][4], int wm,
                                               int wn, int lane, int n_cols, int row0,
                                               const float* scale, const float* bias) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + (lane >> 2);
      const int col = wn + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = row + (e >> 1) * 8;
        const int cc = col + (e & 1);
        st[rr * LDS + cc] =
            (cc < n_cols) ? epilogue(static_cast<float>(acc[i][j][e]), row0 + cc, scale, bias)
                          : neg_inf();
      }
    }
}

// The tensor-core main loop of one CTA: `Walk` hands out the bank tiles
// (row0() is a tile's first bank row, row_end() the end of the rows it may
// read, n_cols() its valid columns, next() moves on, done() ends), the ring
// prefetches one depth chunk ahead across tile boundaries, and each finished
// tile is merged into `top`.
template <class F, int S, class Walk>
__device__ __forceinline__ void mma_scan(const typename F::TQ* __restrict__ q,
                                         const typename F::TB* __restrict__ bank,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, int q0, int nq, int d,
                                         Walk cur, TopK<S>& top) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* stages = smem_raw;  // [2][STAGE]
  float* st = reinterpret_cast<float*>(smem_raw + 2 * Ring<F>::STAGE);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32;  // warp's first query row in the tile
  const int wn = (warp & 3) * 32;   // warp's first bank row in the tile
  const int n_chunks = (d + F::DEPTH - 1) / F::DEPTH;

  // `cur` is the tile being scored, `pre` the tile whose chunk `pc` is
  // loaded next; the ring holds two chunks, so `pre` runs one chunk ahead.
  Walk pre = cur;
  int pc = 0;
  if (!pre.done()) {
    load_chunk<F>(q, bank, stages, q0, nq, pre.row0(), pre.row_end(), d, 0);
    if (++pc == n_chunks) {
      pc = 0;
      pre.next();
    }
  }
  typename F::Acc acc[2][4][4];
  int c = 0;  // chunk of `cur` scored in this step
  for (int s = 0; !cur.done(); ++s) {
    if (!pre.done()) {  // prefetch the next chunk into the other stage
      load_chunk<F>(q, bank, stages + ((s + 1) & 1) * Ring<F>::STAGE, q0, nq, pre.row0(),
                    pre.row_end(), d, pc * F::DEPTH);
      if (++pc == n_chunks) {
        pc = 0;
        pre.next();
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this stage's copies are visible to every warp

    if (c == 0) zero_mma_acc(acc);
    mma_chunk<F>(acc, stages + (s & 1) * Ring<F>::STAGE, wm, wn, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled

    if (++c == n_chunks) {
      store_mma_tile(st, acc, wm, wn, lane, cur.n_cols(), cur.row0(), scale, bias);
      __syncthreads();
      top.merge_tile(st, q0, nq, cur.row0(), warp, lane);
      c = 0;
      cur.next();
    }
  }
}

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
