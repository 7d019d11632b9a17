// Device code shared by K1 (knn_topk.cu) and K2 (ivf_topk.cu): the running
// top-k of 64-bit keys, the f32 FMA score tile, and the bf16 tensor-core
// score tile fed by a two-stage cp.async ring.
//
// Both kernels give one CTA (256 threads) BQ = 64 queries and walk bank
// tiles of BM = 128 rows; K1 walks the whole bank, K2 only the rows of the
// leaf slabs its query tile probes. A finished 64×128 f32 score tile goes to
// shared memory (columns past the tile's valid rows score -inf) and is merged
// into the queries' running top sets:
// - Each warp owns 8 queries. A query's running top-(32·S) lives in
//   registers, S slots per lane (S = ceil(k / 32)). A candidate is a 64-bit
//   key: the order-preserving bits of its f32 score above the complement of
//   its column, so "larger key" means "higher score, then lower bank index".
//   Keys are unique, so the replace-the-minimum insertion keeps exactly the
//   top set under that order, whatever order candidates arrive in.
// - A warp vote skips a query's tile when none of its 128 scores beats the
//   query's current minimum key (the TPU kernels' carry-merge predicate).
// - Slots start at (-inf, index 0), the TPU kernels' _init; they stay so
//   when fewer than k rows are valid.
// - At the end each warp extracts its queries' k largest keys in order:
//   values descending, then bank index ascending.

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

// f32 FMA path: depth chunks of BK staged transposed as f32.
constexpr int BK = 32;
constexpr int TM = 4;        // micro-tile rows (queries)
constexpr int TN = 8;        // micro-tile cols (bank rows)
constexpr int LDQ = BQ + 4;  // staged query chunk [BK][LDQ]
constexpr int LDB = BM + 4;  // staged bank chunk  [BK][LDB]
static_assert((BQ / TM) * (BM / TN) == THREADS, "micro-tiles must cover the tile");
constexpr size_t FMA_SMEM =
    (BK * LDQ + BK * LDB > BQ * LDS ? BK * LDQ + BK * LDB : BQ * LDS) * sizeof(float);

// bf16 tensor-core path: depth chunks of MK staged row-major as bf16, the
// rows padded by 16 bytes so ldmatrix's eight 16-byte rows hit distinct
// banks. Warps tile the 64×128 score tile as 2 (queries) × 4 (bank rows),
// 32×32 each: 2 m16 × 4 n8 mma tiles.
constexpr int MK = 64;
constexpr int LDK = MK + 8;
constexpr int STAGE = (BQ + BM) * LDK;  // bf16 elements per pipeline stage
constexpr size_t MMA_SMEM = 2 * STAGE * sizeof(__nv_bfloat16) + BQ * LDS * sizeof(float);

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

// Insert a query's tile candidates `ck` (CAND keys per lane) into its
// running top set `keys` (S keys per lane). `thr` is the set's minimum key
// (warp-uniform) and is kept current.
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
    // Evict one slot holding the minimum (keys are unique except the
    // identical initial slots, so any holder will do).
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
}

// Running top sets of a warp's queries.
template <int S>
struct TopK {
  u64 keys[ROWS_PER_WARP][S];
  u64 thr[ROWS_PER_WARP];

  __device__ __forceinline__ void init() {
    const u64 empty = make_key(neg_inf(), 0);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      thr[r] = empty;
#pragma unroll
      for (int s = 0; s < S; ++s) keys[r][s] = empty;
    }
  }

  // Merge the score tile `st` (bank rows m0..m0+BM) into the warp's queries.
  __device__ __forceinline__ void merge_tile(const float* st, int q0, int nq, int m0,
                                             int warp, int lane) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp * ROWS_PER_WARP + r;
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
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qi = q0 + warp * ROWS_PER_WARP + r;
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

// ---------------------------------------------------------------------------
// f32 inputs: FMA score tile.
// ---------------------------------------------------------------------------

// Stage rows [row0, row0 + ROWS) x depth [k0, k0 + BK) of a row-major
// (n_rows, d) f32 matrix into dst[BK][ld], transposed; zeros outside.
// d is a multiple of 4, so a float4 is wholly in or out.
template <int ROWS>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int row0,
                                          int n_rows, int d, int k0, float* dst, int ld) {
  constexpr int PER_ROW = BK / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    const int gr = row0 + r;
    const int gk = k0 + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < n_rows && gk < d) v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(gr) * d + gk);
    dst[(c + 0) * ld + r] = v.x;
    dst[(c + 1) * ld + r] = v.y;
    dst[(c + 2) * ld + r] = v.z;
    dst[(c + 3) * ld + r] = v.w;
  }
}

// Score queries [q0, q0 + BQ) against bank rows [m0, m0 + BM) over the
// whole depth into this thread's TM×TN micro-tile; rows at or past m_lim
// (and queries at or past nq) read as zeros. `smem` holds the staged chunks
// and doubles as the score tile afterwards: the caller syncs before writing it.
__device__ __forceinline__ void fma_score_tile(const float* __restrict__ q,
                                               const float* __restrict__ bank, int q0, int nq,
                                               int m0, int m_lim, int d, float* smem,
                                               float (&acc)[TM][TN]) {
  float* qs = smem;             // [BK][LDQ]
  float* bs = smem + BK * LDQ;  // [BK][LDB]
  const int tx = threadIdx.x % (BM / TN);  // bank-column group
  const int ty = threadIdx.x / (BM / TN);  // query-row group
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();  // earlier readers of the shared buffers are done
    stage_f32<BQ>(q, q0, nq, d, k0, qs, LDQ);
    stage_f32<BM>(bank, m0, m_lim, d, k0, bs, LDB);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[kk * LDQ + ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk * LDB + tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk * LDB + tx * TN + 4]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Write the micro-tiles to the score tile st[BQ][LDS]; columns at or past
// `n_cols` score -inf.
__device__ __forceinline__ void store_fma_tile(float* st, const float (&acc)[TM][TN],
                                               int n_cols) {
  const int tx = threadIdx.x % (BM / TN);
  const int ty = threadIdx.x / (BM / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      st[(ty * TM + i) * LDS + c] = (c < n_cols) ? acc[i][j] : neg_inf();
    }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor-core score tile.
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

// Issue the async copies of one depth chunk: query rows [q0, q0 + BQ) and
// bank rows [m0, m0 + BM), depth [k0, k0 + MK), into one pipeline stage
// (rows of LDK bf16). Query rows at or past nq, bank rows at or past m and
// depths past d are zero-filled; d is a multiple of 8, so a 16-byte vector
// is wholly in or out.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ bank,
                                           __nv_bfloat16* stage, int q0, int nq, int m0, int m,
                                           int d, int k0) {
  constexpr int VECS = MK / 8;  // 16-byte vectors per staged row
  for (int i = threadIdx.x; i < (BQ + BM) * VECS; i += THREADS) {
    const int r = i / VECS;
    const int c = (i % VECS) * 8;
    const bool is_q = r < BQ;
    const int gr = is_q ? q0 + r : m0 + (r - BQ);
    const bool ok = (is_q ? gr < nq : gr < m) && k0 + c < d;
    const __nv_bfloat16* base = is_q ? q : bank;
    const __nv_bfloat16* src = ok ? base + static_cast<size_t>(gr) * d + k0 + c : base;
    cp_async16(stage + r * LDK + c, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void zero_mma_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// Accumulate one staged depth chunk into the warp's 32×32 part of the tile
// (query rows wm.., bank rows wn..).
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const __nv_bfloat16* stage,
                                          int wm, int wn, int lane) {
  const __nv_bfloat16* qs = stage;
  const __nv_bfloat16* bs = stage + BQ * LDK;
#pragma unroll
  for (int kk = 0; kk < MK; kk += 16) {
    unsigned a[2][4];
    unsigned b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // matrices: rows 0-7 | 8-15 of the m16 tile × depth 0-7 | 8-15
      const int row = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a[i], qs + row * LDK + kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // matrices: (n8 tile 2j, depth 0-7 | 8-15), (n8 tile 2j+1, ...)
      unsigned r[4];
      const int row = wn + j * 16 + (lane >> 4) * 8 + (lane & 7);
      ldmatrix_x4(r, bs + row * LDK + kk + ((lane >> 3) & 1) * 8);
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

// Write the warp's accumulators to the score tile st[BQ][LDS]; columns at
// or past `n_cols` score -inf. Accumulator layout: (row lane/4, cols
// 2·(lane%4) + {0,1}), and row + 8.
__device__ __forceinline__ void store_mma_tile(float* st, const float (&acc)[2][4][4], int wm,
                                               int wn, int lane, int n_cols) {
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
        st[rr * LDS + cc] = (cc < n_cols) ? acc[i][j][e] : neg_inf();
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
