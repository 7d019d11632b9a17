// The Hopper score-and-select tile of K1 (knn_topk.cu) and K2 (ivf_topk.cu):
// one persistent kernel template, topk_wgmma<Form, S, Epi, Items>, that
// scores 64 queries against 128-row bank tiles with wgmma fed by TMA rings
// and keeps each query's running top set with a batched select. Every form
// of K1 and of K2 runs it at every depth and every k.
//
// - Items hand out the work: K1's (bank split, 64-query tile), K2's (probe
//   split, 64-query tile), split-major, so the CTAs in flight read the same
//   bank rows (K1's split, or the slabs K2's 256-query tile probes) and find
//   them in L2. An item's Walk lists its 128-row bank tiles in order: the
//   first row, and the valid columns (K1: up to the split's end; K2: up to
//   the slab's leaf_valid; the rest of the box is loaded but never selected).
// - A CTA is one producer warp (its warpgroup gives registers away with
//   setmaxnreg) and two consumer warpgroups. Consumer w scores the item's
//   tiles w, w + 2, ... from its own ring of up to 4 stages, one 128-byte
//   depth chunk of 128 rows each, which the producer fills by TMA, the two
//   rings in turn.
// - The item's queries, 64 rows of 128-byte chunks, either stay resident
//   (loaded once by TMA for the whole depth) or are streamed (STREAM_Q): each
//   ring stage holds the item's query chunk (8 KB, 128-byte swizzled, at the
//   stage's 1,024-aligned start) beside the bank chunk, so no query stays in
//   shared memory and every depth fits; the query chunk is read again from
//   L2 for every bank tile (half a bf16 tile's bytes again). The launchers
//   keep a form's queries resident where they fit (smem_at > 0) and stream
//   them past that (Streamed<F>): bf16 past D = 1,536, bf16 queries on int8
//   codes past D = 1,152, int8 x int8 past 3,072; F32's never fit and
//   always stream. The chunks' products are the same, in the same order,
//   either way, so both layouts give the same bits.
// - Forms: Bf16 (m64n128k16, f32 accumulators), S8 (int8 codes, m64n128k32
//   s8, s32 accumulators converted once by __int2float_rn), Asym (bf16
//   queries, int8 codes: the ring holds the codes, 64 bytes a row, and the
//   consumer widens each stage exactly (widen_s8x4) into a 128-byte-swizzled
//   bf16 tile of its own before a bf16 wgmma, so the select's layout is the
//   other forms') and F32 (below). The epilogue: none, minus the l2 bias, or
//   times the row scale (Epi), one f32 rounding each. Asym widens chunk
//   c + 1's codes into its other tile while chunk c's products run, with one
//   named barrier a chunk (every warp's widening done before the products).
// - F32, 3xTF32 (tf32.cuh), always streamed (64 queries of f32 take 192 KB
//   at D = 768). K2's f32 slab tiles go the same
//   way: a tile that ends at its slab's leaf_valid is loaded whole and its
//   columns past it never selected; D % 32 != 0 scores TMA's zero fill. The consumer splits the query chunk
//   into big and small A fragments in registers and the bank chunk in place
//   into big, with small into a 128-row tile of its own at the same offsets
//   (so the same swizzle), then issues small·big + big·small + big·big per
//   k8 step (wgmma m64n128k8 tf32, A from registers) into a fresh
//   accumulator; each chunk's 12 products are added to the tile's sum in
//   f32 registers rounding to nearest, since the tensor cores' own sums
//   round toward zero (288 of them at D = 768 would drift by up to ~3e-5 of
//   a score). While a chunk's products run, the consumer splits the next
//   chunk's bank rows into its other small tile. Three stages of 24 KB and
//   two small tiles per consumer fit at any depth.
//
// The select (why it is batched). A consumer warp holds the accumulators of
// 16 queries x 128 bank rows. Keeping the 16 running top-(32·S) sets in
// registers cost 32·S + 32 registers beside 64 accumulators and spilled at
// S >= 2, and merging each accepted key alone cost a warp-wide max and min
// (two chains of five dependent shuffles) per key. Here:
// - Registers hold only each lane's two rows' minimum keys and counts. A
//   score whose key beats its row's minimum (and the minimum published by
//   the query's other partial sets) is appended, compacted over the row's
//   four lanes, to the row's candidate buffer (BUF keys) in the CTA's
//   global scratch `work` (stores do not stall the warp). The count pass
//   compares a score with the floor as a float and an index (no 64-bit key)
//   and keeps each lane's last two keys of a row, so a tile whose keys are
//   sparse (the common case once the sets fill) stores them at once; only a
//   denser tile takes a second pass over the accumulators.
// - When a row holds FLUSH_AT or more buffered keys, or at the item's end,
//   the warp merges them into the row's set, which lies sorted descending
//   in `work` (P = 32·S keys, 128 at S = 3): chunks of 32 keys, each sorted
//   by a bitonic network over the warp, reversed, folded into the set's
//   lowest 32 keys by an elementwise max (the set's top P then form one
//   bitonic sequence) and put in order by a bitonic merge of P. A key then
//   costs a share of ~25 shuffle steps per 32 keys, not two reductions of
//   its own. The new minimum is the set's last key.
// - The keys are the unique 64-bit keys of topk_common.cuh, so the sets are
//   exact under "value descending, then index ascending" in any arrival and
//   merge order. Each consumer leaves its top-(32·S) keys per query as one
//   partial set of `parts`; merge_parts emits the k best.
// - The partial sets of a query share `thr` (zeroed by the caller): a set
//   publishes its minimum (the P-th best key of its rows so far) with
//   atomicMax, and keys below another set's minimum are dropped, since P >=
//   k greater keys exist. The union of the sets still holds the k best.
// tests/test_torch_knn_select.py emulates this order of work in torch.

#pragma once

#include "hopper.cuh"
#include "tf32.cuh"
#include "topk_common.cuh"

namespace wg {

constexpr int BQH = 64;                     // queries per item
constexpr int BMH = 128;                    // bank rows per tile: one consumer warpgroup's N
constexpr int CHUNK_BYTES = 128;            // query depth per chunk: one 128-byte swizzled row
constexpr int Q_CHUNK = BQH * CHUNK_BYTES;  // 8 KB
constexpr int WIDE_TILE = BMH * CHUNK_BYTES;  // 16 KB: a 128-row bf16 chunk
constexpr int MAX_STAGES = 4;               // per consumer ring
constexpr int THREADS = 384;                // producer warpgroup + two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;          // a block's shared memory on an H100
constexpr int BAR_BYTES = 256;
constexpr int ROWS = 16;                    // queries per consumer warp
constexpr int WARPS_PER_CTA = 8;            // consumer warps
constexpr int MERGE_THREADS = 256;          // 8 queries per merge CTA, one warp each
constexpr int FLUSH_AT = 32;                // buffered keys of a row that start a merge
constexpr int BUF = 160;                    // a row's buffer: FLUSH_AT - 1 + one tile's 128, rounded
constexpr int BUF_CHUNKS = BUF / 32;

// The forms: element types (TMA map types, bytes per element), the depth
// DK of one chunk, the bank bytes of a chunk's row, whether the queries are
// streamed in the ring (STREAM_Q) and the wgmma.
struct Bf16 {
  typedef float Acc;
  static constexpr int DK = 64, B_BYTES = 128;
  static constexpr bool WIDEN = false, SPLIT = false, STREAM_Q = false;
  static constexpr CUtensorMapDataType Q_TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType B_TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    hopper::wgmma_m64n128k16_ss(d, a, b, scale_d);
  }
  __device__ __forceinline__ static float score(float v) { return v; }
  __device__ __forceinline__ static float bits(float v) { return v; }
  __device__ __forceinline__ static float unbits(float v) { return v; }
};
struct S8 {
  typedef int Acc;
  static constexpr int DK = 128, B_BYTES = 128;
  static constexpr bool WIDEN = false, SPLIT = false, STREAM_Q = false;
  static constexpr CUtensorMapDataType Q_TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType B_TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    hopper::wgmma_m64n128k32_s8_ss(d, a, b, scale_d);
  }
  __device__ __forceinline__ static float score(int v) { return __int2float_rn(v); }
  __device__ __forceinline__ static int bits(float v) { return __float_as_int(v); }
  __device__ __forceinline__ static float unbits(int v) { return __int_as_float(v); }
};
struct Asym : Bf16 {  // bf16 queries, int8 codes widened in shared memory
  static constexpr int B_BYTES = 64;
  static constexpr bool WIDEN = true;
  static constexpr CUtensorMapDataType B_TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
struct F32 : Bf16 {  // f32 queries and bank, split into TF32 parts by the consumers
  static constexpr int DK = 32;
  static constexpr bool SPLIT = true, STREAM_Q = true;
  static constexpr CUtensorMapDataType Q_TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapDataType B_TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
// Form F with the item's query chunk streamed in each ring stage.
template <class F>
struct Streamed : F {
  static constexpr bool STREAM_Q = true;
};

enum Epi { PLAIN = 0, BIAS = 1, SCALE = 2 };

template <Epi E>
__device__ __forceinline__ float epi(float v, float c) {
  if constexpr (E == BIAS) return __fsub_rn(v, c);
  if constexpr (E == SCALE) return __fmul_rn(v, c);
  return v;
}

// Shared memory: the resident queries (none where STREAM_Q), two rings, the
// consumers' own tiles (two per consumer: Asym's widened codes, F32's small
// parts), barriers.
template <class F>
__host__ __device__ constexpr int own_tiles_bytes() {
  return F::WIDEN || F::SPLIT ? 4 * WIDE_TILE : 0;
}

// One ring stage: a 128-row bank chunk (STREAM_Q: after the item's query
// chunk, so the stage's start keeps the 1,024-byte alignment that the query
// chunk's 128-byte swizzle needs, and so does the bank chunk's).
template <class F>
__host__ __device__ constexpr int stage_bytes() {
  return BMH * F::B_BYTES + (F::STREAM_Q ? Q_CHUNK : 0);
}

template <class F>
constexpr int fixed_smem(int n_chunks) {
  return hopper::SMEM_ALIGN + (F::STREAM_Q ? 0 : n_chunks * Q_CHUNK) + own_tiles_bytes<F>() +
         BAR_BYTES;
}

// Ring stages per consumer for n_chunks depth chunks (0: the queries do not
// fit). A streamed form holds a chunk's stage until its products are done
// and waits for the next one meanwhile, so it needs two.
template <class F>
inline int stages_for(int n_chunks) {
  const int st = (SMEM_LIMIT - fixed_smem<F>(n_chunks)) / (2 * stage_bytes<F>());
  return st < MAX_STAGES ? (st >= (F::STREAM_Q ? 2 : 1) ? st : 0) : MAX_STAGES;
}

template <class F>
inline int smem_bytes(int n_chunks, int stages) {
  return fixed_smem<F>(n_chunks) + 2 * stages * stage_bytes<F>();
}

// Dynamic shared memory of form F's kernel at depth d (0: the queries do not fit).
template <class F>
inline int smem_at(int d) {
  const int n_chunks = (d + F::DK - 1) / F::DK;
  const int stages = stages_for<F>(n_chunks);
  return stages < 1 ? 0 : smem_bytes<F>(n_chunks, stages);
}

// The streamed forms fit at every depth with full rings: 197,888 bytes for
// Streamed<Bf16> (8 KB of queries and 16 KB of bank rows a stage), for
// Streamed<Asym> (8 KB and 8 KB of codes a stage, four widened tiles) and
// for Streamed<S8> (8 KB and 16 KB a stage).
static_assert(fixed_smem<Streamed<Bf16>>(0) + 2 * MAX_STAGES * stage_bytes<Streamed<Bf16>>() <=
                  SMEM_LIMIT, "");
static_assert(fixed_smem<Streamed<S8>>(0) + 2 * MAX_STAGES * stage_bytes<Streamed<S8>>() <=
                  SMEM_LIMIT, "");
static_assert(fixed_smem<Streamed<Asym>>(0) + 2 * MAX_STAGES * stage_bytes<Streamed<Asym>>() <=
                  SMEM_LIMIT, "");

// Shared memory of form F at depth d with its queries resident where they
// fit, else of Streamed<F>: the kernel the launchers run.
template <class F>
inline int smem_fit(int d) {
  const int resident = smem_at<F>(d);
  return resident > 0 ? resident : smem_at<Streamed<F>>(d);
}

// ---------------------------------------------------------------------------
// The batched select.
// ---------------------------------------------------------------------------

template <int S>
struct SetSize {
  static constexpr int COLS = S == 3 ? 4 : S;  // keys a lane: the bitonic merge wants 2^n
  static constexpr int P = 32 * COLS;
  static constexpr int WARP_KEYS = ROWS * (P + BUF);  // scratch keys of a consumer warp
};

// Scratch keys of one CTA at k (the wrapper allocates grid x this).
inline int work_keys(int k) {
  const int s = (k + 31) / 32;
  const int p = 32 * (s == 3 ? 4 : s);
  return WARPS_PER_CTA * ROWS * (p + BUF);
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// Compare-exchange with the lane j away: keep the larger key or the smaller.
__device__ __forceinline__ u64 cx(u64 v, int j, bool keep_max) {
  const u64 o = __shfl_xor_sync(FULL, v, j);
  return keep_max ? umax(v, o) : umin(v, o);
}

// One key a lane, sorted descending over the warp (bitonic sort).
__device__ __forceinline__ u64 sort32_desc(u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1)
      v = cx(v, j, ((lane & j) == 0) == ((lane & size) == 0 || size == 32));
  return v;
}

// A bitonic sequence of 32·COLS keys (key s·32 + lane in t[s]) sorted
// descending.
template <int COLS>
__device__ __forceinline__ void merge_desc(u64 (&t)[COLS], int lane) {
#pragma unroll
  for (int js = COLS / 2; js > 0; js >>= 1)
#pragma unroll
    for (int s = 0; s < COLS; ++s)
      if ((s & js) == 0) {
        const u64 a = t[s], b = t[s + js];
        t[s] = umax(a, b);
        t[s + js] = umin(a, b);
      }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1)
#pragma unroll
    for (int s = 0; s < COLS; ++s) t[s] = cx(t[s], j, (lane & j) == 0);
}

// Merge 32 keys `x` (one a lane, any order, 0 for none) into the sorted set
// t: the set keeps its top 32·COLS of the union, sorted descending. The
// reversed sorted chunk against the set's last 32 keys, elementwise max,
// gives the top 32 of those 64; with the set's other keys (each above all 32
// of its last) they are the union's top and a bitonic sequence.
template <int COLS>
__device__ __forceinline__ void merge_chunk(u64 (&t)[COLS], u64 x, int lane) {
  x = sort32_desc(x, lane);
  x = __shfl_sync(FULL, x, 31 - lane);
  t[COLS - 1] = umax(t[COLS - 1], x);
  merge_desc<COLS>(t, lane);
}

// The running sets of one consumer warp's 16 queries. A lane holds the
// minimum key and the buffered count of rows g = lane / 4 and g + 8 (the
// rows of its accumulators; the four lanes of a row agree).
template <int S>
struct Select {
  static constexpr int COLS = SetSize<S>::COLS, P = SetSize<S>::P;
  u64* top;  // [ROWS][P] sorted descending
  u64* buf;  // [ROWS][BUF]
  u64 t_lo, t_hi;
  int n_lo, n_hi;

  // The warp's scratch: its sets, then its buffers.
  __device__ __forceinline__ void bind(u64* warp_work) {
    top = warp_work;
    buf = warp_work + ROWS * P;
  }

  // At the item's end: merge every buffered key.
  __device__ __forceinline__ void finish(u64 pub, u64* thr_out, int n_rows, int lane) {
    flush_rows(1, pub, thr_out, n_rows, lane);
  }

  __device__ __forceinline__ void init(int lane) {
    const u64 empty = make_key(neg_inf(), 0);
#pragma unroll 4
    for (int i = lane; i < ROWS * P; i += 32) top[i] = empty;
    t_lo = t_hi = empty;
    n_lo = n_hi = 0;
    __syncwarp();
  }

  // Merge row r's n buffered keys above `floor` into its set; returns the
  // set's new minimum.
  __device__ __forceinline__ u64 flush(int r, int n, u64 floor, int lane) {
    u64* tr = top + r * P;
    const u64* br = buf + r * BUF;
    u64 t[COLS], c[BUF_CHUNKS];
#pragma unroll
    for (int s = 0; s < COLS; ++s) t[s] = tr[32 * s + lane];
#pragma unroll
    for (int j = 0; j < BUF_CHUNKS; ++j) c[j] = 32 * j + lane < n ? br[32 * j + lane] : 0;
#pragma unroll
    for (int j = 0; j < BUF_CHUNKS; ++j) {
      if (32 * j >= n) break;  // warp-uniform
      const u64 lo = umax(__shfl_sync(FULL, t[COLS - 1], 31), floor);
      const u64 x = c[j] > lo ? c[j] : 0;
      if (__any_sync(FULL, x != 0)) merge_chunk<COLS>(t, x, lane);
    }
#pragma unroll
    for (int s = 0; s < COLS; ++s) tr[32 * s + lane] = t[s];
    return __shfl_sync(FULL, t[COLS - 1], 31);
  }

  // Lanes of row r take its new minimum `m` (and, when `reset`, an empty
  // buffer); lane 0 publishes m where it is above the shared minimum.
  __device__ __forceinline__ void set_min(int r, u64 m, bool reset, u64 pub_r, u64* thr_out,
                                          int n_rows, int lane) {
    if ((lane >> 2) == (r & 7)) {
      if (r < 8) {
        t_lo = m;
        if (reset) n_lo = 0;
      } else {
        t_hi = m;
        if (reset) n_hi = 0;
      }
    }
    if (lane == 0 && r < n_rows && m > pub_r) atomicMax(thr_out + r, m);
  }

  // Merge every row whose buffer holds at least `at` keys; publish a row's
  // new minimum above the shared one (lane r's `pub`) at thr_out[r].
  __device__ __forceinline__ void flush_rows(int at, u64 pub, u64* thr_out, int n_rows, int lane) {
    const unsigned lo = __ballot_sync(FULL, (lane & 3) == 0 && n_lo >= at);
    const unsigned hi = __ballot_sync(FULL, (lane & 3) == 0 && n_hi >= at);
    if ((lo | hi) == 0) return;
    __syncwarp();  // the buffers' stores are visible to the whole warp
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int q = 4 * (r & 7);
      if ((((r < 8 ? lo : hi) >> q) & 1u) == 0) continue;  // warp-uniform
      const int n = __shfl_sync(FULL, r < 8 ? n_lo : n_hi, q);
      const u64 pub_r = __shfl_sync(FULL, pub, r);
      set_min(r, flush(r, n, pub_r, lane), true, pub_r, thr_out, n_rows, lane);
    }
    __syncwarp();  // every lane's reads of the buffers precede the next tile's stores
  }

  // Write each row's top-(32·S) keys as partial set `part` of `parts`.
  __device__ __forceinline__ void emit_part(u64* parts, int q_row, int nq, int n_parts, int part,
                                           int lane) {
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < ROWS && q_row + r < nq; ++r) {
      u64* dst = parts + (static_cast<size_t>(q_row + r) * n_parts + part) * (32 * S);
#pragma unroll
      for (int s = 0; s < S; ++s) dst[32 * s + lane] = top[r * P + 32 * s + lane];
    }
  }
};

// One finished tile (accumulators `acc`, bank rows col0.., the first n_cols
// of them valid) into the warp's sets. A lane holds rows g = lane/4 and g + 8
// of the warp's 16, columns 8j + 2·(lane%4) + {0, 1} (accumulator 4j + {0,
// 1} and 4j + {2, 3}); cv[2j + e] holds its columns' epilogue values. Each
// score goes through the conversion and the epilogue; a key above its row's
// floor (the larger of the set's minimum and `pub`, lane r's copy of the
// minimum published for row r) is buffered; full buffers are merged.
template <class F, int S, Epi E>
__device__ __forceinline__ void select_tile(Select<S>& sel, typename F::Acc (&acc)[64], int col0,
                                            int n_cols, const float (&cv)[32], u64 pub,
                                            u64* thr_out, int n_rows, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const u64 f_lo = umax(sel.t_lo, __shfl_sync(FULL, pub, g));
  const u64 f_hi = umax(sel.t_hi, __shfl_sync(FULL, pub, g + 8));
  // key(v, c) > f as a float and an index compare: v above f's value, or
  // equal to it (+0 == -0, as make_key folds them) at a lower column.
  const float fv_lo = ord2f(static_cast<unsigned>(f_lo >> 32));
  const float fv_hi = ord2f(static_cast<unsigned>(f_hi >> 32));
  const unsigned fc_lo = ~static_cast<unsigned>(f_lo), fc_hi = ~static_cast<unsigned>(f_hi);
  int c_lo = 0, c_hi = 0;
  // The lane's last two keys of each row, as (score, column).
  float lv_lo = 0.0f, pv_lo = 0.0f, lv_hi = 0.0f, pv_hi = 0.0f;
  int lc_lo = 0, pc_lo = 0, lc_hi = 0, pc_hi = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t4 + e;
      float lo = neg_inf(), hi = neg_inf();
      if (c < n_cols) {
        const float c_e = E == PLAIN ? 0.0f : cv[2 * j + e];
        lo = epi<E>(F::score(acc[4 * j + e]), c_e);
        hi = epi<E>(F::score(acc[4 * j + 2 + e]), c_e);
        const int col = col0 + c;
        if (lo > fv_lo || (lo == fv_lo && static_cast<unsigned>(col) < fc_lo)) {
          ++c_lo;
          pv_lo = lv_lo;
          pc_lo = lc_lo;
          lv_lo = lo;
          lc_lo = col;
        }
        if (hi > fv_hi || (hi == fv_hi && static_cast<unsigned>(col) < fc_hi)) {
          ++c_hi;
          pv_hi = lv_hi;
          pc_hi = lc_hi;
          lv_hi = hi;
          lc_hi = col;
        }
      }
      acc[4 * j + e] = F::bits(lo);
      acc[4 * j + 2 + e] = F::bits(hi);
    }
  if (!__any_sync(FULL, (c_lo | c_hi) != 0)) return;  // the common case once the sets fill
  // Each lane's place in its rows' buffers: an exclusive prefix over the four lanes.
  int x_lo = c_lo, x_hi = c_hi;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const int a = __shfl_up_sync(FULL, x_lo, o, 4), b = __shfl_up_sync(FULL, x_hi, o, 4);
    if (t4 >= o) {
      x_lo += a;
      x_hi += b;
    }
  }
  int at_lo = sel.n_lo + x_lo - c_lo, at_hi = sel.n_hi + x_hi - c_hi;
  sel.n_lo += __shfl_sync(FULL, x_lo, 3, 4);
  sel.n_hi += __shfl_sync(FULL, x_hi, 3, 4);
  u64* b_lo = sel.buf + g * BUF;
  u64* b_hi = sel.buf + (g + 8) * BUF;
  if (!__any_sync(FULL, c_lo > 2 || c_hi > 2)) {
    // Sparse keys, the common case once the sets fill: the count pass kept
    // them (order within a buffer does not matter).
    if (c_lo > 0) b_lo[at_lo] = make_key(lv_lo, lc_lo);
    if (c_lo > 1) b_lo[at_lo + 1] = make_key(pv_lo, pc_lo);
    if (c_hi > 0) b_hi[at_hi] = make_key(lv_hi, lc_hi);
    if (c_hi > 1) b_hi[at_hi + 1] = make_key(pv_hi, pc_hi);
  } else if (c_lo | c_hi) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        if (c < n_cols) {
          const u64 k_lo = make_key(F::unbits(acc[4 * j + e]), col0 + c);
          const u64 k_hi = make_key(F::unbits(acc[4 * j + 2 + e]), col0 + c);
          if (k_lo > f_lo) b_lo[at_lo++] = k_lo;
          if (k_hi > f_hi) b_hi[at_hi++] = k_hi;
        }
      }
  }
  sel.flush_rows(FLUSH_AT, pub, thr_out, n_rows, lane);
}

// Four int8 codes (one 32-bit word) widened to two bf16 pairs, exactly:
// 0x4B0000uu is the f32 2^23 + uu, and uu = code + 128.
__device__ __forceinline__ void widen_s8x4(unsigned r, unsigned& lo, unsigned& hi) {
  const unsigned u = r ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) - 8388736.0f;
  __nv_bfloat162 l = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 h = __floats2bfloat162_rn(f[2], f[3]);
  lo = *reinterpret_cast<unsigned*>(&l);
  hi = *reinterpret_cast<unsigned*>(&h);
}

// Widen one ring stage of int8 codes (128 rows x 64 bytes, row-major) into
// a bf16 tile (128 rows x 128 bytes, 128-byte swizzle: 16-byte unit u of row
// r at unit u ^ (r % 8)); thread tid of the consumer warpgroup takes row tid.
__device__ __forceinline__ void widen_tile(const unsigned char* src, unsigned char* dst, int tid) {
  const uint4* s = reinterpret_cast<const uint4*>(src + tid * 64);
  unsigned char* d = dst + tid * CHUNK_BYTES;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = s[j];
    uint4 a, b;
    widen_s8x4(v.x, a.x, a.y);
    widen_s8x4(v.y, a.z, a.w);
    widen_s8x4(v.z, b.x, b.y);
    widen_s8x4(v.w, b.z, b.w);
    *reinterpret_cast<uint4*>(d + (((2 * j) ^ (tid & 7)) * 16)) = a;
    *reinterpret_cast<uint4*>(d + (((2 * j + 1) ^ (tid & 7)) * 16)) = b;
  }
}

// Split one ring stage's 128-row chunk of f32 bank rows (128-byte swizzled)
// in place into its TF32 big parts, and its small parts into `small` at the
// same offsets; thread tid of the consumer warpgroup takes 16-byte units
// tid, tid + 128, ...
__device__ __forceinline__ void split_tile(unsigned char* tile, unsigned char* small, int tid) {
#pragma unroll
  for (int j = 0; j < WIDE_TILE / (16 * 128); ++j) {
    uint4* t = reinterpret_cast<uint4*>(tile) + tid + 128 * j;
    const uint4 v = *t;
    uint4 b, s;
    tf32::split(__uint_as_float(v.x), b.x, s.x);
    tf32::split(__uint_as_float(v.y), b.y, s.y);
    tf32::split(__uint_as_float(v.z), b.z, s.z);
    tf32::split(__uint_as_float(v.w), b.w, s.w);
    *t = b;
    reinterpret_cast<uint4*>(small)[tid + 128 * j] = s;
  }
}

// Consumer warp `warp`'s A fragments of one f32 query chunk (64 rows x 32,
// 128-byte swizzled: 16-byte unit u of row r at unit u ^ (r % 8)), split
// into TF32 big and small parts: k-step kk's a0 (row g, depth 8kk + t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows.
__device__ __forceinline__ void split_a(const unsigned char* qc, int warp, int lane,
                                        uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
  const int g = lane >> 2;
  const unsigned char* r0 = qc + (warp * 16 + g) * CHUNK_BYTES + 4 * (lane & 3);
  const unsigned char* r1 = r0 + 8 * CHUNK_BYTES;  // row g + 8: the same swizzle
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int u0 = ((2 * kk) ^ g) * 16, u1 = ((2 * kk + 1) ^ g) * 16;
    tf32::split(*reinterpret_cast<const float*>(r0 + u0), big[kk][0], small[kk][0]);
    tf32::split(*reinterpret_cast<const float*>(r1 + u0), big[kk][1], small[kk][1]);
    tf32::split(*reinterpret_cast<const float*>(r0 + u1), big[kk][2], small[kk][2]);
    tf32::split(*reinterpret_cast<const float*>(r1 + u1), big[kk][3], small[kk][3]);
  }
}

// ---------------------------------------------------------------------------
// The kernel.
// ---------------------------------------------------------------------------

// Items (host and device): n_items(), q_tile(item), split(item), splits,
// and (device) walk(item) with
// done(), next(), row0() (the tile's first bank row, its first key id) and
// n_cols() (its valid columns). `work` holds gridDim.x x work_keys(k) keys.
template <class F, int S, Epi E, class Items>
__global__ void __launch_bounds__(THREADS, 1)
    topk_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ cvec, u64* __restrict__ parts, u64* __restrict__ thr,
               u64* __restrict__ work, const Items items, int nq, int n_chunks, int stages) {
  constexpr int B_STAGE = stage_bytes<F>();
  constexpr int Q_IN_STAGE = F::STREAM_Q ? Q_CHUNK : 0;  // a stage's query chunk, then bank rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::aligned_smem(smem_raw);  // [n_chunks][64 rows][128 B], if resident
  unsigned char* ring = qs + (F::STREAM_Q ? 0 : n_chunks * Q_CHUNK);  // [2][stages][B_STAGE]
  // Asym: [2][2][128 rows][128 B] widened; F32: the same, small parts
  unsigned char* wide = ring + 2 * stages * B_STAGE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(wide + own_tiles_bytes<F>());
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;  // [2][MAX_STAGES]
  uint64_t* empty = full + 2 * MAX_STAGES;
  const int n_items = items.n_items();
  const int n_parts = 2 * items.splits;
  const int wgi = __shfl_sync(FULL, threadIdx.x / 128, 0);  // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 256);
    for (int i = 0; i < 2 * MAX_STAGES; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // Producer: one thread issues every TMA copy; the item's tiles go to the
    // two rings in turn, chunk by chunk, so both consumers move at once.
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tb);
      int st[2] = {0, 0};
      uint32_t ph[2] = {0, 0}, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int q_row0 = items.q_tile(item) * BQH;
        if constexpr (!F::STREAM_Q) {
          hopper::mbar_wait(q_empty, (it & 1) ^ 1);
          hopper::mbar_expect_tx(q_full, n_chunks * Q_CHUNK);
          for (int c = 0; c < n_chunks; ++c)
            hopper::tma_load_2d(qs + c * Q_CHUNK, &tq, q_full, c * F::DK, q_row0);
        }
        for (auto wk = items.walk(item); !wk.done();) {
          int row[2], n = 0;
          for (; n < 2 && !wk.done(); ++n, wk.next()) row[n] = wk.row0();
          for (int c = 0; c < n_chunks; ++c)
            for (int w = 0; w < n; ++w) {
              uint64_t* f = full + w * MAX_STAGES + st[w];
              unsigned char* dst = ring + (w * stages + st[w]) * B_STAGE;
              hopper::mbar_wait(empty + w * MAX_STAGES + st[w], ph[w] ^ 1);
              hopper::mbar_expect_tx(f, B_STAGE);
              if constexpr (F::STREAM_Q) hopper::tma_load_2d(dst, &tq, f, c * F::DK, q_row0);
              hopper::tma_load_2d(dst + Q_IN_STAGE, &tb, f, c * F::DK, row[w]);
              if (++st[w] == stages) {
                st[w] = 0;
                ph[w] ^= 1;
              }
            }
        }
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int w = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    unsigned char* my_ring = ring + w * stages * B_STAGE;
    unsigned char* my_wide = wide + w * 2 * WIDE_TILE;
    uint64_t* my_full = full + w * MAX_STAGES;
    uint64_t* my_empty = empty + w * MAX_STAGES;
    Select<S> sel;
    sel.bind(work + (static_cast<size_t>(blockIdx.x) * WARPS_PER_CTA + 4 * w + warp) *
                        SetSize<S>::WARP_KEYS);
    typename F::Acc acc[64];
    float part[F::SPLIT ? 64 : 1];  // F32: one chunk's products
    int st = 0, wb = 0;
    uint32_t ph = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int q_row = items.q_tile(item) * BQH + warp * ROWS;  // the warp's first query
      if constexpr (!F::STREAM_Q) hopper::mbar_wait(q_full, it & 1);
      sel.init(lane);
      auto wk = items.walk(item);
      if (w == 1 && !wk.done()) wk.next();  // consumer w takes tiles w, w + 2, ...
      bool released = false;
      while (!wk.done()) {
        const int col0 = wk.row0(), n_cols = wk.n_cols();
        int prev = -1;  // the stage whose chunk's products are the last in flight
        if constexpr (F::SPLIT) {
          // Chunk c's products run while the consumer splits chunk c + 1's
          // bank rows into the other small tile; the A fragments wait for
          // the products (they are read from registers).
          unsigned char* stage = my_ring + st * B_STAGE;
          uint32_t ab[4][4], as[4][4];
          hopper::mbar_wait(my_full + st, ph);
          split_a(stage, warp, lane, ab, as);
          // every warp's products of the last tile, the small tiles' last
          // readers, are done (wgmma_wait<0> below)
          hopper::named_sync(1 + w, 128);
          split_tile(stage + Q_IN_STAGE, my_wide + wb * WIDE_TILE, tid);
          for (int c = 0; c < n_chunks; ++c) {
            const unsigned char* bc = stage + Q_IN_STAGE;
            const unsigned char* sc = my_wide + wb * WIDE_TILE;
            hopper::fence_proxy_async();
            hopper::named_sync(1 + w, 128);  // every warp's split of this chunk is done
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t big = hopper::sw128_desc(bc + kk * 32);
              const uint64_t small = hopper::sw128_desc(sc + kk * 32);
              hopper::wgmma_m64n128k8_tf32_rs(part, as[kk], big, kk != 0);
              hopper::wgmma_m64n128k8_tf32_rs(part, ab[kk], small, 1);
              hopper::wgmma_m64n128k8_tf32_rs(part, ab[kk], big, 1);
            }
            hopper::wgmma_commit();
            const int done = st;
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
            wb ^= 1;
            unsigned char* next = my_ring + st * B_STAGE;
            if (c + 1 < n_chunks) {  // the other small tile's last products were chunk c - 1's
              hopper::mbar_wait(my_full + st, ph);
              split_tile(next + Q_IN_STAGE, my_wide + wb * WIDE_TILE, tid);
            }
            hopper::wgmma_wait<0>();
            hopper::fence_regs(part);
            hopper::mbar_arrive(my_empty + done);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = c == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
            if (c + 1 < n_chunks) split_a(next, warp, lane, ab, as);
            stage = next;
          }
        } else if constexpr (F::WIDEN) {
          // Chunk c's products run while the consumer widens chunk c + 1's
          // codes into its other tile, whose last readers, chunk c - 1's
          // products, every warp waited for (wgmma_wait<0>) before chunk c's
          // barrier: one barrier a chunk. Resident queries: a stage is
          // released once widened; streamed: once its products are done.
          hopper::mbar_wait(my_full + st, ph);
          widen_tile(my_ring + st * B_STAGE + Q_IN_STAGE, my_wide + wb * WIDE_TILE, tid);
          if constexpr (!F::STREAM_Q) hopper::mbar_arrive(my_empty + st);  // the codes are read
          for (int c = 0; c < n_chunks; ++c) {
            const unsigned char* qc = F::STREAM_Q ? my_ring + st * B_STAGE : qs + c * Q_CHUNK;
            const unsigned char* bc = my_wide + wb * WIDE_TILE;
            hopper::fence_proxy_async();
            hopper::named_sync(1 + w, 128);  // every warp's widening of this chunk is done
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < CHUNK_BYTES / 32; ++kk)
              F::mma(acc, hopper::sw128_desc(qc + kk * 32), hopper::sw128_desc(bc + kk * 32),
                     (c | kk) != 0);
            hopper::wgmma_commit();
            if constexpr (F::STREAM_Q) prev = st;
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
            wb ^= 1;
            if (c + 1 < n_chunks) {
              hopper::mbar_wait(my_full + st, ph);
              widen_tile(my_ring + st * B_STAGE + Q_IN_STAGE, my_wide + wb * WIDE_TILE, tid);
              if constexpr (!F::STREAM_Q) hopper::mbar_arrive(my_empty + st);
              hopper::wgmma_wait<0>();
              if constexpr (F::STREAM_Q) hopper::mbar_arrive(my_empty + prev);
            }
          }
        } else {
          for (int c = 0; c < n_chunks; ++c) {
            hopper::mbar_wait(my_full + st, ph);
            const unsigned char* stage = my_ring + st * B_STAGE;
            const unsigned char* qc = F::STREAM_Q ? stage : qs + c * Q_CHUNK;
            const unsigned char* bc = stage + Q_IN_STAGE;
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < CHUNK_BYTES / 32; ++kk)
              F::mma(acc, hopper::sw128_desc(qc + kk * 32), hopper::sw128_desc(bc + kk * 32),
                     (c | kk) != 0);
            hopper::wgmma_commit();
            if (stages > 1) {
              hopper::wgmma_wait<1>();  // the previous chunk's products are done with its stage
              if (prev >= 0) hopper::mbar_arrive(my_empty + prev);
              prev = st;
            } else {  // one stage: it is refilled only once this chunk is done
              hopper::wgmma_wait<0>();
              hopper::mbar_arrive(my_empty + st);
            }
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
          }
        }
        // Under the last chunk's products: this tile's epilogue values (l2
        // biases or row scales) and the warp's published minimum keys.
        float cv[32];
        if constexpr (E != PLAIN) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * (lane & 3) + e;
              cv[2 * j + e] = c < n_cols ? __ldg(cvec + col0 + c) : 0.0f;
            }
        }
        const u64 pub = lane < ROWS && q_row + lane < nq ? __ldcg(thr + q_row + lane) : 0;
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (prev >= 0) hopper::mbar_arrive(my_empty + prev);
        wk.next();
        if (!wk.done()) wk.next();
        if (!F::STREAM_Q && wk.done()) {  // this consumer's last tile: the queries are read
          hopper::mbar_arrive(q_empty);
          released = true;
        }
        select_tile<F, S, E>(sel, acc, col0, n_cols, cv, pub, thr + q_row, nq - q_row, lane);
      }
      if (!F::STREAM_Q && !released) hopper::mbar_arrive(q_empty);
      const u64 pub = lane < ROWS && q_row + lane < nq ? __ldcg(thr + q_row + lane) : 0;
      sel.finish(pub, thr + q_row, nq - q_row, lane);
      sel.emit_part(parts, q_row, nq, n_parts, 2 * items.split(item) + w, lane);
    }
  }
}

// The split merge: one warp per query takes the best keys of its n_parts
// partial sets (merge_row, so the tie order is the single-pass one) and
// emits the k best, value descending, then index ascending.
template <int S>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_parts(const u64* __restrict__ parts, int n_parts, float* __restrict__ out_vals,
                long long* __restrict__ out_idx, int nq, int k) {
  const int qi = (blockIdx.x * MERGE_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // warp-uniform
  TopK<S, 1> top;
  top.init();
  const int total = n_parts * 32 * S;
  const u64* src = parts + static_cast<size_t>(qi) * total;
  for (int c0 = 0; c0 < total; c0 += 32 * CAND) {
    u64 ck[CAND];
#pragma unroll
    for (int j = 0; j < CAND; ++j) {
      const int i = c0 + lane + 32 * j;
      ck[j] = i < total ? src[i] : 0;
    }
    merge_row<S>(top.keys[0], top.thr[0], ck, lane);
  }
  top.emit(out_vals, out_idx, qi, nq, k, 0, lane);
}

// Launch form F over `items`: tensor maps of the queries (nq, d) (box one
// chunk x 64 rows, resident or in the ring alike) and the bank (m, d) (one
// chunk x 128 rows; Asym's int8 codes unswizzled, the consumers widen them),
// the persistent kernel on min(work_ctas, items) CTAs, then the merge of the
// 2 · splits partial sets.
template <class F, int S, Epi E, class Items>
int launch(const void* q, const void* bank, const float* cvec, void* out_vals, void* out_idx,
           void* parts, void* thr, void* work, int work_ctas, int nq, int m, int d, int k,
           const Items& items, cudaStream_t stream) {
  const int n_chunks = (d + F::DK - 1) / F::DK;
  const int stages = stages_for<F>(n_chunks);
  if (stages < 1 || parts == nullptr || thr == nullptr || work == nullptr || work_ctas < 1 ||
      (E == PLAIN) != (cvec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tb;
  const uint64_t q_stride[1] = {static_cast<uint64_t>(d) * (CHUNK_BYTES / F::DK)};
  const uint64_t q_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(nq)};
  const uint32_t q_box[2] = {F::DK, BQH};
  int r = hopper::encode_tensor_map(&tq, 2, q, q_dims, q_stride, q_box, F::Q_TMA);
  if (r != 0) return r;
  // A bank of no rows is never read: its map points at the queries.
  const uint64_t b_stride[1] = {static_cast<uint64_t>(d) * (F::B_BYTES / F::DK)};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(m > 0 ? m : nq)};
  const uint32_t b_box[2] = {F::DK, BMH};
  r = hopper::encode_tensor_map(&tb, 2, m > 0 ? bank : q, m > 0 ? b_dims : q_dims,
                                m > 0 ? b_stride : q_stride, b_box, m > 0 ? F::B_TMA : F::Q_TMA,
                                F::WIDEN && m > 0 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                                  : CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != 0) return r;
  const size_t smem = smem_bytes<F>(n_chunks, stages);
  cudaError_t e = allow_smem(topk_wgmma<F, S, E, Items>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_items = items.n_items();
  const int grid = work_ctas < n_items ? work_ctas : n_items;
  topk_wgmma<F, S, E, Items><<<grid, THREADS, smem, stream>>>(
      tq, tb, cvec, static_cast<u64*>(parts), static_cast<u64*>(thr), static_cast<u64*>(work),
      items, nq, n_chunks, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (nq + MERGE_THREADS / 32 - 1) / (MERGE_THREADS / 32);
  merge_parts<S><<<blocks, MERGE_THREADS, 0, stream>>>(
      static_cast<const u64*>(parts), 2 * items.splits, static_cast<float*>(out_vals),
      static_cast<long long*>(out_idx), nq, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
