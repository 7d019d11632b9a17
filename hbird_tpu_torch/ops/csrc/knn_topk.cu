// K1: fused exact kNN — scores q·bᵀ with f32 accumulation (int32 for int8
// codes) and keeps each query's running top-k without ever writing the Q×M
// score matrix.
//
// Replaces the TPU kernel hbird_tpu/ops/knn_pallas.py::_knn_kernel (launched
// by _pallas_knn_jit, entry pallas_knn), with the default `carry` merge,
// k <= 128, in each of its forms:
// (a) dot product on f32 or bf16 inputs;
// (b) expanded-norm L2 on a float bank: score q·b − ||b||²/2, the bias (one
//     f32 per bank row, computed by the wrapper) subtracted in the epilogue;
// (c) int8 × int8 codes with int32 accumulation, converted once to f32;
// (d) row_scale: each score times its int8 row's f32 scale in the epilogue;
// (e) asymmetric: bf16 queries against int8 codes, widened in registers.
//
// What bounds it on an H100: operations. One call does 2·Q·M·D multiply-adds
// on Q·D + M·D input elements; at the engine's shapes (Q = 21,904, D = 768)
// that is ~1,600 operations per byte in bf16 and ~3,200 in int8, far above
// the ~295 (bf16) and ~590 (int8) at which the card stops being memory bound.
// So the score tile belongs on the tensor cores. f32 inputs keep exact f32
// FMAs (the tensor cores would round them to TF32).
//
// bf16, forms (a) and (b), and int8 codes, forms (c) and (c)+(d)
// (`wg::knn_wgmma<F, S, E>`, built from hopper.cuh; F the element form, S
// keys a lane, E the epilogue):
// - Persistent CTAs, one per SM, walk work items (bank split, 64-query
//   tile), split-major, so the CTAs in flight read the same ~1/splits of the
//   bank and find it in L2. The wrapper picks the fewest splits whose
//   rounds of items keep at least 90% of the SMs busy (ops/knn_cuda.py,
//   plan_splits: 3 at Q = 21,904 on 132 SMs); the splits cover only the
//   valid rows.
// - A CTA is one producer warp (its warpgroup gives registers away with
//   setmaxnreg) and two consumer warpgroups. The item's 64 queries are
//   loaded once by TMA and stay in shared memory for the whole depth;
//   consumer w scores the split's 128-row bank tiles w, w + 2, ... from its
//   own ring of up to 4 stages of 128 rows × one 128-byte depth chunk (16
//   KB: 64 bf16 or 128 int8 values), which the producer fills chunk by
//   chunk by TMA, the two rings in turn. At D = 768 the queries take 96 KB
//   in bf16 and 48 KB in int8, the rings 2 × 4 × 16 KB. Wider bf16 banks get
//   fewer stages (one each at D = 1536, dinov2_vitg14's width); wider still
//   (a converted checkpoint of width 1,664, say) do not leave room for one
//   stage and take mma_scan<FormBf16>, the kernel of the other forms below.
//   int8 codes are at most 1,024 wide (exact scores), so their queries
//   always fit. int8 at k > 96 (S = 4 keys a lane, where the consumers'
//   top sets spill) runs mma_scan instead, chosen in knn_topk_launch by k:
//   at the main path's bank (87,616 rows, the `faiss` int8 + reorder scan's
//   k = 120) it is the faster of the two (PERF.md).
// - Scores: wgmma m64n128k16 (bf16, f32 accumulators) or m64n128k32 s8
//   (int32 accumulators), queries and bank rows both K-major in 128-byte
//   swizzled tiles; either way a chunk is 4 k-steps of 32 bytes.
// - Select in registers: each accumulator goes through the conversion
//   (int32 -> f32 once for int8) and the epilogue (minus the l2 bias, or
//   times the row scale, preloaded per lane under the last chunk's
//   products) and is compared with its query's current minimum key, kept
//   in registers by TopK<S, 16> (topk_common.cuh). Only a query with a
//   score above it is merged (insert_key for a single one, else merge_row
//   after a shuffle into its layout): no score tile in shared memory. While
//   one consumer selects, the other's products run.
// - Each consumer leaves its top-(32·S) keys per query as one partial set
//   of the scratch `parts`; a second kernel, launched from the same entry
//   point, merges a query's 2·splits sets with merge_row and emits the k
//   best: the tie order (value descending, then index ascending) is the
//   single-pass one, because the keys are unique and each partial holds its
//   range's exact top set. int8 scores are the plain version's bit for bit
//   (exact integers, one f32 rounding for the row scale), so are the keys.
// The other forms (f32, and bf16 queries on int8 codes), bf16 wider than
// D = 1536 and int8 at k > 96 keep topk_common.cuh's mma_scan: one CTA (256
// threads) per BQ = 64 queries walking the bank in tiles of BM = 128 rows;
// bf16 queries on int8 codes go through mma.sync m16n8k16 with the codes
// widened in registers, int8 × int8 through m16n8k32 s8, fed by a two-stage
// cp.async ring; an int8 bank tile takes half the ring bytes of a bf16 one.
// Tiles at or past `valid_rows` are never visited: their columns would all
// score -inf. The epilogue and the running top-k merge (ties resolve by
// lowest index, as ops/knn.py::exact_knn does) are shared with K2, in
// topk_common.cuh.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "hopper.cuh"
#include "topk_common.cuh"

namespace {

// The bank's tiles in order, up to valid_rows.
struct BankWalk {
  int m0, valid;
  __device__ __forceinline__ bool done() const { return m0 >= valid; }
  __device__ __forceinline__ void next() { m0 += BM; }
  __device__ __forceinline__ int row0() const { return m0; }
  __device__ __forceinline__ int row_end() const { return valid; }
  __device__ __forceinline__ int n_cols() const { return valid - m0; }
};

template <int S>
__global__ void __launch_bounds__(THREADS)
    knn_topk_f32(const float* __restrict__ q, const float* __restrict__ bank,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out_vals, long long* __restrict__ out_idx, int nq, int m,
                 int d, int valid_rows, int k) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;  // [BQ][LDS], aliases the staging buffers

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;

  TopK<S> top;
  top.init();
  for (BankWalk w{0, valid_rows}; !w.done(); w.next()) {
    float acc[TM][TN];
    fma_score_tile(q, bank, q0, nq, w.row0(), w.row_end(), d, smem, acc);
    __syncthreads();  // all reads of the staged chunks are done before st overwrites them
    store_fma_tile(st, acc, w.n_cols(), w.row0(), scale, bias);
    __syncthreads();
    top.merge_tile(st, q0, nq, w.row0(), warp, lane);
  }
  top.emit(out_vals, out_idx, q0, nq, k, warp, lane);
}

template <class F, int S>
__global__ void __launch_bounds__(THREADS)
    knn_topk_mma(const typename F::TQ* __restrict__ q, const typename F::TB* __restrict__ bank,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out_vals, long long* __restrict__ out_idx, int nq, int m,
                 int d, int valid_rows, int k) {
  const int q0 = blockIdx.x * BQ;
  TopK<S> top;
  top.init();
  mma_scan<F, S>(q, bank, scale, bias, q0, nq, d, BankWalk{0, valid_rows}, top);
  top.emit(out_vals, out_idx, q0, nq, k, threadIdx.x >> 5, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// bf16 dot and l2, int8 and int8_rows: wgmma on TMA-fed rings with a producer
// warp.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQH = 64;                   // queries per item, resident for the whole depth
constexpr int BMH = 128;                  // bank rows per tile: one consumer warpgroup's N
constexpr int CHUNK_BYTES = 128;          // depth per chunk: one 128-byte swizzled row
constexpr int Q_CHUNK = BQH * CHUNK_BYTES;  // 8 KB
constexpr int B_CHUNK = BMH * CHUNK_BYTES;  // 16 KB
constexpr int MAX_STAGES = 4;             // per consumer ring
constexpr int THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;        // a block's shared memory on an H100
constexpr int BAR_BYTES = 256;
constexpr int ROWS = 16;                  // queries per consumer warp
constexpr int MERGE_THREADS = 256;        // 8 queries per merge CTA, one warp each
// int8 at larger k (S = 4 keys a lane) runs mma_scan: at the main path's bank
// it is the faster there (PERF.md).
constexpr int S8_MAX_K = 96;

// The forms of the kernel: the element type (its TMA map type and depth per
// 128-byte chunk), the wgmma that scores one chunk (4 k-steps of 32 bytes
// either way) and the accumulator type with its conversion to a score.
// - Bf16: m64n128k16, f32 accumulators.
// - S8: int8 codes, m64n128k32 s8, s32 accumulators, each converted once to
//   f32 (__int2float_rn, exact below 2^24: D <= 1024); a score turned back
//   into the accumulator's register keeps its f32 bits.
struct Bf16 {
  typedef float Acc;
  static constexpr int DK = 64;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    hopper::wgmma_m64n128k16_ss(d, a, b, scale_d);
  }
  __device__ __forceinline__ static float score(float v) { return v; }
  __device__ __forceinline__ static float bits(float v) { return v; }
  __device__ __forceinline__ static float unbits(float v) { return v; }
};
struct S8 {
  typedef int Acc;
  static constexpr int DK = 128;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    hopper::wgmma_m64n128k32_s8_ss(d, a, b, scale_d);
  }
  __device__ __forceinline__ static float score(int v) { return __int2float_rn(v); }
  __device__ __forceinline__ static int bits(float v) { return __float_as_int(v); }
  __device__ __forceinline__ static float unbits(int v) { return __int_as_float(v); }
};

// The epilogue after the conversion, with one f32 per bank row (the
// wrapper's vector `cvec`): none, minus the l2 bias, or times the row scale
// (topk_common.cuh's epilogue, one rounding each).
enum Epi { PLAIN = 0, BIAS = 1, SCALE = 2 };

template <Epi E>
__device__ __forceinline__ float epi(float v, float c) {
  if constexpr (E == BIAS) return __fsub_rn(v, c);
  if constexpr (E == SCALE) return __fmul_rn(v, c);
  return v;
}

// Ring stages per consumer warpgroup for n_chunks depth chunks of queries
// (0: the queries do not fit).
inline int stages_for(int n_chunks) {
  const int left = SMEM_LIMIT - hopper::SMEM_ALIGN - BAR_BYTES - n_chunks * Q_CHUNK;
  const int st = left / (2 * B_CHUNK);
  return st < MAX_STAGES ? (st > 0 ? st : 0) : MAX_STAGES;
}

// Dynamic shared memory of the kernel: queries, two rings, barriers.
inline int smem_bytes(int n_chunks, int stages) {
  return hopper::SMEM_ALIGN + n_chunks * Q_CHUNK + 2 * stages * B_CHUNK + BAR_BYTES;
}

// Merge one finished tile (accumulators `acc`, bank rows col0..col0+127, of
// which those below row_end are valid) into the warp's 16 running top sets.
// A lane holds rows g = lane/4 and g + 8 of the warp's 16, columns
// 8j + 2·(lane%4) + {0, 1} (accumulator 4j + {0, 1} and 4j + {2, 3}); `cv`
// holds its columns' epilogue values (cv[2j + e]: l2 bias or row scale).
// Each score goes through the conversion and the epilogue and is compared
// with the larger of its row's minimum key and `pub`, lane r's copy of the
// minimum key published for row r by any partial set of the same query (see
// knn_wgmma); only a row with a score above it is merged. A single such
// score replaces the set's minimum (insert_key); more are first
// redistributed by shuffles to 4 per lane, merge_row's layout. A row whose
// minimum key rose publishes it (atomicMax at `thr_out[r]`).
template <class F, int S, Epi E>
__device__ __forceinline__ void merge_acc(TopK<S, ROWS>& top, typename F::Acc (&acc)[64], int col0,
                                          int row_end, const float (&cv)[32], u64 pub,
                                          u64* thr_out, int n_rows, int lane) {
  const int g = lane >> 2;
  u64 t_lo = top.thr[0], t_hi = top.thr[8];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    if (g == r) {
      t_lo = top.thr[r];
      t_hi = top.thr[r + 8];
    }
  const u64 p_lo = __shfl_sync(FULL, pub, g), p_hi = __shfl_sync(FULL, pub, g + 8);
  t_lo = p_lo > t_lo ? p_lo : t_lo;
  t_hi = p_hi > t_hi ? p_hi : t_hi;
  const int n_cols = row_end - col0;
  int n_lo = 0, n_hi = 0;  // candidates of this lane's two rows
  u64 last_lo = 0, last_hi = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * (lane & 3) + e;
      float lo = neg_inf(), hi = neg_inf();
      if (c < n_cols) {
        const float c_e = E == PLAIN ? 0.0f : cv[2 * j + e];
        lo = epi<E>(F::score(acc[4 * j + e]), c_e);
        hi = epi<E>(F::score(acc[4 * j + 2 + e]), c_e);
        const u64 k_lo = make_key(lo, col0 + c), k_hi = make_key(hi, col0 + c);
        if (k_lo > t_lo) {
          ++n_lo;
          last_lo = k_lo;
        }
        if (k_hi > t_hi) {
          ++n_hi;
          last_hi = k_hi;
        }
      }
      acc[4 * j + e] = F::bits(lo);
      acc[4 * j + 2 + e] = F::bits(hi);
    }
  const unsigned b_lo = __ballot_sync(FULL, n_lo > 0), b_hi = __ballot_sync(FULL, n_hi > 0);
  if ((b_lo | b_hi) == 0) return;  // the common case once the sets fill
  const unsigned m_lo = __ballot_sync(FULL, n_lo > 1), m_hi = __ballot_sync(FULL, n_hi > 1);
  const int src_t = (lane & 7) >> 1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned bits = ((r < 8 ? b_lo : b_hi) >> (4 * (r & 7))) & 0xFu;  // warp-uniform
    if (bits == 0) continue;
    const u64 pub_r = __shfl_sync(FULL, pub, r);
    if (__popc(bits) == 1 && (((r < 8 ? m_lo : m_hi) >> (4 * (r & 7))) & 0xFu) == 0) {
      // One candidate, above the set's minimum: it replaces the minimum.
      const u64 g = __shfl_sync(FULL, r < 8 ? last_lo : last_hi, 4 * (r & 7) + __ffs(bits) - 1);
      insert_key<S>(top.keys[r], top.thr[r], g, lane);
    } else {
      // Redistribute the row's 128 scores by shuffles, 4 per lane (column
      // lane + 32j: accumulator group 4j + lane/8, element lane%2), and merge.
      const int src = 4 * (r & 7) + src_t;
      u64 ck[CAND];
#pragma unroll
      for (int j = 0; j < CAND; ++j) {
        float v = neg_inf();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = F::unbits(__shfl_sync(FULL, acc[4 * (4 * j + jj) + 2 * (r >> 3) + e], src));
            if ((lane >> 3) == jj && (lane & 1) == e) v = x;
          }
        const u64 key = make_key(v, col0 + lane + 32 * j);
        ck[j] = key > pub_r ? key : 0;
      }
      merge_row<S>(top.keys[r], top.thr[r], ck, lane);
    }
    if (lane == 0 && r < n_rows && top.thr[r] > pub_r) atomicMax(thr_out + r, top.thr[r]);
  }
}

// One CTA per SM walks work items (split, query tile), split-major so that
// the CTAs in flight read the same bank rows (from L2). Item: the 64 queries
// of tile qt (resident in shared memory for the whole depth, by TMA, once)
// against the valid bank rows of split `split`; consumer warpgroup w scores
// the split's tiles w, w + 2, ... from its own ring, and leaves its running
// top-(32·S) keys per query as part 2·split + w of `parts`
// [nq][2·splits][32·S] (unsorted; knn_merge_parts picks the k best).
// The partial sets of a query share `thr` [nq] (zeroed by the caller): each
// publishes its minimum key there with atomicMax and reads the others' at
// every tile. A key below another set's minimum has 32·S >= k greater keys
// and cannot be among the k best, so a set may drop it: the union of the
// sets still holds the k best, whatever the timing, and far fewer keys are
// inserted than if each set filled on its own.
template <class F, int S, Epi E>
__global__ void __launch_bounds__(THREADS, 1)
    knn_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb,
              const float* __restrict__ cvec, u64* __restrict__ parts, u64* __restrict__ thr,
              int nq, int valid, int n_chunks, int stages, int q_tiles, int split_rows,
              int n_items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::aligned_smem(smem_raw);  // [n_chunks][64 rows][128 B]
  unsigned char* ring = qs + n_chunks * Q_CHUNK;        // [2][stages][128 rows][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 2 * stages * B_CHUNK);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;           // [2][MAX_STAGES]
  uint64_t* empty = full + 2 * MAX_STAGES;
  const int n_parts = 2 * (n_items / q_tiles);
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
    // Producer: one thread issues every TMA copy; the two rings are filled
    // chunk by chunk in turn, so both consumers move at once.
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tb);
      int st[2] = {0, 0};
      uint32_t ph[2] = {0, 0}, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int split = item / q_tiles, qt = item % q_tiles;
        const int r0 = split * split_rows;
        const int r1 = min(valid, r0 + split_rows);
        const int n_tiles = r1 > r0 ? (r1 - r0 + BMH - 1) / BMH : 0;
        hopper::mbar_wait(q_empty, (it & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, n_chunks * Q_CHUNK);
        for (int c = 0; c < n_chunks; ++c)
          hopper::tma_load_2d(qs + c * Q_CHUNK, &tq, q_full, c * F::DK, qt * BQH);
        for (int p = 0; 2 * p < n_tiles; ++p)
          for (int c = 0; c < n_chunks; ++c)
            for (int w = 0; w < 2; ++w) {
              const int tile = 2 * p + w;
              if (tile >= n_tiles) continue;
              uint64_t* f = full + w * MAX_STAGES + st[w];
              hopper::mbar_wait(empty + w * MAX_STAGES + st[w], ph[w] ^ 1);
              hopper::mbar_expect_tx(f, B_CHUNK);
              hopper::tma_load_2d(ring + (w * stages + st[w]) * B_CHUNK, &tb, f, c * F::DK,
                                  r0 + tile * BMH);
              if (++st[w] == stages) {
                st[w] = 0;
                ph[w] ^= 1;
              }
            }
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int w = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned char* my_ring = ring + w * stages * B_CHUNK;
    uint64_t* my_full = full + w * MAX_STAGES;
    uint64_t* my_empty = empty + w * MAX_STAGES;
    TopK<S, ROWS> top;
    typename F::Acc acc[64];
    int st = 0;
    uint32_t ph = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int split = item / q_tiles, qt = item % q_tiles;
      const int r0 = split * split_rows;
      const int r1 = min(valid, r0 + split_rows);
      const int n_tiles = r1 > r0 ? (r1 - r0 + BMH - 1) / BMH : 0;
      const int q_row = qt * BQH + warp * ROWS;  // the warp's first query
      hopper::mbar_wait(q_full, it & 1);
      top.init();
      if (w >= n_tiles) hopper::mbar_arrive(q_empty);
      for (int tile = w; tile < n_tiles; tile += 2) {
        int prev = -1;
        for (int c = 0; c < n_chunks; ++c) {
          hopper::mbar_wait(my_full + st, ph);
          const unsigned char* qc = qs + c * Q_CHUNK;
          const unsigned char* bc = my_ring + st * B_CHUNK;
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
        // Under the last chunk's products: this tile's epilogue values (l2
        // biases or row scales) and the warp's published minimum keys.
        const int col0 = r0 + tile * BMH;
        float cv[32];
        if constexpr (E != PLAIN) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = col0 + 8 * j + 2 * (lane & 3) + e;
              cv[2 * j + e] = c < r1 ? __ldg(cvec + c) : 0.0f;
            }
        }
        const u64 pub = lane < ROWS && q_row + lane < nq ? __ldcg(thr + q_row + lane) : 0;
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (prev >= 0) hopper::mbar_arrive(my_empty + prev);
        if (tile + 2 >= n_tiles) hopper::mbar_arrive(q_empty);  // the queries are read
        merge_acc<F, S, E>(top, acc, col0, r1, cv, pub, thr + q_row, nq - q_row, lane);
      }
      const int part = 2 * split + w;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int qi = q_row + r;
        if (qi >= nq) break;
        u64* dst = parts + (static_cast<size_t>(qi) * n_parts + part) * (32 * S);
#pragma unroll
        for (int s = 0; s < S; ++s) dst[32 * s + lane] = top.keys[r][s];
      }
    }
  }
}

// The split merge: one warp per query takes the best keys of its n_parts
// partial sets (merge_row, so the tie order is the single-pass one) and
// emits the k best, value descending, then index ascending.
template <int S>
__global__ void __launch_bounds__(MERGE_THREADS)
    knn_merge_parts(const u64* __restrict__ parts, int n_parts, float* __restrict__ out_vals,
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

// Dynamic shared memory of form F's kernel at depth d (0: the queries do
// not fit).
template <class F>
inline int smem_at(int d) {
  const int n_chunks = (d + F::DK - 1) / F::DK;
  const int stages = stages_for(n_chunks);
  return stages < 1 ? 0 : smem_bytes(n_chunks, stages);
}

// Launch form F: tensor maps of the queries (box one chunk × 64 rows) and
// the bank (one chunk × 128 rows), the persistent kernel, then the merge.
template <class F, int S, Epi E>
int launch(const void* q, const void* bank, const float* cvec, void* out_vals, void* out_idx,
           void* parts, void* thr, int nq, int m, int d, int valid_rows, int k, int split_rows,
           cudaStream_t stream) {
  const int n_chunks = (d + F::DK - 1) / F::DK;
  const int stages = stages_for(n_chunks);
  if (stages < 1 || split_rows < BMH || split_rows % BMH != 0 || parts == nullptr ||
      thr == nullptr || (E == PLAIN) != (cvec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tb;
  const int elem = CHUNK_BYTES / F::DK;  // bytes per element
  const uint64_t stride[1] = {static_cast<uint64_t>(d) * elem};
  const uint64_t q_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(nq)};
  const uint32_t q_box[2] = {F::DK, BQH};
  int r = hopper::encode_tensor_map(&tq, 2, q, q_dims, stride, q_box, F::TMA_TYPE);
  if (r != 0) return r;
  // A bank of no rows is never read: its map points at the queries.
  const uint64_t b_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(m > 0 ? m : nq)};
  const uint32_t b_box[2] = {F::DK, BMH};
  r = hopper::encode_tensor_map(&tb, 2, m > 0 ? bank : q, b_dims, stride, b_box, F::TMA_TYPE);
  if (r != 0) return r;
  const int q_tiles = (nq + BQH - 1) / BQH;
  const int splits = valid_rows > 0 ? (valid_rows + split_rows - 1) / split_rows : 1;
  const int n_items = q_tiles * splits;
  const size_t smem = smem_bytes(n_chunks, stages);
  cudaError_t e = allow_smem(knn_wgmma<F, S, E>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = hopper::sm_count();
  const int grid = sms > 0 && sms < n_items ? sms : n_items;
  knn_wgmma<F, S, E><<<grid, THREADS, smem, stream>>>(
      tq, tb, cvec, static_cast<u64*>(parts), static_cast<u64*>(thr), nq, valid_rows, n_chunks,
      stages, q_tiles, split_rows, n_items);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (nq + MERGE_THREADS / 32 - 1) / (MERGE_THREADS / 32);
  knn_merge_parts<S><<<blocks, MERGE_THREADS, 0, stream>>>(
      static_cast<const u64*>(parts), 2 * splits, static_cast<float*>(out_vals),
      static_cast<long long*>(out_idx), nq, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename TQ, typename TB, typename Kernel>
cudaError_t launch_one(Kernel kernel, size_t smem, const void* q, const void* bank,
                       const float* scale, const float* bias, void* out_vals, void* out_idx,
                       int nq, int m, int d, int valid_rows, int k, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const TQ*>(q), static_cast<const TB*>(bank),
                                          scale, bias, static_cast<float*>(out_vals),
                                          static_cast<long long*>(out_idx), nq, m, d,
                                          valid_rows, k);
  return cudaGetLastError();
}

template <class F, int S>
cudaError_t launch_mma(const void* q, const void* bank, const float* scale, const float* bias,
                       void* out_vals, void* out_idx, int nq, int m, int d, int valid_rows, int k,
                       cudaStream_t stream) {
  return launch_one<typename F::TQ, typename F::TB>(knn_topk_mma<F, S>, Ring<F>::SMEM, q, bank,
                                                    scale, bias, out_vals, out_idx, nq, m, d,
                                                    valid_rows, k, stream);
}

template <int S>
int launch(const void* q, const void* bank, const float* scale, const float* bias,
           void* out_vals, void* out_idx, void* parts, void* thr, int nq, int m, int d,
           int valid_rows, int k, int form, int split_rows, cudaStream_t stream) {
  switch (form) {
    case 0:
      return launch_one<float, float>(knn_topk_f32<S>, FMA_SMEM, q, bank, scale, bias, out_vals,
                                      out_idx, nq, m, d, valid_rows, k, stream);
    case 1:
      if (wg::smem_at<wg::Bf16>(d) == 0)  // the queries do not fit: mma_scan
        return launch_mma<FormBf16, S>(q, bank, scale, bias, out_vals, out_idx, nq, m, d,
                                       valid_rows, k, stream);
      if (bias != nullptr)
        return wg::launch<wg::Bf16, S, wg::BIAS>(q, bank, bias, out_vals, out_idx, parts, thr, nq,
                                                 m, d, valid_rows, k, split_rows, stream);
      return wg::launch<wg::Bf16, S, wg::PLAIN>(q, bank, nullptr, out_vals, out_idx, parts, thr,
                                                nq, m, d, valid_rows, k, split_rows, stream);
    case 2:  // D <= 1024: the queries always fit
      if constexpr (32 * S > wg::S8_MAX_K) {
        return launch_mma<FormS8, S>(q, bank, scale, bias, out_vals, out_idx, nq, m, d,
                                     valid_rows, k, stream);
      } else {
        if (scale != nullptr)
          return wg::launch<wg::S8, S, wg::SCALE>(q, bank, scale, out_vals, out_idx, parts, thr,
                                                  nq, m, d, valid_rows, k, split_rows, stream);
        return wg::launch<wg::S8, S, wg::PLAIN>(q, bank, nullptr, out_vals, out_idx, parts, thr,
                                                nq, m, d, valid_rows, k, split_rows, stream);
      }
    default:
      return launch_mma<FormAsym, S>(q, bank, scale, bias, out_vals, out_idx, nq, m, d,
                                     valid_rows, k, stream);
  }
}

}  // namespace

// Launch K1 on `stream`. q (nq, d) and bank (m, d) are row-major, by `form`:
// 0 both f32, 1 both bf16, 2 both int8, 3 bf16 q and int8 bank; d is a
// multiple of 8 (of 16 with an int8 bank) and both pointers are 16-byte
// aligned. scale (m,) f32 multiplies each score by its row's scale and bias
// (m,) f32 is subtracted from it, each when not null. Writes out_vals
// (nq, k) f32 and out_idx (nq, k) int64. 1 <= k <= 128,
// 0 <= valid_rows <= m, nq >= 1. Forms 1 and 2 split the valid rows into
// ceil(valid_rows / split_rows) splits (split_rows a multiple of 128) and
// need the scratch `parts`, (nq, 2 · splits, 32 · ceil(k / 32)) 64-bit
// keys, and `thr`, nq 64-bit keys set to 0, where
// knn_topk_wgmma_smem(d, form, k) > 0 (the queries fit in shared memory,
// and form 2 at k <= 96); the other calls ignore them. Returns
// cudaGetLastError() after the launch (0 = launched), or 9001 / 9002 when
// the wgmma forms' tensor maps cannot be encoded.
extern "C" int knn_topk_launch(const void* q, const void* bank, const float* scale,
                               const float* bias, void* out_vals, void* out_idx, int nq, int m,
                               int d, int valid_rows, int k, int form, void* parts, void* thr,
                               int split_rows, void* stream) {
  if (nq < 1 || k < 1 || k > 128 || valid_rows < 0 || valid_rows > m || form < 0 || form > 3 ||
      d % (form >= 2 ? 16 : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(q, bank, scale, bias, out_vals, out_idx, parts, thr, nq, m, d, valid_rows, k, form, split_rows, s);
    case 2: return launch<2>(q, bank, scale, bias, out_vals, out_idx, parts, thr, nq, m, d, valid_rows, k, form, split_rows, s);
    case 3: return launch<3>(q, bank, scale, bias, out_vals, out_idx, parts, thr, nq, m, d, valid_rows, k, form, split_rows, s);
    default: return launch<4>(q, bank, scale, bias, out_vals, out_idx, parts, thr, nq, m, d, valid_rows, k, form, split_rows, s);
  }
}

// Dynamic shared memory the wgmma kernel of `form` (1 bf16, 2 int8) asks
// for at depth d and k; 0: that call runs mma_scan, without scratch (bf16
// whose queries do not fit, int8 at k > 96, and the other forms).
extern "C" int knn_topk_wgmma_smem(int d, int form, int k) {
  if (form == 1) return wg::smem_at<wg::Bf16>(d);
  return form == 2 && k <= wg::S8_MAX_K ? wg::smem_at<wg::S8>(d) : 0;
}
