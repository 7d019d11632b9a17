// K1: fused exact kNN — scores q·bᵀ with f32 accumulation and keeps each
// query's running top-k without ever writing the Q×M score matrix.
//
// Replaces the TPU kernel hbird_tpu/ops/knn_pallas.py::_knn_kernel (launched
// by _pallas_knn_jit, entry pallas_knn) in its dot-product form, with the
// default `carry` merge, on bf16 or f32 inputs, k <= 128.
//
// What bounds it on an H100: operations. One call does 2·Q·M·D flops on
// Q·D + M·D input bytes; at the engine's shapes (Q = 21,904, D = 768) that
// is ~1,600 flops per byte, far above the ~295 at which the card stops
// being memory bound. So the score tile belongs on the tensor cores:
// bf16 inputs (the engine's bf16 bank) go through mma.sync m16n8k16 with
// f32 accumulation, fed by ldmatrix from a two-stage cp.async ring. f32
// inputs keep exact f32 FMAs (the tensor cores would round them to TF32).
//
// Design: one CTA (256 threads) owns BQ = 64 queries and walks the bank in
// tiles of BM = 128 rows; the grid is ceil(Q / 64) CTAs. Queries are
// independent, so no cross-CTA reduction exists (the TPU kernel's
// sequential "arbitrary" grid axis becomes the loop over bank tiles). Tiles
// at or past `valid_rows` are never visited: their columns would all score
// -inf. The score tiles and the running top-k merge (ties resolve by lowest
// index, as ops/knn.py::exact_knn does) are shared with K2, in
// topk_common.cuh.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "topk_common.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(THREADS)
    knn_topk_f32(const float* __restrict__ q, const float* __restrict__ bank,
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
  const int n_tiles = (valid_rows + BM - 1) / BM;
  for (int t = 0; t < n_tiles; ++t) {
    const int m0 = t * BM;
    float acc[TM][TN];
    fma_score_tile(q, bank, q0, nq, m0, m, d, smem, acc);
    __syncthreads();  // all reads of the staged chunks are done before st overwrites them
    store_fma_tile(st, acc, valid_rows - m0);
    __syncthreads();
    top.merge_tile(st, q0, nq, m0, warp, lane);
  }
  top.emit(out_vals, out_idx, q0, nq, k, warp, lane);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    knn_topk_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ bank,
                  float* __restrict__ out_vals, long long* __restrict__ out_idx, int nq, int m,
                  int d, int valid_rows, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][STAGE]
  float* st = reinterpret_cast<float*>(smem_raw + 2 * STAGE * sizeof(__nv_bfloat16));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 32;  // warp's first query row in the tile
  const int wn = (warp & 3) * 32;   // warp's first bank row in the tile
  const int q0 = blockIdx.x * BQ;

  TopK<S> top;
  top.init();
  const int n_tiles = (valid_rows + BM - 1) / BM;
  const int n_chunks = (d + MK - 1) / MK;
  const int total = n_tiles * n_chunks;
  if (total > 0) load_chunk(q, bank, stages, q0, nq, 0, m, d, 0);

  float acc[2][4][4];
  for (int s = 0; s < total; ++s) {
    const int c = s % n_chunks;
    const int m0 = (s / n_chunks) * BM;
    if (s + 1 < total) {  // prefetch the next chunk into the other stage
      const int c1 = (s + 1) % n_chunks;
      load_chunk(q, bank, stages + ((s + 1) & 1) * STAGE, q0, nq, ((s + 1) / n_chunks) * BM,
                 m, d, c1 * MK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this stage's copies are visible to every warp

    if (c == 0) zero_mma_acc(acc);
    mma_chunk(acc, stages + (s & 1) * STAGE, wm, wn, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled

    if (c == n_chunks - 1) {
      store_mma_tile(st, acc, wm, wn, lane, valid_rows - m0);
      __syncthreads();
      top.merge_tile(st, q0, nq, m0, warp, lane);
    }
  }
  top.emit(out_vals, out_idx, q0, nq, k, warp, lane);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
cudaError_t launch_one(Kernel kernel, size_t smem, const void* q, const void* bank,
                       void* out_vals, void* out_idx, int nq, int m, int d, int valid_rows,
                       int k, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(bank),
                                          static_cast<float*>(out_vals),
                                          static_cast<long long*>(out_idx), nq, m, d,
                                          valid_rows, k);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const void* q, const void* bank, void* out_vals, void* out_idx, int nq,
                   int m, int d, int valid_rows, int k, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_one<decltype(&knn_topk_bf16<S>), __nv_bfloat16>(
        knn_topk_bf16<S>, MMA_SMEM, q, bank, out_vals, out_idx, nq, m, d, valid_rows, k,
        stream);
  return launch_one<decltype(&knn_topk_f32<S>), float>(
      knn_topk_f32<S>, FMA_SMEM, q, bank, out_vals, out_idx, nq, m, d, valid_rows, k, stream);
}

}  // namespace

// Launch K1 on `stream`. q (nq, d) and bank (m, d) are row-major, both f32
// (is_bf16 = 0) or both bf16 (is_bf16 = 1); d is a multiple of 8 and both
// pointers are 16-byte aligned. Writes out_vals (nq, k) f32 and out_idx
// (nq, k) int64. 1 <= k <= 128, 0 <= valid_rows <= m, nq >= 1.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_topk_launch(const void* q, const void* bank, void* out_vals, void* out_idx,
                               int nq, int m, int d, int valid_rows, int k, int is_bf16,
                               void* stream) {
  if (nq < 1 || k < 1 || k > 128 || valid_rows < 0 || valid_rows > m || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((k + 31) / 32) {
    case 1: e = launch<1>(q, bank, out_vals, out_idx, nq, m, d, valid_rows, k, is_bf16, s); break;
    case 2: e = launch<2>(q, bank, out_vals, out_idx, nq, m, d, valid_rows, k, is_bf16, s); break;
    case 3: e = launch<3>(q, bank, out_vals, out_idx, nq, m, d, valid_rows, k, is_bf16, s); break;
    default: e = launch<4>(q, bank, out_vals, out_idx, nq, m, d, valid_rows, k, is_bf16, s); break;
  }
  return static_cast<int>(e);
}
