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
// So the score tile belongs on the tensor cores: bf16, int8 and asymmetric
// inputs go through mma.sync (m16n8k16 bf16, m16n8k32 s8) fed by ldmatrix
// from a two-stage cp.async ring; an int8 bank tile takes half the ring bytes
// of a bf16 one. f32 inputs keep exact f32 FMAs (the tensor cores would round
// them to TF32).
//
// Design: one CTA (256 threads) owns BQ = 64 queries and walks the bank in
// tiles of BM = 128 rows; the grid is ceil(Q / 64) CTAs. Queries are
// independent, so no cross-CTA reduction exists (the TPU kernel's
// sequential "arbitrary" grid axis becomes the loop over bank tiles). Tiles
// at or past `valid_rows` are never visited: their columns would all score
// -inf. The score tiles, the epilogue and the running top-k merge (ties
// resolve by lowest index, as ops/knn.py::exact_knn does) are shared with
// K2, in topk_common.cuh.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

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
cudaError_t launch(const void* q, const void* bank, const float* scale, const float* bias,
                   void* out_vals, void* out_idx, int nq, int m, int d, int valid_rows, int k,
                   int form, cudaStream_t stream) {
  switch (form) {
    case 0:
      return launch_one<float, float>(knn_topk_f32<S>, FMA_SMEM, q, bank, scale, bias, out_vals,
                                      out_idx, nq, m, d, valid_rows, k, stream);
    case 1:
      return launch_mma<FormBf16, S>(q, bank, scale, bias, out_vals, out_idx, nq, m, d,
                                     valid_rows, k, stream);
    case 2:
      return launch_mma<FormS8, S>(q, bank, scale, bias, out_vals, out_idx, nq, m, d,
                                   valid_rows, k, stream);
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
// 0 <= valid_rows <= m, nq >= 1. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int knn_topk_launch(const void* q, const void* bank, const float* scale,
                               const float* bias, void* out_vals, void* out_idx, int nq, int m,
                               int d, int valid_rows, int k, int form, void* stream) {
  if (nq < 1 || k < 1 || k > 128 || valid_rows < 0 || valid_rows > m || form < 0 || form > 3 ||
      d % (form >= 2 ? 16 : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((k + 31) / 32) {
    case 1: e = launch<1>(q, bank, scale, bias, out_vals, out_idx, nq, m, d, valid_rows, k, form, s); break;
    case 2: e = launch<2>(q, bank, scale, bias, out_vals, out_idx, nq, m, d, valid_rows, k, form, s); break;
    case 3: e = launch<3>(q, bank, scale, bias, out_vals, out_idx, nq, m, d, valid_rows, k, form, s); break;
    default: e = launch<4>(q, bank, scale, bias, out_vals, out_idx, nq, m, d, valid_rows, k, form, s); break;
  }
  return static_cast<int>(e);
}
