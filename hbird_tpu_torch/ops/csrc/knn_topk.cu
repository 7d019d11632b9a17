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
// (e) asymmetric: bf16 queries against int8 codes, widened to bf16.
//
// What bounds it on an H100: operations. One call does 2·Q·M·D multiply-adds
// on Q·D + M·D input elements; at the engine's shapes (Q = 21,904, D = 768)
// that is ~1,600 operations per byte in bf16 and ~3,200 in int8, far above
// the ~295 (bf16) and ~590 (int8) at which the card stops being memory bound.
// So the score tile belongs on the tensor cores. f32 inputs take f32
// accuracy there in three TF32 passes (3xTF32, tf32.cuh): 3 x 2·Q·M·D at
// 495 TFLOP/s is 17.9 ms at Q = 21,904, M = 87,616, against 44.0 ms for
// the FMAs alone at 67 TFLOP/s.
//
// Every form runs wgmma_topk.cuh's persistent kernel (topk_wgmma<F, S, E,
// Flat>: wgmma on TMA rings with a producer warp, and the batched select) at
// every depth and every k, over (bank split, 64-query tile) items,
// split-major, so the CTAs in flight read the same ~1/splits of the bank and
// find it in L2: bf16 (a)/(b) as Bf16, int8 (c)/(c)+(d) as S8, (e)/(e)+(d)
// as Asym (the codes widened in shared memory, as K2 does), f32 (a)/(b) as
// F32 (3xTF32). The wrapper picks the fewest splits whose rounds of items
// keep at least 90% of the SMs busy (ops/knn_cuda.py, plan_splits: 3 at Q =
// 21,904 on 132 SMs); the splits cover only the valid rows. The queries stay
// resident in shared memory where they fit and are streamed in the ring
// beside the bank chunks past that (wg::Streamed): at D =
// 768 they take 96 KB in bf16 and 48 KB in int8, the rings 2 x 4 x 16 KB.
// bf16 queries stay resident up to D = 1,536 (fewer stages as
// they grow: one a consumer at D = 1,536, dinov2_vitg14's width) and stream
// past it (a converted checkpoint of width 1,664, say); Asym keeps two
// widened tiles per consumer beside them, so its queries fit up to D = 1,152
// and stream past it (mae_vith14's 1,280, dinov2_vitg14's 1,536); int8's fit
// up to D = 3,072 and stream past it; F32's always stream. A streamed form
// fits at every depth. int8 scores are the plain version's bit for bit at
// every depth (exact integers, one f32 rounding for the row scale; 127² · D
// stays below 2^31 up to D = 133,143), so are the keys, and the split merge
// keeps the single-pass tie order. The batched select holds no set in
// registers, so every k runs this kernel (PERF.md has the designs measured
// against it). The layout is chosen by shape before the launch
// (knn_topk_wgmma_smem). The keys and the merge of the partial sets (ties
// resolve by lowest index, as ops/knn.py::exact_knn does) are shared with
// K2, in topk_common.cuh.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "topk_common.cuh"
#include "wgmma_topk.cuh"

namespace {

// wgmma_topk.cuh's kernel over (bank split, 64-query tile) items. The
// splits cut the valid rows into ranges of split_rows (a multiple of
// 128); an item walks its range's 128-row tiles.
struct Flat {
  int q_tiles, splits, split_rows, valid;
  struct Walk {
    int m0, end;
    __device__ __forceinline__ bool done() const { return m0 >= end; }
    __device__ __forceinline__ void next() { m0 += wg::BMH; }
    __device__ __forceinline__ int row0() const { return m0; }
    __device__ __forceinline__ int n_cols() const { return end - m0; }
  };
  __host__ __device__ __forceinline__ int n_items() const { return q_tiles * splits; }
  __host__ __device__ __forceinline__ int q_tile(int item) const { return item % q_tiles; }
  __host__ __device__ __forceinline__ int split(int item) const { return item / q_tiles; }
  __device__ __forceinline__ Walk walk(int item) const {
    const int r0 = split(item) * split_rows;
    return Walk{r0, min(valid, r0 + split_rows)};
  }
};

template <class F, int S, wg::Epi E>
int launch_wgmma(const void* q, const void* bank, const float* cvec, void* out_vals, void* out_idx,
                 void* parts, void* thr, void* work, int work_ctas, int nq, int m, int d,
                 int valid_rows, int k, int split_rows, cudaStream_t stream) {
  if (split_rows < wg::BMH || split_rows % wg::BMH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = valid_rows > 0 ? (valid_rows + split_rows - 1) / split_rows : 1;
  const Flat items{(nq + wg::BQH - 1) / wg::BQH, splits, split_rows, valid_rows};
  if (cvec == nullptr)
    return wg::launch<F, S, wg::PLAIN>(q, bank, nullptr, out_vals, out_idx, parts, thr, work,
                                       work_ctas, nq, m, d, k, items, stream);
  return wg::launch<F, S, E>(q, bank, cvec, out_vals, out_idx, parts, thr, work, work_ctas, nq, m,
                             d, k, items, stream);
}

// Form F with the epilogue E (its vector `cvec`, when given: K1's l2
// biases or row scales) and its queries resident where they fit, else
// streamed.
template <class F, int S, wg::Epi E>
int launch_fit(const void* q, const void* bank, const float* cvec, void* out_vals, void* out_idx,
               void* parts, void* thr, void* work, int work_ctas, int nq, int m, int d,
               int valid_rows, int k, int split_rows, cudaStream_t stream) {
  if (wg::smem_at<F>(d) > 0)
    return launch_wgmma<F, S, E>(q, bank, cvec, out_vals, out_idx, parts, thr, work, work_ctas, nq,
                                 m, d, valid_rows, k, split_rows, stream);
  return launch_wgmma<wg::Streamed<F>, S, E>(q, bank, cvec, out_vals, out_idx, parts, thr, work,
                                             work_ctas, nq, m, d, valid_rows, k, split_rows,
                                             stream);
}

template <int S>
int launch(const void* q, const void* bank, const float* scale, const float* bias,
           void* out_vals, void* out_idx, void* parts, void* thr, void* work, int work_ctas,
           int nq, int m, int d, int valid_rows, int k, int form, int split_rows,
           cudaStream_t stream) {
  switch (form) {
    case 0:  // no queries resident: every depth fits
      return launch_wgmma<wg::F32, S, wg::BIAS>(q, bank, bias, out_vals, out_idx, parts, thr, work,
                                                work_ctas, nq, m, d, valid_rows, k, split_rows,
                                                stream);
    case 1:
      return launch_fit<wg::Bf16, S, wg::BIAS>(q, bank, bias, out_vals, out_idx, parts, thr, work,
                                               work_ctas, nq, m, d, valid_rows, k, split_rows,
                                               stream);
    case 2:  // int8 x int8: s32 accumulators, one conversion to f32
      return launch_fit<wg::S8, S, wg::SCALE>(q, bank, scale, out_vals, out_idx, parts, thr, work,
                                              work_ctas, nq, m, d, valid_rows, k, split_rows,
                                              stream);
    default:
      return launch_fit<wg::Asym, S, wg::SCALE>(q, bank, scale, out_vals, out_idx, parts, thr,
                                                work, work_ctas, nq, m, d, valid_rows, k,
                                                split_rows, stream);
  }
}

}  // namespace

// Launch K1 on `stream`. q (nq, d) and bank (m, d) are row-major, by `form`:
// 0 both f32, 1 both bf16, 2 both int8, 3 bf16 q and int8 bank; d is a
// multiple of 8 (of 16 with an int8 bank) and both pointers are 16-byte
// aligned. scale (m,) f32 multiplies each score by its row's scale and bias
// (m,) f32 is subtracted from it, each when not null. Writes out_vals
// (nq, k) f32 and out_idx (nq, k) int64. 1 <= k <= 128,
// 0 <= valid_rows <= m, nq >= 1. Every call runs the wgmma kernel: it
// splits the valid rows into ceil(valid_rows / split_rows) splits
// (split_rows a multiple of 128) and needs the scratch `parts`, (nq, 2 ·
// splits, 32 · ceil(k / 32)) 64-bit keys, `thr`, nq 64-bit keys set to 0,
// and `work`, work_ctas · knn_topk_work_keys(k) 64-bit keys (it runs on at
// most work_ctas CTAs). Returns cudaGetLastError() after the launch (0 =
// launched), or 9001 / 9002 when the tensor maps cannot be encoded.
extern "C" int knn_topk_launch(const void* q, const void* bank, const float* scale,
                               const float* bias, void* out_vals, void* out_idx, int nq, int m,
                               int d, int valid_rows, int k, int form, void* parts, void* thr,
                               void* work, int work_ctas, int split_rows, void* stream) {
  if (nq < 1 || k < 1 || k > 128 || valid_rows < 0 || valid_rows > m || form < 0 || form > 3 ||
      d % (form >= 2 ? 16 : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(q, bank, scale, bias, out_vals, out_idx, parts, thr, work, work_ctas, nq, m, d, valid_rows, k, form, split_rows, s);
    case 2: return launch<2>(q, bank, scale, bias, out_vals, out_idx, parts, thr, work, work_ctas, nq, m, d, valid_rows, k, form, split_rows, s);
    case 3: return launch<3>(q, bank, scale, bias, out_vals, out_idx, parts, thr, work, work_ctas, nq, m, d, valid_rows, k, form, split_rows, s);
    default: return launch<4>(q, bank, scale, bias, out_vals, out_idx, parts, thr, work, work_ctas, nq, m, d, valid_rows, k, form, split_rows, s);
  }
}

// Dynamic shared memory the wgmma kernel of `form` (0 f32, 1 bf16, 2 int8,
// 3 bf16 queries on int8 codes) asks for at depth d (bf16, int8 and asym:
// the resident form's where it fits, else the streamed one's; f32
// always streams); more than 0 for every form at every depth.
extern "C" int knn_topk_wgmma_smem(int d, int form) {
  switch (form) {
    case 0: return wg::smem_at<wg::F32>(d);
    case 1: return wg::smem_fit<wg::Bf16>(d);
    case 2: return wg::smem_fit<wg::S8>(d);
    case 3: return wg::smem_fit<wg::Asym>(d);
    default: return 0;
  }
}

// 64-bit keys of the wgmma kernel's `work` scratch per CTA at k.
extern "C" int knn_topk_work_keys(int k) { return wg::work_keys(k); }
