// K2: probed-leaf top-k — for each query tile, scores q·bᵀ against only the
// leaf slabs the tile probes, with f32 accumulation, and keeps each query's
// running top-k without writing the score matrix.
//
// Replaces the TPU kernel hbird_tpu/ops/ivf.py::_ivf_kernel (launched by
// pallas_ivf_knn) on bf16 or f32 inputs, k <= 128. Its int8 and row_scale
// forms are not ported here.
//
// The IVF bank is leaf-contiguous: slab s holds rows [s·cap, (s+1)·cap), of
// which the first leaf_valid[s] are real. Queries come in tiles of block_q
// rows (a multiple of 64); tile t probes the n_probe slabs
// leaf_ids[t, :]. The TPU kernel picks the probed slab per grid step with a
// scalar-prefetched index map and carries the top-k across the sequential
// probe axis; here one CTA (256 threads) owns BQ = 64 queries of one tile,
// reads that tile's leaf_ids row itself and loops over the probed slabs'
// 128-row tiles. Tiles at or past a slab's leaf_valid are never visited,
// columns past it in the last tile score -inf, and slabs with no valid row
// (or an id outside [0, n_slabs)) contribute nothing.
//
// What bounds it on an H100: bytes, at the engine's shapes. A 256-query
// tile reads n_probe·cap rows of D bf16 and does 2·256 flops per element,
// 256 flops per byte, under the ~295 at which the card stops being memory
// bound; four 64-query CTAs read the same slabs, mostly from L2. The score
// tile is K1's (topk_common.cuh): bf16 through mma.sync m16n8k16 fed by a
// two-stage cp.async ring whose prefetch runs across slab boundaries, f32 on
// exact FMAs. Returned ids are IVF slot ids, sorted by value descending,
// then slot ascending; unfilled slots are (-inf, 0).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "topk_common.cuh"

namespace {

// Walks the 128-row tiles of a query tile's probed slabs in probe order.
// Every thread of the CTA walks the same way, so the walk is CTA-uniform.
struct SlabWalk {
  const int* lids;    // the tile's n_probe slab ids
  const int* lvalid;  // real rows per slab
  int n_probe, n_slabs, cap;
  int p;      // current probe (n_probe when done)
  int m0;     // first row of the current tile within its slab
  int valid;  // real rows of the current slab
  int base;   // first row of the current slab in the bank

  // Move to the first tile of the first non-empty slab at or after probe `from`.
  __device__ __forceinline__ void seek(int from) {
    m0 = 0;
    for (p = from; p < n_probe; ++p) {
      const int s = lids[p];
      if (s < 0 || s >= n_slabs) continue;
      valid = min(max(lvalid[s], 0), cap);
      if (valid > 0) {
        base = s * cap;
        return;
      }
    }
  }
  __device__ __forceinline__ bool done() const { return p >= n_probe; }
  __device__ __forceinline__ void next() {
    m0 += BM;
    if (m0 >= valid) seek(p + 1);
  }
  __device__ __forceinline__ int row0() const { return base + m0; }     // tile's first bank row
  __device__ __forceinline__ int row_end() const { return base + valid; }  // slab's end
  __device__ __forceinline__ int n_cols() const { return valid - m0; }  // valid columns
};

__device__ __forceinline__ SlabWalk start_walk(const int* leaf_ids, const int* leaf_valid,
                                               int n_slabs, int cap, int block_q,
                                               int n_probe) {
  const int tile = blockIdx.x * BQ / block_q;
  SlabWalk w{leaf_ids + static_cast<size_t>(tile) * n_probe, leaf_valid, n_probe, n_slabs, cap};
  w.seek(0);
  return w;
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    ivf_topk_f32(const float* __restrict__ q, const float* __restrict__ bank,
                 const int* __restrict__ leaf_ids, const int* __restrict__ leaf_valid,
                 float* __restrict__ out_vals, long long* __restrict__ out_idx, int nq,
                 int n_slabs, int cap, int d, int block_q, int n_probe, int k) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;  // [BQ][LDS], aliases the staging buffers

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;

  TopK<S> top;
  top.init();
  for (SlabWalk w = start_walk(leaf_ids, leaf_valid, n_slabs, cap, block_q, n_probe);
       !w.done(); w.next()) {
    float acc[TM][TN];
    fma_score_tile(q, bank, q0, nq, w.row0(), w.row_end(), d, smem, acc);
    __syncthreads();  // all reads of the staged chunks are done before st overwrites them
    store_fma_tile(st, acc, w.n_cols());
    __syncthreads();
    top.merge_tile(st, q0, nq, w.row0(), warp, lane);
  }
  top.emit(out_vals, out_idx, q0, nq, k, warp, lane);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    ivf_topk_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ bank,
                  const int* __restrict__ leaf_ids, const int* __restrict__ leaf_valid,
                  float* __restrict__ out_vals, long long* __restrict__ out_idx, int nq,
                  int n_slabs, int cap, int d, int block_q, int n_probe, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][STAGE]
  float* st = reinterpret_cast<float*>(smem_raw + 2 * STAGE * sizeof(__nv_bfloat16));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32;  // warp's first query row in the tile
  const int wn = (warp & 3) * 32;   // warp's first bank row in the tile
  const int q0 = blockIdx.x * BQ;
  const int n_chunks = (d + MK - 1) / MK;

  TopK<S> top;
  top.init();
  // `cur` is the tile being scored, `pre` the tile whose chunk `pc` is
  // loaded next; the ring holds two chunks, so `pre` runs one chunk ahead.
  SlabWalk cur = start_walk(leaf_ids, leaf_valid, n_slabs, cap, block_q, n_probe);
  SlabWalk pre = cur;
  int pc = 0;
  if (!pre.done()) {
    load_chunk(q, bank, stages, q0, nq, pre.row0(), pre.row_end(), d, 0);
    if (++pc == n_chunks) {
      pc = 0;
      pre.next();
    }
  }

  float acc[2][4][4];
  int c = 0;  // chunk of `cur` scored in this step
  for (int s = 0; !cur.done(); ++s) {
    if (!pre.done()) {  // prefetch the next chunk into the other stage
      load_chunk(q, bank, stages + ((s + 1) & 1) * STAGE, q0, nq, pre.row0(), pre.row_end(),
                 d, pc * MK);
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
    mma_chunk(acc, stages + (s & 1) * STAGE, wm, wn, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled

    if (++c == n_chunks) {
      store_mma_tile(st, acc, wm, wn, lane, cur.n_cols());
      __syncthreads();
      top.merge_tile(st, q0, nq, cur.row0(), warp, lane);
      c = 0;
      cur.next();
    }
  }
  top.emit(out_vals, out_idx, q0, nq, k, warp, lane);
}

template <typename Kernel, typename T>
cudaError_t launch_one(Kernel kernel, size_t smem, const void* q, const void* bank,
                       const void* leaf_ids, const void* leaf_valid, void* out_vals,
                       void* out_idx, int nq, int n_slabs, int cap, int d, int block_q,
                       int n_probe, int k, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nq / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(bank), static_cast<const int*>(leaf_ids),
      static_cast<const int*>(leaf_valid), static_cast<float*>(out_vals),
      static_cast<long long*>(out_idx), nq, n_slabs, cap, d, block_q, n_probe, k);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const void* q, const void* bank, const void* leaf_ids,
                   const void* leaf_valid, void* out_vals, void* out_idx, int nq, int n_slabs,
                   int cap, int d, int block_q, int n_probe, int k, int is_bf16,
                   cudaStream_t stream) {
  if (is_bf16)
    return launch_one<decltype(&ivf_topk_bf16<S>), __nv_bfloat16>(
        ivf_topk_bf16<S>, MMA_SMEM, q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq,
        n_slabs, cap, d, block_q, n_probe, k, stream);
  return launch_one<decltype(&ivf_topk_f32<S>), float>(
      ivf_topk_f32<S>, FMA_SMEM, q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs,
      cap, d, block_q, n_probe, k, stream);
}

}  // namespace

// Launch K2 on `stream`. q (nq, d) and bank (n_slabs·cap, d) are row-major,
// both f32 (is_bf16 = 0) or both bf16 (is_bf16 = 1); d is a multiple of 8
// and both pointers are 16-byte aligned. leaf_ids (nq / block_q, n_probe)
// and leaf_valid (n_slabs,) are int32. block_q is a multiple of 64 that
// divides nq. Writes out_vals (nq, k) f32 and out_idx (nq, k) int64 IVF slot
// ids. 1 <= k <= 128, n_probe >= 0, n_slabs·cap < 2^31.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ivf_topk_launch(const void* q, const void* bank, const void* leaf_ids,
                               const void* leaf_valid, void* out_vals, void* out_idx, int nq,
                               int n_slabs, int cap, int d, int block_q, int n_probe, int k,
                               int is_bf16, void* stream) {
  if (nq < 1 || k < 1 || k > 128 || d % 8 != 0 || n_slabs < 1 || cap < 1 || n_probe < 0 ||
      block_q < BQ || block_q % BQ != 0 || nq % block_q != 0 ||
      static_cast<long long>(n_slabs) * cap > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((k + 31) / 32) {
    case 1: e = launch<1>(q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, is_bf16, s); break;
    case 2: e = launch<2>(q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, is_bf16, s); break;
    case 3: e = launch<3>(q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, is_bf16, s); break;
    default: e = launch<4>(q, bank, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, is_bf16, s); break;
  }
  return static_cast<int>(e);
}
