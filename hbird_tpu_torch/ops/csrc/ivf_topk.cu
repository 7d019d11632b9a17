// K2: probed-leaf top-k — for each query tile, scores q·bᵀ against only the
// leaf slabs the tile probes, with f32 accumulation, and keeps each query's
// running top-k without writing the score matrix.
//
// Replaces the TPU kernel hbird_tpu/ops/ivf.py::_ivf_kernel (launched by
// pallas_ivf_knn), k <= 128, in each of its forms: f32 or bf16 slabs; int8
// codes under int8 queries (int32 accumulation, converted once to f32); int8
// codes under bf16 queries (asymmetric: the codes widened to bf16 in shared
// memory); and the row_scale epilogue on int8 slabs, one f32 scale per slot,
// read in the slab layout.
//
// The IVF bank is leaf-contiguous: slab s holds rows [s·cap, (s+1)·cap), of
// which the first leaf_valid[s] are real. Queries come in tiles of block_q
// rows (a multiple of 64); tile t probes the n_probe slabs
// leaf_ids[t, :]. The TPU kernel picks the probed slab per grid step with a
// scalar-prefetched index map and carries the top-k across the sequential
// probe axis. Tiles at or past a slab's leaf_valid are never visited,
// columns past it in the last tile are never selected, and slabs with no
// valid row (or an id outside [0, n_slabs)) contribute nothing.
//
// What bounds it on an H100: bytes, at the engine's shapes. A 256-query
// tile reads n_probe·cap rows of D bf16 and does 2·256 flops per element,
// 256 flops per byte, under the ~295 at which the card stops being memory
// bound; the four 64-query items of a tile read the same slabs, mostly from
// L2. f32 slabs move twice the bytes and take three TF32 passes.
// Every form, f32 (3xTF32: each operand split into TF32 big and small
// parts, tf32.cuh), bf16, int8 (with or without row scales) and bf16
// queries on int8 codes (asym, asym_rows: the reference's ScaNN searcher),
// runs wgmma_topk.cuh's kernel (topk_wgmma<F, S, E, Slabs>), K1's, at every
// depth: persistent CTAs over (probe split, 64-query tile) items, the
// queries resident where they fit and else streamed beside each slab
// chunk (f32 always; bf16 past D = 1,536, int8 past 3,072, asym past
// 1,152: every depth fits), the slab tiles by TMA from one
// 2-D tensor map over the leaf-contiguous bank (a tile is the box at row
// s·cap + m0), two consumer warpgroups on wgmma, the batched select in
// registers and global scratch, the partial sets merged in a second pass.
// asym's codes are widened to bf16 in shared memory by the consumers
// (exact), so its wgmma and select are bf16's.
// Returned ids are IVF slot ids, sorted by value descending, then slot
// ascending; unfilled slots are (-inf, 0). Probed slabs do not arrive in slot
// order, so an equal score in a later slab may carry a lower slot: the 64-bit
// keys of the merge order it first all the same.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "topk_common.cuh"
#include "wgmma_topk.cuh"

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
    m0 += wg::BMH;
    if (m0 >= valid) seek(p + 1);
  }
  __device__ __forceinline__ int row0() const { return base + m0; }  // tile's first bank row
  __device__ __forceinline__ int n_cols() const { return valid - m0; }  // valid columns
};

// The wgmma kernel's items (wgmma_topk.cuh): (probe split, 64-query tile),
// split-major, so the four items of a 256-query tile run side by side and
// read the same slabs from L2. A split walks probes [p0, p0 + per_split) of
// its query tile's leaf_ids row, slab by slab, 128 rows a tile.
struct Slabs {
  const int* leaf_ids;
  const int* leaf_valid;
  int n_slabs, cap, n_probe, block_q, q_tiles, splits, per_split;
  __host__ __device__ __forceinline__ int n_items() const { return q_tiles * splits; }
  __host__ __device__ __forceinline__ int q_tile(int item) const { return item % q_tiles; }
  __host__ __device__ __forceinline__ int split(int item) const { return item / q_tiles; }
  __device__ __forceinline__ SlabWalk walk(int item) const {
    const int tile = q_tile(item) * wg::BQH / block_q;
    const int p0 = split(item) * per_split;
    SlabWalk w{leaf_ids + static_cast<size_t>(tile) * n_probe, leaf_valid,
               min(n_probe, p0 + per_split), n_slabs, cap};
    w.seek(p0);
    return w;
  }
};

template <class F, int S, wg::Epi E>
int launch_wgmma(const void* q, const void* bank, const float* scale, const void* leaf_ids,
                 const void* leaf_valid, void* out_vals, void* out_idx, void* parts, void* thr,
                 void* work, int work_ctas, int nq, int n_slabs, int cap, int d, int block_q,
                 int n_probe, int k, int probe_splits, cudaStream_t stream) {
  if (probe_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_split = n_probe > 0 ? (n_probe + probe_splits - 1) / probe_splits : 1;
  const int splits = n_probe > 0 ? (n_probe + per_split - 1) / per_split : 1;
  const Slabs items{static_cast<const int*>(leaf_ids), static_cast<const int*>(leaf_valid),
                    n_slabs, cap, n_probe, block_q, nq / wg::BQH, splits, per_split};
  if (scale == nullptr)
    return wg::launch<F, S, wg::PLAIN>(q, bank, nullptr, out_vals, out_idx, parts, thr, work,
                                       work_ctas, nq, n_slabs * cap, d, k, items, stream);
  return wg::launch<F, S, E>(q, bank, scale, out_vals, out_idx, parts, thr, work, work_ctas, nq,
                             n_slabs * cap, d, k, items, stream);
}

// Form F with the epilogue E (its row scales `scale`, when given) and its
// queries resident where they fit, else streamed.
template <class F, int S, wg::Epi E>
int launch_fit(const void* q, const void* bank, const float* scale, const void* leaf_ids,
               const void* leaf_valid, void* out_vals, void* out_idx, void* parts, void* thr,
               void* work, int work_ctas, int nq, int n_slabs, int cap, int d, int block_q,
               int n_probe, int k, int probe_splits, cudaStream_t stream) {
  if (wg::smem_at<F>(d) > 0)
    return launch_wgmma<F, S, E>(q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, parts,
                                 thr, work, work_ctas, nq, n_slabs, cap, d, block_q, n_probe, k,
                                 probe_splits, stream);
  return launch_wgmma<wg::Streamed<F>, S, E>(
      q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, parts, thr, work, work_ctas, nq,
      n_slabs, cap, d, block_q, n_probe, k, probe_splits, stream);
}

template <int S>
int launch(const void* q, const void* bank, const float* scale, const void* leaf_ids,
           const void* leaf_valid, void* out_vals, void* out_idx, int nq, int n_slabs, int cap,
           int d, int block_q, int n_probe, int k, int form, void* parts, void* thr, void* work,
           int work_ctas, int probe_splits, cudaStream_t stream) {
  switch (form) {
    case 0:  // f32 keeps no queries resident: every depth fits
      return launch_wgmma<wg::F32, S, wg::PLAIN>(q, bank, nullptr, leaf_ids, leaf_valid,
                                                 out_vals, out_idx, parts, thr, work, work_ctas,
                                                 nq, n_slabs, cap, d, block_q, n_probe, k,
                                                 probe_splits, stream);
    case 1:
      return launch_fit<wg::Bf16, S, wg::PLAIN>(q, bank, nullptr, leaf_ids, leaf_valid, out_vals,
                                                out_idx, parts, thr, work, work_ctas, nq, n_slabs,
                                                cap, d, block_q, n_probe, k, probe_splits, stream);
    case 2:  // int8 x int8: s32 accumulators, one conversion to f32
      return launch_fit<wg::S8, S, wg::SCALE>(q, bank, scale, leaf_ids, leaf_valid, out_vals,
                                              out_idx, parts, thr, work, work_ctas, nq, n_slabs,
                                              cap, d, block_q, n_probe, k, probe_splits, stream);
    default:
      return launch_fit<wg::Asym, S, wg::SCALE>(q, bank, scale, leaf_ids, leaf_valid, out_vals,
                                                out_idx, parts, thr, work, work_ctas, nq, n_slabs,
                                                cap, d, block_q, n_probe, k, probe_splits, stream);
  }
}

}  // namespace

// Launch K2 on `stream`. q (nq, d) and bank (n_slabs·cap, d) are row-major,
// by `form`: 0 both f32, 1 both bf16, 2 both int8, 3 bf16 q and int8 bank;
// d is a multiple of 8 (of 16 with an int8 bank) and both pointers are
// 16-byte aligned. scale (n_slabs·cap,) f32, when not null, multiplies each
// score by its slot's scale. leaf_ids (nq / block_q, n_probe) and leaf_valid
// (n_slabs,) are int32. block_q is a multiple of 64 that divides nq. Writes
// out_vals (nq, k) f32 and out_idx (nq, k) int64 IVF slot ids.
// 1 <= k <= 128, n_probe >= 0, n_slabs·cap < 2^31. Every call runs the
// wgmma kernel: it cuts each tile's probe list into ceil(n_probe /
// ceil(n_probe / probe_splits)) splits and needs the scratch `parts`, (nq,
// 2 · splits, 32 · ceil(k / 32)) 64-bit keys, `thr`, nq 64-bit keys set to
// 0, and `work`, work_ctas · ivf_topk_work_keys(k) 64-bit keys (it runs on
// at most work_ctas CTAs). Returns cudaGetLastError() after the launch (0 =
// launched), or 9001 / 9002 when the tensor maps cannot be encoded.
extern "C" int ivf_topk_launch(const void* q, const void* bank, const float* scale,
                               const void* leaf_ids, const void* leaf_valid, void* out_vals,
                               void* out_idx, int nq, int n_slabs, int cap, int d, int block_q,
                               int n_probe, int k, int form, void* parts, void* thr, void* work,
                               int work_ctas, int probe_splits, void* stream) {
  if (nq < 1 || k < 1 || k > 128 || form < 0 || form > 3 || d % (form >= 2 ? 16 : 8) != 0 ||
      n_slabs < 1 || cap < 1 || n_probe < 0 || block_q < wg::BQH || block_q % wg::BQH != 0 ||
      nq % block_q != 0 || static_cast<long long>(n_slabs) * cap > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, form, parts, thr, work, work_ctas, probe_splits, s);
    case 2: return launch<2>(q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, form, parts, thr, work, work_ctas, probe_splits, s);
    case 3: return launch<3>(q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, form, parts, thr, work, work_ctas, probe_splits, s);
    default: return launch<4>(q, bank, scale, leaf_ids, leaf_valid, out_vals, out_idx, nq, n_slabs, cap, d, block_q, n_probe, k, form, parts, thr, work, work_ctas, probe_splits, s);
  }
}

// Dynamic shared memory the wgmma kernel of `form` (0 f32, 1 bf16, 2 int8,
// 3 bf16 queries on int8 codes) asks for at depth d (bf16, int8 and asym:
// the resident form's where it fits, else the streamed one's; f32
// always streams); more than 0 for every form at every depth.
extern "C" int ivf_topk_wgmma_smem(int d, int form) {
  if (form == 0) return wg::smem_at<wg::F32>(d);
  if (form == 1) return wg::smem_fit<wg::Bf16>(d);
  if (form == 2) return wg::smem_fit<wg::S8>(d);
  return form == 3 ? wg::smem_fit<wg::Asym>(d) : 0;
}

// 64-bit keys of the wgmma kernel's `work` scratch per CTA at k.
extern "C" int ivf_topk_work_keys(int k) { return wg::work_keys(k); }
