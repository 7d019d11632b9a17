// K3: flash attention forward — softmax(q·kᵀ·scale)·v over (B, H, N, hd)
// without writing the (B, H, N, N) logits.
//
// Replaces the TPU kernel behind hbird_tpu/models/vit.py::_flash_attention:
// JAX's library Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, forward
// `_flash_attention_kernel`), which the JAX ViT runs on a sequence padded to
// a multiple of 512 with segment ids masking the padding. Here nothing is
// padded: key columns at or past N score -inf and query rows at or past N
// are never stored. The numerics follow that kernel: s = q·kᵀ accumulated in
// f32, then multiplied by `scale`; an online max-stable softmax in f32; p
// cast to v's dtype for p·v, accumulated in f32; the output cast to q's
// dtype. The sum is divided out once, at the end.
//
// What bounds it on an H100: operations. One call does 4·B·H·N²·hd flops on
// 4·B·H·N·hd elements moved (q, k, v read, o written); at the ViT-B/14 main
// shape (16, 12, 1370, 64) that is ~685 flops per bf16 byte, above the ~295
// at which the card stops being memory bound. So both products go on the
// tensor cores, and the scores, the softmax and p never leave registers.
// Short sequences fall under that line (mocov3_vits16 at 224, N = 197: ~98
// flops per byte; mae_vith14 at 224, N = 257: ~128; bytes bound) and are
// bound by latency in practice.
//
// f32 (`f32::flash_f32<HD>`, every hd): 3xTF32 on mma.sync m16n8k8, each
// f32 operand split into TF32 big and small parts by tf32.cuh (its comment
// has the rounding; tests/test_torch_flash_tf32.py emulates it), each chain
// of products into one accumulator kept short and the chains summed in f32
// registers: within 1e-5 of the f32 plain version (~1e-6 measured). The split
// of a fragment is computed once, when a warp loads it, for its three
// products: q once per CTA (its A fragments stay in registers), each K and
// V word once per warp and tile, p once per tile in registers. That costs
// three tensor-core passes, but TF32's dense rate is ~7x the f32 FMA rate.
// 4 warps per 64-query block, 16 rows each, 64-key tiles through a
// two-stage cp.async ring; the fragments' k order is chosen so that a lane
// reads q and K as float4s and the s accumulator is p·v's A fragment in
// place (see flash_f32).
//
// bf16 at every width, `flash_bf16_wgmma<HD>`, built from hopper.cuh: hd 64
// (every dinov2, DINO, ViT-B/L and MAE-B/L preset; the main path), hd 32
// (mocov3_vits16) and hd 80 (mae_vith14).
// - Persistent CTAs, one per SM, walk work items (b, h, 128-query block),
//   the blocks of one head adjacent so that its K and V stay in L2.
// - A CTA is one producer warp (in a warpgroup that gives its registers
//   away with setmaxnreg) and two consumer warpgroups of 64 query rows each.
//   The producer issues every copy by TMA from 4-D tensor maps (hd, N, H,
//   B) built from the strides: the ViT's strided views of its qkv
//   projection go in as they are, a tile never crosses into the next head,
//   and rows at or past N arrive as zeros. Q comes once per item; K and V
//   stream in 128-key tiles through a 4-stage ring with full (K, V) and
//   empty mbarriers, across item boundaries.
// - s = q·kᵀ is wgmma m64n128k16 with both operands K-major in swizzled
//   shared memory; p·v is wgmma m64n{HD}k16 with p as the register A operand
//   (cast to bf16 from the s accumulator, whose layout is the A fragment's)
//   and V as the MN-major B operand (the transpose bit; a k16 step is 16
//   rows of V): no ldmatrix, no shared-memory round trip of s or p.
// - Row layouts, in TMA and in the descriptors alike: hd 64's 128-byte rows
//   take the 128-byte swizzle, hd 32's 64-byte rows the 64-byte one. hd
//   80's 160-byte rows fit no swizzle row, so a tile is stored as two: head
//   dims 0-63 (16 KiB, the 128-byte swizzle, as at hd 64) and head dims
//   64-79 (4 KiB, 32-byte rows, the 32-byte swizzle), each filled by its
//   own tensor map (box {64, 128} at column 0, box {16, 128} at column 64)
//   and both completing on the tile's mbarrier (20,480 bytes). q·kᵀ is then
//   four k16 steps in the first part and one in the second; p·v is, per
//   16-key step, m64n64k16 on the first part and m64n16k16 on the second,
//   into one 40-float accumulator whose last 8 are head dims 64-79. Q plus
//   the K/V ring take 10 such tiles (Q double-buffered): 201 KiB.
// - Online softmax in f32 registers with exp2 of s·scale·log2(e), the sum
//   divided out once at the end; key columns at or past N score -inf.
// - Overlap, both kept by measurement (PERF.md): the next tile's q·kᵀ is
//   issued together with this tile's p·v and the softmax runs while p·v is
//   in flight; and the two consumer warpgroups take turns issuing products
//   (ping-pong on named barriers), so one's softmax runs under the other's
//   products.
// - hd 32 at N = 197 (mocov3_vits16 at 224) is short work: a head is two
//   query blocks and two key tiles, 384 items of 128 queries on 132 SMs,
//   bound by latency, not by the tensor cores. It keeps hd 64's item shape
//   and double-buffers Q (q_buffers<32>()), so the next item's Q arrives
//   while this item's last products run. Its time follows the rounds of
//   items, not the work (chip_smoke.py phase 7 on an H100, in a CUDA graph:
//   12 heads at B = 4, 8, 12, 16, i.e. 1, 2, 3, 3 rounds, take 5.6, 8.3,
//   10.9, 10.9 µs: ~2.9 µs fixed and ~2.65 µs a round). An item holding a
//   whole head (its K and V loaded once, every query block scored against
//   them), or several heads, halves the items to 192 but doubles each
//   item's passes: 2 rounds of 2 passes against 3 of one, a loss unless a
//   pass got 25% cheaper, and the ring already streams K and V from L2 one
//   item ahead, so kept out. Any N runs (mocov3_vits16 at 512: N = 1,025,
//   9 key tiles).
// - hd 80 at N = 257 (mae_vith14 at 224) is short work too: 257 = 2·128 + 1,
//   so a head is three query blocks (the third holding one row) and three
//   key tiles (the third holding one key): 768 items at batch 16, and
//   (384/257)² = 2.2x the useful (query, key) pairs. Q is double-buffered
//   as at hd 32. Its time follows the rounds of items too (phase 7, in a
//   CUDA graph: ~5.5-6 µs a round, ~3 µs fixed), and the one-key tail cost
//   0.039 ms at N = 257 against 0.023 at N = 256. Cutting work inside the
//   tail items alone moved nothing: with 132 CTAs striding over 3 blocks a
//   head, every CTA keeps one block index, so the third blocks all sit on
//   a third of the CTAs and the others run 6 full items each. So at hd 80
//   (tail_cuts), measured together on an H100 (0.0393 -> 0.0348 ms):
//   (1) the last query block of every head is ordered after all other
//   blocks (item_coords), so the short items spread over every CTA (4 full
//   and 2 short items at most, where there were 6 full); (2) a consumer
//   warpgroup whose 64 rows all lie at or past N issues no products and
//   only keeps its turns and barrier arrivals; (3) a last key tile of at
//   most 16 keys takes one p·v step, not 8. Scoring such a tile on
//   m64n16k16 instead of m64n128k16 made ptxas serialise every wgmma of
//   the kernel for want of registers (C7511), 20% slower: not kept.
//
// Design of the rest: the TPU grid's sequential key axis becomes the loop
// over key tiles inside the CTA, with the running max m, the sum l and the
// f32 output accumulator kept across it. o is written through its own
// strides (the wrapper lays it out so that the heads merge back without a
// copy).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "hopper.cuh"
#include "tf32.cuh"
#include "topk_common.cuh"  // allow_smem, neg_inf, FULL

namespace {

// 16-byte async copy (K3 f32's cp.async ring); src_bytes = 0 zero-fills the
// destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

constexpr int FQ = 64;  // queries per CTA (f32)
constexpr int FK = 64;  // keys per tile (f32)

// q/k/v (shared) and o strides, in elements.
struct Layout {
  long long sb, sh, sn;
  long long ob, oh, on;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Start the async copies of rows [row0, row0 + 64) of one (b, h) slice
// into dst[64][LD]; rows at or past n are zero-filled (so a masked key's
// value row is 0, never garbage times a zero weight).
template <int HD, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int n,
                                          long long sn, int threads) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VECS = HD / PER;
  for (int i = threadIdx.x; i < 64 * VECS; i += threads) {
    const int r = i / VECS;
    const int c = (i % VECS) * PER;
    const bool ok = row0 + r < n;
    const T* s = ok ? src + static_cast<long long>(row0 + r) * sn + c : src;
    cp_async16(dst + r * LD + c, s, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed rings with a producer warp.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;                 // queries per item: two consumer warpgroups of 64
constexpr int BKV = 128;                // keys per tile
constexpr int STAGES = 4;               // K/V ring depth
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups

// A row's head dims in the tile's first part (128- or 64-byte swizzle) and
// in its second (hd 80's dims 64-79, the 32-byte swizzle; none otherwise).
template <int HD>
__host__ __device__ constexpr int lo_dims() {
  return HD == 80 ? 64 : HD;
}
template <int HD>
__host__ __device__ constexpr int hi_dims() {
  return HD - lo_dims<HD>();
}
template <int HD>
__host__ __device__ constexpr int lo_bytes() {
  return BKV * lo_dims<HD>() * 2;
}

// The ragged tail's cuts (1)-(3) of the header: hd 80 only, so hd 32 and
// 64 keep their code and their bits.
template <int HD>
__host__ __device__ constexpr bool tail_cuts() {
  return HD == 80;
}

// Q tiles in flight: at hd 32 and 80 an item is short (two and three key
// tiles at N = 197 and 257), so the next item's Q is loaded while this one
// runs; hd 64 keeps one.
template <int HD>
__host__ __device__ constexpr int q_buffers() {
  return HD == 64 ? 1 : 2;
}

// A K or V tile, and the Q tile: 128 rows of HD bf16.
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return BKV * HD * 2;
}

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return hopper::SMEM_ALIGN + tile_bytes<HD>() * (q_buffers<HD>() + 2 * STAGES) + 256;
}

// The tensor maps of q, k and v (the tiles' first parts), then, at hd 80,
// of their head dims 64-79.
template <int HD>
struct Maps {
  static constexpr int COUNT = hi_dims<HD>() ? 6 : 3;
  CUtensorMap m[COUNT];
};

// The descriptor of a tile's first part: 128-byte rows (hd 64, hd 80's
// dims 0-63) take the 128-byte swizzle, 64-byte rows (hd 32) the 64-byte
// one. The second part's 32-byte rows take hopper::sw32_desc.
template <int HD>
__device__ __forceinline__ uint64_t desc(const void* p) {
  if constexpr (HD == 32) return hopper::sw64_desc(p);
  return hopper::sw128_desc(p);
}

// Rows row0.. of (b, h) of tensor i (0 q, 1 k, 2 v) into the tile at dst,
// completing on bar: one TMA copy a part.
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const Maps<HD>& maps, int i,
                                         uint64_t* bar, int row0, int h, int b) {
  hopper::tma_load_4d(dst, &maps.m[i], bar, 0, row0, h, b);
  if constexpr (hi_dims<HD>() > 0)
    hopper::tma_load_4d(dst + lo_bytes<HD>(), &maps.m[3 + i], bar, lo_dims<HD>(), row0, h, b);
}

// Work item -> (b·heads + h, query block): heads in order, the blocks of
// one head adjacent; with the tail cuts (1) the last block of every head
// comes after every other block, so that those short items spread over
// all CTAs.
template <int HD>
__device__ __forceinline__ void item_coords(int item, int n_qblocks, int n_items, int& bh, int& qb) {
  if constexpr (tail_cuts<HD>()) {
    const int full = n_items - n_items / n_qblocks;  // items of the blocks before the last
    if (item >= full) {
      bh = item - full;
      qb = n_qblocks - 1;
      return;
    }
    bh = item / (n_qblocks - 1);
    qb = item % (n_qblocks - 1);
    return;
  }
  bh = item / n_qblocks;
  qb = item % n_qblocks;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = q·kᵀ for one 128-key tile (A: consumer warpgroup cw's 64 query rows
// of the Q tile qt): k16 steps of 32 bytes inside the rows of each part.
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[64], const unsigned char* qt, int cw,
                                        const unsigned char* kt) {
  const unsigned char* qa = qt + cw * (64 * lo_dims<HD>() * 2);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < lo_dims<HD>() / 16; ++kk)
    hopper::wgmma_m64n128k16_ss(s, desc<HD>(qa + kk * 32), desc<HD>(kt + kk * 32), kk > 0);
  if constexpr (hi_dims<HD>() > 0)
    hopper::wgmma_m64n128k16_ss(s, hopper::sw32_desc(qt + lo_bytes<HD>() + cw * 64 * 32),
                                hopper::sw32_desc(kt + lo_bytes<HD>()), 1);
  hopper::wgmma_commit();
}

// o += p·v for one 128-key tile: 8 k16 steps of 16 keys (16 rows of V:
// 2,048 bytes at 128-byte rows, 1,024 at 64; at hd 80 also 512 bytes of
// the 32-byte second part, into o's last 8 floats).
template <int HD, int STEPS = BKV / 16>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[8][4],
                                         const unsigned char* vt) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    if constexpr (HD == 32) {
      hopper::wgmma_m64n32k16_rs_tb(o, p[kk], desc<HD>(vt + kk * 16 * HD * 2), 1);
    } else if constexpr (HD == 64) {
      hopper::wgmma_m64n64k16_rs_tb(o, p[kk], desc<HD>(vt + kk * 16 * HD * 2), 1);
    } else {
      hopper::wgmma_m64n64k16_rs_tb(*reinterpret_cast<float(*)[32]>(o), p[kk],
                                    desc<HD>(vt + kk * 16 * 128), 1);
      hopper::wgmma_m64n16k16_rs_tb(*reinterpret_cast<float(*)[8]>(o + 32), p[kk],
                                    hopper::sw32_desc(vt + lo_bytes<HD>() + kk * 16 * 32), 1);
    }
  }
  hopper::wgmma_commit();
}

// The online softmax of one score tile in place (s becomes unnormalised p
// in f32): scores scaled by sl2 = scale·log2(e), columns at or past n
// masked, the rows' maxima m and partial sums l updated; alpha rescales the
// output accumulated so far. Accumulator element 4j+e: row g (e < 2) or
// g + 8, column 8j + 2·(lane%4) + (e&1).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int c0, int n, float sl2,
                                             int lane) {
  float mx[2] = {m[0], m[1]};
  const bool ragged = c0 + BKV > n;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sl2;
      if (ragged && c0 + 8 * j + 2 * (lane & 3) + (e & 1) >= n) x = neg_inf();
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(s[4 * j + e] - m[e >> 1]);
      l[e >> 1] += s[4 * j + e];
    }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// p as bf16 A fragments of the 8 k16 steps: columns 16kk.. are accumulator
// groups 2kk and 2kk+1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Consumer warpgroup `cw`'s turn to issue products (ping-pong): named
// barrier 1 + cw, completed by the other warpgroup's arrival.
__device__ __forceinline__ void turn_begin(int cw) { hopper::named_sync(1 + cw, 256); }

__device__ __forceinline__ void turn_end(int cw) { hopper::named_arrive(2 - cw, 256); }

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_wgmma(const __grid_constant__ Maps<HD> maps, __nv_bfloat16* __restrict__ o,
                     int heads, int n, long long ob, long long oh, long long on, float sl2,
                     int n_qblocks, int n_items) {
  constexpr int TILE = tile_bytes<HD>();
  constexpr int QBUF = q_buffers<HD>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::aligned_smem(smem_raw);  // [QBUF][TILE]
  unsigned char* ks = qs + QBUF * TILE;
  unsigned char* vs = ks + STAGES * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);  // [QBUF]
  uint64_t* q_empty = q_full + QBUF;                                   // [QBUF]
  uint64_t* k_full = q_empty + QBUF;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  const int n_tiles = (n + BKV - 1) / BKV;
  // (3) The last key tile holds at most 16 keys (N = 257 = 2·128 + 1): one
  // p·v step (the rest of p is 0).
  const bool short_last = tail_cuts<HD>() && n - (n_tiles - 1) * BKV <= 16;
  const int wgi = __shfl_sync(FULL, threadIdx.x / 128, 0);  // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUF; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, 256);
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // Producer: one thread issues every TMA copy.
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < Maps<HD>::COUNT; ++i) hopper::prefetch_tensor_map(&maps.m[i]);
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        int bh, qb;
        item_coords<HD>(item, n_qblocks, n_items, bh, qb);
        const int b = bh / heads, h = bh % heads;
        const int qi = it % QBUF;
        hopper::mbar_wait(q_empty + qi, ((it / QBUF) & 1) ^ 1);
        hopper::mbar_expect_tx(q_full + qi, TILE);
        tma_tile<HD>(qs + qi * TILE, maps, 0, q_full + qi, qb * BQ, h, b);
        for (int t = 0; t < n_tiles; ++t) {
          hopper::mbar_wait(empty + stage, phase ^ 1);
          hopper::mbar_expect_tx(k_full + stage, TILE);
          tma_tile<HD>(ks + stage * TILE, maps, 1, k_full + stage, t * BKV, h, b);
          hopper::mbar_expect_tx(v_full + stage, TILE);
          tma_tile<HD>(vs + stage * TILE, maps, 2, v_full + stage, t * BKV, h, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows [64·cw, 64·cw + 64) of the item.
    hopper::reg_alloc<232>();
    const int cw = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    if (cw == 1) hopper::named_arrive(1, 256);  // consumer 0 takes the first turn
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      int bh, qb;
      item_coords<HD>(item, n_qblocks, n_items, bh, qb);
      const int b = bh / heads, h = bh % heads;
      const int qi = it % QBUF;
      const unsigned char* qt = qs + qi * TILE;
      if constexpr (tail_cuts<HD>()) {
        if (qb * BQ + cw * 64 >= n) {
          // (2) Every row of this warpgroup lies at or past N: no products,
          // but the turns, waits and arrivals of a working warpgroup.
          hopper::mbar_wait(q_full + qi, (it / QBUF) & 1);
          for (int t = 0; t <= n_tiles; ++t) {
            const int prev = stage == 0 ? STAGES - 1 : stage - 1;
            const uint32_t prev_phase = stage == 0 ? phase ^ 1 : phase;
            turn_begin(cw);
            if (t < n_tiles) hopper::mbar_wait(k_full + stage, phase);
            if (t > 0) hopper::mbar_wait(v_full + prev, prev_phase);
            turn_end(cw);
            if (t == n_tiles - 1) hopper::mbar_arrive(q_empty + qi);
            if (t > 0) hopper::mbar_arrive(empty + prev);
            if (t < n_tiles && ++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          continue;
        }
      }
      float acc[HD / 2], s[64], m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f}, alpha[2];
      uint32_t p[8][4];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      hopper::mbar_wait(q_full + qi, (it / QBUF) & 1);

      // Prologue: s of tile 0 and its softmax.
      turn_begin(cw);
      hopper::mbar_wait(k_full + stage, phase);
      issue_s<HD>(s, qt, cw, ks + stage * TILE);
      turn_end(cw);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if (n_tiles == 1) hopper::mbar_arrive(q_empty + qi);
      softmax_tile(s, m, l, alpha, 0, n, sl2, lane);
      pack_p(p, s);
      int prev = stage;
      uint32_t prev_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      for (int t = 1; t < n_tiles; ++t) {
        // s of tile t and p·v of tile t-1 in flight together; the softmax
        // of tile t runs under p·v.
        turn_begin(cw);
        hopper::mbar_wait(k_full + stage, phase);
        issue_s<HD>(s, qt, cw, ks + stage * TILE);
        rescale(acc, alpha);
        hopper::mbar_wait(v_full + prev, prev_phase);
        issue_pv<HD>(acc, p, vs + prev * TILE);
        turn_end(cw);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        if (t == n_tiles - 1) hopper::mbar_arrive(q_empty + qi);
        softmax_tile(s, m, l, alpha, t * BKV, n, sl2, lane);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::mbar_arrive(empty + prev);
        pack_p(p, s);
        prev = stage;
        prev_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      turn_begin(cw);
      rescale(acc, alpha);
      hopper::mbar_wait(v_full + prev, prev_phase);
      if (short_last)
        issue_pv<HD, 1>(acc, p, vs + prev * TILE);
      else
        issue_pv<HD>(acc, p, vs + prev * TILE);
      turn_end(cw);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty + prev);

      // Normalise once and store the rows below n: rows g and g + 8 of the
      // warp's 16, head dims 8j + 2·(lane%4).
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
        inv[i] = 1.0f / l[i];
      }
      __nv_bfloat16* ob_h = o + b * ob + h * oh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qb * BQ + cw * 64 + warp * 16 + (lane >> 2) + 8 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(ob_h + row * on + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
        }
      }
    }
  }
}

// K3 bf16: the tensor maps of q, k and v (shared strides; each part's box
// and swizzle as in the header), then the kernel. Returns 0, a cudaError_t
// or a hopper::ERR_* code.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads, int n,
           const Layout& lay, float scale, cudaStream_t stream) {
  Maps<HD> maps;
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(n), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(lay.sn) * 2, static_cast<uint64_t>(lay.sh) * 2,
                               static_cast<uint64_t>(lay.sb) * 2};
  const uint32_t box[4] = {lo_dims<HD>(), BKV, 1, 1};
  const uint32_t hi_box[4] = {hi_dims<HD>(), BKV, 1, 1};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int r = hopper::encode_tensor_map(
        &maps.m[i], 4, ptrs[i], dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == 0 && hi_dims<HD>() > 0)
      r = hopper::encode_tensor_map(&maps.m[3 + i], 4, ptrs[i], dims, strides, hi_box,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_32B);
    if (r != 0) return r;
  }
  const int n_qblocks = (n + BQ - 1) / BQ;
  const int n_items = n_qblocks * batch * heads;
  const float sl2 = scale * 1.4426950408889634f;
  constexpr int SMEM = smem_bytes<HD>();
  const cudaError_t e = allow_smem(flash_bf16_wgmma<HD>, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = hopper::sm_count();
  const int grid = sms > 0 && sms < n_items ? sms : n_items;
  flash_bf16_wgmma<HD><<<grid, THREADS, SMEM, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), heads, n, lay.ob, lay.oh, lay.on, sl2, n_qblocks,
      n_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores.
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int THREADS = 128;  // four warps of 16 query rows

// Row strides (floats) of the staged K and V tiles. K is read as float4s at
// depth 16i + 4t of key g by the lanes (g, t) of a quarter warp: a stride
// of 16 (mod 32) words puts keys g and g + 1 on the two halves of the
// banks. V is read as single floats at keys 2t, 2t + 1 and dim g: a stride
// of 4 (mod 16) words puts the 32 lanes on 32 banks.
template <int HD>
__host__ __device__ constexpr int ldk() {
  return HD + (48 - HD % 32) % 32;
}
template <int HD>
__host__ __device__ constexpr int ldv() {
  return HD + 4;
}
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * FK * (ldk<HD>() + ldv<HD>()) * sizeof(float);  // two stages of (K, V)
}

using tf32::split;  // big = tf32(x), small = tf32(x - big)

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: the two small cross terms first, then big·big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t b0b, uint32_t b1b,
                                           uint32_t b0s, uint32_t b1s) {
  mma_tf32(c, as, b0b, b1b);
  mma_tf32(c, ab, b0s, b1s);
  mma_tf32(c, ab, b0b, b1b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per 64 queries of one (b, h); lane (g, t) = (lane / 4, lane % 4)
// of warp w holds query rows w·16 + g and + 8. The m16n8k8 fragments take
// their k index in an order of our choosing, as long as A and B agree:
// - q·kᵀ, k-step 2i + h: k index t is depth 16i + 4t + 2h and t + 4 is the
//   depth after it, so a lane reads its A and B words as float4s;
// - p·v, k-step j: k index t is key 8j + 2t and t + 4 is key 8j + 2t + 1,
//   which is where the s accumulator of n8 tile j holds p: p becomes the A
//   fragment in place.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int heads, int n, Layout lay,
              float sl2) {
  constexpr int LDK = ldk<HD>();
  constexpr int LDV = ldv<HD>();
  constexpr int DG = HD / 16;  // depth groups of two k-steps
  constexpr int DT = HD / 8;   // n8 tiles of the output row
  // The tensor cores add into their f32 accumulator rounding toward zero,
  // a bias that grows with the length of a chain of mma.sync into one
  // accumulator (over a whole sequence it reached 1e-5 in o). So every
  // chain is short: s sums each depth group (6 products) into a fresh
  // accumulator, and p·v a tile (24) at hd <= 64, a k-step (3) at hd = 80,
  // whose 40 more registers a tile's sum would not leave; the sums are
  // added in f32, rounding to nearest.
  constexpr int SUM_STEPS = HD <= 64 ? 8 : 1;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;               // [2][FK][LDK]
  float* vs = ks + 2 * FK * LDK;  // [2][FK][LDV]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * FQ;
  const long long off = b * lay.sb + h * lay.sh;
  q += off;
  k += off;
  v += off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  load_tile<HD, LDK>(ks, k, 0, n, lay.sn, THREADS);
  load_tile<HD, LDV>(vs, v, 0, n, lay.sn, THREADS);
  asm volatile("cp.async.commit_group;\n" ::);

  // The warp's query rows as split A fragments, read once from memory.
  uint32_t qb[DT][4], qsm[DT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < DG; ++i) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < n) x = *reinterpret_cast<const float4*>(q + row * lay.sn + 16 * i + 4 * t4);
      // A: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
      split(x.x, qb[2 * i][r], qsm[2 * i][r]);
      split(x.y, qb[2 * i][2 + r], qsm[2 * i][2 + r]);
      split(x.z, qb[2 * i + 1][r], qsm[2 * i + 1][r]);
      split(x.w, qb[2 * i + 1][2 + r], qsm[2 * i + 1][2 + r]);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()};  // rows g and g + 8, in log2 units
  float l[2] = {0.0f, 0.0f};           // this lane's share of the row sums

  const int n_tiles = (n + FK - 1) / FK;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      const int st = (t + 1) & 1;
      load_tile<HD, LDK>(ks + st * FK * LDK, k, (t + 1) * FK, n, lay.sn, THREADS);
      load_tile<HD, LDV>(vs + st * FK * LDV, v, (t + 1) * FK, n, lay.sn, THREADS);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile's copies are visible to every warp
    const float* kt = ks + (t & 1) * FK * LDK;
    const float* vt = vs + (t & 1) * FK * LDV;

    // s = q·kᵀ: 16 rows × 64 keys per warp, 8 n8 tiles; each K word is
    // split once, for its three products. Each depth group's products go
    // into a fresh accumulator, added to s in f32 (see SUM_STEPS).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < DG; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(kt + (8 * j + g) * LDK + 16 * i + 4 * t4);
        uint32_t bb[4], bs[4];
        split(x.x, bb[0], bs[0]);
        split(x.y, bb[1], bs[1]);
        split(x.z, bb[2], bs[2]);
        split(x.w, bb[3], bs[3]);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(d, qb[2 * i], qsm[2 * i], bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(d, qb[2 * i + 1], qsm[2 * i + 1], bb[2], bb[3], bs[2], bs[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += d[e];
      }

    // Scale (by scale·log2 e), mask the ragged edge, online softmax in f32.
    const int col0 = t * FK + 2 * t4;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = col0 + 8 * j + (e & 1) < n ? s[j][e] * sl2 : neg_inf();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p·v: k-step j is n8 score tile j; p and each V word split once.
    // The products of SUM_STEPS k-steps go into a fresh accumulator, added
    // to o in f32.
    float pv[DT][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j % SUM_STEPS == 0) {
#pragma unroll
        for (int nn = 0; nn < DT; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[nn][e] = 0.0f;
      }
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const float* v0 = vt + (8 * j + 2 * t4) * LDV + g;
#pragma unroll
      for (int nn = 0; nn < DT; ++nn) {
        uint32_t b0b, b0s, b1b, b1s;
        split(v0[8 * nn], b0b, b0s);
        split(v0[LDV + 8 * nn], b1b, b1s);
        mma_3xtf32(pv[nn], pb, ps, b0b, b1b, b0s, b1s);
      }
      if (j % SUM_STEPS == SUM_STEPS - 1) {
#pragma unroll
        for (int nn = 0; nn < DT; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nn][e] += pv[nn][e];
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Normalise once and store the rows below n: head dims 8nn + 2t, + 1.
  o += b * lay.ob + h * lay.oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float inv = 1.0f / l[i];
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nn = 0; nn < DT; ++nn)
      *reinterpret_cast<float2*>(o + row * lay.on + 8 * nn + 2 * t4) =
          make_float2(acc[nn][2 * i] * inv, acc[nn][2 * i + 1] * inv);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                       int n, Layout lay, float scale, cudaStream_t stream) {
  const dim3 grid((n + FQ - 1) / FQ, batch * heads);
  constexpr size_t smem = f32::smem_bytes<HD>();
  const cudaError_t e = allow_smem(f32::flash_f32<HD>, smem);
  if (e != cudaSuccess) return e;
  f32::flash_f32<HD><<<grid, f32::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), heads, n, lay, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Launch K3 on `stream`. q, k, v are (batch, heads, n, hd) arrays with one
// shared set of element strides (sb, sh, sn) and a unit stride along hd; o
// has strides (ob, oh, on) and a unit stride along hd. All f32 (is_bf16 =
// 0) or all bf16 (is_bf16 = 1); hd is 32, 64 or 80; pointers and strides
// are 16-byte aligned. n >= 1, batch · heads <= 65,535.
// Returns cudaGetLastError() after the launch (0 = launched), or 9001 / 9002
// when the tensor maps of the bf16 wgmma kernel cannot be encoded.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int n, int hd, long long sb, long long sh,
                                 long long sn, long long ob, long long oh, long long on,
                                 float scale, int is_bf16, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{sb, sh, sn, ob, oh, on};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (hd) {
      case 32: return wg::launch<32>(q, k, v, o, batch, heads, n, lay, scale, s);
      case 64: return wg::launch<64>(q, k, v, o, batch, heads, n, lay, scale, s);
      case 80: return wg::launch<80>(q, k, v, o, batch, heads, n, lay, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t e;
  switch (hd) {
    case 32: e = launch_f32<32>(q, k, v, o, batch, heads, n, lay, scale, s); break;
    case 64: e = launch_f32<64>(q, k, v, o, batch, heads, n, lay, scale, s); break;
    case 80: e = launch_f32<80>(q, k, v, o, batch, heads, n, lay, scale, s); break;
    default: e = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(e);
}

// Dynamic shared memory the bf16 wgmma kernel asks for at head width hd (0
// at a width the kernel does not take).
extern "C" int flash_attn_wgmma_smem(int hd) {
  switch (hd) {
    case 32: return wg::smem_bytes<32>();
    case 64: return wg::smem_bytes<64>();
    case 80: return wg::smem_bytes<80>();
    default: return 0;
  }
}
