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
// f32 at every width, `flash_f32_wgmma<HD, LSE>`: 3xTF32 on wgmma, each f32
// operand split into TF32 big and small parts by tf32.cuh (its comment has
// the rounding), within 1e-5 of the f32 plain version;
// tests/test_torch_flash_tf32.py emulates the split and this order of work
// (`emulate_tiles`).
// - The bf16 kernel's frame (below): persistent CTAs over (b, h, 128-query
//   block) items, two consumer warpgroups of 64 query rows, a producer
//   thread issuing every copy by TMA from (hd, N, H, B) tensor maps built
//   from the shared strides, an online softmax in exp2 units, one division
//   at the end, rows past N never stored.
// - wgmma takes tf32 operands K-major only (the transpose bit is for 16-bit
//   types), so p·v needs each V tile as Vᵀ, keys contiguous. The producer
//   warpgroup's other three warps transform each 64-key tile as it lands:
//   K split in place into its big parts, its small parts beside it, and V
//   transposed and split into Vᵀ big and small parts. In each 8-key group
//   of Vᵀ, key 2t goes to k index t and key 2t + 1 to t + 4: that is where
//   the s accumulator of m64n64k8 holds p, so p's split A fragments are
//   taken from the registers, one tile at a time.
// - Tiles: 32-float parts of 128-byte rows under the 128-byte swizzle, and
//   at hd 80 head dims 64-79 as a 16-float part of 64-byte rows under the
//   64-byte swizzle (TMA and descriptors alike); Vᵀ is two 32-key chunks of
//   HD rows. A ring of split tiles (K, K small, Vᵀ, Vᵀ small) and a ring of
//   raw V tiles sit beside the Q tile (f32_smem_bytes: 165,120, 197,888
//   and 226,560 bytes at hd 32, 64 and 80).
// - Registers: s (32 a thread), p's split parts (64), o and a tile's p·v
//   (HD/2 each). q's split A fragments (HD/4) stay for the whole item up to
//   hd 64; at hd 80 they are split again from the Q tile for every key tile.
//   The transform loops are on the critical path: the producer warpgroup
//   keeps 72 registers (the loops unrolled 4 times) and the consumers 216.
//   At (16, 12, 1370, 64) on an H100 (PERF.md): 40 / 232 with the
//   loops unrolled twice spilled 4 bytes (1.07 ms), unrolled once 1.13,
//   56 / 224 unrolled twice 1.01, this 0.98.
// - The two consumer warpgroups take turns issuing products, as in bf16:
//   without the turns 1.14 ms against 1.13 (unrolled once).
// - Numerics: the tensor cores add into their f32 accumulator rounding
//   toward zero, about an ulp of the accumulator per instruction. So each
//   product group issues its small cross terms first, while the
//   accumulator is still ~2^-11 of the result, and its big·big terms last:
//   HD/8 such adds for s and 8 for a tile's p·v, which goes into a fresh
//   accumulator added to o in f32, rounding to nearest.
//
//
// bf16 at every width, `flash_bf16_wgmma<HD, LSE>`, built from hopper.cuh: hd 64
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
// The backward's residual: each kernel is a template on LSE too. The LSE
// instances (flash_attn_launch_lse, the forward under autograd) also write
// each row's log-sum-exp of s·scale, (m + log2 l)·ln 2 in natural units,
// one f32 a row, which K3-bwd (flash_bwd.cu) reads; everything else is
// `if constexpr`-equal, so the no-grad instances (flash_attn_launch) keep
// their code and their bits, and the LSE instances' output is theirs.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).


#include "hopper.cuh"
#include "tf32.cuh"
#include "topk_common.cuh"  // neg_inf, FULL

namespace {

// q/k/v (shared) and o strides, in elements.
struct Layout {
  long long sb, sh, sn;
  long long ob, oh, on;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed rings with a producer warp (and what f32 shares).
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
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int c0, int n, float sl2,
                                             int lane) {
  constexpr int NJ = N / 4;  // 8-column groups: 8·NJ keys (bf16 128, f32 64)
  float mx[2] = {m[0], m[1]};
  const bool ragged = c0 + 8 * NJ > n;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
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
  for (int j = 0; j < NJ; ++j)
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

// The `LSE` instances' residual for the backward (flash_bwd.cu): each
// stored row's log-sum-exp of s·scale, (m + log2 l)·ln 2 in natural units,
// from the running max m (in exp2 units) and the quad-summed l of rows g
// and g + 8 of the warp's 16 (first row row0), written by lane 4g.
__device__ __forceinline__ void store_lse(float* lse, int bh, int n, int row0, const float (&m)[2],
                                          const float (&l)[2], int lane) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row < n) lse[static_cast<long long>(bh) * n + row] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_wgmma(const __grid_constant__ Maps<HD> maps, __nv_bfloat16* __restrict__ o,
                     int heads, int n, long long ob, long long oh, long long on, float sl2,
                     int n_qblocks, int n_items, float* __restrict__ lse) {
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
      if constexpr (LSE) store_lse(lse, bh, n, qb * BQ + cw * 64 + warp * 16, m, l, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma, with the producer warpgroup's other warps
// transforming the tiles.
// ---------------------------------------------------------------------------

constexpr int FBK = 64;          // keys per f32 tile
constexpr int XF_THREADS = 96;   // warps 1-3 of the producer warpgroup

// Split tiles in flight (K, K small, Vᵀ, Vᵀ small) and raw V tiles, at each
// width, as many as fit beside the Q tile.
template <int HD>
__host__ __device__ constexpr int xf_stages() {
  return HD == 32 ? 4 : 2;
}
template <int HD>
__host__ __device__ constexpr int v_stages() {
  return HD == 80 ? 1 : 2;
}

// q's split A fragments stay in registers for the whole item up to hd 64;
// at hd 80 (80 registers beside s, p's parts, o and a tile's p·v) they are
// split again from the Q tile for every key tile, so the Q tile is held to
// the item's last key tile.
template <int HD>
__host__ __device__ constexpr bool q_resident() {
  return HD <= 64;
}

// 64 rows of HD floats: a K, V or split tile; the Q tile is two.
template <int HD>
__host__ __device__ constexpr int f32_tile_bytes() {
  return FBK * HD * 4;
}

template <int HD>
__host__ __device__ constexpr int f32_smem_bytes() {
  return hopper::SMEM_ALIGN + f32_tile_bytes<HD>() * (2 + 4 * xf_stages<HD>() + v_stages<HD>()) + 256;
}

// Byte offset of head dim d of row `row` in an f32 tile of ROWS rows: part
// d / 32 starts at (d / 32)·ROWS·128; a 32-float part has 128-byte rows
// whose 16-byte unit u lies at u ^ (row % 8), hd 80's last (16 floats)
// 64-byte rows whose unit u lies at u ^ (row / 2 % 4).
template <int HD, int ROWS>
__device__ __forceinline__ int tile_off(int row, int d) {
  const int p = d >> 5, c = d & 31;
  if (HD - 32 * p >= 32) return p * ROWS * 128 + row * 128 + (((c >> 2) ^ (row & 7)) << 4) + ((c & 3) << 2);
  return p * ROWS * 128 + row * 64 + (((c >> 2) ^ ((row >> 1) & 3)) << 4) + ((c & 3) << 2);
}

// The descriptor of k8 step kk (head dims 8kk..8kk+7) of an f32 tile of
// ROWS rows: 32 bytes a step inside a part's rows.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t kstep_desc(const unsigned char* tile, int kk) {
  const int p = kk >> 2;
  const unsigned char* a = tile + p * ROWS * 128 + (kk & 3) * 32;
  return HD - 32 * p >= 32 ? hopper::sw128_desc(a) : hopper::sw64_desc(a);
}

// The descriptor of k8 step j (keys 8j..8j+7, permuted) of a Vᵀ tile: chunk
// j / 4 of HD rows of 128 bytes, 32 bytes a step.
template <int HD>
__device__ __forceinline__ uint64_t vt_desc(const unsigned char* vt, int j) {
  return hopper::sw128_desc(vt + (j >> 2) * HD * 128 + (j & 3) * 32);
}

// Rows row0.. of (b, h) of tensor i (0 q, 1 k, 2 v) into an f32 tile of
// ROWS rows at dst, completing on bar: one TMA copy a part (box {32, ROWS},
// and at hd 80 {16, ROWS} at head dim 64).
template <int HD, int ROWS>
__device__ __forceinline__ void f32_tma(unsigned char* dst, const Maps<HD>& maps, int i, uint64_t* bar,
                                        int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < HD / 32; ++p) hopper::tma_load_4d(dst + p * ROWS * 128, &maps.m[i], bar, 32 * p, row0, h, b);
  if constexpr (HD % 32 != 0)
    hopper::tma_load_4d(dst + (HD / 32) * ROWS * 128, &maps.m[3 + i], bar, HD / 32 * 32, row0, h, b);
}

__device__ __forceinline__ void split4(uint4 v, uint4& big, uint4& small) {
  tf32::split(__uint_as_float(v.x), big.x, small.x);
  tf32::split(__uint_as_float(v.y), big.y, small.y);
  tf32::split(__uint_as_float(v.z), big.z, small.z);
  tf32::split(__uint_as_float(v.w), big.w, small.w);
}

// Transform warps (thread x of XF_THREADS): a K tile split in place into
// its big parts, the small parts into ksm at the same offsets.
template <int HD>
__device__ __forceinline__ void split_k(unsigned char* kt, unsigned char* ksm, int x) {
#pragma unroll 4
  for (int u = x; u < f32_tile_bytes<HD>() / 16; u += XF_THREADS) {
    uint4* p = reinterpret_cast<uint4*>(kt) + u;
    uint4 big, small;
    split4(*p, big, small);
    *p = big;
    reinterpret_cast<uint4*>(ksm)[u] = small;
  }
}

// Transform warp `warp` (0-2): the raw V tile vr (64 keys x HD) as Vᵀ (HD
// rows of 64 keys: two 32-key chunks of 128-byte rows, the 128-byte
// swizzle), split into big (vtb) and small (vts) parts. Lane l takes key
// 32c + l of chunk c, at position (l & 24) + (l even ? l % 8 / 2 : 4 + l %
// 8 / 2): keys 2t, 2t + 1 of an 8-key group at k indices t, t + 4. A task is
// 4 head dims of one chunk: one 16-byte read a lane (8 rows of a quarter
// warp: 8 distinct units) and 8 four-byte writes (32 distinct banks).
template <int HD>
__device__ __forceinline__ void transpose_v(const unsigned char* vr, unsigned char* vtb, unsigned char* vts,
                                            int warp, int lane) {
  constexpr int GROUPS = HD / 4;
  const int r = lane & 7;
  const int pos = (lane & 24) | ((r & 1) ? 4 + (r >> 1) : (r >> 1));
#pragma unroll 4
  for (int task = warp; task < 2 * GROUPS; task += XF_THREADS / 32) {
    const int c = task / GROUPS, d = (task % GROUPS) * 4;
    const float4 x = *reinterpret_cast<const float4*>(vr + tile_off<HD, FBK>(32 * c + lane, d));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = d + i;
      const int off = c * HD * 128 + row * 128 + (((pos >> 2) ^ (row & 7)) << 4) + ((pos & 3) << 2);
      uint32_t big, small;
      tf32::split(xs[i], big, small);
      *reinterpret_cast<uint32_t*>(vtb + off) = big;
      *reinterpret_cast<uint32_t*>(vts + off) = small;
    }
  }
}

// Consumer warp rows row0 + g and + 8 of the Q tile (128 rows) as split
// A fragments: k8 step kk's a0 (row g, head dim 8kk + t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4).
template <int HD>
__device__ __forceinline__ void load_q(const unsigned char* qt, int row0, int lane, uint32_t (&qb)[HD / 8][4],
                                       uint32_t (&qs)[HD / 8][4]) {
  const int r0 = row0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int d = 8 * kk + t;
    tf32::split(*reinterpret_cast<const float*>(qt + tile_off<HD, BQ>(r0, d)), qb[kk][0], qs[kk][0]);
    tf32::split(*reinterpret_cast<const float*>(qt + tile_off<HD, BQ>(r0 + 8, d)), qb[kk][1], qs[kk][1]);
    tf32::split(*reinterpret_cast<const float*>(qt + tile_off<HD, BQ>(r0, d + 4)), qb[kk][2], qs[kk][2]);
    tf32::split(*reinterpret_cast<const float*>(qt + tile_off<HD, BQ>(r0 + 8, d + 4)), qb[kk][3], qs[kk][3]);
  }
}

// s = q·kᵀ for one 64-key tile in 3xTF32: the cross terms (q small · K big,
// q big · K small) first, then q big · K big (see the header's numerics).
template <int HD>
__device__ __forceinline__ void issue_s_f32(float (&s)[32], const uint32_t (&qb)[HD / 8][4],
                                            const uint32_t (&qs)[HD / 8][4], const unsigned char* kb,
                                            const unsigned char* ksm) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) hopper::wgmma_m64n64k8_tf32_rs(s, qs[kk], kstep_desc<HD, FBK>(kb, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) hopper::wgmma_m64n64k8_tf32_rs(s, qb[kk], kstep_desc<HD, FBK>(ksm, kk), 1);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) hopper::wgmma_m64n64k8_tf32_rs(s, qb[kk], kstep_desc<HD, FBK>(kb, kk), 1);
  hopper::wgmma_commit();
}

template <int HD>
__device__ __forceinline__ void wgmma_pv_f32(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (HD == 32) hopper::wgmma_m64n32k8_tf32_rs(o, a, b, scale_d);
  if constexpr (HD == 64) hopper::wgmma_m64n64k8_tf32_rs(o, a, b, scale_d);
  if constexpr (HD == 80) hopper::wgmma_m64n80k8_tf32_rs(o, a, b, scale_d);
}

// A tile's p·v into the fresh accumulator op, 3xTF32 in the same order as s.
template <int HD>
__device__ __forceinline__ void issue_pv_f32(float (&op)[HD / 2], const uint32_t (&pb)[8][4],
                                             const uint32_t (&ps)[8][4], const unsigned char* vtb,
                                             const unsigned char* vts) {
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_pv_f32<HD>(op, ps[j], vt_desc<HD>(vtb, j), j > 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_pv_f32<HD>(op, pb[j], vt_desc<HD>(vts, j), 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_pv_f32<HD>(op, pb[j], vt_desc<HD>(vtb, j), 1);
  hopper::wgmma_commit();
}

// p (the s accumulator after the softmax) as split A fragments of the 8 k8
// steps: step j's k index t is key 8j + 2t (accumulator element 4j, and 4j
// + 2 for row g + 8) and t + 4 is key 8j + 2t + 1 (4j + 1, 4j + 3).
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&pb)[8][4], uint32_t (&ps)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    tf32::split(s[4 * j], pb[j][0], ps[j][0]);
    tf32::split(s[4 * j + 2], pb[j][1], ps[j][1]);
    tf32::split(s[4 * j + 1], pb[j][2], ps[j][2]);
    tf32::split(s[4 * j + 3], pb[j][3], ps[j][3]);
  }
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_wgmma(const __grid_constant__ Maps<HD> maps, float* __restrict__ o, int heads, int n,
                    long long ob, long long oh, long long on, float sl2, int n_qblocks, int n_items,
                    float* __restrict__ lse) {
  constexpr int TILE = f32_tile_bytes<HD>();
  constexpr int X = xf_stages<HD>();
  constexpr int R = v_stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs_tile = hopper::aligned_smem(smem_raw);  // [2 TILE]: 128 rows
  unsigned char* xf = qs_tile + 2 * TILE;                    // [X][K, K small, Vᵀ, Vᵀ small]
  unsigned char* vraw = xf + 4 * X * TILE;                   // [R][TILE]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vraw + R * TILE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;   // [X] the K tile landed
  uint64_t* xf_full = k_full + X;   // [X] the split tile is ready
  uint64_t* xf_empty = xf_full + X; // [X] both consumers are done with it
  uint64_t* v_full = xf_empty + X;  // [R]
  uint64_t* v_empty = v_full + R;   // [R]
  const int n_tiles = (n + FBK - 1) / FBK;
  const int wgi = __shfl_sync(FULL, threadIdx.x / 128, 0);  // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 256);
    for (int s = 0; s < X; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(xf_full + s, XF_THREADS);
      hopper::mbar_init(xf_empty + s, 256);
    }
    for (int s = 0; s < R; ++s) {
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(v_empty + s, XF_THREADS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 0) {
    hopper::reg_dealloc<72>();
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
      // Producer: one thread issues every TMA copy.
#pragma unroll
      for (int i = 0; i < Maps<HD>::COUNT; ++i) hopper::prefetch_tensor_map(&maps.m[i]);
      int xs = 0, vs = 0;
      uint32_t xph = 0, vph = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        int bh, qb;
        item_coords<HD>(item, n_qblocks, n_items, bh, qb);
        const int b = bh / heads, h = bh % heads;
        hopper::mbar_wait(q_empty, (it & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, 2 * TILE);
        f32_tma<HD, BQ>(qs_tile, maps, 0, q_full, qb * BQ, h, b);
        for (int t = 0; t < n_tiles; ++t) {
          hopper::mbar_wait(xf_empty + xs, xph ^ 1);
          hopper::mbar_expect_tx(k_full + xs, TILE);
          f32_tma<HD, FBK>(xf + 4 * xs * TILE, maps, 1, k_full + xs, t * FBK, h, b);
          hopper::mbar_wait(v_empty + vs, vph ^ 1);
          hopper::mbar_expect_tx(v_full + vs, TILE);
          f32_tma<HD, FBK>(vraw + vs * TILE, maps, 2, v_full + vs, t * FBK, h, b);
          if (++xs == X) {
            xs = 0;
            xph ^= 1;
          }
          if (++vs == R) {
            vs = 0;
            vph ^= 1;
          }
        }
      }
    } else if (warp > 0) {
      // Transform warps: every tile in the producer's order.
      const int x = threadIdx.x - 32, lane = threadIdx.x & 31;
      int xs = 0, vs = 0;
      uint32_t xph = 0, vph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        for (int t = 0; t < n_tiles; ++t) {
          unsigned char* st = xf + 4 * xs * TILE;
          hopper::mbar_wait(k_full + xs, xph);
          split_k<HD>(st, st + TILE, x);
          hopper::mbar_wait(v_full + vs, vph);
          transpose_v<HD>(vraw + vs * TILE, st + 2 * TILE, st + 3 * TILE, warp - 1, lane);
          hopper::mbar_arrive(v_empty + vs);  // the raw V is read
          hopper::fence_proxy_async();        // the split tile, to the tensor cores
          hopper::mbar_arrive(xf_full + xs);
          if (++xs == X) {
            xs = 0;
            xph ^= 1;
          }
          if (++vs == R) {
            vs = 0;
            vph ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows [64·cw, 64·cw + 64) of the item.
    hopper::reg_alloc<216>();
    const int cw = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = cw * 64 + warp * 16;  // the warp's first row in the Q tile
    if (cw == 1) hopper::named_arrive(1, 256);  // consumer 0 takes the first turn
    int xs = 0;
    uint32_t xph = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      int bh, qb;
      item_coords<HD>(item, n_qblocks, n_items, bh, qb);
      const int b = bh / heads, h = bh % heads;
      uint32_t qfb[HD / 8][4], qfs[HD / 8][4];
      hopper::mbar_wait(q_full, it & 1);
      if constexpr (q_resident<HD>()) {
        load_q<HD>(qs_tile, row0, lane, qfb, qfs);
        hopper::mbar_arrive(q_empty);
      }
      float acc[HD / 2], m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      for (int t = 0; t < n_tiles; ++t) {
        const unsigned char* st = xf + 4 * xs * TILE;
        if constexpr (!q_resident<HD>()) {
          load_q<HD>(qs_tile, row0, lane, qfb, qfs);
          if (t == n_tiles - 1) hopper::mbar_arrive(q_empty);
        }
        float s[32];
        turn_begin(cw);
        hopper::mbar_wait(xf_full + xs, xph);
        issue_s_f32<HD>(s, qfb, qfs, st, st + TILE);
        turn_end(cw);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        softmax_tile(s, m, l, alpha, t * FBK, n, sl2, lane);
        uint32_t pb[8][4], ps[8][4];
        split_p(s, pb, ps);
        float op[HD / 2];
        turn_begin(cw);
        issue_pv_f32<HD>(op, pb, ps, st + 2 * TILE, st + 3 * TILE);
        turn_end(cw);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(op);
        hopper::mbar_arrive(xf_empty + xs);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[(i >> 1) & 1]), op[i]);
        if (++xs == X) {
          xs = 0;
          xph ^= 1;
        }
      }

      // Normalise once and store the rows below n: rows g and g + 8 of the
      // warp's 16, head dims 8j + 2·(lane%4).
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
        inv[i] = 1.0f / l[i];
      }
      float* ob_h = o + b * ob + h * oh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qb * BQ + row0 + (lane >> 2) + 8 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(ob_h + row * on + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
      }
      if constexpr (LSE) store_lse(lse, bh, n, qb * BQ + row0, m, l, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// The tensor maps of q, k and v (shared strides; each part's box and swizzle
// as in the header): bf16 tiles of BKV rows; f32 Q tiles of BQ rows and K
// and V tiles of FBK.
template <int HD, bool BF16>
int encode_maps(Maps<HD>* maps, const void* const (&ptrs)[3], const uint64_t (&dims)[4],
                const uint64_t (&strides)[3]) {
  const CUtensorMapDataType type = BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle lo_swizzle = BF16 && HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle hi_swizzle = BF16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  constexpr uint32_t LO = BF16 ? lo_dims<HD>() : 32;  // head dims of a part
  constexpr uint32_t HI = hi_dims<HD>();               // hd 80's dims 64-79, either type
  for (int i = 0; i < 3; ++i) {
    const uint32_t rows = BF16 ? BKV : (i == 0 ? BQ : FBK);
    const uint32_t box[4] = {LO, rows, 1, 1};
    int r = hopper::encode_tensor_map(&maps->m[i], 4, ptrs[i], dims, strides, box, type, lo_swizzle);
    if constexpr (HI > 0) {
      const uint32_t hi_box[4] = {HI, rows, 1, 1};
      if (r == 0)
        r = hopper::encode_tensor_map(&maps->m[3 + i], 4, ptrs[i], dims, strides, hi_box, type, hi_swizzle);
    }
    if (r != 0) return r;
  }
  return 0;
}

// K3 at one width and type on `device` (the current device): the tensor
// maps, the shared-memory attribute (once per device) and a persistent grid
// of one CTA per SM. Returns 0, a cudaError_t or a hopper::ERR_* code.
template <int HD, bool BF16, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads, int n,
           const Layout& lay, float scale, int device, cudaStream_t stream, float* lse) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr uint64_t ELT = BF16 ? 2 : 4;
  const void* const ptrs[3] = {q, k, v};
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(n), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(lay.sn) * ELT, static_cast<uint64_t>(lay.sh) * ELT,
                               static_cast<uint64_t>(lay.sb) * ELT};
  Maps<HD> maps;
  const int r = encode_maps<HD, BF16>(&maps, ptrs, dims, strides);
  if (r != 0) return r;
  const int n_qblocks = (n + BQ - 1) / BQ;
  const int n_items = n_qblocks * batch * heads;
  const float sl2 = scale * 1.4426950408889634f;
  const int sms = hopper::sm_count(device);
  const int grid = sms > 0 && sms < n_items ? sms : n_items;
  cudaError_t e;
  if constexpr (BF16) {
    constexpr int SMEM = smem_bytes<HD>();
    e = hopper::allow_smem_once(flash_bf16_wgmma<HD, LSE>, SMEM, device, smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bf16_wgmma<HD, LSE><<<grid, THREADS, SMEM, stream>>>(maps, static_cast<__nv_bfloat16*>(o), heads, n,
                                                               lay.ob, lay.oh, lay.on, sl2, n_qblocks, n_items,
                                                               lse);
  } else {
    constexpr int SMEM = f32_smem_bytes<HD>();
    e = hopper::allow_smem_once(flash_f32_wgmma<HD, LSE>, SMEM, device, smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_f32_wgmma<HD, LSE><<<grid, THREADS, SMEM, stream>>>(maps, static_cast<float*>(o), heads, n, lay.ob,
                                                              lay.oh, lay.on, sl2, n_qblocks, n_items, lse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// K3 on `stream` of device `device`, writing each row's log-sum-exp to lse
// where LSE (the backward's residual).
template <bool LSE>
int launch_entry(const void* q, const void* k, const void* v, void* o, int batch, int heads, int n, int hd,
                 long long sb, long long sh, long long sn, long long ob, long long oh, long long on, float scale,
                 int is_bf16, int device, void* stream, float* lse) {
  // Any number of (b, h) pairs: the items, (b, h, 128-query block), are walked by
  // persistent CTAs and only their count has to fit the kernel's int index.
  if (batch < 1 || heads < 1 || n < 1 ||
      static_cast<long long>((n + wg::BQ - 1) / wg::BQ) * batch * heads > hopper::MAX_ITEMS)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Layout lay{sb, sh, sn, ob, oh, on};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r = static_cast<int>(cudaErrorInvalidValue);
  switch (hd * 2 + (is_bf16 ? 1 : 0)) {
    case 65: r = wg::launch<32, true, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    case 129: r = wg::launch<64, true, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    case 161: r = wg::launch<80, true, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    case 64: r = wg::launch<32, false, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    case 128: r = wg::launch<64, false, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    case 160: r = wg::launch<80, false, LSE>(q, k, v, o, batch, heads, n, lay, scale, device, s, lse); break;
    default: break;
  }
  if (current != device) cudaSetDevice(current);
  return r;
}

}  // namespace

// Launch K3 on `stream` of device `device`. q, k, v are (batch, heads, n,
// hd) arrays with one shared set of element strides (sb, sh, sn) and a unit
// stride along hd; o has strides (ob, oh, on) and a unit stride along hd.
// All f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); hd is 32, 64 or 80;
// pointers and strides are 16-byte aligned. n >= 1, and ⌈n / 128⌉ ·
// batch · heads (the work items) at most hopper::MAX_ITEMS, else
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch (0 =
// launched), or 9001 / 9002 when the tensor maps cannot be encoded.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int n, int hd, long long sb, long long sh,
                                 long long sn, long long ob, long long oh, long long on,
                                 float scale, int is_bf16, int device, void* stream) {
  return launch_entry<false>(q, k, v, o, batch, heads, n, hd, sb, sh, sn, ob, oh, on, scale, is_bf16, device,
                             stream, nullptr);
}

// flash_attn_launch, and each row's log-sum-exp of s·scale into lse, a
// contiguous (batch, heads, n) f32 array: the forward under autograd, whose
// residual the backward (flash_bwd.cu) reads. The output is the same, bit
// for bit.
extern "C" int flash_attn_launch_lse(const void* q, const void* k, const void* v, void* o, int batch,
                                     int heads, int n, int hd, long long sb, long long sh,
                                     long long sn, long long ob, long long oh, long long on,
                                     float scale, int is_bf16, int device, void* stream, void* lse) {
  return launch_entry<true>(q, k, v, o, batch, heads, n, hd, sb, sh, sn, ob, oh, on, scale, is_bf16, device,
                            stream, static_cast<float*>(lse));
}

// Dynamic shared memory K3 asks for at head width hd in bf16 (is_bf16 = 1)
// or f32 (0 at a width it does not take).
extern "C" int flash_attn_wgmma_smem(int hd, int is_bf16) {
  switch (hd * 2 + (is_bf16 ? 1 : 0)) {
    case 65: return wg::smem_bytes<32>();
    case 129: return wg::smem_bytes<64>();
    case 161: return wg::smem_bytes<80>();
    case 64: return wg::f32_smem_bytes<32>();
    case 128: return wg::f32_smem_bytes<64>();
    case 160: return wg::f32_smem_bytes<80>();
    default: return 0;
  }
}
