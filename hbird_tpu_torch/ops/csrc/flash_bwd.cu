// K3-bwd: the flash attention backward — dk, dv and dq of
// softmax(q·kᵀ·scale)·v over (B, H, N, hd), without writing the (B, H, N, N)
// probabilities or their gradient.
//
// Replaces the TPU kernels behind the library's VJP of
// jax/experimental/pallas/ops/tpu/flash_attention.py (`_flash_attention_bwd`):
// `_flash_attention_dkv_kernel` (dk, dv) and `_flash_attention_dq_kernel`
// (dq), the backward of the Pallas flash attention that
// hbird_tpu/models/vit.py::_flash_attention calls. As there, the work is
// split in two kernels with no atomics, so two runs give the same bits:
// - `flash_bwd_dkv`: a work item owns a block of keys of one (b, h) and
//   walks every query tile, accumulating dk and dv of its keys in registers;
// - `flash_bwd_dq`: an item owns a block of queries and walks every key
//   tile, accumulating dq.
// Both recompute s and p from q, k and the forward's per-row log-sum-exp
// (flash_attn.cu's `LSE` instances write it), as the library recomputes
// them from m and l. di = Σ o·do comes in from the wrapper (a torch op, as
// the library computes it outside its kernels). The numerics are the
// library kernels': s = q·kᵀ in f32 then times scale, p = exp(s - lse), p
// cast to do's dtype for dv = pᵀ·do, dp = do·vᵀ in f32, ds = (dp - di)·p·
// scale cast to the input dtype for dk = dsᵀ·q and dq = ds·k, every product
// accumulated in f32 and each output cast once (ops/flash.py, the plain
// version, has them in torch). p is exp2(s·scale·log2(e) - lse·log2(e)).
//
// What bounds it on an H100: operations. The two kernels do 14·B·H·N²·hd
// flops (s and dp twice, dv, dk, dq; the least work is 10·B·H·N²·hd) on
// 8·B·H·N·hd elements moved; at the ViT-B/14 main shape (16, 12, 1370, 64)
// that is ~1,200 flops per bf16 byte (dK/dV alone 8 flops on 6 tensors,
// ~910; dQ 6 on 5, ~820), far above the ~295 at which the card stops being
// memory bound. So every product goes on the tensor cores, and p and ds
// never leave registers.
//
// Rows past N: streamed query rows arrive as zeros and take lse = +inf, so
// their p and ds are 0; streamed key columns at or past N get p = 0; owned
// rows past N are never stored. Any N >= 1 runs (N = 257's last key tile
// holds one key).
//
// bf16, `wg::flash_bwd_dkv<__nv_bfloat16, HD>` and
// `wg::flash_bwd_dq<__nv_bfloat16, HD>` at hd 32, 64 and 80: wgmma + TMA
// (hopper.cuh), the frame of K3's bf16 forward (flash_attn.cu).
// - One template (wg::bwd_body) serves both: an item owns 128 rows of one
//   (b, h) (keys for dK/dV, queries for dQ; two consumer warpgroups of 64)
//   through a pair of owned tiles (K and V; Q and dO) and streams 64-row
//   tiles of the other pair (Q and dO; K and V) through a ring of STAGES
//   mbarrier stages. Persistent CTAs, one per SM, walk the items, the
//   blocks of one head adjacent (its streamed tiles stay in L2); so B·H has
//   no limit but the item count's int. One producer thread issues every
//   copy by TMA from 4-D (hd, N, H, B) tensor maps built from the strides
//   (q, k and v's shared ones; do's own), rows past N arriving as zeros;
//   the owned pair is double-buffered so the next item's arrives while
//   this one runs. dK/dV's streamed queries also need their lse and di:
//   warp 1 of the producer warpgroup writes them into the stage (lse·log2(e),
//   +inf past N; di, 0 past N) and arrives on its full barrier beside the
//   TMA's transaction.
// - Products: x = A0·S0ᵀ and y = A1·S1ᵀ (sᵀ = K·Qᵀ and dpᵀ = V·dOᵀ; s = Q·Kᵀ
//   and dp = dO·Vᵀ) are m64n64k16 with B, the streamed tile, K-major in
//   swizzled shared memory (A below). p and ds are formed in place in those accumulators and
//   cast to bf16 A fragments (the accumulator's layout is the A
//   fragment's, as K3's forward casts p): dV += pᵀ·dO and dK += dsᵀ·Q, and
//   dQ += ds·K, are m64n{HD}k16 with A in registers and B the streamed
//   tile read MN-major (the transpose bit) through a second descriptor of
//   the same swizzled tile that was K-major B a moment before. No
//   ldmatrix, no shared-memory round trip of p or ds, nothing transposed
//   by hand: the mma.sync form this replaced read that B two 16-bit values
//   a pair.
// - x's and y's A operands (the owned rows) are loaded into registers once
//   an item (load_a, from the swizzled tile), so those products read only
//   B from shared memory: with both operands there, m64n64k16 needs the
//   shared memory's whole bandwidth at the tensor cores' rate.
// - Overlap, kept by measurement (PERF.md): tile t's x and y are issued
//   before tile t-1's register-A products, so p and ds of tile t are
//   computed while those run; and the two consumer warpgroups take turns
//   issuing products (ping-pong on named barriers, as K3's forward), so
//   one's p and ds run under the other's products.
// - Registers: x and y 32 f32 each a thread, dK and dV HD/2 each (dQ one
//   HD/2), the A fragments of p and ds 16 each and of the owned rows HD/4
//   each (dK/dV at hd 80 keeps V in shared memory: with it in registers
//   the consumers would need ~250); the producer warpgroup gives its
//   registers to the consumers (setmaxnreg 40 / 232).
// - hd 80 and hd 32 as in K3's forward: hd 80's 160-byte rows are two
//   parts, head dims 0-63 under the 128-byte swizzle and 64-79 under the
//   32-byte one (two tensor maps a tensor, both completing on the tile's
//   barrier; m64n64k16 + m64n16k16 for the register products); hd 32's
//   64-byte rows take the 64-byte swizzle (m64n32k16).
// - A consumer warpgroup whose 64 owned rows all lie at or past N (a short
//   last block) issues no products and only keeps its turns and barrier
//   arrivals.
// - Accumulation: dK, dV and dQ are accumulated across the streamed tiles
//   in the wgmma accumulators, a chain of truncating tensor-core adds (4 k16
//   steps a tile; 88 at N = 1,370). Each add loses at most an f32 ulp of
//   the running sum, ~2^-16 of it over the chain, far below the bf16
//   output's 2^-8 ulp, so the bf16 tolerance (4 ulps at the row's scale)
//   holds as it is and the registers a separate per-tile accumulator would
//   take stay free.
//
// f32, `flash_bwd_dkv<float, HD>` and `flash_bwd_dq<float, HD>`: mma.sync,
// simple and right, not fast (its redesign takes wgmma with transform
// warps, as K3's f32 forward does): a CTA owns a 64-row tile
// of one (b, h) (grid x walks (b·h, tile), so any B·H runs), four warps of
// 16 rows, every product an m16n8k8 in TF32 with each operand split by
// tf32.cuh into big and small parts (3xTF32), a product's cross terms over
// the whole depth issued before its big·big terms, since the tensor cores
// add rounding toward zero; the fragments are loaded from padded shared
// memory a value at a time, which reads the transposed operands of dv, dk
// and dq in place (wgmma's tf32 form takes K-major operands only). A 64-row
// tile of dk, dv or dq is added into its f32 accumulator once per streamed
// tile, rounding to nearest, so no chain of truncating adds runs longer
// than one tile.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed rings with a producer warp, persistent CTAs.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BR = 128;       // rows an item owns: keys (dK/dV) or queries (dQ), 64 a consumer warpgroup
constexpr int BS = 64;        // rows of a streamed tile: queries (dK/dV) or keys (dQ)
constexpr int STAGES = 6;     // streamed ring depth
constexpr int OBUF = 2;       // owned tile pairs in flight
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// Consumer warpgroup `cw`'s turn to issue products (ping-pong): named
// barrier 1 + cw, completed by the other warpgroup's arrival.
__device__ __forceinline__ void turn_begin(int cw) { hopper::named_sync(1 + cw, 256); }

__device__ __forceinline__ void turn_end(int cw) { hopper::named_arrive(2 - cw, 256); }

// A row's head dims in a tile's first part (128- or 64-byte swizzle) and in
// its second (hd 80's dims 64-79, the 32-byte swizzle; none otherwise).
template <int HD>
__host__ __device__ constexpr int lo_dims() {
  return HD == 80 ? 64 : HD;
}
template <int HD>
__host__ __device__ constexpr int hi_dims() {
  return HD - lo_dims<HD>();
}
template <int HD, int ROWS>
__host__ __device__ constexpr int lo_bytes() {
  return ROWS * lo_dims<HD>() * 2;
}
template <int HD, int ROWS>
__host__ __device__ constexpr int tile_bytes() {
  return ROWS * HD * 2;
}

// The owned pairs, the ring of streamed pairs, dK/dV's per-stage lse and di
// rows, and the barriers.
template <int HD, bool DKV>
__host__ __device__ constexpr int smem_bytes() {
  return hopper::SMEM_ALIGN + 2 * OBUF * tile_bytes<HD, BR>() + 2 * STAGES * tile_bytes<HD, BS>() +
         (DKV ? STAGES * 2 * BS * 4 : 0) + 256;
}

// Tensor maps: the owned pair (boxes of BR rows: k, v for dK/dV; q, do for
// dQ), the streamed pair (boxes of BS rows: q, do; k, v), then at hd 80
// the same four for head dims 64-79.
template <int HD>
struct Maps {
  static constexpr int COUNT = hi_dims<HD>() ? 8 : 4;
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

// Rows row0.. of (b, h) of tensor map i into the ROWS-row tile at dst,
// completing on bar: one TMA copy a part.
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const Maps<HD>& maps, int i, uint64_t* bar, int row0,
                                         int h, int b) {
  hopper::tma_load_4d(dst, &maps.m[i], bar, 0, row0, h, b);
  if constexpr (hi_dims<HD>() > 0)
    hopper::tma_load_4d(dst + lo_bytes<HD, ROWS>(), &maps.m[4 + i], bar, lo_dims<HD>(), row0, h, b);
}

// Whether y's A operand (V for dK/dV, dO for dQ) is held in registers like
// x's: everywhere but dK/dV at hd 80, where 40 more registers beside dK and
// dV (40 each) would spill; there it is read from shared memory.
template <int HD, bool DKV>
__host__ __device__ constexpr bool y_in_regs() {
  return !(DKV && HD == 80);
}

// Byte offset of head dims d, d + 1 (d even) of row `row` in a BR-row
// owned tile as TMA wrote it: 128-byte rows' 16-byte unit u at u ^ (row %
// 8), 64-byte rows' at u ^ (row / 2 % 4), hd 80's second part (32-byte
// rows) at u ^ (row / 4 % 2).
template <int HD>
__device__ __forceinline__ int a_off(int row, int d) {
  if (d >= lo_dims<HD>()) {
    const int c = (d - lo_dims<HD>()) * 2;
    return lo_bytes<HD, BR>() + row * 32 + ((((c >> 4) ^ (row >> 2)) & 1) << 4) + (c & 15);
  }
  const int c = d * 2;
  if constexpr (HD == 32) return row * 64 + ((((c >> 4) ^ (row >> 1)) & 3) << 4) + (c & 15);
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

// Rows row0 + g and row0 + g + 8 (lane = 4g + t) of an owned tile as bf16 A
// fragments of its HD / 16 k16 steps: a0 (row g, dims 16kk + 2t, + 1), a1
// (g + 8, the same), a2 and a3 8 dims on. Loaded once an item.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&f)[HD / 16][4], const unsigned char* tile, int row0, int lane) {
  const int r = row0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = *reinterpret_cast<const uint32_t*>(tile + a_off<HD>(r + 8 * (i & 1), 16 * kk + 8 * (i >> 1) + 2 * t));
}

// acc (64 x 64) = the owned rows' A fragments `a` times the streamed tile
// `st` transposed, over the head dims: k16 steps of 32 bytes inside each
// part's rows, B K-major.
template <int HD>
__device__ __forceinline__ void issue_rs_k(float (&acc)[32], const uint32_t (&a)[HD / 16][4],
                                           const unsigned char* st) {
#pragma unroll
  for (int kk = 0; kk < lo_dims<HD>() / 16; ++kk)
    hopper::wgmma_m64n64k16_rs(acc, a[kk], desc<HD>(st + kk * 32), kk > 0);
  if constexpr (hi_dims<HD>() > 0)
    hopper::wgmma_m64n64k16_rs(acc, a[HD / 16 - 1], hopper::sw32_desc(st + lo_bytes<HD, BS>()), 1);
}

// The same with A read from rows [64·cw, 64·cw + 64) of the owned tile
// `own` in shared memory, both operands K-major.
template <int HD>
__device__ __forceinline__ void issue_ss(float (&acc)[32], const unsigned char* own, int cw,
                                         const unsigned char* st) {
  const unsigned char* a = own + cw * (64 * lo_dims<HD>() * 2);
#pragma unroll
  for (int kk = 0; kk < lo_dims<HD>() / 16; ++kk)
    hopper::wgmma_m64n64k16_ss(acc, desc<HD>(a + kk * 32), desc<HD>(st + kk * 32), kk > 0);
  if constexpr (hi_dims<HD>() > 0)
    hopper::wgmma_m64n64k16_ss(acc, hopper::sw32_desc(own + lo_bytes<HD, BR>() + cw * 64 * 32),
                               hopper::sw32_desc(st + lo_bytes<HD, BS>()), 1);
}

// acc (64 x HD) += a (A fragments of 64 rows by the tile's 64 streamed rows,
// 4 k16 steps) · the streamed tile st (64 x HD) read MN-major: a k16 step
// is 16 of its rows (2,048 bytes at 128-byte rows, 1,024 at 64; at hd 80
// also 512 bytes of the 32-byte second part, into acc's last 8 floats).
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2], const uint32_t (&a)[4][4], const unsigned char* st) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    if constexpr (HD == 32) {
      hopper::wgmma_m64n32k16_rs_tb(acc, a[kk], desc<HD>(st + kk * 16 * HD * 2), 1);
    } else if constexpr (HD == 64) {
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], desc<HD>(st + kk * 16 * HD * 2), 1);
    } else {
      hopper::wgmma_m64n64k16_rs_tb(*reinterpret_cast<float(*)[32]>(acc), a[kk], desc<HD>(st + kk * 16 * 128), 1);
      hopper::wgmma_m64n16k16_rs_tb(*reinterpret_cast<float(*)[8]>(acc + 32), a[kk],
                                    hopper::sw32_desc(st + lo_bytes<HD, BS>() + kk * 16 * 32), 1);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An accumulator of 64 columns as bf16 A fragments of 4 k16 steps: columns
// 16kk.. are accumulator groups 2kk and 2kk + 1.
__device__ __forceinline__ void pack(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// The two products of a streamed tile's first half: x = A0·S0ᵀ and y =
// A1·S1ᵀ, A0 from the fragments f0, A1 from f1 or (y_in_regs false) from
// the owned tile in shared memory.
template <int HD, bool DKV>
__device__ __forceinline__ void issue_xy(float (&x)[32], float (&y)[32], const uint32_t (&f0)[HD / 16][4],
                                         const uint32_t (&f1)[HD / 16][4], const unsigned char* own, int cw,
                                         const unsigned char* st) {
  hopper::wgmma_fence();
  issue_rs_k<HD>(x, f0, st);
  if constexpr (y_in_regs<HD, DKV>())
    issue_rs_k<HD>(y, f1, st + tile_bytes<HD, BS>());
  else
    issue_ss<HD>(y, own + tile_bytes<HD, BR>(), cw, st + tile_bytes<HD, BS>());
  hopper::wgmma_commit();
}

// Its second half: acc_a += fds·S0 (dK += dsᵀ·Q; dQ += ds·K) and, for
// dK/dV, acc_b += fp·S1 (dV += pᵀ·dO).
template <int HD, bool DKV, int NB>
__device__ __forceinline__ void issue_grads(float (&acc_a)[HD / 2], float (&acc_b)[NB], const uint32_t (&fds)[4][4],
                                            const uint32_t (&fp)[4][4], const unsigned char* st) {
  hopper::wgmma_fence();
  issue_rs<HD>(acc_a, fds, st);
  if constexpr (DKV) issue_rs<HD>(acc_b, fp, st + tile_bytes<HD, BS>());
  hopper::wgmma_commit();
}

// p and ds of one streamed tile in place (x becomes p, y ds), in f32.
// Accumulator element 4j + e: owned row g (e < 2) or g + 8 of the warp's 16,
// streamed row 8j + 2·(lane % 4) + (e & 1) of the tile (first row r0).
// dK/dV: the lse (times log2(e)) and di of each streamed query from the
// stage's rows; dQ: the owned query's from registers, and key columns at or
// past n get p = 0.
template <bool DKV>
__device__ __forceinline__ void grads(float (&x)[32], float (&y)[32], const float* lse_di, const float (&lse2)[2],
                                      const float (&dii)[2], int r0, int n, float scale, float sl2, int lane) {
  const int t = lane & 3;
  const bool ragged = !DKV && r0 + BS > n;
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) {
    float l[2], d[2];
    if constexpr (DKV) {
      const float2 lv = *reinterpret_cast<const float2*>(lse_di + 8 * j + 2 * t);
      const float2 dv = *reinterpret_cast<const float2*>(lse_di + BS + 8 * j + 2 * t);
      l[0] = lv.x, l[1] = lv.y, d[0] = dv.x, d[1] = dv.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float le = DKV ? l[e & 1] : lse2[e >> 1];
      const float de = DKV ? d[e & 1] : dii[e >> 1];
      float p = ex2(fmaf(x[4 * j + e], sl2, -le));
      if (ragged && r0 + 8 * j + 2 * t + (e & 1) >= n) p = 0.0f;
      y[4 * j + e] = p * (y[4 * j + e] - de) * scale;
      x[4 * j + e] = p;
    }
  }
}

// The warp's 16 rows of an accumulator (rows row0 + g and + 8) into the
// contiguous (b, h) matrix out (n rows of HD), rows below n, in bf16.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[HD / 2], int row0, int n,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * HD + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// One bf16 kernel: DKV, dk (out0) and dv (out1) of items of 128 keys; else
// dq (out0) of items of 128 queries. Items (b·heads + h, block) with the
// blocks of one head adjacent.
template <int HD, bool DKV>
__device__ __forceinline__ void bwd_body(const Maps<HD>& maps, const float* __restrict__ lse,
                                         const float* __restrict__ di, __nv_bfloat16* __restrict__ out0,
                                         __nv_bfloat16* __restrict__ out1, int heads, int n, float scale, float sl2,
                                         int n_blocks, int n_items) {
  constexpr int OWN = tile_bytes<HD, BR>(), ST = tile_bytes<HD, BS>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own = hopper::aligned_smem(smem_raw);              // [OBUF][A0, A1]
  unsigned char* ring = own + OBUF * 2 * OWN;                       // [STAGES][S0, S1]
  float* rows = reinterpret_cast<float*>(ring + STAGES * 2 * ST);   // dK/dV: [STAGES][lse·log2(e), di][BS]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(rows + (DKV ? STAGES * 2 * BS : 0));  // [OBUF]
  uint64_t* own_empty = own_full + OBUF;                                                  // [OBUF]
  uint64_t* full = own_empty + OBUF;                                                      // [STAGES]
  uint64_t* empty = full + STAGES;                                                        // [STAGES]
  const int n_tiles = (n + BS - 1) / BS;
  const int wgi = __shfl_sync(FULL, threadIdx.x / 128, 0);  // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    for (int i = 0; i < OBUF; ++i) {
      hopper::mbar_init(own_full + i, 1);
      hopper::mbar_init(own_empty + i, 256);
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, DKV ? 1 + 32 : 1);  // dK/dV: the TMA thread and warp 1's lanes
      hopper::mbar_init(empty + s, 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 0) {
    hopper::reg_dealloc<40>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      // Producer: one thread issues every TMA copy.
#pragma unroll
      for (int i = 0; i < Maps<HD>::COUNT; ++i) hopper::prefetch_tensor_map(&maps.m[i]);
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_blocks, blk = item % n_blocks;
        const int b = bh / heads, h = bh % heads;
        const int ob = it % OBUF;
        unsigned char* a = own + ob * 2 * OWN;
        hopper::mbar_wait(own_empty + ob, ((it / OBUF) & 1) ^ 1);
        hopper::mbar_expect_tx(own_full + ob, 2 * OWN);
        tma_tile<HD, BR>(a, maps, 0, own_full + ob, blk * BR, h, b);
        tma_tile<HD, BR>(a + OWN, maps, 1, own_full + ob, blk * BR, h, b);
        for (int t = 0; t < n_tiles; ++t) {
          unsigned char* s = ring + stage * 2 * ST;
          hopper::mbar_wait(empty + stage, phase ^ 1);
          hopper::mbar_expect_tx(full + stage, 2 * ST);
          tma_tile<HD, BS>(s, maps, 2, full + stage, t * BS, h, b);
          tma_tile<HD, BS>(s + ST, maps, 3, full + stage, t * BS, h, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (DKV && warp == 1) {
      // The streamed queries' lse (times log2(e), +inf past n) and di (0
      // past n) into each stage, two rows a lane, in the producer's order.
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const long long base = static_cast<long long>(item / n_blocks) * n;
        for (int t = 0; t < n_tiles; ++t) {
          float* r = rows + stage * 2 * BS;
          hopper::mbar_wait(empty + stage, phase ^ 1);
#pragma unroll
          for (int i = lane; i < BS; i += 32) {
            const int q = t * BS + i;
            r[i] = q < n ? lse[base + q] * LOG2E : pos_inf();
            r[BS + i] = q < n ? di[base + q] : 0.0f;
          }
          hopper::mbar_arrive(full + stage);  // releases the writes to the consumers
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows [64·cw, 64·cw + 64) of the item.
    hopper::reg_alloc<232>();
    const int cw = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int NB = DKV ? HD / 2 : 1;
    if (cw == 1) hopper::named_arrive(1, 256);  // consumer 0 takes the first turn
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_blocks, blk = item % n_blocks;
      const int ob = it % OBUF;
      const unsigned char* a = own + ob * 2 * OWN;
      const long long base = static_cast<long long>(bh) * n;  // (b, h)'s first row of lse, di and the outputs
      const int row0 = blk * BR + cw * 64 + warp * 16;       // the warp's first owned row
      float lse2[2] = {0.0f, 0.0f}, dii[2] = {0.0f, 0.0f};    // dQ: the warp's rows g and g + 8
      if constexpr (!DKV) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + (lane >> 2) + 8 * i;
          lse2[i] = row < n ? lse[base + row] * LOG2E : pos_inf();
          dii[i] = row < n ? di[base + row] : 0.0f;
        }
      }
      float acc_a[HD / 2], acc_b[NB];  // dK and dV; dQ
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc_a[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NB; ++i) acc_b[i] = 0.0f;
      hopper::mbar_wait(own_full + ob, (it / OBUF) & 1);
      if (blk * BR + cw * 64 >= n) {
        // Every owned row of this warpgroup lies at or past n: no products,
        // but the turns, waits and arrivals of a working warpgroup.
        for (int t = 0; t <= n_tiles; ++t) {
          turn_begin(cw);
          if (t < n_tiles) hopper::mbar_wait(full + stage, phase);
          turn_end(cw);
          if (t == n_tiles) break;
          hopper::mbar_arrive(empty + stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      } else {
        float x[32], y[32];
        uint32_t f0[HD / 16][4], f1[HD / 16][4], fds[4][4], fp[4][4];
        load_a<HD>(f0, a, cw * 64 + warp * 16, lane);
        if constexpr (y_in_regs<HD, DKV>()) load_a<HD>(f1, a + OWN, cw * 64 + warp * 16, lane);
        // Tile 0: its x and y, then p and ds.
        turn_begin(cw);
        hopper::mbar_wait(full + stage, phase);
        issue_xy<HD, DKV>(x, y, f0, f1, a, cw, ring + stage * 2 * ST);
        turn_end(cw);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(x);
        hopper::fence_regs(y);
        grads<DKV>(x, y, rows + stage * 2 * BS, lse2, dii, 0, n, scale, sl2, lane);
        pack(fds, y);
        if constexpr (DKV) pack(fp, x);
        int prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        for (int t = 1; t < n_tiles; ++t) {
          // x and y of tile t, then the gradients' products of tile t - 1;
          // p and ds of tile t are formed while those run.
          turn_begin(cw);
          hopper::mbar_wait(full + stage, phase);
          issue_xy<HD, DKV>(x, y, f0, f1, a, cw, ring + stage * 2 * ST);
          issue_grads<HD, DKV>(acc_a, acc_b, fds, fp, ring + prev * 2 * ST);
          turn_end(cw);
          hopper::wgmma_wait<1>();
          hopper::fence_regs(x);
          hopper::fence_regs(y);
          grads<DKV>(x, y, rows + stage * 2 * BS, lse2, dii, t * BS, n, scale, sl2, lane);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc_a);
          hopper::fence_regs(acc_b);
          hopper::mbar_arrive(empty + prev);
          pack(fds, y);
          if constexpr (DKV) pack(fp, x);
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        turn_begin(cw);
        issue_grads<HD, DKV>(acc_a, acc_b, fds, fp, ring + prev * 2 * ST);
        turn_end(cw);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc_a);
        hopper::fence_regs(acc_b);
        hopper::mbar_arrive(empty + prev);
      }
      hopper::mbar_arrive(own_empty + ob);
      store_rows<HD>(out0 + base * HD, acc_a, row0, n, lane);
      if constexpr (DKV) store_rows<HD>(out1 + base * HD, acc_b, row0, n, lane);
    }
  }
}

// dk and dv of bf16 attention: persistent CTAs over (b·h, 128-key block)
// items. T is bf16; the f32 kernels of the same names (mma.sync) are below.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv(const __grid_constant__ Maps<HD> maps, const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int heads, int n, float scale, float sl2, int n_blocks,
                  int n_items) {
  static_assert(sizeof(T) == 2, "the wgmma kernel is bf16's");
  bwd_body<HD, true>(maps, lse, di, dk, dv, heads, n, scale, sl2, n_blocks, n_items);
}

// dq of bf16 attention: persistent CTAs over (b·h, 128-query block) items.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq(const __grid_constant__ Maps<HD> maps, const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int heads, int n, float scale, float sl2, int n_blocks, int n_items) {
  static_assert(sizeof(T) == 2, "the wgmma kernel is bf16's");
  bwd_body<HD, false>(maps, lse, di, dq, nullptr, heads, n, scale, sl2, n_blocks, n_items);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync.
// ---------------------------------------------------------------------------

constexpr int BM = 64;       // rows a CTA owns: keys (dk, dv) or queries (dq)
constexpr int BN = 64;       // rows of a streamed tile: queries (dk, dv) or keys (dq)
constexpr int WARPS = 4;     // each owns 16 of the BM rows
constexpr int THREADS = 32 * WARPS;

// Strides in elements: q, k and v share one set, do has its own; the
// outputs, lse and di are contiguous.
struct Strides {
  long long sb, sh, sn, db, dh, dn;
};

// Shared-memory row pitch, in floats, of an HD-wide tile and of a warp's
// 16 x BN tile of p or ds: 16 bytes of padding.
template <int HD>
__host__ __device__ constexpr int tile_pitch() {
  return HD + 4;
}
constexpr int SCRATCH_PITCH = BN + 4;

// Dynamic shared memory: four HD-wide tiles (two owned, two streamed), a
// warp's p and ds tiles (dk, dv) or its ds tile (dq), and the streamed
// queries' lse and di (dk, dv).
template <int HD, bool DKV>
__host__ __device__ constexpr int f32_smem_bytes() {
  return 4 * BM * tile_pitch<HD>() * 4 + (DKV ? 2 : 1) * WARPS * 16 * SCRATCH_PITCH * 4 + (DKV ? 2 * BN * 4 : 0);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16][8·NT] += A[16][K] · B[K][8·NT] for one warp in 3xTF32: A row-major
// (the depth contiguous) at a with pitch pa; B stored transposed as
// Bt[8·NT][K] (BT, the depth contiguous) or as B[K][8·NT], at b with pitch
// pb. The cross terms (A small · B big, A big · B small) over the whole
// depth first, then A big · B big. Fragment element (row g or g + 8,
// column 8j + 2t or + 1) is c[j][0..3], with g = lane / 4 and t = lane % 4.
template <int NT, int K, bool BT>
__device__ __forceinline__ void mma_tile(float (&c)[NT][4], const float* a, int pa, const float* b, int pb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ab[4], as[4];
      tf32::split(a[g * pa + k0 + t], ab[0], as[0]);
      tf32::split(a[(g + 8) * pa + k0 + t], ab[1], as[1]);
      tf32::split(a[g * pa + k0 + t + 4], ab[2], as[2]);
      tf32::split(a[(g + 8) * pa + k0 + t + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float x0 = BT ? b[(8 * j + g) * pb + k0 + t] : b[(k0 + t) * pb + 8 * j + g];
        const float x1 = BT ? b[(8 * j + g) * pb + k0 + t + 4] : b[(k0 + t + 4) * pb + 8 * j + g];
        uint32_t bb[2], bs[2];
        tf32::split(x0, bb[0], bs[0]);
        tf32::split(x1, bb[1], bs[1]);
        if (pass == 0) {
          mma_tf32(c[j], as, bb);
          mma_tf32(c[j], ab, bs);
        } else {
          mma_tf32(c[j], ab, bb);
        }
      }
    }
  }
}

// acc += A·B over one streamed tile, B stored as B[K][8·NT]: mma_tile into
// a fresh accumulator, then one f32 add a value, rounding to nearest.
template <int NT, int K>
__device__ __forceinline__ void add_tile(float (&acc)[NT][4], const float* a, int pa, const float* b, int pb,
                                         int lane) {
  float part[NT][4] = {};
  mma_tile<NT, K, false>(part, a, pa, b, pb, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// Rows row0.. of one (b, h) matrix (row stride sn, unit stride along hd) into
// a BM-row tile of pitch tile_pitch<HD>, rows at or past n as zeros: 16
// bytes a thread at a time.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn, int row0, int n) {
  constexpr int CH = HD / 4;  // 16-byte units a row
  for (int c = threadIdx.x; c < BM * CH; c += THREADS) {
    const int r = c / CH, u = c % CH;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) x = reinterpret_cast<const float4*>(src + (row0 + r) * sn)[u];
    reinterpret_cast<float4*>(dst + r * tile_pitch<HD>())[u] = x;
  }
}

// Two adjacent values.
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// The warp's 16 rows of an accumulator (f32, fragment layout) into the
// contiguous (b, h) matrix out (n rows of HD), rows row0.. below n.
template <int HD>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[HD / 8][4], int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) store2(out + row * HD + 8 * j + 2 * t, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// dk and dv of one 64-key tile of one (b, h): blockIdx.x = (b·heads + h) ·
// n_tiles + tile. T is float (bf16 runs wg::flash_bwd_dkv). Two CTAs an
// SM (at most two fit beside their shared memory at hd 64 and 80), which
// leaves each thread up to 255 registers; with no such bound ptxas kept the
// hd-80 dQ kernel to 168 and spilled.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int heads, int n, Strides st, float scale, float sl2) {
  static_assert(sizeof(T) == 4, "the mma.sync kernel is f32's");
  constexpr int TP = tile_pitch<HD>(), SP = SCRATCH_PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BM * TP;
  T* qs = vs + BM * TP;
  T* dos = qs + BN * TP;
  T* ps = dos + BN * TP;             // [WARPS][16][SP] pᵀ
  T* dss = ps + WARPS * 16 * SP;     // [WARPS][16][SP] dsᵀ
  float* lse_s = dss + WARPS * 16 * SP;  // [BN] lse·log2(e), +inf past n
  float* di_s = lse_s + BN;              // [BN] di, 0 past n
  const int n_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / n_tiles, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = (blockIdx.x % n_tiles) * BM;
  const long long rows = static_cast<long long>(bh) * n;  // (b, h)'s first row of lse, di and the outputs
  const T* qh = q + b * st.sb + h * st.sh;
  const T* doh = dout + b * st.db + h * st.dh;
  load_tile<HD>(ks, k + b * st.sb + h * st.sh, st.sn, key0, n);
  load_tile<HD>(vs, v + b * st.sb + h * st.sh, st.sn, key0, n);
  const T* kw = ks + warp * 16 * TP;
  const T* vw = vs + warp * 16 * TP;
  T* pw = ps + warp * 16 * SP;
  T* dsw = dss + warp * 16 * SP;
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};
  for (int q0 = 0; q0 < n; q0 += BN) {
    __syncthreads();  // the last tile is read (and, the first time, K and V are in place)
    load_tile<HD>(qs, qh, st.sn, q0, n);
    load_tile<HD>(dos, doh, st.dn, q0, n);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool in = q0 + i < n;
      lse_s[i] = in ? lse[rows + q0 + i] * LOG2E : pos_inf();
      di_s[i] = in ? di[rows + q0 + i] : 0.0f;
    }
    __syncthreads();
    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ: the warp's 16 keys by the tile's 64 queries.
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma_tile<BN / 8, HD, true>(s, kw, TP, qs, TP, lane);
    mma_tile<BN / 8, HD, true>(dp, vw, TP, dos, TP, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 8 * j + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = exp2f(fmaf(s[j][2 * i + e], sl2, -lse_s[col + e]));
          ds[e] = p[e] * (dp[j][2 * i + e] - di_s[col + e]) * scale;
        }
        store2(pw + (g + 8 * i) * SP + col, p[0], p[1]);
        store2(dsw + (g + 8 * i) * SP + col, ds[0], ds[1]);
      }
    __syncwarp();
    // dv += pᵀ·do and dk += dsᵀ·q over the tile's queries.
    add_tile<HD / 8, BN>(dv_acc, pw, SP, dos, TP, lane);
    add_tile<HD / 8, BN>(dk_acc, dsw, SP, qs, TP, lane);
  }
  store_rows<HD>(dk + rows * HD, dk_acc, key0 + warp * 16, n, lane);
  store_rows<HD>(dv + rows * HD, dv_acc, key0 + warp * 16, n, lane);
}

// dq of one 64-query tile of one (b, h): blockIdx.x = (b·heads + h) ·
// n_tiles + tile. T is float (bf16 runs wg::flash_bwd_dq).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int heads, int n, Strides st, float scale, float sl2) {
  static_assert(sizeof(T) == 4, "the mma.sync kernel is f32's");
  constexpr int TP = tile_pitch<HD>(), SP = SCRATCH_PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BM * TP;
  T* ks = dos + BM * TP;
  T* vs = ks + BN * TP;
  T* dss = vs + BN * TP;  // [WARPS][16][SP] ds
  const int n_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / n_tiles, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tile0 = (blockIdx.x % n_tiles) * BM;
  const int row0 = tile0 + warp * 16;  // the warp's first query
  const long long rows = static_cast<long long>(bh) * n;
  const T* kh = k + b * st.sb + h * st.sh;
  const T* vh = v + b * st.sb + h * st.sh;
  load_tile<HD>(qs, q + b * st.sb + h * st.sh, st.sn, tile0, n);
  load_tile<HD>(dos, dout + b * st.db + h * st.dh, st.dn, tile0, n);
  float lse2[2], dii[2];  // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    lse2[i] = row < n ? lse[rows + row] * LOG2E : pos_inf();
    dii[i] = row < n ? di[rows + row] : 0.0f;
  }
  const T* qw = qs + warp * 16 * TP;
  const T* dow = dos + warp * 16 * TP;
  T* dsw = dss + warp * 16 * SP;
  float dq_acc[HD / 8][4] = {};
  for (int k0 = 0; k0 < n; k0 += BN) {
    __syncthreads();  // the last tile is read (and, the first time, Q and dO are in place)
    load_tile<HD>(ks, kh, st.sn, k0, n);
    load_tile<HD>(vs, vh, st.sn, k0, n);
    __syncthreads();
    // s = q·kᵀ and dp = do·vᵀ: the warp's 16 queries by the tile's 64 keys.
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma_tile<BN / 8, HD, true>(s, qw, TP, ks, TP, lane);
    mma_tile<BN / 8, HD, true>(dp, dow, TP, vs, TP, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 8 * j + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = k0 + col + e < n ? exp2f(fmaf(s[j][2 * i + e], sl2, -lse2[i])) : 0.0f;
          ds[e] = p * (dp[j][2 * i + e] - dii[i]) * scale;
        }
        store2(dsw + (g + 8 * i) * SP + col, ds[0], ds[1]);
      }
    __syncwarp();
    // dq += ds·k over the tile's keys.
    add_tile<HD / 8, BN>(dq_acc, dsw, SP, ks, TP, lane);
  }
  store_rows<HD>(dq + rows * HD, dq_acc, row0, n, lane);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// One launch's arguments (see flash_bwd_launch).
struct Call {
  int kernel;
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *out0, *out1;
  int batch, heads, n;
  Strides st;
  float scale;
  int device;
  cudaStream_t stream;
};

// Work a launch holds (bf16: persistent items of 128 rows; f32: CTAs on
// grid x, one a 64-row tile), or -1 past what a 32-bit index holds.
long long work_items(int batch, int heads, int n, bool bf16) {
  const int rows = bf16 ? wg::BR : BM;
  const long long items = static_cast<long long>((n + rows - 1) / rows) * batch * heads;
  return items <= hopper::MAX_ITEMS ? items : -1;
}

// The bf16 kernels at one width: the tensor maps (dK/dV owns k, v and
// streams q, do; dQ the reverse), the shared-memory attribute (once per
// device) and a persistent grid of one CTA per SM. Returns 0, a cudaError_t
// or a hopper::ERR_* code.
template <int HD>
int launch_bf16(const Call& c) {
  static std::atomic<uint64_t> dkv_set{0}, dq_set{0};
  const bool dkv = c.kernel == 0;
  const void* const ptrs[4] = {dkv ? c.k : c.q, dkv ? c.v : c.dout, dkv ? c.q : c.k, dkv ? c.dout : c.v};
  const bool is_do[4] = {false, !dkv, false, dkv};
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(c.n), static_cast<uint64_t>(c.heads),
                            static_cast<uint64_t>(c.batch)};
  const uint64_t qkv_strides[3] = {static_cast<uint64_t>(c.st.sn) * 2, static_cast<uint64_t>(c.st.sh) * 2,
                                   static_cast<uint64_t>(c.st.sb) * 2};
  const uint64_t do_strides[3] = {static_cast<uint64_t>(c.st.dn) * 2, static_cast<uint64_t>(c.st.dh) * 2,
                                  static_cast<uint64_t>(c.st.db) * 2};
  const CUtensorMapSwizzle lo_swizzle = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  wg::Maps<HD> maps;
  for (int i = 0; i < 4; ++i) {
    const uint64_t* strides = is_do[i] ? do_strides : qkv_strides;
    const uint32_t rows = i < 2 ? wg::BR : wg::BS;
    const uint32_t box[4] = {static_cast<uint32_t>(wg::lo_dims<HD>()), rows, 1, 1};
    int r = hopper::encode_tensor_map(&maps.m[i], 4, ptrs[i], dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                      lo_swizzle);
    if constexpr (wg::hi_dims<HD>() > 0) {
      const uint32_t hi_box[4] = {static_cast<uint32_t>(wg::hi_dims<HD>()), rows, 1, 1};
      if (r == 0)
        r = hopper::encode_tensor_map(&maps.m[4 + i], 4, ptrs[i], dims, strides, hi_box,
                                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_32B);
    }
    if (r != 0) return r;
  }
  const int n_blocks = (c.n + wg::BR - 1) / wg::BR;
  const int n_items = static_cast<int>(work_items(c.batch, c.heads, c.n, true));
  const int sms = hopper::sm_count(c.device);
  const int grid = sms > 0 && sms < n_items ? sms : n_items;
  const float sl2 = c.scale * LOG2E;
  __nv_bfloat16* out0 = static_cast<__nv_bfloat16*>(c.out0);
  cudaError_t e;
  if (dkv) {
    constexpr int SMEM = wg::smem_bytes<HD, true>();
    e = hopper::allow_smem_once(wg::flash_bwd_dkv<__nv_bfloat16, HD>, SMEM, c.device, dkv_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    wg::flash_bwd_dkv<__nv_bfloat16, HD><<<grid, wg::THREADS, SMEM, c.stream>>>(
        maps, c.lse, c.di, out0, static_cast<__nv_bfloat16*>(c.out1), c.heads, c.n, c.scale, sl2, n_blocks, n_items);
  } else {
    constexpr int SMEM = wg::smem_bytes<HD, false>();
    e = hopper::allow_smem_once(wg::flash_bwd_dq<__nv_bfloat16, HD>, SMEM, c.device, dq_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    wg::flash_bwd_dq<__nv_bfloat16, HD><<<grid, wg::THREADS, SMEM, c.stream>>>(maps, c.lse, c.di, out0, c.heads, c.n,
                                                                           c.scale, sl2, n_blocks, n_items);
  }
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernels at one width: one CTA a (b·h, 64-row tile) on grid x;
// the shared-memory attribute is set once per device.
template <int HD>
int launch_f32(const Call& c) {
  static std::atomic<uint64_t> dkv_set{0}, dq_set{0};
  const unsigned grid = static_cast<unsigned>(work_items(c.batch, c.heads, c.n, false));
  const float sl2 = c.scale * LOG2E;
  const float* q = static_cast<const float*>(c.q);
  const float* k = static_cast<const float*>(c.k);
  const float* v = static_cast<const float*>(c.v);
  const float* dout = static_cast<const float*>(c.dout);
  cudaError_t e;
  if (c.kernel == 0) {
    constexpr int SMEM = f32_smem_bytes<HD, true>();
    e = hopper::allow_smem_once(flash_bwd_dkv<float, HD>, SMEM, c.device, dkv_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv<float, HD><<<grid, THREADS, SMEM, c.stream>>>(q, k, v, dout, c.lse, c.di, static_cast<float*>(c.out0),
                                                                static_cast<float*>(c.out1), c.heads, c.n, c.st,
                                                                c.scale, sl2);
  } else {
    constexpr int SMEM = f32_smem_bytes<HD, false>();
    e = hopper::allow_smem_once(flash_bwd_dq<float, HD>, SMEM, c.device, dq_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq<float, HD><<<grid, THREADS, SMEM, c.stream>>>(q, k, v, dout, c.lse, c.di, static_cast<float*>(c.out0),
                                                               c.heads, c.n, c.st, c.scale, sl2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one K3-bwd kernel on `stream` of device `device`: kernel 0 writes
// dk and dv (out0, out1), kernel 1 dq (out0). q, k, v are (batch, heads, n,
// hd) arrays with one shared set of element strides (sb, sh, sn), dout has
// strides (db, dh, dn), all with a unit stride along hd and every pointer
// and stride a multiple of 16 bytes; lse and di are contiguous (batch,
// heads, n) f32, the outputs contiguous (batch, heads, n, hd). All f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1); hd is 32, 64 or 80; n >= 1, and
// any batch · heads whose work fits a 32-bit index (bf16: ⌈n / 128⌉ ·
// batch · heads items, f32: ⌈n / 64⌉ · batch · heads CTAs, at most
// hopper::MAX_ITEMS), else cudaErrorInvalidValue. Returns cudaGetLastError()
// after the launch (0 = launched), or 9001 / 9002 when the bf16 kernels'
// tensor maps cannot be encoded.
extern "C" int flash_bwd_launch(int kernel, const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* out0, void* out1, int batch, int heads,
                                int n, int hd, long long sb, long long sh, long long sn, long long db,
                                long long dh, long long dn, float scale, int is_bf16, int device, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || kernel < 0 || kernel > 1 || work_items(batch, heads, n, is_bf16) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Call c{kernel, q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di), out0, out1,
               batch, heads, n, Strides{sb, sh, sn, db, dh, dn}, scale, device, static_cast<cudaStream_t>(stream)};
  int r = static_cast<int>(cudaErrorInvalidValue);
  switch (hd * 2 + (is_bf16 ? 1 : 0)) {
    case 65: r = launch_bf16<32>(c); break;
    case 129: r = launch_bf16<64>(c); break;
    case 161: r = launch_bf16<80>(c); break;
    case 64: r = launch_f32<32>(c); break;
    case 128: r = launch_f32<64>(c); break;
    case 160: r = launch_f32<80>(c); break;
    default: break;
  }
  if (current != device) cudaSetDevice(current);
  return r;
}

// Dynamic shared memory of a K3-bwd kernel (0: dk, dv; 1: dq) at head width
// hd in bf16 (is_bf16 = 1) or f32 (0 at a width it does not take).
extern "C" int flash_bwd_smem(int kernel, int hd, int is_bf16) {
  const bool dkv = kernel == 0;
  switch (hd * 2 + (is_bf16 ? 1 : 0)) {
    case 65: return dkv ? wg::smem_bytes<32, true>() : wg::smem_bytes<32, false>();
    case 129: return dkv ? wg::smem_bytes<64, true>() : wg::smem_bytes<64, false>();
    case 161: return dkv ? wg::smem_bytes<80, true>() : wg::smem_bytes<80, false>();
    case 64: return dkv ? f32_smem_bytes<32, true>() : f32_smem_bytes<32, false>();
    case 128: return dkv ? f32_smem_bytes<64, true>() : f32_smem_bytes<64, false>();
    case 160: return dkv ? f32_smem_bytes<80, true>() : f32_smem_bytes<80, false>();
    default: return 0;
  }
}
