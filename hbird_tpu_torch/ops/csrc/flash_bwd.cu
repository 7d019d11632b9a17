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
// f32, `flash_bwd_dkv<float, HD>` and `flash_bwd_dq<float, HD>` at hd 32, 64
// and 80: 3xTF32 on wgmma + TMA, the frame above with the transform warps
// of K3's f32 forward (flash_attn.cu); tests/test_torch_flash_bwd_tf32.py
// emulates this order of work.
// - Each f32 operand x is split by tf32.cuh into big = rna(x) and small =
//   rna(x - big); a product is small·big + big·small, then big·big.
// - wgmma takes tf32 operands K-major only (the transpose bit is for 16-bit
//   types). sᵀ = K·Qᵀ and dpᵀ = V·dOᵀ (s = Q·Kᵀ, dp = dO·Vᵀ) reduce over
//   the head dims, so their operands are read as they arrive; dV += pᵀ·dO
//   and dK += dsᵀ·Q (dQ += ds·K) reduce over the streamed rows, so their B
//   operands dOᵀ and Qᵀ (Kᵀ) are written transposed. Transform warps take
//   each streamed tile as TMA lands it: split into its big and small
//   parts, and Q and dO (K) also transposed and split, streamed row r of
//   each 8-row group at position r / 2 (r even) or 4 + r / 2 (r odd). That
//   is where the score accumulator holds row r, so p and ds become split A
//   fragments straight from the s and dp accumulators, as p does in K3's
//   f32 forward.
// - An item owns 64 rows of one (b, h) (keys for dK/dV, queries for dQ),
//   split once in place in shared memory, and sᵀ and dpᵀ (s and dp) read
//   their A operand there (m64n32k8 or m64n16k8 with both operands in
//   shared memory): the split A fragments of both owned tiles would take
//   2·HD registers beside the sums. Both consumer warpgroups own the
//   item's rows and take its streamed tiles in turn, even tiles the first
//   and odd the second, each with its own sums; at the end the second
//   stores its part and the first adds its own to it (f32, rounding to
//   nearest), so two runs give the same bits.
// - A CTA is 512 threads: warp 0 issues the TMA copies (and, for dK/dV,
//   copies the streamed queries' lse and di with cp.async), warps 1-7
//   transform, warps 8-15 are the two consumer warpgroups (setmaxnreg 64 /
//   192). Seven transform warps, not three: the split tiles are written a
//   float at a time, and with three the consumers waited for them (PERF.md).
// - Shared memory: the owned tiles (4 × 64 rows), a ring of raw stages
//   that TMA fills (the streamed pair as it arrives, up to 4 ahead) and a
//   ring of split stages that the transform warps fill from it (the pair's
//   big and small parts and the transposed split tiles: dK/dV 8 tiles, dQ
//   6), at least two (one a consumer warpgroup), as many as fit
//   (f32_raw_stages, f32_stages). Streamed tiles are 32 rows, 16 at hd 80.
//   An item's first tiles are copied and split before its owned tiles,
//   which wait for the last item's consumers. What bounds it on an H100 is
//   the shared memory's bandwidth: a tile's operand reads (A and B of sᵀ
//   and dpᵀ, B of the rest) and the transform's writes.
// - Numerics: the tensor cores add into their accumulator rounding toward
//   zero, about an ulp of the accumulator an instruction. sᵀ and dpᵀ issue
//   their cross terms first (HD/8 adds at the full value); each tile's
//   product for dV, dK or dQ goes into a fresh accumulator (3·BS/8 adds,
//   BS/8 of them at the full value for a tile of BS rows) that is added
//   into the warpgroup's f32 sum rounding to nearest, so no chain of
//   truncating adds runs longer than one tile.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include <cuda_bf16.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma, the producer warpgroup's other warps splitting and
// transposing the tiles.
// ---------------------------------------------------------------------------

constexpr int FBR = 64;           // rows an f32 item owns: keys (dK/dV) or queries (dQ)
constexpr int F32_THREADS = 512;  // TMA warp and transform warps (two warpgroups), two consumer warpgroups
constexpr int XF_THREADS = 224;   // warps 1-7: the transform warps
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take (227 KB)

// Streamed rows of an f32 tile: 32, and 16 at hd 80, where two split
// stages and two raw stages of 32 rows would not fit beside the owned tiles.
template <int HD>
__host__ __device__ constexpr int fbs() {
  return HD == 80 ? 16 : 32;
}

template <int HD, int ROWS>
__host__ __device__ constexpr int f32_tile_bytes() {
  return ROWS * HD * 4;
}

// A split stage: the streamed pair's big parts, their small parts, then the
// transposed split tiles (dK/dV: Qᵀ and dOᵀ; dQ: Kᵀ), big and small.
template <int HD, bool DKV>
__host__ __device__ constexpr int f32_stage_bytes() {
  return (DKV ? 8 : 6) * f32_tile_bytes<HD, fbs<HD>()>();
}

// The owned tiles, `split` split stages, `raw` raw stages (the streamed
// pair as TMA writes it), dK/dV's lse and di rows of each stage of both
// kinds, and the barriers.
template <int HD, bool DKV>
__host__ __device__ constexpr int f32_smem_at(int split, int raw) {
  return hopper::SMEM_ALIGN + 4 * f32_tile_bytes<HD, FBR>() + split * f32_stage_bytes<HD, DKV>() +
         raw * 2 * f32_tile_bytes<HD, fbs<HD>()>() + (DKV ? (split + raw) * 2 * fbs<HD>() * 4 : 0) +
         8 * (3 + 2 * split + 2 * raw);
}

// Raw stages: as many as fit beside two split stages (one a consumer
// warpgroup), at most 4: dK/dV 4, 2, 4 at hd 32, 64, 80; dQ 4 at each.
template <int HD, bool DKV>
__host__ __device__ constexpr int f32_raw_stages() {
  int r = 1;
  while (r < 4 && f32_smem_at<HD, DKV>(2, r + 1) <= MAX_SMEM) ++r;
  return r;
}

// Split stages: as many as then fit, at most 8: dK/dV 4, 2, 2; dQ 6, 2, 3.
template <int HD, bool DKV>
__host__ __device__ constexpr int f32_stages() {
  int s = 2;
  while (s < 8 && f32_smem_at<HD, DKV>(s + 1, f32_raw_stages<HD, DKV>()) <= MAX_SMEM) ++s;
  return s;
}

template <int HD, bool DKV>
__host__ __device__ constexpr int f32_smem_bytes() {
  return f32_smem_at<HD, DKV>(f32_stages<HD, DKV>(), f32_raw_stages<HD, DKV>());
}

// Byte offset of head dim d of row `row` in an f32 tile of ROWS rows (K3's
// f32 layout): part d / 32 starts at (d / 32)·ROWS·128; a 32-float part has
// 128-byte rows whose 16-byte unit u lies at u ^ (row % 8), hd 80's last
// (16 floats) 64-byte rows whose unit u lies at u ^ (row / 2 % 4).
template <int HD, int ROWS>
__device__ __forceinline__ int f32_off(int row, int d) {
  const int p = d >> 5, c = d & 31;
  if (HD - 32 * p >= 32) return p * ROWS * 128 + row * 128 + (((c >> 2) ^ (row & 7)) << 4) + ((c & 3) << 2);
  return p * ROWS * 128 + row * 64 + (((c >> 2) ^ ((row >> 1) & 3)) << 4) + ((c & 3) << 2);
}

// The descriptor of k8 step kk (head dims 8kk..8kk+7) of an f32 tile of
// ROWS rows: 32 bytes a step inside a part's rows.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk) {
  const int p = kk >> 2;
  const unsigned char* a = tile + p * ROWS * 128 + (kk & 3) * 32;
  return HD - 32 * p >= 32 ? hopper::sw128_desc(a) : hopper::sw64_desc(a);
}

// A transposed tile: HD rows (head dims) of BS positions, 128-byte rows
// under the 128-byte swizzle (BS 32) or 64-byte rows under the 64-byte one
// (BS 16). Streamed row r of an 8-row group sits at position r / 2 (r even)
// or 4 + r / 2 (r odd) of its group.
template <int BS>
__device__ __forceinline__ int t_off(int d, int pos) {
  if constexpr (BS == 32) return d * 128 + ((((pos >> 2) ^ d) & 7) << 4) + ((pos & 3) << 2);
  return d * 64 + ((((pos >> 2) ^ (d >> 1)) & 3) << 4) + ((pos & 3) << 2);
}

// The descriptor of k8 step j (streamed rows 8j..8j+7) of a transposed tile.
template <int BS>
__device__ __forceinline__ uint64_t t_desc(const unsigned char* t, int j) {
  if constexpr (BS == 32) return hopper::sw128_desc(t + 32 * j);
  return hopper::sw64_desc(t + 32 * j);
}

// Rows row0.. of (b, h) of tensor map i into an f32 tile of ROWS rows at
// dst, completing on bar: one TMA copy a 32-float part (box {32, ROWS}) and
// at hd 80 one of {16, ROWS} at head dim 64 (map 4 + i).
template <int HD, int ROWS>
__device__ __forceinline__ void f32_tma(unsigned char* dst, const Maps<HD>& maps, int i, uint64_t* bar, int row0,
                                        int h, int b) {
#pragma unroll
  for (int p = 0; p < HD / 32; ++p) hopper::tma_load_4d(dst + p * ROWS * 128, &maps.m[i], bar, 32 * p, row0, h, b);
  if constexpr (HD % 32 != 0)
    hopper::tma_load_4d(dst + (HD / 32) * ROWS * 128, &maps.m[4 + i], bar, HD / 32 * 32, row0, h, b);
}

__device__ __forceinline__ void split4(uint4 v, uint4& big, uint4& small) {
  tf32::split(__uint_as_float(v.x), big.x, small.x);
  tf32::split(__uint_as_float(v.y), big.y, small.y);
  tf32::split(__uint_as_float(v.z), big.z, small.z);
  tf32::split(__uint_as_float(v.w), big.w, small.w);
}

// Transform threads (x of XF_THREADS): a tile of BYTES at src split into
// its big parts (at `big`, which may be src) and its small parts, at the
// same offsets.
template <int BYTES>
__device__ __forceinline__ void split_tile(const unsigned char* src, unsigned char* big, unsigned char* small, int x) {
#pragma unroll 2
  for (int u = x; u < BYTES / 16; u += XF_THREADS) {
    uint4 b, sm;
    split4(reinterpret_cast<const uint4*>(src)[u], b, sm);
    reinterpret_cast<uint4*>(big)[u] = b;
    reinterpret_cast<uint4*>(small)[u] = sm;
  }
}

// Transform warp `warp` (0-6): a streamed tile at src (BS rows) split into
// `big` and `small` at the same offsets, and written transposed and split
// as tb and ts. Lane l takes row l % BS and 4 head dims a task (at BS 16,
// lanes 16-31 the next 4): one 16-byte read a lane, two 16-byte writes and
// 8 four-byte writes, a transposed row's BS positions across the lanes.
// Head dims d..d+3 (d a multiple of 4) of a transposed tile lie at d rows
// past dims 0-3, their swizzled unit flipped in one bit when d % 8 = 4.
template <int HD, int BS>
__device__ __forceinline__ void split_t(const unsigned char* src, unsigned char* big, unsigned char* small,
                                        unsigned char* tb, unsigned char* ts, int warp, int lane) {
  constexpr int GROUPS = 32 / BS;  // 4-dim groups a task
  const int r = lane % BS, q = r & 7;
  const int pos = (r & ~7) | ((q & 1) ? 4 + (q >> 1) : (q >> 1));
  int co[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) co[i] = t_off<BS>(i, pos);
#pragma unroll 2
  for (int task = warp; task < HD / 4 / GROUPS; task += XF_THREADS / 32) {
    const int d = (task * GROUPS + lane / BS) * 4;
    const int off = f32_off<HD, BS>(r, d);
    const int rows = d * BS * 4, flip = (d & 4) << (BS == 32 ? 4 : 3);
    uint4 b, sm;
    split4(*reinterpret_cast<const uint4*>(src + off), b, sm);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = sm;
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w}, sv[4] = {sm.x, sm.y, sm.z, sm.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = rows + (co[i] ^ flip);
      *reinterpret_cast<uint32_t*>(tb + o) = bv[i];
      *reinterpret_cast<uint32_t*>(ts + o) = sv[i];
    }
  }
}

template <int BS>
__device__ __forceinline__ void wgmma_ss_f32(float (&d)[BS / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BS == 32) hopper::wgmma_m64n32k8_tf32_ss(d, a, b, scale_d);
  if constexpr (BS == 16) hopper::wgmma_m64n16k8_tf32_ss(d, a, b, scale_d);
}

template <int HD>
__device__ __forceinline__ void wgmma_rs_f32(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (HD == 32) hopper::wgmma_m64n32k8_tf32_rs(d, a, b, scale_d);
  if constexpr (HD == 64) hopper::wgmma_m64n64k8_tf32_rs(d, a, b, scale_d);
  if constexpr (HD == 80) hopper::wgmma_m64n80k8_tf32_rs(d, a, b, scale_d);
}

// acc (the 64 owned rows by the BS streamed rows) = the owned tile (ob
// big, os small) times the streamed tile (sb, ss) transposed, over the head
// dims, in 3xTF32: the cross terms first, then big·big.
template <int HD, int BS>
__device__ __forceinline__ void issue_s(float (&acc)[BS / 2], const unsigned char* ob, const unsigned char* os,
                                        const unsigned char* sb, const unsigned char* ss) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_ss_f32<BS>(acc, kdesc<HD, FBR>(os, kk), kdesc<HD, BS>(sb, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_ss_f32<BS>(acc, kdesc<HD, FBR>(ob, kk), kdesc<HD, BS>(ss, kk), 1);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) wgmma_ss_f32<BS>(acc, kdesc<HD, FBR>(ob, kk), kdesc<HD, BS>(sb, kk), 1);
}

// f (64 owned rows × HD) = a (split A fragments: the owned rows by the
// tile's BS streamed rows) times a transposed tile (tb, ts), in 3xTF32 in
// the same order, into a fresh accumulator.
template <int HD, int BS>
__device__ __forceinline__ void issue_t(float (&f)[HD / 2], const uint32_t (&ab)[BS / 8][4],
                                        const uint32_t (&as)[BS / 8][4], const unsigned char* tb,
                                        const unsigned char* ts) {
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs_f32<HD>(f, as[j], t_desc<BS>(tb, j), j > 0);
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs_f32<HD>(f, ab[j], t_desc<BS>(ts, j), 1);
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs_f32<HD>(f, ab[j], t_desc<BS>(tb, j), 1);
  hopper::wgmma_commit();
}

// An accumulator of BS streamed columns as split A fragments of BS / 8 k8
// steps: step j's k index t is column 8j + 2t (elements 4j, and 4j + 2 for
// row g + 8) and t + 4 is column 8j + 2t + 1 (4j + 1, 4j + 3).
template <int J>
__device__ __forceinline__ void split_acc(const float (&x)[4 * J], uint32_t (&b)[J][4], uint32_t (&s)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    tf32::split(x[4 * j], b[j][0], s[j][0]);
    tf32::split(x[4 * j + 2], b[j][1], s[j][1]);
    tf32::split(x[4 * j + 1], b[j][2], s[j][2]);
    tf32::split(x[4 * j + 3], b[j][3], s[j][3]);
  }
}

// p and ds of one streamed tile of BS rows in place (x becomes p, y ds), in
// f32 as the plain version: p = exp2(s·scale·log2(e) - lse·log2(e)), ds =
// p·(dp - di)·scale. Element 4j + e: owned row g (e < 2) or g + 8,
// streamed row 8j + 2·(lane % 4) + (e & 1) of the tile (first row r0).
// dK/dV: the streamed queries' lse and di from the stage's rows; dQ: the
// owned queries' from registers, and key columns at or past n get p = 0.
template <bool DKV, int BS>
__device__ __forceinline__ void grads_f32(float (&x)[BS / 2], float (&y)[BS / 2], const float* lse_di,
                                          const float (&lse2)[2], const float (&dii)[2], int r0, int n, float scale,
                                          float sl2, int lane) {
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
      float p = exp2f(fmaf(x[4 * j + e], sl2, -le));
      if (ragged && r0 + 8 * j + 2 * t + (e & 1) >= n) p = 0.0f;
      y[4 * j + e] = p * (y[4 * j + e] - de) * scale;
      x[4 * j + e] = p;
    }
  }
}

template <int N>
__device__ __forceinline__ void add_into(float (&sum)[N], const float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = __fadd_rn(sum[i], f[i]);
}

// The warp's 16 rows of an f32 accumulator (rows row0 + g and + 8) into the
// contiguous (b, h) matrix out (n rows of HD), rows below n; with `add`,
// each value added to what out holds there (the other warpgroup's part).
template <int HD>
__device__ __forceinline__ void store_f32(float* out, const float (&acc)[HD / 2], int row0, int n, int lane,
                                          bool add) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float2* p = reinterpret_cast<float2*>(out + static_cast<long long>(row) * HD + 8 * j + 2 * (lane & 3));
      float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      if (add) {
        const float2 o = *p;
        v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
      }
      *p = v;
    }
  }
}

// One f32 kernel: DKV, dk (out0) and dv (out1) of items of 64 keys; else dq
// (out0) of items of 64 queries. Items (b·heads + h, block), the blocks of
// one head adjacent.
template <int HD, bool DKV>
__device__ __forceinline__ void f32_body(const Maps<HD>& maps, const float* __restrict__ lse,
                                         const float* __restrict__ di, float* __restrict__ out0,
                                         float* __restrict__ out1, int heads, int n, float scale, float sl2,
                                         int n_blocks, int n_items) {
  constexpr int BS = fbs<HD>(), S = f32_stages<HD, DKV>(), R = f32_raw_stages<HD, DKV>();
  constexpr int OWN = f32_tile_bytes<HD, FBR>(), ST = f32_tile_bytes<HD, BS>(), STAGE = f32_stage_bytes<HD, DKV>();
  static_assert(f32_smem_bytes<HD, DKV>() <= MAX_SMEM, "the f32 tiles exceed a block's shared memory");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own = hopper::aligned_smem(smem_raw);        // [A, A small, B, B small]: K, V; Q, dO
  unsigned char* ring = own + 4 * OWN;                        // [S][A, A small, B, B small, Aᵀ, Aᵀ small(, Bᵀ, Bᵀ small)]
  unsigned char* raw = ring + S * STAGE;                      // [R][A, B] as TMA writes them
  float* rows = reinterpret_cast<float*>(raw + R * 2 * ST);   // dK/dV: [S][lse·log2(e), di][BS]
  float* raw_rows = rows + (DKV ? S * 2 * BS : 0);            // dK/dV: [R][lse, di][BS] as copied
  uint64_t* own_full = reinterpret_cast<uint64_t*>(raw_rows + (DKV ? R * 2 * BS : 0));
  uint64_t* own_ready = own_full + 1;  // the owned tiles split
  uint64_t* own_empty = own_ready + 1;
  uint64_t* raw_full = own_empty + 1;  // [R] the streamed pair landed
  uint64_t* raw_empty = raw_full + R;  // [R] the transform warps read it
  uint64_t* ready = raw_empty + R;     // [S] split (and dK/dV's rows written)
  uint64_t* empty = ready + S;         // [S] its consumer warpgroup is done with it
  const int n_tiles = (n + BS - 1) / BS;
  const int wgi = __shfl_sync(FULL, threadIdx.x / 128, 0);  // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    hopper::mbar_init(own_ready, XF_THREADS);
    hopper::mbar_init(own_empty, 256);
    for (int r = 0; r < R; ++r) {
      hopper::mbar_init(raw_full + r, DKV ? 1 + 32 : 1);  // dK/dV: the TMA lane and the warp's row copies
      hopper::mbar_init(raw_empty + r, XF_THREADS);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(ready + s, XF_THREADS);
      hopper::mbar_init(empty + s, 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi < 2) {
    hopper::reg_dealloc<64>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
      // Producer warp: lane 0 issues every TMA copy; for dK/dV, lanes below
      // BS copy the streamed queries' lse and di (rows below n) beside each
      // raw pair with cp.async. An item's first R streamed tiles go before
      // its owned tiles, which wait for the last item's consumers.
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < Maps<HD>::COUNT; ++i) hopper::prefetch_tensor_map(&maps.m[i]);
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_blocks, blk = item % n_blocks;
        const int b = bh / heads, h = bh % heads;
        const int pre = n_tiles < R ? n_tiles : R;
        for (int t = 0; t < n_tiles; ++t) {
          if (t == pre && lane == 0) {
            hopper::mbar_wait(own_empty, (it & 1) ^ 1);
            hopper::mbar_expect_tx(own_full, 2 * OWN);
            f32_tma<HD, FBR>(own, maps, 0, own_full, blk * FBR, h, b);
            f32_tma<HD, FBR>(own + 2 * OWN, maps, 1, own_full, blk * FBR, h, b);
          }
          unsigned char* rw = raw + stage * 2 * ST;
          hopper::mbar_wait(raw_empty + stage, phase ^ 1);
          if (lane == 0) {
            hopper::mbar_expect_tx(raw_full + stage, 2 * ST);
            f32_tma<HD, BS>(rw, maps, 2, raw_full + stage, t * BS, h, b);
            f32_tma<HD, BS>(rw + ST, maps, 3, raw_full + stage, t * BS, h, b);
          }
          if constexpr (DKV) {
            const int q = t * BS + lane;
            float* rr = raw_rows + stage * 2 * BS;
            if (lane < BS && q < n) {
              const long long row = static_cast<long long>(bh) * n + q;
              hopper::cp_async4(rr + lane, lse + row);
              hopper::cp_async4(rr + BS + lane, di + row);
            }
            hopper::cp_async_arrive(raw_full + stage);
          }
          if (++stage == R) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (pre == n_tiles && lane == 0) {
          hopper::mbar_wait(own_empty, (it & 1) ^ 1);
          hopper::mbar_expect_tx(own_full, 2 * OWN);
          f32_tma<HD, FBR>(own, maps, 0, own_full, blk * FBR, h, b);
          f32_tma<HD, FBR>(own + 2 * OWN, maps, 1, own_full, blk * FBR, h, b);
        }
      }
    } else if (warp > 0) {
      // Transform warps: every tile in the producer's order, each raw pair
      // into the next free split stage; dK/dV's streamed queries' lse
      // (times log2(e), +inf past n) and di (0 past n) beside it. An item's
      // first S tiles go before its owned tiles.
      const int x = threadIdx.x - 32;
      int rs = 0, stage = 0;
      uint32_t rph = 0, phase = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int pre = n_tiles < S ? n_tiles : S;
        for (int t = 0; t <= n_tiles; ++t) {
          if (t == pre) {
            hopper::mbar_wait(own_full, it & 1);
            split_tile<OWN>(own, own, own + OWN, x);
            split_tile<OWN>(own + 2 * OWN, own + 2 * OWN, own + 3 * OWN, x);
            hopper::fence_proxy_async();  // the split tiles, to the tensor cores
            hopper::mbar_arrive(own_ready);
          }
          if (t == n_tiles) break;
          const unsigned char* rw = raw + rs * 2 * ST;
          unsigned char* st = ring + stage * STAGE;
          hopper::mbar_wait(raw_full + rs, rph);
          hopper::mbar_wait(empty + stage, phase ^ 1);
          split_t<HD, BS>(rw, st, st + ST, st + 4 * ST, st + 5 * ST, warp - 1, lane);
          if constexpr (DKV) {
            split_t<HD, BS>(rw + ST, st + 2 * ST, st + 3 * ST, st + 6 * ST, st + 7 * ST, warp - 1, lane);
            if (x < BS) {
              const float* rr = raw_rows + rs * 2 * BS;
              const bool in = t * BS + x < n;
              rows[stage * 2 * BS + x] = in ? rr[x] * LOG2E : pos_inf();
              rows[stage * 2 * BS + BS + x] = in ? rr[BS + x] : 0.0f;
            }
          } else {
            split_tile<ST>(rw + ST, st + 2 * ST, st + 3 * ST, x);
          }
          hopper::mbar_arrive(raw_empty + rs);  // the raw pair is read
          hopper::fence_proxy_async();          // the split tiles, to the tensor cores
          hopper::mbar_arrive(ready + stage);
          if (++rs == R) {
            rs = 0;
            rph ^= 1;
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw takes tiles t with t % 2 == cw of every item.
    hopper::reg_alloc<192>();
    const int cw = wgi - 2;
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int NB = DKV ? HD / 2 : 1;
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_blocks, blk = item % n_blocks;
      const long long base = static_cast<long long>(bh) * n;  // (b, h)'s first row of lse, di and the outputs
      const int row0 = blk * FBR + warp * 16;                // the warp's first owned row
      float lse2[2] = {0.0f, 0.0f}, dii[2] = {0.0f, 0.0f};   // dQ: the warp's rows g and g + 8
      if constexpr (!DKV) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + (lane >> 2) + 8 * i;
          lse2[i] = row < n ? lse[base + row] * LOG2E : pos_inf();
          dii[i] = row < n ? di[base + row] : 0.0f;
        }
      }
      float sa[HD / 2], sb[NB];  // dK and dV; dQ
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) sa[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NB; ++i) sb[i] = 0.0f;
      hopper::mbar_wait(own_ready, it & 1);
      for (int t = 0; t < n_tiles; ++t) {
        if ((t & 1) == cw) {
          const unsigned char* st = ring + stage * STAGE;
          float x[BS / 2], y[BS / 2], f[HD / 2];
          uint32_t fb[BS / 8][4], fs[BS / 8][4];
          hopper::mbar_wait(ready + stage, phase);
          hopper::wgmma_fence();
          issue_s<HD, BS>(x, own, own + OWN, st, st + ST);                      // sᵀ = K·Qᵀ; s = Q·Kᵀ
          issue_s<HD, BS>(y, own + 2 * OWN, own + 3 * OWN, st + 2 * ST, st + 3 * ST);  // dpᵀ = V·dOᵀ; dp = dO·Vᵀ
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(x);
          hopper::fence_regs(y);
          grads_f32<DKV, BS>(x, y, rows + stage * 2 * BS, lse2, dii, t * BS, n, scale, sl2, lane);
          if constexpr (DKV) {
            split_acc<BS / 8>(x, fb, fs);
            issue_t<HD, BS>(f, fb, fs, st + 6 * ST, st + 7 * ST);  // pᵀ·dO
            hopper::wgmma_wait<0>();
            hopper::fence_regs(f);
            add_into(sb, f);
          }
          split_acc<BS / 8>(y, fb, fs);
          issue_t<HD, BS>(f, fb, fs, st + 4 * ST, st + 5 * ST);  // dsᵀ·Q; ds·K
          hopper::wgmma_wait<0>();
          hopper::fence_regs(f);
          hopper::mbar_arrive(empty + stage);
          add_into(sa, f);
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      // The two parts: the second warpgroup's stored, the first's added.
      if (cw == 1) {
        store_f32<HD>(out0 + base * HD, sa, row0, n, lane, false);
        if constexpr (DKV) store_f32<HD>(out1 + base * HD, sb, row0, n, lane, false);
        __threadfence_block();
        hopper::named_arrive(1, 256);
      } else {
        hopper::named_sync(1, 256);
        store_f32<HD>(out0 + base * HD, sa, row0, n, lane, true);
        if constexpr (DKV) store_f32<HD>(out1 + base * HD, sb, row0, n, lane, true);
      }
      hopper::mbar_arrive(own_empty);  // the first warpgroup's after its reads: the next item waits for them
    }
  }
}

// Threads of a CTA: bf16 384 (bwd_body), f32 512 (f32_body).
template <typename T>
__host__ __device__ constexpr int threads() {
  return sizeof(T) == 2 ? THREADS : F32_THREADS;
}

// dk and dv: persistent CTAs over (b·h, key block) items; bf16 blocks of
// 128 keys (bwd_body), f32 of 64 (f32_body).
template <typename T, int HD>
__global__ void __launch_bounds__(threads<T>(), 1)
    flash_bwd_dkv(const __grid_constant__ Maps<HD> maps, const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int heads, int n, float scale, float sl2, int n_blocks,
                  int n_items) {
  if constexpr (sizeof(T) == 2)
    bwd_body<HD, true>(maps, lse, di, dk, dv, heads, n, scale, sl2, n_blocks, n_items);
  else
    f32_body<HD, true>(maps, lse, di, dk, dv, heads, n, scale, sl2, n_blocks, n_items);
}

// dq: persistent CTAs over (b·h, query block) items (bf16 128 queries, f32 64).
template <typename T, int HD>
__global__ void __launch_bounds__(threads<T>(), 1)
    flash_bwd_dq(const __grid_constant__ Maps<HD> maps, const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int heads, int n, float scale, float sl2, int n_blocks, int n_items) {
  if constexpr (sizeof(T) == 2)
    bwd_body<HD, false>(maps, lse, di, dq, nullptr, heads, n, scale, sl2, n_blocks, n_items);
  else
    f32_body<HD, false>(maps, lse, di, dq, nullptr, heads, n, scale, sl2, n_blocks, n_items);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Element strides of a call: q, k and v share one set, do has its own.
struct Strides {
  long long sb, sh, sn, db, dh, dn;
};

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

// Work items a launch holds (persistent items of 128 rows in bf16, 64 in
// f32), or -1 past what a 32-bit index holds.
long long work_items(int batch, int heads, int n, bool bf16) {
  const int rows = bf16 ? wg::BR : wg::FBR;
  const long long items = static_cast<long long>((n + rows - 1) / rows) * batch * heads;
  return items <= hopper::MAX_ITEMS ? items : -1;
}

// The kernels at one width and type: the tensor maps (dK/dV owns k, v and
// streams q, do; dQ the reverse; bf16 tiles in one part, or at hd 80 a
// 64-dim part under the 128-byte swizzle and a 16-dim part under the 32-byte
// one; f32 tiles in 32-float parts under the 128-byte swizzle, hd 80's last
// 16 floats under the 64-byte one), the shared-memory attribute (once per
// device) and a persistent grid of one CTA per SM. Returns 0, a cudaError_t
// or a hopper::ERR_* code.
template <int HD, bool BF16>
int launch(const Call& c) {
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;
  static std::atomic<uint64_t> dkv_set{0}, dq_set{0};
  constexpr uint64_t ELT = sizeof(T);
  const bool dkv = c.kernel == 0;
  const void* const ptrs[4] = {dkv ? c.k : c.q, dkv ? c.v : c.dout, dkv ? c.q : c.k, dkv ? c.dout : c.v};
  const bool is_do[4] = {false, !dkv, false, dkv};
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(c.n), static_cast<uint64_t>(c.heads),
                            static_cast<uint64_t>(c.batch)};
  const uint64_t qkv_strides[3] = {static_cast<uint64_t>(c.st.sn) * ELT, static_cast<uint64_t>(c.st.sh) * ELT,
                                   static_cast<uint64_t>(c.st.sb) * ELT};
  const uint64_t do_strides[3] = {static_cast<uint64_t>(c.st.dn) * ELT, static_cast<uint64_t>(c.st.dh) * ELT,
                                  static_cast<uint64_t>(c.st.db) * ELT};
  const CUtensorMapDataType type = BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle lo_swizzle = BF16 && HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle hi_swizzle = BF16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  constexpr uint32_t LO = BF16 ? wg::lo_dims<HD>() : 32;  // head dims of a part's box
  const uint32_t own_rows = BF16 ? wg::BR : wg::FBR;
  const uint32_t st_rows = BF16 ? wg::BS : wg::fbs<HD>();
  wg::Maps<HD> maps;
  for (int i = 0; i < 4; ++i) {
    const uint64_t* strides = is_do[i] ? do_strides : qkv_strides;
    const uint32_t rows = i < 2 ? own_rows : st_rows;
    const uint32_t box[4] = {LO, rows, 1, 1};
    int r = hopper::encode_tensor_map(&maps.m[i], 4, ptrs[i], dims, strides, box, type, lo_swizzle);
    if constexpr (wg::hi_dims<HD>() > 0) {
      const uint32_t hi_box[4] = {static_cast<uint32_t>(wg::hi_dims<HD>()), rows, 1, 1};
      if (r == 0) r = hopper::encode_tensor_map(&maps.m[4 + i], 4, ptrs[i], dims, strides, hi_box, type, hi_swizzle);
    }
    if (r != 0) return r;
  }
  const int n_blocks = (c.n + own_rows - 1) / own_rows;
  const int n_items = static_cast<int>(work_items(c.batch, c.heads, c.n, BF16));
  const int sms = hopper::sm_count(c.device);
  const int grid = sms > 0 && sms < n_items ? sms : n_items;
  const float sl2 = c.scale * LOG2E;
  T* out0 = static_cast<T*>(c.out0);
  cudaError_t e;
  if (dkv) {
    constexpr int SMEM = BF16 ? wg::smem_bytes<HD, true>() : wg::f32_smem_bytes<HD, true>();
    e = hopper::allow_smem_once(wg::flash_bwd_dkv<T, HD>, SMEM, c.device, dkv_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    wg::flash_bwd_dkv<T, HD><<<grid, wg::threads<T>(), SMEM, c.stream>>>(maps, c.lse, c.di, out0, static_cast<T*>(c.out1),
                                                                    c.heads, c.n, c.scale, sl2, n_blocks, n_items);
  } else {
    constexpr int SMEM = BF16 ? wg::smem_bytes<HD, false>() : wg::f32_smem_bytes<HD, false>();
    e = hopper::allow_smem_once(wg::flash_bwd_dq<T, HD>, SMEM, c.device, dq_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    wg::flash_bwd_dq<T, HD><<<grid, wg::threads<T>(), SMEM, c.stream>>>(maps, c.lse, c.di, out0, c.heads, c.n, c.scale,
                                                                   sl2, n_blocks, n_items);
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
// any batch · heads whose items fit a 32-bit index (⌈n / 128⌉ · batch ·
// heads in bf16, ⌈n / 64⌉ · batch · heads in f32, at most
// hopper::MAX_ITEMS), else cudaErrorInvalidValue. Returns cudaGetLastError()
// after the launch (0 = launched), or 9001 / 9002 when the tensor maps
// cannot be encoded.
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
    case 65: r = launch<32, true>(c); break;
    case 129: r = launch<64, true>(c); break;
    case 161: r = launch<80, true>(c); break;
    case 64: r = launch<32, false>(c); break;
    case 128: r = launch<64, false>(c); break;
    case 160: r = launch<80, false>(c); break;
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
    case 64: return dkv ? wg::f32_smem_bytes<32, true>() : wg::f32_smem_bytes<32, false>();
    case 128: return dkv ? wg::f32_smem_bytes<64, true>() : wg::f32_smem_bytes<64, false>();
    case 160: return dkv ? wg::f32_smem_bytes<80, true>() : wg::f32_smem_bytes<80, false>();
    default: return 0;
  }
}

// Streamed rows of the f32 K3-bwd kernels' tiles at head width hd, or 0 at
// a width they do not take: each tile's product for dk, dv or dq is a chain
// of 3 · rows / 8 truncating tensor-core adds.
extern "C" int flash_bwd_f32_tile(int hd) {
  switch (hd) {
    case 32: return wg::fbs<32>();
    case 64: return wg::fbs<64>();
    case 80: return wg::fbs<80>();
    default: return 0;
  }
}
