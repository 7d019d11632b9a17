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
// - `flash_bwd_dkv`: each CTA owns a 64-key tile of one (b, h) and walks
//   every 64-query tile, accumulating dk and dv of its keys in registers;
// - `flash_bwd_dq`: each CTA owns a 64-query tile and walks every 64-key
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
// that is ~1,200 flops per bf16 byte, far above the ~295 at which the card
// stops being memory bound. So every product goes on the tensor cores and
// p and ds leave registers only for a per-warp tile of shared memory.
//
// This first form is simple and right, not fast (a later PR redesigns it on
// wgmma + TMA): four warps a CTA, each owning 16 of the CTA's 64 rows, and
// every product an `mma.sync` whose fragments the threads load from padded
// shared memory (the padding keeps the bf16 fragment loads free of bank
// conflicts): m16n8k16 in bf16; in f32, m16n8k8 in TF32 with each operand
// split by tf32.cuh into big and small parts (3xTF32), a product's cross
// terms over the whole depth issued before its big·big terms, since the
// tensor cores add rounding toward zero. The transposed operands of dv =
// pᵀ·do, dk = dsᵀ·q and dq = ds·k (do, q and k with the reduction running
// down their rows) are read a value at a time, which mma.sync allows and
// wgmma's tf32 form does not. A 64-row tile of dk, dv or dq is added into
// its f32 accumulator once per streamed tile, rounding to nearest, so no
// chain of truncating tensor-core adds runs longer than one tile.
//
// Rows past N: streamed query rows load as zeros and take lse = +inf, so
// their p and ds are 0; streamed key columns at or past N get p = 0; owned
// rows past N are never stored. Any N >= 1 runs (N = 257's last key tile
// holds one key).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include <cuda_bf16.h>

#include "hopper.cuh"  // allow_smem_once
#include "tf32.cuh"

namespace {

constexpr int BM = 64;       // rows a CTA owns: keys (dk, dv) or queries (dq)
constexpr int BN = 64;       // rows of a streamed tile: queries (dk, dv) or keys (dq)
constexpr int WARPS = 4;     // each owns 16 of the BM rows
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// Strides in elements: q, k and v share one set, do has its own; the
// outputs, lse and di are contiguous.
struct Strides {
  long long sb, sh, sn, db, dh, dn;
};

// Shared-memory row pitch, in elements, of an HD-wide tile and of a warp's
// 16 x BN tile of p or ds: 16 bytes of padding in bf16, so the 32-bit
// fragment loads of 8 rows by 4 columns hit 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int pad() {
  return sizeof(T) == 2 ? 8 : 4;
}
template <typename T, int HD>
__host__ __device__ constexpr int tile_pitch() {
  return HD + pad<T>();
}
template <typename T>
__host__ __device__ constexpr int scratch_pitch() {
  return BN + pad<T>();
}

// Dynamic shared memory: four HD-wide tiles (two owned, two streamed), a
// warp's p and ds tiles (dk, dv) or its ds tile (dq), and the streamed
// queries' lse and di (dk, dv).
template <typename T, int HD, bool DKV>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * BM * tile_pitch<T, HD>() * static_cast<int>(sizeof(T)) +
         (DKV ? 2 : 1) * WARPS * 16 * scratch_pitch<T>() * static_cast<int>(sizeof(T)) + (DKV ? 2 * BN * 4 : 0);
}

// CTAs an SM must hold, for ptxas's register budget: in f32 two (at most two
// fit beside their shared memory at hd 64 and 80), which leaves each thread
// up to 255 registers; with no such bound ptxas kept the f32 hd-80 dQ
// kernel to 168 and spilled. bf16: one, the same 255.
template <typename T>
__host__ __device__ constexpr int min_ctas() {
  return sizeof(T) == 4 ? 2 : 1;
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two adjacent values, rounded to the element type.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// c[16][8·NT] += A[16][K] · B[K][8·NT] for one warp: A row-major (the depth
// contiguous) at a with pitch pa; B stored transposed as Bt[8·NT][K] (BT,
// the depth contiguous) or as B[K][8·NT], at b with pitch pb. Fragment
// element (row g or g + 8, column 8j + 2t or + 1) is c[j][0..3], with g =
// lane / 4 and t = lane % 4.
template <int NT, int K, bool BT>
__device__ __forceinline__ void mma_tile(float (&c)[NT][4], const __nv_bfloat16* a, int pa, const __nv_bfloat16* b,
                                         int pb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t af[4] = {ld2(a + g * pa + k0 + 2 * t), ld2(a + (g + 8) * pa + k0 + 2 * t),
                            ld2(a + g * pa + k0 + 2 * t + 8), ld2(a + (g + 8) * pa + k0 + 2 * t + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bf[2];
      if constexpr (BT) {
        const __nv_bfloat16* bj = b + (8 * j + g) * pb + k0 + 2 * t;
        bf[0] = ld2(bj);
        bf[1] = ld2(bj + 8);
      } else {
        const __nv_bfloat16* bj = b + (k0 + 2 * t) * pb + 8 * j + g;
        bf[0] = pack(bj[0], bj[pb]);
        bf[1] = pack(bj[8 * pb], bj[9 * pb]);
      }
      mma_bf16(c[j], af, bf);
    }
  }
}

// The same in f32 as 3xTF32: the cross terms (A small · B big, A big · B
// small) over the whole depth first, then A big · B big.
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
template <int NT, int K, typename T>
__device__ __forceinline__ void add_tile(float (&acc)[NT][4], const T* a, int pa, const T* b, int pb, int lane) {
  float part[NT][4] = {};
  mma_tile<NT, K, false>(part, a, pa, b, pb, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// Rows row0.. of one (b, h) matrix (row stride sn, unit stride along hd) into
// a BM-row tile of pitch tile_pitch<T, HD>, rows at or past n as zeros: 16
// bytes a thread at a time.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long sn, int row0, int n) {
  constexpr int CH = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte units a row
  constexpr int PB = tile_pitch<T, HD>() * static_cast<int>(sizeof(T));
  for (int c = threadIdx.x; c < BM * CH; c += THREADS) {
    const int r = c / CH, u = c % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      x = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(src + (row0 + r) * sn) + 16 * u);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + r * PB + 16 * u) = x;
  }
}

// The warp's 16 rows of an accumulator (f32, fragment layout) into the
// contiguous (b, h) matrix out (n rows of HD), rows row0.. below n.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[HD / 8][4], int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) store2(out + row * HD + 8 * j + 2 * t, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// dk and dv of one 64-key tile (blockIdx.x) of one (b, h) (blockIdx.y).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, min_ctas<T>())
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int heads, int n, Strides st, float scale, float sl2) {
  constexpr int TP = tile_pitch<T, HD>(), SP = scratch_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BM * TP;
  T* qs = vs + BM * TP;
  T* dos = qs + BN * TP;
  T* ps = dos + BN * TP;             // [WARPS][16][SP] pᵀ, in do's dtype
  T* dss = ps + WARPS * 16 * SP;     // [WARPS][16][SP] dsᵀ, in the input dtype
  float* lse_s = reinterpret_cast<float*>(dss + WARPS * 16 * SP);  // [BN] lse·log2(e), +inf past n
  float* di_s = lse_s + BN;                                          // [BN] di, 0 past n
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * BM;
  const long long rows = static_cast<long long>(bh) * n;  // (b, h)'s first row of lse, di and the outputs
  const T* qh = q + b * st.sb + h * st.sh;
  const T* doh = dout + b * st.db + h * st.dh;
  load_tile<T, HD>(ks, k + b * st.sb + h * st.sh, st.sn, key0, n);
  load_tile<T, HD>(vs, v + b * st.sb + h * st.sh, st.sn, key0, n);
  const T* kw = ks + warp * 16 * TP;
  const T* vw = vs + warp * 16 * TP;
  T* pw = ps + warp * 16 * SP;
  T* dsw = dss + warp * 16 * SP;
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};
  for (int q0 = 0; q0 < n; q0 += BN) {
    __syncthreads();  // the last tile is read (and, the first time, K and V are in place)
    load_tile<T, HD>(qs, qh, st.sn, q0, n);
    load_tile<T, HD>(dos, doh, st.dn, q0, n);
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
  store_rows<T, HD>(dk + rows * HD, dk_acc, key0 + warp * 16, n, lane);
  store_rows<T, HD>(dv + rows * HD, dv_acc, key0 + warp * 16, n, lane);
}

// dq of one 64-query tile (blockIdx.x) of one (b, h) (blockIdx.y).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, min_ctas<T>())
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int heads, int n, Strides st, float scale, float sl2) {
  constexpr int TP = tile_pitch<T, HD>(), SP = scratch_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BM * TP;
  T* ks = dos + BM * TP;
  T* vs = ks + BN * TP;
  T* dss = vs + BN * TP;  // [WARPS][16][SP] ds, in the input dtype
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM + warp * 16;  // the warp's first query
  const long long rows = static_cast<long long>(bh) * n;
  const T* kh = k + b * st.sb + h * st.sh;
  const T* vh = v + b * st.sb + h * st.sh;
  load_tile<T, HD>(qs, q + b * st.sb + h * st.sh, st.sn, blockIdx.x * BM, n);
  load_tile<T, HD>(dos, dout + b * st.db + h * st.dh, st.dn, blockIdx.x * BM, n);
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
    load_tile<T, HD>(ks, kh, st.sn, k0, n);
    load_tile<T, HD>(vs, vh, st.sn, k0, n);
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
  store_rows<T, HD>(dq + rows * HD, dq_acc, row0, n, lane);
}

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

// One kernel (0: dk and dv into out0 and out1; 1: dq into out0) at one
// width and type on the current device; the shared-memory attribute is set
// once per device. Returns 0 or a cudaError_t.
template <typename T, int HD>
int launch(const Call& c) {
  static std::atomic<uint64_t> dkv_set{0}, dq_set{0};
  const dim3 grid((c.n + BM - 1) / BM, c.batch * c.heads);
  const float sl2 = c.scale * LOG2E;
  const T* q = static_cast<const T*>(c.q);
  const T* k = static_cast<const T*>(c.k);
  const T* v = static_cast<const T*>(c.v);
  const T* dout = static_cast<const T*>(c.dout);
  cudaError_t e;
  if (c.kernel == 0) {
    constexpr int SMEM = smem_bytes<T, HD, true>();
    e = hopper::allow_smem_once(flash_bwd_dkv<T, HD>, SMEM, c.device, dkv_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv<T, HD><<<grid, THREADS, SMEM, c.stream>>>(q, k, v, dout, c.lse, c.di, static_cast<T*>(c.out0),
                                                            static_cast<T*>(c.out1), c.heads, c.n, c.st, c.scale,
                                                            sl2);
  } else {
    constexpr int SMEM = smem_bytes<T, HD, false>();
    e = hopper::allow_smem_once(flash_bwd_dq<T, HD>, SMEM, c.device, dq_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq<T, HD><<<grid, THREADS, SMEM, c.stream>>>(q, k, v, dout, c.lse, c.di, static_cast<T*>(c.out0),
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
// (is_bf16 = 0) or all bf16 (is_bf16 = 1); hd is 32, 64 or 80; n >= 1,
// batch · heads <= 65,535. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int flash_bwd_launch(int kernel, const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* out0, void* out1, int batch, int heads,
                                int n, int hd, long long sb, long long sh, long long sn, long long db,
                                long long dh, long long dn, float scale, int is_bf16, int device, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || batch * heads > 65535 || kernel < 0 || kernel > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Call c{kernel, q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di), out0, out1,
               batch, heads, n, Strides{sb, sh, sn, db, dh, dn}, scale, device, static_cast<cudaStream_t>(stream)};
  int r = static_cast<int>(cudaErrorInvalidValue);
  switch (hd * 2 + (is_bf16 ? 1 : 0)) {
    case 65: r = launch<__nv_bfloat16, 32>(c); break;
    case 129: r = launch<__nv_bfloat16, 64>(c); break;
    case 161: r = launch<__nv_bfloat16, 80>(c); break;
    case 64: r = launch<float, 32>(c); break;
    case 128: r = launch<float, 64>(c); break;
    case 160: r = launch<float, 80>(c); break;
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
    case 65: return dkv ? smem_bytes<__nv_bfloat16, 32, true>() : smem_bytes<__nv_bfloat16, 32, false>();
    case 129: return dkv ? smem_bytes<__nv_bfloat16, 64, true>() : smem_bytes<__nv_bfloat16, 64, false>();
    case 161: return dkv ? smem_bytes<__nv_bfloat16, 80, true>() : smem_bytes<__nv_bfloat16, 80, false>();
    case 64: return dkv ? smem_bytes<float, 32, true>() : smem_bytes<float, 32, false>();
    case 128: return dkv ? smem_bytes<float, 64, true>() : smem_bytes<float, 64, false>();
    case 160: return dkv ? smem_bytes<float, 80, true>() : smem_bytes<float, 80, false>();
    default: return 0;
  }
}
