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
// tensor cores for bf16 (mma.sync m16n8k16, f32 accumulation), fed by a
// two-stage cp.async ring of 64-key K/V tiles, and the scores, the softmax
// and p never leave registers: p is re-packed from the q·kᵀ accumulator
// layout straight into the A operand of p·v. f32 inputs use FMAs on a
// 64×64 score tile in shared memory (no TF32, which would round the
// inputs).
//
// Design: one CTA per (b, h, 64-query block); the TPU grid's sequential
// key axis becomes the loop over 64-key tiles inside the CTA, with the
// running max m, the sum l and the f32 output accumulator kept across it.
// bf16: 4 warps, each owning 16 query rows and the whole 64-key tile. f32:
// 256 threads, each owning a 4×4 part of the score tile and 4 rows × hd/16
// columns of the output. q, k and v are read through strides (the ViT hands
// over views of its qkv projection) and o is written through its own (the
// wrapper lays it out so that the heads merge back without a copy). Head
// widths 32, 64 and 80 (every VIT_PRESETS width) are instantiated.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see ../cuda_build.py, which builds it at first use).

#include "topk_common.cuh"  // cp_async16, ldmatrix_x4, mma_bf16, allow_smem, neg_inf

namespace {

constexpr int FQ = 64;  // queries per CTA
constexpr int FK = 64;  // keys per tile
constexpr int BF16_THREADS = 128;
constexpr int F32_THREADS = 256;

// q/k/v (shared) and o strides, in elements.
struct Layout {
  long long sb, sh, sn;
  long long ob, oh, on;
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

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
// bf16: tensor cores.
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS)
    flash_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int heads,
               int n, Layout lay, float scale) {
  constexpr int LD = HD + 8;  // 16-byte pad: ldmatrix's eight rows hit distinct banks
  constexpr int KSTEPS = HD / 16;
  constexpr int DT = HD / 8;  // n8 tiles of the output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [FQ][LD]
  __nv_bfloat16* ks = qs + FQ * LD;                                 // [2][FK][LD]
  __nv_bfloat16* vs = ks + 2 * FK * LD;                             // [2][FK][LD]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * FQ;
  const long long off = b * lay.sb + h * lay.sh;
  q += off;
  k += off;
  v += off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  load_tile<HD, LD>(qs, q, q0, n, lay.sn, BF16_THREADS);
  load_tile<HD, LD>(ks, k, 0, n, lay.sn, BF16_THREADS);
  load_tile<HD, LD>(vs, v, 0, n, lay.sn, BF16_THREADS);
  asm volatile("cp.async.commit_group;\n" ::);

  unsigned qa[KSTEPS][4];  // the warp's 16 query rows as A fragments
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // Rows g = lane/4 (elements 0, 1) and g + 8 (elements 2, 3) of the warp.
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  const int n_tiles = (n + FK - 1) / FK;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      const int st = (t + 1) & 1;
      load_tile<HD, LD>(ks + st * FK * LD, k, (t + 1) * FK, n, lay.sn, BF16_THREADS);
      load_tile<HD, LD>(vs + st * FK * LD, v, (t + 1) * FK, n, lay.sn, BF16_THREADS);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile's copies are visible to every warp
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qa[kk], qs + row * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* kt = ks + (t & 1) * FK * LD;
    const __nv_bfloat16* vt = vs + (t & 1) * FK * LD;

    // s = q·kᵀ: 16 rows × 64 keys per warp, 8 n8 tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned r[4];
        const int row = j * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r, kt + row * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * j + 1], qa[kk], r[2], r[3]);
      }
    }

    // Scale, mask the ragged edge, and take the tile's row maxima.
    const int col0 = t * FK + (lane & 3) * 2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + j * 8 + (e & 1);
        s[j][e] = col < n ? s[j][e] * scale : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = __expf(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p·v: the accumulator layout of two n8 score tiles is the A
    // fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned r[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, vt + key * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Normalise once and store the rows below n.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = 1.0f / l[i];
  }
  o += b * lay.ob + h * lay.oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(o + row * lay.on + col) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs.
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int heads, int n, Layout lay,
              float scale) {
  constexpr int LDT = FQ + 4;  // q and k staged transposed: [HD][LDT]
  constexpr int LDV = HD + 4;  // v row-major: [FK][LDV]
  constexpr int LDP = FK + 4;  // p: [FQ][LDP]
  constexpr int DJ = HD / 16;  // output columns per thread: tx + 16·j
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;
  float* kt = qt + HD * LDT;
  float* vs = kt + HD * LDT;
  float* ps = vs + FK * LDV;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * FQ;
  const long long off = b * lay.sb + h * lay.sh;
  q += off;
  k += off;
  v += off;
  const int tx = threadIdx.x & 15;  // score columns tx·4.., output columns tx + 16·j
  const int ty = threadIdx.x >> 4;  // rows ty·4..ty·4+3; a row's 16 threads share a half-warp

  // Stage rows [row0, row0 + 64) transposed into dst[HD][LDT]; zeros past n.
  auto stage_t = [&](float* dst, const float* src, int row0) {
    for (int i = threadIdx.x; i < 64 * (HD / 4); i += F32_THREADS) {
      const int r = i / (HD / 4);
      const int c = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row0 + r < n)
        x = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * lay.sn + c);
      dst[(c + 0) * LDT + r] = x.x;
      dst[(c + 1) * LDT + r] = x.y;
      dst[(c + 2) * LDT + r] = x.z;
      dst[(c + 3) * LDT + r] = x.w;
    }
  };

  stage_t(qt, q, q0);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.0f;
  }

  const int n_tiles = (n + FK - 1) / FK;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // earlier readers of kt, vs and ps are done
    stage_t(kt, k, t * FK);
    load_tile<HD, LDV>(vs, v, t * FK, n, lay.sn, F32_THREADS);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kt[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = t * FK + tx * 4 + j < n ? s[i][j] * scale : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        l[i] += s[i][j];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * LDP + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < FK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * LDP + c]);
        pr[i][0] = x.x;
        pr[i][1] = x.y;
        pr[i][2] = x.z;
        pr[i][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = vs[(c + cc) * LDV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i][cc], vv, acc[i][j]);
        }
    }
  }

  o += b * lay.ob + h * lay.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l[i] += __shfl_xor_sync(FULL, l[i], w);
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[row * lay.on + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                   int n, Layout lay, float scale, int is_bf16, cudaStream_t stream) {
  const dim3 grid((n + FQ - 1) / FQ, batch * heads);
  if (is_bf16) {
    const size_t smem = 5 * 64 * (HD + 8) * sizeof(__nv_bfloat16);  // q, 2 × (k, v)
    const cudaError_t e = allow_smem(flash_bf16<HD>, smem);
    if (e != cudaSuccess) return e;
    flash_bf16<HD><<<grid, BF16_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), heads, n, lay,
        scale);
  } else {
    const size_t smem = (2 * HD * (FQ + 4) + FK * (HD + 4) + FQ * (FK + 4)) * sizeof(float);
    const cudaError_t e = allow_smem(flash_f32<HD>, smem);
    if (e != cudaSuccess) return e;
    flash_f32<HD><<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), heads, n, lay, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch K3 on `stream`. q, k, v are (batch, heads, n, hd) arrays with one
// shared set of element strides (sb, sh, sn) and a unit stride along hd; o
// has strides (ob, oh, on) and a unit stride along hd. All f32 (is_bf16 =
// 0) or all bf16 (is_bf16 = 1); hd is 32, 64 or 80; pointers and strides
// are 16-byte aligned. n >= 1, batch · heads <= 65,535.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int n, int hd, long long sb, long long sh,
                                 long long sn, long long ob, long long oh, long long on,
                                 float scale, int is_bf16, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{sb, sh, sn, ob, oh, on};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch<32>(q, k, v, o, batch, heads, n, lay, scale, is_bf16, s); break;
    case 64: e = launch<64>(q, k, v, o, batch, heads, n, lay, scale, is_bf16, s); break;
    case 80: e = launch<80>(q, k, v, o, batch, heads, n, lay, scale, is_bf16, s); break;
    default: e = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(e);
}
