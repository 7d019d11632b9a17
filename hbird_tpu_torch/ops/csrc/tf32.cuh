// f32 products at f32 accuracy on the TF32 tensor cores (3xTF32), shared by
// K3 f32 (flash_attn.cu, wgmma m64n64k8 and m64n{32,64,80}k8), K1 and K2
// f32 (wgmma_topk.cuh, wgmma m64n128k8) and K3-bwd f32 (flash_bwd.cu, wgmma
// m64n{16,32}k8 with both operands in shared memory and m64n{32,64,80}k8).
//
// Each f32 operand x is split into big = tf32(x) and small = tf32(x - big),
// both rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero;
// the rounding is held fixed: tests/tf32_emulation.py emulates it), and a
// product is big·small + small·big + big·big with f32 accumulation: about
// 21 bits of each operand. The tensor cores read 32-bit operands and ignore
// their 13 low mantissa bits, so both parts hold values already rounded
// here: the parts, and so every product of two parts, are exactly those of
// the CPU emulation. The sums are not: the tensor cores add a chunk's
// products in their own order, rounding toward zero, and the emulation adds
// them with torch matmuls, rounding to nearest, so the two agree to within
// the f32 tolerance, not bit for bit. The kernels keep each chain of
// products into one accumulator short and add the chains in f32 registers,
// rounding to nearest.

#pragma once

#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding, as two integer operations (the
// magnitude bits gain half the dropped unit, then the 13 low bits go);
// the instruction itself compiles to a longer sequence. Equal to cvt.rna
// on every input but NaN, which still leaves the output non-finite.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// big = tf32(x) and small = tf32(x - big), both rounded by rna; x - big is
// exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna(x);
  small = rna(__fsub_rn(x, __uint_as_float(big)));
}

}  // namespace tf32
