"""3xTF32 products, emulated in torch: the rounding and the split that the
port's f32 kernels (K3 f32 on mma.sync, K1 f32 on wgmma) share
(hbird_tpu_torch/ops/csrc/tf32.cuh).

Each f32 operand x is split into big = tf32(x) and small = tf32(x - big),
rounded by cvt.rna.tf32.f32 (to nearest, ties away from zero, 10 stored
mantissa bits), and a product is big·small + small·big + big·big with f32
accumulation. `tf32_rna` is that rounding, bit for bit by construction (the
magnitude bits rounded at bit 13, half away from zero). Products of two
TF32 values are exact in f32, so torch's f32 matmul of the parts on the CPU
differs from the tensor cores only in the order and rounding of the sums.
"""

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 `x`: the 13 low mantissa bits rounded off,
    to nearest, ties away from zero (the magnitude bits gain half the
    dropped unit, then lose the 13 bits), as an f32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: the two small cross terms, then
    big·big, each product of TF32 values exact in f32, sums in f32."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb
