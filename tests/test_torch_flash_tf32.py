"""K3 f32's 3xTF32 products and order of work, emulated in torch, against
the f32 numerics.

The CUDA kernel (ops/csrc/flash_attn.cu, `flash_f32_wgmma`) runs both of
K3's products on TF32 tensor cores: each f32 operand x is split into
big = tf32(x) and small = tf32(x - big), rounded by cvt.rna.tf32.f32 (to
nearest, ties away from zero, 10 stored mantissa bits), and a product is
big·small + small·big + big·big with f32 accumulation. The kernel runs only
on the card; this file holds the design on the CPU:
- `tf32_rna` (tests/tf32_emulation.py, shared with K1 f32's emulation in
  test_torch_knn_tf32.py) is that rounding, bit for bit by construction
  (the magnitude bits rounded at bit 13, half away from zero);
- `flash_3xtf32` is flash_attention_plain's numerics with both products
  taken in 3xTF32. It is within 1e-5 of the f32 plain version and of the
  JAX package's `_flash_attention` (JAX's library Pallas TPU kernel, run
  in interpret mode) for N in {1, 50, 197, 600} and hd in {32, 64, 80} on
  unit-normal inputs: the f32 tolerance K3 is held to on the card. A
  single TF32 pass (big·big alone) misses that tolerance, so the three
  passes are what keeps it;
- `emulate_tiles` is the kernel's order of work: 64-key tiles; s in
  3xTF32 with the cross terms (q small · K big, q big · K small) summed
  first and q big · K big last, scaled by scale·log2(e); an exp2 against
  the running row maximum; p split into TF32 parts per tile; the tile's
  p·v in 3xTF32 in the same order into a fresh sum, added to the output so
  far rescaled by alpha = exp2(m_old - m_new); the unsplit p summed into l;
  one division by l at the end. The sums are torch's, rounded to nearest,
  where the tensor cores round toward zero, so it agrees with the card to
  the f32 tolerance, not bit for bit. It is held within 1e-5 of the same
  two references at N in {1, 129 (one key past two tiles), 197
  (mocov3_vits16 at 224), 257 (mae_vith14 at 224)}, hd in {32, 64, 80}.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hbird_tpu.models.vit import _flash_attention
from hbird_tpu_torch.ops.flash import flash_attention_plain
from tf32_emulation import matmul_3xtf32, split_tf32, tf32_rna

F32_TOL = 1e-5
TILE = 64  # K3 f32's keys per tile (FBK in flash_attn.cu)


def flash_3xtf32(q, k, v, scale, passes=3):
    """flash_attention_plain's numerics (f32) with its two products in
    3xTF32 (`passes=1`: big·big alone, one TF32 pass)."""
    mm = matmul_3xtf32 if passes == 3 else (lambda a, b: tf32_rna(a) @ tf32_rna(b))
    s = mm(q, k.transpose(-2, -1)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return mm(p, v)


def _3xtf32(a_big, a_small, b_big, b_small):
    """a @ b from split parts in the kernel's order: cross terms, then big·big."""
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def emulate_tiles(q, k, v, scale):
    """f32 (B, H, N, hd) q, k, v through flash_f32_wgmma's order of work."""
    sl2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(q.shape)
    qb, qs = split_tf32(q)
    for c0 in range(0, q.shape[2], TILE):
        kb, ks = split_tf32(k[:, :, c0:c0 + TILE].transpose(-2, -1))
        x = _3xtf32(qb, qs, kb, ks) * sl2
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)  # 0 on the first tile
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pb, ps = split_tf32(p)
        vb, vs = split_tf32(v[:, :, c0:c0 + TILE])
        acc = acc * alpha + _3xtf32(pb, ps, vb, vs)  # the tile's p·v: a fresh sum
        m = m_new
    return acc * (1.0 / l)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _case(n, hd):
    """The seeded (2, 2, n, hd) inputs and the library TPU kernel's output
    on them in interpret mode (one compile per shape for the file)."""
    q, k, v = _qkv((2, 2, n, hd), seed=n * 100 + hd)
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), hd**-0.5))
    return q, k, v, j


def test_rounding_is_to_nearest_ties_away():
    """Halfway cases go away from zero in both signs; others to nearest;
    the 13 low bits are clear; inf and 0 stay."""
    one_ulp = 2.0**-10  # a TF32 ulp at 1.0
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + 3 * one_ulp / 2,
                      1 + one_ulp / 2 - 2.0**-23, 1 + one_ulp / 2 + 2.0**-23,
                      float("inf"), -float("inf"), 0.0], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp, 1.0, 1 + one_ulp,
                         float("inf"), -float("inf"), 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = tf32_rna(torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32)))
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()


def test_split_keeps_about_21_bits():
    """big + small equals x to within 2^-21 of |x| (big alone: 2^-11)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=100000).astype(np.float32))
    big, small = split_tf32(x)
    x64, b64, s64 = x.double(), big.double(), small.double()
    assert ((x64 - b64).abs() <= 2.0**-11 * x64.abs()).all()
    assert ((x64 - b64 - s64).abs() <= 2.0**-21 * x64.abs()).all()


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("n", [1, 50, 197, 600])
def test_3xtf32_matches_f32_and_the_tpu_kernel(n, hd):
    """3xTF32 within 1e-5 of the f32 plain version and of the library TPU
    kernel in interpret mode; one TF32 pass does not keep 1e-5 (N > 1)."""
    q, k, v, j = _case(n, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale = hd**-0.5
    out = flash_3xtf32(tq, tk, tv, scale)
    plain = flash_attention_plain(tq, tk, tv, scale)
    assert out.dtype == torch.float32 and out.shape == (2, 2, n, hd)
    assert (out - plain).abs().max().item() <= F32_TOL
    assert np.abs(out.numpy() - j).max() <= F32_TOL
    if n > 1:
        one_pass = flash_3xtf32(tq, tk, tv, scale, passes=1)
        assert (one_pass - plain).abs().max().item() > F32_TOL


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("n", [1, 129, 197, 257])
def test_tile_order_matches_f32_and_the_tpu_kernel(n, hd):
    """The kernel's order of work within 1e-5 of the f32 plain version and
    of the library TPU kernel in interpret mode."""
    q, k, v, j = _case(n, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = emulate_tiles(tq, tk, tv, hd**-0.5)
    assert out.dtype == torch.float32 and out.shape == (2, 2, n, hd) and torch.isfinite(out).all()
    assert (out - flash_attention_plain(tq, tk, tv, hd**-0.5)).abs().max().item() <= F32_TOL
    assert np.abs(out.numpy() - j).max() <= F32_TOL


def test_tile_order_is_not_the_plain_version():
    """With keys over several tiles, the per-tile running maximum, the split
    p and the per-tile sums move outputs off the plain version's and the
    whole-row 3xTF32 version's bits, within the tolerance."""
    q, k, v, _ = _case(257, 80)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = emulate_tiles(tq, tk, tv, 80**-0.5)
    for ref in (flash_attention_plain(tq, tk, tv, 80**-0.5), flash_3xtf32(tq, tk, tv, 80**-0.5)):
        assert not torch.equal(out, ref)
        assert (out - ref).abs().max().item() <= F32_TOL
