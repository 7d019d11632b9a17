"""K3 bf16's order of work on the card, emulated in torch on the CPU.

The `wgmma` flash kernel (`flash_bf16_wgmma<HD>` in
hbird_tpu_torch/ops/csrc/flash_attn.cu) walks the keys in tiles of 128: s =
q·kᵀ in f32, scaled by scale·log2(e), an exp2 against the running row
maximum, p rounded to bf16 per tile for p·v, the output so far rescaled by
alpha = exp2(m_old - m_new), the unrounded p summed into l, and one division
by l at the end. `emulate` repeats that order with torch ops, so the
arithmetic that the card alone can run is held here against the plain
version (`flash_attention_plain`, which rounds the normalised p) and against
the JAX package's `_flash_attention` (the library Pallas TPU kernel in
interpret mode), at N = 1, 129 (one key past a tile) and 257 (mae_vith14 at
224: one key and one query past two tiles), hd 64 and 80.

Tolerance, the one `chip_smoke.check_flash` holds the card's bf16 output to:
each output within 4 bf16 ulps at its query row's scale (4 · 2^-8 · the
row's largest |reference output|) and the mean |error| under 2^-7 · mean
|reference output|. The kernel and the references round p at different
points (against the running maximum per tile, or after normalising), so
about half the outputs differ by about one ulp; the output's own rounding
adds at most one.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hbird_tpu.models.vit import _flash_attention
from hbird_tpu_torch.ops.flash import flash_attention_plain

TILE = 128  # keys per tile (BKV in flash_attn.cu)


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """bf16 (B, H, N, hd) q, k, v through the kernel's order of work."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sl2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(q.shape)
    for c0 in range(0, q.shape[2], TILE):
        x = torch.matmul(qf, kf[:, :, c0:c0 + TILE].transpose(-2, -1)) * sl2
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)  # 0 on the first tile
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(), vf[:, :, c0:c0 + TILE])
        m = m_new
    return (acc * (1.0 / l)).bfloat16()


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _reference(name, q, k, v, scale):
    if name == "plain":
        t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
        return flash_attention_plain(*t, scale).float()
    with pltpu.force_tpu_interpret_mode():
        j = _flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale)
    return torch.from_numpy(np.array(j.astype(jnp.float32)))


def _assert_within_check_flash(out, ref):
    err = (out.float() - ref).abs()
    row = 2.0**-8 * ref.abs().amax(dim=-1, keepdim=True)
    assert (err <= 4 * row).all(), (err / row.clamp_min(1e-30)).max().item()
    assert err.mean().item() <= 2.0**-7 * ref.abs().mean().item(), err.mean().item()


@pytest.mark.parametrize("reference", ["plain", "tpu_interpret"])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("n", [1, 129, 257])
def test_tile_order_matches_the_references(n, hd, reference):
    q, k, v = _qkv((2, 2, n, hd), seed=7 * n + hd)
    scale = hd**-0.5
    out = emulate(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale)
    assert out.shape == (2, 2, n, hd) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    _assert_within_check_flash(out, _reference(reference, q, k, v, scale))


def test_tile_order_rounds_p_against_the_running_maximum():
    """The emulation is not the plain version in disguise: with keys spread
    over three tiles, rounding p per tile against the running maximum moves
    some outputs by an ulp (and stays within the tolerance)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((2, 2, 257, 80), seed=3))
    out = emulate(q, k, v, 80**-0.5)
    ref = flash_attention_plain(q, k, v, 80**-0.5)
    assert not torch.equal(out, ref)
    _assert_within_check_flash(out, ref.float())
