"""K3-bwd f32's 3xTF32 products and order of work, emulated in torch, against
the f32 numerics.

The CUDA kernels (ops/csrc/flash_bwd.cu, `flash_bwd_dkv<float, HD>` and
`flash_bwd_dq<float, HD>`) run every product of the backward on TF32
tensor cores with `wgmma`: each f32 operand x is split into big = tf32(x)
and small = tf32(x - big), rounded by cvt.rna.tf32.f32 (`tf32_rna`,
tests/tf32_emulation.py), and a product is small·big + big·small, then
big·big, with f32 accumulation. The kernels run only on the card; this
file holds their order of work on the CPU (`emulate_bwd`):
- s = q·kᵀ and dp = do·vᵀ over the head dims in 3xTF32, the cross terms
  summed first and big·big last;
- p = exp2(s·scale·log2(e) - lse·log2(e)) (one rounding of the product
  and difference, as the kernels' fma), ds = p·(dp - di)·scale, in f32;
- dv = pᵀ·do and dk = dsᵀ·q over tiles of TILE[hd] streamed queries, dq =
  ds·k over tiles of as many streamed keys: p and ds split into TF32 parts
  per tile, each tile's product in 3xTF32 in the same order into a fresh
  sum, the even tiles' sums added into one f32 part and the odd tiles'
  into another (the two consumer warpgroups take the tiles in turn), and
  the two parts added at the end. The sums are torch's, rounded to
  nearest, where the tensor cores round toward zero, so the emulation
  agrees with the card to the f32 tolerance, not bit for bit.
It is held within 1e-5·S (S the largest |value| of the three reference
gradients, as on the card) of the f32 plain halves
(ops/flash.py::flash_attention_dkv_plain, flash_attention_dq_plain) and of
the library TPU backward kernels (`_flash_attention_dkv_kernel`,
`_flash_attention_dq_kernel`) in interpret mode, at N in {1, 65 (a row
past the tiles), 197 (mocov3_vits16 at 224), 257 (mae_vith14 at 224)}, hd
in {32, 64, 80}: the f32 tolerance K3-bwd is held to on the card. A single
TF32 pass (big·big alone) misses that tolerance.
"""

import functools
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu_torch.ops.flash import (
    flash_attention_di,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_plain,
)
from test_torch_flash_bwd import _library_vjp
from tf32_emulation import split_tf32, tf32_rna

F32_TOL = 1e-5
# Streamed rows of a tile by head width (flash_bwd.cu's fbs): 32, and 16 at
# hd 80, where the split stages of 32 rows would not fit.
TILE = {32: 32, 64: 32, 80: 16}
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _mm(a, b, passes=3):
    """a @ b as the kernels issue it: the two cross terms, then big·big
    (`passes=1`: big·big alone, one TF32 pass)."""
    if passes == 1:
        return tf32_rna(a.contiguous()) @ tf32_rna(b.contiguous())
    ab, as_ = split_tf32(a.contiguous())
    bb, bs = split_tf32(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def emulate_bwd(q, k, v, lse, do, di, scale, passes=3):
    """(dq, dk, dv) of f32 (B, H, N, hd) attention through the f32 K3-bwd
    kernels' order of work, given the forward's lse and di (B, H, N)."""
    n, hd = q.shape[-2:]
    rows = TILE[hd]
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    s = _mm(q, k.transpose(-2, -1), passes)
    dp = _mm(do, v.transpose(-2, -1), passes)
    x = s.double() * sl2.double() - (lse * LOG2E).double().unsqueeze(-1)  # exact, then one rounding: the fma
    p = torch.exp2(x.float())
    ds = p * (dp - di.unsqueeze(-1)) * scale

    def tiled(a, b):
        """a (.., rows out, N streamed) @ b (.., N, hd) over the streamed
        tiles, even and odd tiles into two parts, added at the end."""
        parts = [torch.zeros(a.shape[:-1] + (hd,)), torch.zeros(a.shape[:-1] + (hd,))]
        for t, r0 in enumerate(range(0, n, rows)):
            parts[t % 2] = parts[t % 2] + _mm(a[..., r0:r0 + rows], b[..., r0:r0 + rows, :], passes)
        return parts[1] + parts[0]

    return tiled(ds, k), tiled(ds.transpose(-2, -1), q), tiled(p.transpose(-2, -1), do)


@functools.lru_cache(maxsize=None)
def _case(n, hd):
    """Seeded (1, 2, n, hd) q, k, v, do; the library TPU backward kernels'
    (dq, dk, dv) on them in interpret mode, its forward output o; lse from
    the plain forward and di from o (one compile per shape for the file)."""
    rng = np.random.default_rng(n * 1000 + hd)
    q, k, v, do = (rng.normal(size=(1, 2, n, hd)).astype(np.float32) for _ in range(4))
    scale = hd**-0.5
    o, lib = _library_vjp(*(jnp.asarray(a) for a in (q, k, v, do)), scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, lse = flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    di = flash_attention_di(torch.from_numpy(np.array(o)), tdo)
    return (tq, tk, tv, lse, tdo, di, scale), tuple(np.asarray(g) for g in lib)


def _plain(args):
    q, k, v, lse, do, di, scale = args
    return (flash_attention_dq_plain(q, k, v, lse, do, di, scale),
            *flash_attention_dkv_plain(q, k, v, lse, do, di, scale))


def _worst(got, ref):
    """The largest |err| of (dq, dk, dv) over S, the largest |value| of the
    three reference gradients (the card's 1e-5·S: at N = 1 dq and dk vanish
    in exact arithmetic and both sides return rounding noise)."""
    s = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    return max(float(np.abs(g.numpy() - np.asarray(r)).max()) for g, r in zip(got, ref)) / s


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("n", [1, 65, 197, 257])
def test_tile_order_matches_f32_and_the_tpu_kernels(n, hd):
    """The kernels' order of work within 1e-5·S of the f32 plain halves and
    of the library TPU backward kernels in interpret mode, S the largest
    |value| of each reference's three gradients; one TF32 pass misses
    that."""
    args, lib = _case(n, hd)
    got = emulate_bwd(*args)
    assert all(g.dtype == torch.float32 and g.shape == (1, 2, n, hd) and torch.isfinite(g).all() for g in got)
    for ref in (_plain(args), lib):
        assert _worst(got, ref) <= F32_TOL, _worst(got, ref)
    if n > 1:
        assert _worst(emulate_bwd(*args, passes=1), _plain(args)) > F32_TOL


def test_tile_order_is_not_the_plain_version():
    """With queries and keys over several tiles, the per-tile split of p and
    ds, the per-tile sums and the two parts move gradients off the bits of
    the plain version and of a whole-row 3xTF32 product, within the
    tolerance."""
    args, _ = _case(257, 80)
    q, k, v, lse, do, di, scale = args
    got = emulate_bwd(*args)
    p = torch.exp(_mm(q, k.transpose(-2, -1)) * scale - lse.unsqueeze(-1))
    ds = (_mm(do, v.transpose(-2, -1)) - di.unsqueeze(-1)) * p * scale
    whole = (_mm(ds, k), _mm(ds.transpose(-2, -1), q), _mm(p.transpose(-2, -1), do))
    for ref in (_plain(args), whole):
        assert not all(torch.equal(g, r) for g, r in zip(got, ref))
        assert _worst(got, ref) <= F32_TOL


def test_tiles_are_the_kernels():
    """TILE is what chip_smoke.py holds the library's f32 tiles to on the
    card (F32_BWD_TILE), and each tile's chain of truncating adds, 3·rows/8,
    stays at 12 or fewer."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.F32_BWD_TILE == TILE
    assert all(3 * rows // 8 <= 12 and rows % 8 == 0 for rows in TILE.values())
    assert math.isclose(float(LOG2E), math.log2(math.e), rel_tol=1e-7)
