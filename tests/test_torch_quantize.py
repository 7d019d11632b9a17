"""ops/quantize.py: the port's int8 quantizers against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances: codes identical and scales equal (both packages divide, take
maxima and round half to even in f32, one operation each);
`block_column_scales` within 1e-7. The anisotropic refinement compares f32
losses summed in another order, so a row whose two candidate losses tie
within f32 rounding may keep the other candidate: such rows are at most 2%
of the rows, and their two losses agree within 1e-4 relative. On both
packages the chosen codes never lose to round-to-nearest (loss within
1e-6 relative of it or below), and the chunked result equals the
unchunked one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops import quantize as jq
from hbird_tpu_torch.ops import quantize as tq


def _bank(m, d, seed, spread=2.0):
    """Rows spanning `spread` decades of dynamic range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    return x * (10.0 ** rng.uniform(-spread, 0, size=(m, 1))).astype(np.float32)


def _block_hetero_bank(m, d, dpb, seed):
    """Columns spanning 2 decades of range across blocks of `dpb`."""
    rng = np.random.default_rng(seed)
    col = np.repeat(10.0 ** np.linspace(-2, 0, -(-d // dpb)), dpb)[:d].astype(np.float32)
    return rng.normal(size=(m, d)).astype(np.float32) * col, col


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _aniso_loss(x, codes, denom, threshold):
    """Per-row anisotropic loss in f64 (the refinement's objective)."""
    x = x.astype(np.float64)
    d = x.shape[1]
    t2 = min(threshold**2, 0.99)
    eta = (d - 1) * t2 / (1 - t2)
    r = codes.astype(np.float64) * denom - x
    norm2 = np.maximum((x * x).sum(1, keepdims=True), 1e-12)
    par2 = ((r * x).sum(1, keepdims=True) / norm2) ** 2 * norm2
    return (eta * par2 + (r * r).sum(1, keepdims=True) - par2)[:, 0]


@pytest.mark.parametrize("per_row", [False, True], ids=["global", "per_row"])
@pytest.mark.parametrize("shape", [(300, 32), (7, 768), (1, 5)], ids=["bank", "wide", "one_row"])
def test_quantize_bank_int8_matches_jax(per_row, shape):
    x = _bank(*shape, seed=shape[0])
    x[0, :2] = 0.0  # zeros and exact halves stay on both sides of a tie
    codes, scale = tq.quantize_bank_int8(torch.from_numpy(x), per_row=per_row)
    jcodes, jscale = jq.quantize_bank_int8(jnp.asarray(x), per_row=per_row)
    assert codes.dtype == torch.int8 and codes.shape == shape
    assert scale.dtype == torch.float32 and scale.shape == ((shape[0], 1) if per_row else ())
    np.testing.assert_array_equal(_np(codes), _np(jcodes))
    np.testing.assert_array_equal(_np(scale), _np(jscale))
    assert np.abs(_np(codes)).max() <= 127


def test_round_half_to_even_on_both():
    """Values at exact halves of the scale round to the even code."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5]], np.float32)
    codes, _ = tq.quantize_bank_int8(torch.from_numpy(x), per_row=True)
    jcodes, _ = jq.quantize_bank_int8(jnp.asarray(x), per_row=True)
    np.testing.assert_array_equal(_np(codes)[0], [127, 0, 2, 2, 0, -2, 126])
    np.testing.assert_array_equal(_np(codes), _np(jcodes))


@pytest.mark.parametrize("shape", [(21, 64), (500, 3), (4, 768)])
def test_quantize_queries_int8_matches_jax(shape):
    q = _bank(*shape, seed=7, spread=1.0) * 3.0
    codes, scale = tq.quantize_queries_int8(torch.from_numpy(q))
    jcodes, jscale = jq.quantize_queries_int8(jnp.asarray(q))
    np.testing.assert_array_equal(_np(codes), _np(jcodes))
    assert float(scale) == float(jscale)
    codes_bf, _ = tq.quantize_queries_int8(torch.from_numpy(q).bfloat16())
    jcodes_bf, _ = jq.quantize_queries_int8(jnp.asarray(q).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_np(codes_bf), _np(jcodes_bf))


@pytest.mark.parametrize("d, dpb", [(30, 4), (32, 4), (768, 4), (16, 5), (8, 1), (6, 3)])
def test_block_column_scales_match_jax(d, dpb):
    x, _ = _block_hetero_bank(256, d, dpb, seed=d)
    x[:, :dpb] = 0.0  # an all-zero block: the 1e-4 floor
    c = tq.block_column_scales(torch.from_numpy(x), dpb)
    jc = jq.block_column_scales(jnp.asarray(x), dpb)
    assert c.shape == (d,) and c.dtype == torch.float32
    np.testing.assert_allclose(_np(c), _np(jc), rtol=0, atol=1e-7)
    # constant within each block, the largest block at 1
    blocks = -(-d // dpb)
    for b in range(blocks):
        blk = _np(c)[b * dpb : (b + 1) * dpb]
        assert (blk == blk[0]).all()
    assert np.isclose(_np(c).max(), 1.0) and (_np(c)[:dpb] == np.float32(1e-4)).all()


def test_block_column_scales_rejects_zero_block():
    with pytest.raises(ValueError, match="dims_per_block"):
        tq.block_column_scales(torch.zeros(4, 8), 0)


def test_aniso_eta_matches_jax():
    for d, t in ((768, 0.2), (32, 0.5), (4, 0.999), (16, 0.0)):
        assert tq._aniso_eta(d, t) == jq._aniso_eta(d, t)


@pytest.mark.parametrize("with_col", [False, True], ids=["rows", "rows_cols"])
@pytest.mark.parametrize("d, threshold", [(128, 0.4), (768, 0.2), (32, 0.2)])
def test_quantize_codes_aniso_matches_jax(d, threshold, with_col):
    x = _bank(256, d, seed=d, spread=1.0)
    col = _np(tq.block_column_scales(torch.from_numpy(x), 4)) if with_col else None
    xc = x / col if with_col else x
    scale = np.maximum(np.abs(xc).max(axis=1, keepdims=True), 1e-12).astype(np.float32) / np.float32(127)
    tcol = None if col is None else torch.from_numpy(col)
    codes = _np(tq.quantize_codes_aniso(torch.from_numpy(x), torch.from_numpy(scale), threshold,
                                        col_scale=tcol))
    jcodes = _np(jq.quantize_codes_aniso(jnp.asarray(x), jnp.asarray(scale), threshold,
                                         col_scale=None if col is None else jnp.asarray(col)))
    assert codes.dtype == np.int8
    denom = scale * col if with_col else scale
    loss_t = _aniso_loss(x, codes, denom, threshold)
    loss_j = _aniso_loss(x, jcodes, denom, threshold)
    nearest = np.clip(np.round(x / denom.astype(np.float32)), -127, 127)
    loss_n = _aniso_loss(x, nearest, denom, threshold)
    # never worse than round-to-nearest, on either package
    for loss in (loss_t, loss_j):
        assert (loss <= loss_n * (1 + 1e-6) + 1e-12).all()
    # identical codes except on near-tied rows, whose losses agree
    differ = (codes != jcodes).any(axis=1)
    assert differ.mean() <= 0.02, differ.mean()
    np.testing.assert_allclose(loss_t[differ], loss_j[differ], rtol=1e-4)


def test_aniso_refinement_moves_codes_and_cuts_the_parallel_residual():
    """At d = 128, T = 0.4 (eta >> 1) the refinement changes most rows and
    shrinks the parallel residual, as the JAX package's test states."""
    x = _bank(512, 128, seed=2, spread=1.0)
    scale = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-12) / np.float32(127)
    refined = _np(tq.quantize_codes_aniso(torch.from_numpy(x), torch.from_numpy(scale), 0.4))
    nearest = np.clip(np.round(x / scale), -127, 127)
    assert np.mean((refined != nearest).any(axis=1)) > 0.5
    assert _aniso_loss(x, refined, scale, 0.4).mean() < 0.95 * _aniso_loss(x, nearest, scale, 0.4).mean()
    norm2 = (x.astype(np.float64) ** 2).sum(1, keepdims=True)

    def par2(codes):
        r = codes * scale - x
        return (((r * x).sum(1, keepdims=True) / norm2) ** 2 * norm2).mean()

    assert par2(refined) < 0.25 * par2(nearest)


@pytest.mark.parametrize(
    "dpb, threshold", [(4, None), (None, 0.2), (4, 0.2), (None, None)],
    ids=["blocks", "aniso", "blocks_aniso", "rows_only"],
)
def test_quantize_bank_int8_ah_matches_jax(dpb, threshold):
    x, _ = _block_hetero_bank(300, 32, 4, seed=11)
    codes, scale, col = tq.quantize_bank_int8_ah(
        torch.from_numpy(x), dims_per_block=dpb, aniso_threshold=threshold
    )
    jcodes, jscale, jcol = jq.quantize_bank_int8_ah(
        jnp.asarray(x), dims_per_block=dpb, aniso_threshold=threshold
    )
    np.testing.assert_array_equal(_np(scale), _np(jscale))
    assert (col is None) == (jcol is None) == (dpb is None)
    if col is not None:
        np.testing.assert_allclose(_np(col), _np(jcol), rtol=0, atol=1e-7)
    differ = (_np(codes) != _np(jcodes)).any(axis=1)
    if threshold is None:
        assert not differ.any()
    else:
        assert differ.mean() <= 0.02


def test_quantize_bank_int8_ah_chunked_equals_unchunked():
    x = torch.from_numpy(_bank(300, 16, seed=3, spread=1.0))
    whole = tq.quantize_bank_int8_ah(x, dims_per_block=4, aniso_threshold=0.2, row_block=None)
    for block in (64, 7, 300, 1000):
        part = tq.quantize_bank_int8_ah(x, dims_per_block=4, aniso_threshold=0.2, row_block=block)
        assert torch.equal(part[0], whole[0])
        assert torch.equal(part[1], whole[1]) and torch.equal(part[2], whole[2])


def test_separable_dequant_recovers_small_columns():
    """Block scales keep the resolution of small-range columns that the
    per-row scheme loses to the row's largest dim."""
    x, col_factor = _block_hetero_bank(2048, 64, 4, seed=1)
    codes_r, s_r = tq.quantize_bank_int8(torch.from_numpy(x), per_row=True)
    codes_a, s_a, c = tq.quantize_bank_int8_ah(torch.from_numpy(x), dims_per_block=4)
    err_rows = np.abs(_np(codes_r).astype(np.float32) * _np(s_r) - x)
    err_ah = np.abs(_np(codes_a).astype(np.float32) * _np(s_a) * _np(c) - x)
    small = col_factor < 0.05
    scale = np.abs(x[:, small]).mean()
    assert err_ah[:, small].mean() / scale < err_rows[:, small].mean() / scale / 5
