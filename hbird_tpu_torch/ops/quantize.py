"""Symmetric int8 quantization shared by every int8 bank of the port.

Counterpart of hbird_tpu/ops/quantize.py, whole: a global abs-max scale
(`use_int8` / `quantization='int8'`) or per-row abs-max scales
(`quantization='int8_rows'` and `'int8_asym'`, the Faiss SQ8 analogue and
the cheap core of ScaNN's `score_ah`, reference
hbird/nn/search_scann.py:29-30), per-column-block scales
(`dimensions_per_block`) and anisotropic code refinement
(`anisotropic_quantization_threshold`). These are host-side tensor ops, not
kernels: the JAX package runs them in XLA outside any Pallas kernel. The
kernels that read the codes (K1, K2) dequantize the per-row scales in their
epilogue.

Rounding is half to even in both packages (`torch.round`, `jnp.round`), and
every division, maximum and clip is the same f32 operation, so codes and
scales are identical to the JAX package's. `quantize_codes_aniso` compares
f32 losses summed in another order, so a row whose two candidate losses
nearly tie may keep the other codes (tests/test_torch_quantize.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as a true division on every device: PyTorch multiplies a
    CUDA tensor divided by a Python scalar by the scalar's reciprocal,
    which can differ from the quotient in the last bit."""
    return x / torch.full((), 127.0, dtype=torch.float32, device=x.device)


def _round_codes(y: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to the symmetric int8 range (as f32)."""
    return torch.clamp(torch.round(y), -127.0, 127.0)


def global_scale(abs_max: torch.Tensor) -> torch.Tensor:
    """The global scale of a bank whose largest |entry| is `abs_max`."""
    return _over_127(torch.clamp(abs_max.float(), min=1e-12))


def quantize_bank_int8(
    bank_f: torch.Tensor, *, per_row: bool, scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a float bank to symmetric int8 codes.

    Returns `(codes, scale)`: int8 codes and a `(M, 1)` f32 scale when
    `per_row`, else a 0-d f32 scale. Dequantization is `codes * scale`.
    A given global `scale` (of a bank this is a slice of) is used as is.
    """
    x = bank_f.float()
    if per_row:
        scale = _over_127(torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12))
    elif scale is None:
        scale = global_scale(x.abs().max())
    else:
        scale = scale.to(x.device)
    return _round_codes(x / scale).to(torch.int8), scale


def block_column_scales(bank_f: torch.Tensor, dims_per_block: int) -> torch.Tensor:
    """Per-column relative scales `c` of shape `(d,)`, constant within each
    block of `dims_per_block` feature dims (ScaNN's `dimensions_per_block`,
    reference hbird/nn/search_scann.py:30): each block's scale is its column
    abs-max over the largest block's, floored at 1e-4. Dequantization stays
    separable (`codes * s_row[i] * c[j]`), so the search folds `c` into the
    queries and the kernels are untouched."""
    d = bank_f.shape[1]
    dpb = int(dims_per_block)
    if dpb < 1:
        raise ValueError(f"dims_per_block must be >= 1: {dims_per_block}")
    col_max = bank_f.float().abs().amax(dim=0)
    nb = -(-d // dpb)
    pad = nb * dpb - d
    if pad:
        col_max = torch.cat([col_max, col_max.new_zeros(pad)])
    blk = col_max.reshape(nb, dpb).amax(dim=1)
    blk = blk / torch.clamp(blk.max(), min=1e-12)
    blk = torch.clamp(blk, min=1e-4)  # all-zero blocks stay harmless
    return torch.repeat_interleave(blk, dpb)[:d].float()


def _aniso_eta(d: int, threshold: float) -> float:
    """ScaNN's parallel-residual weight at threshold T:
    eta = (d-1) T^2 / (1 - T^2)."""
    t2 = min(max(float(threshold) ** 2, 0.0), 0.99)
    return (d - 1) * t2 / max(1.0 - t2, 1e-6)


def _aniso_loss(x, deq, norm2, eta):
    """eta-weighted parallel residual plus the orthogonal rest, per row."""
    r = deq - x
    par_coef = (r * x).sum(dim=1, keepdim=True) / norm2
    par2 = par_coef * par_coef * norm2
    return eta * par2 + ((r * r).sum(dim=1, keepdim=True) - par2)


def quantize_codes_aniso(
    bank_f: torch.Tensor,
    scale: torch.Tensor,
    threshold: float,
    *,
    col_scale: Optional[torch.Tensor] = None,
    iters: int = 4,
) -> torch.Tensor:
    """int8 codes minimizing the anisotropic quantization loss (the
    score-aware objective behind ScaNN's `anisotropic_quantization_threshold`,
    reference hbird/nn/search_scann.py:29) instead of round-to-nearest.

    Iteratively re-rounds a target shifted against the measured parallel
    residual and keeps, per row, whichever codes score the lower loss, so
    the result never loses to round-to-nearest.
    """
    x = bank_f.float()
    denom = scale * col_scale if col_scale is not None else scale
    eta = torch.tensor(_aniso_eta(x.shape[1], threshold), dtype=torch.float32)
    norm2 = torch.clamp((x * x).sum(dim=1, keepdim=True), min=1e-12)

    def codes_of(y):
        return _round_codes(y / denom)

    best = codes_of(x)
    best_loss = _aniso_loss(x, best * denom, norm2, eta)
    one = torch.tensor(1.0, dtype=torch.float32)
    damp = one - one / (1.0 + eta)
    y = x
    for _ in range(max(1, int(iters))):
        codes = codes_of(y)
        r = codes * denom - x
        par_coef = (r * x).sum(dim=1, keepdim=True) / norm2
        y = y - damp * par_coef * x
        loss = _aniso_loss(x, codes * denom, norm2, eta)
        best = torch.where(loss < best_loss, codes, best)
        best_loss = torch.minimum(loss, best_loss)
    codes = codes_of(y)
    loss = _aniso_loss(x, codes * denom, norm2, eta)
    best = torch.where(loss < best_loss, codes, best)
    return best.to(torch.int8)


def quantize_bank_int8_ah(
    bank_f: torch.Tensor,
    *,
    dims_per_block: Optional[int] = None,
    aniso_threshold: Optional[float] = None,
    row_block: Optional[int] = 262144,
    col_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """`score_ah`-flavored scalar quantization: separable per-row x
    per-column-block scales plus anisotropic code refinement.

    Returns `(codes, row_scale (M, 1), col_scale (d,) or None)`;
    dequantization is `codes * row_scale * col_scale`. `row_block` chunks
    the anisotropic refinement's (block, d) f32 temporaries (~800 MB at
    d = 768); None refines all rows at once. A given `col_scale` (of a bank
    this is a slice of) replaces the one `dims_per_block` would measure.
    """
    col = col_scale
    if col is None and dims_per_block is not None:
        col = block_column_scales(bank_f, dims_per_block)
    xc = bank_f.float() / col if col is not None else bank_f.float()
    scale = _over_127(torch.clamp(xc.abs().amax(dim=1, keepdim=True), min=1e-12))
    if aniso_threshold is None:
        return _round_codes(xc / scale).to(torch.int8), scale, col
    m = bank_f.shape[0]
    step = m if row_block is None else max(1, int(row_block))
    codes = torch.cat([
        quantize_codes_aniso(bank_f[s : s + step], scale[s : s + step], aniso_threshold,
                             col_scale=col)
        for s in range(0, m, step)
    ]) if m else torch.zeros((0, bank_f.shape[1]), dtype=torch.int8, device=bank_f.device)
    return codes, scale, col


def quantize_queries_int8(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a query batch with one shared scale: `(q_int8, q_scale)`."""
    q32 = q.float()
    q_scale = _over_127(torch.clamp(q32.abs().max(), min=1e-12))
    return _round_codes(q32 / q_scale).to(torch.int8), q_scale
