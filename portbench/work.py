"""Operations and bytes of the work, counted from shapes and data.

A frozen copy of the arithmetic the port's kernel tables use
(`chip_smoke.py::bound_ms`, `ivf_bound_ms`, `flash_bound_ms`), kept here so
that no later change to the program can move the yardstick. Each input is
counted as read once and each output written once, whatever a kernel reads
again; a bound is the larger of operations over the peak rate and bytes over
the peak bandwidth.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(n_q: int, m_valid: int, d: int, k: int, elt_bytes: int = 2,
             peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """K1 (flat top-k): queries and bank rows read once, (value, id) pairs
    written once, or 2·Q·M·D operations."""
    bytes_moved = n_q * d * elt_bytes + m_valid * d * elt_bytes + n_q * k * (4 + 8)
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = k1_flops(n_q, m_valid, d) / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def k1_flops(n_q: int, m_valid: int, d: int) -> float:
    return 2.0 * n_q * m_valid * d


def ivf_bound_ms(n_q: int, n_tiles: int, scanned: int, read: int, d: int, k: int,
                 elt_bytes: int = 2, peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """K2 (probed-leaf top-k) over one call: `scanned` valid rows summed over
    the tiles, `read` distinct valid rows probed; queries, leaf ids and
    counts read once, results written once, or 2·block_q·D per scanned row."""
    block_q = n_q // n_tiles
    bytes_moved = read * d * elt_bytes + n_q * d * elt_bytes + n_q * k * (4 + 8)
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = k2_flops(block_q, scanned, d) / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def k2_flops(block_q: int, scanned: int, d: int) -> float:
    return 2.0 * block_q * scanned * d


def flash_bound_ms(shape: Tuple[int, int, int, int], elt_bytes: int = 2,
                   peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """K3 (flash attention forward): q, k, v read and o written once, or the
    4·B·H·N²·hd operations of q·kᵀ and p·v."""
    b, h, n, hd = shape
    t_bytes = 4 * b * h * n * hd * elt_bytes / PEAK_BYTES * 1e3
    t_ops = 4.0 * b * h * n * n * hd / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def vit_tokens(cfg: dict, input_size: int) -> int:
    grid = input_size // cfg["patch_size"]
    return 1 + cfg.get("num_register_tokens", 0) + grid * grid


def mlp_hidden(cfg: dict) -> int:
    if cfg.get("swiglu"):
        h = int(cfg["width"] * cfg["mlp_ratio"] * 2 / 3)
        return ((h + 7) // 8) * 8
    return int(cfg["width"] * cfg["mlp_ratio"])


def vit_flops(cfg: dict, input_size: int, images: int = 1) -> float:
    """Matmul and attention operations of the forward of `images` images:
    the patch embedding, per block the qkv, projection and MLP products
    and 4·T²·D of attention. Norms and element-wise work are not counted."""
    d, p = cfg["width"], cfg["patch_size"]
    t = vit_tokens(cfg, input_size)
    n = (input_size // p) ** 2
    h = mlp_hidden(cfg)
    mlp = 2 * t * d * 2 * h + 2 * t * h * d if cfg.get("swiglu") else 2 * 2 * t * d * h
    block = 2 * t * d * 3 * d + 2 * t * d * d + mlp + 4 * t * t * d
    return float(images) * (2 * n * 3 * p * p * d + cfg["depth"] * block)
