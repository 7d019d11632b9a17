"""The plain ViT forward in float32, written from the published description.

Pre-norm ViT blocks (DINOv2 with LayerScale; MAE without), exact erf GELU,
softmax attention, final LayerNorm; the patch tokens are returned. The
positional table is resampled as the DINOv2 hub backbones do it: bicubic
`F.interpolate` with `scale_factor=(n + offset) / g` when an offset is set
(interpolate_offset=0.1), else to the exact grid. Images arrive as uint8 and
are normalised here.

`precision='fp8'` is the control: the same forward with both inputs of
every product (the patch embedding, qkv, attention's two products, the
projection and the MLP) rounded to float8 e4m3 under a per-tensor scale,
the step below the configuration's bfloat16.

No module of the program is imported here.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over `dim`, or the whole tensor) to the format's largest."""
    a = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(a, min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mm:
    def __init__(self, precision: str) -> None:
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8': {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a, b)


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def positional_table(weights: Dict[str, torch.Tensor], cfg: dict) -> torch.Tensor:
    pos = weights["pos_embed"].float()
    g = cfg["img_size"] // cfg["patch_size"]
    n = cfg["input_size"] // cfg["patch_size"]
    if n == g:
        return pos
    patch = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    offset = cfg.get("pos_interp_offset", 0.0)
    kw = dict(mode="bicubic", align_corners=False, antialias=cfg.get("pos_interp_antialias", False))
    if offset:
        patch = F.interpolate(patch, scale_factor=((n + offset) / g, (n + offset) / g), **kw)
    else:
        patch = F.interpolate(patch, size=(n, n), **kw)
    patch = patch.permute(0, 2, 3, 1).reshape(1, n * n, -1)
    return torch.cat([pos[:, :1], patch], dim=1)


def forward(weights: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            mean, std, precision: str = "f32") -> torch.Tensor:
    """Patch tokens (B, N, D) f32 of uint8 images (B, 3, S, S)."""
    mm = _Mm(precision)
    w = {k: v.float() for k, v in weights.items()}
    dev = images.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
    x = (images.float() / 255.0 - m) / s
    p, d, heads = cfg["patch_size"], cfg["width"], cfg["num_heads"]
    hd = d // heads
    eps = cfg["ln_eps"]
    patches = F.unfold(x, kernel_size=p, stride=p).transpose(1, 2)  # (B, N, 3·p·p)
    b = patches.shape[0]
    tok = mm(patches, w["patch_embed.weight"].t()) + w["patch_embed.bias"]
    tok = torch.cat([w["cls_token"].expand(b, 1, d), tok], dim=1) + positional_table(w, cfg)
    n_reg = cfg.get("num_register_tokens", 0)
    if n_reg:
        tok = torch.cat([tok[:, :1], w["register_tokens"].expand(b, n_reg, d), tok[:, 1:]], dim=1)
    t = tok.shape[1]
    for i in range(cfg["depth"]):
        pre = f"blocks.{i}."
        y = _ln(tok, w[pre + "norm1.weight"], w[pre + "norm1.bias"], eps)
        qkv = mm(y, w[pre + "attn.qkv.weight"].t())
        if pre + "attn.qkv.bias" in w:
            qkv = qkv + w[pre + "attn.qkv.bias"]
        q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(mm(q * (1.0 / math.sqrt(hd)), k.transpose(-2, -1)), dim=-1)
        o = mm(att, v).transpose(1, 2).reshape(b, t, d)
        y = mm(o, w[pre + "attn.proj.weight"].t()) + w[pre + "attn.proj.bias"]
        if pre + "ls1" in w:
            y = y * w[pre + "ls1"]
        tok = tok + y
        y = _ln(tok, w[pre + "norm2.weight"], w[pre + "norm2.bias"], eps)
        if cfg.get("swiglu"):
            h12 = mm(y, w[pre + "mlp.w12.weight"].t()) + w[pre + "mlp.w12.bias"]
            h1, h2 = h12.chunk(2, dim=-1)
            y = mm(F.silu(h1) * h2, w[pre + "mlp.w3.weight"].t()) + w[pre + "mlp.w3.bias"]
        else:
            h = F.gelu(mm(y, w[pre + "mlp.fc1.weight"].t()) + w[pre + "mlp.fc1.bias"])
            y = mm(h, w[pre + "mlp.fc2.weight"].t()) + w[pre + "mlp.fc2.bias"]
        if pre + "ls2" in w:
            y = y * w[pre + "ls2"]
        tok = tok + y
    tok = _ln(tok, w["norm.weight"], w["norm.bias"], eps)
    return tok[:, 1 + n_reg:]
