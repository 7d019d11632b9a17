"""Vision Transformer backbones (DINO, DINOv2, MAE, MoCo-v3, HF-ViT) in PyTorch.

Counterpart of hbird_tpu/models/vit.py: one parameterized pre-norm ViT
covering the preset families, with optional LayerScale (DINOv2), SwiGLU
FFN (DINOv2-giant) and register tokens (DINOv2 -reg), exact (erf) GELU,
and host-side bicubic positional-table interpolation with both of the
families' conventions (offset 0.1 and antialias).

It computes what the JAX forward computes, in the same order:
- the patch embedding is an unfold followed by a matmul (no convolution,
  so no TF32 cuDNN path);
- attention takes one of three forms (`attention_impl`):
  - 'xla' (the default): plain matmul -> softmax -> matmul; under bf16
    compute the logits stay bf16 with an f32 max-stable exp and
    normalisation, unless `attn_logits_f32`;
  - 'flash': K3, the flash attention kernel (ops/flash_cuda.py; its plain
    version, ops/flash.py, on the CPU), which never writes the (B, H, N, N)
    logits;
  - 'chunked': the 'xla' math over blocks of `attention_chunk_q` query
    rows, so only a (B, H, chunk, N) logits slice lives at a time;
  a block asked for its attention weights runs 'xla', as in JAX;
- layer norms run in f32 and cast back to the compute dtype;
- weights are kept in f32 and cast to the compute dtype at each use.

Weight converters (the JAX parameter pytree, timm and HuggingFace
checkpoints) live in models/convert.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hbird_tpu_torch.ops.flash_cuda import flash_attention

ATTENTION_IMPLS = ("xla", "flash", "chunked")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    img_size: int = 224  # size the positional table was trained at
    layerscale: bool = False  # DINOv2
    swiglu: bool = False  # DINOv2 giant
    num_register_tokens: int = 0  # DINOv2 -reg variants
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.float32
    # 'xla' = plain matmul attention; 'flash' = the K3 kernel (any sequence
    # length, head widths 32/64/80 on the card); 'chunked' = the 'xla' math
    # over blocks of attention_chunk_q query rows.
    attention_impl: str = "xla"
    attention_chunk_q: int = 256  # query-block rows for 'chunked'
    # Under bf16 compute the attention logits are bf16 unless this is set.
    attn_logits_f32: bool = False
    # Positional-table interpolation convention (see interpolate_pos_embed).
    pos_interp_offset: float = 0.0
    pos_interp_antialias: bool = False

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        if self.swiglu:
            # DINOv2 SwiGLU sizing: 2/3 * 4d, rounded up to a multiple of 8.
            h = int(self.width * self.mlp_ratio * 2 / 3)
            return ((h + 7) // 8) * 8
        return int(self.width * self.mlp_ratio)


# Presets for the backbone families in the reference results table
# (reference README.md:269-335) plus MAE / MoCo-v3 from BASELINE.json configs.
_HUB_OFF = {"pos_interp_offset": 0.1}  # torch.hub DINO/DINOv2 0.1 quirk
_REG_AA = {"pos_interp_antialias": True}  # DINOv2 -reg / timm convention
VIT_PRESETS: Dict[str, ViTConfig] = {
    "dino_vits16": ViTConfig(16, 384, 12, 6, img_size=224, **_HUB_OFF),
    "dino_vits8": ViTConfig(8, 384, 12, 6, img_size=224, **_HUB_OFF),
    "dino_vitb16": ViTConfig(16, 768, 12, 12, img_size=224, **_HUB_OFF),
    "dino_vitb8": ViTConfig(8, 768, 12, 12, img_size=224, **_HUB_OFF),
    "dinov2_vits14": ViTConfig(
        14, 384, 12, 6, img_size=518, layerscale=True, **_HUB_OFF
    ),
    "dinov2_vitb14": ViTConfig(
        14, 768, 12, 12, img_size=518, layerscale=True, **_HUB_OFF
    ),
    "dinov2_vitl14": ViTConfig(
        14, 1024, 24, 16, img_size=518, layerscale=True, **_HUB_OFF
    ),
    "dinov2_vitg14": ViTConfig(
        14, 1536, 40, 24, img_size=518, layerscale=True, swiglu=True, **_HUB_OFF
    ),
    "dinov2_vits14_reg": ViTConfig(
        14, 384, 12, 6, img_size=518, layerscale=True, num_register_tokens=4,
        **_REG_AA,
    ),
    "dinov2_vitb14_reg": ViTConfig(
        14, 768, 12, 12, img_size=518, layerscale=True, num_register_tokens=4,
        **_REG_AA,
    ),
    "dinov2_vitl14_reg": ViTConfig(
        14, 1024, 24, 16, img_size=518, layerscale=True, num_register_tokens=4,
        **_REG_AA,
    ),
    "dinov2_vitg14_reg": ViTConfig(
        14, 1536, 40, 24, img_size=518, layerscale=True, swiglu=True,
        num_register_tokens=4, **_REG_AA,
    ),
    "mae_vitb16": ViTConfig(16, 768, 12, 12, img_size=224),
    "mae_vitl16": ViTConfig(16, 1024, 24, 16, img_size=224),
    "mae_vith14": ViTConfig(14, 1280, 32, 16, img_size=224),
    "mocov3_vits16": ViTConfig(16, 384, 12, 12, img_size=224),
    "mocov3_vitb16": ViTConfig(16, 768, 12, 12, img_size=224),
    "vit_base_patch16_224": ViTConfig(16, 768, 12, 12, img_size=224, **_REG_AA),
    "vit_small_patch16_224": ViTConfig(16, 384, 12, 6, img_size=224, **_REG_AA),
    "vit_large_patch16_224": ViTConfig(16, 1024, 24, 16, img_size=224, **_REG_AA),
    # HuggingFace ViT uses LN eps 1e-12.
    "hf_vit_base_patch16_224": ViTConfig(16, 768, 12, 12, img_size=224, ln_eps=1e-12),
}


# ---------------------------------------------------------------------------
# Positional-embedding interpolation (host-side numpy, static per input size)
# ---------------------------------------------------------------------------


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with torch's a=-0.75."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def _resize_axis_cubic(
    x: np.ndarray,
    out_len: int,
    axis: int,
    scale: Optional[float] = None,
    antialias: bool = False,
) -> np.ndarray:
    """1D bicubic resample along `axis` (torch F.interpolate semantics).

    Default: half-pixel centers, a=-0.75 kernel — torch mode='bicubic',
    align_corners=False, antialias=False with an explicit `size`.
    `scale` overrides the sampling scale (torch's `scale_factor` path, used
    by the hub DINO/DINOv2 backbones' interpolate_offset quirk: they pass
    scale_factor=(grid+0.1)/g, dinov2 vision_transformer.py:179-211).
    `antialias=True` reproduces torch's PIL-compatible antialiased bicubic
    (a=-0.5 kernel stretched by the downscale factor, weights normalized) —
    what Dinov2-with-registers and timm use. Both paths verified to ~1e-14
    against torch.nn.functional.interpolate.
    """
    in_len = x.shape[axis]
    if in_len == out_len and scale is None:
        return x
    inv_scale = in_len / out_len if scale is None else 1.0 / scale
    x_moved = np.moveaxis(x, axis, 0)
    dst = np.arange(out_len, dtype=np.float64)
    if antialias:
        support_scale = max(inv_scale, 1.0)
        support = 2.0 * support_scale
        rows = []
        for i in range(out_len):
            center = (i + 0.5) * inv_scale
            lo = max(int(np.floor(center - support + 0.5)), 0)
            hi = min(int(np.floor(center + support + 0.5)), in_len)
            j = np.arange(lo, hi)
            w = _cubic_kernel((j + 0.5 - center) / support_scale, a=-0.5)
            w = w / w.sum()
            rows.append(np.einsum("t,t...->...", w, x_moved[j]))
        out = np.stack(rows, axis=0)
        return np.moveaxis(out, 0, axis)
    src = (dst + 0.5) * inv_scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    # 4-tap kernel at offsets -1..2 around base
    weights = np.stack([_cubic_kernel(frac + 1 - t) for t in range(4)], axis=0)
    idx = np.stack([np.clip(base - 1 + t, 0, in_len - 1) for t in range(4)], axis=0)
    out = np.einsum("to,to...->o...", weights, x_moved[idx])
    return np.moveaxis(out, 0, axis)


def interpolate_pos_embed(
    pos_embed: np.ndarray,
    grid_hw: Tuple[int, int],
    num_prefix_tokens: int = 1,
    offset: float = 0.0,
    antialias: bool = False,
) -> np.ndarray:
    """Bicubic-resample the patch positional table to a new grid.

    Matches the torch backbones' interpolate_pos_encoding (bicubic,
    align_corners=False). The prefix (CLS) embeddings pass through.

    Conventions differ per family and both knobs are exposed:
    - offset=0.1, antialias=False: torch.hub DINO v1 and DINOv2 non-reg
      (dino vision_transformer.py:174-194, dinov2 interpolate_offset=0.1) —
      interpolation runs with scale_factor=(target+0.1)/g instead of an
      exact size.
    - offset=0.0, antialias=True: DINOv2 -reg variants and timm
      resample_abs_pos_embed.
    - offset=0.0, antialias=False: HF ViTModel / Dinov2Model.

    Args:
        pos_embed: (1, prefix + g*g, D).
        grid_hw: target (H_patches, W_patches).
        num_prefix_tokens: how many leading non-spatial tokens.
        offset: scale-factor offset (the hub backbones' 0.1 quirk).
        antialias: torch/PIL antialiased bicubic for downscales.

    Returns:
        (1, prefix + H*W, D) float32 numpy array.
    """
    pos_embed = np.asarray(pos_embed, np.float64)
    prefix = pos_embed[:, :num_prefix_tokens]
    patch = pos_embed[:, num_prefix_tokens:]
    n = patch.shape[1]
    g = int(round(n**0.5))
    assert g * g == n, f"pos table is not square: {n}"
    th, tw = grid_hw
    if (th, tw) != (g, g):
        patch = patch.reshape(1, g, g, -1)
        sh = (th + offset) / g if offset else None
        sw = (tw + offset) / g if offset else None
        patch = _resize_axis_cubic(patch, th, axis=1, scale=sh, antialias=antialias)
        patch = _resize_axis_cubic(patch, tw, axis=2, scale=sw, antialias=antialias)
        patch = patch.reshape(1, th * tw, -1)
    return np.concatenate([prefix, patch], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """LayerNorm in f32, cast back to x's dtype (the JAX `_layer_norm`)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x @ Wᵀ + b with the f32 weights cast to x's dtype at use."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _xla_attention(q, k, v, scale: float, logits_f32: bool):
    """Plain attention over (B, H, N, hd): returns (out, weights)."""
    if logits_f32:
        logits = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
    else:
        # bf16 logits with an f32 max-stable exp and normalisation.
        logits = torch.matmul(q * scale, k.transpose(-2, -1))
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp((logits - m).float())
        attn = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.matmul(attn, v), attn


def _chunked_attention(q, k, v, scale: float, block_q: int, logits_f32: bool):
    """The 'xla' math over blocks of `block_q` query rows: each step holds a
    (B, H, block_q, N) logits slice, never the whole (B, H, N, N)."""
    n = q.shape[2]
    return torch.cat(
        [
            _xla_attention(q[:, :, i:i + block_q], k, v, scale, logits_f32)[0]
            for i in range(0, n, block_q)
        ],
        dim=2,
    )


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.width, 3 * cfg.width, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.width, cfg.width)

    def forward(
        self, x: torch.Tensor, return_weights: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        b, n, d = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        qkv = _linear(x, self.qkv).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd) views of qkv
        scale = hd**-0.5
        logits_f32 = cfg.attn_logits_f32 or x.dtype == torch.float32
        attn = None
        if return_weights or cfg.attention_impl == "xla":
            out, attn = _xla_attention(q, k, v, scale, logits_f32)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, scale)
        else:
            out = _chunked_attention(q, k, v, scale, cfg.attention_chunk_q, logits_f32)
        out = out.transpose(1, 2).reshape(b, n, d)
        return _linear(out, self.proj), (attn if return_weights else None)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.swiglu = cfg.swiglu
        h = cfg.mlp_hidden
        if cfg.swiglu:
            self.w12 = nn.Linear(cfg.width, 2 * h)
            self.w3 = nn.Linear(h, cfg.width)
        else:
            self.fc1 = nn.Linear(cfg.width, h)
            self.fc2 = nn.Linear(h, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            x1, x2 = _linear(x, self.w12).chunk(2, dim=-1)
            return _linear(F.silu(x1) * x2, self.w3)
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)  # exact erf GELU


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.eps = cfg.ln_eps
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        if cfg.layerscale:
            self.ls1 = nn.Parameter(torch.full((cfg.width,), 1e-5))
            self.ls2 = nn.Parameter(torch.full((cfg.width,), 1e-5))
        else:
            self.ls1 = self.ls2 = None

    def forward(
        self, x: torch.Tensor, return_weights: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        y, attn = self.attn(
            _layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps), return_weights
        )
        if self.ls1 is not None:
            y = y * self.ls1.to(x.dtype)
        x = x + y
        y = self.mlp(_layer_norm(x, self.norm2.weight, self.norm2.bias, self.eps))
        if self.ls2 is not None:
            y = y * self.ls2.to(x.dtype)
        return x + y, attn


class ViT(nn.Module):
    """`vit = ViT(cfg); vit.prepare(input_size); out = vit(imgs)`.

    `prepare` resamples the positional table for an input size (host-side
    numpy, from the native table, so it can be called again for another
    size). Parameters stay f32; `config.compute_dtype` (or the forward's
    `compute_dtype`) sets the dtype the blocks compute in.
    """

    def __init__(self, config: ViTConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}: {cfg.attention_impl!r}"
            )
        self.config = cfg
        d, p = cfg.width, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.grid_size**2, d))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
            if cfg.num_register_tokens
            else None
        )
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.register_buffer("pos_embed_input", None, persistent=False)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights: truncated normal (std 0.02, cut at 2 std) for
        matrices and tokens, zero biases, unit norms, LayerScale 1e-5."""
        for name, prm in self.named_parameters():
            if name.endswith("bias"):
                prm.zero_()
            elif ".norm" in name or name.startswith("norm."):
                prm.fill_(1.0)
            elif name.endswith(("ls1", "ls2")):
                prm.fill_(1e-5)
            else:
                nn.init.trunc_normal_(
                    prm, std=0.02, a=-0.04, b=0.04, generator=generator
                )
        self.pos_embed_input = None

    @torch.no_grad()
    def prepare(
        self,
        input_hw,
        offset: Optional[float] = None,
        antialias: Optional[bool] = None,
    ) -> "ViT":
        """Resample the positional table for `input_hw` (int or (H, W)).

        The convention (offset/antialias) defaults to the config's family
        convention and can be overridden per call.
        """
        if isinstance(input_hw, int):
            input_hw = (input_hw, input_hw)
        cfg = self.config
        grid = (input_hw[0] // cfg.patch_size, input_hw[1] // cfg.patch_size)
        pos = interpolate_pos_embed(
            self.pos_embed.detach().cpu().numpy(),
            grid,
            offset=cfg.pos_interp_offset if offset is None else offset,
            antialias=cfg.pos_interp_antialias if antialias is None else antialias,
        )
        self.pos_embed_input = torch.from_numpy(pos).to(self.pos_embed.device)
        return self

    def _embed(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Images (B,3,H,W) -> tokens (B, 1+R+N, D) with pos embed added."""
        cfg = self.config
        b, c, h, w = x.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        x = x.to(dtype).reshape(b, c, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p)
        tokens = _linear(x, self.patch_embed)
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.width)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = self.pos_embed_input
        if pos is None or pos.shape[1] != 1 + gh * gw:
            pos = self.pos_embed
        if pos.shape[1] != 1 + gh * gw:
            raise ValueError(
                f"pos_embed has {pos.shape[1]} tokens but input needs "
                f"{1 + gh * gw}; call prepare(...) for this input size first."
            )
        tokens = tokens + pos.to(dtype)
        if self.register_tokens is not None:
            regs = self.register_tokens.to(dtype).expand(b, -1, cfg.width)
            tokens = torch.cat([tokens[:, :1], regs, tokens[:, 1:]], dim=1)
        return tokens

    def forward(
        self,
        imgs: torch.Tensor,
        compute_dtype: Optional[torch.dtype] = None,
        return_attention: bool = False,
    ) -> Dict[str, Optional[torch.Tensor]]:
        """Forward pass on normalized (B, 3, H, W) images.

        Args:
            imgs: (B, 3, H, W) float images.
            compute_dtype: the blocks' dtype (defaults to the config's).
            return_attention: also return the last block's attention
                weights (that block then runs 'xla').

        Returns:
            dict with x_norm_patchtokens (B, N, D) f32 final-LN patch tokens,
            x_norm_clstoken (B, D) f32, and attn: the last block's
            (B, heads, T, T) weights over all T tokens in the compute dtype,
            or None.
        """
        cfg = self.config
        x = self._embed(imgs, compute_dtype or cfg.compute_dtype)
        attn = None
        for i, blk in enumerate(self.blocks):
            x, attn = blk(x, return_attention and i == cfg.depth - 1)
        x = _layer_norm(x, self.norm.weight, self.norm.bias, cfg.ln_eps).float()
        n_prefix = 1 + cfg.num_register_tokens
        return {"x_norm_patchtokens": x[:, n_prefix:], "x_norm_clstoken": x[:, 0], "attn": attn}

    def qkv_features(
        self,
        imgs: torch.Tensor,
        feat: str = "k",
        layer_num: int = -1,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """Q/K/V token features of block `layer_num`'s attention input.

        The chosen projection, heads re-concatenated, prefix (CLS and
        register) tokens dropped (the reference's forward-hook extraction,
        hbird/models.py:257-321). Returns (B, N_patches, D) f32.
        """
        if feat not in ("q", "k", "v"):
            raise ValueError(f"feat must be 'q', 'k' or 'v': {feat!r}")
        cfg = self.config
        layer = layer_num % cfg.depth
        x = self._embed(imgs, compute_dtype or cfg.compute_dtype)
        for blk in self.blocks[:layer]:
            x, _ = blk(x)
        blk = self.blocks[layer]
        y = _layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        qkv = _linear(y, blk.attn.qkv)
        b, n, _ = qkv.shape
        out = qkv.reshape(b, n, 3, cfg.width)[:, :, "qkv".index(feat)]
        return out[:, 1 + cfg.num_register_tokens:].float()

    def cls_attention(
        self, imgs: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
    ) -> torch.Tensor:
        """The last layer's CLS->patch attention, mean over heads, min-max
        scaled per image (reference hbird/models.py:44-53, 356-361)."""
        attn = self(imgs, compute_dtype, return_attention=True)["attn"]
        return cls_to_patches(attn, self.config.num_register_tokens)


def normalize_minmax(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Min-max normalize the last dim (reference hbird/models.py:44-53)."""
    mins = x.amin(dim=-1, keepdim=True)
    maxs = x.amax(dim=-1, keepdim=True)
    return (x - mins) / torch.clamp(maxs - mins, min=eps)


def cls_to_patches(attn: torch.Tensor, num_register_tokens: int = 0) -> torch.Tensor:
    """(B, heads, T, T) weights -> (B, N_patches) mean-head CLS->patch
    attention, min-max scaled; the token layout is [CLS, registers, patches]."""
    return normalize_minmax(attn[:, :, 0, 1 + num_register_tokens:].mean(dim=1))
