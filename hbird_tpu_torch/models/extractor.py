"""Feature-extractor wrappers: the pluggable backbone protocol.

Counterpart of hbird_tpu/models/extractor.py (reference
hbird/models.py:70-103, 119-235):

- `FeatureExtractorSimple`: wraps a user feature function
  `ftr_extr_fn(model, imgs) -> feats | (feats, attn)` on torch tensors
  (`default_ftr_extr_fn` grabs the patch tokens of most model outputs).
- `FeatureExtractor`: wraps this package's ViT and exposes
  `forward_features(imgs) -> (patch_tokens, None)`, the tokens with the
  normalized CLS attention, and intermediate Q/K/V features.

Both expose `eval_spatial_resolution` and `d_model`, the attributes the
evaluation engine reads (reference hbird_eval.py:133, 156-161).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch

from hbird_tpu_torch.models.vit import ViT, cls_to_patches, normalize_minmax

__all__ = [
    "FeatureExtractor",
    "FeatureExtractorSimple",
    "default_ftr_extr_fn",
    "normalize_minmax",
]


def default_ftr_extr_fn(model, imgs):
    """Generic patch-token grabber (reference eval.py:262-309 semantics).

    `model` may be a callable or a (fn, params) tuple; its output may be a
    (B, N, D) tensor, a dict (preferring 'x_norm_patchtokens', then
    'x'/'last_hidden_state'/'tokens'/'out'/'features'), or a tuple/list
    holding such a tensor. If the token count N-1 is a perfect square, the
    first token is taken for CLS and dropped.
    """
    if isinstance(model, tuple) and callable(model[0]):
        out = model[0](model[1], imgs)
    elif callable(model):
        out = model(imgs)
    else:
        raise TypeError("model must be callable or a (fn, params) tuple")

    if isinstance(out, dict) and "x_norm_patchtokens" in out:
        tokens = out["x_norm_patchtokens"]
        if tokens.ndim != 3:
            raise ValueError(f"Expected (B, N, D), got {tuple(tokens.shape)}")
        return tokens, None

    def grab(o):
        if hasattr(o, "ndim"):
            return o
        if isinstance(o, dict):
            for key in ("x", "last_hidden_state", "tokens", "out", "features"):
                v = o.get(key)
                if v is not None and hasattr(v, "ndim"):
                    return v
            for v in o.values():
                if hasattr(v, "ndim"):
                    return v
        if isinstance(o, (list, tuple)):
            for v in o:
                if hasattr(v, "ndim"):
                    return v
        raise TypeError("Could not locate token tensor in model output")

    tokens = grab(out)
    if tokens.ndim != 3:
        raise ValueError(f"Expected (B, N, D) token tensor, got {tuple(tokens.shape)}")
    n = tokens.shape[1]
    if n > 1 and math.isqrt(n - 1) ** 2 == (n - 1):
        tokens = tokens[:, 1:, :]  # CLS present at index 0
    return tokens, None


class FeatureExtractorSimple:
    """Delegates feature extraction to a user-provided function.

    Args:
        model: arbitrary model object the function understands.
        ftr_extr_fn: callable (model, imgs) -> (B, N, D) features, or a
            (features, attention) tuple.
        eval_spatial_resolution: S (patch grid side).
        d_model: embedding dim.
    """

    def __init__(
        self,
        model: Any,
        ftr_extr_fn: Callable,
        eval_spatial_resolution: int = 14,
        d_model: int = 768,
    ) -> None:
        self.model = model
        self.ftr_extr_fn = ftr_extr_fn
        self.eval_spatial_resolution = eval_spatial_resolution
        self.d_model = d_model

    def forward_features(self, imgs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        out = self.ftr_extr_fn(self.model, imgs)
        if isinstance(out, tuple):
            return out[0], (out[1] if len(out) > 1 else None)
        return out, None

    def __call__(self, imgs):
        return self.forward_features(imgs)

    def freeze_feature_extractor(self, unfreeze_layers=None, regex=False):
        """No-op for API parity: the engine runs under inference mode."""
        return None


class FeatureExtractor:
    """Extractor over this package's ViT.

    Args:
        vit: the ViT module, already `prepare`d for the input size (the
            engine does this).
        eval_spatial_resolution: S (defaults to the config's grid).
        d_model: embedding dim (defaults to the config width).
        use_bf16: run the backbone in bfloat16 (the reference's fp16
            autocast analogue, hbird/models.py:188-192).
    """

    def __init__(
        self,
        vit: ViT,
        eval_spatial_resolution: Optional[int] = None,
        d_model: Optional[int] = None,
        use_bf16: bool = False,
    ) -> None:
        cfg = vit.config
        self.vit = vit
        self.compute_dtype = torch.bfloat16 if use_bf16 else cfg.compute_dtype
        self.d_model = d_model or cfg.width
        self.eval_spatial_resolution = eval_spatial_resolution or cfg.grid_size

    def forward_features(self, imgs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        out = self.vit(imgs, compute_dtype=self.compute_dtype)
        return out["x_norm_patchtokens"], None

    def forward_features_with_attention(self, imgs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Patch tokens and the normalized CLS->patch attention (B, N)."""
        out = self.vit(imgs, compute_dtype=self.compute_dtype, return_attention=True)
        attn = cls_to_patches(out["attn"], self.vit.config.num_register_tokens)
        return out["x_norm_patchtokens"], attn

    def get_intermediate_layer_feats(self, imgs, feat: str = "k", layer_num: int = -1):
        """Q/K/V features of an intermediate layer and the normalized CLS
        attention (reference hbird/models.py:257-321 equivalent)."""
        feats = self.vit.qkv_features(imgs, feat=feat, layer_num=layer_num,
                                      compute_dtype=self.compute_dtype)
        _, attn = self.forward_features_with_attention(imgs)
        return feats, attn

    def freeze_feature_extractor(self, unfreeze_layers=None, regex=False):
        """No-op for API parity (the engine never trains the backbone)."""
        return None

    def __call__(self, imgs):
        return self.forward_features(imgs)
