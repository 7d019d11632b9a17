"""Weights for this package's ViT: the JAX parameter pytree, timm-style and
HuggingFace checkpoints.

Counterpart of hbird_tpu/models/convert.py. Every converter builds the
JAX package's parameter layout as numpy arrays (per-block tensors stacked
along a leading depth axis, einsum weights laid out (d_in, d_out), the
patch embedding a flattened (p*p*3, D) kernel in (c, ph, pw) order) and
passes it through `params_from_jax`, so one function carries weights into
`ViT.load_state_dict` whichever way they come:

- `params_from_jax`: the JAX package's pytree (numpy leaves);
- `convert_timm_vit`: timm-style ViTs (DINO, DINOv2 incl. -reg and the
  SwiGLU giant, MAE, MoCo-v3 after prefix stripping, plain timm `vit_*`);
- `convert_hf_vit`: HuggingFace `ViTModel` (separate q/k/v projections);
- `convert_hf_dinov2`: HuggingFace `Dinov2Model` and
  `Dinov2WithRegistersModel`;
- `convert(family='auto')` sniffs the family from the keys.

The converters return `(state_dict, ViTConfig)`, so that
`ViT(cfg).load_state_dict(sd)` works. They take a mapping of torch tensors
or numpy arrays, or a checkpoint path (`load_torch_state_dict`); neither
`timm` nor `transformers` is needed. The pos-embed table is kept at its
native size: call `ViT.prepare` for the input size.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from hbird_tpu_torch.models.vit import ViTConfig
from hbird_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

StateDict = Dict[str, torch.Tensor]
Source = Union[Mapping[str, Any], str]

# JAX block key -> (this package's parameter path, is a (d_in, d_out) matrix)
_BLOCK_KEYS = {
    "norm1_scale": ("norm1.weight", False),
    "norm1_bias": ("norm1.bias", False),
    "qkv_w": ("attn.qkv.weight", True),
    "qkv_b": ("attn.qkv.bias", False),
    "proj_w": ("attn.proj.weight", True),
    "proj_b": ("attn.proj.bias", False),
    "norm2_scale": ("norm2.weight", False),
    "norm2_bias": ("norm2.bias", False),
    "fc1_w": ("mlp.fc1.weight", True),
    "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True),
    "fc2_b": ("mlp.fc2.bias", False),
    "w12": ("mlp.w12.weight", True),
    "b12": ("mlp.w12.bias", False),
    "w3": ("mlp.w3.weight", True),
    "b3": ("mlp.w3.bias", False),
    "ls1": ("ls1", False),
    "ls2": ("ls2", False),
}


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)  # a writable copy
    if transpose:
        a = np.ascontiguousarray(a.T)
    return torch.from_numpy(a)


def params_from_jax(np_params: Dict[str, Any]) -> StateDict:
    """JAX ViT parameter pytree (numpy leaves) -> ViT state dict."""
    sd: StateDict = {
        "patch_embed.weight": _t(np_params["patch_embed"]["kernel"], True),
        "patch_embed.bias": _t(np_params["patch_embed"]["bias"]),
        "cls_token": _t(np_params["cls_token"]),
        "pos_embed": _t(np_params["pos_embed"]),
        "norm.weight": _t(np_params["norm"]["scale"]),
        "norm.bias": _t(np_params["norm"]["bias"]),
    }
    if "register_tokens" in np_params:
        sd["register_tokens"] = _t(np_params["register_tokens"])
    blocks = np_params["blocks"]
    depth = np.asarray(blocks["qkv_w"]).shape[0]
    for key, stacked in blocks.items():
        if key not in _BLOCK_KEYS:
            raise KeyError(f"unknown block parameter {key!r}")
        path, is_matrix = _BLOCK_KEYS[key]
        stacked = np.asarray(stacked)
        for i in range(depth):
            sd[f"blocks.{i}.{path}"] = _t(stacked[i], is_matrix)
    return sd


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint from disk into numpy arrays.

    Handles the common wrappers: {'state_dict': ...}, {'model': ...},
    {'teacher': ...} (DINO), and 'module.'/'backbone.'/'base_encoder.'/
    'momentum_encoder.' prefixes (reference eval.py:230-233). The file is
    unpickled in full (DINO checkpoints carry their training arguments), so
    load only checkpoints you trust.
    """
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "teacher"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    out = {}
    for k, v in sd.items():
        if not hasattr(v, "shape"):
            continue
        k = re.sub(r"^(module\.|backbone\.|base_encoder\.|momentum_encoder\.)", "", k)
        out[k] = _to_numpy(v)
    return out


def _depth(sd: Mapping[str, np.ndarray], pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)) is not None)


def infer_config_from_timm_sd(
    sd: Mapping[str, np.ndarray], ln_eps: float = 1e-6
) -> ViTConfig:
    """Infer a ViTConfig from a timm-style state dict's shapes.

    Heads cannot be read from shapes: 64-wide heads are assumed, with a
    warning where that is known to be ambiguous (width 384: DINO ViT-S has
    6 heads, MoCo-v3 ViT-S 12). Pass an explicit config for such backbones.
    """
    d, _, p, _ = sd["patch_embed.proj.weight"].shape  # (D, 3, p, p)
    depth = _depth(sd, r"blocks\.(\d+)\.")
    grid = int(round((sd["pos_embed"].shape[1] - 1) ** 0.5))
    swiglu = any(".mlp.w12." in k or ".mlp.w1." in k for k in sd)
    layerscale = any(".ls1." in k or ".gamma_1" in k for k in sd)
    n_reg = sd["register_tokens"].shape[1] if "register_tokens" in sd else 0
    if swiglu:
        mlp_ratio = sd["blocks.0.mlp.w3.weight"].shape[1] * 3 / 2 / d
    else:
        mlp_ratio = sd["blocks.0.mlp.fc1.weight"].shape[0] / d
    num_heads = max(1, d // 64)
    if d % 64 != 0 or d <= 384:
        warnings.warn(
            f"infer_config_from_timm_sd: assuming {num_heads} heads of dim "
            f"{d // num_heads} for width {d}. Head count cannot be inferred "
            "from weight shapes — pass an explicit ViTConfig(num_heads=...) "
            "if this backbone uses non-64-dim heads (e.g. MoCo-v3 ViT-S has "
            "12 heads at width 384).",
            stacklevel=2,
        )
    return ViTConfig(
        patch_size=p,
        width=d,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=float(mlp_ratio),
        img_size=grid * p,
        layerscale=layerscale,
        swiglu=swiglu,
        num_register_tokens=n_reg,
        ln_eps=ln_eps,
    )


def _read(sd: Source, prefix: str = "") -> Dict[str, np.ndarray]:
    """A mapping or checkpoint path -> numpy arrays, `prefix` stripped."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    return {re.sub(prefix, "", k) if prefix else k: _to_numpy(v) for k, v in sd.items()}


def _f32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32)


def convert_timm_vit(
    sd: Source, config: Optional[ViTConfig] = None
) -> Tuple[StateDict, ViTConfig]:
    """Convert a timm-style ViT state dict (DINO/DINOv2/MAE/MoCo-v3/timm).

    Returns (state_dict, config). LayerScale comes as `ls1.gamma` or the
    older `gamma_1`; the SwiGLU FFN as fused `w12` or split `w1`/`w2`; a
    model without a qkv bias gets zeros.
    """
    sd = _read(sd)
    if config is None:
        config = infer_config_from_timm_sd(sd)
    depth, d = config.depth, config.width

    def stack(fmt: str, transform=lambda x: x):
        return np.stack([transform(_f32(sd[fmt.format(i)])) for i in range(depth)])

    blocks: Dict[str, np.ndarray] = {
        "norm1_scale": stack("blocks.{}.norm1.weight"),
        "norm1_bias": stack("blocks.{}.norm1.bias"),
        "qkv_w": stack("blocks.{}.attn.qkv.weight", lambda x: x.T),
        "proj_w": stack("blocks.{}.attn.proj.weight", lambda x: x.T),
        "proj_b": stack("blocks.{}.attn.proj.bias"),
        "norm2_scale": stack("blocks.{}.norm2.weight"),
        "norm2_bias": stack("blocks.{}.norm2.bias"),
    }
    if "blocks.0.attn.qkv.bias" in sd:
        blocks["qkv_b"] = stack("blocks.{}.attn.qkv.bias")
    else:  # qkv_bias=False models
        blocks["qkv_b"] = np.zeros((depth, 3 * d), np.float32)

    if config.swiglu:
        if "blocks.0.mlp.w12.weight" in sd:  # SwiGLUFFNFused
            blocks["w12"] = stack("blocks.{}.mlp.w12.weight", lambda x: x.T)
            blocks["b12"] = stack("blocks.{}.mlp.w12.bias")
        else:  # separate w1/w2
            blocks["w12"] = np.concatenate(
                [stack("blocks.{}.mlp.w1.weight", lambda x: x.T),
                 stack("blocks.{}.mlp.w2.weight", lambda x: x.T)], axis=-1)
            blocks["b12"] = np.concatenate(
                [stack("blocks.{}.mlp.w1.bias"), stack("blocks.{}.mlp.w2.bias")], axis=-1)
        blocks["w3"] = stack("blocks.{}.mlp.w3.weight", lambda x: x.T)
        blocks["b3"] = stack("blocks.{}.mlp.w3.bias")
    else:
        blocks["fc1_w"] = stack("blocks.{}.mlp.fc1.weight", lambda x: x.T)
        blocks["fc1_b"] = stack("blocks.{}.mlp.fc1.bias")
        blocks["fc2_w"] = stack("blocks.{}.mlp.fc2.weight", lambda x: x.T)
        blocks["fc2_b"] = stack("blocks.{}.mlp.fc2.bias")

    if config.layerscale:
        if "blocks.0.ls1.gamma" in sd:
            blocks["ls1"] = stack("blocks.{}.ls1.gamma")
            blocks["ls2"] = stack("blocks.{}.ls2.gamma")
        else:  # older naming (gamma_1/gamma_2)
            blocks["ls1"] = stack("blocks.{}.gamma_1")
            blocks["ls2"] = stack("blocks.{}.gamma_2")

    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _f32(sd["patch_embed.proj.weight"]).reshape(d, -1).T,
            "bias": _f32(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _f32(sd["cls_token"]),
        "pos_embed": _f32(sd["pos_embed"]),  # DINOv2's table holds no registers
        "blocks": blocks,
        "norm": {"scale": _f32(sd["norm.weight"]), "bias": _f32(sd["norm.bias"])},
    }
    if config.num_register_tokens:
        params["register_tokens"] = _f32(sd["register_tokens"])
    logger.info(
        "Converted timm-style ViT: depth=%d width=%d patch=%d", depth, d, config.patch_size
    )
    return params_from_jax(params), config


def _hf_embeddings(sd: Mapping[str, np.ndarray], d: int) -> Dict[str, Any]:
    return {
        "patch_embed": {
            "kernel": _f32(sd["embeddings.patch_embeddings.projection.weight"]).reshape(d, -1).T,
            "bias": _f32(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "cls_token": _f32(sd["embeddings.cls_token"]),
        "pos_embed": _f32(sd["embeddings.position_embeddings"]),
        "norm": {"scale": _f32(sd["layernorm.weight"]), "bias": _f32(sd["layernorm.bias"])},
    }


def _hf_qkv(sd: Mapping[str, np.ndarray], depth: int, d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked (depth, d, 3d) qkv kernels and (depth, 3d) biases from HF's
    separate query/key/value Linears (zeros where there is no bias)."""

    def g(i, name):
        return _f32(sd[f"encoder.layer.{i}.attention.attention.{name}"])

    w = np.stack([
        np.concatenate([g(i, f"{p}.weight").T for p in ("query", "key", "value")], axis=1)
        for i in range(depth)
    ])
    if "encoder.layer.0.attention.attention.query.bias" not in sd:
        return w, np.zeros((depth, 3 * d), np.float32)
    b = np.stack([
        np.concatenate([g(i, f"{p}.bias") for p in ("query", "key", "value")])
        for i in range(depth)
    ])
    return w, b


def convert_hf_vit(
    sd: Source, config: Optional[ViTConfig] = None
) -> Tuple[StateDict, ViTConfig]:
    """Convert a HuggingFace `transformers` ViTModel state dict.

    HF splits q/k/v into separate Linears and names the block norms
    layernorm_before/after; its LayerNorm eps is 1e-12.
    """
    sd = _read(sd, r"^vit\.")
    d, _, p, _ = sd["embeddings.patch_embeddings.projection.weight"].shape
    depth = _depth(sd, r"encoder\.layer\.(\d+)\.")
    grid = int(round((sd["embeddings.position_embeddings"].shape[1] - 1) ** 0.5))
    if config is None:
        hidden = sd["encoder.layer.0.intermediate.dense.weight"].shape[0]
        config = ViTConfig(
            patch_size=p, width=d, depth=depth, num_heads=max(1, d // 64),
            mlp_ratio=hidden / d, img_size=grid * p, ln_eps=1e-12,
        )

    def stack(name, transform=lambda x: x):
        return np.stack([transform(_f32(sd[f"encoder.layer.{i}.{name}"])) for i in range(depth)])

    qkv_w, qkv_b = _hf_qkv(sd, depth, d)
    blocks = {
        "norm1_scale": stack("layernorm_before.weight"),
        "norm1_bias": stack("layernorm_before.bias"),
        "qkv_w": qkv_w,
        "qkv_b": qkv_b,
        "proj_w": stack("attention.output.dense.weight", lambda x: x.T),
        "proj_b": stack("attention.output.dense.bias"),
        "norm2_scale": stack("layernorm_after.weight"),
        "norm2_bias": stack("layernorm_after.bias"),
        "fc1_w": stack("intermediate.dense.weight", lambda x: x.T),
        "fc1_b": stack("intermediate.dense.bias"),
        "fc2_w": stack("output.dense.weight", lambda x: x.T),
        "fc2_b": stack("output.dense.bias"),
    }
    return params_from_jax({**_hf_embeddings(sd, d), "blocks": blocks}), config


def convert_hf_dinov2(
    sd: Source, config: Optional[ViTConfig] = None
) -> Tuple[StateDict, ViTConfig]:
    """Convert a HuggingFace Dinov2Model / Dinov2WithRegistersModel state dict.

    HF's Dinov2 mirrors the torch.hub DINOv2 blocks — pre-norm attention
    with LayerScale (`layer_scale1.lambda1`), MLP or SwiGLU (`mlp.fc1/fc2`
    or `mlp.weights_in/weights_out`), separate q/k/v Linears. Register
    tokens (`embeddings.register_tokens`) go in after the pos-embed add, as
    in HF (modeling_dinov2_with_registers.py:164-166).
    """
    sd = _read(sd, r"^(dinov2\.|dinov2_with_registers\.)")
    d, _, p, _ = sd["embeddings.patch_embeddings.projection.weight"].shape
    depth = _depth(sd, r"encoder\.layer\.(\d+)\.")
    grid = int(round((sd["embeddings.position_embeddings"].shape[1] - 1) ** 0.5))
    swiglu = "encoder.layer.0.mlp.weights_in.weight" in sd
    n_reg = sd["embeddings.register_tokens"].shape[1] if "embeddings.register_tokens" in sd else 0
    if config is None:
        if swiglu:
            mlp_ratio = sd["encoder.layer.0.mlp.weights_out.weight"].shape[1] * 3 / 2 / d
        else:
            mlp_ratio = sd["encoder.layer.0.mlp.fc1.weight"].shape[0] / d
        config = ViTConfig(
            patch_size=p, width=d, depth=depth, num_heads=max(1, d // 64),
            mlp_ratio=float(mlp_ratio), img_size=grid * p, layerscale=True,
            swiglu=swiglu, num_register_tokens=n_reg, ln_eps=1e-6,
            # HF Dinov2Model interpolates to a size without antialias; the
            # -reg model with antialias.
            pos_interp_antialias=bool(n_reg),
        )

    def stack(name, transform=lambda x: x):
        return np.stack([transform(_f32(sd[f"encoder.layer.{i}.{name}"])) for i in range(depth)])

    qkv_w, qkv_b = _hf_qkv(sd, depth, d)
    blocks: Dict[str, np.ndarray] = {
        "norm1_scale": stack("norm1.weight"),
        "norm1_bias": stack("norm1.bias"),
        "qkv_w": qkv_w,
        "qkv_b": qkv_b,
        "proj_w": stack("attention.output.dense.weight", lambda x: x.T),
        "proj_b": stack("attention.output.dense.bias"),
        "norm2_scale": stack("norm2.weight"),
        "norm2_bias": stack("norm2.bias"),
        "ls1": stack("layer_scale1.lambda1"),
        "ls2": stack("layer_scale2.lambda1"),
    }
    if swiglu:
        blocks["w12"] = stack("mlp.weights_in.weight", lambda x: x.T)
        blocks["b12"] = stack("mlp.weights_in.bias")
        blocks["w3"] = stack("mlp.weights_out.weight", lambda x: x.T)
        blocks["b3"] = stack("mlp.weights_out.bias")
    else:
        blocks["fc1_w"] = stack("mlp.fc1.weight", lambda x: x.T)
        blocks["fc1_b"] = stack("mlp.fc1.bias")
        blocks["fc2_w"] = stack("mlp.fc2.weight", lambda x: x.T)
        blocks["fc2_b"] = stack("mlp.fc2.bias")
    params = {**_hf_embeddings(sd, d), "blocks": blocks}
    if n_reg:
        params["register_tokens"] = _f32(sd["embeddings.register_tokens"])
    logger.info(
        "Converted HF Dinov2: depth=%d width=%d patch=%d swiglu=%s reg=%d",
        depth, d, p, swiglu, n_reg,
    )
    return params_from_jax(params), config


def convert(sd: Source, family: str = "auto", config: Optional[ViTConfig] = None):
    """Family dispatcher: 'timm'/'dino'/'dinov2'/'mae'/'mocov3' share the
    timm converter; 'hf' and 'hf_dinov2' the HuggingFace ones. 'auto'
    sniffs the keys."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    f = family.lower()
    if f == "auto":
        if any("encoder.layer.0." in k for k in sd):
            # HF flavours: Dinov2 names the block norms norm1/norm2, ViTModel
            # layernorm_before/after.
            dinov2 = any(k.endswith("encoder.layer.0.norm1.weight") for k in sd)
            f = "hf_dinov2" if dinov2 else "hf"
        else:
            f = "timm"
    if f in ("timm", "dino", "dinov2", "mae", "mocov3", "moco"):
        return convert_timm_vit(sd, config)
    if f == "hf":
        return convert_hf_vit(sd, config)
    if f in ("hf_dinov2", "hf-dinov2"):
        return convert_hf_dinov2(sd, config)
    raise ValueError(f"Unknown model family: {family}")
