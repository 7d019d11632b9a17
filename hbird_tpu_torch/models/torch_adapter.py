"""Live torch.nn.Module backbones as feature extractors of the engine.

Counterpart of hbird_tpu/models/torch_adapter.py. The reference accepts any
torch model object — torch.hub, timm, HF — either auto-detected
(hbird/models.py:119-235, 326-354) or through the user's `ftr_extr_fn`
(README.md:147, eval.py:262-309). Here the module is already a PyTorch
module on the engine's device, so the wrapper calls it there on the
engine's image tensors and hands its tokens on as tensors on the same
device: no host round trip, unlike the JAX adapter, which feeds a TPU from
a host-side torch forward.

Use it for backbones that have no converter (models/convert.py) or to
cross-check a converted model against its original.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from hbird_tpu_torch.device import DeviceLike, resolve_device
from hbird_tpu_torch.models.extractor import FeatureExtractorSimple
from hbird_tpu_torch.models.vit import cls_to_patches
from hbird_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _extract_tokens(out) -> Any:
    """Locate the (B, N, D) token tensor in a torch model's output.

    Handles the reference's model-output shapes (eval.py:262-309):
    DINOv2-style dicts ('x_norm_patchtokens' — already patch-only),
    HF ModelOutput (.last_hidden_state), plain tensors, tuples/lists.
    Returns (tokens, patch_only).
    """
    if hasattr(out, "last_hidden_state"):  # HF ModelOutput dataclass
        return out.last_hidden_state, False
    if isinstance(out, dict):
        if "x_norm_patchtokens" in out:
            return out["x_norm_patchtokens"], True
        for key in ("x", "last_hidden_state", "tokens", "out", "features"):
            v = out.get(key)
            if v is not None and hasattr(v, "ndim"):
                return v, False
        for v in out.values():
            if hasattr(v, "ndim") and v.ndim == 3:
                return v, False
    if isinstance(out, (list, tuple)):
        for v in out:
            if hasattr(v, "ndim") and v.ndim == 3:
                return v, False
    if hasattr(out, "ndim"):
        return out, False
    raise TypeError(f"Could not locate a token tensor in {type(out)!r}")


def _cls_attention(out, model, x, return_attn: bool) -> Optional[torch.Tensor]:
    """Mean-head CLS->patch attention, min-max normalized (the reference's
    HF path, models.py:219-231). Sources, in order: HF ModelOutput
    `.attentions` (free when the forward already produced them), DINO
    hub's `get_last_selfattention` (a second forward — only when
    `return_attn` asked for it explicitly)."""
    att = None
    atts = getattr(out, "attentions", None)
    if atts:
        att = atts[-1]  # (B, heads, N, N), CLS at 0
    elif return_attn and hasattr(model, "get_last_selfattention"):
        att = model.get_last_selfattention(x)
    if att is None:
        return None
    # Token layout is [CLS, registers..., patches]; register-token ViTs
    # (DINOv2 -reg) must drop their registers or the map misaligns with
    # the patch grid.
    n_reg = int(
        getattr(model, "num_register_tokens", 0)
        or getattr(getattr(model, "config", None), "num_register_tokens", 0)
        or 0
    )
    return cls_to_patches(att.float(), n_reg)


def make_torch_ftr_extr_fn(
    device: DeviceLike = None,
    use_amp: bool = False,
    forward: Optional[Callable] = None,
    return_attn: bool = False,
) -> Callable:
    """Build an `ftr_extr_fn(torch_model, imgs) -> ((B, N, D) tokens, attn)`.

    imgs arrive as the engine's normalized (B, 3, H, W) float tensor (a
    numpy array works too) and run on `device` (CUDA unless the caller asks
    for the CPU); tokens come back as f32 tensors on that device, with the
    CLS token dropped by the reference's perfect-square rule
    (eval.py:303-309).

    Args:
        device: the torch device of the module.
        use_amp: torch.autocast around the forward on a GPU (reference
            models.py:188-192).
        forward: optional override `forward(model, imgs) -> output`
            (e.g. `lambda m, x: m.get_intermediate_layers(x)[0]`).
        return_attn: also return the mean-head CLS->patch attention,
            min-max normalized (reference models.py:219-231). HF models
            that accept `output_attentions` give it within the one
            forward; DINO-hub models pay a second forward via
            `get_last_selfattention`. Off by default: the engine never
            reads attention.
    """
    dev = resolve_device(device)

    def fn(model, imgs):
        x = torch.as_tensor(imgs, dtype=torch.float32, device=dev)

        def run():
            if forward:
                return forward(model, x)
            if return_attn:
                # Recent transformers default to SDPA kernels, which
                # cannot capture attention probs (output_attentions comes
                # back None with a warning) — flip to eager once.
                impl = getattr(getattr(model, "config", None), "_attn_implementation", None)
                if impl not in (None, "eager") and hasattr(model, "set_attn_implementation"):
                    try:
                        model.set_attn_implementation("eager")
                    except Exception:  # pragma: no cover - exotic models
                        pass
                # HF-style kwargs; non-HF modules reject them -> plain call
                try:
                    return model(x, output_attentions=True, return_dict=True)
                except TypeError:
                    pass
            return model(x)

        with torch.inference_mode():
            if use_amp and dev.type != "cpu":
                with torch.autocast(device_type=dev.type):
                    out = run()
            else:
                out = run()
            attn = _cls_attention(out, model, x, return_attn) if return_attn else None
        tokens, patch_only = _extract_tokens(out)
        tokens = tokens.float()
        if tokens.ndim != 3:
            raise ValueError(f"Expected (B, N, D) tokens, got {tuple(tokens.shape)}")
        n = tokens.shape[1]
        if not patch_only and n > 1 and math.isqrt(n - 1) ** 2 == n - 1:
            tokens = tokens[:, 1:, :]  # leading CLS token
        return tokens, attn

    return fn


def wrap_torch_backbone(
    module: torch.nn.Module,
    eval_spatial_resolution: int,
    d_model: int,
    device: DeviceLike = None,
    use_amp: bool = False,
    forward: Optional[Callable] = None,
    return_attn: bool = False,
) -> FeatureExtractorSimple:
    """Wrap a live torch.nn.Module for the evaluation engine.

    The module is put in eval mode, frozen and moved to `device` (CUDA
    unless the caller asks for the CPU); pass the same device to the
    engine.

    Example:
        model = torch.hub.load('facebookresearch/dino:main', 'dino_vits16')
        fe = wrap_torch_backbone(model, eval_spatial_resolution=14, d_model=384)
        miou = hbird_evaluation(fe, d_model=384, patch_size=16, ...)
    """
    dev = resolve_device(device)
    module = module.eval().to(dev)
    for p in module.parameters():
        p.requires_grad_(False)  # freeze (reference models.py:237-255)
    logger.info("Wrapped torch backbone %s on %s", type(module).__name__, dev)
    return FeatureExtractorSimple(
        module,
        ftr_extr_fn=make_torch_ftr_extr_fn(
            device=dev, use_amp=use_amp, forward=forward, return_attn=return_attn,
        ),
        eval_spatial_resolution=eval_spatial_resolution,
        d_model=d_model,
    )
