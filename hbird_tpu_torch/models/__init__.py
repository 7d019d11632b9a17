from hbird_tpu_torch.models.vit import ViTConfig, ViT, VIT_PRESETS
from hbird_tpu_torch.models.extractor import (
    FeatureExtractor,
    FeatureExtractorSimple,
    default_ftr_extr_fn,
    normalize_minmax,
)
# `convert` (the family dispatcher) stays in models.convert: exported here it
# would shadow the submodule of the same name.
from hbird_tpu_torch.models.convert import (
    convert_hf_dinov2,
    convert_hf_vit,
    convert_timm_vit,
    infer_config_from_timm_sd,
    load_torch_state_dict,
    params_from_jax,
)
from hbird_tpu_torch.models.torch_adapter import make_torch_ftr_extr_fn, wrap_torch_backbone

__all__ = [
    "ViTConfig",
    "ViT",
    "VIT_PRESETS",
    "FeatureExtractor",
    "FeatureExtractorSimple",
    "default_ftr_extr_fn",
    "normalize_minmax",
    "convert_hf_dinov2",
    "convert_hf_vit",
    "convert_timm_vit",
    "infer_config_from_timm_sd",
    "load_torch_state_dict",
    "params_from_jax",
    "make_torch_ftr_extr_fn",
    "wrap_torch_backbone",
]
