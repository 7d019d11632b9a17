"""The port's checkpoint converters, torch adapter and extractor helpers
against the JAX package.

Inputs are random state dicts made with numpy from a seed (or random
`transformers` models, which the JAX package's tests use too) and handed to
both packages. Tolerances: converted weights identical to the JAX
converter's, carried across with `params_from_jax`; configs equal field by
field; the converted port ViT matches HuggingFace's `last_hidden_state`
within 1e-4 (f32, another implementation's summation order); the torch
adapter's tokens and CLS attention equal the JAX adapter's on the same CPU
module within 1e-6.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import hbird_tpu.models.convert as jconvert
import hbird_tpu_torch.models.convert as tconvert
from hbird_tpu.models.torch_adapter import make_torch_ftr_extr_fn as j_make_fn
from hbird_tpu_torch.models import (
    ViT,
    ViTConfig,
    default_ftr_extr_fn,
    make_torch_ftr_extr_fn,
    normalize_minmax,
    wrap_torch_backbone,
)

D, DEPTH, P, GRID = 32, 2, 4, 4

TIMM_VARIANTS = {
    "plain": {},
    "ls_gamma": {"layerscale": "ls1.gamma"},
    "gamma_1": {"layerscale": "gamma_1"},
    "swiglu_w12": {"swiglu": "w12", "layerscale": "ls1.gamma"},
    "swiglu_w1_w2": {"swiglu": "w1"},
    "registers": {"n_reg": 4, "layerscale": "ls1.gamma"},
    "no_qkv_bias": {"qkv_bias": False},
}


def timm_sd(seed=0, layerscale=None, swiglu=None, n_reg=0, qkv_bias=True):
    """A random timm-style state dict of numpy arrays."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    sd = {
        "patch_embed.proj.weight": r(D, 3, P, P),
        "patch_embed.proj.bias": r(D),
        "cls_token": r(1, 1, D),
        "pos_embed": r(1, 1 + GRID * GRID, D),
        "norm.weight": 1 + r(D),
        "norm.bias": r(D),
    }
    h = ((int(D * 4 * 2 / 3) + 7) // 8) * 8 if swiglu else 4 * D
    for i in range(DEPTH):
        b = f"blocks.{i}."
        sd.update({
            b + "norm1.weight": 1 + r(D), b + "norm1.bias": r(D),
            b + "attn.qkv.weight": r(3 * D, D),
            b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
            b + "norm2.weight": 1 + r(D), b + "norm2.bias": r(D),
        })
        if qkv_bias:
            sd[b + "attn.qkv.bias"] = r(3 * D)
        if swiglu == "w12":
            sd.update({b + "mlp.w12.weight": r(2 * h, D), b + "mlp.w12.bias": r(2 * h)})
        elif swiglu == "w1":
            sd.update({b + "mlp.w1.weight": r(h, D), b + "mlp.w1.bias": r(h),
                       b + "mlp.w2.weight": r(h, D), b + "mlp.w2.bias": r(h)})
        if swiglu:
            sd.update({b + "mlp.w3.weight": r(D, h), b + "mlp.w3.bias": r(D)})
        else:
            sd.update({b + "mlp.fc1.weight": r(4 * D, D), b + "mlp.fc1.bias": r(4 * D),
                       b + "mlp.fc2.weight": r(D, 4 * D), b + "mlp.fc2.bias": r(D)})
        if layerscale == "ls1.gamma":
            sd.update({b + "ls1.gamma": r(D), b + "ls2.gamma": r(D)})
        elif layerscale == "gamma_1":
            sd.update({b + "gamma_1": r(D), b + "gamma_2": r(D)})
    if n_reg:
        sd["register_tokens"] = r(1, n_reg, D)
    return sd


def _assert_same(t_out, j_out):
    """Port (state_dict, config) equals JAX (params, config) carried across."""
    (sd, cfg), (jparams, jcfg) = t_out, j_out
    ref = tconvert.params_from_jax(jax_numpy(jparams))
    assert sorted(sd) == sorted(ref)
    for key in ref:
        assert torch.equal(sd[key], ref[key]), key
    for field in dataclasses.fields(cfg):
        if field.name != "compute_dtype":
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
    ViT(cfg).load_state_dict(sd)  # the layout the port's ViT takes


def jax_numpy(tree):
    return {k: jax_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.mark.filterwarnings("ignore:infer_config_from_timm_sd")
@pytest.mark.parametrize("variant", list(TIMM_VARIANTS))
def test_timm_converter_matches_jax(variant):
    sd = timm_sd(seed=len(variant), **TIMM_VARIANTS[variant])
    t = tconvert.convert_timm_vit(sd)
    j = jconvert.convert_timm_vit(sd)
    _assert_same(t, j)
    # torch tensors in, and an explicit config, give the same
    cfg = dataclasses.replace(t[1], num_heads=2)
    t2 = tconvert.convert_timm_vit({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert t2[1] is cfg and all(torch.equal(t2[0][k], t[0][k]) for k in t[0])


@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


def _hf_model(transformers, kind):
    torch.manual_seed(0)
    if kind == "vit":
        cfg = transformers.ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                                     intermediate_size=256, image_size=32, patch_size=8)
        return transformers.ViTModel(cfg, add_pooling_layer=False).eval()
    common = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1, patch_size=8,
                  image_size=32, layerscale_value=1.0)
    if kind == "dinov2":
        model = transformers.Dinov2Model(transformers.Dinov2Config(**common))
    else:
        model = transformers.Dinov2WithRegistersModel(
            transformers.Dinov2WithRegistersConfig(num_register_tokens=4, **common))
    with torch.no_grad():  # randomize the zero/constant-initialized extras
        for name, p in model.named_parameters():
            if "lambda1" in name or "register_tokens" in name or "mask_token" in name:
                p.copy_(torch.randn_like(p) * 0.5)
    return model.eval()


HF = {
    "vit": (tconvert.convert_hf_vit, jconvert.convert_hf_vit),
    "dinov2": (tconvert.convert_hf_dinov2, jconvert.convert_hf_dinov2),
    "dinov2_reg": (tconvert.convert_hf_dinov2, jconvert.convert_hf_dinov2),
}


@pytest.mark.parametrize("kind", list(HF))
def test_hf_converters_match_jax_and_hf(transformers, kind):
    model = _hf_model(transformers, kind)
    sd = dict(model.state_dict())
    t_fn, j_fn = HF[kind]
    sd_t, cfg = t_fn(sd)
    _assert_same((sd_t, cfg), j_fn({k: v.numpy() for k, v in sd.items()}))
    assert cfg.num_register_tokens == (4 if kind == "dinov2_reg" else 0)
    vit = ViT(cfg)
    vit.load_state_dict(sd_t)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        ref = model(x).last_hidden_state
        out = vit(x)
    n_prefix = 1 + cfg.num_register_tokens
    np.testing.assert_allclose(out["x_norm_clstoken"].numpy(), ref[:, 0].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["x_norm_patchtokens"].numpy(), ref[:, n_prefix:].numpy(), rtol=0, atol=1e-4)


@pytest.mark.filterwarnings("ignore:infer_config_from_timm_sd")
def test_convert_auto_sniffs_the_family(transformers):
    cases = {
        "timm": timm_sd(layerscale="ls1.gamma"),
        "hf": {f"vit.{k}": v for k, v in _hf_model(transformers, "vit").state_dict().items()},
        "hf_dinov2": dict(_hf_model(transformers, "dinov2_reg").state_dict()),
    }
    for family, sd in cases.items():
        sd_t, cfg = tconvert.convert(sd, family="auto")
        ref_sd, ref_cfg = tconvert.convert(sd, family=family)
        assert cfg == ref_cfg and all(torch.equal(sd_t[k], ref_sd[k]) for k in ref_sd)
        _assert_same((sd_t, cfg), jconvert.convert(sd, family="auto"))
    assert tconvert.convert(cases["hf"])[1].ln_eps == 1e-12
    assert tconvert.convert(cases["hf_dinov2"])[1].pos_interp_antialias
    with pytest.raises(ValueError, match="family"):
        tconvert.convert(cases["timm"], family="resnet")


@pytest.mark.filterwarnings("ignore:infer_config_from_timm_sd")
@pytest.mark.parametrize("wrapper", ["teacher", "model", "state_dict", "module_prefix", "bare"])
def test_load_torch_state_dict_unwraps(tmp_path, wrapper):
    sd = {k: torch.from_numpy(v) for k, v in timm_sd(seed=3).items()}
    if wrapper == "module_prefix":
        blob = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    elif wrapper == "bare":
        blob = dict(sd, num_batches_tracked=7)  # entries without a shape are dropped
    else:
        blob = {wrapper: sd, "epoch": 3, "args": {"arch": "vit_tiny"}}
    path = str(tmp_path / "ckpt.pth")
    torch.save(blob, path)
    t = tconvert.load_torch_state_dict(path)
    j = jconvert.load_torch_state_dict(path)
    assert sorted(t) == sorted(j) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(t[k], j[k])
    _assert_same(tconvert.convert(path), jconvert.convert(path))


def test_bf16_checkpoint_tensors_convert():
    sd = {k: torch.from_numpy(v).bfloat16() for k, v in timm_sd(seed=4).items()}
    ref = {k: v.float().numpy() for k, v in sd.items()}
    with pytest.warns(UserWarning, match="heads"):
        out, _ = tconvert.convert_timm_vit(sd)
    with pytest.warns(UserWarning, match="heads"):
        expected, _ = tconvert.convert_timm_vit(ref)
    assert all(torch.equal(out[k], expected[k]) for k in expected)


class TinyHub(torch.nn.Module):
    """A DINO-hub-like module with register tokens: dict output with patch
    tokens, and `get_last_selfattention`."""

    num_register_tokens = 2

    def __init__(self):
        super().__init__()
        torch.manual_seed(5)
        self.embed = torch.nn.Linear(3 * P * P, D)
        self.qk = torch.nn.Linear(D, 2 * D)

    def _tokens(self, x):
        b = x.shape[0]
        patches = x.unfold(2, P, P).unfold(3, P, P).permute(0, 2, 3, 1, 4, 5).reshape(b, -1, 3 * P * P)
        t = self.embed(patches)
        prefix = t.mean(1, keepdim=True).expand(b, 1 + self.num_register_tokens, D)
        return torch.cat([prefix, t], 1)

    def forward(self, x):
        t = self._tokens(x)
        return {"x_norm_patchtokens": t[:, 1 + self.num_register_tokens:], "x_norm_clstoken": t[:, 0]}

    def get_last_selfattention(self, x):
        q, k = self.qk(self._tokens(x)).reshape(x.shape[0], -1, 2, 2, D // 2).permute(2, 0, 3, 1, 4)
        return torch.softmax(q @ k.transpose(-2, -1), dim=-1)


def _adapter_modules(transformers):
    return {"hf_vit": _hf_model(transformers, "vit"), "hub_registers": TinyHub().eval()}


@pytest.mark.parametrize("module", ["hf_vit", "hub_registers"])
def test_torch_adapter_matches_jax_adapter(transformers, module):
    model = _adapter_modules(transformers)[module]
    x = np.random.default_rng(2).normal(size=(2, 3, 32, 32)).astype(np.float32)
    jt, ja = j_make_fn(device="cpu", return_attn=True)(model, x)
    t, a = make_torch_ftr_extr_fn(device="cpu", return_attn=True)(model, torch.from_numpy(x))
    n_patches = {"hf_vit": 16, "hub_registers": 64}[module]
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.shape == (2, n_patches, jt.shape[-1])
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-6)
    assert a.shape == (2, n_patches)
    np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=1e-6)
    jt, ja = j_make_fn(device="cpu")(model, x)
    t, a = make_torch_ftr_extr_fn(device="cpu")(model, torch.from_numpy(x))
    assert a is None and ja is None
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-6)


def test_wrapped_module_runs_the_engine_like_the_vit(tmp_path):
    """A live port ViT wrapped as a torch module gives the engine the same
    mIoU as the ViT handed over directly."""
    import hbird_tpu_torch
    from hbird_tpu_torch.data.synthetic import make_voc_fixture

    root = str(tmp_path / "voc")
    make_voc_fixture(root, n_train=8, n_val=4, size=(64, 48), colorize=True, seed=3,
                     class_pool=[1, 2, 3])
    vit = ViT(ViTConfig(P, D, DEPTH, 2, img_size=32, attention_impl="flash"),
              generator=torch.Generator().manual_seed(0))
    common = dict(batch_size=4, input_size=32, n_neighbours=5, num_workers=0, device="cpu")
    random.seed(7)
    direct = hbird_tpu_torch.hbird_evaluation(vit, D, P, "voc", root, **common)
    fe = wrap_torch_backbone(vit, eval_spatial_resolution=8, d_model=D, device="cpu")
    assert not any(p.requires_grad for p in vit.parameters())
    random.seed(7)
    wrapped = hbird_tpu_torch.hbird_evaluation(fe, D, P, "voc", root, **common)
    assert wrapped == direct


def test_default_device_of_the_adapter_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        wrap_torch_backbone(TinyHub(), eval_spatial_resolution=8, d_model=D)


def test_default_ftr_extr_fn_dict_patchtokens_passthrough():
    tok = torch.ones((2, 9, 8))
    feats, attn = default_ftr_extr_fn(lambda imgs: {"x_norm_patchtokens": tok}, None)
    assert feats.shape == (2, 9, 8) and attn is None


def test_default_ftr_extr_fn_cls_drop_heuristic():
    # N = 17 -> N-1 = 16 is a perfect square -> CLS dropped.
    feats, _ = default_ftr_extr_fn(lambda imgs: torch.ones((2, 17, 8)), None)
    assert feats.shape == (2, 16, 8)
    # N = 16 already square -> untouched.
    feats, _ = default_ftr_extr_fn(lambda imgs: torch.ones((2, 16, 8)), None)
    assert feats.shape == (2, 16, 8)


def test_default_ftr_extr_fn_tuple_and_dict_fallbacks():
    feats, _ = default_ftr_extr_fn(lambda imgs: {"last_hidden_state": torch.ones((1, 5, 4))}, None)
    assert feats.shape == (1, 4, 4)
    feats, _ = default_ftr_extr_fn(lambda imgs: (torch.ones((1, 10, 4)), "aux"), None)
    assert feats.shape == (1, 9, 4)
    feats, _ = default_ftr_extr_fn((lambda params, imgs: params * imgs, torch.ones((1, 10, 4))), 2.0)
    assert feats.shape == (1, 9, 4) and float(feats.max()) == 2.0
    with pytest.raises(TypeError):
        default_ftr_extr_fn(3, None)


def test_normalize_minmax():
    x = torch.tensor([[1.0, 3.0, 2.0]])
    np.testing.assert_allclose(normalize_minmax(x).numpy(), [[0, 1, 0.5]])
    assert torch.equal(normalize_minmax(torch.ones(2, 3)), torch.zeros(2, 3))
