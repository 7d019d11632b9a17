"""The port's ViT against the JAX ViT, weights carried across with
`params_from_jax`.

A tiny ViT (depth 2, width 64, 4 heads, patch 4, image 32) is initialised
by the JAX package from a seed; its parameter pytree goes to the port as
numpy arrays. Tolerances: f32 forward within 1e-5 (same math, another
summation order); bf16 compute within 0.1 absolute and 1e-2 mean absolute
on the final-LN tokens (bf16 rounds at other places in the two frameworks;
the bf16 forward differs from the f32 one by about as much).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu.models.extractor import FeatureExtractor as JFeatureExtractor
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig, interpolate_pos_embed
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.extractor import FeatureExtractor
from hbird_tpu_torch.models.vit import VIT_PRESETS, ViT, ViTConfig
from hbird_tpu_torch.models.vit import interpolate_pos_embed as t_interpolate_pos_embed

VARIANTS = {
    "plain": {},
    "layerscale": {"layerscale": True},
    "swiglu": {"swiglu": True},
    "registers": {"num_register_tokens": 4, "layerscale": True},
}


def _pair(variant, seed=0, **extra):
    kw = {**VARIANTS[variant], **extra}
    jcfg = JConfig(4, 64, 2, 4, img_size=32, **kw)
    tcfg = ViTConfig(4, 64, 2, 4, img_size=32, **kw)
    params = JViT(jcfg).init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    if "ls1" in np_params["blocks"]:
        # LayerScale at its 1e-5 init hides the blocks; make it matter.
        rng = np.random.default_rng(seed)
        for key in ("ls1", "ls2"):
            np_params["blocks"][key] = rng.uniform(0.2, 1.0, np_params["blocks"][key].shape).astype(np.float32)
        params = jax.tree.map(jnp.asarray, np_params)
    tvit = ViT(tcfg)
    tvit.load_state_dict(params_from_jax(np_params))
    return JViT(jcfg), params, tvit


def _images(size, seed=0):
    return np.random.default_rng(seed).normal(size=(2, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_f32(variant):
    jvit, params, tvit = _pair(variant)
    x = _images(32)
    jout = jvit.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tvit(torch.from_numpy(x))
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_bf16(variant):
    jvit, params, tvit = _pair(variant)
    jvit = JViT(dataclasses.replace(jvit.config, compute_dtype=jnp.bfloat16))
    x = _images(32, seed=1)
    j = np.asarray(jvit.apply(params, jnp.asarray(x))["x_norm_patchtokens"])
    with torch.no_grad():
        t = tvit(torch.from_numpy(x), compute_dtype=torch.bfloat16)["x_norm_patchtokens"]
    assert t.dtype == torch.float32
    err = np.abs(t.numpy() - j)
    assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())


def test_forward_bf16_f32_logits():
    jvit, params, tvit = _pair("plain", attn_logits_f32=True)
    jvit = JViT(dataclasses.replace(jvit.config, compute_dtype=jnp.bfloat16))
    x = _images(32, seed=2)
    j = np.asarray(jvit.apply(params, jnp.asarray(x))["x_norm_patchtokens"])
    with torch.no_grad():
        t = tvit(torch.from_numpy(x), compute_dtype=torch.bfloat16)["x_norm_patchtokens"]
    err = np.abs(t.numpy() - j)
    assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())


@pytest.mark.parametrize(
    "convention", [{"offset": 0.1}, {"antialias": True}, {}], ids=["offset", "antialias", "exact_size"]
)
@pytest.mark.parametrize("size", [48, 24], ids=["up", "down"])
def test_pos_interp_conventions(convention, size):
    jvit, params, tvit = _pair("registers")
    jp = jvit.prepare_params(params, size, **convention)
    tvit.prepare(size, **convention)
    np.testing.assert_array_equal(tvit.pos_embed_input.numpy(), np.asarray(jp["pos_embed"]))
    x = _images(size, seed=3)
    j = jvit.apply(jp, jnp.asarray(x))["x_norm_patchtokens"]
    with torch.no_grad():
        t = tvit(torch.from_numpy(x))["x_norm_patchtokens"]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_interpolate_pos_embed_copy_is_identical():
    table = np.random.default_rng(0).normal(size=(1, 1 + 49, 8)).astype(np.float32)
    for kw in ({"offset": 0.1}, {"antialias": True}):
        np.testing.assert_array_equal(
            t_interpolate_pos_embed(table, (11, 9), **kw), interpolate_pos_embed(table, (11, 9), **kw)
        )


def test_prepare_resamples_from_native_table():
    _, _, tvit = _pair("plain")
    tvit.prepare(48)
    first = tvit.pos_embed_input.clone()
    tvit.prepare(24)
    tvit.prepare(48)
    assert torch.equal(first, tvit.pos_embed_input)
    with pytest.raises(ValueError, match="prepare"):
        tvit(torch.zeros(1, 3, 40, 40))


def test_feature_extractor_matches_jax():
    jvit, params, tvit = _pair("layerscale")
    x = _images(32, seed=4)
    j, _ = JFeatureExtractor(jvit, params).forward_features(jnp.asarray(x))
    with torch.no_grad():
        t, attn = FeatureExtractor(tvit).forward_features(torch.from_numpy(x))
    assert attn is None
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_presets_match_jax_presets():
    from hbird_tpu.models.vit import VIT_PRESETS as J_PRESETS

    assert set(VIT_PRESETS) == set(J_PRESETS)
    for name, cfg in VIT_PRESETS.items():
        jcfg = J_PRESETS[name]
        for field in dataclasses.fields(cfg):
            if field.name != "compute_dtype":
                assert getattr(cfg, field.name) == getattr(jcfg, field.name), (name, field.name)
        assert cfg.mlp_hidden == jcfg.mlp_hidden


def test_random_init_is_seeded():
    cfg = ViTConfig(4, 32, 1, 2, img_size=16)
    a = ViT(cfg, generator=torch.Generator().manual_seed(3))
    b = ViT(cfg, generator=torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.patch_embed.weight.abs().max() <= 0.04


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attention_impl"):
        ViT(ViTConfig(4, 32, 1, 2, img_size=16, attention_impl="pallas"))
