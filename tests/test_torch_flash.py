"""K3's plain version and the port ViT's attention forms against the JAX package.

- `flash_attention_plain` against `hbird_tpu.models.vit._flash_attention`,
  which runs JAX's library Pallas TPU flash attention, here in interpret
  mode (padding to 512, segment ids, block sizes and all). Inputs are
  unit normals from numpy. Tolerances: f32 within 1e-5 absolute (the same
  products summed in another order); bf16 within 2^-8 · max|out| (half an
  ulp of the largest outputs, where one bf16 rounding of p or of the output
  may go the other way), with fewer than 1% of the outputs differing at
  all.
- The port's ViT with 'flash' (the plain version on the CPU) against the
  JAX ViT's 'xla' math, since JAX runs 'flash' only on a TPU; 'chunked'
  against JAX 'chunked'; attention weights, CLS attention and Q/K/V
  features against JAX. The tiny ViTs are those of `test_torch_vit.py`
  (depth 2, width 64, 4 heads, patch 4, image 32), weights carried across
  with `params_from_jax`. Tolerances as there: f32 within 1e-5; bf16 within
  0.1 absolute and 1e-2 mean absolute on the final-LN tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hbird_tpu.models.extractor import FeatureExtractor as JFeatureExtractor
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig, _flash_attention
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.extractor import FeatureExtractor
from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.ops import flash_cuda
from hbird_tpu_torch.ops.flash import flash_attention_plain

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {
    "plain": {},
    "layerscale": {"layerscale": True},
    "swiglu": {"swiglu": True},
    "registers": {"num_register_tokens": 4, "layerscale": True},
}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("n", [1, 50, 197, 600])
def test_plain_matches_tpu_kernel_in_interpret_mode(n, hd, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv((2, 2, n, hd), seed=n * 100 + hd)
    with pltpu.force_tpu_interpret_mode():
        j = _flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), hd**-0.5)
        j = np.asarray(j.astype(jnp.float32))
    t = flash_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), hd**-0.5)
    assert t.dtype == tdt and t.shape == (2, 2, n, hd)
    err = np.abs(t.float().numpy() - j)
    if dtype == "f32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 2.0**-8 * np.abs(j).max(), err.max()
        assert (err > 0).mean() < 0.01, (err > 0).mean()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 40, 16), seed=1))
    before = flash_cuda.flash_attention.launches
    out = flash_cuda.flash_attention(q, k, v, 0.25)
    assert torch.equal(out, flash_attention_plain(q, k, v, 0.25))
    assert flash_cuda.flash_attention.launches == before  # launches count the kernel only
    with pytest.raises(ValueError, match="dtype"):
        flash_cuda.flash_attention(q, k.bfloat16(), v, 0.25)
    with pytest.raises(ValueError, match="shape"):
        flash_cuda.flash_attention(q, k[:, :, :39], v, 0.25)


def _pair(variant, seed=0, **extra):
    """The JAX ViT and its params, and the port's ViT with the same weights."""
    kw = {**VARIANTS[variant], **extra}
    jkw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    jcfg = JConfig(4, 64, 2, 4, img_size=32, **jkw)
    tcfg = ViTConfig(4, 64, 2, 4, img_size=32, **kw)
    np_params = jax.tree.map(np.asarray, JViT(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for key in ("ls1", "ls2"):
        if key in np_params["blocks"]:
            # LayerScale at its 1e-5 init hides the blocks; make it matter.
            np_params["blocks"][key] = rng.uniform(0.2, 1.0, np_params["blocks"][key].shape).astype(np.float32)
    if "register_tokens" in np_params:
        np_params["register_tokens"] = rng.normal(0, 0.5, np_params["register_tokens"].shape).astype(np.float32)
    tvit = ViT(tcfg)
    tvit.load_state_dict(params_from_jax(np_params))
    return jcfg, jax.tree.map(jnp.asarray, np_params), tvit


def _images(seed, size=32):
    return np.random.default_rng(seed).normal(size=(2, 3, size, size)).astype(np.float32)


def _jax_tokens(jcfg, params, x, **cfg):
    jvit = JViT(dataclasses.replace(jcfg, **cfg))
    return np.asarray(jvit.apply(params, jnp.asarray(x))["x_norm_patchtokens"])


def _assert_close(t, j, dtype):
    err = np.abs(t - j)
    if dtype == "f32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_vit_matches_jax_xla(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, params, tvit = _pair(variant, attention_impl="flash")
    x = _images(seed=5)
    j = _jax_tokens(jcfg, params, x, attention_impl="xla", compute_dtype=jdt)
    with torch.no_grad():
        t = tvit(torch.from_numpy(x), compute_dtype=tdt)["x_norm_patchtokens"]
    _assert_close(t.numpy(), j, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [8, 256])
def test_chunked_vit_matches_jax_chunked(chunk, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, params, tvit = _pair("registers", attention_impl="chunked", attention_chunk_q=chunk)
    x = _images(seed=6)
    j = _jax_tokens(jcfg, params, x, compute_dtype=jdt)
    with torch.no_grad():
        t = tvit(torch.from_numpy(x), compute_dtype=tdt)["x_norm_patchtokens"]
    _assert_close(t.numpy(), j, dtype)
    if dtype == "f32":  # the 'xla' math block by block
        xvit = ViT(dataclasses.replace(tvit.config, attention_impl="xla"))
        xvit.load_state_dict(tvit.state_dict())
        with torch.no_grad():
            xla = xvit(torch.from_numpy(x))["x_norm_patchtokens"]
        np.testing.assert_allclose(t.numpy(), xla.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash", "chunked"])
@pytest.mark.parametrize("variant", ["plain", "registers"])
def test_attention_outputs_match_jax(variant, impl):
    """The last block returns its weights ('xla' math whatever the form);
    cls_attention is their normalized CLS row; tokens are unchanged."""
    jcfg, params, tvit = _pair(variant, attention_impl=impl, attention_chunk_q=8)
    jvit = JViT(jcfg)
    x = _images(seed=7)
    jout = jvit.apply(params, jnp.asarray(x), return_attention=True)
    with torch.no_grad():
        tout = tvit(torch.from_numpy(x), return_attention=True)
        plain = tvit(torch.from_numpy(x))
        cls = tvit.cls_attention(torch.from_numpy(x))
    assert plain["attn"] is None
    n_tokens = 1 + jcfg.num_register_tokens + 64
    assert tout["attn"].shape == (2, 4, n_tokens, n_tokens)
    np.testing.assert_allclose(tout["attn"].numpy(), np.asarray(jout["attn"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tout["x_norm_patchtokens"].numpy(), np.asarray(jout["x_norm_patchtokens"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        plain["x_norm_patchtokens"].numpy(), tout["x_norm_patchtokens"].numpy(), rtol=0, atol=1e-5)
    jcls = np.asarray(jvit.cls_attention(params, jnp.asarray(x)))
    assert cls.shape == (2, 64)
    np.testing.assert_allclose(cls.numpy(), jcls, rtol=0, atol=1e-5)


@pytest.mark.parametrize("feat,layer", [("q", 0), ("k", -1), ("v", 1)])
@pytest.mark.parametrize("variant", ["layerscale", "registers"])
def test_qkv_features_match_jax(variant, feat, layer):
    jcfg, params, tvit = _pair(variant, attention_impl="flash")
    x = _images(seed=8)
    j = np.asarray(JViT(jcfg).qkv_features(params, jnp.asarray(x), feat=feat, layer_num=layer))
    with torch.no_grad():
        t = tvit.qkv_features(torch.from_numpy(x), feat=feat, layer_num=layer)
    assert t.shape == (2, 64, 64) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="feat"):
        tvit.qkv_features(torch.from_numpy(x), feat="x")


def test_feature_extractor_attention_methods_match_jax():
    jcfg, params, tvit = _pair("registers", attention_impl="flash")
    jfe = JFeatureExtractor(JViT(jcfg), params)
    fe = FeatureExtractor(tvit)
    x = _images(seed=9)
    jt, ja = jfe.forward_features_with_attention(jnp.asarray(x))
    jf, jfa = jfe.get_intermediate_layer_feats(jnp.asarray(x), feat="k", layer_num=1)
    with torch.no_grad():
        t, a = fe.forward_features_with_attention(torch.from_numpy(x))
        f, fa = fe.get_intermediate_layer_feats(torch.from_numpy(x), feat="k", layer_num=1)
    for ours, theirs in ((t, jt), (a, ja), (f, jf), (fa, jfa)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
