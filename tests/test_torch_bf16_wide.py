"""bf16 search 1,664 wide (past the depth at which the card's K1 and K2 keep
their bf16 queries resident): the port's engine against the JAX package.

vit_gigantic_patch14_clip_224 (timm; width 1,664, 48 blocks, an MLP of
8,192) converted by shape gets 26 heads of 64 from both packages'
`infer_config_from_timm_sd`; on the card its bank runs K1 and K2 with the
queries streamed beside each bank chunk (chip_smoke.py phase 5 drives it
at full width). Held here, numpy inputs from a seed:
- both converters give that configuration from the checkpoint's shapes;
- `hbird_evaluation` with a tiny ViT of that width and head count (one
  block, the JAX weights carried across) in `scann` (the flat bf16 bank:
  K1 dot) and `ivf` probing every leaf (a bf16 tree: K2): the mIoU within
  1e-4 of the JAX engine's.
The plain K1 and K2 at D = 1,664 against `pallas_knn` and `pallas_ivf_knn`
are in test_torch_knn.py and test_torch_ivf.py.
"""

import importlib.util
import pathlib
import random

import numpy as np
import pytest

import jax

import hbird_tpu
import hbird_tpu_torch
from hbird_tpu.models.convert import infer_config_from_timm_sd as jax_infer_config
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.models.convert import infer_config_from_timm_sd, params_from_jax
from hbird_tpu_torch.models.vit import ViT, ViTConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTH, HIDDEN = 1664, 8192
INPUT, PATCH, K = 32, 4, 5
ENGINE_RUNS = {
    "scann": ("scann", {}),
    "ivf, every leaf": ("ivf", {"num_leaves": 8, "num_leaves_to_search": 8}),
}


def gigantic_shapes():
    """The shapes of vit_gigantic_patch14_clip_224's timm state dict that
    the converters read (no weights), as chip_smoke.py builds them."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.GIGANTIC_SHAPE["width"], smoke.GIGANTIC_SHAPE["hidden"]) == (WIDTH, HIDDEN)
    return smoke.gigantic_shapes()


def test_converters_give_the_gigantic_configuration():
    cfg = infer_config_from_timm_sd(gigantic_shapes())
    assert (cfg.patch_size, cfg.width, cfg.depth, cfg.num_heads, cfg.head_dim) == (14, WIDTH, 48, 26, 64)
    assert (cfg.mlp_hidden, cfg.img_size, cfg.qkv_bias, cfg.layerscale, cfg.swiglu) == (HIDDEN, 224, True,
                                                                                         False, False)
    jcfg = jax_infer_config(gigantic_shapes())
    assert (jcfg.patch_size, jcfg.width, jcfg.depth, jcfg.num_heads, jcfg.mlp_hidden, jcfg.img_size) == (
        14, WIDTH, 48, 26, HIDDEN, 224)


@pytest.fixture(scope="module")
def gigantic_engine(tmp_path_factory):
    """A VOC fixture and a ViT 1,664 wide (1 block of 26 heads of 64, an
    MLP of 8,192) in both packages, the JAX weights carried across."""
    root = str(tmp_path_factory.mktemp("voc_gigantic") / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3,
                     class_pool=[1, 2, 3, 4, 5])
    jcfg = JConfig(PATCH, WIDTH, 1, 26, mlp_ratio=HIDDEN / WIDTH, img_size=INPUT)
    params = JViT(jcfg).init(jax.random.PRNGKey(0))
    tvit = ViT(ViTConfig(PATCH, WIDTH, 1, 26, mlp_ratio=HIDDEN / WIDTH, img_size=INPUT))
    tvit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return root, (JViT(jcfg), params), tvit


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_gigantic_width_engine_matches_jax(gigantic_engine, run):
    root, jax_model, tvit = gigantic_engine
    assert tvit.config.head_dim == 64 and tvit.config.mlp_hidden == HIDDEN
    nn_method, nn_params = ENGINE_RUNS[run]
    common = dict(d_model=WIDTH, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=4,
                  input_size=INPUT, n_neighbours=K, num_workers=0, nn_method=nn_method)
    random.seed(1234)
    t = hbird_tpu_torch.hbird_evaluation(model=tvit, device="cpu", nn_params=dict(nn_params), **common)
    random.seed(1234)
    j = hbird_tpu.hbird_evaluation(model=jax_model, nn_params=dict(nn_params), **common)
    assert abs(t - j) <= 1e-4, (t, j)
