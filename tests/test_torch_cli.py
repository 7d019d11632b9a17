"""The port's command line (hbird_tpu_torch/eval_cli.py) against the JAX
package's (hbird_tpu/eval_cli.py, behind eval.py).

- tests/test_cli.py's parser, config and model-selection cases, on the port.
  `--platform` and `--compilation-cache` configure JAX alone: the port's
  parser rejects them and its RunConfig has no such fields.
- `main([...])` end to end on a VOC fixture with a checkpoint the test
  writes (a depth-2 network of dino_vits16's width and patch): the mIoU in
  its --out JSON within 1e-4 of `hbird_tpu.eval_cli.main` on the same
  fixture and checkpoint, for 'scann' and for 'ivf' with every leaf probed;
  then the persistence flags (a saved bank reloaded with --load-memory gives
  the same mIoU and builds nothing).
The hub loaders are tested with fakes: nothing is downloaded.
"""

import argparse
import json
import sys
import types

import numpy as np
import pytest
import torch

from hbird_tpu_torch import eval_cli
from hbird_tpu_torch.eval_cli import NNBackend, RunConfig, _parse_nn_params, build_model, build_parser
from hbird_tpu_torch.models import FeatureExtractorSimple, ViT

REQUIRED = ["--dataset-name", "voc", "--data-dir", "/d", "--d-model", "768", "--patch-size", "14"]


# ----------------------------------------------------------------------
# Parser and config (tests/test_cli.py::TestParser)
# ----------------------------------------------------------------------
def test_required_and_defaults():
    args = build_parser().parse_args(REQUIRED)
    assert args.batch_size == 64 and args.input_size == 224
    assert args.nn_method == "scann" and args.n_neighbours == 30
    assert args.ignore_index == 255 and args.augmentation_epoch == 1
    assert args.device == "cuda"  # the port runs on the card unless asked
    with pytest.raises(SystemExit):
        build_parser().parse_args(REQUIRED[:4])


def test_memory_persistence_flags():
    p = build_parser()
    args = p.parse_args(REQUIRED + ["--f-mem-p", "/tmp/idx.treedir", "--l-mem-p", "/tmp/lab.npy",
                                    "--load-memory"])
    assert args.f_mem_p == "/tmp/idx.treedir" and args.l_mem_p == "/tmp/lab.npy"
    assert args.load_memory is True
    args2 = p.parse_args(REQUIRED)
    assert args2.f_mem_p is None and not args2.load_memory


def test_nn_param_coercion():
    out = _parse_nn_params(["num_leaves=512", "recall_target=0.9", "use_fp16=true", "name=abc"])
    assert out == {"num_leaves": 512, "recall_target": 0.9, "use_fp16": True, "name": "abc"}


def test_nn_param_invalid():
    with pytest.raises(argparse.ArgumentTypeError):
        _parse_nn_params(["bad-entry"])


def test_fractional_dataset_name_passthrough():
    args = build_parser().parse_args(["--dataset-name", "voc*0.2", "--data-dir", "/d", "--d-model", "384",
                                      "--patch-size", "16"])
    assert args.dataset_name == "voc*0.2"


def test_positive_int_validation():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--dataset-name", "voc", "--data-dir", "/d", "--d-model", "-1",
                                   "--patch-size", "16"])


def test_config_dataclasses():
    cfg = RunConfig(dataset_name="voc", data_dir="/d", d_model=768, patch_size=14,
                    nn=NNBackend(nn_method="faiss", n_neighbours=10))
    assert cfg.nn.nn_method == "faiss" and cfg.device == "cuda"
    # tests/test_cli.py also asserts compilation_cache == ".jax_cache": the
    # XLA compile cache (and --platform) configure JAX and have no
    # counterpart in the port.
    assert not hasattr(cfg, "compilation_cache") and not hasattr(cfg, "platform")


@pytest.mark.parametrize("flag", [["--platform", "cpu"], ["--compilation-cache", ".jax_cache"]])
def test_jax_only_flags_are_rejected(flag):
    with pytest.raises(SystemExit):
        build_parser().parse_args(REQUIRED + flag)


def test_jax_and_port_parsers_share_every_other_flag():
    from hbird_tpu.eval_cli import build_parser as jax_build_parser

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(jax_build_parser()) - flags(build_parser()) == {"--platform", "--compilation-cache"}
    # --mesh-devices is the port's own: a JAX mesh needs distinct devices.
    assert flags(build_parser()) - flags(jax_build_parser()) == {"--mesh-devices"}


def test_mesh_bank_raises(tmp_path):
    """--mesh-bank takes the first N CUDA cards, and there are none here.
    (The flat bank on a mesh: tests/test_torch_parallel_engine.py; the tree
    on one: tests/test_torch_sharded_ivf_engine.py.)"""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            eval_cli.main(REQUIRED + ["--model", "dino_vits16", "--random-init", "--mesh-bank", "2",
                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="needs --mesh-bank"):
        eval_cli.main(REQUIRED + ["--model", "dino_vits16", "--random-init", "--mesh-devices", "cpu,cpu",
                                  "--device", "cpu"])


# ----------------------------------------------------------------------
# build_model (tests/test_cli.py::TestBuildModelNegativePaths and friends)
# ----------------------------------------------------------------------
def _cfg(**kw):
    base = dict(dataset_name="voc", data_dir="/d", d_model=384, patch_size=16)
    base.update(kw)
    return RunConfig(**base)


def test_misspelled_preset_lists_available():
    with pytest.raises(RuntimeError, match="Unknown model preset"):
        build_model(_cfg(model="dino_vitz16"))
    with pytest.raises(RuntimeError, match="dino_vits16"):
        build_model(_cfg(model="dino_vitz16"))


def test_unsupported_dinov2_size():
    with pytest.raises(RuntimeError, match="Unsupported --dinov2"):
        build_model(_cfg(dinov2="vith14", d_model=1280))


def test_no_model_specified():
    with pytest.raises(RuntimeError, match="No model specified"):
        build_model(_cfg())


def test_preset_without_checkpoint_or_random_init():
    with pytest.raises(RuntimeError, match="No --checkpoint"):
        build_model(_cfg(model="dino_vits16"))


def test_random_init_is_the_seeded_preset():
    vit = build_model(_cfg(model="dino_vits16", random_init=True, seed=5))
    from hbird_tpu_torch.models import VIT_PRESETS

    ref = ViT(VIT_PRESETS["dino_vits16"], generator=torch.Generator().manual_seed(5))
    assert isinstance(vit, ViT) and vit.config == ref.config
    for (n, a), (_, b) in zip(vit.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), n


def _timm_state_dict(d, depth, patch, tokens, rng, layerscale=False):
    """A timm-layout ViT state dict with random weights."""
    def w(*shape, scale=0.02):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    sd = {
        "patch_embed.proj.weight": w(d, 3, patch, patch),
        "patch_embed.proj.bias": w(d),
        "cls_token": w(1, 1, d),
        "pos_embed": w(1, 1 + tokens, d),
        "norm.weight": 1 + w(d),
        "norm.bias": w(d),
    }
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({
            b + "norm1.weight": 1 + w(d), b + "norm1.bias": w(d),
            b + "attn.qkv.weight": w(3 * d, d), b + "attn.qkv.bias": w(3 * d),
            b + "attn.proj.weight": w(d, d), b + "attn.proj.bias": w(d),
            b + "norm2.weight": 1 + w(d), b + "norm2.bias": w(d),
            b + "mlp.fc1.weight": w(4 * d, d), b + "mlp.fc1.bias": w(4 * d),
            b + "mlp.fc2.weight": w(d, 4 * d), b + "mlp.fc2.bias": w(d),
        })
        if layerscale:
            sd.update({b + "ls1.gamma": 1 + w(d), b + "ls2.gamma": 1 + w(d)})
    return sd


def test_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "wrong.pth")
    torch.save(_timm_state_dict(384, 2, 8, 28 * 28, np.random.default_rng(0)), path)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        build_model(_cfg(model="dino_vits16", checkpoint=path))


def test_checkpoint_load_carries_preset_interp_convention(tmp_path):
    """A dinov2 preset with a matching checkpoint keeps the preset's hub
    interpolation convention (offset 0.1) and head count, with the
    checkpoint's weights."""
    sd = _timm_state_dict(384, 2, 14, 37 * 37, np.random.default_rng(1), layerscale=True)
    path = str(tmp_path / "dinov2s.pth")
    torch.save(sd, path)
    vit = build_model(_cfg(dinov2="vits14", checkpoint=path))
    assert vit.config.pos_interp_offset == 0.1 and vit.config.layerscale
    assert vit.config.num_heads == 6 and vit.config.depth == 2
    assert torch.equal(vit.cls_token, sd["cls_token"])


class _FakeDino(torch.nn.Module):
    def get_intermediate_layers(self, x, n=1):
        return [torch.zeros(x.shape[0], 1 + 16, 8)]  # CLS + 4x4 patches


def test_runtime_fetch_dino_via_torch_hub(monkeypatch):
    calls = {}

    def fake_hub_load(repo, name, **kw):
        calls["repo"], calls["name"] = repo, name
        return _FakeDino()

    monkeypatch.setattr(torch.hub, "load", fake_hub_load)
    fe = build_model(_cfg(model="dino_vits16", runtime_fetch=True, d_model=8, patch_size=4, input_size=16,
                          device="cpu"))
    assert isinstance(fe, FeatureExtractorSimple)
    assert calls == {"repo": "facebookresearch/dino:main", "name": "dino_vits16"}
    feats, _ = fe.forward_features(torch.zeros(2, 3, 16, 16))
    assert feats.shape == (2, 16, 8)  # CLS dropped


def test_runtime_fetch_timm_for_unknown_names(monkeypatch):
    class FakeTimmViT(torch.nn.Module):
        def forward_features(self, x):
            return torch.zeros(x.shape[0], 1 + 16, 8)

    fake_timm = types.ModuleType("timm")
    created = {}

    def create_model(name, pretrained=False, **kw):
        created["name"], created["pretrained"] = name, pretrained
        return FakeTimmViT()

    fake_timm.create_model = create_model
    monkeypatch.setitem(sys.modules, "timm", fake_timm)
    fe = build_model(_cfg(model="eva02_base_patch14_224", runtime_fetch=True, d_model=8, patch_size=4,
                          input_size=16, device="cpu"))
    assert isinstance(fe, FeatureExtractorSimple)
    assert created == {"name": "eva02_base_patch14_224", "pretrained": True}


def test_checkpoint_beats_runtime_fetch():
    with pytest.raises(RuntimeError, match="Unknown model preset"):
        build_model(_cfg(model="not_a_preset", checkpoint="/nope.pth", runtime_fetch=True))


def test_hf_model_through_transformers(monkeypatch, tmp_path):
    """--hf-model loads transformers' ViTModel and converts it (a fake
    transformers module hands over HF-layout weights)."""
    from hbird_tpu_torch.models.convert import convert_hf_vit

    sd = _hf_state_dict(np.random.default_rng(2))

    class FakeViTModel:
        @staticmethod
        def from_pretrained(name, add_pooling_layer=True):
            assert name == "some/vit" and add_pooling_layer is False
            return types.SimpleNamespace(state_dict=lambda: sd)

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(ViTModel=FakeViTModel))
    vit = build_model(_cfg(hf_model="some/vit"))
    want, cfg = convert_hf_vit(sd)
    assert vit.config == cfg
    for name, t in vit.state_dict().items():
        assert torch.equal(t, want[name]), name


def _hf_state_dict(rng, d=32, depth=1, patch=4, tokens=16):
    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))

    sd = {
        "embeddings.cls_token": w(1, 1, d),
        "embeddings.position_embeddings": w(1, 1 + tokens, d),
        "embeddings.patch_embeddings.projection.weight": w(d, 3, patch, patch),
        "embeddings.patch_embeddings.projection.bias": w(d),
        "layernorm.weight": 1 + w(d),
        "layernorm.bias": w(d),
    }
    for i in range(depth):
        b = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[b + f"attention.attention.{n}.weight"] = w(d, d)
            sd[b + f"attention.attention.{n}.bias"] = w(d)
        sd.update({
            b + "attention.output.dense.weight": w(d, d), b + "attention.output.dense.bias": w(d),
            b + "layernorm_before.weight": 1 + w(d), b + "layernorm_before.bias": w(d),
            b + "layernorm_after.weight": 1 + w(d), b + "layernorm_after.bias": w(d),
            b + "intermediate.dense.weight": w(4 * d, d), b + "intermediate.dense.bias": w(4 * d),
            b + "output.dense.weight": w(d, 4 * d), b + "output.dense.bias": w(d),
        })
    return sd


# ----------------------------------------------------------------------
# main() end to end against the JAX package's command
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def run_inputs(tmp_path_factory):
    from hbird_tpu_torch.data.synthetic import make_voc_fixture

    base = tmp_path_factory.mktemp("cli")
    root = str(base / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3, class_pool=[1, 2, 3, 4, 5])
    ckpt = str(base / "tiny_dino_vits16.pth")
    # dino_vits16's width and patch, two blocks: the presets check width and
    # patch, the converter takes the depth from the checkpoint.
    torch.save(_timm_state_dict(384, 2, 16, 14 * 14, np.random.default_rng(0)), ckpt)
    return root, ckpt, base


def _argv(root, ckpt, out, *extra):
    return ["--dataset-name", "voc", "--data-dir", root, "--model", "dino_vits16", "--checkpoint", ckpt,
            "--d-model", "384", "--patch-size", "16", "--input-size", "32", "--batch-size", "4",
            "--num-workers", "0", "--n-neighbours", "5", "--out", out, "--log-level", "WARNING", *extra]


CLI_RUNS = {
    "scann": [],
    "ivf_full_probe": ["--nn-method", "ivf", "--nn-param", "num_leaves=4", "--nn-param", "num_leaves_to_search=4"],
}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_main_matches_jax_cli(run_inputs, run):
    from hbird_tpu.eval_cli import main as jax_main

    root, ckpt, base = run_inputs
    out, jout = str(base / f"{run}.json"), str(base / f"{run}_jax.json")
    eval_cli.main(_argv(root, ckpt, out, "--device", "cpu", *CLI_RUNS[run]))
    jax_main(_argv(root, ckpt, jout, "--platform", "cpu", "--compilation-cache", "", *CLI_RUNS[run]))
    got, want = json.load(open(out)), json.load(open(jout))
    assert abs(got["miou"] - want["miou"]) <= 1e-4, (got, want)
    assert got["phases"]["memory_build"]["items"] == 12 and got["phases"]["evaluate"]["items"] == 6


@pytest.mark.parametrize("f_name, l_name, method", [
    ("f.bankdir", "l.bankdir", "scann"),
    ("f.bankdir", "l.bankdir", "ivf"),  # the streamed tree build from the saved bank
    ("idx.treedir", None, "ivf"),
    ("f.npy", "l.npy", "faiss"),
])
def test_main_persists_and_reloads(run_inputs, f_name, l_name, method):
    root, ckpt, base = run_inputs
    d = base / f"persist_{method}_{f_name}"
    d.mkdir()
    paths = ["--f-mem-p", str(d / f_name)] + ([] if l_name is None else ["--l-mem-p", str(d / l_name)])
    flags = ["--device", "cpu", "--nn-method", method, "--nn-param", "num_leaves=4", *paths]
    built, loaded = str(d / "built.json"), str(d / "loaded.json")
    eval_cli.main(_argv(root, ckpt, built, *flags))
    eval_cli.main(_argv(root, ckpt, loaded, *flags, "--load-memory"))
    a, b = json.load(open(built)), json.load(open(loaded))
    assert b["phases"]["memory_build"].get("items", 0) == 0 and "index_build" not in b["phases"]
    assert b["miou"] == a["miou"]


def test_profile_flag_sets_the_trace_dir(run_inputs, monkeypatch, tmp_path):
    root, ckpt, _ = run_inputs
    monkeypatch.setenv("HBIRD_PROFILE_DIR", "")  # restored (unset) after the test
    prof = tmp_path / "prof"
    eval_cli.main(_argv(root, ckpt, str(tmp_path / "o.json"), "--device", "cpu", "--profile", str(prof)))
    assert sorted(p.name for p in prof.iterdir()) == ["evaluate.json", "index_build.json", "memory_build.json"]
