"""Evaluation command line: `python -m hbird_tpu_torch.eval_cli ...`.

Counterpart of hbird_tpu/eval_cli.py (the JAX package's `eval.py`), with the
same flags, running the PyTorch engine on one CUDA card (`--device cpu`
runs it on the CPU). Model loading: a preset (--dinov2 / --model /
--timm-model) with weights from a local torch checkpoint (--checkpoint,
converted by models/convert.py) or random weights from the seed
(--random-init); a HuggingFace ViT (--hf-model); or, with --runtime-fetch,
the live torch module from torch.hub / timm (needs the network or a hub
cache).

Two flags of the JAX command configure JAX alone and have no counterpart:
--platform (the JAX backend; here --device) and --compilation-cache (the
XLA compile cache; nothing is compiled here beyond the CUDA kernels, which
cache themselves under build/).

--mesh-bank N shards the flat bank over N devices (parallel/): by default
the first N CUDA cards, as the JAX command takes the first N devices. One
flag is the port's own: --mesh-devices lists the mesh's devices, and a
device may repeat (cuda:0,cuda:0,cuda:0,cuda:0 stacks four shards on one
card; cpu,cpu,... with --device cpu). The JAX command has no such flag
because a JAX mesh needs distinct devices.

Examples:
    python -m hbird_tpu_torch.eval_cli --dataset-name voc --data-dir /data/voc \\
        --dinov2 vitb14 --checkpoint /ckpts/dinov2_vitb14.pth \\
        --d-model 768 --patch-size 14 --input-size 518 --batch-size 16 \\
        --nn-method scann --f-mem-p bank.bankdir --l-mem-p labels.bankdir \\
        --out results.json

    # later runs reuse the saved bank (or, with --nn-method ivf, build the
    # tree from it by the streamed build)
    python -m hbird_tpu_torch.eval_cli ... --f-mem-p bank.bankdir \\
        --l-mem-p labels.bankdir --load-memory
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import random
import sys
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _positive_int(value: str) -> int:
    iv = int(value)
    if iv <= 0:
        raise argparse.ArgumentTypeError("value must be a positive integer")
    return iv


@dataclass
class NNBackend:
    nn_method: str = "scann"  # 'scann' (approx) | 'faiss' (exact) | aliases
    n_neighbours: int = 30
    nn_params: Optional[Dict[str, Any]] = None


@dataclass
class RunConfig:
    dataset_name: str
    data_dir: str
    d_model: int
    patch_size: int

    batch_size: int = 64
    input_size: int = 224
    augmentation_epoch: int = 1
    device: str = "cuda"
    memory_size: Optional[int] = None
    num_workers: int = 8
    ignore_index: int = 255

    train_fs_path: Optional[str] = None
    val_fs_path: Optional[str] = None

    # Memory/index persistence (the engine's f_mem_p / l_mem_p / load_memory)
    f_mem_p: Optional[str] = None
    l_mem_p: Optional[str] = None
    load_memory: bool = False

    # Model selection
    model: Optional[str] = None  # preset name (models/vit.py VIT_PRESETS)
    timm_model: Optional[str] = None
    dinov2: Optional[str] = None  # vits14 | vitb14 | vitl14 | vitg14
    checkpoint: Optional[str] = None
    random_init: bool = False
    hf_model: Optional[str] = None  # HuggingFace id or local dir
    # Resolve --model/--dinov2 via torch.hub / timm.create_model when there
    # is no checkpoint, and run the live torch module (models/torch_adapter.py).
    runtime_fetch: bool = False

    amp: bool = False  # bf16 backbone compute
    seed: Optional[int] = 123

    nn: NNBackend = field(default_factory=NNBackend)

    mesh_bank: Optional[int] = None  # shard the bank over N devices
    mesh_devices: Optional[str] = None  # comma-separated devices of that mesh (may repeat)
    bf16_bank: bool = False
    # The JAX command's `platform` and `compilation_cache` configure JAX and
    # have no counterpart here.
    loader_mode: str = "thread"  # 'process' scales host decode with cores
    device_normalize: bool = True  # uint8 host feed + on-device normalize

    out: Optional[str] = None
    log_level: str = "INFO"
    knn_details_out: Optional[str] = None  # .npz dump of kNN details
    profile_dir: Optional[str] = None  # torch.profiler traces (HBIRD_PROFILE_DIR)


def set_seed(seed: Optional[int]) -> None:
    """Seed python, numpy and torch RNGs (reference eval.py:180-186); the
    engine's sampling generator is seeded by its own `seed`."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def configure_logging(level: str = "INFO") -> None:
    lvl = getattr(logging, level.upper(), logging.INFO)
    logging.basicConfig(format="[%(levelname)s] %(message)s", level=lvl, force=True)


def _runtime_fetch_backbone(cfg: RunConfig, name: str):
    """A live torch backbone by name (reference eval.py:207-234):
    'dinov2_*' from torch.hub facebookresearch/dinov2, 'dino_*' from
    facebookresearch/dino, anything else from timm.create_model(name,
    pretrained=True), wrapped as a FeatureExtractorSimple on cfg.device."""
    from hbird_tpu_torch.models.torch_adapter import wrap_torch_backbone

    if name.startswith("dinov2_"):
        module = torch.hub.load("facebookresearch/dinov2", name)
        fwd = lambda m, x: m.forward_features(x)  # noqa: E731
    elif name.startswith("dino_"):
        # DINO hub models return the CLS embedding from __call__; the patch
        # tokens come from get_intermediate_layers.
        module = torch.hub.load("facebookresearch/dino:main", name)
        fwd = lambda m, x: m.get_intermediate_layers(x)[0]  # noqa: E731
    else:
        import timm

        module = timm.create_model(name, pretrained=True)
        fwd = lambda m, x: m.forward_features(x)  # noqa: E731
    return wrap_torch_backbone(
        module,
        eval_spatial_resolution=cfg.input_size // cfg.patch_size,
        d_model=cfg.d_model,
        device=cfg.device,
        use_amp=cfg.amp,
        forward=fwd,
    )


def build_model(cfg: RunConfig):
    """The backbone the config names: a `ViT` with its weights, or (with
    --runtime-fetch and no checkpoint) a wrapped live torch module.

    Priority: --dinov2 > --model > --timm-model > --hf-model, as in the
    reference (eval.py:198-239).
    """
    from hbird_tpu_torch.models.convert import convert, convert_hf_vit
    from hbird_tpu_torch.models.vit import VIT_PRESETS, ViT

    preset_name = None
    if cfg.dinov2:
        name = cfg.dinov2.lower()
        valid = {"vits14": 384, "vitb14": 768, "vitl14": 1024, "vitg14": 1536}
        if name not in valid:
            raise RuntimeError(
                f"Unsupported --dinov2 '{cfg.dinov2}'. Choose from: {sorted(valid)}"
            )
        if cfg.d_model != valid[name]:
            logging.getLogger("eval").warning(
                "d_model (%d) does not match expected for %s (%d). Proceeding anyway.",
                cfg.d_model,
                name,
                valid[name],
            )
        preset_name = f"dinov2_{name}"
    elif cfg.model:
        preset_name = cfg.model
    elif cfg.timm_model:
        preset_name = cfg.timm_model

    if cfg.runtime_fetch and preset_name is not None and not cfg.checkpoint and not cfg.random_init:
        return _runtime_fetch_backbone(cfg, preset_name)

    if preset_name is not None:
        if preset_name not in VIT_PRESETS:
            raise RuntimeError(
                f"Unknown model preset '{preset_name}'. Available: "
                f"{sorted(VIT_PRESETS)} — or pass --hf-model, "
                "--runtime-fetch (torch.hub/timm on a networked host), "
                "or plug your own model via the library API."
            )
        config = VIT_PRESETS[preset_name]
        if cfg.checkpoint:
            state_dict, conv_cfg = convert(cfg.checkpoint, family="auto")
            if (conv_cfg.width, conv_cfg.patch_size) != (config.width, config.patch_size):
                raise RuntimeError(
                    f"Checkpoint shape mismatch: preset {preset_name} expects "
                    f"width={config.width}/patch={config.patch_size}, checkpoint "
                    f"has width={conv_cfg.width}/patch={conv_cfg.patch_size}"
                )
            # The preset's family conventions, which shapes cannot tell:
            # head count, LN eps and the pos-embed interpolation convention.
            vit = ViT(dataclasses.replace(
                conv_cfg, ln_eps=config.ln_eps, num_heads=config.num_heads,
                pos_interp_offset=config.pos_interp_offset,
                pos_interp_antialias=config.pos_interp_antialias,
            ))
            vit.load_state_dict(state_dict)
            return vit
        if not cfg.random_init:
            raise RuntimeError(
                "No --checkpoint given. Pass --checkpoint <torch .pth> or "
                "--random-init for random weights (no network access on this host)."
            )
        return ViT(config, generator=torch.Generator().manual_seed(cfg.seed or 0))

    if cfg.hf_model:
        import transformers

        hf = transformers.ViTModel.from_pretrained(cfg.hf_model, add_pooling_layer=False)
        state_dict, config = convert_hf_vit(dict(hf.state_dict()))
        vit = ViT(config)
        vit.load_state_dict(state_dict)
        return vit

    raise RuntimeError(
        "No model specified. Provide --dinov2, --model, --timm-model or --hf-model."
    )


def run(cfg: RunConfig) -> Dict[str, Any]:
    """Evaluate as configured; returns (and with --out writes) the summary:
    the mIoU and the engine's phase times."""
    from hbird_tpu_torch.hbird_eval import hbird_evaluation
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    logger = logging.getLogger("eval")
    logger.info("===== Hummingbird Evaluation (PyTorch) =====")
    logger.info("Config: %s", json.dumps(_public_config_dict(cfg), indent=2))
    mesh = None
    if cfg.mesh_bank:
        from hbird_tpu_torch.parallel import make_mesh

        devices = cfg.mesh_devices.split(",") if cfg.mesh_devices else None
        mesh = make_mesh((cfg.mesh_bank,), ("bank",), devices)
    elif cfg.mesh_devices:
        raise ValueError("--mesh-devices needs --mesh-bank")

    set_seed(cfg.seed)
    if cfg.profile_dir:
        os.environ["HBIRD_PROFILE_DIR"] = cfg.profile_dir
    model = build_model(cfg)
    timer = PhaseTimer()
    result = hbird_evaluation(
        model=model,
        d_model=cfg.d_model,
        patch_size=cfg.patch_size,
        dataset_name=cfg.dataset_name,
        data_dir=cfg.data_dir,
        batch_size=cfg.batch_size,
        input_size=cfg.input_size,
        augmentation_epoch=cfg.augmentation_epoch,
        device=cfg.device,
        return_knn_details=bool(cfg.knn_details_out),
        n_neighbours=cfg.nn.n_neighbours,
        nn_method=cfg.nn.nn_method,
        nn_params=cfg.nn.nn_params,
        memory_size=cfg.memory_size,
        num_workers=cfg.num_workers,
        ignore_index=cfg.ignore_index,
        train_fs_path=cfg.train_fs_path,
        val_fs_path=cfg.val_fs_path,
        f_mem_p=cfg.f_mem_p,
        l_mem_p=cfg.l_mem_p,
        load_memory=cfg.load_memory,
        loader_mode=cfg.loader_mode,
        device_normalize=cfg.device_normalize,
        seed=cfg.seed or 123,
        bf16_bank=cfg.bf16_bank,
        bf16_model=cfg.amp,
        mesh=mesh,
        timer=timer,
    )

    if isinstance(result, tuple) and len(result) == 2:
        miou, details = result
        summary = {"miou": float(miou), **{k: "<arrays>" for k in details}}
        if cfg.knn_details_out:
            out_dir = os.path.dirname(cfg.knn_details_out)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
            np.savez(cfg.knn_details_out, **details)
            summary["knn_details_path"] = cfg.knn_details_out
            logger.info("Saved kNN details to %s", cfg.knn_details_out)
    else:
        summary = {"miou": float(result)}
    summary["phases"] = timer.summary()

    if cfg.out:
        out_dir = os.path.dirname(cfg.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(cfg.out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
        logger.info("Saved results to %s", cfg.out)

    logger.info("===== Summary =====")
    for k, v in summary.items():
        try:
            logger.info("%s: %.4f", k, float(v))
        except (TypeError, ValueError):
            logger.info("%s: %s", k, v)
    return summary


def _public_config_dict(cfg: RunConfig) -> Dict[str, Any]:
    d = asdict(cfg)
    if d.get("nn", {}).get("nn_params"):
        d["nn"]["nn_params"] = {
            k: d["nn"]["nn_params"][k] for k in sorted(d["nn"]["nn_params"])[:8]
        }
    return d


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=(
            "Evaluate a ViT backbone with the Hummingbird retrieval + "
            "soft-label aggregation pipeline on a CUDA card. Dataset "
            "subsampling via the dataset name (e.g. 'voc*0.2')."
        ),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--dataset-name", required=True,
                   help="voc | ade20k | cityscapes | coco-thing | coco-stuff "
                        "(optionally '*fract', e.g. voc*0.2)")
    p.add_argument("--data-dir", required=True,
                   help="Dataset root folder or .tar archive.")
    p.add_argument("--d-model", type=_positive_int, required=True)
    p.add_argument("--patch-size", type=_positive_int, required=True)
    p.add_argument("--batch-size", type=_positive_int, default=64)
    p.add_argument("--input-size", type=_positive_int, default=224)
    p.add_argument("--augmentation-epoch", type=_positive_int, default=1)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'.")
    p.add_argument("--amp", action="store_true",
                   help="bf16 backbone compute.")
    p.add_argument("--n-neighbours", type=_positive_int, default=30)
    p.add_argument("--nn-method",
                   choices=["scann", "faiss", "exact", "approx", "ivf", "tree"],
                   default="scann",
                   help="faiss/exact and scann/approx = the flat bank "
                        "searched exactly (the fused top-k kernel); "
                        "ivf/tree = leaf-partitioned scan (ScaNN tree() "
                        "semantics; num_leaves / num_leaves_to_search "
                        "nn-params). ivf with --nn-param recall_target=R "
                        "(and no explicit num_leaves_to_search) MEASURES the "
                        "smallest probe count meeting recall R against a "
                        "full-probe oracle.")
    p.add_argument("--nn-param", action="append", default=[], metavar="KEY=VALUE",
                   help="Extra NN param (repeatable), e.g. --nn-param use_fp16=true")
    p.add_argument("--memory-size", type=int, default=None)
    p.add_argument("--f-mem-p", dest="f_mem_p", type=str, default=None,
                   help="Persist the feature memory / index here. Formats "
                        "by suffix: .npy/.npz/.pt flat bank, .bankdir "
                        "chunked bank, .treedir the BUILT IVF index "
                        "(reload skips k-means+layout+scatter).")
    p.add_argument("--l-mem-p", dest="l_mem_p", type=str, default=None,
                   help="Persist the label memory here (same formats; "
                        "unused by .treedir, which stores labels inside).")
    p.add_argument("--load-memory", action="store_true",
                   help="Restore the persisted bank/index from "
                        "--f-mem-p/--l-mem-p instead of building from the "
                        "train set (falls back to a build when absent).")
    p.add_argument("--ignore-index", type=int, default=255)
    p.add_argument("--train-fs", dest="train_fs_path", type=str, default=None)
    p.add_argument("--val-fs", dest="val_fs_path", type=str, default=None)
    # Model selection
    p.add_argument("--model", type=str, default=None,
                   help="Preset (e.g. dino_vits16, dinov2_vitb14, "
                        "mae_vitl16, mocov3_vitb16).")
    p.add_argument("--timm-model", type=str, default=None,
                   help="timm model name (resolved against local presets; "
                        "weights from --checkpoint).")
    p.add_argument("--dinov2", type=str,
                   choices=["vits14", "vitb14", "vitl14", "vitg14"], default=None)
    p.add_argument("--hf-model", type=str, default=None,
                   help="HuggingFace ViT id or local dir (transformers).")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Torch checkpoint (.pth) converted to the preset's ViT.")
    p.add_argument("--random-init", action="store_true",
                   help="Random weights from the seed (smoke tests / benchmarking).")
    p.add_argument("--runtime-fetch", action="store_true",
                   help="Resolve --model/--dinov2 at runtime via "
                        "torch.hub / timm.create_model (reference "
                        "eval.py:207-234) and run the live torch module. "
                        "Needs network or cached hub models.")
    p.add_argument("--mesh-bank", type=int, default=None,
                   help="Shard the memory bank over N devices (default: the first N CUDA cards).")
    p.add_argument("--mesh-devices", default=None,
                   help="Comma-separated devices of the --mesh-bank mesh; a device may repeat "
                        "(cuda:0,cuda:0,cuda:0,cuda:0 stacks four shards on one card). Not in the "
                        "JAX command, whose meshes need distinct devices.")
    p.add_argument("--bf16-bank", action="store_true",
                   help="Store the bank in bfloat16 (faiss useFloat16 analogue).")
    # Misc
    p.add_argument("--host-normalize", action="store_true",
                   help="normalize images on the host (float32 feed) instead "
                        "of the default uint8 feed + on-device normalize")
    p.add_argument("--loader-mode", choices=["thread", "process"], default="thread",
                   help="Data-loader workers: threads or spawned processes "
                        "(scales decode with cores).")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--knn-details", dest="knn_details_out", type=str,
                   default=None, metavar="PATH.npz",
                   help="dump per-query kNN details (neighbor features/"
                        "labels/cross-attention labels) to an .npz")
    p.add_argument("--profile", dest="profile_dir", type=str, default=None,
                   metavar="DIR",
                   help="write torch.profiler traces per phase to DIR "
                        "(equivalent to HBIRD_PROFILE_DIR)")
    p.add_argument("--log-level", choices=["DEBUG", "INFO", "WARNING", "ERROR"],
                   default="INFO")
    return p


def _parse_nn_params(kv_list: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in kv_list:
        if "=" not in kv:
            raise argparse.ArgumentTypeError(f"Invalid --nn-param '{kv}'. Use KEY=VALUE.")
        k, v = kv.split("=", 1)
        k, v = k.strip(), v.strip()
        if v.lower() in {"true", "false"}:
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    nn_params = _parse_nn_params(args.nn_param)
    cfg = RunConfig(
        dataset_name=args.dataset_name,
        data_dir=args.data_dir,
        d_model=args.d_model,
        patch_size=args.patch_size,
        batch_size=args.batch_size,
        input_size=args.input_size,
        augmentation_epoch=args.augmentation_epoch,
        device=args.device,
        memory_size=args.memory_size,
        num_workers=args.num_workers,
        ignore_index=args.ignore_index,
        train_fs_path=args.train_fs_path,
        val_fs_path=args.val_fs_path,
        f_mem_p=args.f_mem_p,
        l_mem_p=args.l_mem_p,
        load_memory=bool(args.load_memory),
        model=args.model,
        timm_model=args.timm_model,
        dinov2=args.dinov2,
        hf_model=args.hf_model,
        checkpoint=args.checkpoint,
        random_init=bool(args.random_init),
        runtime_fetch=bool(args.runtime_fetch),
        amp=bool(args.amp),
        seed=args.seed,
        nn=NNBackend(
            nn_method=args.nn_method,
            n_neighbours=args.n_neighbours,
            nn_params=nn_params or None,
        ),
        mesh_bank=args.mesh_bank,
        mesh_devices=args.mesh_devices,
        loader_mode=args.loader_mode,
        device_normalize=not bool(args.host_normalize),
        bf16_bank=bool(args.bf16_bank),
        out=args.out,
        log_level=args.log_level,
        knn_details_out=args.knn_details_out,
        profile_dir=args.profile_dir,
    )
    configure_logging(cfg.log_level)
    try:
        run(cfg)
    except KeyboardInterrupt:
        logging.getLogger("eval").warning("Interrupted by user.")
        sys.exit(130)


if __name__ == "__main__":
    main()
