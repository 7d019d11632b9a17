"""The configuration's ViT, its weights made on the device from the seed.

The weights follow the port's own random initialisation (truncated normal,
std 0.02, cut at two deviations, for matrices and tokens; zero biases, unit
norms), drawn in a few large calls on the device rather than leaf by leaf
on the host. LayerScale is the exception: the port starts it at 1e-5, which
would leave every block's branch out of the features, so each channel is
drawn uniform in the configuration's `layerscale_range` (the order a trained
model's takes). They are f32, the type the port keeps them
in (it casts them to the compute type at each use). The reference makes the
same tensors again from the same seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.data import mix

_TRUNC = 2.0  # the cut, in standard deviations
_STD = 0.02


def parameter_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Names and shapes of the ViT's parameters, in the port's order and
    with its names (models/vit.py)."""
    d, p, depth = cfg["width"], cfg["patch_size"], cfg["depth"]
    grid = cfg["img_size"] // p
    out = [
        ("cls_token", (1, 1, d)),
        ("pos_embed", (1, 1 + grid * grid, d)),
    ]
    if cfg.get("num_register_tokens", 0):
        out.append(("register_tokens", (1, cfg["num_register_tokens"], d)))
    out += [("patch_embed.weight", (d, p * p * 3)), ("patch_embed.bias", (d,))]
    from portbench.work import mlp_hidden

    h = mlp_hidden(cfg)
    for i in range(depth):
        b = f"blocks.{i}."
        out += [
            (b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
            (b + "attn.qkv.weight", (3 * d, d)),
        ]
        if cfg.get("qkv_bias", True):
            out.append((b + "attn.qkv.bias", (3 * d,)))
        out += [
            (b + "attn.proj.weight", (d, d)), (b + "attn.proj.bias", (d,)),
            (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
        ]
        if cfg.get("swiglu"):
            out += [(b + "mlp.w12.weight", (2 * h, d)), (b + "mlp.w12.bias", (2 * h,)),
                    (b + "mlp.w3.weight", (d, h)), (b + "mlp.w3.bias", (d,))]
        else:
            out += [(b + "mlp.fc1.weight", (h, d)), (b + "mlp.fc1.bias", (h,)),
                    (b + "mlp.fc2.weight", (d, h)), (b + "mlp.fc2.bias", (d,))]
        if cfg.get("layerscale"):
            out += [(b + "ls1", (d,)), (b + "ls2", (d,))]
    out += [("norm.weight", (d,)), ("norm.bias", (d,))]
    return out


def _kind(name: str) -> str:
    if name.endswith("bias"):
        return "zero"
    if ".norm" in name or name.startswith("norm."):
        return "one"
    if name.endswith(("ls1", "ls2")):
        return "ls"
    return "normal"


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, f32 on `device`, from `seed`."""
    shapes = parameter_shapes(cfg)
    n_normal = sum(math.prod(s) for n, s in shapes if _kind(n) == "normal")
    g = torch.Generator(device=device).manual_seed(mix(seed, "weights"))
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    u = torch.rand(n_normal, generator=g, device=device, dtype=torch.float32)
    u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0)
    normal = u.erfinv_().mul_(_STD * math.sqrt(2.0)).clamp_(-_TRUNC * _STD, _TRUNC * _STD)
    n_ls = sum(math.prod(s) for n, s in shapes if _kind(n) == "ls")
    ls_lo, ls_hi = cfg.get("layerscale_range", (1.0, 1.0))
    ls = torch.rand(n_ls, generator=g, device=device, dtype=torch.float32)
    ls.mul_(ls_hi - ls_lo).add_(ls_lo)
    out, at, at_ls = {}, 0, 0
    for name, shape in shapes:
        kind = _kind(name)
        if kind == "normal":
            n = math.prod(shape)
            out[name] = normal[at:at + n].view(shape)
            at += n
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = ls[at_ls:at_ls + n].view(shape)
            at_ls += n
    return out


def port_vit(cfg: dict, seed: int, device):
    """The port's ViT for `cfg`, its parameters set from `make_weights`,
    prepared for the configuration's input size."""
    from hbird_tpu_torch.models.vit import ViT, ViTConfig

    vcfg = ViTConfig(
        patch_size=cfg["patch_size"], width=cfg["width"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"], img_size=cfg["img_size"],
        layerscale=cfg.get("layerscale", False), swiglu=cfg.get("swiglu", False),
        num_register_tokens=cfg.get("num_register_tokens", 0), qkv_bias=cfg.get("qkv_bias", True),
        ln_eps=cfg["ln_eps"], attention_impl=cfg["attention_impl"],
        pos_interp_offset=cfg.get("pos_interp_offset", 0.0),
        pos_interp_antialias=cfg.get("pos_interp_antialias", False),
    )
    with torch.device("meta"):
        vit = ViT(vcfg)
    vit = vit.to_empty(device=device)
    weights = make_weights(cfg, seed, device)
    own = dict(vit.named_parameters())
    if set(own) != set(weights):
        raise RuntimeError(f"parameter names differ: {sorted(set(own) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, prm in own.items():
            prm.copy_(weights[name])
    del weights
    vit.eval()
    return vit.prepare(cfg["input_size"])
