"""What the job drivers share: the run's context, the sample the reference
judges, the engine's arguments, and the measured window."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.data import mix


def clock() -> float:
    return time.perf_counter()


@dataclass
class Ctx:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the host clock when the process started
    stages: Optional["Stages"] = None  # set-up seconds by step, made by run.execute


@dataclass
class Sample:
    """Images the reference judges, drawn from the seed: train image ids
    whose features are judged, (eval batch, offset) pairs of the window's
    batches, and train image ids whose bank rows are judged (the first
    list and one image of every memory-step batch)."""

    train: List[int]
    val: List[tuple]
    bank: List[int]

    def train_calls(self, batch: int) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for j in self.train:
            out.setdefault(j // batch, []).append(j % batch)
        return out

    def val_batches(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for b, o in self.val:
            out.setdefault(b, []).append(o)
        return out


def draw_sample(seed: int, traffic: dict, val_positions: int) -> Sample:
    """`sample.train` train images, `sample.val` val images among the first
    `val_positions` images the window's eval batches hold, and for the bank
    those train images and one of every batch of the memory build."""
    rng = np.random.default_rng(mix(seed, "sample"))
    spec = traffic["sample"]
    n, b = traffic["train_images"], traffic["batch"]
    train = sorted(int(j) for j in rng.choice(n, spec["train"], replace=False))
    flat = rng.choice(val_positions, spec["val"], replace=False)
    val = sorted((int(v) // b, int(v) % b) for v in flat)
    per_batch = [lo + int(rng.integers(min(b, n - lo))) for lo in range(0, n, b)]
    return Sample(train, val, sorted(set(train) | set(per_batch)))


def engine_seed(seed: int) -> int:
    """The engine's sampling seed, from the run's."""
    return mix(seed, "engine") % (2**31)


def engine_kwargs(ctx: Ctx, dataset_size: int, timer) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    return dict(
        num_classes=tr["classes"], n_neighbours=tr["n_neighbours"],
        augmentation_epoch=cfg["augmentation_epoch"], device=ctx.device,
        nn_method=tr["nn_method"], nn_params=dict(tr["nn_params"]),
        memory_size=tr["memory_size"], dataset_size=dataset_size,
        seed=engine_seed(ctx.seed), device_norm=tuple(tr["device_norm"]), timer=timer,
    )


class Stages:
    """Host seconds of each step of set-up, from the process's start (each
    step ends with the device synchronised)."""

    def __init__(self, ctx: Ctx) -> None:
        self.device = ctx.device
        self.last = ctx.t0
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        if self.device.type != "cuda" or torch.cuda.is_initialized():
            sync(self.device)
        now = clock()
        self.seconds[name] = now - self.last
        self.last = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window: synchronised at both ends, a
    `portbench.window` span, and under `--trace 1` a profiler around it
    whose trace is read in memory when the window closes."""

    def __init__(self, ctx: Ctx) -> None:
        self.ctx = ctx
        self.trace = None
        self.seconds = 0.0

    @contextlib.contextmanager
    def open(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as tracing

        ctx = self.ctx
        sync(ctx.device)
        prof = None
        if ctx.trace:
            acts = [ProfilerActivity.CPU]
            if ctx.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = clock()
        try:
            with record_function("portbench.window"):
                yield self
                sync(ctx.device)
        finally:
            self.seconds = clock() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            self.trace = tracing.parse(prof)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def feature_extractor(ctx: Ctx, recorder):
    from hbird_tpu_torch.models.extractor import FeatureExtractor

    from portbench.model import port_vit
    from portbench.probe import Extractor

    vit = port_vit(ctx.config, ctx.seed, ctx.device)
    cfg = ctx.config
    inner = FeatureExtractor(vit, eval_spatial_resolution=cfg["input_size"] // cfg["patch_size"],
                             d_model=cfg["width"], use_bf16=cfg["compute_dtype"] == "bfloat16")
    return Extractor(inner, recorder)


def split(ctx: Ctx, name: str, n_images: Optional[int] = None):
    from portbench.data import Split

    tr = ctx.traffic
    return Split(ctx.seed, name, n_images or tr[f"{name}_images"], ctx.config["input_size"],
                 tr["batch"], tr["masks"], ctx.device)
