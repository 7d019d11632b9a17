"""The one generator of the benchmark's images and masks.

Every traffic file (`traffic/<name>.json`) gives its splits' sizes, the
input side, the batch and a `masks` block; this module turns those numbers
and `--seed` into data. Images are uint8 (B, 3, S, S), masks uint8 class ids
(B, 1, S, S): a background of class 0 under a few axis-aligned objects, each
of a class drawn from 1..C-1, each ringed by a band of 255 (the void border
that Pascal VOC draws around objects). The pixels of an object are tinted
with its class's colour over uniform noise, so every image is distinct and
its features carry its labels.

Images are made in chunks of one batch, on the device, by a generator
seeded from (seed, split, chunk): any chunk can be made again alone, which
the reference does for the images it samples.
"""

from __future__ import annotations

import hashlib
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np
import torch

MASK_IGNORE = 255


def mix(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed is any whole number)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclass(frozen=True)
class Split:
    seed: int
    name: str
    n_images: int
    size: int
    batch: int
    masks: dict
    device: torch.device

    @property
    def n_chunks(self) -> int:
        return -(-self.n_images // self.batch)

    def chunk(self, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images c·batch .. (c+1)·batch - 1 (fewer in the last chunk) on the
        device: (uint8 images, uint8 masks)."""
        lo = c * self.batch
        b = min(self.batch, self.n_images - lo)
        if b <= 0:
            raise IndexError(f"chunk {c} of {self.n_chunks}")
        g = torch.Generator(device=self.device).manual_seed(mix(self.seed, self.name, c))
        return _images_and_masks(g, b, self.size, self.masks, self.device)

    def host_chunk(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.chunk(c)
        return x.cpu().numpy(), y.cpu().numpy()

    def image(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image j alone, as (1, 3, S, S) and (1, 1, S, S)."""
        x, y = self.chunk(j // self.batch)
        o = j % self.batch
        return x[o:o + 1], y[o:o + 1]


def _palette(n_classes: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    colours = torch.randint(0, 256, (n_classes + 1, 3), generator=g, dtype=torch.int64)
    colours[-1] = 128  # the void border
    return colours.to(device)


def _images_and_masks(g: torch.Generator, b: int, s: int, spec: dict, device):
    classes = int(spec["classes"])
    lo, hi = spec["objects"]
    border = int(spec["border"])
    min_side = max(1, int(s * float(spec["min_side"])))
    r = int(hi)
    n_obj = torch.randint(int(lo), int(hi) + 1, (b, 1), generator=g, device=device)
    cls = torch.randint(1, classes, (b, r), generator=g, device=device)
    u = torch.rand((b, r, 4), generator=g, device=device)
    half = s // 2
    y0 = (u[..., 0] * half).long()
    x0 = (u[..., 1] * half).long()
    y1 = y0 + min_side + (u[..., 2] * (s - y0 - min_side).clamp(min=0)).long()
    x1 = x0 + min_side + (u[..., 3] * (s - x0 - min_side).clamp(min=0)).long()
    yy = torch.arange(s, device=device).view(1, s, 1)
    xx = torch.arange(s, device=device).view(1, 1, s)
    mask = torch.zeros((b, s, s), dtype=torch.int64, device=device)
    for i in range(r):
        on = (i < n_obj).view(b, 1, 1)
        a0, a1 = y0[:, i].view(b, 1, 1), y1[:, i].view(b, 1, 1)
        c0, c1 = x0[:, i].view(b, 1, 1), x1[:, i].view(b, 1, 1)
        inside = (yy >= a0) & (yy < a1) & (xx >= c0) & (xx < c1)
        inner = (yy >= a0 + border) & (yy < a1 - border) & (xx >= c0 + border) & (xx < c1 - border)
        mask = torch.where(on & inner, cls[:, i].view(b, 1, 1), mask)
        mask = torch.where(on & inside & ~inner, torch.full_like(mask, MASK_IGNORE), mask)
    noise = torch.randint(0, 256, (b, 3, s, s), generator=g, device=device, dtype=torch.int64)
    colour_id = torch.where(mask == MASK_IGNORE, torch.full_like(mask, classes), mask)
    tint = _palette(classes, device)[colour_id].permute(0, 3, 1, 2)  # (b, 3, s, s)
    images = ((noise + tint) // 2).to(torch.uint8)
    return images, mask.to(torch.uint8).unsqueeze(1)


def class_histogram(masks: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Pixels of each class 0..C-1 per image (255 and other ids not
    counted): (B, C) int64."""
    m = masks.reshape(masks.shape[0], -1).long()
    counts = torch.zeros((m.shape[0], 256), dtype=torch.int64, device=m.device)
    counts.scatter_add_(1, m, torch.ones_like(m))
    return counts[:, :n_classes]


class HostSplit:
    """A split made once into host memory, chunk by chunk: the batches the
    engine takes, and each image's class histogram."""

    def __init__(self, split: Split, n_classes: int) -> None:
        xs, ys, hs = [], [], []
        for c in range(split.n_chunks):
            x, y = split.chunk(c)
            hs.append(class_histogram(y, n_classes).cpu().numpy())
            xs.append(x.cpu().numpy())
            ys.append(y.cpu().numpy())
        self.images: List[np.ndarray] = xs
        self.masks: List[np.ndarray] = ys
        self.histogram = np.concatenate(hs)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return zip(self.images, self.masks)

    def __len__(self) -> int:
        return len(self.images)


class Prefetched:
    """One pass over a split's chunks, each made ahead by a thread on a
    stream of its own, so the engine never waits on the generator."""

    def __init__(self, split: Split, depth: int = 2) -> None:
        self.split = split
        self.depth = depth

    def __iter__(self):
        split = self.split
        if split.device.type != "cuda":
            for c in range(split.n_chunks):
                yield split.host_chunk(c)
            return
        q: "queue.Queue" = queue.Queue(self.depth)
        stop = threading.Event()

        def produce():
            try:
                with torch.cuda.stream(torch.cuda.Stream(split.device)):
                    for c in range(split.n_chunks):
                        if stop.is_set():
                            return
                        q.put(split.host_chunk(c))
                q.put(None)
            except BaseException as exc:  # handed to the consumer, which raises it
                q.put(exc)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while worker.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            worker.join()


class TimedStream:
    """Batches of a host split taken in order, wrapping round, until
    `deadline` (a perf_counter time, set when the window opens) has passed,
    and never fewer than `at_least`: the window's feed. `indices` holds the
    images of each batch handed out."""

    def __init__(self, host: HostSplit, batch: int, at_least: int, clock) -> None:
        self.all_images = np.concatenate(host.images)
        self.all_masks = np.concatenate(host.masks)
        self.batch = batch
        self.deadline = float("inf")
        self.at_least = at_least
        self.clock = clock
        self.indices: List[np.ndarray] = []

    def __iter__(self):
        i = 0
        n = self.all_images.shape[0]
        while i < self.at_least or self.clock() < self.deadline:
            idx = np.arange(i * self.batch, (i + 1) * self.batch) % n
            self.indices.append(idx)
            yield self.all_images[idx], self.all_masks[idx]
            i += 1
