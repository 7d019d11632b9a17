"""What the benchmark hands the engine, and how it watches the engine's
outputs: its own phase timer (each phase also a profiler span), a thin
feature extractor that opens the forward's span, and a recorder that keeps
copies of the outputs the reference will judge.

The recorder copies only the sampled images' rows (and, for a sampled eval
batch, its whole prediction and, on a tree, its queries), so what it adds
to the timed path is a few small device copies.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from hbird_tpu_torch.utils.profiling import PhaseTimer

SPAN = "portbench."


class BenchTimer(PhaseTimer):
    """The engine's PhaseTimer, each phase also a `portbench.phase.<name>`
    profiler span."""

    @contextlib.contextmanager
    def phase(self, name: str):
        with record_function(f"{SPAN}phase.{name}"), super().phase(name) as t:
            yield t


class Recorder:
    """Copies of sampled outputs, by memory-step call and eval batch.

    train: {call: [offsets]} memory-step forwards whose images are sampled;
    val: {batch: [offsets]} eval batches whose images are sampled;
    keep_queries: also keep each sampled eval batch's whole query matrix.
    """

    def __init__(self, train: Dict[int, List[int]], val: Dict[int, List[int]],
                 keep_queries: bool = False) -> None:
        self.train_want = train
        self.val_want = val
        self.keep_queries = keep_queries
        self.reset()

    def reset(self) -> None:
        self.train_calls = 0
        self.eval_batches = 0
        self.in_eval = False
        self.train_feats: Dict[Tuple[int, int], torch.Tensor] = {}
        self.val: Dict[Tuple[int, int], dict] = {}
        self.batches: Dict[int, dict] = {}

    def on_forward(self, feats: torch.Tensor) -> None:
        if self.in_eval:
            return
        for o in self.train_want.get(self.train_calls, ()):
            self.train_feats[(self.train_calls, o)] = feats[o].detach().clone()
        self.train_calls += 1

    def on_search(self, q: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor) -> None:
        b = self.eval_batches
        if b not in self.val_want:
            return
        n = q.shape[0] // self._batch
        offsets = self.val_want[b]
        for o in offsets:
            rows = slice(o * n, (o + 1) * n)
            self.val[(b, o)] = {"q": q[rows].detach().clone(), "vals": vals[rows].clone(),
                                "ids": idx[rows].clone()}
        if self.keep_queries:
            self.batches.setdefault(b, {})["q"] = q.detach().clone()

    def on_eval_step(self, out) -> None:
        conf, pred = out[0], out[1]
        b = self.eval_batches
        if self.val_want.get(b):
            rec = self.batches.setdefault(b, {})
            rec["conf"], rec["pred"] = conf.clone(), pred.clone()
            for o in self.val_want[b]:
                self.val[(b, o)]["pred"] = pred[o].clone()
        self.eval_batches += 1


class Extractor:
    """The port's FeatureExtractor behind the benchmark's forward span."""

    def __init__(self, inner, recorder: Recorder) -> None:
        self.inner = inner
        self.recorder = recorder
        self.eval_spatial_resolution = inner.eval_spatial_resolution
        self.d_model = inner.d_model

    def forward_features(self, imgs):
        with record_function(f"{SPAN}forward"):
            out = self.inner.forward_features(imgs)
        self.recorder.on_forward(out[0])
        return out


def watch_eval(engine, recorder: Recorder, batch: int) -> None:
    """Route the engine's eval step and search through the recorder (the
    engine's own methods still do the work). The wrappers hold the engine
    and its backend weakly, so dropping the engine frees it at once."""
    recorder._batch = batch
    nn = engine.NN_algorithm
    step, search = type(engine)._eval_step, type(nn).search_with_labels_pure
    engine_ref, nn_ref = weakref.ref(engine), weakref.ref(nn)

    def eval_step(*args, **kwargs):
        recorder.in_eval = True
        out = step(engine_ref(), *args, **kwargs)
        recorder.on_eval_step(out)
        return out

    def search_with_labels_pure(state, q, k=None, **kwargs):
        vals, idx, labels = search(nn_ref(), state, q, k, **kwargs)
        recorder.on_search(q, vals, idx)
        return vals, idx, labels

    engine._eval_step = eval_step
    nn.search_with_labels_pure = search_with_labels_pure


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters, by kernel and form."""
    from hbird_tpu_torch.ops.flash_cuda import flash_attention
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    out = {}
    for name, fn in (("knn_topk", knn_topk), ("ivf_topk", ivf_topk), ("flash_attention", flash_attention)):
        for form, n in fn.forms.items():
            out[f"{name}.{form}"] = int(n)
    return out
