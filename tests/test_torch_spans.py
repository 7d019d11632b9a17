"""The port's program spans (utils/profiling.py): off without a profiler,
on the profiler's clock under one, and the engine's and the tree build's
span trees on the CPU."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hbird_tpu_torch
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.nn import NearestNeighborSearchApprox
from hbird_tpu_torch.ops import ivf
from hbird_tpu_torch.parallel import make_mesh
from hbird_tpu_torch.utils import profiling
from hbird_tpu_torch.utils.profiling import PhaseTimer, clear_spans, recorded_spans, span

PATCH = 4
STAGES = {"kmeans", "refine", "assign", "layout", "scatter"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_store():
    clear_spans()
    yield
    clear_spans()


def test_without_a_profiler_a_span_records_nothing_and_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    timer = PhaseTimer()
    with span("hbird.test.outer", engine=0, batch=0):
        with span("hbird.test.inner"), timer.phase("evaluate"):
            pass
    assert recorded_spans() == []
    assert span("hbird.a") is span("hbird.b", batch=1)  # one shared no-op: nothing made per span
    assert timer.phases["evaluate"]["seconds"] > 0


def test_spans_nest_and_lie_on_the_profilers_clock():
    # The process's and each session's first range pay the profiler's
    # one-time set-up (~0.3 ms here), which is not the clock's doing.
    with _cpu_profile(), span("hbird.test.warm"):
        pass
    clear_spans()
    with _cpu_profile() as prof:
        with span("hbird.test.warm"):
            pass
        with span("hbird.test.outer", engine=3, batch=1):
            for i in range(2):
                with span("hbird.test.inner", engine=3, batch=i):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    spans = [s for s in recorded_spans() if s.name != "hbird.test.warm"]
    by_id = {s.id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    assert names == {"hbird.test.outer": 1, "hbird.test.inner": 2}
    outer = next(s for s in spans if s.name == "hbird.test.outer")
    inner = [s for s in spans if s.name == "hbird.test.inner"]
    assert outer.parent is None and outer.attrs == {"engine": 3, "batch": 1}
    assert [s.attrs for s in inner] == [{"engine": 3, "batch": 0}, {"engine": 3, "batch": 1}]
    for s in inner:
        assert by_id[s.parent] is outer and outer.start_ns <= s.start_ns < s.end_ns <= outer.end_ns
    # the profiler's own range of each span: same name, same clock, within 200 us at both ends
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {k: len(v) for k, v in events.items()} == dict(names)
    for name, ranges in events.items():
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        for (s0, s1), (e0, e1) in zip(mine, sorted(ranges)):
            assert abs(s0 - e0) <= 200_000 and abs(s1 - e1) <= 200_000, (name, s0 - e0, s1 - e1)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_spans") / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3, class_pool=[1, 2, 3])
    return root


def _oracle(model, imgs):
    b, c, h, w = imgs.shape
    s = h // PATCH
    x = imgs.reshape(b, c, s, PATCH, s, PATCH).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, s * s, c), None


STEP_CHILDREN = {
    "hbird.memory.step": ["hbird.forward", "hbird.memory.labels", "hbird.memory.sample", "hbird.memory.write"],
    "hbird.eval.step": ["hbird.forward", "hbird.search", "hbird.eval.label_transfer", "hbird.eval.confusion"],
    "hbird.memory.feed": ["hbird.memory.put"],
    "hbird.eval.feed": ["hbird.eval.put"],
    "hbird.eval.consume": ["hbird.eval.consume.wait"],
}


@pytest.mark.parametrize("nn_method, nn_params", [
    ("scann", {}),
    ("ivf", {"num_leaves": 4, "num_leaves_to_search": 2}),
])
def test_engine_records_its_span_tree(voc, nn_method, nn_params):
    """12 train and 6 val images in batches of 4: 3 memory steps, 2 eval
    steps, each with its pieces; one feed more than steps in each phase
    (the last finds the loader exhausted); every per-batch span carries
    the engine's serial and its batch."""
    with _cpu_profile():
        hbird_tpu_torch.hbird_evaluation(
            None, 3, PATCH, "voc", voc, batch_size=4, input_size=32, n_neighbours=5, ftr_extr_fn=_oracle,
            num_workers=0, device="cpu", nn_method=nn_method, nn_params=nn_params,
        )
    spans = recorded_spans()
    by_id = {s.id: s for s in spans}
    parent = {s.id: by_id[s.parent].name if s.parent else None for s in spans}
    names = collections.Counter(s.name for s in spans)
    phases = {f"hbird.phase.{p}" for p in ("memory_build", "index_build", "evaluate", "metric_compute")}
    index = {f"hbird.index.{k}" for k in STAGES} if nn_method == "ivf" else set()
    assert set(names) == phases | index | set(STEP_CHILDREN) | {c for cs in STEP_CHILDREN.values() for c in cs}
    assert names["hbird.memory.step"] == 3 and names["hbird.memory.feed"] == 4
    assert names["hbird.eval.step"] == names["hbird.eval.consume"] == 2 and names["hbird.eval.feed"] == 3
    assert all(names[p] == 1 for p in phases | index)
    for s in spans:
        if s.name in phases:
            assert s.parent is None
        elif s.name in index:
            assert parent[s.id] == "hbird.phase.index_build"
        elif s.name in STEP_CHILDREN:
            phase = "hbird.phase.memory_build" if s.name.startswith("hbird.memory.") else "hbird.phase.evaluate"
            assert parent[s.id] == phase, s
            kids = sorted((c for c in spans if c.parent == s.id), key=lambda c: c.start_ns)
            last_feed = s.name.endswith(".feed") and s.attrs["batch"] == names[s.name] - 1
            assert [c.name for c in kids] == ([] if last_feed else STEP_CHILDREN[s.name]), s
            assert all(c.attrs == s.attrs for c in kids)
    per_batch = [s for s in spans if s.name not in phases | index]
    assert len({s.attrs["engine"] for s in per_batch}) == 1
    for name, n in (("hbird.memory.step", 3), ("hbird.memory.feed", 4), ("hbird.eval.step", 2),
                    ("hbird.eval.consume", 2), ("hbird.eval.feed", 3)):
        assert sorted(s.attrs["batch"] for s in spans if s.name == name) == list(range(n))


def _bank(m=1200, d=16, seed=5):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _stream(x, step):
    def stream():
        for i in range(0, x.shape[0], step):
            yield torch.from_numpy(x[i : i + step]), None
    return stream


@pytest.mark.parametrize("build", ["in_memory", "streamed", "sharded_host", "sharded_device"])
def test_tree_build_records_one_span_per_timed_stage(build):
    x = _bank()
    common = dict(n_neighbors=5, use_tree=True, num_leaves=8, num_leaves_to_search=4, device="cpu")
    with _cpu_profile():
        if build == "streamed":
            seconds = ivf.build_tree_streamed(_stream(x, 500), x.shape[0], 8, seed=0)["build_seconds"]
        elif build == "in_memory":
            seconds = NearestNeighborSearchApprox(x, **common).build_seconds
        else:
            mesh = make_mesh((2,), ("bank",), ["cpu"] * 2)
            seconds = NearestNeighborSearchApprox(
                x, mesh=mesh, tree_build_layout=build.split("_")[1], **common).build_seconds
    assert set(seconds) == STAGES
    stages = collections.Counter(s.name for s in recorded_spans() if s.name.startswith("hbird.index."))
    assert stages == {f"hbird.index.{k}": 1 for k in seconds}
