"""CPU rehearsals of the benchmark: both job kinds end to end through the
harness at a tiny configuration, the result line's keys, the frozen
operation and byte counts against hand-worked shapes, the import rules,
and the card-only command refusing to report without a card.

    python -m pytest portbench/ -q
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import work
from portbench.harness import Ctx
from portbench.run import ROOT, execute, load_cell, reader_path, result_line

TINY = {
    "name": "tiny", "patch_size": 4, "width": 32, "depth": 2, "num_heads": 2, "head_dim": 16,
    "mlp_ratio": 4.0, "img_size": 32, "layerscale": True, "layerscale_range": [0.1, 1.0], "swiglu": False, "num_register_tokens": 0,
    "qkv_bias": True, "ln_eps": 1e-6, "pos_interp_offset": 0.1, "pos_interp_antialias": False,
    "input_size": 24, "compute_dtype": "bfloat16", "attention_impl": "flash", "augmentation_epoch": 1,
}
BASE = {
    "n_neighbours": 5, "memory_size": 300, "train_images": 22, "val_images": 10, "classes": 5, "batch": 4,
    "device_norm": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.255]],
    "masks": {"classes": 5, "objects": [1, 2], "border": 1, "min_side": 0.25}, "launches": {},
}
TRAFFIC = {
    "eval": dict(BASE, job="eval", nn_method="scann", nn_params={},
                 sample={"train": 2, "val": 2, "val_batches": 2}),
    "job": dict(BASE, job="job", nn_method="ivf",
                nn_params={"num_leaves": 4, "num_leaves_to_search": 2, "query_block": 16},
                sample={"train": 3, "val": 3}),
}
LIMITS = {"feat": 1.0, "bank": 1.0, "knn": 1.0, "pred": 1.0, "conf": 0.0, "gt_hist": 0.0, "miou": 0.0,
          "launches": 0.0}
SEED = 2**31 + 977  # past 32 signed bits, as the driver's are


def tiny_run(kind, trace=False, config=None, with_control=False, seed=SEED):
    limits = dict(LIMITS, **({"tree": 0.0, "leaf": 1.0, "centroid": 1.0} if kind == "job" else {}))
    ctx = Ctx("tiny." + kind, config or TINY, TRAFFIC[kind], seed, 0.3, trace, torch.device("cpu"),
              time.perf_counter())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = execute(ctx, bench["per_layer"] if trace else bench["end_to_end"], limits, with_control)
    return ctx, out, limits


@pytest.mark.parametrize("kind", ["eval", "job"])
@pytest.mark.parametrize("trace", [False, True])
def test_job_kind_runs_end_to_end_and_prints_the_contract_line(kind, trace):
    ctx, out, limits = tiny_run(kind, trace)
    line = result_line(ctx, out, limits)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == set(limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        rate = "eval_img_per_s" if kind == "eval" else "job_s"
        assert {rate, "setup_s"} <= set(line["metrics"])
        assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    json.dumps(line)


def test_same_seed_same_answers_and_runs_judged_alike():
    _, a, _ = tiny_run("job")
    _, b, _ = tiny_run("job")
    assert a["numbers"] == b["numbers"]
    assert a["res"]["miou"] == b["res"]["miou"]  # every job scores the whole val split


def test_a_watched_engine_is_freed_when_dropped():
    """Jobs release each engine before the next: the recorder's wrappers
    must not keep it alive (a cycle would hold the bank until the
    collector runs, and the card's peak would grow job by job)."""
    import gc
    import weakref

    from hbird_tpu_torch.hbird_eval import HbirdEvaluation

    from portbench.data import HostSplit
    from portbench.harness import engine_kwargs, feature_extractor, split
    from portbench.probe import BenchTimer, Recorder, watch_eval

    ctx = Ctx("tiny.job", TINY, TRAFFIC["job"], SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    rec = Recorder({}, {}, keep_queries=True)
    train = HostSplit(split(ctx, "train"), BASE["classes"])
    engine = HbirdEvaluation(feature_extractor(ctx, rec), list(train.batches()),
                             **engine_kwargs(ctx, BASE["train_images"], BenchTimer()))
    watch_eval(engine, rec, BASE["batch"])
    alive = weakref.ref(engine.NN_algorithm)
    gc.disable()
    try:
        del engine
        assert alive() is None
    finally:
        gc.enable()


def test_card_only_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the refusal is for hosts without one")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "dinov2_vitb14.eval.flat-10m",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_every_cell_finds_its_files_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = load_cell(cell["name"])
        assert (ROOT / "portbench" / "jobs" / f"{spec['traffic']['job']}.py").exists()
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert reader_path(m["name"]).exists(), m["name"]
        assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
        assert spec["per_layer"]


# -- the frozen counts, by hand ------------------------------------------

def test_k1_bound_at_the_flat_cell():
    q, m, d, k = 82_944, 10_232_794, 768, 30
    ops = 2 * q * m * d  # 1.3037e15
    bytes_moved = q * d * 2 + m * d * 2 + q * k * 12
    bound, by = work.bound_ms(q, m, d, k)
    assert by == "operations"
    assert bound == pytest.approx(ops / 989e12 * 1e3)
    assert bound == pytest.approx(1318.2, rel=1e-4)
    assert bytes_moved / 3.35e12 * 1e3 < bound


def test_k2_bound_counts_scanned_and_distinct_rows():
    # 64 tiles of 256 queries, each scanning 32 leaves of 5,000 rows;
    # 20,000 distinct rows in all.
    bound, by = work.ivf_bound_ms(16_384, 64, 64 * 32 * 5_000, 20_000, 1_280, 30)
    ops = 2 * 256 * (64 * 32 * 5_000) * 1_280
    bytes_moved = 20_000 * 1_280 * 2 + 16_384 * 1_280 * 2 + 16_384 * 30 * 12
    assert bound == pytest.approx(max(ops / 989e12, bytes_moved / 3.35e12) * 1e3)
    assert by == "operations"


def test_k3_bound_at_the_job_cell():
    b, h, n, hd = 64, 16, 257, 80
    bound, by = work.flash_bound_ms((b, h, n, hd))
    assert bound == pytest.approx(max(4 * b * h * n * n * hd / 989e12, 4 * b * h * n * hd * 2 / 3.35e12) * 1e3)
    assert by == "bytes"  # 168 MB of q, k, v and o; 21.6 GFLOP
    assert bound == pytest.approx(0.050277, rel=1e-4)


def test_forward_operations_match_hand_count_and_a_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.model import make_weights
    from portbench.reference import vit as ref_vit

    cfg = dict(TINY, attention_impl="xla", compute_dtype="float32")
    t, d, hid, n = 37, 32, 128, 36  # 1 + 6·6 tokens at input 24
    hand = 2 * n * 48 * d + 2 * (2 * t * d * 3 * d + 2 * t * d * d + 4 * t * d * hid + 4 * t * t * d)
    assert work.vit_flops(cfg, 24) == hand
    w = make_weights(cfg, 1, "cpu")
    x = torch.randint(0, 256, (2, 3, 24, 24), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        ref_vit.forward(w, cfg, x, [0.5] * 3, [0.25] * 3)
    assert fc.get_total_flops() == work.vit_flops(cfg, 24, images=2)
    mae = json.loads((ROOT / "portbench" / "configs" / "mae_vith14.json").read_text())
    assert work.vit_tokens(mae, 224) == 257
    assert work.vit_flops(mae, 224) == pytest.approx(3.3459e11, rel=1e-4)


# -- imports ---------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "hbird_tpu", "hbird", "flax"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import portbench.run, portbench.calibrate, portbench.check, portbench.jobs.eval, "
            "portbench.jobs.job\nimport pathlib\nfrom portbench.run import load_module\n"
            "for p in sorted(pathlib.Path('portbench/metrics').glob('*.py')): load_module(p)\n"
            "import hbird_tpu_torch.hbird_eval")
    names = _top_level_after(code)
    assert not names & FORBIDDEN
    assert "hbird_tpu_torch" in names  # whole names: the port is not the JAX package


def test_reference_imports_nothing_of_the_program():
    names = _top_level_after("import portbench.reference.vit, portbench.reference.hbird")
    assert not names & (FORBIDDEN | {"hbird_tpu_torch"})


def test_sources_name_no_forbidden_module():
    import ast

    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
                if "reference" in path.parts:
                    assert name.split(".")[0] != "hbird_tpu_torch", (path, name)
