"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The script's phases run here with the plain versions (a CPU tensor never
launches K1, K2 or K3), so each wrapper's plain path is wrapped to count as
a launch; this checks the script's control flow, shapes and checks, not the
kernels.
Without a GPU, `main()` must exit non-zero and print no result.
"""

import collections
import importlib.util
import json
import pathlib

import pytest
import torch

from hbird_tpu_torch.ops import flash_cuda, ivf_cuda, knn_cuda
from hbird_tpu_torch.ops import flash as flash_mod
from hbird_tpu_torch.ops import ivf as ivf_mod
from hbird_tpu_torch.ops import knn as knn_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    monkeypatch.setattr(mod, "CASE_Q", 48)
    monkeypatch.setattr(mod, "CASE_M", 3001)
    monkeypatch.setattr(mod, "CASE_VALID", 2990)
    monkeypatch.setattr(mod, "DEPTH", 64)
    monkeypatch.setattr(mod, "FIXTURE", {"n_train": 8, "n_val": 4, "size": (80, 60)})
    monkeypatch.setattr(mod, "PRESET", "dino_vits16")
    monkeypatch.setattr(mod, "INPUT", 64)
    monkeypatch.setattr(mod, "BATCH", 4)
    monkeypatch.setattr(mod, "MEMORY_SIZE", 64)
    monkeypatch.setattr(mod, "BIG_M", 3000)
    monkeypatch.setattr(mod, "IVF_ROWS", 3000)
    monkeypatch.setattr(mod, "IVF_CLUSTERS", 8)
    monkeypatch.setattr(mod, "IVF_Q", 200)
    monkeypatch.setattr(mod, "FLASH_SHAPES", {"one token": (2, 2, 1, 64), "ragged": (1, 2, 65, 32),
                                              "wide": (1, 1, 70, 80)})
    monkeypatch.setattr(mod, "FLASH_MAIN", (2, 2, 40, 32))
    monkeypatch.setattr(mod, "FLASH_LONG", (1, 2, 130, 64))
    monkeypatch.setattr(mod, "FLASH_NARROW", (2, 2, 20, 32))
    monkeypatch.setattr(mod, "FLASH_WIDE", (2, 2, 20, 80))

    def counted(*args, **kwargs):
        knn_cuda.knn_topk.launches += 1
        l2 = kwargs.get("distance") in knn_mod.L2_DISTANCES
        knn_cuda.knn_topk.forms[knn_cuda.form_name(args[0], args[1], l2, kwargs.get("row_scale"))] += 1
        return knn_mod.exact_knn(*args, **kwargs)

    def counted_ivf(*args, **kwargs):
        ivf_cuda.ivf_topk.launches += 1
        ivf_cuda.ivf_topk.forms[knn_cuda.form_name(args[0], args[1], False, kwargs.get("row_scale"))] += 1
        return ivf_mod.ivf_search_plain(*args, **kwargs)

    monkeypatch.setattr(knn_cuda, "exact_knn", counted)
    monkeypatch.setattr(knn_cuda.knn_topk, "launches", 0)
    monkeypatch.setattr(knn_cuda.knn_topk, "forms", collections.Counter())
    monkeypatch.setattr(ivf_cuda.ivf_topk, "forms", collections.Counter())
    def counted_flash(*args, **kwargs):
        flash_cuda.flash_attention.launches += 1
        flash_cuda.flash_attention.forms["bf16" if args[0].dtype == torch.bfloat16 else "f32"] += 1
        return flash_mod.flash_attention_plain(*args, **kwargs)

    monkeypatch.setattr(ivf_cuda, "ivf_search_plain", counted_ivf)
    monkeypatch.setattr(ivf_cuda.ivf_topk, "launches", 0)
    monkeypatch.setattr(flash_cuda, "flash_attention_plain", counted_flash)
    monkeypatch.setattr(flash_cuda.flash_attention, "launches", 0)
    monkeypatch.setattr(flash_cuda.flash_attention, "forms", collections.Counter())
    return mod


def test_phases_rehearse_on_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    assert smoke.kernel_cases(gen) <= 1e-5
    assert smoke.ivf_cases(gen) == 0.0
    assert smoke.quantized_kernel_cases(gen) == 0.0
    assert smoke.quantized_ivf_cases(gen) == 0.0
    runs, launches, err, tree, q, bank, main_tree = smoke.main_path(gen_seed=0)
    # scann x 2, int8_rows, int8+rerank, l2 on K1; ivf x 2, scann-literal on K2
    assert launches == {"knn_topk": 5, "ivf_topk": 3} and err == {"K1": 0.0, "K2": 0.0}
    assert set(runs) == {"scann unbounded", "scann bounded 64", "ivf unbounded", "ivf bounded 64",
                         *smoke.QUANT_RUNS}
    for label, run in runs.items():
        assert 0.0 <= run["miou"] <= 1.0
        assert run["phases"]["memory_build"]["items"] == 8
        assert run["phases"]["evaluate"]["items"] == 4
        if label in smoke.QUANT_RUNS:
            kernel, form = smoke.QUANT_RUNS[label][3]
            assert run["forms"][kernel] == {form: 1}
            assert 0.0 < run["recall_at_30_vs_k1_bf16"] <= run["score_recall_at_30_vs_k1_bf16"] <= 1.0
        else:
            kernel = "ivf_topk" if label.startswith("ivf") else "knn_topk"
            assert run["forms"][kernel] == {"dot": 1}
        assert run["launches"] == {"knn_topk": 0, "ivf_topk": 0, kernel: 1}
    assert q.shape == (4 * 16, 384) and bank.shape == (8 * 16, 384)
    assert q.dtype == bank.dtype == torch.bfloat16
    assert (tree["n_leaves"], tree["cap"]) == (128, 256) and set(tree["recall_at_30_vs_k1"]) == {"tile", "query"}
    assert all(0.0 < r <= tree["score_recall_at_30_vs_k1"][m] <= 1.0
               for m, r in tree["recall_at_30_vs_k1"].items())
    assert set(tree["build_s"]) == {"kmeans", "refine", "assign", "layout", "scatter"}
    k1_rows, k2_rows, err_timing = smoke.timing(q, bank, main_tree, gen)
    sizes = ("main", "bank_3000")
    assert set(k1_rows) == {*sizes, *(f"{f} {s}" for f in ("int8", "int8_rows", "asym_rows", "asym", "l2", "f32")
                                      for s in sizes),
                            *(f"{f} k=120 {s}" for f in ("int8", "int8_rows") for s in sizes)}
    assert k1_rows["int8 k=120 main"]["k"] == 120 and k1_rows["int8_rows main"]["k"] == 30
    assert set(k2_rows) == {*sizes, *(f"{f} {s}" for f in ("int8_rows", "asym_rows", "int8", "asym", "f32")
                                      for s in sizes)}
    assert k1_rows["int8 main"]["bound_by"] == k1_rows["main"]["bound_by"]
    assert err_timing == {"K1": 0.0, "K2": 0.0}
    assert k2_rows["bank_3000"]["cap"] == 256 and k2_rows["main"]["block_q"] == 256
    assert json.dumps([k1_rows, k2_rows])
    select = smoke.k1_select_rows(q, bank)
    assert len(select) == 4 and all(0.0 < r["rows_above_kth"] <= 1.0 for r in select.values())


def test_select_load_counts_the_pairs_a_set_receives(smoke):
    """Scores rising along the bank reach the set at every tile, falling
    ones only at the first; ties with an earlier row do not count; a set
    that walks half the tiles fills again."""
    rising = torch.arange(512.0).repeat(3, 1)
    assert smoke.select_load(rising, 4, [list(range(4))]) == (1.0, 128.0)
    assert smoke.select_load(rising.flip(1), 4, [list(range(4))]) == (0.25, 32.0)
    flat = torch.zeros(3, 512)
    assert smoke.select_load(flat, 4, [list(range(4))]) == (0.25, 32.0)
    assert smoke.select_load(rising.flip(1), 4, [[0, 2], [1, 3]]) == (0.5, 64.0)


def test_flash_phases_rehearse_on_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    assert smoke.flash_cases(gen) == 0.0
    runs, launches, token_err, err = smoke.flash_path(gen_seed=0)
    # dino_vits16: 12 blocks x (2 train + 1 val batches of 4), in bf16 and in f32
    for dt in ("bf16", "f32"):
        assert launches[f"{dt} flash"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": 36}
        assert launches[f"{dt} xla"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": 0}
        assert runs[f"scann unbounded, {dt} ViT, attention_impl='flash'"]["forms"]["flash_attention"] == {dt: 36}
    assert err == 0.0 and len(runs) == 4
    for run in runs.values():
        assert 0.0 <= run["miou"] <= 1.0 and run["phases"]["evaluate"]["items"] == 4
    assert token_err["float32"]["max"] <= 1e-4 and token_err["bfloat16"]["mean"] <= 1e-2
    rows, err = smoke.flash_timing(gen)
    assert err == 0.0 and set(rows) == {"main", "f32", "long", "hd32", "hd80"}
    assert rows["main"]["bound_by"] == "bytes" and rows["main"]["dtype"] == "bfloat16"
    assert rows["long"]["shape"] == [1, 2, 130, 64] and rows["long"]["dtype"] == "bfloat16"
    assert rows["hd80"]["shape"] == [2, 2, 20, 80] and rows["hd32"]["dtype"] == "bfloat16"
    assert rows["f32"]["fma_bound_ms"] > 0 and "fma_bound_ms" not in rows["main"]
    forward = smoke.forward_timing(0, gen)
    assert set(forward) == {"xla float32", "xla bfloat16", "flash float32", "flash bfloat16"}
    assert json.dumps([rows, forward])


def test_flash_bound_of_the_main_shape(smoke):
    """4·B·H·N²·hd = 92.25 GFLOP: 0.093 ms at 989 TFLOP/s, 1.38 ms at 67
    TFLOP/s (f32 FMAs); f32 at f32 accuracy on the tensor cores is 3 TF32
    passes, 276.8 GFLOP at 495 TFLOP/s: 0.559 ms. The 134.7 MB of bf16 q,
    k, v and o take 0.040 ms."""
    shape = (16, 12, 1370, 64)
    ms, by = smoke.flash_bound_ms(shape, 2, smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(4 * 16 * 12 * 1370**2 * 64 / 989e9)
    assert ms == pytest.approx(0.0933, abs=1e-4)
    assert smoke.k3_bound(shape, torch.bfloat16) == (ms, by)
    ms, by = smoke.flash_bound_ms(shape, 4, smoke.PEAK_F32_FLOPS)
    assert by == "operations" and ms == pytest.approx(1.377, abs=1e-3)
    ms, by = smoke.k3_bound(shape, torch.float32)
    assert by == "operations" and ms == pytest.approx(0.5591, abs=1e-4)
    ms, by = smoke.flash_bound_ms((16, 12, 8, 64), 2, smoke.PEAK_BF16_FLOPS)
    assert by == "bytes" and ms == pytest.approx(4 * 16 * 12 * 8 * 64 * 2 / 3.35e9)


def test_check_flash_holds_the_stated_tolerance(smoke):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 50, 32, generator=gen) for _ in range(3))
    ref = flash_mod.flash_attention_plain(q, k, v, 0.2)
    assert smoke.check_flash("f32 itself", ref, ref) == 0.0
    smoke.check_flash("f32 within 1e-5", ref + 5e-6, ref)
    with pytest.raises(RuntimeError, match="max"):
        smoke.check_flash("f32 off by 1e-4", ref + 1e-4, ref)
    ref16 = ref.bfloat16()
    row = ref16.float().abs().amax(-1, keepdim=True)
    smoke.check_flash("bf16 one ulp up", (ref16.float() * (1 + 2.0**-7)).bfloat16(), ref16)
    with pytest.raises(RuntimeError, match="ulps"):
        smoke.check_flash("bf16 eight ulps", (ref16.float() + 8 * 2.0**-8 * row).bfloat16(), ref16)
    with pytest.raises(RuntimeError, match="mean"):  # 3 row-scale ulps everywhere: a bias
        smoke.check_flash("bf16 biased", (ref16.float() + 3 * 2.0**-8 * row).bfloat16(), ref16)
    with pytest.raises(RuntimeError, match="dtype|float"):
        smoke.check_flash("dtype", ref16, ref)


def test_entry_point_phase_rehearses_on_cpu(smoke, monkeypatch):
    """Phase 8 at the rehearsal's sizes: the CLI runs launch their kernel
    once per eval batch, the reloads build nothing and repeat the mIoU, the
    streamed builds equal the in-memory ones."""
    monkeypatch.setattr(smoke, "STREAM_WINDOW", 1000)
    monkeypatch.setattr(smoke, "STREAM_CLUSTERS", 16)
    runs, _, _, _, q, _, _ = smoke.main_path(gen_seed=0)
    cli_runs, launches, info = smoke.entry_point_path(0, q, runs["scann unbounded"]["miou"])
    assert launches == {"knn_topk": 2, "ivf_topk": 3}
    assert len(cli_runs) == 5 and all(r["wall_s"] > 0 for r in cli_runs.values())
    assert cli_runs["cli scann, save .bankdir"]["miou"] == runs["scann unbounded"]["miou"]
    assert cli_runs["cli scann, save .bankdir"]["phases"]["memory_build"]["items"] == 8
    for label in ("cli scann, --load-memory", "cli ivf, --load-memory (streamed build)",
                  "cli ivf, --load-memory .treedir"):
        assert "items" not in cli_runs[label]["phases"]["memory_build"]
        assert cli_runs[label]["phases"]["evaluate"]["items"] == 4
    assert 0.0 < info["streamed_recall_at_30_vs_k1"] <= info["streamed_score_recall_at_30_vs_k1"] <= 1.0
    assert set(info["streamed_split_s"]) == {"kmeans", "refine", "assign", "layout", "scatter"}
    scale = info["streamed_at_scale"]
    assert scale["rows"] == 3000 and scale["centroids_equal"] and scale["slots_equal_share"] == 1.0
    assert scale["streamed_peak_bytes"] is None  # no device memory counters on the CPU
    memory = info["bank_build_memory"]
    assert set(memory) == {f"{e} {b}" for e in ("projection", "projection x8")
                           for b in ("concatenated", "in_place")}
    assert memory["projection in_place"]["bank_bytes"] == 8 * 16 * (384 + 21) * 4
    assert memory["projection x8 concatenated"]["bank_bytes"] == 8 * 8 * 16 * (384 + 21) * 4
    assert json.dumps(info)


def test_mesh_phase_rehearses_on_cpu(smoke):
    """Phase 9 at the rehearsal's sizes: the tar feed repeats the folder's
    mIoU, K1 on 4 stacked shards passes its checks with 4 (gather) and 16
    (ring) launches a call, the command line on the mesh repeats the
    unsharded mIoU and its reload builds nothing, the process group of one
    passes the confusion matrix through."""
    runs, _, _, _, q, bank, _ = smoke.main_path(gen_seed=0)
    feed_runs, feed = smoke.native_feed(0, runs["scann unbounded"])
    (run,) = feed_runs.values()
    assert run["miou"] == runs["scann unbounded"]["miou"] and run["launches"]["knn_topk"] == 1
    assert feed["members"] > 0 and set(feed["memory_build_img_per_s"]) == {"tar", "folder"}
    rows, err = smoke.mesh_k1_cases(q, bank, torch.Generator().manual_seed(1), [torch.device("cpu")] * 4)
    assert set(rows) == {f"{b} {f}" for b in ("main", "bank_3000") for f in ("dot", "int8+reorder", "int8_rows")}
    assert all(r["gather_launches_per_call"] == 4 and r["ring_launches_per_call"] == 16 for r in rows.values())
    assert err < 1e-3 and all(0.0 < r["merge_share_of_gather"] for r in rows.values())
    mesh_runs = smoke.mesh_cli(0, runs["scann unbounded"]["miou"], [torch.device("cpu")] * 4)
    assert len(mesh_runs) == 2
    for r in mesh_runs.values():
        assert r["launches"]["knn_topk"] == 4 and abs(r["miou"] - runs["scann unbounded"]["miou"]) <= 1e-4
    assert smoke.nccl_one_process()["backend"] == "gloo"


def test_mesh_checks_reject_a_wrong_merge(smoke, monkeypatch):
    """A sharded search that returns other neighbours fails phase 9.2."""
    from hbird_tpu_torch.parallel import sharded_knn

    real = sharded_knn.merge_topk

    def shifted(vals, idx, k, **kw):
        v, i = real(vals, idx, k, **kw)
        return v, torch.roll(i, 1, dims=1)

    monkeypatch.setattr(sharded_knn, "merge_topk", shifted)
    monkeypatch.setattr(smoke, "BIG_M", 500)
    gen = torch.Generator().manual_seed(0)
    bank = torch.nn.functional.normalize(torch.randn(400, 64, generator=gen), dim=1).to(torch.bfloat16)
    q = torch.randn(50, 64, generator=gen).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="chip_smoke"):
        smoke.mesh_k1_cases(q, bank, gen, [torch.device("cpu")] * 4)


@pytest.mark.parametrize("part", ["centroids", "slots"])
def test_streamed_build_at_scale_fails_when_builds_differ(smoke, monkeypatch, part):
    monkeypatch.setattr(smoke, "STREAM_WINDOW", 1000)
    monkeypatch.setattr(smoke, "STREAM_CLUSTERS", 16)
    build = ivf_mod.build_tree_streamed

    def off(*args, **kwargs):
        parts = build(*args, **kwargs)
        parts[part] = parts[part].flip(0)
        return parts

    monkeypatch.setattr(ivf_mod, "build_tree_streamed", off)
    with pytest.raises(RuntimeError, match="differs from the in-memory build"):
        smoke.streamed_build_at_scale()


def test_main_path_mious_repeat(smoke):
    first = smoke.main_path(gen_seed=0)[0]
    second = smoke.main_path(gen_seed=0)[0]
    assert [r["miou"] for r in first.values()] == [r["miou"] for r in second.values()]


def test_check_against_plain_rejects_wrong_results(smoke):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(16, 64, generator=gen)
    b = torch.nn.functional.normalize(torch.randn(500, 64, generator=gen), dim=1)
    vals, idx = knn_mod.exact_knn(q, b, 10)
    smoke.check_against_plain("right", q, b, 10, 500, (vals, idx))
    wrong_idx = idx.clone()
    wrong_idx[3, 0] = (idx[3, 0] + 1) % 500
    with pytest.raises(RuntimeError, match="do not belong"):
        smoke.check_against_plain("wrong index", q, b, 10, 500, (vals, wrong_idx))
    with pytest.raises(RuntimeError, match="values differ"):
        smoke.check_against_plain("wrong value", q, b, 10, 500, (vals + 1e-2, idx))


def test_bound_of_the_main_shape(smoke):
    ms, by = smoke.bound_ms(21904, 87616, 768, 30, 2, smoke.PEAK_BF16_FLOPS)
    assert by == "operations"
    assert ms == pytest.approx(2 * 21904 * 87616 * 768 / 989e12 * 1e3)


def test_k2_bound_counts_the_probed_valid_rows(smoke):
    """86 tiles of 256 queries, 32 probed slabs each, full slabs of 2,816
    rows: 7.75M rows scanned are 3.05 TFLOP, 3.08 ms at 989 TFLOP/s, above
    the 0.67 ms of reading the 512 slabs once; half-full ones half."""
    lids = torch.arange(86 * 32).reshape(86, 32) % 512
    full = torch.full((512,), 2816, dtype=torch.int32)
    ms, by = smoke.ivf_bound_ms(86 * 256, lids, full, 768, 30, 2, smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(2 * 256 * 86 * 32 * 2816 * 768 / 989e9)
    half, _ = smoke.ivf_bound_ms(86 * 256, lids, full // 2, 768, 30, 2, smoke.PEAK_BF16_FLOPS)
    assert half < 0.51 * ms


def test_k2_bound_reads_each_probed_slab_once(smoke):
    """A slab that many tiles probe is read once: one 64-query tile on 32
    full slabs is set by their bytes, 86 tiles on the same 32 by flops."""
    full = torch.full((512,), 2816, dtype=torch.int32)
    one = torch.arange(32).reshape(1, 32)
    ms, by = smoke.ivf_bound_ms(64, one, full, 768, 30, 2, smoke.PEAK_BF16_FLOPS)
    read = (32 * 2816 + 64) * 768 * 2 + 64 * 30 * 12 + 4 * (32 + 512)
    assert by == "bytes" and ms == pytest.approx(read / 3.35e9)
    many, by = smoke.ivf_bound_ms(86 * 64, one.repeat(86, 1), full, 768, 30, 2, smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and many == pytest.approx(2 * 64 * 86 * 32 * 2816 * 768 / 989e9)


def test_check_ivf_against_plain_rejects_wrong_results(smoke):
    gen = torch.Generator().manual_seed(2)
    cap = 64
    bank = torch.nn.functional.normalize(torch.randn(4 * cap, 32, generator=gen), dim=1)
    q = torch.randn(128, 32, generator=gen)
    lids = torch.tensor([[0, 2], [3, 1]], dtype=torch.int32)
    lv = torch.tensor([60, 64, 0, 20], dtype=torch.int32)
    vals, idx = ivf_mod.ivf_search_plain(q, bank, lids, lv, 10, cap=cap)
    smoke.check_ivf_against_plain("right", q, bank, lids, lv, 10, cap, 64, (vals, idx))
    outside = idx.clone()
    outside[0, 0] = 1 * cap  # slab 1 is not probed by tile 0
    with pytest.raises(RuntimeError, match="outside the probed"):
        smoke.check_ivf_against_plain("unprobed slab", q, bank, lids, lv, 10, cap, 64, (vals, outside))
    masked = idx.clone()
    masked[70, 0] = 3 * cap + 30  # past leaf_valid of slab 3
    with pytest.raises(RuntimeError, match="outside the probed"):
        smoke.check_ivf_against_plain("masked row", q, bank, lids, lv, 10, cap, 64, (vals, masked))
    with pytest.raises(RuntimeError, match="values differ"):
        smoke.check_ivf_against_plain("wrong value", q, bank, lids, lv, 10, cap, 64, (vals + 1e-2, idx))


def test_score_recall_counts_tied_rows(smoke):
    """A returned row tied with the k-th exact score counts as found; one
    below it does not."""
    bank = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.5, 0.0], [0.0, 1.0]])
    q = torch.tensor([[1.0, 0.0]])
    vals, idx = knn_mod.exact_knn(q, bank, 2)
    assert idx.tolist() == [[0, 1]]
    assert smoke.score_recall(torch.tensor([[1, 0]]), q, bank, vals[:, -1]) == 1.0
    assert smoke.score_recall(torch.tensor([[0, 2]]), q, bank, vals[:, -1]) == 0.5
    assert smoke.score_recall(torch.tensor([[3, 2]]), q, bank, vals[:, -1]) == 0.0


def test_main_without_cuda_prints_no_result(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    assert smoke.main() != 0
    assert smoke.main(["--pairs", str(ROOT)]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and '"k1"' not in out


def test_pairs_rehearse_on_cpu(smoke, monkeypatch):
    """The --pairs timing: K3 bf16 and f32 at the main and long shapes, K1
    bf16 dot and l2, int8 and int8_rows at each k of PAIR_KS on both banks,
    and K2 bf16 and asym_rows on a tree of each bank, each with its bound
    and library time, as one JSON-ready result."""
    monkeypatch.setattr(smoke, "PAIR_Q", 40)
    monkeypatch.setattr(smoke, "PAIR_M", 500)
    out = smoke.pairs("here")
    assert out["tree"] == "here" and pathlib.Path(out["package"]) == ROOT / "hbird_tpu_torch"
    assert set(out["k3"]) == {f"{dt} {s}" for dt in ("bf16", "f32")
                              for s in ("(2, 2, 40, 32)", "(1, 2, 130, 64)")}
    assert set(out["k1"]) == {*(f"bf16 {f} Q=40 M={m} k={k}" for f in ("dot", "l2") for m in (500, 3000)
                                for k in smoke.PAIR_KS),
                              *(f"{f} Q=40 M={m} k={k}" for f in ("int8", "int8_rows") for m in (500, 3000)
                                for k in smoke.PAIR_KS)}
    assert len(out["k2"]) == 4
    assert sorted(label.split()[0] for label in out["k2"]) == ["asym_rows", "asym_rows", "bf16", "bf16"]
    assert out["k3"]["f32 (2, 2, 40, 32)"]["bound_ms"] == smoke.k3_bound((2, 2, 40, 32), torch.float32)[0]
    for row in [*out["k3"].values(), *out["k1"].values(), *out["k2"].values()]:
        assert row["ms"] > 0 and row["library_ms"] > 0 and row["bound_ms"] > 0
    assert out["k1"]["bf16 dot Q=40 M=500 k=128"]["bound_by"] == "bytes"
    assert json.dumps(out)


def test_card_vs_cpu_rehearses(smoke):
    result = smoke.card_vs_cpu()
    assert set(result) == {"scann", "faiss", "ivf", "faiss, flash ViT", *smoke.QUANT_RUNS}
    for run in result.values():
        assert run["miou"] == run["cpu_miou"] and run["label_err"] == 0.0
    backends = smoke.backends_card_vs_cpu()
    assert set(backends) == set(smoke.QUANT_RUNS)
    assert backends["int8_rows"]["exact"] and not backends["l2"]["exact"]
    assert all(b["code_rows_differ"] == 0 and b["queries_left_out"] == 0 for b in backends.values())


def test_int8_bound_of_the_main_shape(smoke):
    """2·21,904·87,616·768 int8 operations at 1,979 TOP/s: 1.49 ms; at
    1,024,000 rows 17.4 ms. The bytes (1 per element, 4 per row scale)
    take far less."""
    ms, by = smoke.bound_ms(21904, 87616, 768, 30, 1, smoke.PEAK_INT8_OPS, bank_bytes=1, row_bytes=4)
    assert by == "operations" and ms == pytest.approx(1.49, abs=0.005)
    ms, _ = smoke.bound_ms(21904, 1024000, 768, 30, 1, smoke.PEAK_INT8_OPS, bank_bytes=1)
    assert ms == pytest.approx(17.4, abs=0.05)
    ms, by = smoke.bound_ms(64, 1024000, 768, 30, 2, smoke.PEAK_BF16_FLOPS, bank_bytes=1, row_bytes=4)
    assert by == "bytes" and ms == pytest.approx((64 * 768 * 2 + 1024000 * 772 + 64 * 30 * 12) / 3.35e9)


def test_checks_hold_int8_forms_to_bit_exactness(smoke):
    """An int8 form that differs from the plain version by one ulp, or
    swaps two tied indices, fails the bit-exact check."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    gen = torch.Generator().manual_seed(4)
    codes, scale = quantize_bank_int8(torch.randn(600, 32, generator=gen), per_row=True)
    bank = torch.cat([codes, codes])  # every row tied with its copy
    rs = torch.cat([scale, scale]).reshape(-1)
    q8 = quantize_queries_int8(torch.randn(16, 32, generator=gen))[0]
    vals, idx = knn_mod.exact_knn(q8, bank, 10, row_scale=rs)
    smoke.check_against_plain("right", q8, bank, 10, 1200, (vals, idx), row_scale=rs, exact=True)
    with pytest.raises(RuntimeError, match="bit-exact"):
        smoke.check_against_plain("one ulp", q8, bank, 10, 1200, (torch.nextafter(vals, vals + 1), idx),
                                  row_scale=rs, exact=True)
    swapped = idx.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]  # the two copies of the best row
    with pytest.raises(RuntimeError, match="bit-exact"):
        smoke.check_against_plain("tie order", q8, bank, 10, 1200, (vals, swapped), row_scale=rs,
                                  exact=True)


def test_ptxas_report_reads_the_wgmma_kernels(smoke):
    """Registers at entry and spills of each instance of a kernel, and any
    setmaxnreg-ignored warning, from an nvcc -Xptxas -v log."""
    log = """ptxas info    : Compiling entry function '_ZN2wg16flash_bf16_wgmmaILb1ELb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg16flash_bf16_wgmmaILb1ELb1EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z9flash_f32ILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z9flash_f32ILi64EEvv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2wg16flash_bf16_wgmmaILb0ELb0EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg16flash_bf16_wgmmaILb0ELb0EEEv
    80 bytes stack frame, 1116 bytes spill stores, 1264 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""
    r = smoke.ptxas_report(log, "flash_bf16_wgmma")
    assert r == {"instances": 2, "template_args": ["ILb1ELb1E", "ILb0ELb0E"], "registers": [168, 168],
                 "spill_store_bytes": [0, 1116], "setmaxnreg_ignored": [], "wgmma_notes": []}
    warned = log + "ptxas warning : (C7508) Potential Performance Loss: setmaxnreg ignored; unable to determine register count at entry\n"
    assert len(smoke.ptxas_report(warned, "flash_bf16_wgmma")["setmaxnreg_ignored"]) == 1
    noted = log + (
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line 82808 by compiler to allow use "
        "of registers in GMMA in function '_ZN2wg16flash_bf16_wgmmaILb1ELb1EEEv'\n"
        "ptxas info    : (C7517) warpgroup.wait is injected in around line 82931 by compiler to allow use "
        "of registers defined by GMMA in function '_Z9flash_f32ILi64EEvv'\n")
    notes = smoke.ptxas_report(noted, "flash_bf16_wgmma")["wgmma_notes"]
    assert len(notes) == 1 and notes[0].startswith("ptxas info    : (C7519)")


def test_sass_counts_per_function(smoke):
    """HGMMA, IGMMA (int8 wgmma), UTMALDG, HMMA and IMMA counted per
    function of a cuobjdump listing; HMMA is not counted inside HGMMA, nor
    IMMA inside IGMMA."""
    sass = """
        Function : _ZN2wg14knn_bf16_wgmmaILi1ELb0EEEv
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0120*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24 ;
        Function : _ZN2wg9knn_wgmmaINS_2S8ELi1ELNS_3EpiE0EEEvv
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0110*/                   IGMMA.64x128x32.S32.S8.S8 R24, gdesc[UR8], RZ, !UPT ;
        Function : _Z12knn_topk_mmaI8FormAsymLi1EEvv
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;
"""
    per_fn = smoke.sass_counts(sass)
    assert per_fn["_ZN2wg14knn_bf16_wgmmaILi1ELb0EEEv"] == {"HGMMA": 2, "IGMMA": 0, "UTMALDG": 1, "HMMA": 0,
                                                            "IMMA": 0}
    assert per_fn["_ZN2wg9knn_wgmmaINS_2S8ELi1ELNS_3EpiE0EEEvv"] == {"HGMMA": 0, "IGMMA": 1, "UTMALDG": 1,
                                                                     "HMMA": 0, "IMMA": 0}
    assert per_fn["_Z12knn_topk_mmaI8FormAsymLi1EEvv"] == {"HGMMA": 0, "IGMMA": 0, "UTMALDG": 0, "HMMA": 1,
                                                           "IMMA": 1}
