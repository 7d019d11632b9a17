"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The script's phases run here with the plain versions (a CPU tensor never
launches K1, K2 or K3), so each wrapper's plain path is wrapped to count as
a launch; this checks the script's control flow, shapes and checks, not the
kernels.
Without a GPU, `main()` must exit non-zero and print no result.
"""

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

    def counted(*args, **kwargs):
        knn_cuda.knn_topk.launches += 1
        return knn_mod.exact_knn(*args, **kwargs)

    def counted_ivf(*args, **kwargs):
        ivf_cuda.ivf_topk.launches += 1
        return ivf_mod.ivf_search_plain(*args, **kwargs)

    monkeypatch.setattr(knn_cuda, "exact_knn", counted)
    monkeypatch.setattr(knn_cuda.knn_topk, "launches", 0)
    def counted_flash(*args, **kwargs):
        flash_cuda.flash_attention.launches += 1
        return flash_mod.flash_attention_plain(*args, **kwargs)

    monkeypatch.setattr(ivf_cuda, "ivf_search_plain", counted_ivf)
    monkeypatch.setattr(ivf_cuda.ivf_topk, "launches", 0)
    monkeypatch.setattr(flash_cuda, "flash_attention_plain", counted_flash)
    monkeypatch.setattr(flash_cuda.flash_attention, "launches", 0)
    return mod


def test_phases_rehearse_on_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    assert smoke.kernel_cases(gen) <= 1e-5
    assert smoke.ivf_cases(gen) == 0.0
    runs, launches, err, tree, q, bank, main_tree = smoke.main_path(gen_seed=0)
    assert launches == {"knn_topk": 2, "ivf_topk": 2} and err == {"K1": 0.0, "K2": 0.0}
    assert set(runs) == {"scann unbounded", "scann bounded 64", "ivf unbounded", "ivf bounded 64"}
    for label, run in runs.items():
        assert 0.0 <= run["miou"] <= 1.0
        assert run["phases"]["memory_build"]["items"] == 8
        assert run["phases"]["evaluate"]["items"] == 4
        kernel = "ivf_topk" if label.startswith("ivf") else "knn_topk"
        assert run["launches"] == {"knn_topk": 0, "ivf_topk": 0, kernel: 1}
    assert q.shape == (4 * 16, 384) and bank.shape == (8 * 16, 384)
    assert q.dtype == bank.dtype == torch.bfloat16
    assert (tree["n_leaves"], tree["cap"]) == (128, 256) and set(tree["recall_at_30_vs_k1"]) == {"tile", "query"}
    assert all(0.0 < r <= 1.0 for r in tree["recall_at_30_vs_k1"].values())
    assert set(tree["build_s"]) == {"kmeans", "refine", "assign", "layout", "scatter"}
    k1_rows, k2_rows, err_timing = smoke.timing(q, bank, main_tree, gen)
    assert set(k1_rows) == set(k2_rows) == {"main", "bank_3000"}
    assert err_timing == {"K1": 0.0, "K2": 0.0}
    assert k2_rows["bank_3000"]["cap"] == 256 and k2_rows["main"]["block_q"] == 256
    assert json.dumps([k1_rows, k2_rows])


def test_flash_phases_rehearse_on_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    assert smoke.flash_cases(gen) == 0.0
    runs, launches, token_err, err = smoke.flash_path(gen_seed=0)
    # dino_vits16: 12 blocks x (2 train + 1 val batches of 4)
    assert launches["flash"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": 36}
    assert launches["xla"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": 0}
    assert err == 0.0 and len(runs) == 2
    for run in runs.values():
        assert 0.0 <= run["miou"] <= 1.0 and run["phases"]["evaluate"]["items"] == 4
    assert token_err["float32"]["max"] <= 1e-4 and token_err["bfloat16"]["mean"] <= 1e-2
    rows, err = smoke.flash_timing(gen)
    assert err == 0.0 and set(rows) == {"main", "f32"}
    assert rows["main"]["bound_by"] == "bytes" and rows["main"]["dtype"] == "bfloat16"
    forward = smoke.forward_timing(0, gen)
    assert set(forward) == {"xla float32", "xla bfloat16", "flash float32", "flash bfloat16"}
    assert json.dumps([rows, forward])


def test_flash_bound_of_the_main_shape(smoke):
    """4·B·H·N²·hd = 92.25 GFLOP: 0.093 ms at 989 TFLOP/s, 1.38 ms at 67
    TFLOP/s; the 134.7 MB of bf16 q, k, v and o take 0.040 ms."""
    shape = (16, 12, 1370, 64)
    ms, by = smoke.flash_bound_ms(shape, 2, smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(4 * 16 * 12 * 1370**2 * 64 / 989e9)
    assert ms == pytest.approx(0.0933, abs=1e-4)
    ms, by = smoke.flash_bound_ms(shape, 4, smoke.PEAK_F32_FLOPS)
    assert by == "operations" and ms == pytest.approx(1.377, abs=1e-3)
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


def test_main_without_cuda_prints_no_result(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_card_vs_cpu_rehearses(smoke):
    result = smoke.card_vs_cpu()
    assert set(result) == {"scann", "faiss", "ivf", "faiss, flash ViT"}
    for run in result.values():
        assert run["miou"] == run["cpu_miou"] and run["label_err"] == 0.0
