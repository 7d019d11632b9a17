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

import wgmma_smem
from hbird_tpu_torch.models import VIT_PRESETS, ViTConfig
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
    monkeypatch.setattr(mod, "NARROW_INPUT", 64)
    monkeypatch.setattr(mod, "NARROW_ROUNDS", 3)
    monkeypatch.setattr(mod, "HOST_CALLS", 20)
    monkeypatch.setattr(mod, "HOST_BATCH", 10)
    # mae_vith14's stand-in: 2 blocks of 2 heads of 80 (K3 at hd 80), no LayerScale
    monkeypatch.setitem(VIT_PRESETS, "tiny_hd80", ViTConfig(16, 160, 2, 2, img_size=224))
    monkeypatch.setattr(mod, "WIDE_PRESET", "tiny_hd80")
    monkeypatch.setattr(mod, "WIDE_INPUT", 64)
    # dinov2_vitg14's stand-in: 2 blocks of 2 heads of 64, LayerScale, SwiGLU
    monkeypatch.setitem(VIT_PRESETS, "tiny_giant", ViTConfig(16, 128, 2, 2, img_size=224, layerscale=True,
                                                             swiglu=True))
    monkeypatch.setattr(mod, "GIANT_PRESET", "tiny_giant")
    monkeypatch.setattr(mod, "GIANT_INPUT", 64)
    # vit_gigantic_patch14_clip_224's stand-in, read by the converter from shapes: 1 block of 7 heads of 64
    monkeypatch.setattr(mod, "GIGANTIC_SHAPE", {"patch": 16, "width": 448, "depth": 1, "hidden": 896, "img": 224})
    monkeypatch.setattr(mod, "GIGANTIC_INPUT", 64)
    monkeypatch.setattr(mod, "WIDE_CASE_Q", 256)
    monkeypatch.setattr(mod, "WIDE_CASE_M", 700)
    monkeypatch.setattr(mod, "FLASH_BWD_NS", (1, 50, 129))
    monkeypatch.setattr(mod, "FLASH_BWD_CASE_B", 1)
    monkeypatch.setattr(mod, "GRAD_BATCH", 2)

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
    for name in ("flash_attention_dkv", "flash_attention_dq"):  # K3-bwd's two kernels
        wrapper, plain = getattr(flash_cuda, name), getattr(flash_mod, f"{name}_plain")

        def counted_bwd(*args, wrapper=wrapper, plain=plain, **kwargs):
            wrapper.launches += 1
            return plain(*args, **kwargs)

        monkeypatch.setattr(flash_cuda, f"{name}_plain", counted_bwd)
        monkeypatch.setattr(wrapper, "launches", 0)
    return mod


def test_phases_rehearse_on_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    assert smoke.kernel_cases(gen) <= 1e-5
    assert smoke.ivf_cases(gen) == 0.0
    assert smoke.quantized_kernel_cases(gen) == 0.0
    assert smoke.quantized_ivf_cases(gen) == 0.0
    runs, launches, err, tree, q, bank, main_tree, f32 = smoke.main_path(gen_seed=0)
    # scann x 2, int8_rows, int8+rerank, l2, faiss (f32 bank), faiss int8_asym on K1;
    # ivf x 2, scann-literal, ivf f32 (the f32 tree) on K2
    assert launches == {"knn_topk": 7, "ivf_topk": 4} and err == {"K1": 0.0, "K2": 0.0}
    assert runs["ivf f32"]["forms"]["ivf_topk"] == {"f32": 1}
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
    assert f32[0].shape == q.shape and f32[1].shape == bank.shape and f32[1].dtype == torch.float32
    k1_rows, k2_rows, err_timing = smoke.timing(q, bank, main_tree, f32, gen)
    sizes = ("main", "bank_3000")
    assert set(k1_rows) == {*sizes, *(f"{f} {s}" for f in ("int8", "int8_rows", "asym_rows", "asym", "l2", "f32",
                                                           "f32_l2") for s in sizes),
                            *(f"{f} k=120 {s}" for f in ("int8", "int8_rows", "f32") for s in sizes)}
    assert k1_rows["int8 k=120 main"]["k"] == 120 and k1_rows["int8_rows main"]["k"] == 30
    assert k1_rows["f32 k=120 main"]["k"] == 120 and k1_rows["f32_l2 main"]["k"] == 30
    for name, row in k1_rows.items():  # the route on the CPU is the plain version's
        assert row.get("route", "plain") == "plain" and ("fma_bound_ms" in row) == name.startswith("f32")
        # on the f32 forms' inputs, one TF32 pass misses the tolerance the three passes are held to
        assert ("one_tf32_pass_misses" in row) == (name.startswith("f32") and row["k"] == 30)
        assert row.get("one_tf32_pass_misses", 1.0) > 0.0
    # f32's bound: 3 TF32 passes at the TF32 peak, below its f32 FMA bound
    assert k1_rows["f32 main"]["bound_ms"] <= k1_rows["f32 main"]["fma_bound_ms"]
    assert set(k2_rows) == {*sizes, *(f"{f} {s}" for f in ("int8_rows", "asym_rows", "int8", "asym", "f32")
                                      for s in sizes)}
    assert k1_rows["int8 main"]["bound_by"] == k1_rows["main"]["bound_by"]
    assert err_timing == {"K1": 0.0, "K2": 0.0}
    assert k2_rows["bank_3000"]["cap"] == 256 and k2_rows["main"]["block_q"] == 256
    for size in sizes:  # K2 f32 on f32 trees: 3xTF32 bound below the FMA bound, one pass misses
        row = k2_rows[f"f32 {size}"]
        assert row["route"] == "plain" and row["bound_ms"] <= row["fma_bound_ms"]
        assert row["one_tf32_pass_misses"] > 0.0 and row["form"] == "f32"
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
    # dino_vits16: 12 blocks x (2 train + 1 val batches of 4), in bf16 and in f32;
    # mocov3_vits16 (head width 32): 12 blocks x 3 batches in bf16;
    # mae_vith14's stand-in (head width 80): 2 blocks x 3 batches in bf16;
    # dinov2_vitg14's stand-in: 'flash' alone, 2 blocks x 3 batches in bf16;
    # vit_gigantic_patch14_clip_224's stand-in: 1 block x 3 batches in bf16
    narrow, wide, giant = "mocov3_vits16 at 64, ", "tiny_hd80 at 64, ", "tiny_giant at 64, "
    gigantic = "vit_gigantic_patch14_clip_224 at 64, "
    for prefix, dt, n in (("", "bf16", 36), ("", "f32", 36), (narrow, "bf16", 36), (wide, "bf16", 6),
                          (giant, "bf16", 6), (gigantic, "bf16", 3)):
        assert launches[f"{prefix}{dt} flash"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": n}
        if prefix != giant:
            assert launches[f"{prefix}{dt} xla"] == {"knn_topk": 1, "ivf_topk": 0, "flash_attention": 0}
        label = f"scann unbounded, {prefix}{dt} ViT, attention_impl='flash'"
        assert runs[label]["forms"]["flash_attention"] == {dt: n}
    assert f"{giant}bf16 xla" not in launches
    # the int8 runs on the wide banks and the gigantic ViT's bf16 runs: their K1 or K2 form once per eval
    # batch, K3 as the flash run; each with its recall, and so the 'scann' flash run beside them
    for prefix, quant, n in ((wide, smoke.WIDE_QUANT_RUNS, 6), (giant, smoke.GIANT_QUANT_RUNS, 6),
                             (gigantic, smoke.GIGANTIC_RUNS, 3)):
        for name, (_, _, _, (kernel, form)) in quant.items():
            run = runs[f"{name}, {prefix}bf16 ViT, attention_impl='flash'"]
            assert run["forms"] == {"knn_topk": {}, "ivf_topk": {}, "flash_attention": {"bf16": n}, kernel: {form: 1}}
            assert 0.0 < run["recall_at_30_vs_k1_bf16"] <= run["score_recall_at_30_vs_k1_bf16"] <= 1.0
            assert launches[f"{prefix}bf16 {name}"][kernel] == 1
        scann = runs[f"scann unbounded, {prefix}bf16 ViT, attention_impl='flash'"]
        assert scann["recall_at_30_vs_k1_bf16"] == scann["score_recall_at_30_vs_k1_bf16"] == 1.0
    assert set(smoke.GIANT_QUANT_RUNS) == {"scann int8_rows", "faiss int8 + reorder 120", "faiss int8_asym"}
    assert smoke.WIDE_QUANT_RUNS["scann-literal"][3] == ("ivf_topk", "asym_rows")
    assert {run[3] for run in smoke.GIGANTIC_RUNS.values()} == {("ivf_topk", "dot"), ("knn_topk", "l2")}
    assert smoke.GIGANTIC_RUNS["faiss l2"][2] and runs[f"faiss l2, {gigantic}bf16 ViT, attention_impl='flash'"][
        "bf16_bank"]
    assert err == 0.0 and len(runs) == 11 + sum(map(len, (smoke.WIDE_QUANT_RUNS, smoke.GIANT_QUANT_RUNS,
                                                           smoke.GIGANTIC_RUNS)))
    assert runs[f"scann unbounded, {gigantic}bf16 ViT, attention_impl='xla'"]["D"] == 448
    for run in runs.values():
        assert 0.0 <= run["miou"] <= 1.0 and run["phases"]["evaluate"]["items"] == 4
    assert token_err["float32"]["max"] <= 1e-4 and token_err["bfloat16"]["mean"] <= 1e-2
    assert token_err[f"{narrow}bfloat16"]["max"] <= 0.1 and token_err[f"{wide}bfloat16"]["mean"] <= 1e-2
    assert set(token_err) == {"float32", "bfloat16", f"{narrow}bfloat16", f"{wide}bfloat16", f"{giant}bfloat16",
                              f"{gigantic}bfloat16"}
    for name in ("bfloat16", f"{narrow}bfloat16", f"{wide}bfloat16", f"{giant}bfloat16",
                 f"{gigantic}bfloat16"):  # against the f32 one
        f32_err = token_err[name]
        assert f32_err["flash_vs_f32"]["mean"] <= smoke.TOKEN_F32_MARGIN[1] * f32_err["xla_vs_f32"]["mean"]
        assert 0.0 < f32_err["xla_vs_f32"]["max"] <= 0.2
    assert "flash_vs_f32" not in token_err["float32"]
    rows, err = smoke.flash_timing(gen)
    assert err == 0.0 and set(rows) == {"main", "f32", "long", "hd32", "hd80", "f32 hd32", "f32 hd80"}
    assert all(row["route"] == "wgmma" for row in rows.values())
    assert rows["f32 hd80"]["dtype"] == "float32" and rows["f32 hd80"]["shape"] == [2, 2, 20, 80]
    assert rows["f32 hd32"]["fma_bound_ms"] > 0 and rows["f32 hd32"]["graph_ms"] > 0
    for label in ("hd32", "hd80"):  # timed in turns with SDPA: medians, and the spread of each
        row = rows[label]
        assert row["rounds"] == 3 and row["graph_ms"] > 0 and row["library_graph_ms"] > 0
        assert row["ms"] == row["spread"]["kernel"]["ms"]["median"]
        assert row["spread"]["sdpa"]["graph_ms"]["min"] <= row["library_graph_ms"] <= row["spread"]["sdpa"]["graph_ms"]["max"]
        assert set(row["by_batch"]) == {1, 2} and all(ms > 0 for ms in row["by_batch"].values())
        # the host cost's split (on the CPU, the pieces that run there)
        assert set(row["host_us"]) == {"call", "check", "output", "layout"}
        assert all(us > 0 for us in row["host_us"].values())
    assert rows["main"]["bound_by"] == "bytes" and rows["main"]["dtype"] == "bfloat16"
    assert rows["long"]["shape"] == [1, 2, 130, 64] and rows["long"]["dtype"] == "bfloat16"
    assert rows["hd80"]["shape"] == [2, 2, 20, 80] and rows["hd32"]["dtype"] == "bfloat16"
    assert rows["f32"]["fma_bound_ms"] > 0 and "fma_bound_ms" not in rows["main"]
    forward = smoke.forward_timing(0, gen)
    assert set(forward) == {"xla float32", "xla bfloat16", "flash float32", "flash bfloat16",
                            "tiny_hd80 xla bfloat16", "tiny_hd80 flash bfloat16"}
    assert json.dumps([rows, forward])


def test_flash_bwd_phase_rehearses_on_cpu(smoke):
    """Phase 11 on the CPU: K3-bwd's checks at every head width and dtype,
    the gradient path (the stand-in ViT's 12 blocks: K3 and both K3-bwd
    kernels once per block in each dtype) and the timing rows."""
    gen = torch.Generator().manual_seed(0)
    assert smoke.flash_bwd_cases(gen) >= 0.0
    assert flash_cuda.flash_attention_dkv.launches == flash_cuda.flash_attention_dq.launches == 2 * 3 * 3 * 2
    runs, launches = smoke.flash_grad_path(gen_seed=0)
    for dt in ("bf16", "f32"):
        assert launches[f"grad {dt} flash"] == {"flash_attention": 12, "flash_attention_dkv": 12,
                                                "flash_attention_dq": 12}
        run = runs[f"dino_vits16 at 64, batch 2, {dt}, attention_impl='flash'"]
        assert run["forms"] == {"flash_attention": {dt: 12}}  # K3-bwd counts launches alone
        assert run["tensors"] > 12 * 8 and run["wall_s"] > 0  # the input and every parameter
    assert runs["dino_vits16 at 64, batch 2, f32, attention_impl='flash'"]["max_err_over_max"] <= 1e-4
    rows, err = smoke.flash_bwd_timing(gen)
    assert set(rows) == {"main", "f32", "hd32", "f32 hd32", "hd80", "f32 hd80"} and err >= 0.0
    for row in rows.values():
        assert row["route"] == "wgmma"
        assert row["library"].startswith("SDPA backward (")
        assert row["bound_ms"] <= row["split_bound_ms"] and row["graph_ms"] > 0 and row["library_ms"] > 0
        assert row["dkv"]["ms"] > 0 and row["dq"]["bound_ms"] > 0
        assert all(ms > 0 for ms in row["trace_ms"].values()) and bool(row["trace_ms"]) == (row["shape"][2] == 40)
    assert rows["hd80"]["shape"] == [2, 2, 20, 80] and rows["f32"]["dtype"] == "float32"
    entry = smoke.bwd_entry("flash_attention_dkv (K3-bwd)", "dkv", smoke.TPU_KERNELS["K3-bwd dkv"], 24, err, rows,
                            "card")
    assert entry["route"] == "cuda" and entry["library_ms"] is None and entry["ms"] == rows["main"]["dkv"]["ms"]
    assert entry["form"] == "wgmma"
    assert json.dumps(entry)


def test_bwd_bound_of_the_main_shape(smoke):
    """10·B·H·N²·hd = 230.6 GFLOP: 0.2332 ms at 989 TFLOP/s in bf16, 1.398
    ms in f32 as 3 TF32 passes at 495; the library's split (14) 0.3265 and
    1.957 ms."""
    shape = (16, 12, 1370, 64)
    ms, by = smoke.bwd_bound_ms(shape, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.2332, abs=1e-4)
    assert smoke.bwd_bound_ms(shape, torch.float32)[0] == pytest.approx(1.398, abs=1e-3)
    assert smoke.bwd_bound_ms(shape, torch.bfloat16, smoke.BWD_SPLIT_FLOPS)[0] == pytest.approx(0.3265, abs=1e-4)
    ms, by = smoke.bwd_bound_ms((16, 12, 8, 64), torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx((8 * 16 * 12 * 8 * 64 * 2 + 4 * 16 * 12 * 8) / 3.35e9)


def test_check_grads_holds_the_stated_tolerance(smoke):
    """f32 within 1e-5 of the call's largest |gradient|; bf16 within 4 ulps
    at each row's scale (floored at 2^-8 of the call's scale) and a mean
    bound; rounding noise where the gradient vanishes passes."""
    gen = torch.Generator().manual_seed(4)
    ref = [torch.randn(1, 2, 30, 32, generator=gen) for _ in range(3)]
    assert smoke.check_grads("itself", ref, ref) == 0.0
    smoke.check_grads("f32 within", [r + 1e-5 for r in ref], ref)
    with pytest.raises(RuntimeError, match="max"):
        smoke.check_grads("f32 off", [ref[0] + 1e-3, *ref[1:]], ref)
    noise = [ref[0] * 1e-9, ref[1], ref[2]]  # dq vanishing: both sides noise
    smoke.check_grads("f32 noise", [torch.zeros_like(ref[0]), *ref[1:]], noise)
    r16 = [r.bfloat16() for r in ref]
    smoke.check_grads("bf16 one ulp", [(r.float() * (1 + 2.0**-7)).bfloat16() for r in r16], r16)
    smoke.check_grads("bf16 noise", [torch.zeros_like(r16[0]), *r16[1:]], [(ref[0] * 1e-9).bfloat16(), *r16[1:]])
    row = r16[0].float().abs().amax(-1, keepdim=True)
    with pytest.raises(RuntimeError, match="ulps"):
        smoke.check_grads("bf16 eight ulps", [(r16[0].float() + 8 * 2.0**-8 * row).bfloat16(), *r16[1:]], r16)


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
    runs, _, _, _, q, _, _, _ = smoke.main_path(gen_seed=0)
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
    passes the confusion matrix through, and on a bank axis over it K1's
    gather and ring equal the process-local mesh's in every form and the
    engine repeats the meshed command line's mIoU with K1 once per shard."""
    runs, _, _, _, q, bank, _, _ = smoke.main_path(gen_seed=0)
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
    mesh_miou = mesh_runs["cli scann --mesh-bank 4, save .bankdir"]["miou"]
    group_rows, group_runs, info = smoke.mesh_flat_process_group(q, bank, torch.Generator().manual_seed(2),
                                                                 [torch.device("cpu")] * 4, rows, mesh_miou)
    assert info["backend"] == "gloo"
    assert set(group_rows) == {f"{b} {f} {s}" for b in ("main", "bank_3000")
                               for f in ("bf16", "f32", "int8_rows", "int8+reorder") for s in ("gather", "ring")}
    assert all(r["launches_per_call"] == (4 if name.endswith("gather") else 16) for name, r in group_rows.items())
    assert ("phase_9_2_local_ms" in group_rows["main int8_rows ring"]) and "phase_9_2_local_ms" not in group_rows[
        "main f32 gather"]
    (run,) = group_runs.values()
    assert run["launches"] == {"knn_topk": 4, "ivf_topk": 0} and run["forms"]["knn_topk"] == {"dot": 4}
    assert abs(run["miou"] - mesh_miou) <= 1e-4


def test_mesh_tree_phase_rehearses_on_cpu(smoke, monkeypatch):
    """Phase 10 at the rehearsal's sizes: the meshed builds equal the
    unmeshed one (host layout) and its membership (device layout), the
    every-leaf meshed searches equal the unmeshed ones with K2 once per
    shard (int8_rows bit for bit), the streamed build onto the mesh is the
    unmeshed one, .treedirs round-trip on the mesh and 3 shards raise, a
    bank axis over a process group of one gives the same trees and
    answers, and the command line on the mesh repeats the unmeshed
    every-leaf mIoU."""
    monkeypatch.setattr(smoke, "STREAM_WINDOW", 1000)
    monkeypatch.setattr(smoke, "STREAM_CLUSTERS", 16)
    runs, _, _, _, q, bank, _, _ = smoke.main_path(gen_seed=0)
    four = [torch.device("cpu")] * 4
    info, err = smoke.mesh_tree(q, bank, torch.Generator().manual_seed(1), four)
    assert err < 1e-3 and info["shards"] == 4
    assert set(info["builds"]) == {"main", "bank_3000"}
    for row in info["builds"].values():
        assert set(row) == {"rows", "unmeshed", "host", "device"}
        assert set(row["host"]["split_s"]) == {"kmeans", "refine", "assign", "layout", "scatter"}
        assert row["device"]["spilled"][0] == row["device"]["spilled"][1]
    for row in info["search"].values():
        assert set(row["recall_at_30_vs_k1"]) == {"unmeshed", "split", "full"}
        assert row["merge_share_of_split"] > 0 and row["probes_per_shard"] == 8
    assert "divisible" in info["three_shard_error"]
    assert set(info["streamed"]) == {"save_s", "unmeshed", "meshed"}
    assert smoke.mesh_tree_process_group(q, bank, four)["backend"] == "gloo"
    tree_runs = smoke.mesh_tree_cli(0, runs["ivf unbounded"]["miou"], four)
    assert len(tree_runs) == 5
    base = tree_runs["cli ivf, every leaf probed"]
    assert base["launches"] == {"knn_topk": 0, "ivf_topk": 1}
    for label, r in tree_runs.items():
        if label != "cli ivf, every leaf probed":
            assert r["launches"] == {"knn_topk": 0, "ivf_topk": 4}, label
        if "every leaf" in label:
            assert abs(r["miou"] - base["miou"]) <= 1e-4, label


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
    """The --pairs timing: K3 bf16 and f32 at the main and long shapes and
    bf16 at hd 32 and 80 (in turns with SDPA), K1 bf16 dot and l2, int8 and
    int8_rows at each k of PAIR_KS, f32 at k 30 and 120, asym and asym_rows
    at k 30 on both banks, and K2 bf16 and asym_rows on a tree of each bank
    and f32 on an f32 tree of each; K1 asym and asym_rows and K2 asym_rows
    at D = 1,280 and 1,536; K1 bf16 dot and l2 and K2 bf16 at the wide bf16
    depths on both banks (here 1,664 alone); each with its bound, library
    time and output digest, as one JSON-ready result."""
    monkeypatch.setattr(smoke, "PAIR_Q", 40)
    monkeypatch.setattr(smoke, "PAIR_M", 500)
    assert smoke.BF16_PAIR_DEPTHS == (1024, 1280, 1536, 1664, 2048, 3200)
    monkeypatch.setattr(smoke, "BF16_PAIR_DEPTHS", (1664,))
    out = smoke.pairs("here")
    assert out["tree"] == "here" and pathlib.Path(out["package"]) == ROOT / "hbird_tpu_torch"
    k3 = {*(f"{dt} {s}" for dt in ("bf16", "f32") for s in ("(2, 2, 40, 32)", "(1, 2, 130, 64)")),
          *(f"{dt} {s}" for dt in ("bf16", "f32") for s in ("(2, 2, 20, 32)", "(2, 2, 20, 80)"))}
    assert set(out["k3"]) == k3 and all(row["graph_ms"] > 0 for row in out["k3"].values())
    for shape in ("(2, 2, 20, 32)", "(2, 2, 20, 80)"):  # hd 32 and 80 in turns with SDPA, host-launched and in a graph
        row = out["k3"][f"bf16 {shape}"]
        assert row["route"] == "wgmma" and row["library_graph_ms"] > 0
    assert set(out["k1"]) == {*(f"bf16 {f} Q=40 M={m} k={k}" for f in ("dot", "l2") for m in (500, 3000)
                                for k in smoke.PAIR_KS),
                              *(f"{f} Q=40 M={m} k={k}" for f in ("int8", "int8_rows") for m in (500, 3000)
                                for k in smoke.PAIR_KS),
                              *(f"f32 Q=40 M={m} k={k}" for m in (500, 3000) for k in (30, 120)),
                              *(f"{f} Q=40 M={m} k=30" for f in ("asym", "asym_rows") for m in (500, 3000)),
                              *(f"{f} Q=40 M=500 D={d} k=30" for f in ("asym", "asym_rows")
                                for d in smoke.WIDE_TIMING_DEPTHS),
                              *(f"bf16 {f} Q=40 M={m} D=1664 k=30" for f in ("dot", "l2") for m in (500, 3000))}
    assert len(out["k2"]) == 10
    assert sorted(label.split()[0] for label in out["k2"]) == ["asym_rows"] * 4 + ["bf16"] * 4 + ["f32"] * 2
    assert sum(f"D={d} " in label for label in out["k2"] for d in smoke.WIDE_TIMING_DEPTHS) == 2
    assert sum("D=1664 " in label and label.startswith("bf16 ") for label in out["k2"]) == 2
    f32 = [row for label, row in out["k2"].items() if label.startswith("f32")]
    assert all(row["bound_ms"] > 0 and row["library_ms"] > 0 for row in f32)
    assert out["k3"]["f32 (2, 2, 40, 32)"]["bound_ms"] == smoke.k3_bound((2, 2, 40, 32), torch.float32)[0]
    for kernel in ("k3", "k1", "k2"):  # the outputs' bytes, hashed
        assert all(len(row["digest"]) == 16 for row in out[kernel].values())
    for row in [*out["k3"].values(), *out["k1"].values(), *out["k2"].values()]:
        assert row["ms"] > 0 and row["library_ms"] > 0 and row["bound_ms"] > 0
    assert out["k1"]["bf16 dot Q=40 M=500 k=128"]["bound_by"] == "bytes"
    # K3-bwd: bf16 and f32 at the main shape, hd 32 and hd 80, the whole backward and each kernel
    bwd = {f"{dt} {s}" for dt in ("bfloat16", "float32") for s in ("(2, 2, 40, 32)", "(2, 2, 20, 32)", "(2, 2, 20, 80)")}
    assert set(out["k3bwd"]) == bwd
    for label, row in out["k3bwd"].items():
        assert row["route"] == "wgmma"
        assert len(row["digest"]) == 16 and row["graph_ms"] > 0 and row["dkv_ms"] > 0 and row["dq_ms"] > 0
        assert row["ms"] > 0 and row["library_ms"] > 0 and row["bound_ms"] > 0
    assert json.dumps(out)
    only = smoke.pairs("here", k3_only=True)  # --k3-only: the same K3 and K3-bwd rows, no K1 or K2
    assert set(only["k3"]) == k3 and set(only["k3bwd"]) == bwd and only["k1"] == only["k2"] == {}


def test_card_vs_cpu_rehearses(smoke):
    result = smoke.card_vs_cpu()
    assert set(result) == {"scann", "faiss", "ivf", "faiss, flash ViT", "faiss, flash ViT hd 80", *smoke.QUANT_RUNS}
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
    setmaxnreg-ignored warning, from an nvcc -Xptxas -v log; K3's wgmma
    instances by head width (hd 80's too) and LSE flag."""
    wg80 = ("_ZN46_GLOBAL__N__c18cd632_13_flash_attn_cu_efb7a86d2wg16flash_bf16_wgmmaILi80ELb0EEEvNS0_4MapsIXT_EEE"
            "P13__nv_bfloat16iixxxfiiPf")
    wg64 = wg80.replace("ILi80ELb0E", "ILi64ELb1E")
    log = f"""ptxas info    : Compiling entry function '{wg80}' for 'sm_90a'
ptxas info    : Function properties for {wg80}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z9flash_f32ILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z9flash_f32ILi64EEvv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '{wg64}' for 'sm_90a'
ptxas info    : Function properties for {wg64}
    80 bytes stack frame, 1116 bytes spill stores, 1264 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""
    r = smoke.ptxas_report(log, "flash_bf16_wgmma")
    assert r == {"instances": 2, "template_args": ["ILi80ELb0E", "ILi64ELb1E"], "registers": [168, 168],
                 "spill_store_bytes": [0, 1116], "setmaxnreg_ignored": [], "wgmma_notes": []}
    assert [smoke.K3_WGMMA_WIDTHS[a] for a in r["template_args"]] == [80, 64]
    warned = log + "ptxas warning : (C7508) Potential Performance Loss: setmaxnreg ignored; unable to determine register count at entry\n"
    assert len(smoke.ptxas_report(warned, "flash_bf16_wgmma")["setmaxnreg_ignored"]) == 1
    noted = log + (
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line 82808 by compiler to allow use "
        f"of registers in GMMA in function '{wg80}'\n"
        "ptxas info    : (C7517) warpgroup.wait is injected in around line 82931 by compiler to allow use "
        "of registers defined by GMMA in function '_Z9flash_f32ILi64EEvv'\n")
    notes = smoke.ptxas_report(noted, "flash_bf16_wgmma")["wgmma_notes"]
    assert len(notes) == 1 and notes[0].startswith("ptxas info    : (C7519)")
    # K1's and K2's template: a form (streamed forms nest theirs), S, the epilogue, the items
    topk = [f"_ZN2wg10topk_wgmmaI{a}N44_GLOBAL__N__a6f7a300_11_ivf_topk_cu_1f1607da5SlabsEEEv14CUtensorMap_st"
            for a in ("NS_8StreamedINS_4AsymEEELi2ELNS_3EpiE2E", "NS_4AsymELi2ELNS_3EpiE2E",
                      "NS_8StreamedINS_4Bf16EEELi1ELNS_3EpiE0E", "NS_4Bf16ELi1ELNS_3EpiE0E")]
    log = "".join(f"""ptxas info    : Compiling entry function '{f}' for 'sm_90a'
ptxas info    : Function properties for {f}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
""" for f in topk)
    args = smoke.ptxas_report(log, "topk_wgmma")["template_args"]
    forms = ("INS_8StreamedINS_4AsymEE", "INS_4AsymE", "INS_8StreamedINS_4Bf16EE", "INS_4Bf16E")
    assert [[a.startswith(form) for form in forms] for a in args] == [
        [True, False, False, False], [False, True, False, False], [False, False, True, False],
        [False, False, False, True]]
    assert args[0].endswith("SlabsE") and args[0] != args[1]
    assert smoke.WGMMA_FORMS["knn_topk.cu"]["INS_8StreamedINS_4Bf16EE"] == 8  # S 1-4, plain and l2 epilogues
    assert smoke.WGMMA_FORMS["ivf_topk.cu"]["INS_8StreamedINS_4Bf16EE"] == 4  # S 1-4, no epilogue


def test_ptxas_report_reads_k3_f32_and_serialised_wgmma(smoke):
    """K3 f32's wgmma instances (hd 32, 64, 80) read by head width apart
    from the bf16 kernel's, and a C7511 note (wgmma serialised for want of
    registers) on one of them among its notes, which phase 1 refuses."""
    f32 = ("_ZN46_GLOBAL__N__c18cd632_13_flash_attn_cu_efb7a86d2wg15flash_f32_wgmmaILi{}ELb0EEEvNS0_4MapsIXT_EEE"
           "PfiixxxfiiS4_")
    log = "".join(f"""ptxas info    : Compiling entry function '{f32.format(hd)}' for 'sm_90a'
ptxas info    : Function properties for {f32.format(hd)}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
""" for hd in (32, 64, 80))
    log += ("ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async instructions are serialized due "
            f"to insufficient register resources for the wgmma pipeline in the function '{f32.format(80)}'\n")
    r = smoke.ptxas_report(log, "flash_f32_wgmma")
    assert [smoke.K3_WGMMA_WIDTHS[a] for a in r["template_args"]] == [32, 64, 80]
    assert len(r["wgmma_notes"]) == 1 and "(C7511)" in r["wgmma_notes"][0]
    assert smoke.ptxas_report(log, "flash_bf16_wgmma")["instances"] == 0
    assert smoke.TF32_KERNEL in smoke.WGMMA_KERNELS["flash_attn.cu"] and "flash_attn.cu" in smoke.NO_MMA_SYNC


def test_ptxas_report_reads_the_bwd_kernels(smoke):
    """K3-bwd's kernels (bf16 and f32, both on wgmma) read by dtype and
    head width from their mangled names: six instances of each,
    BWD_INSTANCES's keys."""
    name = ("_ZN45_GLOBAL__N__b215bf55_12_flash_bwd_cu_5acdb52813flash_bwd_dkvI{}Li{}EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_"
            "iiNS_7StridesEff")
    log = "".join(f"""ptxas info    : Compiling entry function '{name.format(t, hd)}' for 'sm_90a'
ptxas info    : Function properties for {name.format(t, hd)}
    0 bytes stack frame, {4 * (hd == 80)} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers
""" for t in ("13__nv_bfloat16", "f") for hd in (32, 64, 80))
    r = smoke.ptxas_report(log, "flash_bwd_dkv")
    assert [smoke.BWD_INSTANCES[a] for a in r["template_args"]] == [
        ("bf16", 32), ("bf16", 64), ("bf16", 80), ("f32", 32), ("f32", 64), ("f32", 80)]
    assert r["spill_store_bytes"] == [0, 0, 4, 0, 0, 4]
    assert smoke.ptxas_report(log, "flash_bwd_dq")["instances"] == 0
    assert "flash_bwd.cu" in smoke.NO_MMA_SYNC and set(smoke.BWD_KERNELS) == {"flash_bwd_dkv", "flash_bwd_dq"}


def test_no_mma_sync_in_the_search_libraries(smoke):
    """Phase 1: an HMMA or IMMA in K1's, K2's, K3's or K3-bwd's library
    fails (every form runs a wgmma kernel, K3 f32 and K3-bwd f32 included);
    a library outside NO_MMA_SYNC is not held to it."""
    clean = {"HGMMA": 40, "IGMMA": 8, "UTMALDG": 60, "HMMA": 0, "IMMA": 0}
    for src in ("knn_topk.cu", "ivf_topk.cu", "flash_attn.cu", "flash_bwd.cu"):
        smoke.check_no_mma_sync(src, clean)
    smoke.check_no_mma_sync("other.cu", dict(clean, HMMA=24))
    for src in ("knn_topk.cu", "ivf_topk.cu", "flash_attn.cu", "flash_bwd.cu"):
        for op in ("HMMA", "IMMA"):
            with pytest.raises(RuntimeError, match="mma.sync"):
                smoke.check_no_mma_sync(src, dict(clean, **{op: 1}))


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
        Function : _Z12knn_topk_mmaI8FormBf16Li1EEvv
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;
        Function : _ZN2wg16flash_bf16_wgmmaILi80EEEvNS0_4MapsIXT_EEE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR16], [UR12] ;
        /*0120*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0130*/                   HGMMA.64x16x16.F32.BF16 R88, R152, gdesc[UR20], R88 ;
"""
    per_fn = smoke.sass_counts(sass)
    assert per_fn["_ZN2wg16flash_bf16_wgmmaILi80EEEvNS0_4MapsIXT_EEE"] == {"HGMMA": 2, "IGMMA": 0, "UTMALDG": 2,
                                                                          "HMMA": 0, "IMMA": 0}
    assert per_fn["_ZN2wg14knn_bf16_wgmmaILi1ELb0EEEv"] == {"HGMMA": 2, "IGMMA": 0, "UTMALDG": 1, "HMMA": 0,
                                                            "IMMA": 0}
    assert per_fn["_ZN2wg9knn_wgmmaINS_2S8ELi1ELNS_3EpiE0EEEvv"] == {"HGMMA": 0, "IGMMA": 1, "UTMALDG": 1,
                                                                     "HMMA": 0, "IMMA": 0}
    assert per_fn["_Z12knn_topk_mmaI8FormBf16Li1EEvv"] == {"HGMMA": 0, "IGMMA": 0, "UTMALDG": 0, "HMMA": 1,
                                                           "IMMA": 1}


def test_wide_int8_phases_rehearse_on_cpu(smoke):
    """Phases 2 and 3 on the wide banks: K1 and K2 int8 and int8_rows at D =
    1,040, 1,280 and 1,536, and at 3,088 and 3,200 (the queries streamed
    on the card), on sharp codes, bit for bit (here the plain version
    against itself: the control flow and the checks); the codes can tell
    one rounding from a running f32 sum from 1,280 on. Then K1 and K2 asym
    and asym_rows at D = 1,168, 1,280 and 1,536 (streamed on the card)."""
    gen = torch.Generator().manual_seed(0)
    err, info = smoke.wide_int8_knn_cases(gen)
    err2, info2 = smoke.wide_int8_ivf_cases(gen)
    assert err == err2 == 0.0
    for i in (info, info2):
        assert set(i) == {*smoke.WIDE_DEPTHS, *smoke.DEEP_INT8_DEPTHS, "smem"}
        assert i.pop("smem") is None  # no card: no library to report its shared memory
        assert i[1040]["sharp_share"] == 0.0 and i[1280]["sharp_share"] > 0.0 and i[1536]["sharp_share"] > 0.0
        assert all(i[d]["sharp_share"] > 0.0 for d in smoke.DEEP_INT8_DEPTHS)
        assert all(row["route"] == "plain" for row in i.values())
    err, info = smoke.wide_asym_knn_cases(gen)
    err2, info2 = smoke.wide_asym_ivf_cases(gen)
    assert err < 1e-3 and err2 < 1e-3
    for i in (info, info2):
        assert set(i) == {*smoke.ASYM_DEPTHS, "smem"} and i["smem"] is None
        assert all(i[d]["route"] == "plain" for d in smoke.ASYM_DEPTHS)


def test_sharp_codes_catch_a_running_f32_sum(smoke):
    """An int8 kernel that summed its products in f32, 128 columns at a
    time, fails the bit-exact check on the sharp codes at D = 1,536; codes
    too small to pass 2^24 fail the sharpness check itself."""
    gen = torch.Generator().manual_seed(3)
    q8, codes = smoke.sharp_codes(64, 1536, gen), smoke.sharp_codes(600, 1536, gen)
    assert smoke.assert_sharp("sharp", q8, codes) > 0.01
    running = torch.zeros(64, 600)
    for c in range(0, 1536, 128):
        running = running + (q8[:, c:c + 128].double() @ codes[:, c:c + 128].double().T).float()
    vals, idx = torch.sort(running, dim=1, descending=True, stable=True)
    with pytest.raises(RuntimeError, match="bit-exact"):
        smoke.check_against_plain("running f32 sum", q8, codes, 30, 600, (vals[:, :30], idx[:, :30]), exact=True)
    with pytest.raises(RuntimeError, match="cannot tell"):
        smoke.assert_sharp("small codes", (q8 // 4).contiguous(), (codes // 4).contiguous())


def test_wide_timing_rehearses_on_cpu(smoke, monkeypatch):
    """Phase 7 on the wide banks: every K1 form and K2 form at D = 1,280 and
    1,536, K1 bf16 dot and l2 and K2 bf16 at 1,664, 2,048 and 3,200 (here
    1,664 and 3,200), and K1 and K2 int8 and int8_rows at 3,200, each row
    with its route, bound, plain and library times."""
    monkeypatch.setattr(smoke, "PAIR_Q", 256)
    monkeypatch.setattr(smoke, "PAIR_M", 900)
    assert smoke.BF16_TIMING_DEPTHS == (1664, 2048, 3200)
    monkeypatch.setattr(smoke, "BF16_TIMING_DEPTHS", (1664, 3200))
    k1_rows, k2_rows, errs = smoke.wide_timing(torch.Generator().manual_seed(0))
    sizes = [f"D={d}" for d in smoke.WIDE_TIMING_DEPTHS]
    deep = f"D={smoke.DEEP_INT8_TIMING_DEPTH}"
    bf16 = [f"D={d}" for d in smoke.BF16_TIMING_DEPTHS]
    assert deep in bf16 and not set(bf16) & set(sizes)
    assert set(k1_rows) == {*sizes, *(f"{f} {s}" for f in ("int8", "int8_rows", "asym_rows", "asym", "l2", "f32",
                                                           "f32_l2") for s in sizes),
                            *(f"{f} k=120 {s}" for f in ("int8", "int8_rows", "f32") for s in sizes),
                            *(f"{f}{k} {deep}" for f in ("int8", "int8_rows") for k in ("", " k=120")),
                            *bf16, *(f"l2 {s}" for s in bf16)}
    assert set(k2_rows) == {*sizes, *(f"{f} {s}" for f in ("int8_rows", "asym_rows", "int8", "asym", "f32")
                                      for s in sizes), f"int8_rows {deep}", f"int8 {deep}", *bf16}
    assert errs["K2"] == 0.0 and errs["K1"] < 1e-3
    for row in [*k1_rows.values(), *k2_rows.values()]:
        assert row["route"] == "plain" and row["D"] in (*smoke.WIDE_TIMING_DEPTHS, *smoke.BF16_TIMING_DEPTHS)
        assert row["ms"] > 0 and row["plain_ms"] > 0 and row["bound_ms"] > 0
    assert k1_rows["int8 k=120 D=1536"]["k"] == 120 and k1_rows["D=1280"]["form"] == "dot"
    assert k1_rows["D=1664"]["form"] == "dot" and k1_rows["l2 D=3200"]["form"] == "l2" and k2_rows["D=3200"]["D"] == 3200
    assert json.dumps([k1_rows, k2_rows])


def test_wide_bf16_phases_rehearse_on_cpu(smoke, monkeypatch):
    """Phases 2 and 3 for bf16 past the resident edge: K1 dot and l2 and K2
    at the last resident depth, one chunk past it, and D = 1,544, 1,664,
    2,048 and 3,200 (streamed on the card; here the first two), at every k
    of CHECK_KS (here two), and the tie order of duplicated rows at 1,664
    (here the plain version against itself: the control flow and the
    checks). The script's edge is the deepest where the header's formula
    keeps bf16 queries resident."""
    edge = smoke.BF16_MAX_RESIDENT
    assert wgmma_smem.smem_at(1, edge) > 0 == wgmma_smem.smem_at(1, edge + 8)
    assert smoke.BF16_DEPTHS == (1544, 1664, 2048, 3200)
    monkeypatch.setattr(smoke, "BF16_DEPTHS", (1544, 1664))
    monkeypatch.setattr(smoke, "CHECK_KS", (30, 97))
    depths = smoke.bf16_edge_depths()
    assert depths[0] == smoke.BF16_MAX_RESIDENT and smoke.BF16_MAX_RESIDENT + 64 in depths
    assert set(smoke.BF16_DEPTHS) <= set(depths) and all((wgmma_smem.smem_at(1, d) > 0) == (d <= edge)
                                                         for d in depths)
    gen = torch.Generator().manual_seed(0)
    err, info = smoke.wide_bf16_knn_cases(gen)
    err2, info2 = smoke.wide_bf16_ivf_cases(gen)
    assert err < 1e-3 and err2 < 1e-3
    for i in (info, info2):
        assert set(i) == {*depths, "smem"} and i["smem"] is None
        assert all(i[d]["route"] == "plain" for d in depths)


def test_backends_card_vs_cpu_at_width_rehearses(smoke):
    """Phase 6's backends at D = 1,536: the same codes and scales, int8 and
    int8_rows neighbours bit for bit (on the CPU twice: the control flow)."""
    backends = smoke.backends_card_vs_cpu(smoke.WIDE_DEPTHS[-1])
    assert set(backends) == set(smoke.QUANT_RUNS)
    assert backends["int8_rows"]["exact"] and backends["int8+rerank"]["exact"] is False
    assert all(b["code_rows_differ"] == 0 for b in backends.values())


def test_topk_agree_takes_one_threshold_for_both_sides(smoke):
    """Phase 6's comparison: the same ids, k-th values apart by less than
    the tolerance, a row between the two sides' own thresholds, or a row a
    rounding either side of the common one, agree; a row well above the
    k-th on one side and missing on the other does not."""
    tol = torch.tensor([1e-5])
    ids = torch.tensor([[4, 7, 2]])
    card = torch.tensor([[0.91927, 0.919263, 0.919252]])  # row 7 above card's k-th + tol, not the CPU's
    cpu = torch.tensor([[0.91927, 0.919263, 0.919254]])
    assert smoke._topk_agree(card, ids, cpu, ids, tol).all()
    straddle = torch.tensor([[0.91927, 0.919264 + 2e-7, 0.919252]])  # row 7 just above 0.919264 on one side
    assert smoke._topk_agree(straddle, ids, cpu, ids, tol).all()
    other = torch.tensor([[9, 7, 2]])
    assert not smoke._topk_agree(card, ids, cpu, other, tol).any()
    assert not smoke._topk_agree(cpu, other, card, ids, tol).any()
    assert not smoke._topk_agree(card, ids, cpu + 1e-4, ids, tol).any()
