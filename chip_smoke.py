#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hbird_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100):

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero with no result:
1. The card (nvidia-smi name and power limit) and versions; K1
   (hbird_tpu_torch/ops/csrc/knn_topk.cu), K2 (ops/csrc/ivf_topk.cu) and K3
   (ops/csrc/flash_attn.cu) are built with nvcc for sm_90a, one nvcc each,
   started together.
2. K1 against its plain PyTorch version on the same CUDA tensors: bf16 and
   f32 at Q=4,096, M=300,001, D=768, k=30, valid_rows=299,000; k in
   {1, 8, 128}; valid_rows < k; a bank of duplicated rows (ties).
3. K2 against its plain version (ops/ivf.py::ivf_search_plain) on an IVF
   tree built by the port over a clustered bank of 300,000 rows at D=768
   (512 leaves): bf16 and f32; k in {1, 30, 128}; n_probe in {1, 8, 32};
   block_q in {64, 128, 256}; probed slabs with leaf_valid < k and = 0; a
   bank of duplicated rows (ties across slabs).
4. K3 against its plain version (ops/flash.py::flash_attention_plain),
   bf16 and f32, on seeded unit normals at (B, H, N, hd) = (16, 12, 1370,
   64) (the main path: dinov2_vitb14 at input 518, batch 16), (2, 12, 1374,
   64) (dinov2_vitb14_reg), (4, 12, 197, 32) (mocov3_vits16), (2, 16, 257,
   80) (mae_vith14), (1, 12, 4625, 64) (dinov2 at input 952), (2, 2, 1, 64)
   and (2, 2, 65, 64).
5. The main paths: `hbird_evaluation` on a generated VOC-layout fixture
   (64 train / 16 val images, 600x450) with dinov2_vitb14 at full width
   (random weights from a seed), input 518, batch 16, k=30, seeded
   augmentations and one decode thread, so the mIoU repeats; with
   nn_method 'scann' (the flat bank, K1) and 'ivf' (the tree's defaults:
   512 leaves, 32 probed, block_q 256; K2), each once with an unbounded
   bank and once with memory_size=32,768. The counts are set to 0 before
   each run and read after it: the run's kernel must have launched, and an
   'ivf' run must not launch K1. Each mIoU must be finite and in [0, 1].
   Then, on the unbounded bank and one eval batch of queries (Q = 21,904):
   the tree build's split, and a second build that must give the same
   centroids and slots; K1 and K2 held against their plain versions;
   recall@30 of the tree against K1, probing per tile and per query.
   The flash path: the same 'scann' run, unbounded, with the ViT in bf16
   (`bf16_model=True`), attention_impl='flash' and LayerScale set to 0.05
   (at its 1e-5 init the blocks barely move the tokens, so no attention
   would show in the output). K3 must launch once per block per forward
   batch, depth x (4 train + 1 val batches) = 60, and K1 must launch; the
   same run with 'xla' beside it launches no K3. On one
   val batch the patch tokens of 'flash' and 'xla' agree (f32 within 1e-4;
   bf16 within 0.1 max and 1e-2 mean, the port's bf16 tolerance), and K3
   holds against its plain version on that batch's block-0 q, k, v, the
   strided views of the qkv projection the ViT hands over.
6. The card against the CPU on a small input: a tiny ViT (depth 2, width
   64) on a 12/6-image fixture through `hbird_evaluation`, 'scann',
   'faiss' and 'ivf' (every leaf probed), and 'faiss' with a tiny ViT of
   head width 32, no LayerScale and attention_impl='flash', once on the
   card and once with device="cpu" (the plain versions): mIoU within 1e-4
   and the transferred soft labels within 1e-4, the tolerances the CPU
   tests hold the port to against the JAX engine.
7. K1, K2 and K3 timed with CUDA events, each beside its bound, its plain
   version and a library yardstick the port never calls: K1 at the main
   path's shape (Q=21,904, M=87,616) and against a 1,024,000-row bank
   (query-chunked bf16 torch.matmul + torch.topk); K2 on the main path's
   tree (32 of 512 leaves) and on a tree of the 1,024,000-row bank (cap
   2,816, 32 of 512 leaves) (the probed slabs gathered per tile, then
   torch.bmm + torch.topk, chunked over tiles); K3 at the main shape in
   bf16 and f32 (torch.nn.functional.scaled_dot_product_attention). Then
   the ViT-B/14 forward per batch of 16 at 518: 'xla' and 'flash', f32 and
   bf16.

Tolerance of the K1 and K2 checks: values within 1e-5 * ||q|| * max||b||
(the products are exact in f32, only the summation order differs); index
sets equal except where the k-th and (k+1)-th plain scores are within
twice that; every returned index re-scored gives its returned value; K2's
ids lie in the valid rows of the slabs their query tile probes.

Tolerance of the K3 checks: f32 within 1e-5 absolute at unit-normal
inputs (the same f32 products and exps summed in another order). bf16
within 4 bf16 ulps at each query row's scale (4 * 2^-8 * the row's largest
|plain output|) and a mean error under 2^-7 * mean |plain output|: the
kernel rounds p to bf16 against its running maximum and normalises at the
end, the plain version rounds the normalised p, so about half the outputs
differ by about one ulp; the output's own rounding adds at most one.

Output: a {"kernels": [...]} line, the nvidia-smi card line, and last
{"ok": true, "device": {...}}.
"""

import json
import random
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 FMA peak (no tensor cores)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
RTOL = 1e-5
FLASH_F32_TOL = 1e-5
FLASH_BF16_ULPS = 4
TPU_KERNELS = {
    "K1": "hbird_tpu/ops/knn_pallas.py:238",  # _knn_kernel
    "K2": "hbird_tpu/ops/ivf.py:668",  # _ivf_kernel
    "K3": "hbird_tpu/models/vit.py:319",  # _flash_attention (JAX's library Pallas kernel)
}

# Sizes of the run (a rehearsal on the CPU may shrink them).
DEVICE = "cuda"
CASE_Q, CASE_M, CASE_VALID, DEPTH = 4096, 300_001, 299_000, 768
IVF_ROWS, IVF_CLUSTERS, IVF_Q = 300_000, 64, 4096
FIXTURE = {"n_train": 64, "n_val": 16, "size": (600, 450)}
PRESET, INPUT, BATCH, MEMORY_SIZE = "dinov2_vitb14", 518, 16, 32768
N_PROBE, BLOCK_Q = 32, 256  # the tree's defaults on the engine's path
BIG_M = 1_024_000
SMALL_FIXTURE = {"n_train": 12, "n_val": 6, "size": (64, 48)}
SMALL_LEAVES = 32
SMALL_TOL = 1e-4
FLASH_SHAPES = {
    "main (dinov2_vitb14, 518, batch 16)": (16, 12, 1370, 64),
    "dinov2_vitb14_reg": (2, 12, 1374, 64),
    "mocov3_vits16": (4, 12, 197, 32),
    "mae_vith14": (2, 16, 257, 80),
    "dinov2 at input 952": (1, 12, 4625, 64),
    "one token": (2, 2, 1, 64),
    "65 tokens": (2, 2, 65, 64),
}
FLASH_MAIN = (16, 12, 1370, 64)  # the main path's (B, H, N, hd)
TOKEN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.1, 1e-2)}  # (max, mean) |err|
LAYERSCALE = 0.05  # the flash path's LayerScale (see flash_path)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean ms of `fn` over `reps` runs, by CUDA events (after one warm-up)."""
    fn()
    if DEVICE != "cuda":  # a CPU rehearsal: host clock
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_q, m_valid, d, k, elt_bytes, peak_flops):
    """Least time for the work: inputs read once, outputs written once, or
    2·Q·M·D flops at the card's peak for the input type."""
    bytes_moved = (n_q + m_valid) * d * elt_bytes + n_q * k * (4 + 8)
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = 2.0 * n_q * m_valid * d / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def ivf_bound_ms(n_q, lids, leaf_valid, d, k, elt_bytes, peak_flops):
    """K2's least time on this data: each input read once (the valid rows
    of the slabs any tile probes, the queries, leaf ids and counts), the
    results written once; or 2·block_q·D flops per row a tile scans."""
    lv = leaf_valid.long()
    scanned = int(lv[lids.long()].sum())  # valid rows scanned, over all tiles
    read = int(lv[torch.unique(lids.long())].sum())  # distinct valid rows probed
    block_q = n_q // lids.shape[0]
    bytes_moved = (read + n_q) * d * elt_bytes + n_q * k * (4 + 8) + 4 * (lids.numel() + leaf_valid.numel())
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = 2.0 * block_q * scanned * d / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(shape, elt_bytes, peak_flops):
    """K3's least time: q, k, v read once and o written once, or the
    4·B·H·N²·hd flops of q·kᵀ and p·v at the card's peak for the type."""
    b, h, n, hd = shape
    t_bytes = 4 * b * h * n * hd * elt_bytes / PEAK_BYTES * 1e3
    t_ops = 4.0 * b * h * n * n * hd / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def check_flash(name, out, ref):
    """K3's output against its plain version's, at the stated tolerance;
    returns max |err|."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{name}: {tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} {ref.dtype}")
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        fail(f"{name}: non-finite outputs")
    err = (o - r).abs()
    worst = err.max().item()
    if ref.dtype == torch.float32:
        if worst > FLASH_F32_TOL:
            fail(f"{name}: max |err| {worst} > {FLASH_F32_TOL}")
        detail = f"tolerance {FLASH_F32_TOL}"
    else:
        ulp = 2.0**-8 * r.abs().amax(dim=-1, keepdim=True)
        ulps = (err / ulp.clamp_min(1e-30)).max().item()
        if (err > FLASH_BF16_ULPS * ulp).any():
            fail(f"{name}: {ulps:.2f} bf16 ulps at the row's scale > {FLASH_BF16_ULPS}")
        if err.mean().item() > 2.0**-7 * r.abs().mean().item():
            fail(f"{name}: mean |err| {err.mean().item()} > 2^-7 * mean |out|")
        detail = f"{ulps:.2f} ulps at the row's scale, {(err > 0).float().mean().item():.3f} of outputs differ"
    print(f"  {name}: max |err| {worst:.3g} ({detail})", flush=True)
    return worst


def check_against_plain(name, q, b, k, valid, kernel_out=None, plain_out=None):
    """K1 vs the plain version on the same CUDA tensors; returns max |err|."""
    from hbird_tpu_torch.ops.knn import exact_knn
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    kv, ki = kernel_out if kernel_out is not None else knn_topk(q, b, k, valid_rows=valid)
    sync()
    pv, pi = plain_out if plain_out is not None else exact_knn(q, b, k + 1, valid_rows=valid)
    qn = q.float().norm(dim=1)
    tol = RTOL * qn * b[:valid].float().norm(dim=1).max() if valid else RTOL * qn
    finite = torch.isfinite(pv[:, :k])
    if not torch.equal(torch.isfinite(kv), finite):
        fail(f"{name}: -inf slots differ from the plain version")
    diff = (kv - pv[:, :k]).abs().where(finite, torch.zeros_like(kv))
    err = diff.max().item()
    if (diff > tol[:, None]).any():
        fail(f"{name}: values differ by {err} > tol")
    if (ki.where(~finite, torch.zeros_like(ki)) != 0).any():
        fail(f"{name}: unfilled slots must hold index 0")
    if ((ki < 0) | (ki >= max(valid, 1))).any():
        fail(f"{name}: index outside the valid rows")
    # every returned index, re-scored, gives its value
    rescored = torch.einsum("qd,qkd->qk", q.float(), b[ki].float())
    if ((rescored - kv).abs().where(finite, torch.zeros_like(kv)) > 2 * tol[:, None]).any():
        fail(f"{name}: returned values do not belong to returned indices")
    same_rows = (torch.sort(ki, 1).values == torch.sort(pi[:, :k], 1).values).all(1)
    nxt = pv[:, k] if pv.shape[1] > k else torch.full_like(pv[:, 0], float("-inf"))
    ambiguous = (pv[:, k - 1] - nxt) <= 2 * tol
    bad = int((~same_rows & ~ambiguous).sum())
    if bad:
        fail(f"{name}: {bad} queries with other neighbour sets away from ties")
    print(
        f"  {name}: max |err| {err:.3g}, {int((~same_rows).sum())} queries differ "
        f"only at ties ({int(ambiguous.sum())} tied at the k-th score)",
        flush=True,
    )
    return err


def check_ivf_against_plain(name, q, bank, lids, lv, k, cap, block_q, kernel_out=None,
                            plain_out=None):
    """K2 vs its plain version on the same CUDA tensors; returns max |err|."""
    from hbird_tpu_torch.ops.ivf import ivf_search_plain
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    kv, ki = kernel_out if kernel_out is not None else ivf_topk(
        q, bank, lids, lv, k, cap=cap, block_q=block_q)
    sync()
    pv, pi = plain_out if plain_out is not None else ivf_search_plain(q, bank, lids, lv, k + 1, cap=cap)
    qn = q.float().norm(dim=1)
    tol = RTOL * qn * max(bank.float().norm(dim=1).max().item(), 1e-30)
    finite = torch.isfinite(pv[:, :k])
    if not torch.equal(torch.isfinite(kv), finite):
        fail(f"{name}: -inf slots differ from the plain version")
    diff = (kv - pv[:, :k]).abs().where(finite, torch.zeros_like(kv))
    err = diff.max().item()
    if (diff > tol[:, None]).any():
        fail(f"{name}: values differ by {err} > tol")
    if (ki.where(~finite, torch.zeros_like(ki)) != 0).any():
        fail(f"{name}: unfilled slots must hold slot 0")
    # every finite id lies in the valid rows of a slab its tile probes
    tile_lids = lids.long().repeat_interleave(block_q, dim=0)  # (Q, n_probe)
    slab, row = ki // cap, ki % cap
    probed = (tile_lids[:, :, None] == slab[:, None, :]).any(1)
    in_valid = row < lv.long()[slab.clamp(0, lv.shape[0] - 1)]
    if (finite & ~(probed & in_valid & (ki >= 0))).any():
        fail(f"{name}: a slot outside the probed slabs' valid rows")
    rescored = torch.einsum("qd,qkd->qk", q.float(), bank[ki].float())
    if ((rescored - kv).abs().where(finite, torch.zeros_like(kv)) > 2 * tol[:, None]).any():
        fail(f"{name}: returned values do not belong to returned slots")
    same_rows = (torch.sort(ki, 1).values == torch.sort(pi[:, :k], 1).values).all(1)
    nxt = pv[:, k] if pv.shape[1] > k else torch.full_like(pv[:, 0], float("-inf"))
    ambiguous = (pv[:, k - 1] - nxt) <= 2 * tol
    bad = int((~same_rows & ~ambiguous).sum())
    if bad:
        fail(f"{name}: {bad} queries with other neighbour sets away from ties")
    print(
        f"  {name}: max |err| {err:.3g}, {int((~same_rows).sum())} queries differ "
        f"only at ties ({int(ambiguous.sum())} tied at the k-th score)",
        flush=True,
    )
    return err


def kernel_cases(gen):
    """Phase 2: K1 against the plain version at the stated cases."""
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    def data(n_q, m, d, dtype):
        q = torch.randn(n_q, d, generator=gen, device=DEVICE)
        b = torch.nn.functional.normalize(torch.randn(m, d, generator=gen, device=DEVICE), dim=1)
        return q.to(dtype).contiguous(), b.to(dtype).contiguous()

    errs = []
    shape = f"Q={CASE_Q} M={CASE_M} D={DEPTH} valid={CASE_VALID}"
    q, b = data(CASE_Q, CASE_M, DEPTH, torch.bfloat16)
    errs.append(check_against_plain(f"bf16 {shape} k=30", q, b, 30, CASE_VALID))
    for k in (1, 8, 128):
        errs.append(check_against_plain(f"bf16 {shape} k={k}", q, b, k, CASE_VALID))
    q32, b32 = q.float().contiguous(), b.float().contiguous()
    del q, b
    errs.append(check_against_plain(f"f32 {shape} k=30", q32, b32, 30, CASE_VALID))
    del q32, b32
    q, b = data(1000, 4000, DEPTH, torch.bfloat16)
    errs.append(check_against_plain("bf16 valid_rows=20 < k=30", q, b, 30, 20))
    errs.append(check_against_plain("bf16 valid_rows=0", q, b, 8, 0))
    # duplicated rows: 4 copies of 2,048 rows, queries are base rows
    base = torch.nn.functional.normalize(torch.randn(2048, DEPTH, generator=gen, device=DEVICE), dim=1)
    bank = base.repeat(4, 1).to(torch.bfloat16).contiguous()
    qd = base[:1024].to(torch.bfloat16).contiguous()
    kv, ki = knn_topk(qd, bank, 30)
    errs.append(check_against_plain("bf16 duplicated rows (ties)", qd, bank, 30, bank.shape[0], (kv, ki)))
    check_tie_order(kv, ki, 2048, "duplicated rows")
    return max(errs)


def check_tie_order(kv, ki, n_base, name):
    """The port's tie rule, exactly: value descending, then index ascending;
    of 4 copies (ids r + c·n_base) a copy is kept only if every lower one is."""
    ordered = (kv[:, :-1] > kv[:, 1:]) | ((kv[:, :-1] == kv[:, 1:]) & (ki[:, :-1] < ki[:, 1:]))
    if not ordered.all():
        fail(f"{name}: ties not in ascending index order")
    copy, row = ki // n_base, ki % n_base
    for c in range(1, 4):
        has_lower = ((row[:, :, None] == row[:, None, :]) & (copy[:, None, :] == c - 1)).any(2)
        if ((copy == c) & ~has_lower).any():
            fail(f"{name}: a higher copy won over a lower one")


def clustered_bank(n, d, n_clusters, gen, noise=0.3):
    """Unit rows around random directions (the geometry IVF assumes)."""
    centres = torch.nn.functional.normalize(torch.randn(n_clusters, d, generator=gen, device=DEVICE), dim=1)
    who = torch.randint(0, n_clusters, (n,), generator=gen, device=DEVICE)
    x = centres[who] + noise / d ** 0.5 * torch.randn(n, d, generator=gen, device=DEVICE)
    return torch.nn.functional.normalize(x, dim=1)


def ivf_cases(gen):
    """Phase 3: K2 against the plain version on a tree the port builds."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    x = clustered_bank(IVF_ROWS, DEPTH, IVF_CLUSTERS, gen)
    t0 = time.perf_counter()
    nn = NearestNeighborSearchApprox(x, n_neighbors=30, use_tree=True, device=DEVICE)
    sync()
    cap, bank, lv, cent = nn._cap, nn.bank, nn.leaf_valid, nn.centroids
    print(f"  tree of {IVF_ROWS} rows: {nn._n_leaves} leaves, cap {cap}, built in "
          f"{time.perf_counter() - t0:.2f}s {json.dumps(rounded(nn.build_seconds))}", flush=True)
    pick = torch.randint(0, IVF_ROWS, (IVF_Q,), generator=gen, device=DEVICE)
    q = x[pick] + 0.05 / DEPTH ** 0.5 * torch.randn(IVF_Q, DEPTH, generator=gen, device=DEVICE)
    del x, nn
    errs = []
    cases = [(30, n_probe, block_q) for n_probe in (1, 8, 32) for block_q in (64, 128, 256)]
    cases += [(1, 32, 256), (1, 8, 64), (128, 32, 256), (128, 1, 128)]
    for dtype in (torch.bfloat16, torch.float32):
        b = bank if dtype == torch.bfloat16 else bank.float().contiguous()
        for k, n_probe, block_q in cases if dtype == torch.bfloat16 else [(30, 32, 256), (128, 8, 128), (1, 1, 64)]:
            qp, lids, _ = tile_probe_inputs(q.to(dtype), cent, n_probe=n_probe, block_q=block_q)
            errs.append(check_ivf_against_plain(
                f"{str(dtype)[6:]} Q={qp.shape[0]} k={k} n_probe={n_probe} block_q={block_q}",
                qp, b, lids, lv, k, cap, block_q))
        del b
    # probed slabs with fewer valid rows than k, and with none
    qp, lids, _ = tile_probe_inputs(q.to(torch.bfloat16), cent, n_probe=8, block_q=128)
    lv_cut = lv.clone()
    lv_cut[lids[:, 0].long()] = 0
    lv_cut[lids[:, 1].long()] = 5
    errs.append(check_ivf_against_plain("bf16 leaf_valid 0 and 5 < k=30 on probed slabs",
                                        qp, bank, lids, lv_cut, 30, cap, 128))
    lone = lids[:, :1].contiguous()
    errs.append(check_ivf_against_plain("bf16 one probed slab with 5 rows < k=30",
                                        qp, bank, lone, torch.where(lv > 0, 5, lv).to(torch.int32),
                                        30, cap, 128))
    errs.append(check_ivf_against_plain("bf16 every probed slab empty", qp, bank, lids,
                                        torch.zeros_like(lv), 8, cap, 128))
    # duplicated rows: 4 slabs holding the same 2,048 rows, every slab probed
    base = torch.nn.functional.normalize(torch.randn(2048, DEPTH, generator=gen, device=DEVICE), dim=1)
    dup = base.repeat(4, 1).to(torch.bfloat16).contiguous()
    qd = base[:1024].to(torch.bfloat16).contiguous()
    dl = torch.tensor([[3, 1, 0, 2]] * 4, dtype=torch.int32, device=DEVICE)
    dv = torch.full((4,), 2048, dtype=torch.int32, device=DEVICE)
    kv, ki = ivf_topk(qd, dup, dl, dv, 30, cap=2048, block_q=256)
    errs.append(check_ivf_against_plain("bf16 duplicated rows across slabs (ties)", qd, dup, dl, dv,
                                        30, 2048, 256, (kv, ki)))
    check_tie_order(kv, ki, 2048, "duplicated slabs")
    return max(errs)


def flash_cases(gen):
    """Phase 4: K3 against the plain version at the stated shapes."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    errs = []
    for label, shape in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
            scale = shape[-1] ** -0.5
            out = flash_attention(q, k, v, scale)
            sync()
            errs.append(check_flash(f"{str(dtype)[6:]} {label} {shape}", out,
                                    flash_attention_plain(q, k, v, scale)))
            del q, k, v, out
    return max(errs)


def rounded(d):
    return {k: round(v, 3) for k, v in d.items()}


def main_path(gen_seed):
    """Phase 5: hbird_evaluation per method and bank, counters, and the
    kernels on the built banks."""
    from hbird_tpu_torch import HbirdEvaluation, hbird_evaluation
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.data.transforms import get_hbird_train_transforms, get_hbird_val_transforms
    from hbird_tpu_torch.models import VIT_PRESETS, FeatureExtractor, ViT
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops import ivf
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    cfg = VIT_PRESETS[PRESET]
    vit = ViT(cfg, generator=torch.Generator().manual_seed(gen_seed))
    runs = {}
    launches = {"knn_topk": 0, "ivf_topk": 0}
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
        print(f"  fixture: {time.perf_counter() - t0:.2f}s", flush=True)
        # One decode thread and a seeded augmentation RNG: the runs, and so
        # their mIoU, repeat exactly.
        common = dict(batch_size=BATCH, input_size=INPUT, n_neighbours=30, num_workers=0,
                      device=DEVICE)
        for method, kernel, idle in (("scann", "knn_topk", "ivf_topk"), ("ivf", "ivf_topk", "knn_topk")):
            for bank, memory_size in (("unbounded", None), (f"bounded {MEMORY_SIZE}", MEMORY_SIZE)):
                label = f"{method} {bank}"
                timer = PhaseTimer()
                random.seed(0)
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, nn_method=method,
                                        memory_size=memory_size, timer=timer, **common)
                wall = time.perf_counter() - t0
                n = {name: fn.launches for name, fn in counters.items()}
                if n[kernel] < 1:
                    fail(f"main path ({label}) never launched {kernel}")
                if method == "ivf" and n[idle]:
                    fail(f"main path ({label}) launched {idle} {n[idle]} times")
                if not (0.0 <= miou <= 1.0):
                    fail(f"main path ({label}): mIoU {miou} not a finite value in [0, 1]")
                for name in launches:
                    launches[name] += n[name]
                runs[label] = {"miou": miou, "launches": n, "wall_s": wall, "phases": timer.summary()}
                print(f"  {label}: mIoU {miou:.6f}, launches {json.dumps(n)}, wall {wall:.2f}s, "
                      f"phases {json.dumps(timer.summary())}", flush=True)

        # The unbounded bank and tree, and one eval batch of queries, as the
        # engine hands them to the kernels.
        tr = get_hbird_train_transforms(INPUT, device_normalize=True)
        va = get_hbird_val_transforms(INPUT, device_normalize=True)
        ds, _ = get_dataset("voc", root, BATCH, 0, tr, va)
        random.seed(0)
        fe = FeatureExtractor(vit, eval_spatial_resolution=INPUT // cfg.patch_size, d_model=cfg.width)
        ev = HbirdEvaluation(fe, ds.train_dataloader(), num_classes=ds.get_num_classes(),
                             device=DEVICE, nn_method="ivf", dataset_size=ds.get_train_dataset_size(),
                             device_norm=tr["device_norm"])
        x, _ = next(iter(ds.val_dataloader()))
        mean, std = (torch.tensor(v, device=DEVICE).reshape(1, -1, 1, 1) for v in tr["device_norm"])
        imgs = (torch.from_numpy(x).to(DEVICE).float() / 255.0 - mean) / std
        with torch.inference_mode():
            feats, _ = fe.forward_features(imgs)
    tree = ev.NN_algorithm
    again = NearestNeighborSearchApprox(ev.feature_memory, n_neighbors=30, use_tree=True,
                                        label_memory=ev.label_memory, device=DEVICE)
    if not (torch.equal(again.centroids, tree.centroids) and torch.equal(again.slots, tree.slots)):
        fail("the tree build does not repeat exactly on the same bank")
    del again
    bank = ev.feature_memory.to(torch.bfloat16).contiguous()  # the flat bank 'scann' stores
    q = feats.reshape(-1, cfg.width).to(torch.bfloat16).contiguous()
    print(f"  built bank {tuple(bank.shape)} {bank.dtype}, queries {tuple(q.shape)}; tree "
          f"{tree._n_leaves} leaves, cap {tree._cap}, build split (s) "
          f"{json.dumps(rounded(tree.build_seconds))}", flush=True)
    err_k1 = check_against_plain("K1, main-path bank, one eval batch", q, bank, 30, bank.shape[0])
    qp, lids, _ = ivf.tile_probe_inputs(q, tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    err_k2 = check_ivf_against_plain("K2, main-path tree, one eval batch", qp, tree.bank, lids,
                                     tree.leaf_valid, 30, tree._cap, BLOCK_Q)
    # recall@30 of the tree (original row ids) against K1 on the flat bank,
    # probing per tile (the engine's step) and per query (ScaNN's semantics)
    _, flat_idx = knn_topk(q, bank, 30)
    recall = {}
    for mode in ("tile", "query"):
        _, tree_idx, _ = tree.search_with_labels_pure(tree.device_state, q, 30, probe_mode=mode)
        recall[mode] = (tree_idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()
    print(f"  recall@30 of the tree ({N_PROBE} of {tree._n_leaves} leaves) against K1: "
          f"{recall['tile']:.4f} probing per tile, {recall['query']:.4f} per query", flush=True)
    tree_info = {"n_leaves": tree._n_leaves, "cap": tree._cap, "build_s": tree.build_seconds,
                 "recall_at_30_vs_k1": recall}
    main_tree = (qp, lids, tree.bank, tree.leaf_valid, tree._cap)
    return runs, launches, {"K1": err_k1, "K2": err_k2}, tree_info, q, bank, main_tree


def _val_batch(root):
    """The first val batch, normalised as the engine does on the device."""
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import get_hbird_val_transforms

    va = get_hbird_val_transforms(INPUT, device_normalize=True)
    ds, _ = get_dataset("voc", root, BATCH, 0, va, va)
    x, _ = next(iter(ds.val_dataloader()))
    mean, std = (torch.tensor(v, device=DEVICE).reshape(1, -1, 1, 1) for v in va["device_norm"])
    return (torch.from_numpy(x).to(DEVICE).float() / 255.0 - mean) / std


def flash_path(gen_seed):
    """Phase 5, the flash path: hbird_evaluation with the bf16 ViT and
    attention_impl='flash' against 'xla', the tokens of both on one val
    batch, and K3 on that batch's block-0 q, k, v."""
    import dataclasses

    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS, FeatureExtractor, ViT
    from hbird_tpu_torch.models.vit import _layer_norm, _linear
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    cfg = VIT_PRESETS[PRESET]
    vits = {impl: ViT(dataclasses.replace(cfg, attention_impl=impl),
                      generator=torch.Generator().manual_seed(gen_seed)) for impl in ("flash", "xla")}
    if cfg.layerscale:
        # At its 1e-5 init LayerScale leaves the blocks almost silent: the
        # tokens of any attention would then agree to 1e-10. At 0.05 the
        # attention moves the tokens and the mIoU.
        with torch.no_grad():
            for vit in vits.values():
                for blk in vit.blocks:
                    blk.ls1.fill_(LAYERSCALE)
                    blk.ls2.fill_(LAYERSCALE)
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk, "flash_attention": flash_attention}
    # One forward per train batch (one augmentation epoch) and per val batch.
    n_batches = -(-FIXTURE["n_train"] // BATCH) + -(-FIXTURE["n_val"] // BATCH)
    expected = cfg.depth * n_batches
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
        common = dict(batch_size=BATCH, input_size=INPUT, n_neighbours=30, num_workers=0,
                      device=DEVICE, nn_method="scann", bf16_model=True)
        for impl, vit in vits.items():
            label = f"scann unbounded, bf16 ViT, attention_impl={impl!r}"
            timer = PhaseTimer()
            random.seed(0)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, timer=timer, **common)
            wall = time.perf_counter() - t0
            n = {name: fn.launches for name, fn in counters.items()}
            want = expected if impl == "flash" else 0
            if n["flash_attention"] != want:
                fail(f"{label}: K3 launched {n['flash_attention']} times, not {want} "
                     f"({cfg.depth} blocks x {n_batches} forward batches)")
            if n["knn_topk"] < 1 or n["ivf_topk"]:
                fail(f"{label}: launches {n}")
            if not (0.0 <= miou <= 1.0):
                fail(f"{label}: mIoU {miou} not a finite value in [0, 1]")
            launches[impl] = n
            runs[label] = {"miou": miou, "launches": n, "wall_s": wall, "phases": timer.summary()}
            print(f"  {label}: mIoU {miou:.6f}, launches {json.dumps(n)} (K3 expected {expected} = "
                  f"{cfg.depth} blocks x {n_batches} forward batches), wall {wall:.2f}s, "
                  f"phases {json.dumps(timer.summary())}", flush=True)
        imgs = _val_batch(root)

    token_err = {}
    with torch.inference_mode():
        for dtype, (max_tol, mean_tol) in TOKEN_TOL.items():
            tokens = {impl: FeatureExtractor(vit, use_bf16=dtype == torch.bfloat16).forward_features(imgs)[0]
                      for impl, vit in vits.items()}
            err = (tokens["flash"] - tokens["xla"]).abs()
            token_err[str(dtype)[6:]] = {"max": err.max().item(), "mean": err.mean().item()}
            if err.max().item() > max_tol or err.mean().item() > mean_tol:
                fail(f"flash vs xla patch tokens, {dtype}: {token_err[str(dtype)[6:]]}")
            print(f"  flash vs xla patch tokens on one val batch, {str(dtype)[6:]}: max |err| "
                  f"{err.max().item():.3g}, mean {err.mean().item():.3g}", flush=True)
        # K3 on the main path's own inputs: block 0's q, k, v, strided views
        # of its qkv projection, as the ViT hands them over.
        vit = vits["flash"]
        x = vit._embed(imgs, torch.bfloat16)
        blk = vit.blocks[0]
        y = _layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        b, n, _ = y.shape
        qkv = _linear(y, blk.attn.qkv).reshape(b, n, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scale = cfg.head_dim**-0.5
        err_k3 = check_flash(f"K3, main path's block-0 q, k, v {tuple(q.shape)} (strided views)",
                             flash_attention(q, k, v, scale), flash_attention_plain(q, k, v, scale))
    return runs, launches, token_err, err_k3


def card_vs_cpu():
    """Phase 6: the same small run on the card and on the CPU agrees."""
    import copy

    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import ViT, ViTConfig

    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    vit = ViT(ViTConfig(4, 64, 2, 4, img_size=32, layerscale=True),
              generator=torch.Generator().manual_seed(1))
    # head width 32, the narrowest K3 takes; no LayerScale, so the
    # attention is not silent at init
    flash_vit = ViT(ViTConfig(4, 64, 2, 2, img_size=32, attention_impl="flash"),
                    generator=torch.Generator().manual_seed(1))
    result = {}
    full_probe = {"num_leaves": SMALL_LEAVES, "num_leaves_to_search": SMALL_LEAVES}
    # The flash ViT runs 'faiss', whose f32 bank passes the card's and the
    # CPU's forward through unrounded.
    cases = {"scann": ("scann", vit), "faiss": ("faiss", vit), "ivf": ("ivf", vit),
             "faiss, flash ViT": ("faiss", flash_vit)}
    with tempfile.TemporaryDirectory() as root:
        make_voc_fixture(root, seed=3, colorize=True, class_pool=[1, 2, 3, 4, 5], **SMALL_FIXTURE)
        for label, (nn_method, model) in cases.items():
            out = {}
            for device in (DEVICE, "cpu"):
                random.seed(1234)
                before = flash_attention.launches
                out[device] = hbird_evaluation(
                    copy.deepcopy(model), 64, 4, "voc", root, batch_size=4, input_size=32,
                    n_neighbours=5, nn_method=nn_method, num_workers=0, device=device,
                    nn_params=full_probe if nn_method == "ivf" else None,
                    return_knn_details=True)
                if device == DEVICE and model is flash_vit and flash_attention.launches == before:
                    fail(f"small input, {label}: K3 never launched on the card")
            (miou, det), (cpu_miou, cpu_det) = out[DEVICE], out["cpu"]
            label_err = float(abs(det["knns_ca_labels"] - cpu_det["knns_ca_labels"]).max())
            if not abs(miou - cpu_miou) <= SMALL_TOL:
                fail(f"small input, {label}: mIoU {miou} on the card, {cpu_miou} on the CPU")
            if not label_err <= SMALL_TOL:
                fail(f"small input, {label}: soft labels differ by {label_err}")
            result[label] = {"miou": miou, "cpu_miou": cpu_miou, "label_err": label_err}
            print(f"  {label}: mIoU {miou:.6f} (CPU {cpu_miou:.6f}), "
                  f"soft labels max |err| {label_err:.3g}", flush=True)
    return result


def ivf_library(qp, bank, lids, lv, k, cap, block_q, chunk=8):
    """The library yardstick for K2: each tile's probed slabs gathered, then
    torch.bmm + torch.topk, chunked over tiles."""
    n_tiles, n_probe = lids.shape
    d = bank.shape[1]
    bank3 = bank.view(-1, cap, d)
    col = torch.arange(cap, device=bank.device)
    for t0 in range(0, n_tiles, chunk):
        ids = lids[t0:t0 + chunk].long()
        c = ids.shape[0]
        slabs = bank3[ids].reshape(c, n_probe * cap, d)
        s = torch.bmm(qp[t0 * block_q:(t0 + c) * block_q].view(c, block_q, d), slabs.transpose(1, 2))
        mask = (col < lv.long()[ids][:, :, None]).reshape(c, 1, n_probe * cap)
        torch.topk(s.masked_fill_(~mask, float("-inf")), k, dim=2)


def timing(q, bank, main_tree, gen):
    """Phase 7: K1 and K2 vs plain vs the library yardsticks at two sizes."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import ivf_search_plain, tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn import exact_knn
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    def library(qq, bb, k, chunk=4096):
        for s in range(0, qq.shape[0], chunk):
            torch.topk(qq[s:s + chunk] @ bb.T, k, dim=1)

    k = 30
    n_q, d = q.shape
    k1_rows, k2_rows, errs = {}, {}, {"K1": 0.0, "K2": 0.0}
    big = torch.nn.functional.normalize(
        torch.randn(BIG_M, bank.shape[1], generator=gen, device=DEVICE), dim=1
    ).to(torch.bfloat16)
    for label, bb, reps in (("main", bank, 5), (f"bank_{BIG_M}", big, 2)):
        m = bb.shape[0]
        ms = cuda_ms(lambda: knn_topk(q, bb, k), reps)
        out = knn_topk(q, bb, k)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(out=exact_knn(q, bb, k + 1)), 1)
        plain = box.pop("out")
        errs["K1"] = max(errs["K1"], check_against_plain(f"K1 timing shape {label}", q, bb, k, m,
                                                          out, plain))
        del plain
        lib_ms = cuda_ms(lambda: library(q, bb, k), reps)
        b_ms, b_by = bound_ms(n_q, m, d, k, 2, PEAK_BF16_FLOPS)
        k1_rows[label] = {"Q": n_q, "M": m, "D": d, "k": k, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"  K1 {label}: Q={n_q} M={m} D={d} k={k}: {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"(k+1), library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)

    t0 = time.perf_counter()
    big_tree = NearestNeighborSearchApprox(big, n_neighbors=k, use_tree=True, device=DEVICE)
    sync()
    print(f"  tree of bank_{BIG_M}: {big_tree._n_leaves} leaves, cap {big_tree._cap}, built in "
          f"{time.perf_counter() - t0:.2f}s {json.dumps(rounded(big_tree.build_seconds))}", flush=True)
    del big
    qp_big, lids_big, _ = tile_probe_inputs(q, big_tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    for label, (qp, lids, tb, lv, cap), reps in (
        ("main", main_tree, 5),
        (f"bank_{BIG_M}", (qp_big, lids_big, big_tree.bank, big_tree.leaf_valid, big_tree._cap), 3),
    ):
        ms = cuda_ms(lambda: ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q), reps)
        out = ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(out=ivf_search_plain(qp, tb, lids, lv, k + 1, cap=cap)), 1)
        plain = box.pop("out")
        errs["K2"] = max(errs["K2"], check_ivf_against_plain(f"K2 timing shape {label}", qp, tb, lids,
                                                              lv, k, cap, BLOCK_Q, out, plain))
        del plain
        lib_ms = cuda_ms(lambda: ivf_library(qp, tb, lids, lv, k, cap, BLOCK_Q), reps)
        b_ms, b_by = ivf_bound_ms(qp.shape[0], lids, lv, d, k, 2, PEAK_BF16_FLOPS)
        rows = int(lv.long()[lids.long()].sum())
        read = int(lv.long()[torch.unique(lids.long())].sum())
        k2_rows[label] = {"Q": qp.shape[0], "slots": tb.shape[0], "cap": cap, "n_probe": lids.shape[1],
                          "block_q": BLOCK_Q, "rows_scanned": rows, "rows_probed": read, "D": d, "k": k,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib_ms}
        print(f"  K2 {label}: Q={qp.shape[0]} slots={tb.shape[0]} cap={cap} n_probe={lids.shape[1]} "
              f"rows scanned {rows} (distinct {read}): {ms:.3f} ms, plain {plain_ms:.3f} ms (k+1), "
              f"library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
    return k1_rows, k2_rows, errs


def flash_timing(gen):
    """Phase 7: K3 at the main shape, bf16 and f32, vs its bound, its plain
    version and scaled_dot_product_attention (a yardstick the port never
    calls)."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    rows, errs = {}, []
    scale = FLASH_MAIN[-1] ** -0.5
    for label, dtype, peak in (("main", torch.bfloat16, PEAK_BF16_FLOPS), ("f32", torch.float32, PEAK_F32_FLOPS)):
        q, k, v = (torch.randn(FLASH_MAIN, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
        ms = cuda_ms(lambda: flash_attention(q, k, v, scale), 10)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(out=flash_attention_plain(q, k, v, scale)), 3)
        errs.append(check_flash(f"K3 timing shape {str(dtype)[6:]} {FLASH_MAIN}",
                                flash_attention(q, k, v, scale), box.pop("out")))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale), 10)
        b_ms, b_by = flash_bound_ms(FLASH_MAIN, q.element_size(), peak)
        rows[label] = {"shape": list(FLASH_MAIN), "dtype": str(dtype)[6:], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"  K3 {str(dtype)[6:]} {FLASH_MAIN}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del q, k, v
    return rows, max(errs)


def forward_timing(gen_seed, gen):
    """Phase 7: the ViT forward per batch (BATCH images at INPUT) with
    'xla' and 'flash' attention, f32 and bf16; ms by CUDA events."""
    import dataclasses

    from hbird_tpu_torch.models import VIT_PRESETS, FeatureExtractor, ViT

    cfg = VIT_PRESETS[PRESET]
    imgs = torch.randn(BATCH, 3, INPUT, INPUT, generator=gen, device=DEVICE)
    rows = {}
    for impl in ("xla", "flash"):
        vit = ViT(dataclasses.replace(cfg, attention_impl=impl),
                  generator=torch.Generator().manual_seed(gen_seed)).to(DEVICE).prepare(INPUT)
        for dtype in (torch.float32, torch.bfloat16):
            fe = FeatureExtractor(vit, use_bf16=dtype == torch.bfloat16)
            with torch.inference_mode():
                ms = cuda_ms(lambda: fe.forward_features(imgs), 5)
            label = f"{impl} {str(dtype)[6:]}"
            rows[label] = {"ms": ms, "images_per_s": BATCH / ms * 1e3}
            print(f"  forward {PRESET} at {INPUT}, batch {BATCH}, {label}: {ms:.3f} ms "
                  f"({BATCH / ms * 1e3:.1f} img/s)", flush=True)
        del vit
    return rows


def kernel_entry(name, source, tpu_kernel, launches, err, rows, card):
    main = rows["main"]
    return {"name": name, "route": "cuda", "source": source, "replaces": tpu_kernel,
            "launches": launches, "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows, "card": card}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from hbird_tpu_torch.device import resolve_device
    from hbird_tpu_torch.ops import cuda_build

    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()

    print("[1] build K1, K2 and K3", flush=True)
    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    print(f"  built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f}s",
          flush=True)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    print("[2] K1 vs plain version", flush=True)
    err_k1 = kernel_cases(gen)

    print("[3] K2 vs plain version", flush=True)
    err_k2 = ivf_cases(gen)

    print("[4] K3 vs plain version", flush=True)
    err_k3 = flash_cases(gen)

    print(f"[5] main paths ({card})", flush=True)
    runs, launches, err_main, tree_info, q, bank, main_tree = main_path(gen_seed=0)
    flash_runs, flash_launches, token_err, err_k3_main = flash_path(gen_seed=0)
    runs.update(flash_runs)
    launches["knn_topk"] += sum(n["knn_topk"] for n in flash_launches.values())

    print("[6] the card against the CPU, small input", flush=True)
    small = card_vs_cpu()

    print(f"[7] K1, K2 and K3 timing; the forward ({card})", flush=True)
    k1_rows, k2_rows, err_timing = timing(q, bank, main_tree, gen)
    k3_rows, err_k3_timing = flash_timing(gen)
    forward = forward_timing(0, gen)

    kernels = {"kernels": [
        kernel_entry("knn_topk (K1)", "hbird_tpu_torch/ops/csrc/knn_topk.cu", TPU_KERNELS["K1"],
                     launches["knn_topk"], max(err_k1, err_main["K1"], err_timing["K1"]), k1_rows,
                     card),
        kernel_entry("ivf_topk (K2)", "hbird_tpu_torch/ops/csrc/ivf_topk.cu", TPU_KERNELS["K2"],
                     launches["ivf_topk"], max(err_k2, err_main["K2"], err_timing["K2"]), k2_rows,
                     card),
        kernel_entry("flash_attention (K3)", "hbird_tpu_torch/ops/csrc/flash_attn.cu", TPU_KERNELS["K3"],
                     flash_launches["flash"]["flash_attention"], max(err_k3, err_k3_main, err_k3_timing),
                     k3_rows, card),
    ], "main_path": runs, "tree": tree_info, "flash_vs_xla_tokens": token_err,
        "forward_ms_per_batch": forward, "card_vs_cpu": small,
        "seconds": time.perf_counter() - t_start}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
