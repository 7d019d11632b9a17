#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hbird_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100):

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero with no result:
1. The card (nvidia-smi name and power limit) and versions; K1
   (hbird_tpu_torch/ops/csrc/knn_topk.cu), K2 (ops/csrc/ivf_topk.cu) and K3
   (ops/csrc/flash_attn.cu) are built with nvcc for sm_90a, one nvcc each,
   started together. For the Hopper kernels (K1's and K2's wgmma kernel,
   ops/csrc/wgmma_topk.cuh, every instance S = 1-4 of each form; K3's bf16
   wgmma kernel; ops/csrc/hopper.cuh) it prints what ptxas reported
   (registers and spills by instance, that setmaxnreg was not
   ignored, and any warpgroup wait or arrive it injected or wgmma it
   serialised), the registers and spills of K3's 3xTF32 f32 kernel, and
   the dynamic shared memory they ask for; where cuobjdump exists, the
   warpgroup MMAs (HGMMA, IGMMA for int8), UTMALDG and mma.sync (HMMA,
   IMMA for int8) instructions of each library and of each wgmma kernel,
   which must issue a warpgroup MMA and UTMALDG and no mma.sync (K1's and
   K2's libraries must hold such kernels).
2. K1 against its plain PyTorch version on the same CUDA tensors: bf16 and
   f32 at Q=4,096, M=300,001, D=768, k=30, valid_rows=299,000; k in
   {1, 8, 128}; valid_rows < k; a bank of duplicated rows (ties). Then its
   forms (b)-(e) at the same shape: l2 (bf16 and f32, rows of unequal
   norm); int8 x int8 codes with a global scale and with row scales, bit
   for bit; bf16 queries on those codes (asym, asym_rows); int8
   valid_rows < k; int8 codes of duplicated rows (integer ties). Then the
   wgmma forms (bf16 dot and l2, int8, int8_rows) at every k of CHECK_KS
   (30, 33, 64, 96, 97, 120, 128: each size of the batched select and its
   edges) at that shape, and on tie-dense entries in {-1, 0, 1} (Q=10,000,
   so items of several bank splits are in flight) bit for bit.
3. K2 against its plain version (ops/ivf.py::ivf_search_plain) on an IVF
   tree built by the port over a clustered bank of 300,000 rows at D=768
   (512 leaves): bf16 and f32; k in {1, 30, 128}; n_probe in {1, 8, 32};
   block_q in {64, 128, 256}; probed slabs with leaf_valid < k and = 0; a
   bank of duplicated rows (ties across slabs). Then its int8 forms on an
   int8_rows tree of the same bank (trained, assigned and probed on the
   codes): int8 and int8_rows bit for bit, asym and asym_rows within the
   tolerance; ragged leaf_valid; int8 codes duplicated across slabs probed
   out of slot order (integer ties). K2's wgmma forms bf16, asym_rows and
   int8_rows at k in {30, 64, 120, 128}, 32 probes a 256-query tile (items
   of several probe splits in flight), with probed slabs emptied, cut to 5
   and to 128 rows, and an id outside [0, n_slabs) in every tile's list.
4. K3 against its plain version (ops/flash.py::flash_attention_plain),
   bf16 and f32, on seeded unit normals at (B, H, N, hd) = (16, 12, 1370,
   64) (the main path: dinov2_vitb14 at input 518, batch 16), (2, 12, 1374,
   64) (dinov2_vitb14_reg), (4, 12, 197, 32) (mocov3_vits16), (2, 16, 257,
   80) (mae_vith14), (1, 12, 4625, 64) (dinov2 at input 952), (2, 2, 1, 64)
   and (2, 2, 65, 64). K3 has no backward: under autograd (an input that
   requires grad) the card's call must raise and launch nothing, and under
   torch.no_grad() the same inputs hold.
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
   recall@30 of the tree against K1, probing per tile and per query, by
   ids and by score (a returned row whose exact score reaches K1's k-th
   counts as found: the bank holds large groups of tied rows).
   The quantized and L2 paths (QUANT_RUNS), unbounded: 'scann' with
   quantization='int8_rows' (K1 int8_rows), 'ivf' with the reference's
   ScaNN searcher (int8_asym, dimensions_per_block=4,
   anisotropic_quantization_threshold=0.2, num_reordering_candidates=120;
   K2 asym_rows), 'faiss' with use_int8 and 120 reordering candidates (K1
   int8, then the exact re-score) and 'faiss' with distance_measure='l2'
   on a bf16 bank (K1 l2): each must launch its form once per eval batch
   and nothing else; each backend's recall@30 against K1's exact bf16
   neighbours on the eval batch, by ids and by score, is printed (no
   limit: it is what the quantization costs in answers).
   The flash path: the same 'scann' run, unbounded, with the ViT in bf16
   (`bf16_model=True`) and in f32, each with attention_impl='flash' and
   LayerScale set to 0.05 (at its 1e-5 init the blocks barely move the
   tokens, so no attention would show in the output). K3 must launch once
   per block per forward batch in the run's dtype, depth x (4 train + 1 val
   batches) = 60, and K1 must launch; the same run with 'xla' beside it
   launches no K3, and the mIoU of the two is printed. On one val batch the
   patch tokens of 'flash' and 'xla' agree (f32 within 1e-4; bf16 within
   0.1 max and 1e-2 mean, the port's bf16 tolerance), and K3 holds against
   its plain version on that batch's block-0 q, k, v, the strided views of
   the qkv projection the ViT hands over, in bf16 and in f32.
6. The card against the CPU on a small input: a tiny ViT (depth 2, width
   64) on a 12/6-image fixture through `hbird_evaluation`, 'scann',
   'faiss' and 'ivf' (every leaf probed), and 'faiss' with a tiny ViT of
   head width 32, no LayerScale and attention_impl='flash', once on the
   card and once with device="cpu" (the plain versions): mIoU within 1e-4
   and the transferred soft labels within 1e-4, the tolerances the CPU
   tests hold the port to against the JAX engine. The four quantized and
   L2 runs on the tiny ViT (the tree probing every leaf): mIoU within 1e-4
   only, since int8 rounding turns ulp-level feature differences between
   the devices into code flips. Then each of those backends built on the
   card and on the CPU from the same float bank (6,000 rows, D=64): the
   same codes and scales (anisotropic codes: at most ANISO_CODE_FLIPS of
   the rows may differ, near-tied losses) and the same neighbours (exact
   int8 forms bit for bit; the others within RTOL).
7. K1, K2 and K3 timed with CUDA events, each beside its bound, its plain
   version and a library yardstick the port never calls: K1 at the main
   path's shape (Q=21,904, M=87,616) and against a 1,024,000-row bank
   (query-chunked bf16 torch.matmul + torch.topk), and in its forms int8,
   int8_rows (torch._int_mm + topk; at k = 30 and at k = 120, the `faiss`
   int8 + reorder path's scan), asym_rows and asym (a bf16 matmul against
   the per-row or global codes widened once), l2 (torch.addmm with the
   bias) and f32 (an f32 matmul) on both banks;
   K2 on the main path's tree (32 of 512 leaves) and on a tree of the
   1,024,000-row bank (cap 2,816, 32 of 512 leaves) (the probed slabs
   gathered per tile, then torch.bmm + torch.topk, chunked over tiles),
   and in its int8_rows and asym_rows forms on the same trees' slabs as
   per-row codes, int8 and asym as global codes, and f32; K3 at the main shape in bf16 and f32 and in bf16 at
   (1, 12, 4625, 64), at hd 32 (16, 12, 197, 32) and at hd 80 (16, 16,
   257, 80) (torch.nn.functional.scaled_dot_product_attention). K3 f32's
   bound is its work at f32 accuracy on the tensor cores (3 TF32 passes at
   the TF32 peak), printed beside the f32 FMA bound. Every row but
   asym_rows prints its share of the bound (bound / ms) and its ratio to
   the library call. The select's load on the main path's bank: for K1
   int8 at k = 30 and 120, the share of (query, 128-row tile) pairs in
   which the running top-k receives a score, walking the tiles in
   mma_scan's order and in the wgmma kernel's partial sets, and for the
   partial sets what the batched select does: scores buffered per pair,
   merges and 32-score chunks merged per query and set. Then the
   ViT-B/14 forward per batch of 16 at 518: 'xla' and 'flash', f32 and
   bf16.
8. The entry point and persistence, at phase 5's width and fixture:
   `hbird_tpu_torch.eval_cli.main` (what `python -m hbird_tpu_torch.eval_cli`
   runs) with --model dinov2_vitb14 --random-init --seed 0, 'scann', saving
   the bank as .bankdirs (its mIoU must equal phase 5's 'scann' unbounded
   run's); again with --load-memory (nothing built: no memory_build items,
   no index_build; the same mIoU); 'ivf' with --load-memory on the same
   .bankdirs (the streamed tree build on the card); 'ivf' saving the built
   index as a .treedir, then reloading it (the same mIoU). Each CLI run must
   launch its kernel's dot form once per eval batch and the other kernel
   never. Then, on phase 5's eval batch: the streamed build from the
   .bankdirs equals the in-memory build of the loaded bank (centroids,
   slots, slabs, labels), its recall@30 against K1; a .treedir round trip
   and the CLI's saved .treedir give neighbours bit for bit equal to the
   built tree's. The streamed build at scale: BIG_M clustered rows (4,096
   mixture centres) from a seeded generator on the card in windows of
   131,072, against the in-memory build of the same f32 bank: seconds and
   peak allocated device memory of each; the two must give the same
   centroids and slots, and the streamed peak must be the lower. The
   memory build's peak allocated memory over the bank's bytes, unbounded,
   with the row count unknown (the steps' slabs concatenated, as before the
   repair) and known (written in place), with a patch-mean projection to
   the ViT's width as the step, once over the fixture and once over 8
   augmentation epochs (a bank 8x larger beside the same step).
9. The native tar feed, K1 on a bank mesh, the command line on the mesh,
   one-process NCCL. 9.1: the native library (utils/native.py) built with
   g++ (its time printed); an uncompressed VOC tar of phase 5's fixture;
   the native index against tarfile (member lists equal, every member's
   bytes identical, the index and the full read timed both ways); phase
   5's unbounded 'scann' run fed from the tar: the folder's mIoU exactly,
   memory_build img/s of both. 9.2: K1 over a ('bank',) mesh of
   MESH_SHARDS shards stacked on one card (parallel/sharded_knn.py), on
   phase 5's bank and eval batch and on a BIG_M-row bank, in bf16 dot,
   int8 + reorder 120 and int8_rows (k = 30), by 'gather' and 'ring',
   against unsharded K1: int8_rows bit for bit (values, ids, labels); dot
   within the K1 tolerance, ids equal away from ties; reorder (each shard
   reorders its own 120 candidates: a superset pool) every id re-scores to
   its value and the sorted values are at least the unsharded run's within
   the tolerance; every label row is its winner's; K1 launches 4 times a
   call (gather) and 16 (ring) in the form asked for; each timed beside
   the unsharded call, with the gather's merge and label fetch timed alone.
   9.3: `eval_cli.main` with 'scann --mesh-bank 4 --mesh-devices
   cuda:0,...' at phase 5's settings, saving .bankdirs, then reloading them
   onto the mesh: mIoU within 1e-4 of phase 5's unsharded run, K1 launched
   4 times per eval batch, the reload building nothing. 9.4: a process
   group of one over tcp://127.0.0.1 on NCCL: sync_conf_mat returns its
   input, PredsmIoU(sync_distributed=True) the unsynced result. With more
   than one card, 9.2 and 9.3 run again over distinct cards.

Tolerance of the K1 and K2 checks: values within 1e-5 * ||q|| * max||b||
(the products are exact in f32, only the summation order differs); index
sets equal except where the k-th and (k+1)-th plain scores are within
twice that; every returned index re-scored gives its returned value; K2's
ids lie in the valid rows of the slabs their query tile probes. With row
scales the bound is 1e-5 * ||q|| * max_i(||b_i|| * s_i). int8 x int8
scores are integers below 2^24 (D <= 1024) and a row scale is one f32
multiply, so those forms must equal the plain version bit for bit, values
and indices (the plain version's f32 matmul of the widened codes is exact
with TF32 off).

Tolerance of the K3 checks: f32 within 1e-5 absolute at unit-normal
inputs (3xTF32 products, about 21 bits of each operand, and exps summed
in another order). bf16
within 4 bf16 ulps at each query row's scale (4 * 2^-8 * the row's largest
|plain output|) and a mean error under 2^-7 * mean |plain output|: the
kernel rounds p to bf16 against its running maximum and normalises at the
end, the plain version rounds the normalised p, so about half the outputs
differ by about one ulp; the output's own rounding adds at most one.

Output: a {"kernels": [...]} line, the nvidia-smi card line, and last
{"ok": true, "device": {...}}.

Parent against change: `python3 chip_smoke.py --pairs TREE` imports the
package of the source tree TREE instead of this one's, builds its kernels,
and times only the kernels redesigned for Hopper, each beside its bound and
library call (phase 7's helpers): K3 bf16 and f32 at the main shape and at
(1, 12, 4625, 64) on unit normals; K1 bf16 dot and l2, int8 and int8_rows
with k in PAIR_KS (30, 64, 96, 120, 128), Q = 21,904 normal queries (and
their int8 codes) against 87,616 and 1,024,000 unit rows (and their global
and per-row int8 codes); K2 bf16 and asym_rows (the slabs' per-row codes)
at k = 30 on a tree the package builds of each bank (512 leaves, 32 probed
per 256-query tile). It prints one JSON line.
Two trees are compared in one run on one card, each in its own
process, in turns: parent, change, change, parent.
"""

import argparse
import json
import pathlib
import random
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 FMA peak (no tensor cores)
TF32_PASSES = 3  # K3 f32's products at f32 accuracy: 3xTF32 (big·small, small·big, big·big)
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
STREAM_WINDOW, STREAM_CLUSTERS = 131_072, 4096  # phase 8's streamed build: window rows, mixture centres
BANK_MEMORY_EPOCHS = 8  # phase 8's larger bank for the memory build's peak (augmentation epochs)
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
FLASH_LONG = (1, 12, 4625, 64)  # dinov2 at input 952: the longest sequence timed
FLASH_NARROW = (16, 12, 197, 32)  # mocov3_vits16 at 224, batch 16: K3 bf16 at hd 32
FLASH_WIDE = (16, 16, 257, 80)  # mae_vith14 at 224, batch 16: K3 bf16 at hd 80
PAIR_Q, PAIR_M = 21904, 87616  # --pairs: the main path's eval batch and bank
# --pairs, K1's wgmma forms: the engine's k, S = 2 and 3 keys a lane, faiss int8 + reorder's scan, the most
PAIR_KS = (30, 64, 96, 120, 128)
INT8_KS = (30, 120)  # phase 7's K1 int8 forms: the engine's k and faiss int8 + reorder's scan
# The Hopper kernels: source -> the name their wgmma kernels carry (K1 and
# K2 instantiate one template, wgmma_topk.cuh's topk_wgmma).
WGMMA_KERNELS = {"knn_topk.cu": "topk_wgmma", "ivf_topk.cu": "topk_wgmma",
                 "flash_attn.cu": "flash_bf16_wgmma"}
# Every k of the K1 card checks: each S (keys a lane) and its edges.
CHECK_KS = (30, 33, 64, 96, 97, 120, 128)
TF32_KERNEL = "flash_f32"  # K3 f32: 3xTF32 on mma.sync (HMMA, no wgmma)
TOKEN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.1, 1e-2)}  # (max, mean) |err|
LAYERSCALE = 0.05  # the flash path's LayerScale (see flash_path)
# The quantized and L2 engine runs: nn_method, nn_params, the engine's
# bf16_bank flag, and the kernel and form that must launch once per eval batch.
QUANT_RUNS = {
    "int8_rows": ("scann", {"quantization": "int8_rows"}, False, ("knn_topk", "int8_rows")),
    "scann-literal": ("ivf", {"quantization": "int8_asym", "dimensions_per_block": 4,
                              "anisotropic_quantization_threshold": 0.2,
                              "num_reordering_candidates": 120}, False, ("ivf_topk", "asym_rows")),
    "int8+rerank": ("faiss", {"use_int8": True, "num_reordering_candidates": 120}, False,
                    ("knn_topk", "int8")),
    "l2": ("faiss", {"distance_measure": "l2"}, True, ("knn_topk", "l2")),
}
ANISO_CODE_FLIPS = 0.02  # rows whose anisotropic codes may differ between devices (near-tied losses)
MESH_SHARDS = 4  # phase 9: bank shards of the mesh (stacked on one card, or distinct cards)


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


def bound_ms(n_q, m_valid, d, k, elt_bytes, peak_flops, bank_bytes=None, row_bytes=0):
    """Least time for the work: inputs read once (queries of `elt_bytes`,
    bank rows of `bank_bytes` (default the same) plus `row_bytes` of row
    scale each), outputs written once, or 2·Q·M·D operations at the card's
    peak for the type the products run in."""
    bank_bytes = elt_bytes if bank_bytes is None else bank_bytes
    bytes_moved = n_q * d * elt_bytes + m_valid * (d * bank_bytes + row_bytes) + n_q * k * (4 + 8)
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = 2.0 * n_q * m_valid * d / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def ivf_bound_ms(n_q, lids, leaf_valid, d, k, elt_bytes, peak_flops, bank_bytes=None, row_bytes=0):
    """K2's least time on this data: each input read once (the valid rows
    of the slabs any tile probes, with `row_bytes` of row scale each, the
    queries, leaf ids and counts), the results written once; or
    2·block_q·D operations per row a tile scans."""
    bank_bytes = elt_bytes if bank_bytes is None else bank_bytes
    lv = leaf_valid.long()
    scanned = int(lv[lids.long()].sum())  # valid rows scanned, over all tiles
    read = int(lv[torch.unique(lids.long())].sum())  # distinct valid rows probed
    block_q = n_q // lids.shape[0]
    bytes_moved = (read * (d * bank_bytes + row_bytes) + n_q * d * elt_bytes + n_q * k * (4 + 8)
                   + 4 * (lids.numel() + leaf_valid.numel()))
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = 2.0 * block_q * scanned * d / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(shape, elt_bytes, peak_flops, passes=1):
    """K3's least time: q, k, v read once and o written once, or the
    4·B·H·N²·hd flops of q·kᵀ and p·v, `passes` times over, at the card's
    peak for the type (f32 at f32 accuracy on the tensor cores: 3 TF32
    passes at the TF32 peak)."""
    b, h, n, hd = shape
    t_bytes = 4 * b * h * n * hd * elt_bytes / PEAK_BYTES * 1e3
    t_ops = passes * 4.0 * b * h * n * n * hd / peak_flops * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def k3_bound(shape, dtype):
    """K3's bound for its dtype: bf16 products at the bf16 peak; f32 at f32
    accuracy on the tensor cores, TF32_PASSES passes at the TF32 peak."""
    if dtype == torch.bfloat16:
        return flash_bound_ms(shape, 2, PEAK_BF16_FLOPS)
    return flash_bound_ms(shape, 4, PEAK_TF32_FLOPS, passes=TF32_PASSES)


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


def check_against_plain(name, q, b, k, valid, kernel_out=None, plain_out=None, *,
                        distance="dot_product", row_scale=None, exact=False):
    """K1 vs the plain version on the same CUDA tensors; returns max |err|.
    With `exact` (int8 codes, row scales) values and indices must equal
    the plain version's bit for bit."""
    from hbird_tpu_torch.ops.knn import exact_knn, l2_bias
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    kw = dict(valid_rows=valid, distance=distance, row_scale=row_scale)
    kv, ki = kernel_out if kernel_out is not None else knn_topk(q, b, k, **kw)
    sync()
    pv, pi = plain_out if plain_out is not None else exact_knn(q, b, k + 1, **kw)
    scale = None if row_scale is None else row_scale.reshape(-1).float()
    bias = l2_bias(b) if distance != "dot_product" else None
    qn = q.float().norm(dim=1)
    bn = b[:valid].float().norm(dim=1) * (1.0 if scale is None else scale[:valid])
    tol = RTOL * qn * bn.max() if valid else RTOL * qn
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
    if scale is not None:
        rescored = rescored * scale[ki]
    if bias is not None:
        rescored = rescored - bias[ki]
    if ((rescored - kv).abs().where(finite, torch.zeros_like(kv)) > 2 * tol[:, None]).any():
        fail(f"{name}: returned values do not belong to returned indices")
    return _same_sets(name, kv, ki, pv, pi, k, tol, err, exact)


def _same_sets(name, kv, ki, pv, pi, k, tol, err, exact):
    """The kernel's neighbour sets against the plain version's (plain run
    with k + 1): bit for bit when `exact`, else equal away from ties."""
    if exact:
        if not (torch.equal(kv, pv[:, :k]) and torch.equal(ki, pi[:, :k])):
            fail(f"{name}: not bit-exact against the plain version (max |err| {err})")
        print(f"  {name}: bit-exact, values and indices", flush=True)
        return err
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


def _in_range(bank, lids, lv, cap, row_scale):
    """(bank, lids, lv, row_scale) with every probed id outside [0, n_slabs)
    pointed at an empty slab appended to the bank, for the plain version,
    which indexes with the ids (the kernel skips such ids)."""
    n_slabs = lv.shape[0]
    bad = (lids < 0) | (lids >= n_slabs)
    if not bad.any():
        return bank, lids, lv, row_scale
    bank = torch.cat([bank, bank.new_zeros((cap, bank.shape[1]))])
    lv = torch.cat([lv, lv.new_zeros(1)])
    if row_scale is not None:
        row_scale = torch.cat([row_scale.reshape(-1), row_scale.new_zeros(cap)])
    return bank, torch.where(bad, n_slabs, lids).to(lids.dtype), lv, row_scale


def check_ivf_against_plain(name, q, bank, lids, lv, k, cap, block_q, kernel_out=None,
                            plain_out=None, *, row_scale=None, exact=False):
    """K2 vs its plain version on the same CUDA tensors; returns max |err|.
    With `exact` (int8 codes, row scales) values and slots must equal the
    plain version's bit for bit. Probed ids outside [0, n_slabs) contribute
    nothing."""
    from hbird_tpu_torch.ops.ivf import ivf_search_plain
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    kv, ki = kernel_out if kernel_out is not None else ivf_topk(
        q, bank, lids, lv, k, cap=cap, block_q=block_q, row_scale=row_scale)
    sync()
    if plain_out is None:
        pb, pl, plv, prs = _in_range(bank, lids, lv, cap, row_scale)
        plain_out = ivf_search_plain(q, pb, pl, plv, k + 1, cap=cap, row_scale=prs)
    pv, pi = plain_out
    scale = None if row_scale is None else row_scale.reshape(-1).float()
    qn = q.float().norm(dim=1)
    bn = bank.float().norm(dim=1) * (1.0 if scale is None else scale)
    tol = RTOL * qn * max(bn.max().item(), 1e-30)
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
    if scale is not None:
        rescored = rescored * scale[ki]
    if ((rescored - kv).abs().where(finite, torch.zeros_like(kv)) > 2 * tol[:, None]).any():
        fail(f"{name}: returned values do not belong to returned slots")
    return _same_sets(name, kv, ki, pv, pi, k, tol, err, exact)


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


def quantized_kernel_cases(gen):
    """Phase 2: K1's forms (b)-(e) against the plain version: l2 on a
    float bank of unequal row norms, int8 x int8 codes (global and per-row
    scales) bit for bit, bf16 queries on int8 codes within the tolerance."""
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    shape = f"Q={CASE_Q} M={CASE_M} D={DEPTH} valid={CASE_VALID}"
    q = torch.randn(CASE_Q, DEPTH, generator=gen, device=DEVICE)
    b = torch.nn.functional.normalize(torch.randn(CASE_M, DEPTH, generator=gen, device=DEVICE), dim=1)
    b = b * (0.5 + 1.5 * torch.rand(CASE_M, 1, generator=gen, device=DEVICE))  # l2 and dot orders differ
    errs = []
    for dtype, ks in ((torch.bfloat16, (30, 1, 128)), (torch.float32, (30,))):
        qq, bb = q.to(dtype).contiguous(), b.to(dtype).contiguous()
        for k in ks:
            errs.append(check_against_plain(f"l2 {str(dtype)[6:]} {shape} k={k}", qq, bb, k, CASE_VALID,
                                            distance="l2"))
        del qq, bb
    q8 = quantize_queries_int8(q)[0]
    qb = q.to(torch.bfloat16).contiguous()
    for per_row in (False, True):
        codes, scale = quantize_bank_int8(b, per_row=per_row)
        rs = scale.reshape(-1) if per_row else None
        for form, qq, exact in (("int8", q8, True), ("asym", qb, False)):
            label = form + ("_rows" if per_row else "")
            for k in ((30, 1, 128) if per_row else (30,)):
                errs.append(check_against_plain(f"{label} {shape} k={k}", qq, codes, k, CASE_VALID,
                                                row_scale=rs, exact=exact))
        errs.append(check_against_plain(f"int8{'_rows' if per_row else ''} valid_rows=20 < k=30",
                                        q8[:1000], codes[:4000], 30, 20,
                                        row_scale=None if rs is None else rs[:4000], exact=True))
        del codes
    # integer ties: 4 copies of 2,048 code rows, queries the codes of base rows
    base = torch.nn.functional.normalize(torch.randn(2048, DEPTH, generator=gen, device=DEVICE), dim=1)
    codes, scale = quantize_bank_int8(base, per_row=True)
    bank, rs = codes.repeat(4, 1).contiguous(), scale.reshape(-1).repeat(4)
    qd = codes[:1024].contiguous()
    kv, ki = knn_topk(qd, bank, 30, row_scale=rs)
    errs.append(check_against_plain("int8_rows duplicated rows (ties)", qd, bank, 30, bank.shape[0],
                                    (kv, ki), row_scale=rs, exact=True))
    check_tie_order(kv, ki, 2048, "int8 duplicated rows")
    errs.append(select_cases(gen))
    return max(errs)


def select_cases(gen):
    """Phase 2: the wgmma forms (bf16 dot and l2, int8, int8_rows) at every
    k of CHECK_KS (each S of the batched select and its edges): on the
    stated shape (Q=4,096 over two bank splits) against the plain version,
    and on tie-dense integer entries in {-1, 0, 1} (Q=10,000 queries, so
    items of several splits are in flight; scores, l2 biases and scaled
    int8 scores exact) bit for bit, values and indices."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    shape = f"Q={CASE_Q} M={CASE_M} D={DEPTH} valid={CASE_VALID}"
    q = torch.randn(CASE_Q, DEPTH, generator=gen, device=DEVICE)
    b = torch.nn.functional.normalize(torch.randn(CASE_M, DEPTH, generator=gen, device=DEVICE), dim=1)
    b = b * (0.5 + 1.5 * torch.rand(CASE_M, 1, generator=gen, device=DEVICE))
    qb, bb = q.bfloat16().contiguous(), b.bfloat16().contiguous()
    q8 = quantize_queries_int8(q)[0]
    codes, scale = quantize_bank_int8(b, per_row=True)
    rs = scale.reshape(-1)
    del q, b
    n_q, m = min(CASE_Q * 5 // 2, 10000), min(CASE_M, 40960)
    tq = torch.randint(-1, 2, (n_q, 96), generator=gen, device=DEVICE)
    tb = torch.randint(-1, 2, (m, 96), generator=gen, device=DEVICE)
    t_rs = 0.25 + torch.rand(m, generator=gen, device=DEVICE)
    forms = {  # form: (the stated shape's (q, bank, kw), the tie-dense (q, bank, kw), exact)
        "dot": ((qb, bb, {}), (tq.bfloat16(), tb.bfloat16(), {}), False),
        "l2": ((qb, bb, {"distance": "l2"}), (tq.bfloat16(), tb.bfloat16(), {"distance": "l2"}), False),
        "int8": ((q8, codes, {}), (tq.to(torch.int8), tb.to(torch.int8), {}), True),
        "int8_rows": ((q8, codes, {"row_scale": rs}), (tq.to(torch.int8), tb.to(torch.int8), {"row_scale": t_rs}),
                      True),
    }
    errs = []
    for form, ((qq, bank, kw), (tqq, tbank, tkw), exact) in forms.items():
        for k in CHECK_KS:
            errs.append(check_against_plain(f"{form} {shape} k={k}", qq, bank, k, CASE_VALID, exact=exact, **kw))
            valid = tbank.shape[0] - 127
            errs.append(check_against_plain(f"{form} tie-dense Q={n_q} M={tbank.shape[0]} valid={valid} k={k}",
                                            tqq, tbank, k, valid, exact=True, **tkw))
    return max(errs)


def clustered_bank(n, d, n_clusters, gen, noise=0.3, device=None):
    """Unit rows around random directions (the geometry IVF assumes)."""
    device = device or DEVICE
    centres = torch.nn.functional.normalize(torch.randn(n_clusters, d, generator=gen, device=device), dim=1)
    who = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    x = centres[who] + noise / d ** 0.5 * torch.randn(n, d, generator=gen, device=device)
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
    errs.append(ivf_edge_cases("bf16", q.to(torch.bfloat16), bank, lv, cent, cap, None, False))
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


def ivf_edge_cases(form, q, bank, lv, cent, cap, rs, exact):
    """Phase 3: K2's wgmma kernel at the select's sizes (k in 30, 64, 120,
    128; 32 probes a 256-query tile, so its items run in several probe
    splits) with probed slabs emptied, cut to 5 rows and to a tile edge
    (128), and an id outside [0, n_slabs) in every tile's list (on the
    card: the kernel skips such ids; the plain version indexes with them)."""
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs

    qp, lids, _ = tile_probe_inputs(q, cent, n_probe=N_PROBE, block_q=BLOCK_Q)
    lv_cut = lv.clone()
    lv_cut[lids[:, 0].long()] = 0
    lv_cut[lids[:, 1].long()] = 5
    lv_cut[lids[:, 2].long()] = torch.clamp(lv_cut[lids[:, 2].long()], max=128)
    lids = lids.clone()
    if DEVICE == "cuda":
        lids[:, 3] = lv.shape[0] + 5
    errs = []
    for k in (30, 64, 120, 128):
        errs.append(check_ivf_against_plain(
            f"{form} Q={qp.shape[0]} k={k} n_probe={N_PROBE} block_q={BLOCK_Q}, slabs empty, of 5 and "
            f"128 rows, an id out of range", qp, bank, lids, lv_cut, k, cap, BLOCK_Q, row_scale=rs,
            exact=exact))
    return max(errs)


def quantized_ivf_cases(gen):
    """Phase 3: K2's int8 forms against the plain version on an int8_rows
    tree the port builds (trained, assigned and probed on the codes, the
    row scales in the slab layout): int8 x int8 with and without the row
    scales bit for bit, bf16 queries on the codes within the tolerance."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    x = clustered_bank(IVF_ROWS, DEPTH, IVF_CLUSTERS, gen)
    t0 = time.perf_counter()
    nn = NearestNeighborSearchApprox(x, n_neighbors=30, use_tree=True, quantization="int8_rows",
                                     device=DEVICE)
    sync()
    cap, codes, lv, cent, rs = nn._cap, nn.bank, nn.leaf_valid, nn.centroids, nn.bank_row_scale
    print(f"  int8_rows tree of {IVF_ROWS} rows: {nn._n_leaves} leaves, cap {cap}, built in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    pick = torch.randint(0, IVF_ROWS, (IVF_Q,), generator=gen, device=DEVICE)
    q = x[pick] + 0.05 / DEPTH ** 0.5 * torch.randn(IVF_Q, DEPTH, generator=gen, device=DEVICE)
    del x, nn
    q8, qb = quantize_queries_int8(q)[0], q.to(torch.bfloat16).contiguous()
    errs = []
    for form, qq, scale, exact in (("int8", q8, None, True), ("int8_rows", q8, rs, True),
                                   ("asym", qb, None, False), ("asym_rows", qb, rs, False)):
        for k, n_probe, block_q in ((30, 32, 256), (128, 8, 128), (1, 1, 64)):
            qp, lids, _ = tile_probe_inputs(qq, cent, n_probe=n_probe, block_q=block_q)
            errs.append(check_ivf_against_plain(
                f"{form} Q={qp.shape[0]} k={k} n_probe={n_probe} block_q={block_q}",
                qp, codes, lids, lv, k, cap, block_q, row_scale=scale, exact=exact))
    qp, lids, _ = tile_probe_inputs(q8, cent, n_probe=8, block_q=128)
    lv_cut = lv.clone()
    lv_cut[lids[:, 0].long()] = 0
    lv_cut[lids[:, 1].long()] = 5
    errs.append(check_ivf_against_plain("int8_rows leaf_valid 0 and 5 < k=30 on probed slabs",
                                        qp, codes, lids, lv_cut, 30, cap, 128, row_scale=rs, exact=True))
    errs.append(ivf_edge_cases("asym_rows", qb, codes, lv, cent, cap, rs, False))
    errs.append(ivf_edge_cases("int8_rows", q8, codes, lv, cent, cap, rs, True))
    # integer ties across slabs probed out of slot order: 4 slabs of the same codes
    base = torch.nn.functional.normalize(torch.randn(2048, DEPTH, generator=gen, device=DEVICE), dim=1)
    bcodes, bscale = quantize_bank_int8(base, per_row=True)
    dup, drs = bcodes.repeat(4, 1).contiguous(), bscale.reshape(-1).repeat(4)
    qd = bcodes[:1024].contiguous()
    dl = torch.tensor([[3, 1, 0, 2]] * 4, dtype=torch.int32, device=DEVICE)
    dv = torch.full((4,), 2048, dtype=torch.int32, device=DEVICE)
    kv, ki = ivf_topk(qd, dup, dl, dv, 30, cap=2048, block_q=256, row_scale=drs)
    errs.append(check_ivf_against_plain("int8_rows duplicated rows across slabs (ties)", qd, dup, dl, dv,
                                        30, 2048, 256, (kv, ki), row_scale=drs, exact=True))
    check_tie_order(kv, ki, 2048, "int8 duplicated slabs")
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
    if DEVICE == "cuda":
        grad_check(gen)
    return max(errs)


def grad_check(gen):
    """Phase 4: K3 has no backward, so under autograd (an input that
    requires grad, grad mode on) the card's call must raise and launch
    nothing; under torch.no_grad() the same inputs run and hold."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    q, k, v = (torch.randn((2, 4, 100, 64), generator=gen, device=DEVICE) for _ in range(3))
    q.requires_grad_(True)
    before = flash_attention.launches
    try:
        flash_attention(q, k, v, 0.125)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        fail("K3 under autograd returned an output instead of raising")
    if flash_attention.launches != before:
        fail("K3 under autograd launched")
    with torch.no_grad():
        out = flash_attention(q, k, v, 0.125)
        check_flash("K3 f32 under torch.no_grad() (its inputs require grad)", out,
                    flash_attention_plain(q, k, v, 0.125))
    print("  K3 under autograd: raises (no backward), launches nothing", flush=True)


def shares(ms, bound, library):
    """'share of the bound x, y x the library' for a timed row."""
    lib = "no library call" if library is None else f"{ms / library:.3f}x the library call"
    return f"{bound / ms:.1%} of the bound, {lib}"


# Warpgroup MMAs (HGMMA float, IGMMA integer), TMA loads, and mma.sync
# (HMMA float, IMMA integer).
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")
# ptxas notes on wgmma: a warpgroup.wait (C7517) or warpgroup.arrive (C7519)
# it injected, or wgmma serialised (C7520).
WGMMA_NOTES = ("C7517", "C7519", "C7520")


def ptxas_report(log, name):
    """Of the kernel `name` in an nvcc -Xptxas -v log: each instance's
    template arguments (as mangled), registers at entry and spill stores;
    the setmaxnreg-ignored warnings; and the WGMMA_NOTES lines."""
    lines = log.splitlines()
    args, regs, spills = [], [], []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            targs = re.search(re.escape(name) + r"(I\w*?E)E", line)
            args.append(targs.group(1) if targs else "")
            for nxt in lines[i + 1:i + 5]:
                if "spill stores" in nxt:
                    spills.append(int(re.search(r"(\d+) bytes spill stores", nxt).group(1)))
                if "Used" in nxt and "registers" in nxt:
                    regs.append(int(re.search(r"Used (\d+) registers", nxt).group(1)))
                    break
    ignored = [ln.strip() for ln in lines if "setmaxnreg" in ln and "ignored" in ln]
    notes = [ln.strip() for ln in lines
             if name in ln and any(f"({code})" in ln for code in WGMMA_NOTES)]
    return {"instances": len(regs), "template_args": args, "registers": regs,
            "spill_store_bytes": spills, "setmaxnreg_ignored": ignored, "wgmma_notes": notes}


def sass_counts(sass):
    """SASS_OPS counted per function of a cuobjdump -sass listing (lines
    with none of them are skipped by a substring test: the listings run to
    millions of lines)."""
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    per_fn, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            per_fn[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None and ("MMA" in line or "UTMA" in line):
            for op in set(pattern.findall(line)):
                per_fn[fn][op] += 1
    return per_fn


def build_report(libs):
    """Phase 1: what ptxas said of the Hopper kernels, the shared memory
    they ask for, and the SASS instructions of each library by cuobjdump
    (where it exists): each wgmma kernel must issue warpgroup MMAs (HGMMA,
    or IGMMA for int8) and UTMALDG and no mma.sync (HMMA, IMMA)."""
    import ctypes
    import shutil

    from hbird_tpu_torch.ops import cuda_build

    report = {}
    for src, name in WGMMA_KERNELS.items():
        if src not in cuda_build.LOGS:
            print(f"  {src}: built before this run, no ptxas report", flush=True)
            continue
        r = report[f"{src}:{name}"] = ptxas_report(cuda_build.LOGS[src], name)
        regs = dict(zip(r["template_args"], r["registers"]))
        spills = dict(zip(r["template_args"], r["spill_store_bytes"]))
        print(f"  ptxas, {src} {name} ({r['instances']} instances): registers at entry by instance "
              f"{json.dumps(regs)}, spill stores by instance {json.dumps(spills)} bytes; "
              "setmaxnreg " + (f"IGNORED: {r['setmaxnreg_ignored'][0]}" if r["setmaxnreg_ignored"]
                               else "not ignored (no C7508 warning)")
              + f"; {len(r['wgmma_notes'])} wgmma notes ({', '.join(WGMMA_NOTES)})", flush=True)
        for note in r["wgmma_notes"]:
            print(f"    {note}", flush=True)
    if "flash_attn.cu" in cuda_build.LOGS:
        r = report[TF32_KERNEL] = ptxas_report(cuda_build.LOGS["flash_attn.cu"], TF32_KERNEL)
        print(f"  ptxas, {TF32_KERNEL} (3xTF32, {r['instances']} instances): registers "
              f"{json.dumps(dict(zip(r['template_args'], r['registers'])))}, spill stores by instance "
              f"{json.dumps(dict(zip(r['template_args'], r['spill_store_bytes'])))} bytes", flush=True)
    k1 = ctypes.CDLL(str(libs["knn_topk.cu"]))
    k2 = ctypes.CDLL(str(libs["ivf_topk.cu"]))
    k3 = ctypes.CDLL(str(libs["flash_attn.cu"]))
    k1.knn_topk_wgmma_smem.argtypes, k1.knn_topk_wgmma_smem.restype = (ctypes.c_int,) * 2, ctypes.c_int
    k2.ivf_topk_wgmma_smem.argtypes, k2.ivf_topk_wgmma_smem.restype = (ctypes.c_int,) * 2, ctypes.c_int
    k3.flash_attn_wgmma_smem.argtypes, k3.flash_attn_wgmma_smem.restype = (), ctypes.c_int
    smem = {"K1 bf16": k1.knn_topk_wgmma_smem(DEPTH, 1), "K1 int8": k1.knn_topk_wgmma_smem(DEPTH, 2),
            "K2 bf16": k2.ivf_topk_wgmma_smem(DEPTH, 1), "K2 int8": k2.ivf_topk_wgmma_smem(DEPTH, 2),
            "K2 asym": k2.ivf_topk_wgmma_smem(DEPTH, 3), "flash_bf16_wgmma": k3.flash_attn_wgmma_smem()}
    print(f"  dynamic shared memory at D={DEPTH}: {json.dumps(smem)} B", flush=True)
    report["smem_bytes"] = smem
    tool = shutil.which("cuobjdump") or shutil.which("cuobjdump", path="/usr/local/cuda/bin")
    if tool is None:
        print("  cuobjdump not found: SASS not counted", flush=True)
        return report
    dumps = {src: subprocess.Popen([tool, "-sass", str(path)], stdout=subprocess.PIPE, text=True)
             for src, path in libs.items()}  # the three listings at once
    with ThreadPoolExecutor(len(dumps)) as pool:
        listings = dict(zip(dumps, pool.map(lambda proc: proc.communicate()[0], dumps.values())))
    for src, path in libs.items():
        per_fn = sass_counts(listings[src])
        total = {op: sum(c[op] for c in per_fn.values()) for op in SASS_OPS}
        name = WGMMA_KERNELS.get(src)
        wg_fns = {f: c for f, c in per_fn.items() if name and name in f}
        print(f"  SASS of {path.name}: {json.dumps(total)}; wgmma kernels ({', '.join(SASS_OPS)}): "
              f"{json.dumps(sorted({tuple(c.values()) for c in wg_fns.values()}))}", flush=True)
        tf32 = {f: c for f, c in per_fn.items() if TF32_KERNEL in f}
        if tf32:
            print(f"  SASS of the {TF32_KERNEL} kernels ({', '.join(SASS_OPS)}): "
                  f"{json.dumps(sorted({tuple(c.values()) for c in tf32.values()}))}", flush=True)
        for f, c in wg_fns.items():
            if c["HGMMA"] + c["IGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] or c["IMMA"]:
                fail(f"{f}: {c} (a wgmma kernel must issue HGMMA or IGMMA and UTMALDG, and no HMMA or IMMA)")
        if name and not wg_fns:
            fail(f"{path.name}: no {name} kernel in the SASS")
        report[path.name] = {"total": total, "wgmma_kernels": len(wg_fns)}
    return report


def reset_counts(counters):
    """Set every kernel's launch count (and its counts by form) to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "forms"):
            fn.forms.clear()


def read_forms(counters):
    """Launches by form of the kernels that count them (K1, K2)."""
    return {name: dict(fn.forms) for name, fn in counters.items() if hasattr(fn, "forms")}


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
                reset_counts(counters)
                t0 = time.perf_counter()
                miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, nn_method=method,
                                        memory_size=memory_size, timer=timer, **common)
                wall = time.perf_counter() - t0
                n = {name: fn.launches for name, fn in counters.items()}
                forms = read_forms(counters)
                if n[kernel] < 1:
                    fail(f"main path ({label}) never launched {kernel}")
                if method == "ivf" and n[idle]:
                    fail(f"main path ({label}) launched {idle} {n[idle]} times")
                if not (0.0 <= miou <= 1.0):
                    fail(f"main path ({label}): mIoU {miou} not a finite value in [0, 1]")
                for name in launches:
                    launches[name] += n[name]
                runs[label] = {"miou": miou, "launches": n, "forms": forms, "wall_s": wall,
                               "phases": timer.summary()}
                print(f"  {label}: mIoU {miou:.6f}, launches {json.dumps(n)}, wall {wall:.2f}s, "
                      f"phases {json.dumps(timer.summary())}", flush=True)
        # The quantized and L2 paths: each launches its kernel's form once
        # per eval batch, and no other form or kernel.
        n_eval = -(-FIXTURE["n_val"] // BATCH)
        for label, (method, params, bf16_bank, (kernel, form)) in QUANT_RUNS.items():
            timer = PhaseTimer()
            random.seed(0)
            reset_counts(counters)
            t0 = time.perf_counter()
            miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, nn_method=method,
                                    nn_params=dict(params), bf16_bank=bf16_bank, timer=timer, **common)
            wall = time.perf_counter() - t0
            n = {name: fn.launches for name, fn in counters.items()}
            forms = read_forms(counters)
            if forms[kernel] != {form: n_eval} or n[kernel] != n_eval or sum(n.values()) != n_eval:
                fail(f"main path ({label}): launches by form {forms}, not {kernel} {form} x {n_eval}")
            if not (0.0 <= miou <= 1.0):
                fail(f"main path ({label}): mIoU {miou} not a finite value in [0, 1]")
            for name in launches:
                launches[name] += n[name]
            runs[label] = {"nn_method": method, "nn_params": params, "miou": miou, "launches": n,
                           "forms": forms, "wall_s": wall, "phases": timer.summary()}
            print(f"  {label} ({method}, {json.dumps(params)}): mIoU {miou:.6f}, launches by form "
                  f"{json.dumps(forms)}, wall {wall:.2f}s, phases {json.dumps(timer.summary())}",
                  flush=True)

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
    # probing per tile (the engine's step) and per query (ScaNN's semantics);
    # by ids, and by score (a row tied with the k-th counts as found)
    flat_vals, flat_idx = knn_topk(q, bank, 30)
    recall, s_recall = {}, {}
    for mode in ("tile", "query"):
        _, tree_idx, _ = tree.search_with_labels_pure(tree.device_state, q, 30, probe_mode=mode)
        recall[mode] = (tree_idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()
        s_recall[mode] = score_recall(tree_idx, q, bank, flat_vals[:, -1])
    print(f"  recall@30 of the tree ({N_PROBE} of {tree._n_leaves} leaves) against K1: "
          f"{recall['tile']:.4f} probing per tile, {recall['query']:.4f} per query; by score "
          f"{s_recall['tile']:.4f}, {s_recall['query']:.4f}", flush=True)
    tree_info = {"n_leaves": tree._n_leaves, "cap": tree._cap, "build_s": tree.build_seconds,
                 "recall_at_30_vs_k1": recall, "score_recall_at_30_vs_k1": s_recall}
    # recall@30 of each quantized or L2 run's backend, built on the same
    # bank, against K1's exact bf16 neighbours for the same (f32) queries:
    # what quantization costs in answers.
    qf = feats.reshape(-1, cfg.width).contiguous()
    for label, (method, params, bf16_bank, _) in QUANT_RUNS.items():
        ev.bf16_bank = bf16_bank
        ev._create_nn(30, method, **params)
        nn = ev.NN_algorithm
        _, idx, _ = nn.search_with_labels_pure(nn.device_state, qf, 30, **ev._search_opts)
        r = (idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()
        rs = score_recall(idx, q, bank, flat_vals[:, -1])
        runs[label]["recall_at_30_vs_k1_bf16"] = r
        runs[label]["score_recall_at_30_vs_k1_bf16"] = rs
        print(f"  recall@30 of {label} against K1's exact bf16 neighbours: {r:.4f} by ids, "
              f"{rs:.4f} by score", flush=True)
        del nn
    ev.NN_algorithm = None
    main_tree = (qp, lids, tree.bank, tree.leaf_valid, tree._cap)
    return runs, launches, {"K1": err_k1, "K2": err_k2}, tree_info, q, bank, main_tree


def _cli(label, argv, counters, kernel, idle, n_eval, runs, per_batch=1):
    """One `python -m hbird_tpu_torch.eval_cli` run in this process, its
    counts set to 0 before and read after: `kernel` must launch
    `per_batch` times (once per bank shard) per eval batch, `idle` never.
    Returns the run's --out summary."""
    from hbird_tpu_torch import eval_cli

    out = argv[argv.index("--out") + 1]
    reset_counts(counters)
    t0 = time.perf_counter()
    eval_cli.main(argv)
    wall = time.perf_counter() - t0
    n = {name: fn.launches for name, fn in counters.items()}
    forms = read_forms(counters)
    with open(out) as f:
        summary = json.load(f)
    want = n_eval * per_batch
    if n[kernel] != want or forms[kernel] != {"dot": want} or n[idle]:
        fail(f"entry point ({label}): launches by form {forms}, not {kernel} dot x {want}")
    if not (0.0 <= summary["miou"] <= 1.0):
        fail(f"entry point ({label}): mIoU {summary['miou']} not a finite value in [0, 1]")
    runs[label] = {"miou": summary["miou"], "launches": n, "forms": forms, "wall_s": wall,
                   "phases": summary["phases"]}
    print(f"  {label}: mIoU {summary['miou']:.6f}, launches {json.dumps(n)}, wall {wall:.2f}s, "
          f"phases {json.dumps(summary['phases'])}", flush=True)
    return summary


def _same_search(name, a, b, q):
    """Two trees give the same answers, bit for bit."""
    va, ia, la = a.search_with_labels_pure(a.device_state, q, 30, probe_mode="tile")
    vb, ib, lb = b.search_with_labels_pure(b.device_state, q, 30, probe_mode="tile")
    if not (torch.equal(va, vb) and torch.equal(ia, ib) and torch.equal(la, lb)):
        fail(f"{name}: the neighbours differ")


def clustered_windows(n_rows, window, d, seed):
    """A re-iterable stream of f32 unit rows around STREAM_CLUSTERS random
    directions, window by window on the card, each window from its own
    seeded generator: every pass gives the same rows."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    centres = torch.nn.functional.normalize(torch.randn(STREAM_CLUSTERS, d, generator=g, device=DEVICE), dim=1)

    def windows():
        for i, s in enumerate(range(0, n_rows, window)):
            n = min(window, n_rows - s)
            g = torch.Generator(device=DEVICE).manual_seed(seed + 1 + i)
            who = torch.randint(0, STREAM_CLUSTERS, (n,), generator=g, device=DEVICE)
            x = centres[who] + 0.3 / d ** 0.5 * torch.randn(n, d, generator=g, device=DEVICE)
            yield torch.nn.functional.normalize(x, dim=1)
    return windows


def peak_bytes(fn):
    """fn()'s result and the card's peak allocated bytes while it ran (None
    on the CPU rehearsal, where no device counts memory)."""
    if DEVICE != "cuda":
        return fn(), None
    sync()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated()


def streamed_build_at_scale():
    """Phase 8.5: the streamed tree build over a seeded stream of BIG_M
    clustered rows in windows of STREAM_WINDOW (no disk), and the in-memory
    build of the same bank (its f32 rows on the card, as the engine holds
    them): seconds and peak device memory of each."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops import ivf

    windows = clustered_windows(BIG_M, STREAM_WINDOW, DEPTH, seed=8)

    def stream():
        for w in windows():
            yield w.to(torch.bfloat16), None  # the store dtype, cast on the card

    t0 = time.perf_counter()
    parts, streamed_peak = peak_bytes(lambda: ivf.build_tree_streamed(stream, BIG_M, 512))
    streamed_s = time.perf_counter() - t0
    flat = torch.cat(list(windows()))
    t0 = time.perf_counter()
    tree, flat_peak = peak_bytes(lambda: NearestNeighborSearchApprox(flat, n_neighbors=30, use_tree=True,
                                                                      device=DEVICE))
    flat_s = time.perf_counter() - t0
    same = (parts["slots"] == tree.slots).float().mean().item()
    info = {"rows": BIG_M, "window_rows": STREAM_WINDOW, "n_leaves": parts["n_leaves"], "cap": parts["cap"],
            "streamed_s": streamed_s, "streamed_split_s": parts["build_seconds"],
            "streamed_peak_bytes": streamed_peak, "in_memory_s": flat_s,
            "in_memory_split_s": tree.build_seconds, "in_memory_peak_bytes": flat_peak,
            "flat_f32_bytes": flat.numel() * 4, "slabs_bytes": parts["ivf_bank"].numel() * 2,
            "centroids_equal": bool(torch.equal(parts["centroids"], tree.centroids)),
            "slots_equal_share": same}
    del flat, tree, parts
    if not (info["centroids_equal"] and same == 1.0):
        fail(f"the streamed build differs from the in-memory build: same centroids {info['centroids_equal']}, "
             f"same slots {same}")
    if DEVICE == "cuda" and not streamed_peak < flat_peak:
        fail(f"streamed build peak {streamed_peak} B is not under the in-memory build's {flat_peak} B")
    gib = (lambda b: "n/a" if b is None else f"{b / 2**30:.3f} GiB")
    print(f"  streamed build of {BIG_M} rows in windows of {STREAM_WINDOW}: {streamed_s:.2f}s "
          f"{json.dumps(rounded(info['streamed_split_s']))}, peak {gib(streamed_peak)}; in-memory build "
          f"(f32 bank {gib(info['flat_f32_bytes'])} on the card): {flat_s:.2f}s "
          f"{json.dumps(rounded(info['in_memory_split_s']))}, peak {gib(flat_peak)}; slabs "
          f"{gib(info['slabs_bytes'])}; same centroids {info['centroids_equal']}, same slots "
          f"{same:.6f}", flush=True)
    return info


def bank_build_memory(cfg, root):
    """Phase 8.6: peak device memory of the unbounded memory build over the
    bank's bytes, with the row count unknown (no dataset_size: the steps'
    slabs concatenated, the build before the repair) and known (written in
    place). The step is a patch-mean projection to the ViT's width: the
    ViT's own activations (its attention logits) would set the peak and
    hide the bank. A step's soft labels still pass through a (B, S, S, P, C)
    one-hot larger than this bank, so the builds run once over the fixture
    and once over BANK_MEMORY_EPOCHS augmentation epochs, a bank that many
    times larger beside the same step. The fixture's batches are decoded
    once and fed again each epoch: the peak does not depend on their
    pixels."""
    from hbird_tpu_torch import HbirdEvaluation
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import get_hbird_train_transforms
    from hbird_tpu_torch.models import FeatureExtractorSimple

    esr = INPUT // cfg.patch_size
    tr = get_hbird_train_transforms(INPUT, device_normalize=True)
    ds, _ = get_dataset("voc", root, BATCH, 0, tr, tr)
    random.seed(0)
    batches = list(ds.train_dataloader())
    proj = torch.randn(3, cfg.width, generator=torch.Generator(device=DEVICE).manual_seed(9), device=DEVICE)

    def patch_means(model, imgs):
        b, c, h, w = imgs.shape
        x = imgs.reshape(b, c, esr, h // esr, esr, w // esr).mean(dim=(3, 5))
        return x.permute(0, 2, 3, 1).reshape(b, esr * esr, c) @ proj, None

    fe = FeatureExtractorSimple(None, patch_means, eval_spatial_resolution=esr, d_model=cfg.width)
    out = {}
    for name, epochs in (("projection", 1), (f"projection x{BANK_MEMORY_EPOCHS}", BANK_MEMORY_EPOCHS)):
        for build, dataset_size in (("concatenated", None), ("in_place", ds.get_train_dataset_size())):
            base = torch.cuda.memory_allocated() if DEVICE == "cuda" else None
            ev, peak = peak_bytes(lambda: HbirdEvaluation(
                fe, batches, num_classes=ds.get_num_classes(), device=DEVICE, nn_method="faiss",
                augmentation_epoch=epochs, dataset_size=dataset_size, device_norm=tr["device_norm"]))
            bank = ev.feature_memory.numel() * 4 + ev.label_memory.numel() * 4
            out[f"{name} {build}"] = {"bank_bytes": bank, "peak_bytes": peak, "base_bytes": base,
                                      "peak_over_bank": None if peak is None else peak / bank,
                                      "growth_over_bank": None if peak is None else (peak - base) / bank}
            del ev
        a, b = out[f"{name} concatenated"], out[f"{name} in_place"]
        if DEVICE == "cuda":
            print(f"  memory_build peak / bank bytes ({name}, bank {a['bank_bytes'] / 2**20:.1f} MiB): "
                  f"concatenated {a['peak_over_bank']:.3f} (growth {a['growth_over_bank']:.3f}), in place "
                  f"{b['peak_over_bank']:.3f} (growth {b['growth_over_bank']:.3f})", flush=True)
    return out


def entry_point_path(gen_seed, q, scann_miou):
    """Phase 8: `python -m hbird_tpu_torch.eval_cli` (its `main`, in this
    process) at full width on phase 5's fixture, with the bank saved and
    reloaded; the streamed tree build at scale; the bank build's memory."""
    from hbird_tpu_torch.bank.io import load_memory
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    cfg = VIT_PRESETS[PRESET]
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
    n_eval = -(-FIXTURE["n_val"] // BATCH)
    runs, info = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = str(pathlib.Path(tmp) / "voc")
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
        f_dir, l_dir, t_dir = (str(pathlib.Path(tmp) / n) for n in ("feats.bankdir", "labels.bankdir",
                                                                    "index.treedir"))

        def argv(label, *flags):
            return ["--dataset-name", "voc", "--data-dir", root, "--model", PRESET, "--random-init",
                    "--seed", str(gen_seed), "--d-model", str(cfg.width), "--patch-size", str(cfg.patch_size),
                    "--input-size", str(INPUT), "--batch-size", str(BATCH), "--num-workers", "0",
                    "--n-neighbours", "30", "--device", DEVICE, "--log-level", "WARNING",
                    "--out", str(pathlib.Path(tmp) / f"{label}.json"), *flags]

        banks = ["--f-mem-p", f_dir, "--l-mem-p", l_dir]
        ivf_flags = ["--nn-method", "ivf"]
        # 1. the CLI builds and saves the bank (.bankdir); the same run as
        # phase 5's 'scann unbounded', so the same mIoU
        t0 = time.perf_counter()
        built = _cli("cli scann, save .bankdir", argv("built", *banks), counters, "knn_topk", "ivf_topk",
                     n_eval, runs)
        if built["miou"] != scann_miou:
            fail(f"the CLI's mIoU {built['miou']} is not phase 5's scann run's {scann_miou}")
        # 2. reloaded: nothing built, the same mIoU
        loaded = _cli("cli scann, --load-memory", argv("loaded", *banks, "--load-memory"), counters,
                      "knn_topk", "ivf_topk", n_eval, runs)
        # 3. ivf from the same .bankdirs: the streamed tree build on the card
        streamed = _cli("cli ivf, --load-memory (streamed build)", argv("streamed", *banks, *ivf_flags,
                                                                         "--load-memory"),
                        counters, "ivf_topk", "knn_topk", n_eval, runs)
        # 4. a .treedir: the built index saved, then reloaded
        tree_built = _cli("cli ivf, save .treedir", argv("tree_built", *ivf_flags, "--f-mem-p", t_dir),
                          counters, "ivf_topk", "knn_topk", n_eval, runs)
        tree_loaded = _cli("cli ivf, --load-memory .treedir", argv("tree_loaded", *ivf_flags, "--f-mem-p",
                                                                    t_dir, "--load-memory"),
                           counters, "ivf_topk", "knn_topk", n_eval, runs)
        info["cli_seconds"] = time.perf_counter() - t0
        for run, label in ((loaded, "cli scann, --load-memory"), (streamed, "cli ivf, --load-memory (streamed build)"),
                           (tree_loaded, "cli ivf, --load-memory .treedir")):
            if run["phases"]["memory_build"].get("items", 0) or "index_build" in run["phases"]:
                fail(f"{label} built its memory: phases {run['phases']}")
        if loaded["miou"] != built["miou"] or tree_loaded["miou"] != tree_built["miou"]:
            fail(f"reloaded runs differ: scann {built['miou']} -> {loaded['miou']}, "
                 f".treedir {tree_built['miou']} -> {tree_loaded['miou']}")

        # The saved bank and the trees, on the eval batch of phase 5.
        t0 = time.perf_counter()
        flat = load_memory(f_dir, device=DEVICE)
        labels = load_memory(l_dir, device=DEVICE)
        info["bankdir_load_s"] = time.perf_counter() - t0
        info["bankdir_bytes"] = sum(p.stat().st_size for d in (f_dir, l_dir) for p in pathlib.Path(d).iterdir())
        flat_bf16 = flat.to(torch.bfloat16)
        flat_vals, flat_idx = knn_topk(q, flat_bf16, 30)
        t0 = time.perf_counter()
        from_disk = NearestNeighborSearchApprox.from_bankdir(f_dir, l_dir, n_neighbors=30, device=DEVICE)
        sync()
        info["streamed_build_s"] = time.perf_counter() - t0
        info["streamed_split_s"] = from_disk.build_seconds
        _, tree_idx, _ = from_disk.search_with_labels_pure(from_disk.device_state, q, 30, probe_mode="tile")
        info["streamed_recall_at_30_vs_k1"] = (tree_idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()
        info["streamed_score_recall_at_30_vs_k1"] = score_recall(tree_idx, q, flat_bf16, flat_vals[:, -1])
        t0 = time.perf_counter()
        tree = NearestNeighborSearchApprox(flat, n_neighbors=30, use_tree=True, label_memory=labels, device=DEVICE)
        sync()
        info["in_memory_build_s"] = time.perf_counter() - t0
        # the streamed build is the in-memory build of the same bank
        for name in ("centroids", "slots", "bank", "labels"):
            if not torch.equal(getattr(from_disk, name), getattr(tree, name)):
                fail(f"the streamed build's {name} differ from the in-memory build's")
        t0 = time.perf_counter()
        tree.save_tree(str(pathlib.Path(tmp) / "direct.treedir"))
        info["treedir_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = NearestNeighborSearchApprox.load_tree(str(pathlib.Path(tmp) / "direct.treedir"), n_neighbors=30,
                                                     device=DEVICE)
        sync()
        info["treedir_load_s"] = time.perf_counter() - t0
        _same_search(".treedir round trip", tree, back, q)
        _same_search("the CLI's saved .treedir against a build of its bank",
                     tree, NearestNeighborSearchApprox.load_tree(t_dir, n_neighbors=30, device=DEVICE), q)
        print(f"  .bankdir ({info['bankdir_bytes'] / 2**20:.1f} MiB) loaded in {info['bankdir_load_s']:.3f}s; "
              f"streamed build from it {info['streamed_build_s']:.2f}s "
              f"{json.dumps(rounded(info['streamed_split_s']))} (in-memory {info['in_memory_build_s']:.2f}s, "
              f"the same tree); recall@30 against K1 {info['streamed_recall_at_30_vs_k1']:.4f} by ids, "
              f"{info['streamed_score_recall_at_30_vs_k1']:.4f} by score; .treedir saved in "
              f"{info['treedir_save_s']:.3f}s, loaded in {info['treedir_load_s']:.3f}s, neighbours bit for bit",
              flush=True)
        del flat, flat_bf16, labels, from_disk, tree, back
        t0 = time.perf_counter()
        info["bank_build_memory"] = bank_build_memory(cfg, root)
        info["bank_build_memory_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["streamed_at_scale"] = streamed_build_at_scale()
    info["streamed_at_scale_s"] = time.perf_counter() - t0
    launches = {name: sum(r["launches"][name] for r in runs.values()) for name in counters}
    return runs, launches, info


def score_recall(idx, q, bank, kth, chunk=4096):
    """Share of the returned rows `idx` (Q, k) whose exact score q·b (f32 on
    the stored bank) reaches the exact k-th score `kth` (Q,) within K1's
    tolerance: recall that counts a row tied with the k-th as found, which
    recall by ids does not (the fixture's bank holds large tie groups)."""
    qf = q.float()
    tol = RTOL * qf.norm(dim=1) * bank.float().norm(dim=1).max()
    hits = 0
    for i in range(0, q.shape[0], chunk):
        s = torch.einsum("qd,qkd->qk", qf[i:i + chunk], bank[idx[i:i + chunk]].float())
        hits += (s >= (kth[i:i + chunk] - tol[i:i + chunk])[:, None]).sum().item()
    return hits / idx.numel()


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
    """Phase 5, the flash path: hbird_evaluation with the ViT in bf16 and in
    f32, each with attention_impl='flash' against 'xla', the tokens of both
    on one val batch, and K3 on that batch's block-0 q, k, v."""
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
                      device=DEVICE, nn_method="scann")
        for dt in ("bf16", "f32"):
            mious = {}
            for impl, vit in vits.items():
                label = f"scann unbounded, {dt} ViT, attention_impl={impl!r}"
                timer = PhaseTimer()
                random.seed(0)
                reset_counts(counters)
                t0 = time.perf_counter()
                miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, timer=timer,
                                        bf16_model=dt == "bf16", **common)
                wall = time.perf_counter() - t0
                n = {name: fn.launches for name, fn in counters.items()}
                forms = read_forms(counters)
                want = expected if impl == "flash" else 0
                if n["flash_attention"] != want or forms["flash_attention"] != ({dt: want} if want else {}):
                    fail(f"{label}: K3 launched {forms['flash_attention']}, not {dt} x {want} "
                         f"({cfg.depth} blocks x {n_batches} forward batches)")
                if n["knn_topk"] < 1 or n["ivf_topk"]:
                    fail(f"{label}: launches {n}")
                if not (0.0 <= miou <= 1.0):
                    fail(f"{label}: mIoU {miou} not a finite value in [0, 1]")
                launches[f"{dt} {impl}"] = n
                mious[impl] = miou
                runs[label] = {"miou": miou, "launches": n, "forms": forms, "wall_s": wall,
                               "phases": timer.summary()}
                print(f"  {label}: mIoU {miou:.6f}, launches {json.dumps(n)} (K3 expected {expected} = "
                      f"{cfg.depth} blocks x {n_batches} forward batches), wall {wall:.2f}s, "
                      f"phases {json.dumps(timer.summary())}", flush=True)
            print(f"  {dt} ViT: mIoU 'flash' - 'xla' {mious['flash'] - mious['xla']:.3g}", flush=True)
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
        blk = vit.blocks[0]
        scale = cfg.head_dim**-0.5
        err_k3 = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            x = vit._embed(imgs, dtype)
            y = _layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
            b, n, _ = y.shape
            qkv = _linear(y, blk.attn.qkv).reshape(b, n, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            err_k3 = max(err_k3, check_flash(
                f"K3 {str(dtype)[6:]}, main path's block-0 q, k, v {tuple(q.shape)} (strided views)",
                flash_attention(q, k, v, scale), flash_attention_plain(q, k, v, scale)))
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
    # (nn_method, model, nn_params, bf16_bank, soft labels held to SMALL_TOL)
    cases = {"scann": ("scann", vit, None, False, True), "faiss": ("faiss", vit, None, False, True),
             "ivf": ("ivf", vit, full_probe, False, True),
             "faiss, flash ViT": ("faiss", flash_vit, None, False, True)}
    # The quantized and L2 runs are held to the mIoU alone: int8 rounding
    # turns ulp-level feature differences between the devices into code
    # flips that move a near-tied neighbour.
    for label, (method, params, bf16_bank, _) in QUANT_RUNS.items():
        params = dict(params, **full_probe) if method == "ivf" else params
        cases[label] = (method, vit, params, bf16_bank, False)
    with tempfile.TemporaryDirectory() as root:
        make_voc_fixture(root, seed=3, colorize=True, class_pool=[1, 2, 3, 4, 5], **SMALL_FIXTURE)
        for label, (nn_method, model, params, bf16_bank, hold_labels) in cases.items():
            out = {}
            for device in (DEVICE, "cpu"):
                random.seed(1234)
                before = flash_attention.launches
                out[device] = hbird_evaluation(
                    copy.deepcopy(model), 64, 4, "voc", root, batch_size=4, input_size=32,
                    n_neighbours=5, nn_method=nn_method, num_workers=0, device=device,
                    nn_params=dict(params) if params else None, bf16_bank=bf16_bank,
                    return_knn_details=True)
                if device == DEVICE and model is flash_vit and flash_attention.launches == before:
                    fail(f"small input, {label}: K3 never launched on the card")
            (miou, det), (cpu_miou, cpu_det) = out[DEVICE], out["cpu"]
            label_err = float(abs(det["knns_ca_labels"] - cpu_det["knns_ca_labels"]).max())
            if not abs(miou - cpu_miou) <= SMALL_TOL:
                fail(f"small input, {label}: mIoU {miou} on the card, {cpu_miou} on the CPU")
            if hold_labels and not label_err <= SMALL_TOL:
                fail(f"small input, {label}: soft labels differ by {label_err}")
            result[label] = {"miou": miou, "cpu_miou": cpu_miou, "label_err": label_err}
            print(f"  {label}: mIoU {miou:.6f} (CPU {cpu_miou:.6f}), "
                  f"soft labels max |err| {label_err:.3g}", flush=True)
    return result


def _topk_agree(va, ia, vb, ib, tol):
    """Per query: values (sorted) within `tol` and the same ids strictly
    above the k-th value + tol on both sides (ties at the k-th may swap)."""
    close = ((va - vb).abs() <= tol[:, None]) | (torch.isinf(va) & torch.isinf(vb))
    sets = []
    for v, i in ((va, ia), (vb, ib)):
        above = v > v[:, -1:] + tol[:, None]
        sets.append(torch.sort(torch.where(above, i, -1), 1).values)
    return close.all(1) & (sets[0] == sets[1]).all(1)


def backends_card_vs_cpu():
    """Phase 6: each quantized or L2 backend, built on the card and on the
    CPU from the same float bank, stores the same codes and scales and
    returns the same neighbours for the same queries. int8 x int8 searches
    are exact, so their values and ids must be equal; asymmetric, reranked
    and l2 scores are f32 sums in another order, held to RTOL. Anisotropic
    codes may differ on rows whose two candidate losses nearly tie (at most
    ANISO_CODE_FLIPS of the rows); queries that meet such a row are left out."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact

    gen = torch.Generator().manual_seed(7)
    x = clustered_bank(6000, 64, 8, gen, device="cpu")
    q = x[:700] + 0.05 / 8 * torch.randn(700, 64, generator=gen)
    result = {}
    for label, (method, params, bf16_bank, (_, form)) in QUANT_RUNS.items():
        cls = NearestNeighborSearchExact if method == "faiss" else NearestNeighborSearchApprox
        kw = dict(params, n_neighbors=30, use_fp16=bf16_bank or cls is NearestNeighborSearchApprox)
        if method == "ivf":
            kw.update(use_tree=True, num_leaves=SMALL_LEAVES, num_leaves_to_search=SMALL_LEAVES)
        nns = {dev: cls(x.to(dev), device=dev, **kw) for dev in (DEVICE, "cpu")}
        rows, out = {}, {}
        for dev, nn in nns.items():
            state = nn.device_state
            order = state["slots"] if getattr(nn, "use_tree", False) else torch.arange(x.shape[0])
            rows[dev] = {name: state[name][order.to(dev)].cpu() if name in ("bank", "bank_row_scale")
                         else state[name].cpu() for name in ("bank", "bank_row_scale", "bank_scale",
                                                             "bank_col_scale") if name in state}
            opts = {"probe_mode": "tile"} if getattr(nn, "use_tree", False) else {}
            v, i, _ = nn.search_with_labels_pure(state, q.to(dev), 30, **opts)
            out[dev] = (v.cpu(), i.cpu())
        card, host = rows[DEVICE], rows["cpu"]
        if set(card) != set(host) or any(not torch.equal(card[n], host[n]) for n in card if n != "bank"):
            fail(f"backends, {label}: scales differ between the card and the CPU")
        flipped = (card["bank"] != host["bank"]).reshape(x.shape[0], -1).any(1)
        aniso = "anisotropic_quantization_threshold" in params
        if flipped.float().mean().item() > (ANISO_CODE_FLIPS if aniso else 0.0):
            fail(f"backends, {label}: {int(flipped.sum())} rows with other codes")
        (cv, ci), (hv, hi) = out[DEVICE], out["cpu"]
        exact = form in ("int8", "int8_rows") and "num_reordering_candidates" not in params
        if exact:
            if not (torch.equal(cv, hv) and torch.equal(ci, hi)):
                fail(f"backends, {label}: exact int8 search differs between the card and the CPU")
            n_bad, n_left = 0, 0
        else:
            deq = nns["cpu"].gather_features_pure(nns["cpu"].device_state, torch.arange(x.shape[0]))
            tol = RTOL * q.norm(dim=1) * deq.float().norm(dim=1).max()
            keep = ~(flipped[ci].any(1) | flipped[hi].any(1))
            agree = _topk_agree(cv, ci, hv, hi, tol)
            n_bad, n_left = int((keep & ~agree).sum()), int((~keep).sum())
            if n_bad:
                fail(f"backends, {label}: {n_bad} queries with other neighbours or values")
        result[label] = {"code_rows_differ": int(flipped.sum()), "exact": exact,
                         "queries_left_out": n_left}
        print(f"  backend {label}: codes and scales match ({int(flipped.sum())} of {x.shape[0]} rows "
              f"differ), neighbours {'bit-exact' if exact else 'agree'} "
              f"({n_left} queries left out)", flush=True)
    return result


def ivf_library(qp, bank, lids, lv, k, cap, block_q, chunk=8, row_scale=None):
    """The library yardstick for K2: each tile's probed slabs gathered, then
    torch.bmm (int8 x int8: torch._int_mm per tile; int8 codes under bf16
    queries: widened to bf16 as gathered), times the row scales when given,
    + torch.topk, chunked over tiles."""
    n_tiles, n_probe = lids.shape
    d = bank.shape[1]
    bank3 = bank.view(-1, cap, d)
    rs3 = None if row_scale is None else row_scale.reshape(-1, cap)
    col = torch.arange(cap, device=bank.device)
    for t0 in range(0, n_tiles, chunk):
        ids = lids[t0:t0 + chunk].long()
        c = ids.shape[0]
        slabs = bank3[ids].reshape(c, n_probe * cap, d)
        qc = qp[t0 * block_q:(t0 + c) * block_q].view(c, block_q, d)
        if qp.dtype == torch.int8:
            s = torch.stack([torch._int_mm(qc[i], slabs[i].t()) for i in range(c)]).float()
        else:
            s = torch.bmm(qc, slabs.to(qc.dtype).transpose(1, 2))
        if rs3 is not None:
            s = s.float() * rs3[ids].reshape(c, 1, n_probe * cap)
        mask = (col < lv.long()[ids][:, :, None]).reshape(c, 1, n_probe * cap)
        torch.topk(s.masked_fill_(~mask, float("-inf")), k, dim=2)


def library_ms(fn, reps, label):
    """`cuda_ms` of a library yardstick, or None (printed) where the
    installed PyTorch refuses it."""
    try:
        return cuda_ms(fn, reps)
    except RuntimeError as e:
        print(f"  {label}: library yardstick refused ({str(e).splitlines()[0][:160]})", flush=True)
        return None


def fmt_ms(t):
    return "n/a" if t is None else f"{t:.3f} ms"


def k1_library(q, bb, k, neg_bias=None, chunk=4096):
    """K1's library yardstick, chunked over the queries: a bf16 matmul (or
    torch.addmm with the negated l2 bias), then torch.topk."""
    for s in range(0, q.shape[0], chunk):
        x = q[s:s + chunk]
        torch.topk(x @ bb.T if neg_bias is None else torch.addmm(neg_bias, x, bb.T), k, dim=1)


def int8_library(q8, codes, k, rs=None, chunk=2048):
    """K1 int8's library yardstick, chunked over the queries:
    torch._int_mm, times the row scales `rs` when given, then torch.topk."""
    for s in range(0, q8.shape[0], chunk):
        x = torch._int_mm(q8[s:s + chunk], codes.t())
        torch.topk(x if rs is None else x.float() * rs, k, dim=1)


def k1_form_rows(q, bb, label, k, reps, rows, errs):
    """Phase 7: K1's forms (b)-(e) and f32 on the bank `bb` (bf16) and the
    queries `q` (bf16; f32: both widened): each timed beside its plain
    version, its bound and a library yardstick (int8: torch._int_mm + topk;
    row scales applied to its f32 result; asymmetric: a bf16 matmul against
    the codes widened to bf16 once; l2: torch.addmm with the bias; f32: an
    f32 matmul, TF32 off). The int8 forms at each k of INT8_KS (the
    engine's k and `faiss` int8 + reorder's scan), the others at `k`."""
    from hbird_tpu_torch.ops.knn import exact_knn, l2_bias
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    n_q, d = q.shape
    m = bb.shape[0]
    q8 = quantize_queries_int8(q)[0]
    codes_g = quantize_bank_int8(bb, per_row=False)[0]
    codes_r, scale = quantize_bank_int8(bb, per_row=True)
    rs = scale.reshape(-1)
    wide, wide_g = codes_r.to(torch.bfloat16), codes_g.to(torch.bfloat16)
    neg_bias = (-l2_bias(bb)).to(torch.bfloat16)
    q32, b32 = q.float(), bb.float()
    chunk = 2048

    def asym_mm(widened, scale_rows):
        for s in range(0, n_q, chunk):
            x = q[s:s + chunk] @ widened.T
            torch.topk(x if scale_rows is None else x.float() * scale_rows, k, dim=1)

    forms = {
        # form: (queries, bank, row_scale, distance, exact, library, bytes of q / bank row, peak, ks)
        "int8": (q8, codes_g, None, "dot_product", True, lambda: int8_library(q8, codes_g, k, None, chunk),
                 1, 1, 0, PEAK_INT8_OPS, INT8_KS),
        "int8_rows": (q8, codes_r, rs, "dot_product", True, lambda: int8_library(q8, codes_r, k, rs, chunk),
                      1, 1, 4, PEAK_INT8_OPS, INT8_KS),
        "asym_rows": (q, codes_r, rs, "dot_product", False, lambda: asym_mm(wide, rs), 2, 1, 4,
                      PEAK_BF16_FLOPS, (k,)),
        "asym": (q, codes_g, None, "dot_product", False, lambda: asym_mm(wide_g, None), 2, 1, 0,
                 PEAK_BF16_FLOPS, (k,)),
        "l2": (q, bb, None, "l2", False, lambda: k1_library(q, bb, k, neg_bias, chunk), 2, 2, 0,
               PEAK_BF16_FLOPS, (k,)),
        "f32": (q32, b32, None, "dot_product", False, lambda: k1_library(q32, b32, k, None, chunk), 4, 4, 0,
                PEAK_F32_FLOPS, (k,)),
    }
    base_k = k
    for form, (qq, b, r, dist, exact, lib, qbytes, bbytes, rbytes, peak, ks) in forms.items():
        for k in ks:
            kw = dict(distance=dist, row_scale=r)
            name = form if k == base_k else f"{form} k={k}"
            ms = cuda_ms(lambda: knn_topk(qq, b, k, **kw), reps)
            out = knn_topk(qq, b, k, **kw)
            box = {}
            plain_ms = cuda_ms(lambda: box.update(out=exact_knn(qq, b, k + 1, **kw)), 1)
            errs["K1"] = max(errs["K1"], check_against_plain(
                f"K1 timing shape {name} {label}", qq, b, k, m, out, box.pop("out"), exact=exact, **kw))
            lib_ms = library_ms(lib, reps, f"K1 {name} {label}")
            b_ms, b_by = bound_ms(n_q, m, d, k, qbytes, peak, bank_bytes=bbytes, row_bytes=rbytes)
            rows[f"{name} {label}"] = {"form": form, "Q": n_q, "M": m, "D": d, "k": k, "ms": ms,
                                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                       "library_ms": lib_ms}
            print(f"  K1 {name} {label}: Q={n_q} M={m} D={d} k={k}: {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"(k+1), library {fmt_ms(lib_ms)}, bound {b_ms:.3f} ms ({b_by})"
                  + (f": {shares(ms, b_ms, lib_ms)}" if not form.startswith("asym") else ""), flush=True)


def select_load(scores, k, groups):
    """What reaches a top-k select: the running top-k sets walk the bank's
    128-row tiles in the orders `groups` (one list of tile indices per set),
    and a (query, tile) pair counts when some score of the tile beats the
    set's k-th score at the tile's start (ties do not: a tied later row has
    the higher index). Returns (share of the pairs that count, scores above
    the k-th per query and tile). `scores` (Q, M) f32."""
    hit = above = pairs = 0
    for group in groups:
        top = torch.full((scores.shape[0], k), float("-inf"), device=scores.device)
        for t in group:
            tile = scores[:, 128 * t:128 * (t + 1)]
            n = (tile > top[:, -1:]).sum(1)
            hit += int((n > 0).sum())
            above += int(n.sum())
            pairs += scores.shape[0]
            top = torch.topk(torch.cat([top, tile], 1), k, dim=1).values
    return hit / pairs, above / pairs


def batched_load(scores, k, groups, flush_at=32, buf=160):
    """The batched select's work on these scores: each partial set (one list
    of tile indices per set) buffers the scores above its minimum as of its
    last merge, and merges its buffer once it holds `flush_at` (and at its
    end) into its top-P set (P = 32·S, 128 at S = 3). Without the minimum
    the sets share, and with ties counted as above, so an upper bound.
    Returns (scores buffered per (query, tile) pair, merges per query and
    set, 32-score chunks merged per query and set)."""
    s = -(-k // 32)
    p = 32 * (4 if s == 3 else s)
    n_q = scores.shape[0]
    buffered = merges = chunks = pairs = 0
    for group in groups:
        top = torch.full((n_q, p), float("-inf"), device=scores.device)
        pend = torch.full((n_q, buf), float("-inf"), device=scores.device)
        cnt = torch.zeros(n_q, dtype=torch.long, device=scores.device)

        def merge(rows):
            nonlocal merges, chunks
            merges += int(rows.numel())
            chunks += int(((cnt[rows] + 31) // 32).sum())
            top[rows] = torch.topk(torch.cat([top[rows], pend[rows]], 1), p, dim=1).values
            pend[rows] = float("-inf")
            cnt[rows] = 0

        for t in group:
            tile = scores[:, 128 * t:128 * (t + 1)]
            mask = tile > top[:, -1:]
            pos = cnt[:, None] + torch.cumsum(mask, 1) - 1
            r, c = mask.nonzero(as_tuple=True)
            pend[r, pos[r, c]] = tile[r, c]
            cnt += mask.sum(1)
            buffered += int(mask.sum())
            pairs += n_q
            merge((cnt >= flush_at).nonzero(as_tuple=True)[0])
        merge((cnt > 0).nonzero(as_tuple=True)[0])
    sets = len(groups) * n_q
    return buffered / pairs, merges / sets, chunks / sets


def k1_select_rows(q, bank, chunk=2048):
    """Phase 7: the select's load on the main path's bank, K1 int8 (global
    codes) at k = 30 and 120: the share of (query, tile) pairs with a score
    above the running k-th, for one set per query over the whole bank in
    order (mma_scan) and for the wgmma kernel's partial sets (per bank
    split of its plan, consumer w taking tiles w, w + 2, ...; without the
    minimum the sets share, so an upper bound for them)."""
    from hbird_tpu_torch.ops import knn_cuda
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    q8 = quantize_queries_int8(q.float())[0]
    codes = quantize_bank_int8(bank.float(), per_row=False)[0]
    m = codes.shape[0]
    tiles = -(-m // 128)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count if DEVICE == "cuda" else 132
    rows = {}
    for k in INT8_KS:
        split_rows, splits = knn_cuda.plan_splits(q8.shape[0], m, n_sm, k)
        per = split_rows // 128
        orders = {"one set over the bank (mma_scan)": [list(range(tiles))],
                  f"wgmma partial sets ({splits} splits x 2)": [
                      list(range(s * per + w, min(tiles, (s + 1) * per), 2))
                      for s in range(splits) for w in range(2)]}
        for scheme, groups in orders.items():
            hit = above = buffered = merges = merged = 0.0
            for s in range(0, q8.shape[0], chunk):
                x = q8[s:s + chunk]
                scores = (torch._int_mm(x, codes.t()) if DEVICE == "cuda"
                          else x.int() @ codes.int().t()).float()
                h, a = select_load(scores, k, groups)
                hit += h * x.shape[0]
                above += a * x.shape[0]
                if scheme.startswith("wgmma"):
                    bu, me, ch = batched_load(scores, k, groups)
                    buffered += bu * x.shape[0]
                    merges += me * x.shape[0]
                    merged += ch * x.shape[0]
            n = q8.shape[0]
            row = rows[f"int8 k={k}, {scheme}"] = {"rows_above_kth": hit / n, "scores_above_kth": above / n}
            print(f"  K1 select load, int8 k={k}, {scheme}: {hit / n:.4f} of (query, tile) "
                  f"pairs hold a score above the running k-th, {above / n:.3f} such scores "
                  f"per pair", flush=True)
            if scheme.startswith("wgmma"):
                row.update(batched_buffered_per_pair=buffered / n, batched_merges_per_set=merges / n,
                           batched_chunks_per_set=merged / n)
                print(f"  K1 batched select, int8 k={k}, {scheme}: {buffered / n:.3f} scores buffered per "
                      f"(query, tile) pair, {merges / n:.2f} merges and {merged / n:.2f} 32-score chunks "
                      f"per query and set (upper bounds: no shared minimum)", flush=True)
    return rows


def k2_form_rows(qp, lids, tb, lv, cap, label, k, reps, rows, errs):
    """Phase 7: K2's other forms on the tree's slabs, probed as the bf16
    tree is: int8_rows and asym_rows on per-row int8 codes (padding slots
    scale 0), int8 and asym on global-scale codes, f32 on the slabs in f32;
    each timed beside the plain version, the bound and the library
    yardstick."""
    from hbird_tpu_torch.ops.ivf import ivf_search_plain
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    d = tb.shape[1]
    codes, scale = quantize_bank_int8(tb, per_row=True)
    slot = torch.arange(tb.shape[0], device=tb.device)
    rs = torch.where(slot % cap < lv.long().repeat_interleave(cap), scale.reshape(-1), 0.0)
    codes_g = quantize_bank_int8(tb, per_row=False)[0]
    q8 = quantize_queries_int8(qp)[0]
    forms = (  # form, queries, slabs, row scales, exact, bytes of q / slab row / row scale, peak
        ("int8_rows", q8, codes, rs, True, 1, 1, 4, PEAK_INT8_OPS),
        ("asym_rows", qp, codes, rs, False, 2, 1, 4, PEAK_BF16_FLOPS),
        ("int8", q8, codes_g, None, True, 1, 1, 0, PEAK_INT8_OPS),
        ("asym", qp, codes_g, None, False, 2, 1, 0, PEAK_BF16_FLOPS),
        ("f32", qp.float(), tb.float(), None, False, 4, 4, 0, PEAK_F32_FLOPS),
    )
    for form, qq, sb, r, exact, qbytes, bbytes, rbytes, peak in forms:
        ms = cuda_ms(lambda: ivf_topk(qq, sb, lids, lv, k, cap=cap, block_q=BLOCK_Q, row_scale=r), reps)
        out = ivf_topk(qq, sb, lids, lv, k, cap=cap, block_q=BLOCK_Q, row_scale=r)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(
            out=ivf_search_plain(qq, sb, lids, lv, k + 1, cap=cap, row_scale=r)), 1)
        errs["K2"] = max(errs["K2"], check_ivf_against_plain(
            f"K2 timing shape {form} {label}", qq, sb, lids, lv, k, cap, BLOCK_Q, out, box.pop("out"),
            row_scale=r, exact=exact))
        lib_ms = library_ms(lambda: ivf_library(qq, sb, lids, lv, k, cap, BLOCK_Q, row_scale=r),
                            reps, f"K2 {form} {label}")
        b_ms, b_by = ivf_bound_ms(qq.shape[0], lids, lv, d, k, qbytes, peak, bank_bytes=bbytes, row_bytes=rbytes)
        rows[f"{form} {label}"] = {"form": form, "Q": qq.shape[0], "slots": codes.shape[0], "cap": cap,
                                   "n_probe": lids.shape[1], "block_q": BLOCK_Q, "D": d, "k": k, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "library_ms": lib_ms}
        print(f"  K2 {form} {label}: Q={qq.shape[0]} slots={codes.shape[0]} cap={cap}: {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms (k+1), library {fmt_ms(lib_ms)}, bound {b_ms:.3f} ms ({b_by})",
              flush=True)


def timing(q, bank, main_tree, gen):
    """Phase 7: K1 and K2 vs plain vs the library yardsticks at two sizes."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import ivf_search_plain, tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn import exact_knn
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

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
        lib_ms = cuda_ms(lambda: k1_library(q, bb, k), reps)
        b_ms, b_by = bound_ms(n_q, m, d, k, 2, PEAK_BF16_FLOPS)
        k1_rows[label] = {"Q": n_q, "M": m, "D": d, "k": k, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"  K1 {label}: Q={n_q} M={m} D={d} k={k}: {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"(k+1), library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}): "
              f"{shares(ms, b_ms, lib_ms)}", flush=True)
        k1_form_rows(q, bb, label, k, reps, k1_rows, errs)

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
        k2_form_rows(qp, lids, tb, lv, cap, label, k, reps, k2_rows, errs)
    return k1_rows, k2_rows, errs


def flash_timing(gen):
    """Phase 7: K3 at the main shape, bf16 and f32, vs its bound, its plain
    version and scaled_dot_product_attention (a yardstick the port never
    calls). f32's bound is its work at f32 accuracy on the tensor cores
    (3 TF32 passes at the TF32 peak); the f32 FMA bound stands beside it."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    rows, errs = {}, []
    for label, shape, dtype in (("main", FLASH_MAIN, torch.bfloat16), ("f32", FLASH_MAIN, torch.float32),
                                ("long", FLASH_LONG, torch.bfloat16), ("hd32", FLASH_NARROW, torch.bfloat16),
                                ("hd80", FLASH_WIDE, torch.bfloat16)):
        scale = shape[-1] ** -0.5
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
        ms = cuda_ms(lambda: flash_attention(q, k, v, scale), 10)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(out=flash_attention_plain(q, k, v, scale)), 3)
        errs.append(check_flash(f"K3 timing shape {str(dtype)[6:]} {shape}",
                                flash_attention(q, k, v, scale), box.pop("out")))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale), 10)
        b_ms, b_by = k3_bound(shape, dtype)
        rows[label] = {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        extra = ""
        if dtype == torch.float32:
            rows[label]["fma_bound_ms"] = flash_bound_ms(shape, 4, PEAK_F32_FLOPS)[0]
            extra = f", f32 FMA bound {rows[label]['fma_bound_ms']:.4f} ms"
        print(f"  K3 {str(dtype)[6:]} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}{', 3xTF32' if extra else ''}){extra}: "
              f"{shares(ms, b_ms, lib_ms)}", flush=True)
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


def pairs(tree):
    """--pairs: the Hopper-redesigned kernels of the imported package (K3
    bf16 and f32, K1 bf16 dot and l2, int8 and int8_rows, K2 bf16 and
    asym_rows) timed alone by CUDA events, each beside its bound and its
    library call; returns the JSON-ready result."""
    import hbird_tpu_torch
    from hbird_tpu_torch.ops import cuda_build
    from hbird_tpu_torch.ops.flash_cuda import flash_attention
    from hbird_tpu_torch.ops.knn import l2_bias
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        cuda_build.build_all()
    out = {"tree": tree, "package": str(pathlib.Path(hbird_tpu_torch.__file__).parent),
           "build_s": time.perf_counter() - t0, "k3": {}, "k1": {}, "k2": {}}
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def record(kernel, label, ms, shape_bound, library):
        b_ms, b_by = shape_bound
        out[kernel][label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library}
        print(f"  [{tree}] {kernel.upper()} {label}: {ms:.4f} ms, library {fmt_ms(library)}, bound "
              f"{b_ms:.4f} ms: {shares(ms, b_ms, library)}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        for shape in (FLASH_MAIN, FLASH_LONG):
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
            scale = shape[-1] ** -0.5
            ms = cuda_ms(lambda: flash_attention(q, k, v, scale), 20)
            lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale), 20)
            record("k3", f"{'bf16' if dtype == torch.bfloat16 else 'f32'} {shape}", ms, k3_bound(shape, dtype), lib)
            del q, k, v
    q = torch.randn(PAIR_Q, DEPTH, generator=gen, device=DEVICE).bfloat16()
    q8 = quantize_queries_int8(q.float())[0]
    for m in (PAIR_M, BIG_M):
        bank = torch.nn.functional.normalize(
            torch.randn(m, DEPTH, generator=gen, device=DEVICE), dim=1).bfloat16()
        neg_bias = (-l2_bias(bank)).bfloat16()
        reps = 5 if m < 200_000 else 2
        codes_g = quantize_bank_int8(bank, per_row=False)[0]
        codes_r, scale = quantize_bank_int8(bank, per_row=True)
        rs = scale.reshape(-1).float().contiguous()
        for k in PAIR_KS:
            bound = bound_ms(PAIR_Q, m, DEPTH, k, 2, PEAK_BF16_FLOPS)
            for form, kw, nb in (("dot", {}, None), ("l2", {"distance": "l2"}, neg_bias)):
                ms = cuda_ms(lambda: knn_topk(q, bank, k, **kw), reps)
                lib = cuda_ms(lambda: k1_library(q, bank, k, nb), reps)
                record("k1", f"bf16 {form} Q={PAIR_Q} M={m} k={k}", ms, bound, lib)
            for form, codes, r in (("int8", codes_g, None), ("int8_rows", codes_r, rs)):
                bound = bound_ms(PAIR_Q, m, DEPTH, k, 1, PEAK_INT8_OPS, row_bytes=0 if r is None else 4)
                ms = cuda_ms(lambda: knn_topk(q8, codes, k, row_scale=r), reps)
                lib = library_ms(lambda: int8_library(q8, codes, k, r), reps, f"K1 {form}")
                record("k1", f"{form} Q={PAIR_Q} M={m} k={k}", ms, bound, lib)
        del codes_g, codes_r, rs, neg_bias
        pairs_k2(q, bank, f"M={m}", record, 5 if m < 200_000 else 3)
        del bank
    return out


def pairs_k2(q, bank, label, record, reps):
    """--pairs, K2: a tree of `bank` (the tree's defaults: 512 leaves),
    `q` grouped into 256-query tiles probing 32 leaves each, k = 30; bf16
    and asym_rows (the slabs as per-row int8 codes, padding slots scale
    0)."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8

    k = 30
    tree = NearestNeighborSearchApprox(bank, n_neighbors=k, use_tree=True, device=DEVICE)
    tb, lv, cap = tree.bank, tree.leaf_valid, tree._cap
    qp, lids, _ = tile_probe_inputs(q, tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    del tree
    codes, scale = quantize_bank_int8(tb, per_row=True)
    slot = torch.arange(tb.shape[0], device=tb.device)
    rs = torch.where(slot % cap < lv.long().repeat_interleave(cap), scale.reshape(-1), 0.0)
    shape = f"Q={qp.shape[0]} slots={tb.shape[0]} cap={cap} n_probe={N_PROBE}"
    for form, b, r, bank_bytes in (("bf16", tb, None, 2), ("asym_rows", codes, rs, 1)):
        bound = ivf_bound_ms(qp.shape[0], lids, lv, DEPTH, k, 2, PEAK_BF16_FLOPS,
                             bank_bytes=bank_bytes, row_bytes=0 if r is None else 4)
        ms = cuda_ms(lambda: ivf_topk(qp, b, lids, lv, k, cap=cap, block_q=BLOCK_Q, row_scale=r), reps)
        lib = cuda_ms(lambda: ivf_library(qp, b, lids, lv, k, cap, BLOCK_Q, row_scale=r), reps)
        record("k2", f"{form} {label} {shape}", ms, bound, lib)


def native_feed(gen_seed, folder_run):
    """Phase 9.1: the native tar index (utils/native.py, built with g++)
    against tarfile on an uncompressed VOC tar of phase 5's fixture, and
    phase 5's unbounded 'scann' run fed from that tar (`folder_run` is the
    same run fed from the folder): the same mIoU."""
    import tarfile

    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.backend import TarBackend
    from hbird_tpu_torch.data.synthetic import folder_to_tar, make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS, ViT
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.utils import native
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    info = {}
    t0 = time.perf_counter()
    cached = native.library_path().exists()
    native.build()
    info["gxx_s"] = time.perf_counter() - t0
    print(f"  native library {native.library_path().name}: g++ {info['gxx_s']:.2f}s"
          f"{' (already built)' if cached else ''}", flush=True)
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, tar = str(pathlib.Path(tmp) / "voc"), str(pathlib.Path(tmp) / "voc.tar")
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
        folder_to_tar(root, tar, "VOCSegmentation")
        info["tar_bytes"] = pathlib.Path(tar).stat().st_size
        t0 = time.perf_counter()
        entries = native.tar_index(tar)
        info["native_index_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tarfile.open(tar) as t:
            members = [m for m in t.getmembers() if m.isfile()]
        info["tarfile_index_s"] = time.perf_counter() - t0
        regular = [name for name, _, _, tf in entries if tf in ("0", "\x00")]
        if sorted(regular) != sorted(m.name for m in members):
            fail("the native tar index lists other members than tarfile")
        backend = TarBackend(tar)
        if backend._index is None:
            fail("TarBackend did not take the native index for an uncompressed tar")
        t0 = time.perf_counter()
        native_bytes = {m: backend.read(m) for m in backend.members}
        info["native_read_s"] = time.perf_counter() - t0
        backend.close()
        t0 = time.perf_counter()
        with tarfile.open(tar) as t:
            tar_bytes = {m.name: t.extractfile(m).read() for m in members}
        info["tarfile_read_s"] = time.perf_counter() - t0
        if native_bytes != tar_bytes:
            fail("the native reads differ from tarfile's bytes")
        info["members"] = len(regular)
        print(f"  {len(regular)} members ({info['tar_bytes'] / 2**20:.1f} MiB): index native "
              f"{info['native_index_s'] * 1e3:.2f} ms vs tarfile {info['tarfile_index_s'] * 1e3:.2f} ms; "
              f"every member read native (pread) {info['native_read_s'] * 1e3:.2f} ms vs tarfile "
              f"{info['tarfile_read_s'] * 1e3:.2f} ms; lists and bytes equal", flush=True)
        cfg = VIT_PRESETS[PRESET]
        vit = ViT(cfg, generator=torch.Generator().manual_seed(gen_seed))
        timer = PhaseTimer()
        random.seed(0)
        reset_counts(counters)
        t0 = time.perf_counter()
        miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", tar, nn_method="scann", batch_size=BATCH,
                                input_size=INPUT, n_neighbours=30, num_workers=0, device=DEVICE, timer=timer)
        wall = time.perf_counter() - t0
        n = {name: fn.launches for name, fn in counters.items()}
        if n["knn_topk"] < 1 or n["ivf_topk"]:
            fail(f"scann fed from the tar: launches {n}")
        if miou != folder_run["miou"]:
            fail(f"scann fed from the tar: mIoU {miou}, from the folder {folder_run['miou']}")
        runs["scann unbounded, tar feed"] = {"miou": miou, "launches": n, "forms": read_forms(counters),
                                             "wall_s": wall, "phases": timer.summary()}
        info["memory_build_img_per_s"] = {
            "tar": timer.summary()["memory_build"]["items_per_sec"],
            "folder": folder_run["phases"]["memory_build"]["items_per_sec"]}
        print(f"  scann unbounded fed from the tar: mIoU {miou:.6f} (the folder's), memory_build img/s "
              f"{json.dumps(info['memory_build_img_per_s'])}, wall {wall:.2f}s", flush=True)
    return runs, info


def mesh_k1_cases(q, bank, gen, devices):
    """Phase 9.2: K1 over a ('bank',) mesh of len(devices) shards against
    unsharded K1, on the main bank and on a BIG_M-row bank, in bf16 dot,
    int8 + reorder 120 and int8_rows (k = 30), by 'gather' and 'ring'."""
    from hbird_tpu_torch.ops.knn import knn_with_labels
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
    from hbird_tpu_torch.parallel import make_mesh, ring_knn_with_labels, sharded_knn_with_labels
    from hbird_tpu_torch.parallel.sharded_knn import fetch_labels, merge_topk, shard_rows

    k, c_reorder, n = 30, 120, len(devices)
    mesh = make_mesh((n,), ("bank",), devices)
    strategies = {"gather": (sharded_knn_with_labels, n), "ring": (ring_knn_with_labels, n * n)}
    q32 = q.float()
    qc, _ = quantize_queries_int8(q32)
    tol = RTOL * q32.norm(dim=1).max().item()  # unit bank rows
    rows, err = {}, 0.0
    big = torch.nn.functional.normalize(
        torch.randn(BIG_M, bank.shape[1], generator=gen, device=DEVICE), dim=1).to(torch.bfloat16)
    for label, bb, reps in (("main", bank, 3), (f"bank_{BIG_M}", big, 2)):
        m = bb.shape[0]
        lab = torch.rand(m, 21, generator=gen, device=DEVICE)
        codes, g_scale = quantize_bank_int8(bb.float(), per_row=False)
        codes_r, r_scale = quantize_bank_int8(bb.float(), per_row=True)
        forms = {
            "dot": ((q, bb), {}, {}),
            "int8+reorder": ((qc, codes), {"rerank_bank": bb, "rerank_queries": q, "rerank_candidates": c_reorder},
                             {"rerank_bank": shard_rows(bb, mesh), "rerank_queries": q,
                              "rerank_candidates": c_reorder}),
            "int8_rows": ((qc, codes_r), {"row_scale": r_scale}, {"row_scale": shard_rows(r_scale, mesh)}),
        }
        del g_scale
        lab_s = shard_rows(lab, mesh)
        for form, ((qq, b), kw1, kwn) in forms.items():
            kernel_form = {"dot": "dot", "int8+reorder": "int8", "int8_rows": "int8_rows"}[form]
            b_s = shard_rows(b, mesh)
            v0, i0, l0 = knn_with_labels(qq, b, lab, k, **kw1)
            one_ms = cuda_ms(lambda: knn_with_labels(qq, b, lab, k, **kw1), reps)
            row = {"M": m, "Q": q.shape[0], "k": k, "shards": n, "unsharded_ms": one_ms}
            for strat, (fn, per_call) in strategies.items():
                before, before_form = knn_topk.launches, knn_topk.forms[kernel_form]
                v, i, lv = fn(qq, b_s, lab_s, k, mesh=mesh, valid_rows=m, **kwn)
                sync()
                if knn_topk.launches - before != per_call or knn_topk.forms[kernel_form] - before_form != per_call:
                    fail(f"mesh {label} {form} {strat}: {knn_topk.launches - before} launches "
                         f"({knn_topk.forms[kernel_form] - before_form} {kernel_form}), not {per_call}")
                name = f"mesh {label} {form} {strat}"
                if not torch.equal(lv, lab[i]):
                    fail(f"{name}: labels are not the winners' rows")
                if form == "int8_rows":
                    if not (torch.equal(v, v0) and torch.equal(i, i0) and torch.equal(lv, l0)):
                        fail(f"{name}: not bit for bit against unsharded K1")
                    e = 0.0
                elif form == "dot":
                    pv, pi = knn_topk(qq, b, k + 1)
                    e = _same_sets(name, v, i, pv, pi, k, torch.full_like(pv[:, 0], tol),
                                   (v - v0).abs().max().item(), False)
                    if (v - v0).abs().max().item() > tol:
                        fail(f"{name}: values differ from unsharded K1 by more than {tol}")
                else:  # each shard reorders its own candidates: a superset pool
                    e = max((torch.einsum("qd,qkd->qk", q32[c0 : c0 + 2048], bb[i[c0 : c0 + 2048]].float())
                             - v[c0 : c0 + 2048]).abs().max().item() for c0 in range(0, q.shape[0], 2048))
                    if e > 2 * tol:
                        fail(f"{name}: ids do not re-score to their values ({e})")
                    if ((v - v0) < -tol).any():
                        fail(f"{name}: sorted values below the unsharded run's")
                err = max(err, e)
                row[f"{strat}_ms"] = cuda_ms(lambda: fn(qq, b_s, lab_s, k, mesh=mesh, valid_rows=m, **kwn), reps)
                row[f"{strat}_launches_per_call"] = per_call
            # the gather's merge alone: n sets of k per query, then the labels
            cand_v = torch.cat([v0] * n, dim=1)
            cand_i = torch.cat([i0 + j * b_s[0].shape[0] for j in range(n)], dim=1)
            row["merge_ms"] = cuda_ms(lambda: merge_topk(cand_v, cand_i, k, index_ordered=True), reps)
            row["label_fetch_ms"] = cuda_ms(lambda: fetch_labels(i0, lab_s), reps)
            row["merge_share_of_gather"] = (row["merge_ms"] + row["label_fetch_ms"]) / row["gather_ms"]
            rows[f"{label} {form}"] = row
            print(f"  K1 on {n} shards, {label} {form}: unsharded {one_ms:.3f} ms, gather {row['gather_ms']:.3f} "
                  f"ms, ring {row['ring_ms']:.3f} ms; merge {row['merge_ms']:.3f} ms + labels "
                  f"{row['label_fetch_ms']:.3f} ms ({100 * row['merge_share_of_gather']:.1f}% of the gather)",
                  flush=True)
            del b_s, v0, i0, l0
    del big
    return rows, err


def mesh_cli(gen_seed, scann_miou, devices, label_prefix=""):
    """Phase 9.3: `eval_cli.main` with 'scann --mesh-bank N' at phase 5's
    settings, saving the bank as .bankdirs, then reloading them onto the
    mesh: both mIoU within 1e-4 of phase 5's unsharded run, K1 launched
    once per shard per eval batch."""
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    cfg = VIT_PRESETS[PRESET]
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
    n_eval = -(-FIXTURE["n_val"] // BATCH)
    n = len(devices)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = str(pathlib.Path(tmp) / "voc")
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
        banks = ["--f-mem-p", str(pathlib.Path(tmp) / "f.bankdir"), "--l-mem-p", str(pathlib.Path(tmp) / "l.bankdir")]

        def argv(label, *flags):
            return ["--dataset-name", "voc", "--data-dir", root, "--model", PRESET, "--random-init",
                    "--seed", str(gen_seed), "--d-model", str(cfg.width), "--patch-size", str(cfg.patch_size),
                    "--input-size", str(INPUT), "--batch-size", str(BATCH), "--num-workers", "0",
                    "--n-neighbours", "30", "--device", DEVICE, "--log-level", "WARNING",
                    "--mesh-bank", str(n), "--mesh-devices", ",".join(str(d) for d in devices),
                    "--out", str(pathlib.Path(tmp) / f"{label}.json"), *flags]

        for label, flags in ((f"{label_prefix}cli scann --mesh-bank {n}, save .bankdir", banks),
                             (f"{label_prefix}cli scann --mesh-bank {n}, --load-memory .bankdir onto the mesh",
                              [*banks, "--load-memory"])):
            out = _cli(label, argv(str(len(runs)), *flags), counters, "knn_topk", "ivf_topk", n_eval, runs,
                       per_batch=n)
            if abs(out["miou"] - scann_miou) > 1e-4:
                fail(f"{label}: mIoU {out['miou']}, unsharded {scann_miou}")
        loaded = runs[f"{label_prefix}cli scann --mesh-bank {n}, --load-memory .bankdir onto the mesh"]
        if loaded["phases"]["memory_build"].get("items", 0) or "index_build" in loaded["phases"]:
            fail(f"the .bankdir reload onto the mesh built its memory: {loaded['phases']}")
    return runs


def nccl_one_process():
    """Phase 9.4: one process joins a process group of one over
    tcp://127.0.0.1 (NCCL on the card): sync_conf_mat returns its input and
    PredsmIoU(sync_distributed=True) the unsynced result."""
    import numpy as np

    from hbird_tpu_torch.parallel import distributed
    from hbird_tpu_torch.utils.eval_metrics import PredsmIoU

    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{port}", num_processes=1, process_id=0, backend=backend)
    try:
        rng = np.random.default_rng(0)
        conf = rng.integers(0, 1000, (21, 21))
        if not np.array_equal(distributed.sync_conf_mat(conf), conf):
            fail("sync_conf_mat over one process changed the matrix")
        m = PredsmIoU(21, 21)
        m.update_with_conf_mat(conf)
        synced = m.compute(is_global_zero=True, sync_distributed=True, return_reordered=False)
        plain = m.compute(is_global_zero=True, return_reordered=False)
        if synced[:4] != plain[:4]:
            fail("PredsmIoU(sync_distributed=True) differs from the unsynced result")
    finally:
        distributed.shutdown()
    wall = time.perf_counter() - t0
    print(f"  {backend} process group of one: sync_conf_mat and PredsmIoU(sync_distributed=True) equal "
          f"their inputs ({wall:.2f}s with init)", flush=True)
    return {"backend": backend, "seconds": wall}


def kernel_entry(name, source, tpu_kernel, launches, err, rows, card, forms=None):
    """One kernel of the `kernels` line: the top-level numbers are its
    'main' shape row (the bf16 form at the main path's shape); `shapes`
    holds every form and shape timed, `forms` the main path's launches by
    form."""
    main = rows["main"]
    entry = {"name": name, "route": "cuda", "source": source, "replaces": tpu_kernel,
             "launches": launches, "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["library_ms"], "shapes": rows, "card": card}
    if forms is not None:
        entry["forms"] = forms
    return entry


def main(argv=()):
    ap = argparse.ArgumentParser(description="Smoke run of hbird_tpu_torch on one CUDA card.")
    ap.add_argument("--pairs", metavar="TREE",
                    help="time only the Hopper-redesigned kernels of TREE's package (see the docstring)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.pairs is not None:
        sys.path.insert(0, str(pathlib.Path(args.pairs).resolve()))
        print(card_line(), flush=True)
        print(json.dumps(pairs(args.pairs)), flush=True)
        return 0
    from hbird_tpu_torch.device import resolve_device
    from hbird_tpu_torch.ops import cuda_build

    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()

    def phase(title):
        print(f"{title} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    phase("[1] build K1, K2 and K3")
    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    print(f"  built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    build = build_report(libs)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phase("[2] K1 vs plain version")
    err_k1 = max(kernel_cases(gen), quantized_kernel_cases(gen))

    phase("[3] K2 vs plain version")
    err_k2 = max(ivf_cases(gen), quantized_ivf_cases(gen))

    phase("[4] K3 vs plain version")
    err_k3 = flash_cases(gen)

    phase(f"[5] main paths ({card})")
    runs, launches, err_main, tree_info, q, bank, main_tree = main_path(gen_seed=0)
    flash_runs, flash_launches, token_err, err_k3_main = flash_path(gen_seed=0)
    runs.update(flash_runs)
    launches["knn_topk"] += sum(n["knn_topk"] for n in flash_launches.values())

    phase("[6] the card against the CPU, small input")
    small = card_vs_cpu()
    backends = backends_card_vs_cpu()

    phase(f"[7] K1, K2 and K3 timing; the forward ({card})")
    k1_rows, k2_rows, err_timing = timing(q, bank, main_tree, gen)
    select = k1_select_rows(q, bank)
    k3_rows, err_k3_timing = flash_timing(gen)
    forward = forward_timing(0, gen)
    del main_tree

    phase(f"[8] the command line, bank and index persistence, the streamed build ({card})")
    cli_runs, cli_launches, persistence = entry_point_path(0, q, runs["scann unbounded"]["miou"])
    runs.update(cli_runs)
    for name, n in cli_launches.items():
        launches[name] += n

    phase(f"[9] the native tar feed, K1 on a bank mesh, the command line on the mesh, NCCL ({card})")
    scann_run = runs["scann unbounded"]
    feed_runs, feed = native_feed(0, scann_run)
    one_card = [torch.device("cuda", torch.cuda.current_device())] * MESH_SHARDS
    mesh_rows, err_mesh = mesh_k1_cases(q, bank, gen, one_card)
    mesh_runs = mesh_cli(0, scann_run["miou"], one_card)
    nccl = nccl_one_process()
    distinct = {}
    if torch.cuda.device_count() > 1:  # never taken on a one-card machine
        cards = [torch.device("cuda", i) for i in range(min(MESH_SHARDS, torch.cuda.device_count()))]
        distinct["k1"], err_distinct = mesh_k1_cases(q, bank, gen, cards)
        err_mesh = max(err_mesh, err_distinct)
        mesh_runs.update(mesh_cli(0, scann_run["miou"], cards, label_prefix="distinct cards: "))
    del bank
    for new_runs in (feed_runs, mesh_runs):
        runs.update(new_runs)
        for run in new_runs.values():
            for name in launches:
                launches[name] += run["launches"][name]

    forms = {name: {} for name in ("knn_topk", "ivf_topk", "flash_attention")}  # main-path launches by form
    for run in runs.values():
        for name, counts in run["forms"].items():
            for form, n in counts.items():
                forms[name][form] = forms[name].get(form, 0) + n
    kernels = {"kernels": [
        kernel_entry("knn_topk (K1)", "hbird_tpu_torch/ops/csrc/knn_topk.cu", TPU_KERNELS["K1"],
                     launches["knn_topk"], max(err_k1, err_main["K1"], err_timing["K1"], err_mesh), k1_rows,
                     card, forms["knn_topk"]),
        kernel_entry("ivf_topk (K2)", "hbird_tpu_torch/ops/csrc/ivf_topk.cu", TPU_KERNELS["K2"],
                     launches["ivf_topk"], max(err_k2, err_main["K2"], err_timing["K2"]), k2_rows,
                     card, forms["ivf_topk"]),
        kernel_entry("flash_attention (K3)", "hbird_tpu_torch/ops/csrc/flash_attn.cu", TPU_KERNELS["K3"],
                     sum(n["flash_attention"] for n in flash_launches.values()),
                     max(err_k3, err_k3_main, err_k3_timing), k3_rows, card, forms["flash_attention"]),
    ], "main_path": runs, "tree": tree_info, "flash_vs_xla_tokens": token_err, "k1_select_load": select,
        "forward_ms_per_batch": forward, "card_vs_cpu": small, "backends_card_vs_cpu": backends,
        "hopper_build": build, "persistence": persistence, "native_feed": feed, "mesh_k1": mesh_rows,
        "mesh_distinct_cards": distinct, "nccl": nccl, "seconds": time.perf_counter() - t_start}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
