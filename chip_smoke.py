#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hbird_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100):

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero with no result:
1. The card (nvidia-smi name and power limit) and versions; K1
   (hbird_tpu_torch/ops/csrc/knn_topk.cu), K2 (ops/csrc/ivf_topk.cu), K3
   (ops/csrc/flash_attn.cu) and K3-bwd (ops/csrc/flash_bwd.cu) are built
   with nvcc for sm_90a, one nvcc each, started together. K3-bwd's two
   kernels (flash_bwd_dkv, flash_bwd_dq) must each have their six
   instances (bf16 and f32, both on wgmma; head widths 32, 64, 80) in
   the ptxas report, none spilling and none with its wgmma serialised
   (C7511, C7520), ask for shared memory, report the f32 tiles'
   streamed rows of F32_BWD_TILE, and, by function in the SASS, every
   instance must issue HGMMA and UTMALDG and no HMMA (check_bwd_sass).
   For the Hopper kernels (K1's and K2's wgmma kernel,
   ops/csrc/wgmma_topk.cuh, every instance S = 1-4 of each form; K3's bf16
   wgmma kernel; ops/csrc/hopper.cuh) it prints what ptxas reported
   (registers and spills by instance, that setmaxnreg was not
   ignored, and any warpgroup wait or arrive it injected or wgmma it
   serialised), the registers and spills of the 3xTF32 kernels (K3 f32's
   and K1's F32 wgmma instances; ops/csrc/tf32.cuh), and the
   dynamic shared memory they ask for; where cuobjdump exists, the
   warpgroup MMAs (HGMMA, IGMMA for int8), UTMALDG and mma.sync (HMMA,
   IMMA for int8) instructions of each library and of each wgmma kernel,
   which must issue a warpgroup MMA and UTMALDG and no mma.sync (K1's,
   K2's, K3's and K3-bwd's libraries must hold such kernels, and no HMMA
   or IMMA at all: every K1, K2, K3 and K3-bwd form runs a wgmma kernel;
   cuobjdump must exist). The
   forms of WGMMA_FORMS must each have their instances (select sizes 1-4,
   one or two epilogues) in the ptxas report and the SASS, and spill
   nothing: K1's F32, Asym and the streamed forms Streamed<Bf16>,
   Streamed<Asym> and Streamed<S8>, K2's F32 and streamed forms; so must
   K3's wgmma kernels at head widths 32, 64 and 80 (flash_bf16_wgmma and
   flash_f32_wgmma <32>, <64>, <80>), neither with its wgmma serialised
   for want of registers (C7511); every form that runs the wgmma kernels
   at D=768, and K3's at each width in each dtype, must ask for its
   shared memory, and so must bf16 at
   BF16_MAX_RESIDENT (resident queries), one chunk past it and at
   BF16_DEPTHS (streamed), asym at D = 1,152 (resident) and 1,168, 1,280
   and 1,536 (streamed) and int8 at 3,072 and at 3,088 and 3,200; and K1
   and K2 must report a size for every form at every depth from 8 to
   4,096 (a multiple of 8, of 16 with int8 codes).
2. K1 against its plain PyTorch version on the same CUDA tensors: first
   bf16 dot and l2 on both sides of the bf16 edge and past it (D =
   BF16_MAX_RESIDENT, one 64-element chunk past it, and BF16_DEPTHS:
   1,544, a partial chunk; 1,664, vit_gigantic_patch14_clip_224's width;
   2,048 and 3,200; the queries streamed past the edge), Q=4,096 normal
   queries against 65,537 rows of norms 0.5-2.0 (the last 537 invalid), at
   every k of CHECK_KS, on the wgmma kernel (`route`), the library
   reporting the resident size at the edge and the streamed one past it;
   and at 1,664 a bank of duplicated rows (the tie order). Then bf16 and
   f32 at Q=4,096, M=300,001, D=768, k=30, valid_rows=299,000; k in
   {1, 8, 128}; valid_rows < k; a bank of duplicated rows (ties). Then its
   forms (b)-(e) at the same shape: l2 (bf16 and f32, rows of unequal
   norm); int8 x int8 codes with a global scale and with row scales, bit
   for bit; bf16 queries on those codes (asym, asym_rows); int8
   valid_rows < k; int8 codes of duplicated rows (integer ties). Then the
   wgmma forms (bf16 dot and l2, f32 dot and l2 on 3xTF32, int8,
   int8_rows, asym, asym_rows: every form) at every k of CHECK_KS (30, 33,
   64, 96, 97, 120, 128: each size of the batched select and its edges) at
   that shape, and on tie-dense entries in {-1, 0, 1} (Q=10,000, so items
   of several bank splits are in flight; every score exact) bit for bit.
   Then int8 and int8_rows on the wide banks, D in WIDE_DEPTHS (1,040:
   a partial last 128-byte chunk; mae_vith14's 1,280; dinov2_vitg14's
   1,536), k in 30 and 120, Q=4,096 against 65,537 rows, on sharp codes
   (magnitudes 120-127, every 7th column negated: every exact score at
   D >= 1,280 passes 2^24, and a running f32 sum is shown to miss some),
   on the wgmma kernel (`route`), bit for bit; the same at D = 3,088 and
   3,200 (DEEP_INT8_DEPTHS), where the queries stream in the ring (the
   library reporting the resident size at 3,072 and the streamed one
   past it). Then asym and asym_rows at D = 1,168, 1,280 and 1,536
   (ASYM_DEPTHS: the queries streamed), Q=4,096 normal queries against
   the global and per-row codes of 65,537 unit rows, on the wgmma kernel,
   at every k of CHECK_KS, and on tie-dense entries bit for bit.
3. K2 against its plain version (ops/ivf.py::ivf_search_plain): first
   bf16 at phase 2's bf16 depths in 48 ragged slabs of cap 256 (one empty;
   4,096 normal queries on unit rows in tiles of 256 probing 32 slabs
   each, one id out of range) at every k of CHECK_KS, on the wgmma kernel,
   and at 1,664 4 slabs of the same rows probed out of slot order (the tie
   order). Then on an IVF
   tree built by the port over a clustered bank of 300,000 rows at D=768
   (512 leaves; the f32 form on an f32 tree of the same rows): bf16 and
   f32; k in {1, 30, 128}; n_probe in {1, 8, 32};
   block_q in {64, 128, 256}; probed slabs with leaf_valid < k and = 0; a
   bank of duplicated rows (ties across slabs). Then its int8 forms on an
   int8_rows tree of the same bank (trained, assigned and probed on the
   codes): int8 and int8_rows bit for bit, asym and asym_rows within the
   tolerance; ragged leaf_valid; int8 codes duplicated across slabs probed
   out of slot order (integer ties). K2's wgmma forms bf16, f32, asym_rows
   and int8_rows at k in {30, 64, 120, 128}, 32 probes a 256-query tile
   (items of several probe splits in flight), with probed slabs emptied,
   cut to 5 and to 128 rows, and an id outside [0, n_slabs) in every
   tile's list; f32 also on slabs of cap 264 (not a multiple of 128) at
   D=72 and 768, rows of norms 0.2-3.0, k in {30, 128}. Then int8 and
   int8_rows at each depth of WIDE_DEPTHS on sharp codes in 48 ragged
   slabs of cap 256 (one empty), 4,096 queries in tiles of 256 probing 32
   slabs each (one id out of range), k in 30 and 120, on the wgmma kernel,
   bit for bit, and so at D = 3,088 and 3,200 (streamed queries); asym
   and asym_rows at each depth of ASYM_DEPTHS in such slabs, normal
   queries on unit rows' codes and tie-dense entries (bit for bit), at
   every k of CHECK_KS.
4. K3 against its plain version (ops/flash.py::flash_attention_plain),
   bf16 and f32, on seeded unit normals at (B, H, N, hd) = (16, 12, 1370,
   64) (the main path: dinov2_vitb14 at input 518, batch 16), (2, 12, 1374,
   64) (dinov2_vitb14_reg), (4, 12, 197, 32) (mocov3_vits16), (2, 16, 257,
   80) (mae_vith14), (1, 12, 4625, 64) (dinov2 at input 952), (2, 2, 1, 64)
   and (2, 2, 65, 64). The launcher's cache of tensor maps: calls on views
   of three buffers (so at three fixed addresses) at one shape, then at
   other dims and strides, each against the plain version (bf16 and f32
   at hd 64, f32 at hd 80; a stale map would read the wrong rows). K3
   under autograd (an input that requires grad, grad mode on), bf16 and
   f32: its Function's forward launches K3's LSE instance once, equal bit
   for bit to the torch.no_grad() call (which takes no Function and launches
   once), the backward launches K3-bwd's dK/dV and dQ kernels once each and
   holds against the plain backward; a second derivative raises. Past
   65,535 (batch, head) pairs (the grid's y limit, which K3 and K3-bwd no
   longer use): K3 at (B, H, N) in MANY_HEADS, (1, 65,536, 3) and (4,
   25,000, 3), at hd 32, 64 and 80, bf16 and f32, against the plain version.
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
   int8, then the exact re-score), 'faiss' with distance_measure='l2'
   on a bf16 bank (K1 l2), 'faiss' as the command line runs it by default
   (no --bf16-bank: an f32 bank, K1 f32 on 3xTF32), flat 'faiss' with
   quantization='int8_asym' (K1 asym_rows) and 'ivf' with use_fp16=False
   (an f32 tree, K2 f32 on 3xTF32): each must launch its form once
   per eval batch and nothing else; each backend's recall@30 against K1's exact bf16
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
   0.1 max and 1e-2 mean, the port's bf16 tolerance, in ViTs of up to 12
   blocks), every bf16 'flash' forward lies no further from the f32 'xla'
   forward than the bf16 'xla' one does (x1.25 max, x1.05 mean; see
   TOKEN_F32_MARGIN), and K3 holds against
   its plain version on that batch's block-0 q, k, v, the strided views of
   the qkv projection the ViT hands over, in bf16 and in f32. The same in
   bf16 with mocov3_vits16 (12 heads of 32: K3 bf16 at hd 32) at input 224
   (random weights from the seed): K3 launches 12 x 5 = 60 times, the
   tokens agree at the bf16 tolerance, both mIoUs are printed; and with
   mae_vith14 (1,280 wide, 32 blocks of 16 heads of 80, no LayerScale: K3
   bf16 at hd 80, N = 257; K1 bf16 dot at D = 1,280) at input 224: K3
   launches 32 x 5 = 160 times, the same checks but the 12-block bound on
   'flash' against 'xla' (printed); the host's time to initialise its ViT
   (631M parameters) is printed. Each preset initialises one ViT and
   switches its blocks between the two attentions. On mae_vith14's
   1,280-wide bank, with the bf16 'flash' ViT, the int8 runs of
   WIDE_QUANT_RUNS: 'faiss' use_int8 + reorder 120 (K1 int8), 'scann'
   int8_rows (K1 int8_rows), 'ivf' int8_rows at N_PROBE probes (K2
   int8_rows), flat 'faiss' int8_asym (K1 asym_rows, streamed queries) and
   the ScaNN searcher (K2 asym_rows, streamed); and dinov2_vitg14
   (1,536 wide, 40 blocks of 24 heads of 64, SwiGLU, LayerScale 0.05) at
   input 518, its one ViT of 1.1B parameters initialised on the host (the
   seconds printed), 'scann' bf16 with 'flash' (K3 200 launches, K1 dot at
   D = 1,536) and GIANT_QUANT_RUNS ('scann' int8_rows, 'faiss' use_int8 +
   reorder 120, flat 'faiss' int8_asym: K1 asym_rows at D = 1,536), its
   tokens held as mae_vith14's. Each int8 run launches
   its K1 or K2 form once per eval batch and K3 as the flash run, nothing
   else, and prints its mIoU and recall@30 against K1's exact bf16
   neighbours on the run's bank. Then the 1,664-wide ViT that the port's
   converter reads from the shapes of timm's vit_gigantic_patch14_clip_224
   (patch 14, 48 blocks of 26 heads of 64, an MLP of 8,192, qkv bias, no
   LayerScale; ~1.84B parameters initialised on the host from the seed,
   the seconds printed) in bf16 at input 224: 'scann' with 'flash' (K3
   bf16 at hd 64 48 x 5 = 240 times, K1 dot at D = 1,664 once per eval
   batch, the queries streamed) and with 'xla', then GIGANTIC_RUNS with
   'flash': 'ivf' on a bf16 tree at N_PROBE probes (K2 bf16 at 1,664) and
   'faiss' l2 on a bf16 bank (K1 l2); each launches its form once per
   eval batch and nothing else and prints its mIoU and recall@30 against
   K1's exact bf16 neighbours ('scann' too); its tokens held as
   mae_vith14's.
6. The card against the CPU on a small input: a tiny ViT (depth 2, width
   64) on a 12/6-image fixture through `hbird_evaluation`, 'scann',
   'faiss', 'ivf' and 'ivf' on an f32 tree (every leaf probed), and
   'faiss' with tiny ViTs of
   head widths 32 and 80, no LayerScale and attention_impl='flash', once on
   the card and once with device="cpu" (the plain versions): mIoU within 1e-4
   and the transferred soft labels within 1e-4, the tolerances the CPU
   tests hold the port to against the JAX engine ('faiss' keeps an f32
   bank: K1 f32 on 3xTF32). The quantized and L2 runs of phase 5 on the
   tiny ViT (the tree probing every leaf): mIoU within 1e-4 only, since
   int8 rounding turns ulp-level feature differences between the devices
   into code flips. Then each backend of phase 5's runs built on the
   card and on the CPU from the same float bank (6,000 rows, D=64): the
   same codes and scales (anisotropic codes: at most ANISO_CODE_FLIPS of
   the rows may differ, near-tied losses) and the same neighbours (exact
   int8 forms bit for bit; the others within RTOL); again at D = 1,536 and
   1,664.
7. K1, K2 and K3 timed with CUDA events, each beside its bound, its plain
   version and a library yardstick the port never calls: K1 at the main
   path's shape (Q=21,904, M=87,616) and against a 1,024,000-row bank
   (query-chunked bf16 torch.matmul + torch.topk), and in its forms int8,
   int8_rows (torch._int_mm + topk; at k = 30 and at k = 120, the `faiss`
   int8 + reorder path's scan), asym_rows and asym (a bf16 matmul against
   the per-row or global codes widened once), l2 (torch.addmm with the
   bias), f32 (an f32 matmul, TF32 off; at k = 30 and 120) and f32 l2 on
   both banks, each row with the kernel it ran (`route`: wgmma at every
   form and depth) and f32's with its 3xTF32 bound (3 TF32 passes at the TF32
   peak) beside its f32 FMA bound. The f32 forms take real f32 operands:
   the main path's f32 queries and f32 bank (the default 'faiss' run's),
   and the large bank's f32 rows, so the split's small parts are not 0 and
   each CTA carries its state over several items; on each, a single TF32
   pass must miss the f32 tolerance at the plain top-30 (else the check
   could not tell it from 3xTF32);
   K2 on the main path's tree (32 of 512 leaves) and on a tree of the
   1,024,000-row bank (cap 2,816, 32 of 512 leaves) (the probed slabs
   gathered per tile, then torch.bmm + torch.topk, chunked over tiles),
   and in its int8_rows and asym_rows forms on the same trees' slabs as
   per-row codes, int8 and asym as global codes; K2 f32 on f32 trees of
   the main path's f32 bank (probed by its f32 queries) and of the large
   bank's f32 rows, with its 3xTF32 bound beside the FMA bound, the route,
   and a single TF32 pass that must miss the f32 tolerance there; K3 at
   the main shape in bf16 and f32, in bf16 at (1, 12, 4625, 64), and in
   bf16 and f32 at hd 32 (16, 12, 197, 32) and at hd 80 (16, 16, 257, 80)
   (torch.nn.functional.scaled_dot_product_attention), each with its
   route; bf16 at hd 32 and hd 80, calls as short as their host cost, in
   NARROW_ROUNDS turns with SDPA, each timed host-launched and in one CUDA
   graph (the device's time), medians with the least and most, and in a
   graph at 1-4 quarters of their batch (the rounds of items), then where
   that host-launched call's host time goes (host_split). K3 f32's
   bound is its work at f32 accuracy on the tensor cores (3 TF32 passes at
   the TF32 peak), printed beside the f32 FMA bound, as K1 f32's. Every
   row prints its share of the bound (bound / ms) and its ratio to the
   library call. The select's load on the main path's bank: for K1
   int8 at k = 30 and 120, the share of (query, 128-row tile) pairs in
   which the running top-k receives a score, walking the tiles in one
   pass over the bank and in the wgmma kernel's partial sets, and for the
   partial sets what the batched select does: scores buffered per pair,
   merges and 32-score chunks merged per query and set. Then the
   ViT-B/14 forward per batch of 16 at 518: 'xla' and 'flash', f32 and
   bf16; and the MAE-H/14 (mae_vith14) forward per batch of 16 at 224,
   'xla' and 'flash' in bf16. Then every K1 and K2 form on the wide banks
   (wide_timing), at D = 1,280 and 1,536: Q=21,904 normal queries against
   87,616 unit rows (their f32 values for the f32 forms), K1 bf16 dot, l2,
   int8 and int8_rows (k 30 and 120), asym, asym_rows, f32 (k 30 and 120)
   and f32 l2; K2 bf16, int8, int8_rows, asym, asym_rows on a tree of that
   bank (32 of 512 leaves) and f32 on an f32 tree; then at D = 1,664,
   2,048 and 3,200 (BF16_TIMING_DEPTHS, the bf16 queries streamed) K1 bf16
   dot and l2 (query-chunked bf16 matmul + topk; addmm + topk) and K2 bf16
   on such a tree, and at 3,200 (DEEP_INT8_TIMING_DEPTH, streamed queries)
   K1 int8 and int8_rows (k 30 and 120) and K2 int8 and int8_rows; each row
   with its route, bound, plain and library times and its check.
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
   one-process NCCL, K1 and the engine over a process group. 9.1: the native library (utils/native.py) built with
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
   input, PredsmIoU(sync_distributed=True) the unsynced result. 9.5: the
   flat search over a bank axis that spans such a group of one
   (`process_mesh`, every cross-shard step a collective): K1 by 'gather'
   and 'ring' in bf16, f32, int8_rows and int8 + reorder 120 on 9.2's two
   banks, on the same 4 stacked shards as the process-local mesh: values,
   ids and labels bit for bit, the same launches, each call timed beside
   the local one; `hbird_evaluation` with 'scann' on that mesh at phase
   5's settings: mIoU within 1e-4 of 9.3's, K1 launched once per shard per
   eval batch. With more than one card, 9.2 and 9.3 run again over
   distinct cards.
10. The IVF tree on a ('bank',) mesh of MESH_SHARDS shards stacked on one
   card (parallel/sharded_ivf.py). 10.1: built on phase 5's bank and on
   BIG_M clustered rows (phase 8's stream) unmeshed, meshed with the host
   layout (must equal the unmeshed build: centroids, slots, perm, leaf
   fill, slabs and labels bit for bit) and with the device layout (the
   same fill, every row in the greedy's leaf except rows whose score ties
   another's within 1e-6, slots and perm consistent); seconds, stages and
   peak allocated memory of each over what was allocated before it. 10.2: with every leaf probed the meshed
   search equals the unmeshed one (bf16 and the ScaNN searcher's asym_rows
   at K2's tolerance, ids equal away from ties; int8_rows bit for bit;
   each label row its winner's) and launches K2 once per shard; at the
   engine's 32 probes, recall@30 against K1's exact neighbours under
   'split' and 'full' beside the unmeshed tree's, and ms of the meshed call,
   of its K2 launches alone, of the merge and of the label fetch, beside
   the unmeshed call and its K2 (bf16, both banks). 10.3: the streamed
   build from a .bankdir of the BIG_M bank onto the mesh: the unmeshed
   streamed build's tree and the in-memory one's, peaks printed. 10.4: the
   meshed bf16, int8_rows and ScaNN trees saved as .treedirs and loaded
   back onto the mesh answer bit for bit; a 3-shard mesh raises. 10.5:
   `eval_cli.main` with 'ivf --mesh-bank 4 --mesh-devices cuda:0,...' at
   phase 5's settings: every leaf probed (host and device layouts), mIoU
   within 1e-4 of the unmeshed every-leaf run, K2 launched once per shard
   per eval batch; at 32 probes ('split', 'full') beside phase 5's 'ivf'
   run. 10.6: the same tree over a bank axis that spans a process group of
   one (NCCL over tcp://127.0.0.1; every cross-shard step a collective):
   builds and search equal the process-local mesh's bit for bit. With more
   than one card, 10.1-10.5 run again over distinct cards.
11. K3-bwd and the gradient path. 11.1: K3-bwd's kernels against the plain
   backward (ops/flash.py::flash_attention_bwd_plain's halves) at N in
   FLASH_BWD_NS (1, 50, 129, 197, 257, 1,370), head widths 32, 64 and 80
   (12, 12 and 16 heads, batch 2), bf16 and f32: q, k, v strided views of
   one (B, N, 3, H, hd) buffer and do a (B, H, N, hd) view of (B, N, H,
   hd) memory, as the ViT hands them over; lse from K3's LSE instance,
   whose output must equal the no-grad call's bit for bit and whose lse
   the plain one's within 1e-5·max(1, |lse|); each kernel run twice for
   the same bits, the f32 rows with their chain of truncating adds (3 ·
   rows / 8 a tile, F32_BWD_TILE); then at phase 4's MANY_HEADS shapes
   (past 65,535 (batch, head) pairs), every width and dtype, two runs bit
   for bit there too. 11.2, the gradient path: dinov2_vitb14 at 518 (N =
   1,370, 12 blocks of 12 heads of 64), random weights from the seed
   (LayerScale 0.05), GRAD_BATCH = 4 seeded images, the loss Σ patch tokens
   · g (g seeded), the gradients of the input and of every parameter with
   attention_impl='flash' against 'xla' (plain torch autograd), f32 and
   bf16 (see flash_grad_path for the limits); each 'flash' run launches
   K3 and each K3-bwd kernel once per block (12), the counts set to 0 just
   before it and read just after. 11.3: K3-bwd timed at FLASH_MAIN,
   FLASH_NARROW and FLASH_WIDE in bf16 and f32 (flash_bwd_timing), each
   row with its route (both 'wgmma') and each kernel's own bound, the main
   shape's split by kernel (dK/dV, dQ, di's torch ops) traced in both.

Tolerance of the K1 and K2 checks: values within 1e-5 * ||q|| * max||b||
(the products are exact in f32, only the summation order differs; K1 f32
takes 3xTF32 products, ~21 bits of each operand); index
sets equal except where the k-th and (k+1)-th plain scores are within
twice that; every returned index re-scored gives its returned value; K2's
ids lie in the valid rows of the slabs their query tile probes. With row
scales the bound is 1e-5 * ||q|| * max_i(||b_i|| * s_i). An int8 x int8
score is the exact integer sum converted to f32 once (the kernel's s32
accumulators; the plain version's f64 product of the codes, exact below
2^53, then one rounding) and a row scale is one f32 multiply, so those
forms must equal the plain version bit for bit, values and indices, at
every depth.

Tolerance of the K3 checks: f32 within 1e-5 absolute at unit-normal
inputs (3xTF32 products, about 21 bits of each operand, and exps summed
in another order). bf16
within 4 bf16 ulps at each query row's scale (4 * 2^-8 * the row's largest
|plain output|) and a mean error under 2^-7 * mean |plain output|: the
kernel rounds p to bf16 against its running maximum and normalises at the
end, the plain version rounds the normalised p, so about half the outputs
differ by about one ulp; the output's own rounding adds at most one.

Tolerance of the K3-bwd checks (check_grads), with S the largest |value|
of the call's three plain gradients: f32 within 1e-5·S (3xTF32 products
and another summation order; p from an lse the CUDA forward wrote). bf16
within 4 bf16 ulps at each row's scale (its largest |plain value|, at
least 2^-8·S) and a mean error under 2^-7·max(mean |plain|, 2^-8·S): the
kernels and the plain version round p and ds to bf16 at the same points,
from values that differ in the last f32 bits, so a rounding may go the
other way. S and the floor: at N = 1, dq and dk vanish in exact
arithmetic (p = 1, ds = 0) and both sides return rounding noise.

Output: a {"kernels": [...]} line, the nvidia-smi card line, and last
{"ok": true, "device": {...}}.

Parent against change: `python3 chip_smoke.py --pairs TREE` imports the
package of the source tree TREE instead of this one's, builds its kernels,
and times only the kernels redesigned for Hopper, each beside its bound and
library call (phase 7's helpers): K3 bf16 and f32 at the main shape and at
(1, 12, 4625, 64) and f32 at hd 32 (16, 12, 197, 32) and hd 80 (16, 16,
257, 80) on unit normals, host-launched and in a CUDA graph, each with a
digest of its output's bytes (the same seeded inputs in every tree, so
equal digests mean equal outputs bit for bit), and K3 bf16 at hd 32 and
hd 80 in NARROW_ROUNDS turns with SDPA, host-launched and in a CUDA
graph, each with its digest; K3-bwd (pairs_bwd) in bf16 and f32 at the
main shape, hd 32 (16, 12, 197, 32) and hd 80 (16, 16, 257, 80), the
whole backward host-launched and in a CUDA graph and each kernel alone,
beside SDPA's backward, with the digest of its three gradients; K1 bf16
dot and l2, int8 and int8_rows with k in PAIR_KS (30, 64, 96, 120, 128), f32 at k = 30 and 120, asym and
asym_rows at k = 30, Q = 21,904 normal queries (and their int8 codes)
against 87,616 and 1,024,000 unit rows (and their global and per-row int8
codes); K2 bf16 and asym_rows (the slabs' per-row codes)
at k = 30 on a tree the package builds of each bank (512 leaves, 32 probed
per 256-query tile), and K2 f32 on an f32 tree of each bank's rows before
their rounding to bf16, probed by the queries before theirs; then at D =
1,280 and 1,536 (87,616 rows) K1 asym and asym_rows and K2 asym_rows; then
at each depth of BF16_PAIR_DEPTHS (1,024-3,200: both sides of the bf16
edge and past it) K1 bf16 dot and l2 at k = 30 on 87,616 and 1,024,000 unit rows and
K2 bf16 on a tree of each.
Every K1 and K2 row carries its output's digest too. It prints one JSON
line. With --k3-only it builds and times K3 and K3-bwd alone (a K3 or
K3-bwd variant tree's turns take about a minute each, against many for
the whole list).
Two trees are compared in one run on one card, each in its own
process, in turns: parent, change, change, parent.
"""

import argparse
import hashlib
import json
import pathlib
import random
import re
import statistics
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
    # K3-bwd: the library's backward kernels behind that call's custom_vjp
    "K3-bwd dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:796",  # _flash_attention_dkv_kernel
    "K3-bwd dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",  # _flash_attention_dq_kernel
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
NARROW_PRESET, NARROW_INPUT = "mocov3_vits16", 224  # phase 5's head-width-32 ViT (K3 bf16 at hd 32)
NARROW_ROUNDS = 15  # phase 7 and --pairs: K3 bf16 hd 32 and SDPA timed in turns, median and spread
HOST_CALLS = 10_000  # phase 7: K3 calls (and of each of its pieces) timed for the split of the host cost
HOST_BATCH = 50  # ... in batches this long, the card synchronised between them
FLASH_WIDE = (16, 16, 257, 80)  # mae_vith14 at 224, batch 16: K3 bf16 at hd 80
WIDE_PRESET, WIDE_INPUT = "mae_vith14", 224  # phase 5's head-width-80 ViT (K3 bf16 at hd 80)
GIANT_PRESET, GIANT_INPUT = "dinov2_vitg14", 518  # phase 5's 1,536-wide ViT (40 blocks, SwiGLU; K3 at hd 64)
# Phase 5's 1,664-wide ViT: the configuration the port's converter reads
# from the shapes of timm's vit_gigantic_patch14_clip_224 (patch 14, 48
# blocks, an MLP of 8,192, input 224; 26 heads of 64), random weights.
GIGANTIC_NAME, GIGANTIC_INPUT = "vit_gigantic_patch14_clip_224", 224
GIGANTIC_SHAPE = {"patch": 14, "width": 1664, "depth": 48, "hidden": 8192, "img": 224}
PAIR_Q, PAIR_M = 21904, 87616  # --pairs: the main path's eval batch and bank
# --pairs, K1's wgmma forms: the engine's k, S = 2 and 3 keys a lane, faiss int8 + reorder's scan, the most
PAIR_KS = (30, 64, 96, 120, 128)
INT8_KS = (30, 120)  # phase 7's K1 int8 forms: the engine's k and faiss int8 + reorder's scan
# Phases 2 and 3: int8 x int8 on the wide banks (mae_vith14's D = 1,280,
# dinov2_vitg14's 1,536; 1,040 ends in a partial 128-byte chunk), Q queries
# against M rows (M not a multiple of 128), on codes whose exact sums pass
# 2^24 (sharp_codes); and past S8_MAX_RESIDENT, the deepest int8 x int8
# whose 64 queries stay resident in the wgmma kernel's shared memory, at
# DEEP_INT8_DEPTHS, where they stream in the ring. bf16 queries on int8
# codes (asym) stay resident up to ASYM_MAX_RESIDENT and stream at
# ASYM_DEPTHS.
WIDE_DEPTHS = (1040, 1280, 1536)
WIDE_TIMING_DEPTHS = (1280, 1536)  # phase 7: every K1 and K2 form at PAIR_Q x PAIR_M on the wide banks
DEEP_INT8_TIMING_DEPTH = 3200  # phase 7: K1 and K2 int8 with streamed queries at PAIR_Q x PAIR_M
WIDE_CASE_Q, WIDE_CASE_M = 4096, 65_537
S8_MAX_RESIDENT, DEEP_INT8_DEPTHS = 3072, (3088, 3200)
ASYM_MAX_RESIDENT, ASYM_DEPTHS = 1152, (1168, 1280, 1536)
# bf16 (K1 dot and l2, K2) keeps its queries resident up to
# BF16_MAX_RESIDENT, the deepest where they fit, and streams them past it:
# phases 2 and 3 check it at BF16_DEPTHS (1,544: a partial 64-element
# chunk; 1,664: vit_gigantic_patch14_clip_224's width) and on both sides of
# the edge; phase 7 times it at BF16_TIMING_DEPTHS; --pairs at
# BF16_PAIR_DEPTHS on both banks (D = 768 is --pairs' main depth).
BF16_MAX_RESIDENT = 1536
BF16_DEPTHS = (1544, 1664, 2048, 3200)
BF16_TIMING_DEPTHS = (1664, 2048, 3200)
BF16_PAIR_DEPTHS = (1024, 1280, 1536, 1664, 2048, 3200)
# The Hopper kernels: source -> the names their wgmma kernels carry (K1 and
# K2 instantiate one template, wgmma_topk.cuh's topk_wgmma; K3 one kernel a
# dtype).
WGMMA_KERNELS = {"knn_topk.cu": ("topk_wgmma",), "ivf_topk.cu": ("topk_wgmma",),
                 "flash_attn.cu": ("flash_bf16_wgmma", "flash_f32_wgmma")}
# Every k of the K1 card checks: each S (keys a lane) and its edges.
CHECK_KS = (30, 33, 64, 96, 97, 120, 128)
TF32_KERNEL = "flash_f32_wgmma"  # K3 f32: 3xTF32 on wgmma (HGMMA, UTMALDG)
# The wgmma template's forms held in phase 1 by the start of their mangled
# template arguments (F32: 3xTF32; Asym; the forms with streamed queries)
# and their instances, one for each select size S (1-4) and epilogue (K1:
# two each; K2: F32 and Bf16 one, the int8 forms two); none may spill.
WGMMA_FORMS = {
    "knn_topk.cu": {"INS_3F32E": 8, "INS_4AsymE": 8, "INS_8StreamedINS_4AsymEE": 8,
                    "INS_8StreamedINS_2S8EE": 8, "INS_8StreamedINS_4Bf16EE": 8},
    "ivf_topk.cu": {"INS_3F32E": 4, "INS_8StreamedINS_4AsymEE": 8, "INS_8StreamedINS_2S8EE": 8,
                    "INS_8StreamedINS_4Bf16EE": 4},
}
# Libraries with no mma.sync at all (HMMA, IMMA in their SASS): every K1, K2,
# K3 and K3-bwd form runs a wgmma kernel.
NO_MMA_SYNC = ("knn_topk.cu", "ivf_topk.cu", "flash_attn.cu", "flash_bwd.cu")
SMEM_DEPTHS = range(8, 4097, 8)  # phase 1: K1 and K2 report shared memory for every form at each
F32_FORM = "INS_3F32E"
# K3's wgmma instances (bf16 and f32 each) by head width and LSE flag (the
# forward under autograd, which also writes each row's log-sum-exp), as
# mangled; none may spill or have its wgmma serialised (C7511).
K3_WGMMA_WIDTHS = {f"ILi{hd}ELb{lse}E": hd for hd in (32, 64, 80) for lse in (0, 1)}
# K3-bwd's kernels (ops/csrc/flash_bwd.cu; bf16 and f32 on wgmma): each one
# instance a dtype and head width (as mangled), none spilling.
BWD_KERNELS = ("flash_bwd_dkv", "flash_bwd_dq")
BWD_INSTANCES = {f"I{t}Li{hd}E": (dt, hd) for t, dt in (("13__nv_bfloat16", "bf16"), ("f", "f32"))
                 for hd in (32, 64, 80)}
# Streamed rows of an f32 K3-bwd tile by head width (flash_bwd.cu's fbs; phase
# 1 holds the library to it): each tile's product for dk, dv or dq is a chain
# of 3 · rows / 8 truncating tensor-core adds, added into an f32 sum rounding
# to nearest.
F32_BWD_TILE = {32: 32, 64: 32, 80: 16}
# Phase 11: K3-bwd against its plain backward at these sequence lengths (every
# head width, both dtypes), the gradient path at GRAD_BATCH, and its times.
FLASH_BWD_NS = (1, 50, 129, 197, 257, 1370)
FLASH_BWD_CASE_B = 2  # batch of each phase 11 check (12 heads; 16 at hd 80)
GRAD_BATCH = 4  # the gradient path's batch
# Phases 4 and 11.1: K3 and K3-bwd past 65,535 (batch, head) pairs, (B, H, N)
# at every head width: 2^16 pairs, and 100,000 (not a power of two).
MANY_HEADS = ((1, 65536, 3), (4, 25000, 3))
# The least work of a backward: s, dp, dv, dk, dq (2·N²·hd flops each a
# head); the library's split (and K3-bwd's) recomputes s and dp, 14.
BWD_FLOPS, BWD_SPLIT_FLOPS = 10, 14
TOKEN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.1, 1e-2)}  # (max, mean) |err|
# TOKEN_TOL holds 'flash' to 'xla' in ViTs of up to 12 blocks. Deeper, two
# bf16 forwards drift apart whatever the attention: at mae_vith14's 32
# blocks 'xla' with bf16 logits and 'xla' with f32 logits differ by 0.125
# max, 0.0112 mean (PERF.md, PR 13). Every bf16 run is also held to the f32
# 'xla' forward: 'flash' no further from it than 'xla', by these factors
# (max, mean; one element of millions sets the max).
TOKEN_TOL_DEPTH = 12
TOKEN_F32_MARGIN = (1.25, 1.05)
LAYERSCALE = 0.05  # the flash path's LayerScale (see flash_path)
# The quantized, L2 and f32-bank engine runs: nn_method, nn_params, the
# engine's bf16_bank flag, and the kernel and form that must launch once per
# eval batch. 'faiss' is the command line's default run (no --bf16-bank).
QUANT_RUNS = {
    "int8_rows": ("scann", {"quantization": "int8_rows"}, False, ("knn_topk", "int8_rows")),
    "scann-literal": ("ivf", {"quantization": "int8_asym", "dimensions_per_block": 4,
                              "anisotropic_quantization_threshold": 0.2,
                              "num_reordering_candidates": 120}, False, ("ivf_topk", "asym_rows")),
    "int8+rerank": ("faiss", {"use_int8": True, "num_reordering_candidates": 120}, False,
                    ("knn_topk", "int8")),
    "l2": ("faiss", {"distance_measure": "l2"}, True, ("knn_topk", "l2")),
    "faiss": ("faiss", {}, False, ("knn_topk", "f32")),
    "faiss int8_asym": ("faiss", {"quantization": "int8_asym"}, False, ("knn_topk", "asym_rows")),
    "ivf f32": ("ivf", {"use_fp16": False}, False, ("ivf_topk", "f32")),
}
# Phase 5's int8 runs on the wide banks, with the bf16 'flash' ViT:
# nn_method, nn_params, and the kernel and form that must launch once per
# eval batch (the tree probes N_PROBE leaves, as phase 5's 'ivf').
WIDE_QUANT_RUNS = {
    "faiss int8 + reorder 120": ("faiss", {"use_int8": True, "num_reordering_candidates": 120}, False,
                                 ("knn_topk", "int8")),
    "scann int8_rows": ("scann", {"quantization": "int8_rows"}, False, ("knn_topk", "int8_rows")),
    "ivf int8_rows": ("ivf", {"quantization": "int8_rows", "num_leaves_to_search": N_PROBE}, False,
                      ("ivf_topk", "int8_rows")),
    "faiss int8_asym": ("faiss", {"quantization": "int8_asym"}, False, ("knn_topk", "asym_rows")),
    "scann-literal": ("ivf", QUANT_RUNS["scann-literal"][1], False, ("ivf_topk", "asym_rows")),
}
GIANT_QUANT_RUNS = {name: WIDE_QUANT_RUNS[name]
                    for name in ("scann int8_rows", "faiss int8 + reorder 120", "faiss int8_asym")}
# The 1,664-wide ViT's bf16 runs beside its 'scann': K2 bf16 on a bf16 tree
# at N_PROBE probes, K1 l2 on a bf16 bank.
GIGANTIC_RUNS = {
    "ivf": ("ivf", {"num_leaves_to_search": N_PROBE}, False, ("ivf_topk", "dot")),
    "faiss l2": ("faiss", {"distance_measure": "l2"}, True, ("knn_topk", "l2")),
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


def graph_ms(fn, reps):
    """Mean ms of `fn` over `reps` calls captured in one CUDA graph and
    replayed, by CUDA events: the device's time without the host's cost of
    each call (Python, ctypes, PyTorch's dispatch), which `cuda_ms` measures
    instead wherever it exceeds a short kernel's."""
    if DEVICE != "cuda":
        return cuda_ms(fn, reps)
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def in_turns(fns, rounds, reps):
    """Each of `fns` (name -> callable) timed `rounds` times in turns, by
    cuda_ms (host-launched) and graph_ms (one graph): per name and way, the
    median, the least and the most of the rounds."""
    times = {name: {"ms": [], "graph_ms": []} for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name]["ms"].append(cuda_ms(fn, reps))
            times[name]["graph_ms"].append(graph_ms(fn, reps))
    return {name: {way: {"median": statistics.median(t), "min": min(t), "max": max(t)}
                   for way, t in ways.items()} for name, ways in times.items()}


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
    bank, qd = duplicated_rows(DEPTH, gen)
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
    """Phase 2: the wgmma forms (bf16 dot and l2, f32 dot and l2, int8,
    int8_rows, asym, asym_rows) at every k of CHECK_KS (each S of the
    batched select and its edges): on the stated shape (Q=4,096 over two
    bank splits) against the plain version, and on tie-dense integer
    entries in {-1, 0, 1} (Q=10,000 queries, so items of several splits are
    in flight; scores, l2 biases and scaled scores exact, 3xTF32 and
    widened codes included) bit for bit, values and indices."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    shape = f"Q={CASE_Q} M={CASE_M} D={DEPTH} valid={CASE_VALID}"
    q = torch.randn(CASE_Q, DEPTH, generator=gen, device=DEVICE)
    b = torch.nn.functional.normalize(torch.randn(CASE_M, DEPTH, generator=gen, device=DEVICE), dim=1)
    b = b * (0.5 + 1.5 * torch.rand(CASE_M, 1, generator=gen, device=DEVICE))
    qb, bb = q.bfloat16().contiguous(), b.bfloat16().contiguous()
    q8 = quantize_queries_int8(q)[0]
    codes, scale = quantize_bank_int8(b, per_row=True)
    codes_g = quantize_bank_int8(b, per_row=False)[0]
    rs = scale.reshape(-1)
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
        "f32": ((q, b, {}), (tq.float(), tb.float(), {}), False),
        "f32_l2": ((q, b, {"distance": "l2"}), (tq.float(), tb.float(), {"distance": "l2"}), False),
        "asym": ((qb, codes_g, {}), (tq.bfloat16(), tb.to(torch.int8), {}), False),
        "asym_rows": ((qb, codes, {"row_scale": rs}), (tq.bfloat16(), tb.to(torch.int8), {"row_scale": t_rs}),
                      False),
    }
    errs = []
    for form, ((qq, bank, kw), (tqq, tbank, tkw), exact) in forms.items():
        for k in CHECK_KS:
            errs.append(check_against_plain(f"{form} {shape} k={k}", qq, bank, k, CASE_VALID, exact=exact, **kw))
            valid = tbank.shape[0] - 127
            errs.append(check_against_plain(f"{form} tie-dense Q={n_q} M={tbank.shape[0]} valid={valid} k={k}",
                                            tqq, tbank, k, valid, exact=True, **tkw))
    return max(errs)


def sharp_codes(n, d, gen):
    """(n, d) int8 codes of magnitude 120-127 with every 7th column negated
    (the same columns in queries and bank, so every product is positive):
    at D >= 1,280 every exact q·b passes 2^24 within the first 1,152
    columns, half of them odd, so a running f32 sum rounds on the way and
    only one conversion of the exact integer gives the TPU kernel's value
    (tests/test_torch_int8_wide.py holds the plain versions to it)."""
    sign = torch.where(torch.arange(d, device=DEVICE) % 7 == 0, -1, 1)
    return (torch.randint(120, 128, (n, d), generator=gen, device=DEVICE) * sign).to(torch.int8).contiguous()


def assert_sharp(name, q, b, chunk=128):
    """Fails unless the codes can tell one rounding from several: at D >=
    1,280 a `chunk`-deep running f32 sum of q·b must miss the once-rounded
    exact sum somewhere (at 1,040 no int8 sum reaches 2^24). Returns the
    share missed."""
    q, b = q[:256].double(), b[:2048].double()
    exact = q @ b.T
    if q.shape[1] * 127**2 < 2**24:
        return 0.0
    acc = torch.zeros(exact.shape, dtype=torch.float32, device=exact.device)
    for c in range(0, q.shape[1], chunk):
        acc = acc + (q[:, c:c + chunk] @ b[:, c:c + chunk].T).float()
    share = (acc != exact.float()).float().mean().item()
    if not (exact.min().item() > 2**24 and share > 0.0):
        fail(f"{name}: the codes cannot tell one rounding from a running f32 sum")
    return share


def streamed_smem(source, prefix, form, edge, depths):
    """Phases 2 and 3: the shared memory the library of `source` reports
    for `form` at `edge` (the deepest whose queries stay resident) and at
    each of `depths` past it, where they stream in the ring: a size at
    every depth, the streamed one not the resident edge's (None on the CPU
    rehearsal)."""
    from hbird_tpu_torch.ops import cuda_build, ivf_cuda, knn_cuda

    if DEVICE != "cuda":
        return None
    argtypes = knn_cuda._ARGTYPES if prefix == "knn_topk" else ivf_cuda._ARGTYPES
    lib = cuda_build.load(source, f"{prefix}_launch", argtypes)
    smem = {d: knn_cuda.wgmma_smem(lib, prefix, d, form) for d in (edge, *depths)}
    if not all(smem.values()) or any(smem[d] == smem[edge] for d in depths):
        fail(f"{prefix} form {form}: shared memory by depth {smem}, not resident to {edge} and streamed past it")
    print(f"  {prefix} form {form}: shared memory by depth {json.dumps(smem)} B (resident queries to D = {edge}, "
          "streamed past it)", flush=True)
    return smem


def wide_int8_knn_cases(gen):
    """Phase 2: K1 int8 and int8_rows at each depth of WIDE_DEPTHS and of
    DEEP_INT8_DEPTHS (the queries streamed in the ring) on sharp codes
    (WIDE_CASE_Q queries, WIDE_CASE_M rows, the last 537 invalid), k in
    INT8_KS, on the wgmma kernel (`route`), bit for bit, values and
    indices."""
    valid = WIDE_CASE_M - 537
    errs, info = [], {}
    for d in WIDE_DEPTHS + DEEP_INT8_DEPTHS:
        q8, codes = sharp_codes(WIDE_CASE_Q, d, gen), sharp_codes(WIDE_CASE_M, d, gen)
        rs = 0.25 + torch.rand(WIDE_CASE_M, generator=gen, device=DEVICE)
        route = _route("knn_topk.cu", "knn_topk", q8, codes)
        info[d] = {"route": route, "sharp_share": assert_sharp(f"K1 D={d}", q8, codes)}
        for form, r in (("int8", None), ("int8_rows", rs)):
            for k in INT8_KS:
                errs.append(check_against_plain(
                    f"{form} sharp codes Q={WIDE_CASE_Q} M={WIDE_CASE_M} D={d} valid={valid} k={k} ({route})",
                    q8, codes, k, valid, row_scale=r, exact=True))
        del q8, codes
    info["smem"] = streamed_smem("knn_topk.cu", "knn_topk", 2, S8_MAX_RESIDENT, DEEP_INT8_DEPTHS)
    return max(errs), info


def tie_dense(n, d, dtype, gen):
    """(n, d) entries in {-1, 0, 1} of `dtype`: every score exact, ties dense."""
    return torch.randint(-1, 2, (n, d), generator=gen, device=DEVICE).to(dtype).contiguous()


def wide_asym_knn_cases(gen):
    """Phase 2: K1 asym and asym_rows at each depth of ASYM_DEPTHS (past
    ASYM_MAX_RESIDENT: the queries streamed in the ring), on the wgmma
    kernel (`route`), at every k of CHECK_KS: WIDE_CASE_Q normal bf16
    queries against the global and per-row int8 codes of WIDE_CASE_M unit
    rows (the last 537 invalid) at the stated tolerance, and tie-dense
    entries in {-1, 0, 1} (row scales 0.25-1.25) bit for bit."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8

    valid = WIDE_CASE_M - 537
    errs, info = [], {}
    for d in ASYM_DEPTHS:
        q = torch.randn(WIDE_CASE_Q, d, generator=gen, device=DEVICE).bfloat16().contiguous()
        b = torch.nn.functional.normalize(torch.randn(WIDE_CASE_M, d, generator=gen, device=DEVICE), dim=1)
        codes, scale = quantize_bank_int8(b, per_row=True)
        codes_g = quantize_bank_int8(b, per_row=False)[0]
        del b
        tq, tb = tie_dense(WIDE_CASE_Q, d, torch.bfloat16, gen), tie_dense(WIDE_CASE_M, d, torch.int8, gen)
        t_rs = 0.25 + torch.rand(WIDE_CASE_M, generator=gen, device=DEVICE)
        route = _route("knn_topk.cu", "knn_topk", q, codes)
        info[d] = {"route": route}
        for form, bank, r, t_r in (("asym", codes_g, None, None), ("asym_rows", codes, scale.reshape(-1), t_rs)):
            for k in CHECK_KS:
                errs.append(check_against_plain(
                    f"{form} Q={WIDE_CASE_Q} M={WIDE_CASE_M} D={d} valid={valid} k={k} ({route})",
                    q, bank, k, valid, row_scale=r))
                errs.append(check_against_plain(
                    f"{form} tie-dense Q={WIDE_CASE_Q} M={WIDE_CASE_M} D={d} valid={valid} k={k} ({route})",
                    tq, tb, k, valid, row_scale=t_r, exact=True))
        del q, codes, codes_g, tq, tb
    info["smem"] = streamed_smem("knn_topk.cu", "knn_topk", 3, ASYM_MAX_RESIDENT, ASYM_DEPTHS)
    return max(errs), info


def wide_slabs(d, rows_fn, gen, n_slabs=48, cap=256, n_probe=32):
    """Phase 3's ragged slabs at depth d: `n_slabs` slabs of `cap` rows
    (leaf_valid random, the first three 0, 5 and cap) filled by
    `rows_fn(n, d)`, padding slots 0; row scales 0.25-1.25 (0 on padding);
    for WIDE_CASE_Q queries in tiles of BLOCK_Q a random list of `n_probe`
    slabs a tile (on the card one id out of range). Returns (bank, row
    scales, lids, leaf_valid)."""
    lv = torch.randint(1, cap + 1, (n_slabs,), generator=gen, device=DEVICE, dtype=torch.int32)
    lv[:3] = torch.tensor([0, 5, cap], dtype=torch.int32)
    slot = torch.arange(n_slabs * cap, device=DEVICE)
    real = slot % cap < lv.long().repeat_interleave(cap)
    bank = rows_fn(n_slabs * cap, d)
    bank[~real] = 0
    rs = torch.where(real, 0.25 + torch.rand(n_slabs * cap, generator=gen, device=DEVICE), 0.0)
    lids = torch.stack([torch.randperm(n_slabs, generator=gen, device=DEVICE)[:n_probe]
                        for _ in range(WIDE_CASE_Q // BLOCK_Q)]).to(torch.int32)
    if DEVICE == "cuda":
        lids[:, 5] = n_slabs + 3
    return bank, rs, lids, lv


def wide_int8_ivf_cases(gen):
    """Phase 3: K2 int8 and int8_rows at each depth of WIDE_DEPTHS and of
    DEEP_INT8_DEPTHS (the queries streamed in the ring) on sharp codes in
    `wide_slabs`, k in INT8_KS, on the wgmma kernel, bit for bit."""
    cap = 256
    errs, info = [], {}
    for d in WIDE_DEPTHS + DEEP_INT8_DEPTHS:
        bank, rs, lids, lv = wide_slabs(d, lambda n, dd: sharp_codes(n, dd, gen), gen, cap=cap)
        q8 = sharp_codes(WIDE_CASE_Q, d, gen)
        route = _route("ivf_topk.cu", "ivf_topk", q8, bank)
        slot = torch.arange(bank.shape[0], device=DEVICE)
        info[d] = {"route": route, "sharp_share": assert_sharp(f"K2 D={d}", q8, bank[lv.long().repeat_interleave(
            cap) > slot % cap])}
        for form, r in (("int8", None), ("int8_rows", rs)):
            for k in INT8_KS:
                errs.append(check_ivf_against_plain(
                    f"{form} sharp codes Q={q8.shape[0]} {lv.shape[0]} slabs of cap {cap} D={d} k={k} "
                    f"n_probe={lids.shape[1]} ({route})", q8, bank, lids, lv, k, cap, BLOCK_Q, row_scale=r,
                    exact=True))
        del q8, bank
    info["smem"] = streamed_smem("ivf_topk.cu", "ivf_topk", 2, S8_MAX_RESIDENT, DEEP_INT8_DEPTHS)
    return max(errs), info


def wide_asym_ivf_cases(gen):
    """Phase 3: K2 asym and asym_rows at each depth of ASYM_DEPTHS (the
    queries streamed in the ring) in `wide_slabs`, on the wgmma kernel, at
    every k of CHECK_KS: normal bf16 queries on the global int8 codes of
    unit rows (row scales 0.25-1.25 for asym_rows) at the stated tolerance,
    and tie-dense entries bit for bit."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8

    def unit_codes(n, d):
        rows = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=DEVICE), dim=1)
        return quantize_bank_int8(rows, per_row=False)[0]

    cap = 256
    errs, info = [], {}
    for d in ASYM_DEPTHS:
        cases = (("", wide_slabs(d, unit_codes, gen, cap=cap),
                  torch.randn(WIDE_CASE_Q, d, generator=gen, device=DEVICE).bfloat16().contiguous(), False),
                 ("tie-dense ", wide_slabs(d, lambda n, dd: tie_dense(n, dd, torch.int8, gen), gen, cap=cap),
                  tie_dense(WIDE_CASE_Q, d, torch.bfloat16, gen), True))
        route = _route("ivf_topk.cu", "ivf_topk", cases[0][2], cases[0][1][0])
        info[d] = {"route": route}
        for kind, (bank, rs, lids, lv), q, exact in cases:
            for form, r in (("asym", None), ("asym_rows", rs)):
                for k in CHECK_KS:
                    errs.append(check_ivf_against_plain(
                        f"{form} {kind}Q={q.shape[0]} {lv.shape[0]} slabs of cap {cap} D={d} k={k} "
                        f"n_probe={lids.shape[1]} ({route})", q, bank, lids, lv, k, cap, BLOCK_Q, row_scale=r,
                        exact=exact))
        del cases
    info["smem"] = streamed_smem("ivf_topk.cu", "ivf_topk", 3, ASYM_MAX_RESIDENT, ASYM_DEPTHS)
    return max(errs), info


def bf16_edge_depths():
    """Phases 2 and 3's bf16 depths: the last whose queries stay resident,
    one 64-element chunk past it, and BF16_DEPTHS (all streamed)."""
    return tuple(sorted({BF16_MAX_RESIDENT, BF16_MAX_RESIDENT + 64, *BF16_DEPTHS}))


def duplicated_rows(d, gen):
    """4 copies of 2,048 unit rows at depth d in bf16, and the first 1,024
    rows as queries: every score tied 4 ways."""
    base = torch.nn.functional.normalize(torch.randn(2048, d, generator=gen, device=DEVICE), dim=1)
    return base.repeat(4, 1).to(torch.bfloat16).contiguous(), base[:1024].to(torch.bfloat16).contiguous()


def wide_bf16_knn_cases(gen):
    """Phase 2: K1 bf16 dot and l2 on both sides of the resident edge and
    past it (bf16_edge_depths: the queries streamed in the ring past
    BF16_MAX_RESIDENT), on the wgmma kernel (`route`), at every k of
    CHECK_KS: WIDE_CASE_Q normal queries against WIDE_CASE_M rows of norms
    0.5-2.0 (the last 537 invalid) at the stated tolerance; and at 1,664
    the tie order on duplicated rows."""
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    valid = WIDE_CASE_M - 537
    errs, info = [], {}
    for d in bf16_edge_depths():
        q = torch.randn(WIDE_CASE_Q, d, generator=gen, device=DEVICE).bfloat16().contiguous()
        b = torch.nn.functional.normalize(torch.randn(WIDE_CASE_M, d, generator=gen, device=DEVICE), dim=1)
        b = (b * (0.5 + 1.5 * torch.rand(WIDE_CASE_M, 1, generator=gen, device=DEVICE))).bfloat16().contiguous()
        route = _route("knn_topk.cu", "knn_topk", q, b)
        info[d] = {"route": route}
        for form, distance in (("dot", "dot_product"), ("l2", "l2")):
            for k in CHECK_KS:
                errs.append(check_against_plain(f"bf16 {form} Q={WIDE_CASE_Q} M={WIDE_CASE_M} D={d} valid={valid} "
                                                f"k={k} ({route})", q, b, k, valid, distance=distance))
        del q, b
    d = BF16_DEPTHS[1]
    bank, qd = duplicated_rows(d, gen)
    kv, ki = knn_topk(qd, bank, 30)
    errs.append(check_against_plain(f"bf16 duplicated rows (ties) D={d}", qd, bank, 30, bank.shape[0], (kv, ki)))
    check_tie_order(kv, ki, 2048, f"bf16 duplicated rows D={d}")
    info["smem"] = streamed_smem("knn_topk.cu", "knn_topk", 1, BF16_MAX_RESIDENT,
                                 tuple(d for d in bf16_edge_depths() if d > BF16_MAX_RESIDENT))
    return max(errs), info


def wide_bf16_ivf_cases(gen):
    """Phase 3: K2 bf16 at bf16_edge_depths in `wide_slabs` (ragged, one
    empty, one id out of range) on the wgmma kernel, at every k of
    CHECK_KS: normal queries on unit rows at the stated tolerance; and at
    1,664 the tie order on 4 slabs of the same rows probed out of slot
    order."""
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    def unit_rows(n, d):
        return torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=DEVICE), dim=1).bfloat16()

    cap = 256
    errs, info = [], {}
    for d in bf16_edge_depths():
        bank, _, lids, lv = wide_slabs(d, unit_rows, gen, cap=cap)
        q = torch.randn(WIDE_CASE_Q, d, generator=gen, device=DEVICE).bfloat16().contiguous()
        route = _route("ivf_topk.cu", "ivf_topk", q, bank)
        info[d] = {"route": route}
        for k in CHECK_KS:
            errs.append(check_ivf_against_plain(
                f"bf16 Q={q.shape[0]} {lv.shape[0]} slabs of cap {cap} D={d} k={k} n_probe={lids.shape[1]} "
                f"({route})", q, bank, lids, lv, k, cap, BLOCK_Q))
        del bank, q
    d = BF16_DEPTHS[1]
    dup, qd = duplicated_rows(d, gen)
    dl = torch.tensor([[3, 1, 0, 2]] * 4, dtype=torch.int32, device=DEVICE)
    dv = torch.full((4,), 2048, dtype=torch.int32, device=DEVICE)
    kv, ki = ivf_topk(qd, dup, dl, dv, 30, cap=2048, block_q=256)
    errs.append(check_ivf_against_plain(f"bf16 duplicated rows across slabs (ties) D={d}", qd, dup, dl, dv, 30, 2048,
                                        256, (kv, ki)))
    check_tie_order(kv, ki, 2048, f"bf16 duplicated slabs D={d}")
    info["smem"] = streamed_smem("ivf_topk.cu", "ivf_topk", 1, BF16_MAX_RESIDENT,
                                 tuple(d for d in bf16_edge_depths() if d > BF16_MAX_RESIDENT))
    return max(errs), info


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
    trees = {}
    for dtype in (torch.bfloat16, torch.float32):  # the tree's slabs in bf16 (the default) and f32
        t0 = time.perf_counter()
        nn = NearestNeighborSearchApprox(x, n_neighbors=30, use_tree=True, use_fp16=dtype == torch.bfloat16,
                                         device=DEVICE)
        sync()
        trees[dtype] = (nn._cap, nn.bank, nn.leaf_valid, nn.centroids)
        print(f"  {str(dtype)[6:]} tree of {IVF_ROWS} rows: {nn._n_leaves} leaves, cap {nn._cap}, built in "
              f"{time.perf_counter() - t0:.2f}s {json.dumps(rounded(nn.build_seconds))}", flush=True)
        del nn
    cap, bank, lv, cent = trees[torch.bfloat16]
    pick = torch.randint(0, IVF_ROWS, (IVF_Q,), generator=gen, device=DEVICE)
    q = x[pick] + 0.05 / DEPTH ** 0.5 * torch.randn(IVF_Q, DEPTH, generator=gen, device=DEVICE)
    del x
    errs = []
    cases = [(30, n_probe, block_q) for n_probe in (1, 8, 32) for block_q in (64, 128, 256)]
    cases += [(1, 32, 256), (1, 8, 64), (128, 32, 256), (128, 1, 128)]
    for dtype in (torch.bfloat16, torch.float32):
        t_cap, b, t_lv, t_cent = trees[dtype]
        for k, n_probe, block_q in cases if dtype == torch.bfloat16 else [(30, 32, 256), (128, 8, 128), (1, 1, 64)]:
            qp, lids, _ = tile_probe_inputs(q.to(dtype), t_cent, n_probe=n_probe, block_q=block_q)
            errs.append(check_ivf_against_plain(
                f"{str(dtype)[6:]} Q={qp.shape[0]} k={k} n_probe={n_probe} block_q={block_q}",
                qp, b, lids, t_lv, k, t_cap, block_q))
    errs.append(ivf_edge_cases("f32", q, *(trees[torch.float32][i] for i in (1, 2, 3, 0)), None, False))
    del trees
    errs.append(ragged_f32_cases(gen))
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
    dup, qd = duplicated_rows(DEPTH, gen)
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


def ragged_f32_cases(gen):
    """Phase 3: K2 f32 on slabs no tree lays out: cap 264 (not a multiple
    of 128, so a slab's second tile box runs into the next slab's rows),
    D = 72 (a partial 32-deep chunk: TMA's zero fill) and D = 768, rows of
    norms 0.2-3.0, slabs empty, of 5 rows, cut at 128 and full probed by
    every tile out of slot order, and (on the card) an id outside [0,
    n_slabs); k in 30, 128."""
    n_slabs, cap, block_q, n_tiles, n_probe = 40, 264, BLOCK_Q, 8, 24
    errs = []
    for d in (72, DEPTH):
        rows = n_slabs * cap
        bank = torch.nn.functional.normalize(torch.randn(rows, d, generator=gen, device=DEVICE), dim=1)
        bank = bank * (0.2 + 2.8 * torch.rand(rows, 1, generator=gen, device=DEVICE))
        lv = torch.randint(1, cap + 1, (n_slabs,), generator=gen, device=DEVICE, dtype=torch.int32)
        lv[:4] = torch.tensor([0, 5, 128, cap], dtype=torch.int32)
        bank[torch.arange(rows, device=DEVICE) % cap >= lv.long().repeat_interleave(cap)] = 0.0
        q = torch.randn(n_tiles * block_q, d, generator=gen, device=DEVICE)
        rest = torch.stack([torch.randperm(n_slabs - 4, generator=gen, device=DEVICE)[:n_probe - 5] + 4
                            for _ in range(n_tiles)])
        edge = torch.tensor([3, 0, 2, 1, n_slabs + 5 if DEVICE == "cuda" else 0], device=DEVICE)
        lids = torch.cat([edge.expand(n_tiles, -1), rest], 1).to(torch.int32).contiguous()
        for k in (30, 128):
            errs.append(check_ivf_against_plain(
                f"f32 cap={cap} D={d} Q={q.shape[0]} k={k} n_probe={n_probe}, slabs empty, of 5, 128 and {cap} "
                f"rows, an id out of range", q, bank, lids, lv, k, cap, block_q))
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
    errs.append(stale_map_check(gen))
    return max(errs)


def stale_map_check(gen):
    """Phase 4: K3's cache of tensor maps against a stale map. q, k and v
    are views of three buffers, so every call below reads from the same
    three addresses: with the strides of (2, 4, 200) at (1, 2, 100), then
    with one dim grown at a time (B, H, N), then at other dims and strides,
    other strides (heads inside tokens) and (2, 4, 200) again; each call is
    held against the plain version. A map kept from a call with a smaller
    dim would read zeros for the grown one's rows. bf16 and f32 at hd 64,
    f32 at hd 80 (its two-part rows)."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    errs = []
    for dtype, hd in ((torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 80)):
        bufs = [torch.randn(2 * 4 * 200 * hd, generator=gen, device=DEVICE).to(dtype) for _ in range(3)]
        views = {"(1, 2, 100), the (2, 4, 200) strides": lambda x: x.view(2, 4, 200, hd)[:1, :2, :100],
                 "(2, 2, 100), B grown": lambda x: x.view(2, 4, 200, hd)[:, :2, :100],
                 "(2, 4, 100), H grown": lambda x: x.view(2, 4, 200, hd)[:, :, :100],
                 "(2, 4, 200), N grown": lambda x: x.view(2, 4, 200, hd),
                 "(4, 2, 200)": lambda x: x.view(4, 2, 200, hd),
                 "(2, 4, 200), heads inside tokens": lambda x: x.view(2, 200, 4, hd).transpose(1, 2),
                 "(2, 4, 200) again": lambda x: x.view(2, 4, 200, hd)}
        for label, view in views.items():
            q, k, v = (view(buf) for buf in bufs)
            if [t.data_ptr() for t in (q, k, v)] != [buf.data_ptr() for buf in bufs]:
                fail(f"stale-map check: {label} is not at its buffers' addresses")
            out = flash_attention(q, k, v, hd**-0.5)
            sync()
            errs.append(check_flash(f"stale-map check {str(dtype)[6:]} hd {hd}, {label}", out,
                                    flash_attention_plain(q, k, v, hd**-0.5)))
        del bufs
    return max(errs)


def many_heads_shapes(sizes=None):
    """(B, H, N, hd) of the checks past 65,535 (batch, head) pairs: each
    (B, H, N) of `sizes` (default MANY_HEADS) at hd 32, 64 and 80."""
    return [(b, h, n, hd) for b, h, n in (MANY_HEADS if sizes is None else sizes) for hd in (32, 64, 80)]


def flash_many_heads(gen, sizes=None):
    """Phase 4: K3 past 65,535 (batch, head) pairs (many_heads_shapes),
    bf16 and f32, on seeded unit normals against the plain version.
    Returns the largest |err|."""
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    errs = []
    for shape in many_heads_shapes(sizes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
            scale = shape[-1] ** -0.5
            out = flash_attention(q, k, v, scale)
            sync()
            errs.append(check_flash(f"{str(dtype)[6:]} {shape}, {shape[0] * shape[1]} (batch, head) pairs", out,
                                    flash_attention_plain(q, k, v, scale)))
            del q, k, v, out
    return max(errs)


def grad_check(gen):
    """Phase 4: K3 under autograd on the card. With an input that requires
    grad (grad mode on) the call goes through its autograd Function: the
    forward launches K3's LSE instance once, its output equal bit for bit
    to the call under torch.no_grad() (which takes no Function: no autograd
    node, one launch); the backward launches K3-bwd's dK/dV and dQ kernels
    once each, and its gradients hold against the plain backward on the
    same q, k, v, output, lse and do (check_grads). A second derivative
    raises. bf16 and f32 at (2, 4, 100, 64)."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import flash_attention_bwd_plain, flash_attention_plain

    counters = {"flash_attention": flash_cuda.flash_attention, "dkv": flash_cuda.flash_attention_dkv,
                "dq": flash_cuda.flash_attention_dq}
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((2, 4, 100, 64), generator=gen, device=DEVICE).to(dtype) for _ in range(4))
        with torch.no_grad():
            reset_counts(counters)
            ref_out = flash_cuda.flash_attention(q.requires_grad_(), k, v, 0.125)
            if ref_out.grad_fn is not None or {n: c.launches for n, c in counters.items()} != {
                    "flash_attention": 1, "dkv": 0, "dq": 0}:
                fail("K3 under torch.no_grad() did not launch once with no autograd node")
        reset_counts(counters)
        out = flash_cuda.flash_attention(q, k, v, 0.125)
        if type(out.grad_fn).__name__ != "FlashAttentionBackward" or not torch.equal(out, ref_out):
            fail(f"K3 under autograd, {dtype}: no Function node, or an output other than the no-grad call's")
        (dq,) = torch.autograd.grad(out, (q,), do)
        if {n: c.launches for n, c in counters.items()} != {"flash_attention": 1, "dkv": 1, "dq": 1}:
            fail(f"K3 under autograd, {dtype}: launches {({n: c.launches for n, c in counters.items()})}, "
                 "not the forward, dK/dV and dQ once each")
        _, lse = flash_attention_plain(q.detach(), k, v, 0.125, return_lse=True)
        ref = flash_attention_bwd_plain(q.detach(), k, v, ref_out, lse, do, 0.125)
        sync()
        errs.append(check_grads(f"K3 under autograd, {str(dtype)[6:]} (2, 4, 100, 64), dq", (dq,), ref[:1],
                                scale_of=ref))
        try:
            torch.autograd.grad(flash_cuda.flash_attention(q, k, v, 0.125).sum(), (q,), create_graph=True)
        except RuntimeError as e:
            if "Higher-order AD not supported" not in str(e):
                raise
        else:
            fail("K3 under autograd took a second derivative")
        q.requires_grad_(False)
    print("  K3 under autograd: the LSE forward (the no-grad output, bit for bit), dK/dV and dQ once each; "
          "no Function under torch.no_grad(); a second derivative raises", flush=True)
    return max(errs)


def check_grads(name, got, ref, scale_of=None):
    """K3-bwd's gradients `got` against the plain backward's `ref` (tuples
    of tensors), at the stated tolerance; S is the largest |value| of
    `scale_of` (default `ref`), the call's gradient scale. f32: within
    1e-5·S. bf16: each row within FLASH_BF16_ULPS bf16 ulps of its scale,
    the larger of its own largest |ref| and 2^-8·S, and a mean error under
    2^-7 times the larger of the mean |ref| and 2^-8·S. The floor: at N = 1
    dq and dk vanish in exact arithmetic (p = 1, ds = 0) and both sides
    return rounding noise. Returns the largest |err|."""
    s = max(r.float().abs().max().item() for r in (ref if scale_of is None else scale_of))
    worst = 0.0
    for out, r in zip(got, ref):
        if out.shape != r.shape or out.dtype != r.dtype:
            fail(f"{name}: {tuple(out.shape)} {out.dtype} against {tuple(r.shape)} {r.dtype}")
        o, r = out.float(), r.float()
        if not torch.isfinite(o).all():
            fail(f"{name}: non-finite gradients")
        err = (o - r).abs()
        e = err.max().item()
        worst = max(worst, e)
        if out.dtype == torch.float32:
            if e > FLASH_F32_TOL * s:
                fail(f"{name}: max |err| {e} > {FLASH_F32_TOL} x {s}")
        else:
            floor = 2.0**-8 * s
            ulp = 2.0**-8 * r.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
            if (err > FLASH_BF16_ULPS * ulp).any():
                fail(f"{name}: {(err / ulp).max().item():.2f} bf16 ulps at the row's scale > {FLASH_BF16_ULPS}")
            if err.mean().item() > 2.0**-7 * max(r.abs().mean().item(), floor):
                fail(f"{name}: mean |err| {err.mean().item()} > 2^-7 * mean |ref|")
    print(f"  {name}: max |err| {worst:.3g}, {worst / max(s, 1e-30):.3g} of the gradients' largest |value| {s:.3g}",
          flush=True)
    return worst


def flash_bwd_cases(gen):
    """Phase 11.1: K3-bwd against its plain backward at every N of
    FLASH_BWD_NS, head width (32, 64, 80) and dtype: q, k and v strided
    views of one (B, N, 3, H, hd) buffer and do a (B, H, N, hd) view of
    (B, N, H, hd) memory, as the ViT hands them over; lse from K3's LSE
    instance (its output equal bit for bit to the no-grad call's, its lse
    within 1e-5·max(1, |plain lse|)); each kernel run twice, the same bits;
    f32's error printed beside its chains of truncating adds (F32_BWD_TILE).
    Returns the largest |err|."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import (flash_attention_di, flash_attention_dkv_plain,
                                           flash_attention_dq_plain, flash_attention_plain)

    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (32, 64, 80):
            heads = 16 if hd == 80 else 12
            for n in FLASH_BWD_NS:
                b, scale = FLASH_BWD_CASE_B, hd**-0.5
                qkv = torch.randn((b, n, 3, heads, hd), generator=gen, device=DEVICE).to(dtype).permute(2, 0, 3, 1, 4)
                q, k, v = qkv[0], qkv[1], qkv[2]
                do = torch.randn((b, n, heads, hd), generator=gen, device=DEVICE).to(dtype).transpose(1, 2)
                label = f"K3-bwd {str(dtype)[6:]} ({b}, {heads}, {n}, {hd})"
                with torch.no_grad():
                    o_ng = flash_cuda.flash_attention(q, k, v, scale)
                    if DEVICE == "cuda":
                        lse = torch.empty((b, heads, n), device=DEVICE)
                        o = flash_cuda._forward(q, k, v, scale, lse)
                    else:  # a CPU rehearsal: the Function's plain forward
                        o, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
                    _, lse_ref = flash_attention_plain(q, k, v, scale, return_lse=True)
                    sync()
                    if not torch.equal(o, o_ng):
                        fail(f"{label}: K3's LSE instance's output differs from the no-grad call's")
                    lse_err = (lse - lse_ref).abs().max().item()
                    if lse_err > 1e-5 * max(1.0, lse_ref.abs().max().item()):
                        fail(f"{label}: lse off the plain version's by {lse_err}")
                    di = flash_attention_di(o, do)
                    runs = []
                    for _ in range(2):
                        dk, dv = flash_cuda.flash_attention_dkv(q, k, v, lse, do, di, scale)
                        runs.append((flash_cuda.flash_attention_dq(q, k, v, lse, do, di, scale), dk, dv))
                    sync()
                    if not all(torch.equal(a, c) for a, c in zip(*runs)):
                        fail(f"{label}: two runs of K3-bwd differ")
                    ref = (flash_attention_dq_plain(q, k, v, lse, do, di, scale),
                           *flash_attention_dkv_plain(q, k, v, lse, do, di, scale))
                    r, tiles = F32_BWD_TILE[hd], -(-n // F32_BWD_TILE[hd])
                    chain = "" if dtype == torch.bfloat16 else (
                        f"; chains of {3 * r // 8} truncating adds a tile of {r} rows, {tiles} tile(s)")
                    errs.append(check_grads(f"{label}, lse err {lse_err:.2g}, two runs equal{chain}", runs[0], ref))
                del qkv, q, k, v, do
    return max(errs)


def flash_bwd_many_heads(gen, sizes=None):
    """Phase 11.1: K3-bwd past 65,535 (batch, head) pairs (many_heads_shapes),
    bf16 and f32: lse from K3's LSE instance (the plain forward's on a CPU
    rehearsal), both kernels run twice for the same bits and against the
    plain backward (check_grads). Returns the largest |err|."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import (flash_attention_di, flash_attention_dkv_plain,
                                           flash_attention_dq_plain, flash_attention_plain)

    errs = []
    for shape in many_heads_shapes(sizes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(4))
            scale = shape[-1] ** -0.5
            with torch.no_grad():
                if DEVICE == "cuda":
                    lse = torch.empty(shape[:3], device=DEVICE)
                    o = flash_cuda._forward(q, k, v, scale, lse)
                else:
                    o, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
                di = flash_attention_di(o, do)
                runs = []
                for _ in range(2):
                    dk, dv = flash_cuda.flash_attention_dkv(q, k, v, lse, do, di, scale)
                    runs.append((flash_cuda.flash_attention_dq(q, k, v, lse, do, di, scale), dk, dv))
                sync()
                label = f"K3-bwd {str(dtype)[6:]} {shape}, {shape[0] * shape[1]} (batch, head) pairs"
                if not all(torch.equal(a, c) for a, c in zip(*runs)):
                    fail(f"{label}: two runs of K3-bwd differ")
                ref = (flash_attention_dq_plain(q, k, v, lse, do, di, scale),
                       *flash_attention_dkv_plain(q, k, v, lse, do, di, scale))
                errs.append(check_grads(f"{label}, two runs equal", runs[0], ref))
            del q, k, v, do, o, lse, di, runs, ref
    return max(errs)


def flash_grad_path(gen_seed):
    """Phase 11.2, the gradient path: PRESET at INPUT (ViT-B/14 at 518, N =
    1,370, 12 heads of 64, 12 blocks), random weights from `gen_seed` with
    LayerScale LAYERSCALE, GRAD_BATCH seeded images; the loss Σ patch
    tokens · g (g seeded); the gradients of the input and of every
    parameter under attention_impl='flash' (K3 with K3-bwd) against 'xla'
    (plain torch autograd), in f32 and bf16. f32: each tensor within 1e-4
    of its largest |'xla' gradient|. bf16: every tensor's error against
    the f32 'xla' gradient, over that tensor's largest |value|, pooled: the
    'flash' run's max and mean no more than TOKEN_F32_MARGIN times the bf16
    'xla' run's. Each 'flash' run launches K3 and each K3-bwd kernel once
    per block (the counts set to 0 just before it and read just after).
    Returns (runs, launches by run)."""
    from hbird_tpu_torch.models import VIT_PRESETS, ViT
    from hbird_tpu_torch.ops import flash_cuda

    cfg = VIT_PRESETS[PRESET]
    t0 = time.perf_counter()
    vit = ViT(cfg, generator=torch.Generator().manual_seed(gen_seed))
    with torch.no_grad():
        for blk in vit.blocks:
            if cfg.layerscale:
                blk.ls1.fill_(LAYERSCALE)
                blk.ls2.fill_(LAYERSCALE)
    vit.to(DEVICE)
    init_s = time.perf_counter() - t0
    host = torch.Generator().manual_seed(gen_seed)
    imgs = torch.randn((GRAD_BATCH, 3, INPUT, INPUT), generator=host).to(DEVICE)
    n_patch = (INPUT // cfg.patch_size) ** 2
    if vit.pos_embed.shape[1] != 1 + n_patch:  # not the native grid (a rehearsal): a resampled, fixed table
        vit.prepare(INPUT)
    g = torch.randn((GRAD_BATCH, n_patch, cfg.width), generator=host).to(DEVICE)
    counters = {"flash_attention": flash_cuda.flash_attention, "flash_attention_dkv": flash_cuda.flash_attention_dkv,
                "flash_attention_dq": flash_cuda.flash_attention_dq}

    def grads(impl, dtype):
        _set_attention(vit, impl)
        vit.zero_grad(set_to_none=True)
        x = imgs.clone().requires_grad_()
        reset_counts(counters)
        t = time.perf_counter()
        (vit(x, compute_dtype=dtype)["x_norm_patchtokens"] * g).sum().backward()
        sync()
        wall = time.perf_counter() - t
        n = {name: fn.launches for name, fn in counters.items()}
        n_forms = read_forms(counters)
        out = {"input": x.grad, **{name: p.grad for name, p in vit.named_parameters() if p.grad is not None}}
        vit.zero_grad(set_to_none=True)
        return out, n, n_forms, wall

    runs, launches = {}, {}
    truth, _, _, wall_xla = grads("xla", torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        flash, n, forms, wall = grads("flash", dtype)
        label = f"{PRESET} at {INPUT}, batch {GRAD_BATCH}, {dt}, attention_impl='flash'"
        want = {"flash_attention": cfg.depth, "flash_attention_dkv": cfg.depth, "flash_attention_dq": cfg.depth}
        if n != want:
            fail(f"{label}: launches {n}, not {want} (K3, dK/dV and dQ once per block)")
        launches[f"grad {dt} flash"] = n
        if set(flash) != set(truth) or len(truth) < sum(1 for _ in vit.parameters()) - (INPUT != cfg.img_size):
            fail(f"{label}: a tensor without its gradient")
        if dtype == torch.float32:
            worst = max(((flash[k] - truth[k]).abs().max() / truth[k].abs().max().clamp_min(1e-30)).item()
                        for k in truth)
            if worst > 1e-4:
                fail(f"{label}: a gradient off 'xla''s by {worst} of its largest |value| (> 1e-4)")
            run = {"max_err_over_max": worst, "xla_wall_s": wall_xla}
            print(f"  {label}: every gradient within {worst:.3g} of its largest |'xla' value| "
                  f"({len(truth)} tensors); launches {json.dumps(n)}; wall {wall:.3f} s ('xla' {wall_xla:.3f} s)",
                  flush=True)
        else:
            xla, _, _, wall_x = grads("xla", dtype)
            off = {}
            for impl, got in (("flash", flash), ("xla", xla)):
                errs = torch.cat([((got[k].float() - truth[k]).abs() / truth[k].abs().max().clamp_min(1e-30))
                                  .flatten() for k in truth])
                off[impl] = {"max": errs.max().item(), "mean": errs.mean().item()}
            f, x = off["flash"], off["xla"]
            if f["max"] > TOKEN_F32_MARGIN[0] * x["max"] or f["mean"] > TOKEN_F32_MARGIN[1] * x["mean"]:
                fail(f"{label}: gradients further from the f32 'xla' ones than bf16 'xla''s: {off}")
            run = {"vs_f32_xla": off, "xla_wall_s": wall_x}
            print(f"  {label}: against the f32 'xla' gradients (each over its tensor's largest |value|, pooled) "
                  f"max {f['max']:.4g}, mean {f['mean']:.4g}; bf16 'xla' max {x['max']:.4g}, mean {x['mean']:.4g}; "
                  f"launches {json.dumps(n)}; wall {wall:.3f} s ('xla' {wall_x:.3f} s)", flush=True)
            del xla
        runs[label] = {**run, "launches": n, "forms": forms, "wall_s": wall,
                       "host_init_s": init_s, "tensors": len(truth)}
        del flash
    del vit, truth
    return runs, launches


def bwd_bound_ms(shape, dtype, flops=BWD_FLOPS, io=8, rows=4):
    """K3-bwd's least time: `io` (B, H, N, hd) tensors moved once (q, k, v,
    o, do read and dq, dk, dv written: 8) and `rows` bytes a row (lse), or
    flops·B·H·N²·hd operations at the card's peak for the type (bf16; f32
    at f32 accuracy on the tensor cores: TF32_PASSES passes at the TF32
    peak)."""
    b, h, n, hd = shape
    elt = 2 if dtype == torch.bfloat16 else 4
    t_bytes = (io * b * h * n * hd * elt + rows * b * h * n) / PEAK_BYTES * 1e3
    ops = flops * b * h * n * n * hd
    t_ops = (ops / PEAK_BF16_FLOPS if dtype == torch.bfloat16 else TF32_PASSES * ops / PEAK_TF32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def trace_split(fn, reps=5):
    """Where a call's time goes: torch.profiler over `reps` calls of `fn`
    (the card's kernels by CUPTI; on a CPU rehearsal the CPU ops), each
    kernel's or op's self time in ms a call, largest first. Empty where the
    trace holds no device time (the CUDA-event times stand then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    cuda = DEVICE == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        sync()
    split = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)) if cuda \
            else ev.self_cpu_time_total
        if us > 0:
            split[ev.key] = us / reps / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def sdpa_backend(q, k, v, scale):
    """The backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=scale)).name


def flash_bwd_timing(gen):
    """Phase 11.3: K3-bwd at the main shape (FLASH_MAIN), hd 32 (FLASH_NARROW)
    and hd 80 (FLASH_WIDE), bf16 and f32: the whole backward
    (flash_attention_bwd: di, then the dK/dV and dQ kernels) host-launched
    (`ms`), in one CUDA graph (`graph_ms`) and, at the main shape, traced by
    kernel (`trace_ms`, trace_split), each kernel alone
    host-launched, against the bound (BWD_FLOPS; the library split's
    BWD_SPLIT_FLOPS beside it; each kernel's own: 8 and 6), the plain
    backward, and scaled_dot_product_attention's backward (a yardstick the
    port never calls; host-launched, its backend named). Returns (rows by
    label, the largest |err|)."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import (flash_attention_bwd_plain, flash_attention_di,
                                           flash_attention_dkv_plain, flash_attention_dq_plain,
                                           flash_attention_plain)

    rows, errs = {}, []
    for label, shape in (("main", FLASH_MAIN), ("hd32", FLASH_NARROW), ("hd80", FLASH_WIDE)):
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            scale = shape[-1] ** -0.5
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(4))
            with torch.no_grad():
                o, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
                di = flash_attention_di(o, do)
                box = {}
                plain_ms = cuda_ms(lambda: box.update(ref=flash_attention_bwd_plain(q, k, v, o, lse, do, scale)), 2)
                ref = box.pop("ref")
                errs.append(check_grads(f"K3-bwd timing shape {dt} {shape}",
                                        flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale), ref))
                del ref
                plain_dkv = cuda_ms(lambda: flash_attention_dkv_plain(q, k, v, lse, do, di, scale), 2)
                plain_dq = cuda_ms(lambda: flash_attention_dq_plain(q, k, v, lse, do, di, scale), 2)

                def bwd():
                    flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale)

                ms, g_ms = cuda_ms(bwd, 10), graph_ms(bwd, 10)
                trace = trace_split(bwd) if label == "main" else {}
                dkv_ms = cuda_ms(lambda: flash_cuda.flash_attention_dkv(q, k, v, lse, do, di, scale), 10)
                dq_ms = cuda_ms(lambda: flash_cuda.flash_attention_dq(q, k, v, lse, do, di, scale), 10)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            backend = sdpa_backend(*leaves, scale)
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True), 10)
            del sdpa_out, leaves
            b_ms, b_by = bwd_bound_ms(shape, dtype)
            split_ms = bwd_bound_ms(shape, dtype, BWD_SPLIT_FLOPS)[0]
            dkv_bound = bwd_bound_ms(shape, dtype, 8, io=6, rows=8)
            dq_bound = bwd_bound_ms(shape, dtype, 6, io=5, rows=8)
            key = label if dtype == torch.bfloat16 else f"f32 {label}" if label != "main" else "f32"
            rows[key] = {"shape": list(shape), "dtype": dt, "route": flash_cuda.route(dtype, shape[-1], "dkv"),
                         "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "split_bound_ms": split_ms, "library_ms": lib_ms, "library": f"SDPA backward ({backend})",
                         "dkv": {"ms": dkv_ms, "plain_ms": plain_dkv, "bound_ms": dkv_bound[0],
                                 "bound_by": dkv_bound[1]},
                         "dq": {"ms": dq_ms, "plain_ms": plain_dq, "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
                         "trace_ms": trace}
            print(f"  K3-bwd {dt} {shape} ({rows[key]['route']}): {ms:.4f} ms host-launched, {g_ms:.4f} in a "
                  "CUDA graph "
                  f"(dK/dV {dkv_ms:.4f}, dQ {dq_ms:.4f}); plain {plain_ms:.4f}; SDPA backward ({backend}) "
                  f"{lib_ms:.4f}; bound {b_ms:.4f} ms ({b_by}; the split's {split_ms:.4f}; dK/dV's "
                  f"{dkv_bound[0]:.4f}, dQ's {dq_bound[0]:.4f}): {shares(ms, b_ms, lib_ms)}", flush=True)
            if label == "main":
                split = "; ".join(f"{name[:60]} {t:.4f}" for name, t in trace.items())
                print(f"    trace, ms a backward by kernel: {split or 'no device time in the trace'}", flush=True)
            del q, k, v, do, o, lse, di
    return rows, max(errs)


def bwd_entry(name, key, tpu_kernel, launches, err, rows, card):
    """One K3-bwd kernel (`key`: 'dkv' or 'dq') of the `kernels` line: its
    own numbers at the main shape in bf16 (no one PyTorch call computes
    that half alone: `library_ms` null; the whole backward's SDPA time is
    in `shapes`)."""
    main = rows["main"][key]
    return {"name": name, "route": "cuda", "form": rows["main"]["route"],
            "source": "hbird_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": tpu_kernel, "launches": launches, "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": rows, "card": card}


def shares(ms, bound, library):
    """'share of the bound x, y x the library' for a timed row."""
    lib = "no library call" if library is None else f"{ms / library:.3f}x the library call"
    return f"{bound / ms:.1%} of the bound, {lib}"


# Warpgroup MMAs (HGMMA float, IGMMA integer), TMA loads, and mma.sync
# (HMMA float, IMMA integer).
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")
# ptxas notes on wgmma: a warpgroup.wait (C7517) or warpgroup.arrive (C7519)
# it injected, or wgmma serialised (C7520; C7511: for want of registers).
WGMMA_NOTES = ("C7511", "C7517", "C7519", "C7520")


def ptxas_report(log, name):
    """Of the kernel `name` in an nvcc -Xptxas -v log: each instance's
    template arguments (as mangled), registers at entry and spill stores;
    the setmaxnreg-ignored warnings; and the WGMMA_NOTES lines."""
    lines = log.splitlines()
    args, regs, spills = [], [], []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            targs = re.search(re.escape(name) + r"(I\w*?(?:FlatE|SlabsE|Li\d+E|Lb[01]E))E", line)
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


def check_no_mma_sync(src, total):
    """Phase 1: fails where a library of NO_MMA_SYNC (K1's, K2's, K3's,
    K3-bwd's) holds an mma.sync instruction (HMMA or IMMA among its SASS
    counts `total`)."""
    if src in NO_MMA_SYNC and (total["HMMA"] or total["IMMA"]):
        fail(f"{src}: {total['HMMA']} HMMA and {total['IMMA']} IMMA instructions: a K1, K2, K3 or K3-bwd form "
             "still runs mma.sync")


def build_report(libs):
    """Phase 1: what ptxas said of the Hopper kernels, the shared memory
    they ask for, and the SASS instructions of each library by cuobjdump
    (where it exists): each wgmma kernel must issue warpgroup MMAs (HGMMA,
    or IGMMA for int8) and UTMALDG and no mma.sync (HMMA, IMMA)."""
    import ctypes
    import shutil

    from hbird_tpu_torch.ops import cuda_build

    report = {}
    for src, name in ((src, name) for src, names in WGMMA_KERNELS.items() for name in names):
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
        for form, want in WGMMA_FORMS.get(src, {}).items():
            got = {a: (regs[a], spills[a]) for a in regs if a.startswith(form)}
            if len(got) != want or any(sp for _, sp in got.values()):
                fail(f"ptxas: {src}'s wgmma instances of {form} (want {want}, none spilling): {got}")
            report[f"{src}:{form}"] = got
            print(f"  ptxas, {src} {form} ({len(got)} instances): (registers, spill bytes) {json.dumps(got)}",
                  flush=True)
        if src == "flash_attn.cu":
            widths = {a: (regs[a], spills[a]) for a in regs}
            if set(widths) != set(K3_WGMMA_WIDTHS) or any(sp for _, sp in widths.values()):
                fail(f"ptxas: K3's {name} instances by head width and LSE flag (want {sorted(K3_WGMMA_WIDTHS)}, "
                     f"none spilling): {widths}")
            if any("(C7511)" in note for note in r["wgmma_notes"]):
                fail(f"ptxas serialised the wgmma of {name} for want of registers (C7511)")
            report[f"flash_attn.cu:{name}:widths"] = widths
    report.update(bwd_build_report())
    k1 = ctypes.CDLL(str(libs["knn_topk.cu"]))
    k2 = ctypes.CDLL(str(libs["ivf_topk.cu"]))
    k3 = ctypes.CDLL(str(libs["flash_attn.cu"]))
    k1.knn_topk_wgmma_smem.argtypes, k1.knn_topk_wgmma_smem.restype = (ctypes.c_int,) * 2, ctypes.c_int
    k2.ivf_topk_wgmma_smem.argtypes, k2.ivf_topk_wgmma_smem.restype = (ctypes.c_int,) * 2, ctypes.c_int
    k3.flash_attn_wgmma_smem.argtypes, k3.flash_attn_wgmma_smem.restype = (ctypes.c_int,) * 2, ctypes.c_int
    smem = {"K1 f32": k1.knn_topk_wgmma_smem(DEPTH, 0), "K1 bf16": k1.knn_topk_wgmma_smem(DEPTH, 1),
            "K1 int8": k1.knn_topk_wgmma_smem(DEPTH, 2), "K1 asym": k1.knn_topk_wgmma_smem(DEPTH, 3),
            "K2 f32": k2.ivf_topk_wgmma_smem(DEPTH, 0), "K2 bf16": k2.ivf_topk_wgmma_smem(DEPTH, 1),
            "K2 int8": k2.ivf_topk_wgmma_smem(DEPTH, 2), "K2 asym": k2.ivf_topk_wgmma_smem(DEPTH, 3),
            **{f"K3 {dt} hd {hd}": k3.flash_attn_wgmma_smem(hd, bf16) for hd in K3_WGMMA_WIDTHS.values()
               for dt, bf16 in (("bf16", 1), ("f32", 0))}}
    if not all(smem.values()):
        fail(f"a form on the wgmma kernels asks for no shared memory (another route): {smem}")
    print(f"  dynamic shared memory at D={DEPTH}: {json.dumps(smem)} B", flush=True)
    report["smem_bytes"] = smem
    # past the resident queries' edge, bf16, asym and int8 stream theirs: a size at every depth
    deep = {f"{name} {form_name} D={d}": fn(d, form)
            for name, fn in (("K1", k1.knn_topk_wgmma_smem), ("K2", k2.ivf_topk_wgmma_smem))
            for form, form_name, depths in ((1, "bf16", (BF16_MAX_RESIDENT, BF16_MAX_RESIDENT + 64) + BF16_DEPTHS),
                                            (3, "asym", (ASYM_MAX_RESIDENT,) + ASYM_DEPTHS),
                                            (2, "int8", (S8_MAX_RESIDENT,) + DEEP_INT8_DEPTHS))
            for d in depths}
    if not all(deep.values()):
        fail(f"bf16, asym or int8 asks for no shared memory at a depth: {deep}")
    print(f"  dynamic shared memory of bf16, asym and int8 past their resident queries' edge: {json.dumps(deep)} B",
          flush=True)
    report["smem_bytes_deep"] = deep
    # every form of K1 and K2 at every depth the wrappers take (a multiple of 8, of 16 with int8 codes)
    none = [(name, form, d) for name, fn in (("K1", k1.knn_topk_wgmma_smem), ("K2", k2.ivf_topk_wgmma_smem))
            for form in range(4) for d in SMEM_DEPTHS if (form < 2 or d % 16 == 0) and fn(d, form) <= 0]
    if none:
        fail(f"K1 or K2 reports no wgmma kernel for (kernel, form, depth): {none[:8]} ({len(none)} in all)")
    print(f"  K1 and K2 report a wgmma kernel for every form at every depth {SMEM_DEPTHS.start}-"
          f"{SMEM_DEPTHS.stop - 1} (a multiple of 8, 16 with int8 codes)", flush=True)
    tool = shutil.which("cuobjdump") or shutil.which("cuobjdump", path="/usr/local/cuda/bin")
    if tool is None:
        fail("cuobjdump not found: the SASS of the K1 and K2 libraries cannot be checked for mma.sync")
    dumps = {src: subprocess.Popen([tool, "-sass", str(path)], stdout=subprocess.PIPE, text=True)
             for src, path in libs.items()}  # the three listings at once
    with ThreadPoolExecutor(len(dumps)) as pool:
        listings = dict(zip(dumps, pool.map(lambda proc: proc.communicate()[0], dumps.values())))
    for src, path in libs.items():
        per_fn = sass_counts(listings[src])
        total = {op: sum(c[op] for c in per_fn.values()) for op in SASS_OPS}
        names = WGMMA_KERNELS.get(src, ())
        wg_fns = {f: c for f, c in per_fn.items() if any(name in f for name in names)}
        print(f"  SASS of {path.name}: {json.dumps(total)}; wgmma kernels ({', '.join(SASS_OPS)}): "
              f"{json.dumps(sorted({tuple(c.values()) for c in wg_fns.values()}))}", flush=True)
        tf32 = {f: c for f, c in per_fn.items() if TF32_KERNEL in f or any(f"{n}{F32_FORM}" in f for n in names)}
        if tf32:
            print(f"  SASS of the 3xTF32 kernels ({TF32_KERNEL}, K1's F32 instances; {', '.join(SASS_OPS)}): "
                  f"{json.dumps(sorted({tuple(c.values()) for c in tf32.values()}))}", flush=True)
        for f, c in wg_fns.items():
            if c["HGMMA"] + c["IGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] or c["IMMA"]:
                fail(f"{f}: {c} (a wgmma kernel must issue HGMMA or IGMMA and UTMALDG, and no HMMA or IMMA)")
        for name in names:
            if not any(name in f for f in wg_fns):
                fail(f"{path.name}: no {name} kernel in the SASS")
        for form, want in WGMMA_FORMS.get(src, {}).items():
            n = sum(f"{names[0]}{form}" in f for f in wg_fns)
            if n != want:
                fail(f"{path.name}: {n} wgmma kernels of {form} in the SASS, not {want}")
        for name in names if src == "flash_attn.cu" else ():
            got = sorted(hd for a, hd in K3_WGMMA_WIDTHS.items() if any(f"{name}{a}" in f for f in wg_fns))
            if got != sorted(K3_WGMMA_WIDTHS.values()):
                fail(f"{path.name}: {name} kernels of head widths {got} in the SASS, not "
                     f"{sorted(K3_WGMMA_WIDTHS.values())}")
        check_no_mma_sync(src, total)
        if src == "flash_bwd.cu":
            report["flash_bwd.cu:sass"] = check_bwd_sass(per_fn)
            print(f"  SASS of K3-bwd by instance ({', '.join(SASS_OPS)}): "
                  f"{json.dumps({f: tuple(c.values()) for f, c in report['flash_bwd.cu:sass'].items()})}", flush=True)
        report[path.name] = {"total": total, "wgmma_kernels": len(wg_fns)}
    print(f"  no HMMA or IMMA in {', '.join(NO_MMA_SYNC)}'s libraries: every form on a wgmma kernel", flush=True)
    return report


def check_bwd_sass(per_fn):
    """Phase 1: K3-bwd's instances by function in flash_bwd.cu's SASS
    (sass_counts): each of BWD_KERNELS at each of BWD_INSTANCES present;
    every instance, bf16 and f32 (3xTF32), runs wgmma: HGMMA and UTMALDG
    and no HMMA. Returns the counts by instance."""
    got = {f"{name} {dt} hd {hd}": c for f, c in per_fn.items() for name in BWD_KERNELS
           for args, (dt, hd) in BWD_INSTANCES.items() if f"{name}{args}" in f}
    want = {f"{name} {dt} hd {hd}" for name in BWD_KERNELS for dt, hd in BWD_INSTANCES.values()}
    if set(got) != want:
        fail(f"flash_bwd.cu's SASS holds K3-bwd instances {sorted(got)}, not {sorted(want)}")
    for inst, c in got.items():
        if c["HMMA"] or not c["HGMMA"] or not c["UTMALDG"]:
            fail(f"{inst}: {c} (a K3-bwd instance runs wgmma: HGMMA and UTMALDG, no HMMA)")
    return got


def bwd_build_report():
    """Phase 1: K3-bwd's kernels (flash_bwd.cu) as ptxas reported them: one
    instance of each kernel a dtype and head width (BWD_INSTANCES), none
    spilling, none with its wgmma serialised (C7511, C7520); the dynamic
    shared memory each asks for; the f32 tiles' streamed rows
    (F32_BWD_TILE)."""
    import ctypes

    from hbird_tpu_torch.ops import cuda_build

    if "flash_bwd.cu" not in cuda_build.LOGS:
        print("  flash_bwd.cu: built before this run, no ptxas report", flush=True)
        return {}
    report = {}
    for name in BWD_KERNELS:
        r = ptxas_report(cuda_build.LOGS["flash_bwd.cu"], name)
        got = {a: (reg, sp) for a, reg, sp in zip(r["template_args"], r["registers"], r["spill_store_bytes"])}
        if set(got) != set(BWD_INSTANCES) or any(sp for _, sp in got.values()):
            fail(f"ptxas: K3-bwd's {name} instances by dtype and head width (want {sorted(BWD_INSTANCES)}, "
                 f"none spilling): {got}")
        serial = [note for note in r["wgmma_notes"] if any(f"{name}{a}" in note for a in BWD_INSTANCES)
                  and ("(C7511)" in note or "(C7520)" in note)]
        if serial:
            fail(f"ptxas serialised the wgmma of a {name} instance: {serial}")
        report[f"flash_bwd.cu:{name}"] = {f"{BWD_INSTANCES[a][0]} hd {BWD_INSTANCES[a][1]}": v
                                          for a, v in got.items()}
        print(f"  ptxas, flash_bwd.cu {name} ({len(got)} instances): (registers, spill bytes) "
              f"{json.dumps(report[f'flash_bwd.cu:{name}'])}; {len(r['wgmma_notes'])} wgmma notes", flush=True)
        for note in r["wgmma_notes"]:
            print(f"    {note}", flush=True)
    lib = ctypes.CDLL(str(cuda_build.library_path("flash_bwd.cu")))
    lib.flash_bwd_smem.argtypes, lib.flash_bwd_smem.restype = (ctypes.c_int,) * 3, ctypes.c_int
    smem = {f"{name} {dt} hd {hd}": lib.flash_bwd_smem(kernel, hd, dt == "bf16")
            for kernel, name in enumerate(BWD_KERNELS) for dt, hd in BWD_INSTANCES.values()}
    if not all(smem.values()):
        fail(f"a K3-bwd kernel asks for no shared memory: {smem}")
    print(f"  K3-bwd dynamic shared memory: {json.dumps(smem)} B", flush=True)
    report["flash_bwd.cu:smem_bytes"] = smem
    lib.flash_bwd_f32_tile.argtypes, lib.flash_bwd_f32_tile.restype = (ctypes.c_int,), ctypes.c_int
    tiles = {hd: lib.flash_bwd_f32_tile(hd) for hd in F32_BWD_TILE}
    if tiles != F32_BWD_TILE:
        fail(f"the f32 K3-bwd tiles' streamed rows are {tiles}, not {F32_BWD_TILE}")
    print(f"  K3-bwd f32 tiles' streamed rows by head width: {json.dumps(tiles)}", flush=True)
    report["flash_bwd.cu:f32_tile_rows"] = tiles
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
    f32 = (qf, ev.feature_memory)  # the f32 queries and bank of the default 'faiss' run
    return runs, launches, {"K1": err_k1, "K2": err_k2}, tree_info, q, bank, main_tree, f32


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


def _val_batch(root, input_size):
    """The first val batch, normalised as the engine does on the device."""
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import get_hbird_val_transforms

    va = get_hbird_val_transforms(input_size, device_normalize=True)
    ds, _ = get_dataset("voc", root, BATCH, 0, va, va)
    x, _ = next(iter(ds.val_dataloader()))
    mean, std = (torch.tensor(v, device=DEVICE).reshape(1, -1, 1, 1) for v in va["device_norm"])
    return (torch.from_numpy(x).to(DEVICE).float() / 255.0 - mean) / std


def _set_attention(vit, impl):
    """`vit` with every block on attention `impl` (the same weights)."""
    import dataclasses

    vit.config = dataclasses.replace(vit.config, attention_impl=impl)
    for blk in vit.blocks:
        blk.attn.cfg = vit.config
    return vit


def gigantic_shapes(g=None):
    """The shapes of timm's vit_gigantic_patch14_clip_224 state dict that
    the converters read (`g`, GIGANTIC_SHAPE by default; no weights)."""
    import types

    g = g or GIGANTIC_SHAPE
    shape = lambda *dims: types.SimpleNamespace(shape=dims)  # noqa: E731
    grid = g["img"] // g["patch"]
    sd = {"patch_embed.proj.weight": shape(g["width"], 3, g["patch"], g["patch"]),
          "pos_embed": shape(1, grid * grid + 1, g["width"]), "cls_token": shape(1, 1, g["width"])}
    for i in range(g["depth"]):
        sd[f"blocks.{i}.attn.qkv.weight"] = shape(3 * g["width"], g["width"])
        sd[f"blocks.{i}.attn.qkv.bias"] = shape(3 * g["width"])
        sd[f"blocks.{i}.mlp.fc1.weight"] = shape(g["hidden"], g["width"])
        sd[f"blocks.{i}.mlp.fc2.weight"] = shape(g["width"], g["hidden"])
    return sd


def gigantic_config():
    """The ViTConfig the port's converter (`infer_config_from_timm_sd`)
    reads from gigantic_shapes (no weights, no download)."""
    from hbird_tpu_torch.models.convert import infer_config_from_timm_sd

    return infer_config_from_timm_sd(gigantic_shapes())


def flash_path(gen_seed):
    """Phase 5, the flash path: hbird_evaluation with attention_impl='flash'
    against 'xla', the tokens of both on one val batch, and K3 on that
    batch's block-0 q, k, v; at PRESET (head width 64) with the ViT in bf16
    and in f32, and in bf16 at NARROW_PRESET (head width 32, K3 bf16 at hd
    32), WIDE_PRESET (head width 80, K3 bf16 at hd 80, with the int8 runs
    of WIDE_QUANT_RUNS on its 1,280-wide bank), GIANT_PRESET ('flash'
    alone, with GIANT_QUANT_RUNS on its 1,536-wide bank) and the 1,664-wide
    gigantic_config (with GIGANTIC_RUNS: K1 dot, K2 bf16 and K1 l2 with
    the queries streamed). Returns the runs, the launches by run, the
    token errors and K3's worst error."""
    from hbird_tpu_torch.models import VIT_PRESETS

    runs, launches, token_err, err = {}, {}, {}, 0.0
    for cfg, input_size, dtypes, prefix, impls, quant_runs in (
            (VIT_PRESETS[PRESET], INPUT, ("bf16", "f32"), "", ("flash", "xla"), {}),
            (VIT_PRESETS[NARROW_PRESET], NARROW_INPUT, ("bf16",), f"{NARROW_PRESET} at {NARROW_INPUT}, ",
             ("flash", "xla"), {}),
            (VIT_PRESETS[WIDE_PRESET], WIDE_INPUT, ("bf16",), f"{WIDE_PRESET} at {WIDE_INPUT}, ", ("flash", "xla"),
             WIDE_QUANT_RUNS),
            (VIT_PRESETS[GIANT_PRESET], GIANT_INPUT, ("bf16",), f"{GIANT_PRESET} at {GIANT_INPUT}, ", ("flash",),
             GIANT_QUANT_RUNS),
            (gigantic_config(), GIGANTIC_INPUT, ("bf16",), f"{GIGANTIC_NAME} at {GIGANTIC_INPUT}, ",
             ("flash", "xla"), GIGANTIC_RUNS)):
        r, n, t, e = _flash_runs(gen_seed, cfg, input_size, dtypes, prefix, impls, quant_runs)
        runs.update(r)
        launches.update(n)
        token_err.update(t)
        err = max(err, e)
    return runs, launches, token_err, err


def _flash_runs(gen_seed, cfg, input_size, dtypes, prefix, impls, quant_runs):
    """flash_path at one ViT configuration and input size, in `dtypes`, the
    engine run with each attention of `impls`; labels begin with `prefix`.
    One ViT is initialised on the host (its seconds printed) and switched
    between attentions. Then, in bf16 on 'flash', each run of `quant_runs`
    and its recall, and the 'scann' run's (_quant_engine_runs)."""
    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import FeatureExtractor, ViT
    from hbird_tpu_torch.models.vit import _layer_norm, _linear
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    vit = ViT(cfg, generator=torch.Generator().manual_seed(gen_seed))
    n_params = sum(p.numel() for p in vit.parameters())
    init_s = time.perf_counter() - t0
    print(f"  {prefix}a ViT of {n_params / 1e6:.1f}M parameters ({cfg.depth} blocks, width {cfg.width}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, MLP {cfg.mlp_hidden}) initialised on the host in {init_s:.2f}s",
          flush=True)
    if cfg.layerscale:
        # At its 1e-5 init LayerScale leaves the blocks almost silent: the
        # tokens of any attention would then agree to 1e-10. At 0.05 the
        # attention moves the tokens and the mIoU.
        with torch.no_grad():
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
        common = dict(batch_size=BATCH, input_size=input_size, n_neighbours=30, num_workers=0,
                      device=DEVICE, nn_method="scann")
        for dt in dtypes:
            mious = {}
            for impl in impls:
                _set_attention(vit, impl)
                label = f"scann unbounded, {prefix}{dt} ViT, attention_impl={impl!r}"
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
                launches[f"{prefix}{dt} {impl}"] = n
                mious[impl] = miou
                runs[label] = {"miou": miou, "launches": n, "forms": forms, "wall_s": wall,
                               "phases": timer.summary(), "D": cfg.width, "host_init_s": init_s}
                print(f"  {label}: mIoU {miou:.6f}, launches {json.dumps(n)} (K3 expected {expected} = "
                      f"{cfg.depth} blocks x {n_batches} forward batches), wall {wall:.2f}s, "
                      f"phases {json.dumps(timer.summary())}", flush=True)
            print(f"  {prefix}{dt} ViT: mIoU " + ", ".join(f"{impl!r} {m:.6f}" for impl, m in mious.items())
                  + (f", 'flash' - 'xla' {mious['flash'] - mious['xla']:.3g}" if len(mious) > 1 else ""),
                  flush=True)
        _set_attention(vit, "flash")
        if quant_runs:
            r, n, scann_recall = _quant_engine_runs(vit, cfg, input_size, root, quant_runs, prefix, counters,
                                                    expected)
            runs.update(r)
            launches.update(n)
            runs[f"scann unbounded, {prefix}bf16 ViT, attention_impl='flash'"].update(scann_recall)
        imgs = _val_batch(root, input_size)

    token_err = {}
    dtypes = [torch.bfloat16 if dt == "bf16" else torch.float32 for dt in dtypes]
    with torch.inference_mode():
        for dtype in dtypes:
            max_tol, mean_tol = TOKEN_TOL[dtype]
            tokens = {impl: FeatureExtractor(_set_attention(vit, impl), use_bf16=dtype == torch.bfloat16)
                      .forward_features(imgs)[0] for impl in ("flash", "xla")}
            err = (tokens["flash"] - tokens["xla"]).abs()
            name = f"{prefix}{str(dtype)[6:]}"
            token_err[name] = {"max": err.max().item(), "mean": err.mean().item()}
            print(f"  flash vs xla patch tokens on one val batch, {name}: max |err| "
                  f"{err.max().item():.3g}, mean {err.mean().item():.3g}", flush=True)
            if cfg.depth <= TOKEN_TOL_DEPTH and (err.max().item() > max_tol or err.mean().item() > mean_tol):
                fail(f"flash vs xla patch tokens, {prefix}{dtype}: {token_err[name]}")
            if dtype == torch.bfloat16:
                # Each bf16 forward against the f32 'xla' forward of the same
                # weights: 'flash' may lie no further from it than 'xla' does.
                truth = FeatureExtractor(vit, use_bf16=False).forward_features(imgs)[0]
                off = {impl: (t.float() - truth).abs() for impl, t in tokens.items()}
                del truth
                for impl, e in off.items():
                    token_err[name][f"{impl}_vs_f32"] = {"max": e.max().item(), "mean": e.mean().item()}
                f, x = token_err[name]["flash_vs_f32"], token_err[name]["xla_vs_f32"]
                print(f"  bf16 patch tokens against the f32 forward, {name}: 'flash' max |err| {f['max']:.4g}, "
                      f"mean {f['mean']:.4g}; 'xla' max {x['max']:.4g}, mean {x['mean']:.4g}", flush=True)
                if f["max"] > TOKEN_F32_MARGIN[0] * x["max"] or f["mean"] > TOKEN_F32_MARGIN[1] * x["mean"]:
                    fail(f"bf16 'flash' tokens further from the f32 forward than 'xla''s, {prefix}: {token_err[name]}")
            del tokens
        # K3 on the main path's own inputs: block 0's q, k, v, strided views
        # of its qkv projection, as the ViT hands them over.
        _set_attention(vit, "flash")
        blk = vit.blocks[0]
        scale = cfg.head_dim**-0.5
        err_k3 = 0.0
        for dtype in dtypes:
            x = vit._embed(imgs, dtype)
            y = _layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
            b, n, _ = y.shape
            qkv = _linear(y, blk.attn.qkv).reshape(b, n, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            err_k3 = max(err_k3, check_flash(
                f"K3 {str(dtype)[6:]}, {prefix}main path's block-0 q, k, v {tuple(q.shape)} (strided views)",
                flash_attention(q, k, v, scale), flash_attention_plain(q, k, v, scale)))
    del vit
    return runs, launches, token_err, err_k3


def _quant_engine_runs(vit, cfg, input_size, root, quant_runs, prefix, counters, expected):
    """Phase 5 on a wide bank: hbird_evaluation with the bf16 'flash' ViT
    `vit` and each run of `quant_runs` (nn_method, nn_params, bf16_bank,
    (kernel, form)), K3 launching `expected` times and the run's K1 or K2
    form once per eval batch, nothing else; then each backend, and the
    'scann' run's, built on the run's bank, and its recall@30 against K1's
    exact bf16 neighbours for one eval batch, by ids and by score. Returns
    (runs, launches by run, the 'scann' backend's recall)."""
    from hbird_tpu_torch import HbirdEvaluation, hbird_evaluation
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import get_hbird_train_transforms
    from hbird_tpu_torch.models import FeatureExtractor
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    n_eval = -(-FIXTURE["n_val"] // BATCH)
    common = dict(batch_size=BATCH, input_size=input_size, n_neighbours=30, num_workers=0, device=DEVICE,
                  bf16_model=True)
    runs, launches = {}, {}
    for name, (method, params, bf16_bank, (kernel, form)) in quant_runs.items():
        label = f"{name}, {prefix}bf16 ViT, attention_impl='flash'"
        timer = PhaseTimer()
        random.seed(0)
        reset_counts(counters)
        t0 = time.perf_counter()
        miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, nn_method=method,
                                nn_params=dict(params), bf16_bank=bf16_bank, timer=timer, **common)
        wall = time.perf_counter() - t0
        n = {c: fn.launches for c, fn in counters.items()}
        forms = read_forms(counters)
        others = sum(v for c, v in n.items() if c not in (kernel, "flash_attention"))
        if forms[kernel] != {form: n_eval} or others or forms["flash_attention"] != {"bf16": expected}:
            fail(f"{label}: launches by form {forms}, not {kernel} {form} x {n_eval} and K3 bf16 x {expected}")
        if not (0.0 <= miou <= 1.0):
            fail(f"{label}: mIoU {miou} not a finite value in [0, 1]")
        launches[f"{prefix}bf16 {name}"] = n
        runs[label] = {"nn_method": method, "nn_params": params, "bf16_bank": bf16_bank, "miou": miou,
                       "launches": n, "forms": forms, "wall_s": wall, "phases": timer.summary(), "D": cfg.width}
        print(f"  {label} ({method}, {json.dumps(params)}{', bf16 bank' if bf16_bank else ''}): mIoU {miou:.6f}, "
              f"launches by form {json.dumps(forms)}, wall {wall:.2f}s, phases {json.dumps(timer.summary())}",
              flush=True)
    # The runs' bank and one eval batch of queries, as the engine builds them.
    tr = get_hbird_train_transforms(input_size, device_normalize=True)
    ds, _ = get_dataset("voc", root, BATCH, 0, tr, tr)
    random.seed(0)
    fe = FeatureExtractor(vit, eval_spatial_resolution=input_size // cfg.patch_size, d_model=cfg.width,
                          use_bf16=True)
    ev = HbirdEvaluation(fe, ds.train_dataloader(), num_classes=ds.get_num_classes(), device=DEVICE,
                         nn_method="faiss", dataset_size=ds.get_train_dataset_size(), device_norm=tr["device_norm"])
    with torch.inference_mode():
        qf = fe.forward_features(_val_batch(root, input_size))[0].reshape(-1, cfg.width).float().contiguous()
    bank = ev.feature_memory.to(torch.bfloat16).contiguous()
    q = qf.to(torch.bfloat16).contiguous()
    flat_vals, flat_idx = knn_topk(q, bank, 30)
    scann_recall = {}
    for name, (method, params, bf16_bank, _) in {"scann": ("scann", {}, False, None), **quant_runs}.items():
        ev.bf16_bank = bf16_bank
        ev._create_nn(30, method, **params)
        nn = ev.NN_algorithm
        _, idx, _ = nn.search_with_labels_pure(nn.device_state, qf, 30, **ev._search_opts)
        r = (idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()
        rs = score_recall(idx, q, bank, flat_vals[:, -1])
        run = scann_recall if name == "scann" else runs[f"{name}, {prefix}bf16 ViT, attention_impl='flash'"]
        run.update(recall_at_30_vs_k1_bf16=r, score_recall_at_30_vs_k1_bf16=rs)
        print(f"  recall@30 of {name} ({prefix}bank {tuple(bank.shape)}) against K1's exact bf16 neighbours: "
              f"{r:.4f} by ids, {rs:.4f} by score", flush=True)
        del nn
    del ev, bank
    return runs, launches, scann_recall


def card_vs_cpu():
    """Phase 6: the same small run on the card and on the CPU agrees."""
    import copy

    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import ViT, ViTConfig

    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    vit = ViT(ViTConfig(4, 64, 2, 4, img_size=32, layerscale=True),
              generator=torch.Generator().manual_seed(1))
    # head widths 32 (the narrowest K3 takes) and 80 (the widest); no
    # LayerScale, so the attention is not silent at init
    flash_vit = ViT(ViTConfig(4, 64, 2, 2, img_size=32, attention_impl="flash"),
                    generator=torch.Generator().manual_seed(1))
    wide_vit = ViT(ViTConfig(4, 160, 2, 2, img_size=32, attention_impl="flash"),
                   generator=torch.Generator().manual_seed(1))
    result = {}
    full_probe = {"num_leaves": SMALL_LEAVES, "num_leaves_to_search": SMALL_LEAVES}
    # The flash ViT runs 'faiss', whose f32 bank passes the card's and the
    # CPU's forward through unrounded.
    # (nn_method, model, nn_params, bf16_bank, soft labels held to SMALL_TOL)
    cases = {"scann": ("scann", vit, None, False, True), "faiss": ("faiss", vit, None, False, True),
             "ivf": ("ivf", vit, full_probe, False, True),
             "ivf f32": ("ivf", vit, dict(full_probe, use_fp16=False), False, True),
             "faiss, flash ViT": ("faiss", flash_vit, None, False, True),
             "faiss, flash ViT hd 80": ("faiss", wide_vit, None, False, True)}
    # The quantized and L2 runs are held to the mIoU alone: int8 rounding
    # turns ulp-level feature differences between the devices into code
    # flips that move a near-tied neighbour.
    for label, (method, params, bf16_bank, _) in QUANT_RUNS.items():
        params = dict(params, **full_probe) if method == "ivf" else params
        cases.setdefault(label, (method, vit, params, bf16_bank, False))  # 'faiss' holds its labels
    with tempfile.TemporaryDirectory() as root:
        make_voc_fixture(root, seed=3, colorize=True, class_pool=[1, 2, 3, 4, 5], **SMALL_FIXTURE)
        for label, (nn_method, model, params, bf16_bank, hold_labels) in cases.items():
            out = {}
            for device in (DEVICE, "cpu"):
                random.seed(1234)
                before = flash_attention.launches
                out[device] = hbird_evaluation(
                    copy.deepcopy(model), model.config.width, 4, "voc", root, batch_size=4, input_size=32,
                    n_neighbours=5, nn_method=nn_method, num_workers=0, device=device,
                    nn_params=dict(params) if params else None, bf16_bank=bf16_bank,
                    return_knn_details=True)
                if device == DEVICE and model.config.attention_impl == "flash" and flash_attention.launches == before:
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
    """Per query: values (sorted) within `tol`, and every id whose value on
    one side lies above the larger of the two k-th values + tol among the
    other side's ids (ties at the k-th may swap; a row near that line on
    both sides, its two values a rounding apart, may count on one side
    alone, so each side's rows are sought in the other's whole set)."""
    close = ((va - vb).abs() <= tol[:, None]) | (torch.isinf(va) & torch.isinf(vb))
    thr = torch.maximum(va[:, -1:], vb[:, -1:]) + tol[:, None]
    a_in_b = (ia[:, :, None] == ib[:, None, :]).any(2)
    b_in_a = (ib[:, :, None] == ia[:, None, :]).any(2)
    return close.all(1) & ((va <= thr) | a_in_b).all(1) & ((vb <= thr) | b_in_a).all(1)


def backends_card_vs_cpu(d=64):
    """Phase 6: each quantized or L2 backend, built on the card and on the
    CPU from the same float bank (6,000 rows of depth d), stores the same codes and scales and
    returns the same neighbours for the same queries. int8 x int8 searches
    are exact, so their values and ids must be equal; asymmetric, reranked
    and l2 scores are f32 sums in another order, held to RTOL. Anisotropic
    codes may differ on rows whose two candidate losses nearly tie (at most
    ANISO_CODE_FLIPS of the rows); queries that meet such a row are left out."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact

    gen = torch.Generator().manual_seed(7)
    x = clustered_bank(6000, d, 8, gen, device="cpu")
    q = x[:700] + 0.05 / d ** 0.5 * torch.randn(700, d, generator=gen)
    result = {}
    for label, (method, params, bf16_bank, (_, form)) in QUANT_RUNS.items():
        cls = NearestNeighborSearchExact if method == "faiss" else NearestNeighborSearchApprox
        kw = {"n_neighbors": 30, "use_fp16": bf16_bank or cls is NearestNeighborSearchApprox, **params}
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
                for r in (keep & ~agree).nonzero().flatten()[:3].tolist():
                    only = {"card": sorted(set(ci[r].tolist()) - set(hi[r].tolist())),
                            "cpu": sorted(set(hi[r].tolist()) - set(ci[r].tolist()))}
                    print(f"  backend {label}, D={d}, query {r}: tol {tol[r].item():.3g}, max |value diff| "
                          f"{(cv[r] - hv[r]).abs().max().item():.3g}, k-th {cv[r, -1].item():.7g} | "
                          f"{hv[r, -1].item():.7g}; ids on one side only {only}, their values "
                          f"{[round(v, 7) for v in cv[r][torch.isin(ci[r], torch.tensor(only['card'], dtype=torch.long))].tolist()]} | "
                          f"{[round(v, 7) for v in hv[r][torch.isin(hi[r], torch.tensor(only['cpu'], dtype=torch.long))].tolist()]}",
                          flush=True)
                fail(f"backends, {label}: {n_bad} queries with other neighbours or values "
                     f"({int(flipped.sum())} rows with other codes)")
        result[label] = {"code_rows_differ": int(flipped.sum()), "exact": exact,
                         "queries_left_out": n_left}
        print(f"  backend {label}, D={d}: codes and scales match ({int(flipped.sum())} of {x.shape[0]} rows "
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


def asym_library(q, widened, k, rs=None, chunk=2048):
    """K1 asym's library yardstick, chunked over the queries: a bf16 matmul
    against the codes widened to bf16 once, times the row scales `rs` when
    given, then torch.topk."""
    for s in range(0, q.shape[0], chunk):
        x = q[s:s + chunk] @ widened.T
        torch.topk(x if rs is None else x.float() * rs, k, dim=1)


def k1_form_rows(q, bb, q32, b32, label, k, reps, rows, errs, only=None):
    """Phase 7: K1's forms (b)-(e) on the bank `bb` (bf16) and the queries
    `q` (bf16), and f32 on `q32` and `b32` (f32 values that are not TF32
    values, so the small parts of the split are not 0): each timed beside its plain
    version, its bound and a library yardstick (int8: torch._int_mm + topk;
    row scales applied to its f32 result; asymmetric: a bf16 matmul against
    the codes widened to bf16 once; l2: torch.addmm with the bias; f32: an
    f32 matmul, TF32 off, and f32 l2 with the bias). The int8 forms and f32
    at each k of INT8_KS (the engine's k and `faiss` int8 + reorder's
    scan), the others at `k`. Each row names the kernel its call ran
    (`route`); f32's bound is 3 TF32 passes at the TF32 peak, its f32 FMA
    bound beside it. At the engine's k, a single TF32 pass must miss the
    f32 tolerance on these inputs (one_tf32_pass_misses). `only` names the
    forms to time (default all)."""
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
    neg_bias32 = -l2_bias(b32)
    chunk = 2048

    forms = {
        # form: (queries, bank, row_scale, distance, exact, library, bytes of q / bank row, peak, ks)
        "int8": (q8, codes_g, None, "dot_product", True, lambda: int8_library(q8, codes_g, k, None, chunk),
                 1, 1, 0, PEAK_INT8_OPS, INT8_KS),
        "int8_rows": (q8, codes_r, rs, "dot_product", True, lambda: int8_library(q8, codes_r, k, rs, chunk),
                      1, 1, 4, PEAK_INT8_OPS, INT8_KS),
        "asym_rows": (q, codes_r, rs, "dot_product", False, lambda: asym_library(q, wide, k, rs, chunk), 2, 1, 4,
                      PEAK_BF16_FLOPS, (k,)),
        "asym": (q, codes_g, None, "dot_product", False, lambda: asym_library(q, wide_g, k, None, chunk), 2, 1, 0,
                 PEAK_BF16_FLOPS, (k,)),
        "l2": (q, bb, None, "l2", False, lambda: k1_library(q, bb, k, neg_bias, chunk), 2, 2, 0,
               PEAK_BF16_FLOPS, (k,)),
        "f32": (q32, b32, None, "dot_product", False, lambda: k1_library(q32, b32, k, None, chunk), 4, 4, 0,
                PEAK_TF32_FLOPS / TF32_PASSES, INT8_KS),
        "f32_l2": (q32, b32, None, "l2", False, lambda: k1_library(q32, b32, k, neg_bias32, chunk), 4, 4, 0,
                   PEAK_TF32_FLOPS / TF32_PASSES, (k,)),
    }
    base_k = k
    for form, (qq, b, r, dist, exact, lib, qbytes, bbytes, rbytes, peak, ks) in forms.items():
        if only is not None and form not in only:
            continue
        route = _route("knn_topk.cu", "knn_topk", qq, b)
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
            row = rows[f"{name} {label}"] = {"form": form, "route": route, "Q": n_q, "M": m, "D": d, "k": k,
                                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                             "library_ms": lib_ms}
            extra = ""
            if form.startswith("f32"):
                row["fma_bound_ms"] = bound_ms(n_q, m, d, k, 4, PEAK_F32_FLOPS)[0]
                extra = f", 3xTF32; f32 FMA bound {row['fma_bound_ms']:.3f} ms"
                if k == base_k:
                    row["one_tf32_pass_misses"] = one_tf32_pass_misses(f"K1 {name} {label}", qq, b, k, dist)
            print(f"  K1 {name} {label} ({route}): Q={n_q} M={m} D={d} k={k}: {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"(k+1), library {fmt_ms(lib_ms)}, bound {b_ms:.3f} ms ({b_by}{extra}): "
                  f"{shares(ms, b_ms, lib_ms)}", flush=True)


def tf32_rna(x):
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 rounds (ops/csrc/tf32.cuh)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def one_tf32_pass_misses(name, q, b, k, distance, n=2048, plain=None):
    """Phase 7: fails unless a single TF32 pass (tf32(q)·tf32(b) alone)
    misses K1's f32 tolerance at the plain top-k of the first `n` queries
    of `q` against `b` (K2: `plain`, the plain version's top-k of those
    queries over their probed slabs), so that the 3xTF32 check on these
    inputs can tell the three passes from one. Returns the share of top-k
    values missed."""
    from hbird_tpu_torch.ops.knn import exact_knn, l2_bias

    qs = q[:n]
    pv, pi = plain if plain is not None else exact_knn(qs, b, k, distance=distance)
    one = torch.einsum("qd,qkd->qk", tf32_rna(qs), tf32_rna(b[pi]))
    if distance != "dot_product":
        one = one - l2_bias(b)[pi]
    tol = RTOL * qs.norm(dim=1) * b.norm(dim=1).max()
    finite = torch.isfinite(pv)
    err = (one - pv).abs().where(finite, torch.zeros_like(pv))
    share = ((err > tol[:, None]).sum() / finite.sum()).item()
    if share == 0.0:
        fail(f"{name}: one TF32 pass stays within the f32 tolerance (max |err| {err.max().item():.3g}): "
             "the check cannot tell 3xTF32 from one pass")
    print(f"  {name}: one TF32 pass misses the f32 tolerance at {share:.4f} of the top-{k} values of "
          f"{qs.shape[0]} queries (max |err| {err.max().item():.3g}, {(err / tol[:, None]).max().item():.2f}x tol)",
          flush=True)
    return share


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
    order (one pass, no splits) and for the wgmma kernel's partial sets (per bank
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
        orders = {"one set over the bank": [list(range(tiles))],
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


def k2_form_rows(qp, lids, tb, lv, cap, label, k, reps, rows, errs, only=None):
    """Phase 7: K2's quantized forms on the tree's slabs, probed as the bf16
    tree is: int8_rows and asym_rows on per-row int8 codes (padding slots
    scale 0), int8 and asym on global-scale codes; each timed beside the
    plain version, the bound and the library yardstick. `only` names the
    forms to time (default all)."""
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
    )
    for form, qq, sb, r, exact, qbytes, bbytes, rbytes, peak in forms:
        if only is not None and form not in only:
            continue
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
        route = _route("ivf_topk.cu", "ivf_topk", qq, sb)
        rows[f"{form} {label}"] = {"form": form, "route": route, "Q": qq.shape[0], "slots": codes.shape[0],
                                   "cap": cap, "n_probe": lids.shape[1], "block_q": BLOCK_Q, "D": d, "k": k,
                                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "library_ms": lib_ms}
        print(f"  K2 {form} {label} ({route}): Q={qq.shape[0]} slots={codes.shape[0]} cap={cap}: {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms (k+1), library {fmt_ms(lib_ms)}, bound {b_ms:.3f} ms ({b_by}): "
              f"{shares(ms, b_ms, lib_ms)}", flush=True)


def k2_f32_row(qp, lids, tb, lv, cap, label, k, reps, rows, errs):
    """Phase 7: K2 f32 on an f32 tree's slabs and f32 queries (real f32
    values, so the split's small parts are not 0), timed beside its plain
    version, the library yardstick and its 3xTF32 bound (3 TF32 passes at
    the TF32 peak), its f32 FMA bound beside it, with the kernel it ran
    (`route`); a single TF32 pass must miss the f32 tolerance here."""
    from hbird_tpu_torch.ops.ivf import ivf_search_plain
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    n_q, d = qp.shape
    route = _route("ivf_topk.cu", "ivf_topk", qp, tb)
    ms = cuda_ms(lambda: ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q), reps)
    out = ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(out=ivf_search_plain(qp, tb, lids, lv, k + 1, cap=cap)), 1)
    errs["K2"] = max(errs["K2"], check_ivf_against_plain(f"K2 timing shape f32 {label}", qp, tb, lids, lv, k,
                                                          cap, BLOCK_Q, out, box.pop("out")))
    lib_ms = library_ms(lambda: ivf_library(qp, tb, lids, lv, k, cap, BLOCK_Q), reps, f"K2 f32 {label}")
    b_ms, b_by = ivf_bound_ms(n_q, lids, lv, d, k, 4, PEAK_TF32_FLOPS / TF32_PASSES)
    fma = ivf_bound_ms(n_q, lids, lv, d, k, 4, PEAK_F32_FLOPS)[0]
    n = min(2048, n_q) // BLOCK_Q * BLOCK_Q
    misses = one_tf32_pass_misses(f"K2 f32 {label}", qp, tb, k, "dot_product", n=n, plain=ivf_search_plain(
        qp[:n], tb, lids[:n // BLOCK_Q], lv, k, cap=cap))
    rows[f"f32 {label}"] = {"form": "f32", "route": route, "Q": n_q, "slots": tb.shape[0], "cap": cap,
                            "n_probe": lids.shape[1], "block_q": BLOCK_Q, "D": d, "k": k, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma,
                            "library_ms": lib_ms, "one_tf32_pass_misses": misses}
    print(f"  K2 f32 {label} ({route}): Q={n_q} slots={tb.shape[0]} cap={cap}: {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms (k+1), library {fmt_ms(lib_ms)}, bound {b_ms:.3f} ms ({b_by}, 3xTF32; f32 FMA bound {fma:.3f} ms): "
          f"{shares(ms, b_ms, lib_ms)}", flush=True)


def f32_tree(bank32, q32):
    """An f32 tree of `bank32` (the tree's defaults, slabs in f32) and the
    probe inputs of `q32` over it: (qp, lids, slabs, leaf_valid, cap)."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs

    tree = NearestNeighborSearchApprox(bank32, n_neighbors=30, use_tree=True, use_fp16=False, device=DEVICE)
    qp, lids, _ = tile_probe_inputs(q32, tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    return qp, lids, tree.bank, tree.leaf_valid, tree._cap


def _route(source, prefix, q, b):
    """The kernel a CUDA call of (q, b) runs in K1's or K2's library
    (`knn_cuda.route`), or 'plain' on the CPU rehearsal."""
    from hbird_tpu_torch.ops import cuda_build, ivf_cuda, knn_cuda

    if DEVICE != "cuda":
        return "plain"
    argtypes = knn_cuda._ARGTYPES if prefix == "knn_topk" else ivf_cuda._ARGTYPES
    return knn_cuda.route(cuda_build.load(source, f"{prefix}_launch", argtypes), q, b, prefix)


def k1_dot_row(q, bb, label, k, reps, rows, errs):
    """Phase 7: K1 bf16 dot of `q` on `bb`, timed beside its plain version,
    its bound and the library yardstick (query-chunked bf16 matmul + topk)."""
    from hbird_tpu_torch.ops.knn import exact_knn
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    n_q, d = q.shape
    m = bb.shape[0]
    ms = cuda_ms(lambda: knn_topk(q, bb, k), reps)
    out = knn_topk(q, bb, k)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(out=exact_knn(q, bb, k + 1)), 1)
    errs["K1"] = max(errs["K1"], check_against_plain(f"K1 timing shape {label}", q, bb, k, m, out, box.pop("out")))
    lib_ms = cuda_ms(lambda: k1_library(q, bb, k), reps)
    b_ms, b_by = bound_ms(n_q, m, d, k, 2, PEAK_BF16_FLOPS)
    route = _route("knn_topk.cu", "knn_topk", q, bb)
    rows[label] = {"form": "dot", "route": route, "Q": n_q, "M": m, "D": d, "k": k, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    print(f"  K1 {label} ({route}): Q={n_q} M={m} D={d} k={k}: {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(k+1), library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}): "
          f"{shares(ms, b_ms, lib_ms)}", flush=True)


def k2_dot_row(qp, lids, tb, lv, cap, label, k, reps, rows, errs):
    """Phase 7: K2 bf16 on a tree's slabs `tb`, probed by `qp` in tiles of
    BLOCK_Q (`lids`), timed beside its plain version, its bound and the
    library yardstick (ivf_library)."""
    from hbird_tpu_torch.ops.ivf import ivf_search_plain
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    d = qp.shape[1]
    ms = cuda_ms(lambda: ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q), reps)
    out = ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(out=ivf_search_plain(qp, tb, lids, lv, k + 1, cap=cap)), 1)
    errs["K2"] = max(errs["K2"], check_ivf_against_plain(f"K2 timing shape {label}", qp, tb, lids, lv, k, cap,
                                                          BLOCK_Q, out, box.pop("out")))
    lib_ms = cuda_ms(lambda: ivf_library(qp, tb, lids, lv, k, cap, BLOCK_Q), reps)
    b_ms, b_by = ivf_bound_ms(qp.shape[0], lids, lv, d, k, 2, PEAK_BF16_FLOPS)
    scanned = int(lv.long()[lids.long()].sum())
    read = int(lv.long()[torch.unique(lids.long())].sum())
    route = _route("ivf_topk.cu", "ivf_topk", qp, tb)
    rows[label] = {"form": "dot", "route": route, "Q": qp.shape[0], "slots": tb.shape[0], "cap": cap,
                   "n_probe": lids.shape[1], "block_q": BLOCK_Q, "rows_scanned": scanned, "rows_probed": read,
                   "D": d, "k": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
    print(f"  K2 {label} ({route}): Q={qp.shape[0]} slots={tb.shape[0]} cap={cap} n_probe={lids.shape[1]} "
          f"rows scanned {scanned} (distinct {read}): {ms:.3f} ms, plain {plain_ms:.3f} ms (k+1), "
          f"library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}): {shares(ms, b_ms, lib_ms)}", flush=True)


def timing(q, bank, main_tree, f32, gen):
    """Phase 7: K1 and K2 vs plain vs the library yardsticks at two sizes.
    K1's and K2's f32 forms take `f32`, the main path's f32 queries and
    bank (K2: an f32 tree of that bank), and the f32 rows of the large bank
    before their rounding to bf16."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs

    k = 30
    k1_rows, k2_rows, errs = {}, {}, {"K1": 0.0, "K2": 0.0}
    big32 = torch.nn.functional.normalize(torch.randn(BIG_M, bank.shape[1], generator=gen, device=DEVICE), dim=1)
    big = big32.to(torch.bfloat16)
    q32 = f32[0]
    for label, bb, b32, reps in (("main", bank, f32[1], 5), (f"bank_{BIG_M}", big, big32, 2)):
        k1_dot_row(q, bb, label, k, reps, k1_rows, errs)
        k1_form_rows(q, bb, q32, b32, label, k, reps, k1_rows, errs)
    trees32 = {"main": f32_tree(f32[1], q32), f"bank_{BIG_M}": f32_tree(big32, q32)}
    del big32

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
        k2_dot_row(qp, lids, tb, lv, cap, label, k, reps, k2_rows, errs)
        k2_form_rows(qp, lids, tb, lv, cap, label, k, reps, k2_rows, errs)
        k2_f32_row(*trees32.pop(label), label, k, reps, k2_rows, errs)
    return k1_rows, k2_rows, errs


def wide_timing(gen):
    """Phase 7 on the wide banks: at each depth of WIDE_TIMING_DEPTHS,
    PAIR_Q normal queries against PAIR_M unit rows (bf16, and their f32
    values before the rounding for the f32 forms): K1 bf16 dot and every
    form of k1_form_rows (int8 and int8_rows at k 30 and 120, f32 at k 30
    and 120 on 3xTF32, f32 l2, asym, asym_rows, l2); K2 bf16 on a tree of
    the bank (its defaults: 512 leaves, N_PROBE probed a 256-query tile),
    its int8, int8_rows, asym and asym_rows forms on that tree's slabs and
    f32 on an f32 tree of the f32 rows. At BF16_TIMING_DEPTHS (the bf16
    queries streamed in the ring) K1 bf16 dot and l2 and K2 bf16, and at
    DEEP_INT8_TIMING_DEPTH (the int8 queries streamed) K1 and K2 int8 and
    int8_rows. Each row with its route, bound, plain and library times, and
    its check against the plain version."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs

    k, reps = 30, 3
    k1_rows, k2_rows, errs = {}, {}, {"K1": 0.0, "K2": 0.0}
    int8_forms = ("int8", "int8_rows")
    for d in sorted({*WIDE_TIMING_DEPTHS, *BF16_TIMING_DEPTHS, DEEP_INT8_TIMING_DEPTH}):
        label, every = f"D={d}", d in WIDE_TIMING_DEPTHS
        bf16, int8 = every or d in BF16_TIMING_DEPTHS, every or d == DEEP_INT8_TIMING_DEPTH
        q32 = torch.randn(PAIR_Q, d, generator=gen, device=DEVICE)
        b32 = torch.nn.functional.normalize(torch.randn(PAIR_M, d, generator=gen, device=DEVICE), dim=1)
        q, bb = q32.to(torch.bfloat16), b32.to(torch.bfloat16)
        if bf16:
            k1_dot_row(q, bb, label, k, reps, k1_rows, errs)
        k1_forms = None if every else (int8_forms if int8 else ()) + (("l2",) if bf16 else ())
        k1_form_rows(q, bb, q32, b32, label, k, reps, k1_rows, errs, only=k1_forms)
        t0 = time.perf_counter()
        tree = NearestNeighborSearchApprox(bb, n_neighbors=k, use_tree=True, device=DEVICE)
        sync()
        print(f"  tree of the {label} bank: {tree._n_leaves} leaves, cap {tree._cap}, built in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        qp, lids, _ = tile_probe_inputs(q, tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
        if bf16:
            k2_dot_row(qp, lids, tree.bank, tree.leaf_valid, tree._cap, label, k, reps, k2_rows, errs)
        if int8:
            k2_form_rows(qp, lids, tree.bank, tree.leaf_valid, tree._cap, label, k, reps, k2_rows, errs,
                         only=None if every else int8_forms)
        del tree, qp, lids, q, bb
        if every:
            k2_f32_row(*f32_tree(b32, q32), label, k, reps, k2_rows, errs)
        del q32, b32
    return k1_rows, k2_rows, errs


def flash_timing(gen):
    """Phase 7: K3 at the main shape, bf16 and f32, in bf16 at the long
    sequence, and in bf16 and f32 at head widths 32 and 80 (FLASH_NARROW,
    FLASH_WIDE), vs its bound, its plain version
    and scaled_dot_product_attention (a yardstick the port never calls),
    each row with the kernel it ran (`route`). f32's bound is its work at
    f32 accuracy on the tensor cores (3 TF32 passes at the TF32 peak); the
    f32 FMA bound stands beside it. `ms` and `library_ms` are
    host-launched, `graph_ms` and `library_graph_ms` the same calls in one
    CUDA graph (the device's time). At hd 32 and 80 (short calls: their
    host cost rivals the kernel's) bf16's kernel and SDPA take NARROW_ROUNDS
    turns, each way: the medians, and `spread` the least and most; the
    kernel's graph time by batch (`by_batch`); and where the host-launched
    call's host time goes (`host_us`, host_split)."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import flash_attention_plain
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    rows, errs = {}, []
    for label, shape, dtype in (("main", FLASH_MAIN, torch.bfloat16), ("f32", FLASH_MAIN, torch.float32),
                                ("long", FLASH_LONG, torch.bfloat16), ("hd32", FLASH_NARROW, torch.bfloat16),
                                ("hd80", FLASH_WIDE, torch.bfloat16), ("f32 hd32", FLASH_NARROW, torch.float32),
                                ("f32 hd80", FLASH_WIDE, torch.float32)):
        scale = shape[-1] ** -0.5
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
        box = {}
        plain_ms = cuda_ms(lambda: box.update(out=flash_attention_plain(q, k, v, scale)), 3)
        errs.append(check_flash(f"K3 timing shape {str(dtype)[6:]} {shape}",
                                flash_attention(q, k, v, scale), box.pop("out")))

        def kernel():
            flash_attention(q, k, v, scale)

        def sdpa():
            torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)

        extra = {}
        if label in ("hd32", "hd80"):
            turns = in_turns({"kernel": kernel, "sdpa": sdpa}, NARROW_ROUNDS, 20)
            ms, lib_ms = turns["kernel"]["ms"]["median"], turns["sdpa"]["ms"]["median"]
            extra = {"graph_ms": turns["kernel"]["graph_ms"]["median"],
                     "library_graph_ms": turns["sdpa"]["graph_ms"]["median"], "rounds": NARROW_ROUNDS,
                     "spread": turns, "by_batch": by_batch(gen, shape), "host_us": host_split(shape)}
        else:
            ms = cuda_ms(kernel, 10)
            lib_ms = cuda_ms(sdpa, 10)
            extra = {"graph_ms": graph_ms(kernel, 10), "library_graph_ms": graph_ms(sdpa, 10)}
        b_ms, b_by = k3_bound(shape, dtype)
        rows[label] = {"shape": list(shape), "dtype": str(dtype)[6:], "route": flash_cuda.route(dtype, shape[-1]),
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                       **extra}
        note = ""
        if dtype == torch.float32:
            rows[label]["fma_bound_ms"] = flash_bound_ms(shape, 4, PEAK_F32_FLOPS)[0]
            note = f", 3xTF32), f32 FMA bound {rows[label]['fma_bound_ms']:.4f} ms"
        else:
            note = ")"
        if "spread" in extra:
            t = extra["spread"]
            note += (f"; in {NARROW_ROUNDS} turns, median [least, most] host-launched {ms:.4f} "
                     f"[{t['kernel']['ms']['min']:.4f}, {t['kernel']['ms']['max']:.4f}] against SDPA {lib_ms:.4f} "
                     f"[{t['sdpa']['ms']['min']:.4f}, {t['sdpa']['ms']['max']:.4f}], in a CUDA graph "
                     f"{extra['graph_ms']:.4f} [{t['kernel']['graph_ms']['min']:.4f}, "
                     f"{t['kernel']['graph_ms']['max']:.4f}] against SDPA {extra['library_graph_ms']:.4f} "
                     f"[{t['sdpa']['graph_ms']['min']:.4f}, {t['sdpa']['graph_ms']['max']:.4f}]")
        else:
            note += f"; in a CUDA graph {extra['graph_ms']:.4f} ms against SDPA {extra['library_graph_ms']:.4f}"
        print(f"  K3 {str(dtype)[6:]} {shape} ({rows[label]['route']}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}{note}: {shares(ms, b_ms, lib_ms)}", flush=True)
        del q, k, v
    return rows, max(errs)


def host_split(shape):
    """Phase 7: where a host-launched K3 bf16 call's host time goes at
    `shape` (FLASH_NARROW, FLASH_WIDE): time.perf_counter_ns over
    HOST_CALLS runs of the whole call and of each of its pieces (the input
    checks, the output's allocation, the layout test, the raw stream, and
    the C call alone with this call's arguments: its tensor maps, the
    shared-memory attribute, the SM count and the launch), µs a call. They
    run in batches of HOST_BATCH with the card synchronised between
    batches (untimed), so that no launch waits for the card: the device
    takes ~11 and ~35 µs a call at these shapes, more than the host's
    launch. A CPU rehearsal times the pieces that run there."""
    from hbird_tpu_torch.ops import flash_cuda

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).bfloat16() for _ in range(3))
    b, h, n, hd = shape
    scale = hd**-0.5
    out = flash_cuda.flash_attention(q, k, v, scale)
    pieces = {
        "call": lambda: flash_cuda.flash_attention(q, k, v, scale),
        "check": lambda: flash_cuda._check(q, k, v),
        "output": lambda: torch.empty_strided(out.shape, out.stride(), dtype=q.dtype, device=q.device),
        "layout": lambda: flash_cuda._kernel_layout(q, k, v),
    }
    if DEVICE == "cuda":
        launch, device = flash_cuda._entry(), q.get_device()
        stream = torch._C._cuda_getCurrentRawStream(device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, hd, *q.stride()[:3],
                *out.stride()[:3], float(scale), 1, device, stream)
        pieces["stream"] = lambda: torch._C._cuda_getCurrentRawStream(device)
        pieces["c_call"] = lambda: launch(*args)
    result = {}
    for name, fn in pieces.items():
        fn()
        sync()
        total = 0
        for _ in range(HOST_CALLS // HOST_BATCH):
            t0 = time.perf_counter_ns()
            for _ in range(HOST_BATCH):
                fn()
            total += time.perf_counter_ns() - t0
            sync()
        result[name] = total / (HOST_CALLS // HOST_BATCH * HOST_BATCH) / 1e3
    print(f"  K3 bf16 {shape} host µs a call (time.perf_counter_ns, {HOST_CALLS} calls each): "
          + ", ".join(f"{name} {us:.3f}" for name, us in result.items()), flush=True)
    return result


def by_batch(gen, shape):
    """Phase 7: K3 bf16 at `shape` in a CUDA graph (median of 5) at batches
    1-4 quarters of its own: its items (128-query blocks; two a head at hd
    32's N = 197, three at hd 80's 257) in 1, 2, 3 and 3 rounds (hd 32)
    and 2, 3, 5 and 6 (hd 80) of the persistent CTAs on an H100, so the
    time per round and the fixed cost show apart. Returns {batch: ms}."""
    from hbird_tpu_torch.ops.flash_cuda import flash_attention

    b, h, n, hd = shape
    out = {}
    for batch in sorted({max(1, b * i // 4) for i in range(1, 5)}):
        q, k, v = (torch.randn((batch, h, n, hd), generator=gen, device=DEVICE).bfloat16() for _ in range(3))
        out[batch] = statistics.median(graph_ms(lambda: flash_attention(q, k, v, hd**-0.5), 20) for _ in range(5))
    print(f"  K3 bf16 hd {hd} in a CUDA graph by batch (H={h}, N={n}): "
          + ", ".join(f"B={batch} {ms:.4f} ms" for batch, ms in out.items()), flush=True)
    return out


def forward_timing(gen_seed, gen):
    """Phase 7: the ViT forward per batch (BATCH images) with 'xla' and
    'flash' attention: PRESET at INPUT in f32 and bf16, WIDE_PRESET at
    WIDE_INPUT in bf16; ms by CUDA events."""
    from hbird_tpu_torch.models import VIT_PRESETS, FeatureExtractor, ViT

    rows = {}
    for preset, size, dtypes, prefix in ((PRESET, INPUT, (torch.float32, torch.bfloat16), ""),
                                         (WIDE_PRESET, WIDE_INPUT, (torch.bfloat16,), f"{WIDE_PRESET} ")):
        cfg = VIT_PRESETS[preset]
        imgs = torch.randn(BATCH, 3, size, size, generator=gen, device=DEVICE)
        vit = ViT(cfg, generator=torch.Generator().manual_seed(gen_seed)).to(DEVICE).prepare(size)
        for impl in ("xla", "flash"):
            _set_attention(vit, impl)
            for dtype in dtypes:
                fe = FeatureExtractor(vit, use_bf16=dtype == torch.bfloat16)
                with torch.inference_mode():
                    ms = cuda_ms(lambda: fe.forward_features(imgs), 5)
                label = f"{prefix}{impl} {str(dtype)[6:]}"
                rows[label] = {"ms": ms, "images_per_s": BATCH / ms * 1e3}
                print(f"  forward {preset} at {size}, batch {BATCH}, {impl} {str(dtype)[6:]}: {ms:.3f} ms "
                      f"({BATCH / ms * 1e3:.1f} img/s)", flush=True)
        del vit
    return rows


def digest(out):
    """The first 16 hex digits of a SHA-256 of an output's bytes (a tensor,
    or K1's and K2's (values, indices)): two trees' kernels agree bit for
    bit on the same seeded inputs when their digests do."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pairs(tree, k3_only=False):
    """--pairs: the Hopper-redesigned kernels of the imported package (K3
    bf16 and f32, K1 bf16 dot and l2, int8, int8_rows, f32, asym and
    asym_rows, K2 bf16, asym_rows and f32; K1 asym and asym_rows and K2
    asym_rows on the wide banks; K1 bf16 dot and l2 and K2 bf16 at
    BF16_PAIR_DEPTHS on both banks) timed alone by CUDA events, each beside
    its bound and its library call, with its output's digest; and K3-bwd
    (pairs_bwd). `k3_only` (--k3-only): K3 and K3-bwd alone. Returns the
    JSON-ready result."""
    import hbird_tpu_torch
    from hbird_tpu_torch.ops import cuda_build
    from hbird_tpu_torch.ops.flash_cuda import flash_attention
    from hbird_tpu_torch.ops.knn import l2_bias
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

    t0 = time.perf_counter()
    if DEVICE == "cuda" and k3_only:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(cuda_build.build, ("flash_attn.cu", "flash_bwd.cu")))
    elif DEVICE == "cuda":
        cuda_build.build_all()
    out = {"tree": tree, "package": str(pathlib.Path(hbird_tpu_torch.__file__).parent),
           "build_s": time.perf_counter() - t0, "k3": {}, "k3bwd": {}, "k1": {}, "k2": {}}
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def record(kernel, label, ms, shape_bound, library, **extra):
        b_ms, b_by = shape_bound
        out[kernel][label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library, **extra}
        print(f"  [{tree}] {kernel.upper()} {label}: {ms:.4f} ms, library {fmt_ms(library)}, bound "
              f"{b_ms:.4f} ms: {shares(ms, b_ms, library)}"
              + "".join(f", {name} {value}" for name, value in extra.items()), flush=True)

    for dtype, shape in ((torch.bfloat16, FLASH_MAIN), (torch.bfloat16, FLASH_LONG), (torch.float32, FLASH_MAIN),
                         (torch.float32, FLASH_LONG), (torch.float32, FLASH_NARROW), (torch.float32, FLASH_WIDE)):
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
        scale = shape[-1] ** -0.5
        ms = cuda_ms(lambda: flash_attention(q, k, v, scale), 20)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        record("k3", f"{'bf16' if dtype == torch.bfloat16 else 'f32'} {shape}", ms, k3_bound(shape, dtype), lib,
               digest=digest(flash_attention(q, k, v, scale).float()),
               graph_ms=graph_ms(lambda: flash_attention(q, k, v, scale), 20))
        del q, k, v
    pairs_turns(record, FLASH_NARROW)
    pairs_turns(record, FLASH_WIDE)
    pairs_bwd(record)
    if k3_only:
        return out
    q_f32 = torch.randn(PAIR_Q, DEPTH, generator=gen, device=DEVICE)  # K2 f32's queries
    q = q_f32.bfloat16()
    q8 = quantize_queries_int8(q.float())[0]
    for m in (PAIR_M, BIG_M):
        bank_f32 = torch.nn.functional.normalize(torch.randn(m, DEPTH, generator=gen, device=DEVICE), dim=1)
        bank = bank_f32.bfloat16()
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
                record("k1", f"bf16 {form} Q={PAIR_Q} M={m} k={k}", ms, bound, lib,
                       digest=digest(knn_topk(q, bank, k, **kw)))
            for form, codes, r in (("int8", codes_g, None), ("int8_rows", codes_r, rs)):
                bound = bound_ms(PAIR_Q, m, DEPTH, k, 1, PEAK_INT8_OPS, row_bytes=0 if r is None else 4)
                ms = cuda_ms(lambda: knn_topk(q8, codes, k, row_scale=r), reps)
                lib = library_ms(lambda: int8_library(q8, codes, k, r), reps, f"K1 {form}")
                record("k1", f"{form} Q={PAIR_Q} M={m} k={k}", ms, bound, lib,
                       digest=digest(knn_topk(q8, codes, k, row_scale=r)))
        # f32 (3xTF32) at the engine's k and the reorder's scan; asym and
        # asym_rows at the engine's k
        q32, bank32 = q.float(), bank.float()
        for k in INT8_KS:
            ms = cuda_ms(lambda: knn_topk(q32, bank32, k), reps)
            lib = cuda_ms(lambda: k1_library(q32, bank32, k), reps)
            record("k1", f"f32 Q={PAIR_Q} M={m} k={k}", ms,
                   bound_ms(PAIR_Q, m, DEPTH, k, 4, PEAK_TF32_FLOPS / TF32_PASSES), lib,
                   digest=digest(knn_topk(q32, bank32, k)))
        del q32, bank32
        pairs_asym(q, codes_g, codes_r, rs, f"Q={PAIR_Q} M={m}", record, reps)
        del codes_g, codes_r, rs, neg_bias
        pairs_k2(q, bank, q_f32, bank_f32, f"M={m}", record, 5 if m < 200_000 else 3)
        del bank, bank_f32
    del q, q_f32, q8
    pairs_wide(record)
    pairs_bf16_wide(record)
    return out


def pairs_asym(q, codes_g, codes_r, rs, label, record, reps, k=PAIR_KS[0]):
    """--pairs, K1 asym (global codes `codes_g`) and asym_rows (`codes_r`,
    row scales `rs`) of the bf16 queries `q` at k = 30, each with its bound,
    its library call (a bf16 matmul on the codes widened once) and its
    digest."""
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    n_q, d = q.shape
    for form, codes, r in (("asym", codes_g, None), ("asym_rows", codes_r, rs)):
        wide = codes.bfloat16()
        ms = cuda_ms(lambda: knn_topk(q, codes, k, row_scale=r), reps)
        lib = cuda_ms(lambda: asym_library(q, wide, k, r), reps)
        record("k1", f"{form} {label} k={k}", ms,
               bound_ms(n_q, codes.shape[0], d, k, 2, PEAK_BF16_FLOPS, bank_bytes=1, row_bytes=0 if r is None else 4),
               lib, digest=digest(knn_topk(q, codes, k, row_scale=r)))
        del wide


def pairs_wide(record, reps=3):
    """--pairs on the wide banks: at each depth of WIDE_TIMING_DEPTHS,
    PAIR_Q normal queries against PAIR_M unit rows, K1 asym and asym_rows
    on their int8 codes (pairs_asym) and K2 asym_rows on a tree of the rows
    (pairs_k2's), each with its digest."""
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    for d in WIDE_TIMING_DEPTHS:
        q = torch.randn(PAIR_Q, d, generator=gen, device=DEVICE).bfloat16()
        bank = torch.nn.functional.normalize(torch.randn(PAIR_M, d, generator=gen, device=DEVICE), dim=1).bfloat16()
        codes_g = quantize_bank_int8(bank, per_row=False)[0]
        codes_r, scale = quantize_bank_int8(bank, per_row=True)
        pairs_asym(q, codes_g, codes_r, scale.reshape(-1).float().contiguous(), f"Q={PAIR_Q} M={PAIR_M} D={d}",
                   record, reps)
        del codes_g, codes_r, scale
        pairs_k2(q, bank, None, None, f"M={PAIR_M} D={d}", record, reps, forms=("asym_rows",))
        del q, bank


def pairs_bf16_wide(record, reps=3):
    """--pairs, bf16 past D = 768: at each depth of BF16_PAIR_DEPTHS (both
    sides of BF16_MAX_RESIDENT, and past the depth whose queries fit at
    all), PAIR_Q normal queries against PAIR_M and BIG_M unit rows, K1 bf16
    dot and l2 at k = 30 and K2 bf16 on a tree of each bank (pairs_k2's),
    each with its bound, library call and digest."""
    from hbird_tpu_torch.ops.knn import l2_bias
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    k = PAIR_KS[0]
    for d in BF16_PAIR_DEPTHS:
        q = torch.randn(PAIR_Q, d, generator=gen, device=DEVICE).bfloat16()
        for m in (PAIR_M, BIG_M):
            bank = torch.nn.functional.normalize(torch.randn(m, d, generator=gen, device=DEVICE), dim=1).bfloat16()
            neg_bias = (-l2_bias(bank)).bfloat16()
            r = reps if m < 200_000 else 2
            for form, kw, nb in (("dot", {}, None), ("l2", {"distance": "l2"}, neg_bias)):
                ms = cuda_ms(lambda: knn_topk(q, bank, k, **kw), r)
                lib = cuda_ms(lambda: k1_library(q, bank, k, nb), r)
                record("k1", f"bf16 {form} Q={PAIR_Q} M={m} D={d} k={k}", ms,
                       bound_ms(PAIR_Q, m, d, k, 2, PEAK_BF16_FLOPS), lib, digest=digest(knn_topk(q, bank, k, **kw)))
            del neg_bias
            pairs_k2(q, bank, None, None, f"M={m} D={d}", record, r, forms=("bf16",))
            del bank
        del q


def pairs_bwd(record):
    """--pairs, K3-bwd at FLASH_MAIN, FLASH_NARROW and FLASH_WIDE, bf16 and
    f32 (unit normals, lse from the plain forward): the whole backward
    (flash_attention_bwd) host-launched and in one CUDA graph, each kernel
    alone, beside its bound (BWD_FLOPS) and SDPA's backward, with its
    route and the digest of (dq, dk, dv)."""
    from hbird_tpu_torch.ops import flash_cuda
    from hbird_tpu_torch.ops.flash import flash_attention_di, flash_attention_plain

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (FLASH_MAIN, FLASH_NARROW, FLASH_WIDE):
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(4))
            scale = shape[-1] ** -0.5
            with torch.no_grad():
                o, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
                di = flash_attention_di(o, do)

                def bwd():
                    return flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale)

                ms, g_ms = cuda_ms(bwd, 10), graph_ms(bwd, 10)
                dkv_ms = cuda_ms(lambda: flash_cuda.flash_attention_dkv(q, k, v, lse, do, di, scale), 10)
                dq_ms = cuda_ms(lambda: flash_cuda.flash_attention_dq(q, k, v, lse, do, di, scale), 10)
                grads = digest(tuple(t.float() for t in bwd()))
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
            lib = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True), 10)
            record("k3bwd", f"{str(dtype)[6:]} {shape}", ms, bwd_bound_ms(shape, dtype), lib, digest=grads,
                   route=flash_cuda.route(dtype, shape[-1], "dkv"), graph_ms=g_ms, dkv_ms=dkv_ms, dq_ms=dq_ms)
            del q, k, v, do, o, lse, di, leaves, sdpa_out


def pairs_turns(record, shape):
    """--pairs, K3 bf16 at a short `shape` (FLASH_NARROW, FLASH_WIDE) and
    SDPA in NARROW_ROUNDS turns, each timed host-launched and in one CUDA
    graph (the device's time): the host-launched medians as ms and library
    ms, the graph medians, the least and most of each, and the output's
    digest."""
    from hbird_tpu_torch.ops import flash_cuda

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).bfloat16() for _ in range(3))
    scale = shape[-1] ** -0.5
    turns = in_turns({"kernel": lambda: flash_cuda.flash_attention(q, k, v, scale),
                      "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)},
                     NARROW_ROUNDS, 20)
    route = flash_cuda.route(torch.bfloat16, shape[-1]) if hasattr(flash_cuda, "route") else "unnamed"
    kt, st = turns["kernel"], turns["sdpa"]
    record("k3", f"bf16 {shape}", kt["ms"]["median"], k3_bound(shape, torch.bfloat16),
           st["ms"]["median"], digest=digest(flash_cuda.flash_attention(q, k, v, scale).float()), route=route,
           graph_ms=kt["graph_ms"]["median"],
           library_graph_ms=st["graph_ms"]["median"],
           spread=" ".join(f"{n}:{w}=[{t[w]['min']:.4f},{t[w]['max']:.4f}]" for n, t in turns.items() for w in t))


def pairs_k2(q, bank, q32, bank32, label, record, reps, forms=("bf16", "asym_rows", "f32")):
    """--pairs, K2: a tree of `bank` (the tree's defaults: 512 leaves),
    `q` grouped into 256-query tiles probing 32 leaves each, k = 30, in
    `forms`: bf16 and asym_rows (the slabs as per-row int8 codes, padding
    slots scale 0); and f32 on an f32 tree of `bank32` (the rows before
    their rounding to bf16) probed by `q32`. Each with its digest."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.ivf import tile_probe_inputs
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8

    k, d = 30, q.shape[1]
    tree = NearestNeighborSearchApprox(bank, n_neighbors=k, use_tree=True, device=DEVICE)
    tb, lv, cap = tree.bank, tree.leaf_valid, tree._cap
    qp, lids, _ = tile_probe_inputs(q, tree.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    del tree
    runs = [("bf16", tb, None, 2)] if "bf16" in forms else []
    if "asym_rows" in forms:
        codes, scale = quantize_bank_int8(tb, per_row=True)
        slot = torch.arange(tb.shape[0], device=tb.device)
        runs.append(("asym_rows", codes, torch.where(slot % cap < lv.long().repeat_interleave(cap),
                                                     scale.reshape(-1), 0.0), 1))
    shape = f"Q={qp.shape[0]} slots={tb.shape[0]} cap={cap} n_probe={N_PROBE}"
    for form, b, r, bank_bytes in runs:
        bound = ivf_bound_ms(qp.shape[0], lids, lv, d, k, 2, PEAK_BF16_FLOPS,
                             bank_bytes=bank_bytes, row_bytes=0 if r is None else 4)
        ms = cuda_ms(lambda: ivf_topk(qp, b, lids, lv, k, cap=cap, block_q=BLOCK_Q, row_scale=r), reps)
        lib = cuda_ms(lambda: ivf_library(qp, b, lids, lv, k, cap, BLOCK_Q, row_scale=r), reps)
        record("k2", f"{form} {label} {shape}", ms, bound, lib,
               digest=digest(ivf_topk(qp, b, lids, lv, k, cap=cap, block_q=BLOCK_Q, row_scale=r)))
    del qp, lids, tb, runs
    if "f32" not in forms:
        return
    qp, lids, tb, lv, cap = f32_tree(bank32, q32)
    ms = cuda_ms(lambda: ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q), reps)
    lib = cuda_ms(lambda: ivf_library(qp, tb, lids, lv, k, cap, BLOCK_Q), reps)
    record("k2", f"f32 {label} Q={qp.shape[0]} slots={tb.shape[0]} cap={cap} n_probe={N_PROBE}", ms,
           ivf_bound_ms(qp.shape[0], lids, lv, d, k, 4, PEAK_TF32_FLOPS / TF32_PASSES), lib,
           digest=digest(ivf_topk(qp, tb, lids, lv, k, cap=cap, block_q=BLOCK_Q)))


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


def mesh_flat_process_group(q, bank, gen, devices, local_rows, mesh_miou):
    """Phase 9.5: the flat search over a bank axis that spans a process
    group of one (parallel/distributed.py::process_mesh, NCCL on the card
    over tcp://127.0.0.1), so every cross-shard step runs as a collective.
    K1 by 'gather' and 'ring' in bf16, f32, int8_rows and int8 + reorder
    120 (k = 30) on phase 5's bank and on BIG_M rows, on the same stacked
    shards as the process-local mesh: values, ids and labels equal the local
    call's bit for bit, with the same launches; each call timed beside the
    local one (and phase 9.2's). Then `hbird_evaluation` with 'scann' on
    that mesh at phase 5's settings: mIoU within 1e-4 of phase 9.3's meshed
    run, K1 launched once per shard per eval batch."""
    import socket

    from hbird_tpu_torch import hbird_evaluation
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS, ViT
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
    from hbird_tpu_torch.parallel import distributed, make_mesh, ring_knn_with_labels, sharded_knn_with_labels
    from hbird_tpu_torch.parallel.sharded_knn import shard_rows
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    k, c_reorder, n = 30, 120, len(devices)
    strategies = {"gather": (sharded_knn_with_labels, n), "ring": (ring_knn_with_labels, n * n)}
    kernel_forms = {"bf16": "dot", "f32": "f32", "int8_rows": "int8_rows", "int8+reorder": "int8"}
    local_names = {"bf16": "dot", "int8_rows": "int8_rows", "int8+reorder": "int8+reorder"}  # phase 9.2's rows
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{port}", num_processes=1, process_id=0, backend=backend)
    rows, runs = {}, {}
    try:
        group = distributed.process_mesh(devices)
        local = make_mesh((n,), ("bank",), devices)
        if not group.spans_processes:
            fail("process_mesh gave a process-local mesh")
        qc, _ = quantize_queries_int8(q.float())
        big = torch.nn.functional.normalize(
            torch.randn(BIG_M, bank.shape[1], generator=gen, device=DEVICE), dim=1).to(torch.bfloat16)
        for label, bb, reps in (("main", bank, 3), (f"bank_{BIG_M}", big, 2)):
            m = bb.shape[0]
            lab_s = shard_rows(torch.rand(m, 21, generator=gen, device=DEVICE), local)
            codes, _ = quantize_bank_int8(bb.float(), per_row=False)
            codes_r, r_scale = quantize_bank_int8(bb.float(), per_row=True)
            forms = {
                "bf16": ((q, bb), {}),
                "f32": ((q.float(), bb.float()), {}),
                "int8_rows": ((qc, codes_r), {"row_scale": shard_rows(r_scale, local)}),
                "int8+reorder": ((qc, codes), {"rerank_bank": shard_rows(bb, local), "rerank_queries": q,
                                               "rerank_candidates": c_reorder}),
            }
            del codes, codes_r
            for form, ((qq, b), kw) in forms.items():
                b_s = shard_rows(b, local)  # views of `b`: both meshes search these shards
                kf = kernel_forms[form]
                for strat, (fn, per_call) in strategies.items():
                    name = f"9.5 {label} {form} {strat}"
                    calls = {where: (lambda mesh=mesh: fn(qq, b_s, lab_s, k, mesh=mesh, valid_rows=m, **kw))
                             for where, mesh in (("local", local), ("group", group))}
                    outs = {}
                    for where, call in calls.items():
                        before, before_form = knn_topk.launches, knn_topk.forms[kf]
                        outs[where] = call()
                        sync()
                        if knn_topk.launches - before != per_call or knn_topk.forms[kf] - before_form != per_call:
                            fail(f"{name} ({where}): {knn_topk.launches - before} launches "
                                 f"({knn_topk.forms[kf] - before_form} {kf}), not {per_call}")
                    if not all(torch.equal(a, c) for a, c in zip(outs["local"], outs["group"])):
                        fail(f"{name}: the process group's values, ids or labels differ from the process-local "
                             f"mesh's")
                    del outs
                    row = {"M": m, "Q": q.shape[0], "k": k, "shards": n, "launches_per_call": per_call,
                           "local_ms": cuda_ms(calls["local"], reps), "group_ms": cuda_ms(calls["group"], reps)}
                    row["group_minus_local_ms"] = row["group_ms"] - row["local_ms"]
                    if form in local_names:
                        row["phase_9_2_local_ms"] = local_rows[f"{label} {local_names[form]}"][f"{strat}_ms"]
                    rows[f"{label} {form} {strat}"] = row
                    print(f"  {name}: bit for bit against the process-local mesh ({per_call} launches a call); "
                          f"group {row['group_ms']:.3f} ms, local {row['local_ms']:.3f} ms"
                          + (f", phase 9.2's local {row['phase_9_2_local_ms']:.3f} ms"
                             if "phase_9_2_local_ms" in row else ""), flush=True)
                del b_s
            del forms
        del big

        # The engine on the process group's mesh, at phase 5's settings
        cfg = VIT_PRESETS[PRESET]
        vit = ViT(cfg, generator=torch.Generator().manual_seed(0))
        counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
        n_eval = -(-FIXTURE["n_val"] // BATCH)
        label = f"scann on a process group's mesh of {n}"
        with tempfile.TemporaryDirectory() as root:
            make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)
            timer = PhaseTimer()
            random.seed(0)
            reset_counts(counters)
            t1 = time.perf_counter()
            miou = hbird_evaluation(vit, cfg.width, cfg.patch_size, "voc", root, nn_method="scann", timer=timer,
                                    batch_size=BATCH, input_size=INPUT, n_neighbours=30, num_workers=0,
                                    device=DEVICE, mesh=group)
            wall = time.perf_counter() - t1
        launches = {name: fn.launches for name, fn in counters.items()}
        forms_n = read_forms(counters)
        want = n_eval * n
        if launches != {"knn_topk": want, "ivf_topk": 0} or forms_n["knn_topk"] != {"dot": want}:
            fail(f"{label}: launches by form {forms_n}, not knn_topk dot x {want} ({n} shards x {n_eval} batches)")
        if abs(miou - mesh_miou) > 1e-4:
            fail(f"{label}: mIoU {miou}, phase 9.3's meshed run {mesh_miou}")
        runs[label] = {"miou": miou, "launches": launches, "forms": forms_n, "wall_s": wall,
                       "phases": timer.summary(), "k1_launches_per_shard_per_batch": launches["knn_topk"] / want}
        print(f"  9.5 {label}: mIoU {miou:.6f} (phase 9.3's {mesh_miou:.6f}), K1 {launches['knn_topk']} launches "
              f"= {n} shards x {n_eval} eval batches, wall {wall:.2f}s, phases {json.dumps(timer.summary())}",
              flush=True)
    finally:
        distributed.shutdown()
    wall = time.perf_counter() - t0
    print(f"  9.5 {backend} process group of one, bank axis over it: K1 gather and ring bit for bit, the engine's "
          f"mIoU held ({wall:.2f}s with init)", flush=True)
    return rows, runs, {"backend": backend, "seconds": wall}


def peak_growth(fn):
    """fn()'s result and the card's peak allocated bytes while it ran over
    what was allocated when it started: the call's own peak, whatever
    earlier results stay alive (None on the CPU rehearsal)."""
    if DEVICE != "cuda":
        return fn(), None
    sync()
    base = torch.cuda.memory_allocated()
    out, peak = peak_bytes(fn)
    return out, peak - base


def _layout_prio(choices, scores, slots, cap):
    """Each row's score for the leaf it sits in (NaN for a row spilled to a
    leaf it did not choose)."""
    import numpy as np

    hit = choices == (slots // cap)[:, None]
    return np.where(hit.any(1), np.where(hit, scores, -np.inf).max(1), np.nan)


def _device_layout_checks(name, one, dev, bank, tie=1e-6):
    """The 'device' layout of a meshed build against the unmeshed host
    greedy's `one`: the same fill; every row on one of its choices in the
    greedy's leaf and the same rows spilled, except rows whose score for a
    leaf in some pass ties another row's there within `tie` (the device
    layout admits ties by row id, the greedy in its internal order after
    the first pass; spilled rows fill leaves with room in another order by
    design); slots and perm consistent, each slab row the bank row it
    names."""
    import numpy as np

    from hbird_tpu_torch.ops import ivf

    m, cap = bank.shape[0], one._cap
    slots = torch.cat(dev.slots)
    if not torch.equal(dev.leaf_valid, one.leaf_valid):
        fail(f"{name}: the device layout's leaf fill differs from the host greedy's")
    if (slots[m:] != -1).any() or torch.unique(slots[:m]).numel() != m or (slots[:m] < 0).any():
        fail(f"{name}: the device layout's slots are not one per real row")
    perm = torch.cat([p.to(slots.device) for p in dev.perm])
    if not torch.equal(perm[slots[:m]], torch.arange(m, device=slots.device)) or int((perm >= 0).sum()) != m:
        fail(f"{name}: the device layout's perm does not invert its slots")
    if not torch.equal(torch.cat(dev.bank)[slots[:m]], bank.to(one.bank.dtype)):
        fail(f"{name}: a slab row is not the bank row its slot names")
    ch, sc = ivf.assign_leaves(bank, one.centroids, n_choices=3, return_scores=True)
    leaf_h, leaf_d = one.slots.cpu().numpy() // cap, slots[:m].cpu().numpy() // cap
    tied = np.zeros(m, bool)
    for a in range(ch.shape[1]):  # rows a near-equal score away from another's in the same leaf and pass
        order = np.lexsort((sc[:, a], ch[:, a]))
        s, c = sc[order, a], ch[order, a]
        near = (np.diff(s) <= tie) & (c[1:] == c[:-1])
        tied[order[1:][near]] = tied[order[:-1][near]] = True
    spilled_h, spilled_d = (np.isnan(_layout_prio(ch, sc, lf * cap, cap)) for lf in (leaf_h, leaf_d))
    differ = (spilled_h != spilled_d) | (~spilled_h & (leaf_h != leaf_d))
    if (differ & ~tied).any():
        fail(f"{name}: {int((differ & ~tied).sum())} rows placed otherwise than by the host greedy, not at a tie")
    return {"rows_in_another_leaf": int(differ.sum()), "tied_rows": int(tied.sum()),
            "spilled": [int(spilled_h.sum()), int(spilled_d.sum())]}


def _mesh_tree_builds(label, bank, labels, mesh, info):
    """Phase 10.1: the unmeshed build and the meshed builds (host and
    device layouts) of `bank` on the same card: seconds, split and peak
    allocated memory of each; the host layout must be the unmeshed build
    exactly, the device layout its membership up to ties."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox

    trees, row = {}, {"rows": bank.shape[0]}
    for name, kw in (("unmeshed", {}), ("host", {"mesh": mesh}),
                     ("device", {"mesh": mesh, "tree_build_layout": "device"})):
        t0 = time.perf_counter()
        trees[name], peak = peak_growth(lambda: NearestNeighborSearchApprox(
            bank, n_neighbors=30, use_tree=True, label_memory=labels, device=DEVICE, **kw))
        row[name] = {"s": time.perf_counter() - t0, "split_s": trees[name].build_seconds,
                     "peak_growth_bytes": peak}
    one, host = trees["unmeshed"], trees["host"]
    for part in ("centroids", "slots", "perm", "leaf_valid"):
        if not torch.equal(getattr(host, part), getattr(one, part)):
            fail(f"{label}: the meshed host-layout build's {part} differ from the unmeshed build's")
    if not (torch.equal(torch.cat(host.bank), one.bank) and torch.equal(torch.cat(host.labels), one.labels)):
        fail(f"{label}: the meshed host-layout build's slabs differ from the unmeshed build's")
    row["device"].update(_device_layout_checks(label, one, trees["device"], bank))
    gib = (lambda b: "n/a" if b is None else f"{b / 2**30:.3f} GiB")
    print(f"  10.1 {label} ({bank.shape[0]} rows, {one._n_leaves} leaves, cap {one._cap}): " + "; ".join(
        f"{n} {r['s']:.2f}s {json.dumps(rounded(r['split_s']))} peak +{gib(r['peak_growth_bytes'])}"
        for n, r in row.items() if n != "rows") + f"; host layout = unmeshed build; device layout: "
        f"{row['device']['rows_in_another_leaf']} rows placed otherwise, all at ties "
        f"({row['device']['tied_rows']} tied rows), spilled {row['device']['spilled']}", flush=True)
    info[label] = row
    return trees


def _mesh_search_checks(label, one, meshed, q, exact, n_shards):
    """Phase 10.2: with every leaf probed the meshed search equals the
    unmeshed one (bit for bit when `exact`, else at K2's tolerance, ids
    equal away from ties), launching K2 once per shard."""
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    for tree in (one, meshed):
        tree.num_leaves_to_search = one._n_leaves
    state = one.device_state
    before = ivf_topk.launches
    mv, mi, ml = meshed.search_with_labels_pure(meshed.device_state, q, 30, probe_mode="tile")
    sync()
    if ivf_topk.launches - before != n_shards:
        fail(f"{label}: the meshed search launched K2 {ivf_topk.launches - before} times, not {n_shards}")
    if exact:
        uv, ui, ul = one.search_with_labels_pure(state, q, 30, probe_mode="tile")
        if not (torch.equal(mv, uv) and torch.equal(mi, ui) and torch.equal(ml, ul)):
            fail(f"{label}: the meshed search is not bit for bit the unmeshed one")
        err = 0.0
        print(f"  10.2 {label}, every leaf probed: bit for bit, values, ids and labels", flush=True)
    else:
        uv, ui, _ = one.search_with_labels_pure(state, q, 31, probe_mode="tile")
        q_cast, _ = one._cast_queries(state, q)
        rows = one.bank.float() * (1.0 if one.bank_row_scale is None else one.bank_row_scale)
        tol = RTOL * q_cast.float().norm(dim=1) * rows.norm(dim=1).max()
        err = (mv - uv[:, :30]).abs().max().item()
        if ((mv - uv[:, :30]).abs() > tol[:, None]).any():
            fail(f"{label}: meshed values differ from the unmeshed search's by {err}")
        _same_sets(f"10.2 {label}, every leaf probed", mv, mi, uv, ui, 30, tol, err, False)
    if not torch.equal(ml, torch.cat(meshed.labels)[meshed._rows(meshed.slots, mi)]):
        fail(f"{label}: a label row is not its winner's")
    one.num_leaves_to_search = meshed.num_leaves_to_search = N_PROBE
    return err


def _mesh_search_timing(label, one, meshed, q, flat_idx, reps):
    """Phase 10.2 at the engine's 32 probes: recall@30 against K1's exact
    neighbours under 'split' and 'full' beside the unmeshed tree's, and ms
    of the meshed call, of its K2 launches alone, of the merge and of the
    label fetch, beside the unmeshed call and its K2."""
    from hbird_tpu_torch.ops import ivf
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.parallel import sharded_ivf
    from hbird_tpu_torch.parallel.sharded_knn import fetch_labels, merge_topk

    row = {}

    def recall(tree):
        _, idx, _ = tree.search_with_labels_pure(tree.device_state, q, 30, probe_mode="tile")
        return (idx[:, :, None] == flat_idx[:, None, :]).any(2).float().mean().item()

    row["recall_at_30_vs_k1"] = {"unmeshed": recall(one)}
    for shard_probe in ("split", "full"):
        meshed.shard_probe = shard_probe
        row["recall_at_30_vs_k1"][shard_probe] = recall(meshed)
        row[f"{shard_probe}_ms"] = cuda_ms(lambda: meshed.search_with_labels_pure(
            meshed.device_state, q, 30, probe_mode="tile"), reps)
    meshed.shard_probe = "split"
    row["unmeshed_ms"] = cuda_ms(lambda: one.search_with_labels_pure(one.device_state, q, 30, probe_mode="tile"),
                                 reps)
    # the kernels alone, on the inputs each call hands them
    qp, lids, _ = ivf.tile_probe_inputs(q, one.centroids, n_probe=N_PROBE, block_q=BLOCK_Q)
    row["k2_unmeshed_ms"] = cuda_ms(lambda: ivf_topk(qp, one.bank, lids, one.leaf_valid, 30, cap=one._cap,
                                                     block_q=BLOCK_Q), reps)
    p = len(meshed.bank)
    local = one._n_leaves // p
    l_p = sharded_ivf.probes_per_shard(N_PROBE, p, local, "split")
    shard_in = []  # each shard's queries, leaf ids and fill, on its device
    for j, slab in enumerate(meshed.bank):
        q_j = qp.to(slab.device)
        shard_in.append((q_j, ivf.select_block_leaves(q_j, meshed.centroids[j * local:(j + 1) * local].to(slab.device),
                                                      l_p, BLOCK_Q),
                         meshed.leaf_valid[j * local:(j + 1) * local].to(slab.device)))

    def k2_shards():
        return [ivf_topk(q_j, meshed.bank[j], lids_j, lv_j, 30, cap=one._cap, block_q=BLOCK_Q)
                for j, (q_j, lids_j, lv_j) in enumerate(shard_in)]

    parts = k2_shards()
    row["k2_shards_ms"] = cuda_ms(k2_shards, reps)
    cand_v = torch.cat([v.to(qp.device) for v, _ in parts], dim=1)
    cand_i = torch.cat([i.to(qp.device) + j * meshed.bank[0].shape[0] for j, (_, i) in enumerate(parts)], dim=1)
    row["merge_ms"] = cuda_ms(lambda: merge_topk(cand_v, cand_i, 30, index_ordered=True), reps)
    _, idx = merge_topk(cand_v, cand_i, 30, index_ordered=True)
    row["label_fetch_ms"] = cuda_ms(lambda: fetch_labels(idx, meshed.labels), reps)
    row["merge_share_of_split"] = (row["merge_ms"] + row["label_fetch_ms"]) / row["split_ms"]
    row.update(probes_per_shard=l_p, queries=q.shape[0])
    r = row["recall_at_30_vs_k1"]
    print(f"  10.2 {label}, {N_PROBE} probes: recall@30 vs K1 unmeshed {r['unmeshed']:.4f}, split {r['split']:.4f}, "
          f"full {r['full']:.4f}; ms unmeshed call {row['unmeshed_ms']:.3f} (K2 {row['k2_unmeshed_ms']:.3f}), "
          f"meshed split {row['split_ms']:.3f} (K2 x{p} {row['k2_shards_ms']:.3f}), full {row['full_ms']:.3f}; "
          f"merge {row['merge_ms']:.3f} + labels {row['label_fetch_ms']:.3f} "
          f"({100 * row['merge_share_of_split']:.1f}% of the split call)", flush=True)
    return row


def _same_answers(name, a, b, q):
    """Two trees answer the eval batch alike at their probes, bit for bit."""
    va, ia, la = a.search_with_labels_pure(a.device_state, q, 30, probe_mode="tile")
    vb, ib, lb = b.search_with_labels_pure(b.device_state, q, 30, probe_mode="tile")
    if not (torch.equal(va, vb) and torch.equal(ia, ib) and torch.equal(la, lb)):
        fail(f"{name}: the neighbours differ")


def _same_leaves_answers(name, host, dev, q, bank):
    """The host and device layouts of one tree, every leaf probed (spilled
    rows fill other leaves in each by design, so a partial probe may
    differ): the same values, and the same ids away from ties (K2 orders
    ties by slot, and the slot orders within a leaf differ)."""
    for tree in (host, dev):
        tree.num_leaves_to_search = host._n_leaves
    vh, ih, _ = host.search_with_labels_pure(host.device_state, q, 31, probe_mode="tile")
    vd, idd, _ = dev.search_with_labels_pure(dev.device_state, q, 30, probe_mode="tile")
    host.num_leaves_to_search = dev.num_leaves_to_search = N_PROBE
    tol = RTOL * q.float().norm(dim=1) * bank.float().norm(dim=1).max()
    err = (vd - vh[:, :30]).abs().max().item()
    if ((vd - vh[:, :30]).abs() > tol[:, None]).any():
        fail(f"{name}: values differ by {err}")
    return _same_sets(name, vd, idd, vh, ih, 30, tol, err, False)


def mesh_tree(q, bank, gen, devices, label_prefix=""):
    """Phase 10: the IVF tree over a ('bank',) mesh of len(devices) shards
    (parallel/sharded_ivf.py): 10.1 its builds against the unmeshed build,
    on phase 5's bank and on BIG_M clustered rows; 10.2 its search, K2
    once per shard, against the unmeshed search, with recall and times;
    10.3 the streamed build from .bankdir windows onto the mesh; 10.4 a
    .treedir saved from the mesh and loaded back onto it."""
    from hbird_tpu_torch.bank.io import save_memory_sharded
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.ops.knn_cuda import knn_topk
    from hbird_tpu_torch.parallel import make_mesh

    n = len(devices)
    mesh = make_mesh((n,), ("bank",), devices)
    info = {"builds": {}, "search": {}, "shards": n}
    err = 0.0
    labels = torch.rand(bank.shape[0], 21, generator=gen, device=DEVICE)
    trees = _mesh_tree_builds(f"{label_prefix}main", bank, labels, mesh, info["builds"])
    flat_idx = knn_topk(q, bank, 30)[1]
    err = max(err, _mesh_search_checks(f"{label_prefix}main bf16", trees["unmeshed"], trees["host"], q, False, n))
    info["search"]["main bf16"] = _mesh_search_timing(f"{label_prefix}main bf16", trees["unmeshed"], trees["host"],
                                                      q, flat_idx, 5)
    _same_leaves_answers(f"{label_prefix}10.2 main: device layout against host layout, every leaf probed",
                         trees["host"], trees["device"], q, bank)
    quantized = {"int8_rows": ({"quantization": "int8_rows"}, True),
                 "ScaNN searcher (asym_rows)": (dict(QUANT_RUNS["scann-literal"][1]), False)}
    saved = {"bf16": trees["host"]}
    for name, (kw, exact) in quantized.items():
        one = NearestNeighborSearchApprox(bank, n_neighbors=30, use_tree=True, label_memory=labels, device=DEVICE,
                                          **kw)
        meshed = NearestNeighborSearchApprox(bank, n_neighbors=30, use_tree=True, label_memory=labels,
                                             device=DEVICE, mesh=mesh, **kw)
        err = max(err, _mesh_search_checks(f"{label_prefix}main {name}", one, meshed, q, exact, n))
        saved[name] = meshed
        del one
    del trees
    with tempfile.TemporaryDirectory() as tmp:
        # 10.4: a .treedir saved from the mesh and loaded back onto it
        t0 = time.perf_counter()
        for i, (name, tree) in enumerate(saved.items()):
            path = tree.save_tree(str(pathlib.Path(tmp) / f"{i}.treedir"))
            back = NearestNeighborSearchApprox.load_tree(path, n_neighbors=30, mesh=mesh, device=DEVICE)
            _same_answers(f"{label_prefix}.treedir of the meshed {name} tree, loaded back onto the mesh", tree,
                          back, q)
            del back
        info["treedir_round_trips_s"] = time.perf_counter() - t0
        n_leaves = tree._n_leaves
        try:
            NearestNeighborSearchApprox.load_tree(path, mesh=make_mesh((3,), ("bank",), [devices[0]] * 3),
                                                  device=DEVICE)
            fail(f"a 3-shard mesh over {n_leaves} leaves loaded")
        except ValueError as e:
            info["three_shard_error"] = str(e)
        print(f"  10.4 .treedir round trips on the mesh ({', '.join(saved)}): bit for bit in "
              f"{info['treedir_round_trips_s']:.2f}s; 3 shards over {n_leaves} leaves: ValueError", flush=True)
        del saved

        # 10.1-10.2 at BIG_M clustered rows (phase 8's stream), bf16
        # (the queries' width: DEPTH on the card, phase 8's stream)
        big = torch.cat([w.to(torch.bfloat16)
                         for w in clustered_windows(BIG_M, STREAM_WINDOW, q.shape[1], seed=8)()])
        trees = _mesh_tree_builds(f"{label_prefix}bank_{BIG_M}", big, None, mesh, info["builds"])
        flat_idx = knn_topk(q, big, 30)[1]
        info["search"][f"bank_{BIG_M} bf16"] = _mesh_search_timing(
            f"{label_prefix}bank_{BIG_M} bf16", trees["unmeshed"], trees["host"], q, flat_idx, 3)
        _same_leaves_answers(f"{label_prefix}10.2 bank_{BIG_M}: device layout against host layout, every leaf "
                             f"probed", trees["host"], trees["device"], q, big)
        in_memory = trees["unmeshed"]
        del trees
        # 10.3: the streamed build from .bankdir windows, onto the mesh
        f_dir = str(pathlib.Path(tmp) / "big.bankdir")
        t0 = time.perf_counter()
        save_memory_sharded(big, f_dir)
        streamed = {"save_s": time.perf_counter() - t0}
        del big
        built = {}
        for name, kw in (("unmeshed", {}), ("meshed", {"mesh": mesh})):
            t0 = time.perf_counter()
            built[name], peak = peak_growth(lambda: NearestNeighborSearchApprox.from_bankdir(
                f_dir, n_neighbors=30, window_rows=STREAM_WINDOW, device=DEVICE, **kw))
            streamed[name] = {"s": time.perf_counter() - t0, "split_s": built[name].build_seconds,
                              "peak_growth_bytes": peak}
        one, meshed = built["unmeshed"], built["meshed"]
        for part in ("centroids", "slots", "perm", "leaf_valid"):
            if not (torch.equal(getattr(meshed, part), getattr(one, part))
                    and torch.equal(getattr(one, part), getattr(in_memory, part))):
                fail(f"10.3: the streamed builds' {part} differ (meshed, unmeshed, in memory)")
        if not (torch.equal(torch.cat(meshed.bank), one.bank) and torch.equal(one.bank, in_memory.bank)):
            fail("10.3: the streamed builds' slabs differ (meshed, unmeshed, in memory)")
        info["streamed"] = streamed
        gib = (lambda b: "n/a" if b is None else f"{b / 2**30:.3f} GiB")
        print(f"  10.3 streamed build of {BIG_M} rows from a .bankdir (saved in {streamed['save_s']:.2f}s), windows "
              f"of {STREAM_WINDOW}: unmeshed {streamed['unmeshed']['s']:.2f}s peak "
              f"+{gib(streamed['unmeshed']['peak_growth_bytes'])}, onto the mesh {streamed['meshed']['s']:.2f}s "
              f"peak +{gib(streamed['meshed']['peak_growth_bytes'])}; the same tree (and the in-memory build's)",
              flush=True)
        del built, one, meshed, in_memory
    return info, err


def mesh_tree_process_group(q, bank, devices):
    """Phase 10.6: the tree over a bank axis that spans a process group of
    one (parallel/distributed.py::process_mesh, NCCL on the card over
    tcp://127.0.0.1), so every cross-shard step runs as a collective: the
    build (both layouts) and the search equal the process-local mesh's bit
    for bit."""
    import socket

    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.parallel import distributed, make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{port}", num_processes=1, process_id=0, backend=backend)
    try:
        group_mesh = distributed.process_mesh(devices)
        local_mesh = make_mesh((len(devices),), ("bank",), devices)
        if not group_mesh.spans_processes:
            fail("process_mesh gave a process-local mesh")
        for layout in ("host", "device"):
            trees = [NearestNeighborSearchApprox(bank, n_neighbors=30, use_tree=True, device=DEVICE, mesh=m,
                                                 tree_build_layout=layout) for m in (local_mesh, group_mesh)]
            for part in ("bank", "labels"):
                if not all(torch.equal(a, b) for a, b in zip(getattr(trees[0], part), getattr(trees[1], part))):
                    fail(f"10.6 {layout}: the process group's {part} differ from the process-local mesh's")
            _same_answers(f"10.6 {layout}: the process group's tree against the process-local one", *trees, q)
            del trees
    finally:
        distributed.shutdown()
    wall = time.perf_counter() - t0
    print(f"  10.6 {backend} process group of one, bank axis over it: builds (host, device) and search equal "
          f"the process-local mesh's ({wall:.2f}s with init)", flush=True)
    return {"backend": backend, "seconds": wall}


def mesh_tree_cli(gen_seed, ivf_miou, devices, label_prefix=""):
    """Phase 10.5: `eval_cli.main` with 'ivf --mesh-bank N' at phase 5's
    settings: every leaf probed, mIoU within 1e-4 of the unmeshed
    every-leaf run (K2 launched once per shard per eval batch); at the
    default probes ('split', 'full') beside phase 5's 'ivf' run; the
    'device' layout once."""
    from hbird_tpu_torch.data.synthetic import make_voc_fixture
    from hbird_tpu_torch.models import VIT_PRESETS
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    cfg = VIT_PRESETS[PRESET]
    counters = {"knn_topk": knn_topk, "ivf_topk": ivf_topk}
    n_eval = -(-FIXTURE["n_val"] // BATCH)
    n = len(devices)
    runs = {}
    every = ["--nn-param", "num_leaves_to_search=512"]
    mesh_flags = ["--mesh-bank", str(n), "--mesh-devices", ",".join(str(d) for d in devices)]
    with tempfile.TemporaryDirectory() as tmp:
        root = str(pathlib.Path(tmp) / "voc")
        make_voc_fixture(root, seed=0, colorize=True, class_pool=list(range(1, 21)), **FIXTURE)

        def argv(label, *flags):
            return ["--dataset-name", "voc", "--data-dir", root, "--model", PRESET, "--random-init",
                    "--seed", str(gen_seed), "--d-model", str(cfg.width), "--patch-size", str(cfg.patch_size),
                    "--input-size", str(INPUT), "--batch-size", str(BATCH), "--num-workers", "0",
                    "--n-neighbours", "30", "--device", DEVICE, "--log-level", "WARNING", "--nn-method", "ivf",
                    "--out", str(pathlib.Path(tmp) / f"{label}.json"), *flags]

        cases = (("cli ivf, every leaf probed", every, 1),
                 (f"cli ivf --mesh-bank {n}, every leaf probed", [*mesh_flags, *every], n),
                 (f"cli ivf --mesh-bank {n}, tree_build_layout=device, every leaf probed",
                  [*mesh_flags, *every, "--nn-param", "tree_build_layout=device"], n),
                 (f"cli ivf --mesh-bank {n}, {N_PROBE} probes split", mesh_flags, n),
                 (f"cli ivf --mesh-bank {n}, {N_PROBE} probes, shard_probe=full",
                  [*mesh_flags, "--nn-param", "shard_probe=full"], n))
        out = {}
        for label, flags, per_batch in cases:
            out[label] = _cli(label_prefix + label, argv(str(len(runs)), *flags), counters, "ivf_topk", "knn_topk",
                              n_eval, runs, per_batch=per_batch)["miou"]
        base = out["cli ivf, every leaf probed"]
        for label, _, per_batch in cases[1:3]:
            if abs(out[label] - base) > 1e-4:
                fail(f"{label}: mIoU {out[label]}, the unmeshed every-leaf run's {base}")
        print(f"  10.5 mIoU at {N_PROBE} probes on the mesh: split {out[cases[3][0]]:.6f}, full "
              f"{out[cases[4][0]]:.6f}; phase 5's unmeshed ivf {ivf_miou:.6f}", flush=True)
    return runs


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
    ap.add_argument("--k3-only", action="store_true", help="with --pairs: K3 and K3-bwd alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.pairs is not None:
        sys.path.insert(0, str(pathlib.Path(args.pairs).resolve()))
        print(card_line(), flush=True)
        print(json.dumps(pairs(args.pairs, args.k3_only)), flush=True)
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

    phase("[1] build K1, K2, K3 and K3-bwd")
    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    print(f"  built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    build = build_report(libs)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phase("[2] K1 vs plain version")
    err_bf16_k1, bf16_k1 = wide_bf16_knn_cases(gen)
    err_wide_k1, wide_k1 = wide_int8_knn_cases(gen)
    err_asym_k1, asym_k1 = wide_asym_knn_cases(gen)
    err_k1 = max(kernel_cases(gen), quantized_kernel_cases(gen), err_bf16_k1, err_wide_k1, err_asym_k1)

    phase("[3] K2 vs plain version")
    err_bf16_k2, bf16_k2 = wide_bf16_ivf_cases(gen)
    err_wide_k2, wide_k2 = wide_int8_ivf_cases(gen)
    err_asym_k2, asym_k2 = wide_asym_ivf_cases(gen)
    err_k2 = max(ivf_cases(gen), quantized_ivf_cases(gen), err_bf16_k2, err_wide_k2, err_asym_k2)

    phase("[4] K3 vs plain version; K3 under autograd")
    err_k3 = max(flash_cases(gen), flash_many_heads(gen))
    err_k3_grad = grad_check(gen)

    phase(f"[5] main paths ({card})")
    runs, launches, err_main, tree_info, q, bank, main_tree, f32 = main_path(gen_seed=0)
    flash_runs, flash_launches, token_err, err_k3_main = flash_path(gen_seed=0)
    runs.update(flash_runs)
    for name in launches:
        launches[name] += sum(n[name] for n in flash_launches.values())

    phase("[6] the card against the CPU, small input")
    small = card_vs_cpu()
    backends = {f"D={d}": backends_card_vs_cpu(d) for d in (64, WIDE_DEPTHS[-1], GIGANTIC_SHAPE["width"])}

    phase(f"[7] K1, K2 and K3 timing; the forward ({card})")
    k1_rows, k2_rows, err_timing = timing(q, bank, main_tree, f32, gen)
    del f32
    wide_rows = wide_timing(gen)
    k1_rows.update(wide_rows[0])
    k2_rows.update(wide_rows[1])
    err_timing = {name: max(err, wide_rows[2][name]) for name, err in err_timing.items()}
    select = k1_select_rows(q, bank)
    k3_rows, err_k3_timing = flash_timing(gen)
    forward = forward_timing(0, gen)
    del main_tree

    phase(f"[8] the command line, bank and index persistence, the streamed build ({card})")
    cli_runs, cli_launches, persistence = entry_point_path(0, q, runs["scann unbounded"]["miou"])
    runs.update(cli_runs)
    for name, n in cli_launches.items():
        launches[name] += n

    phase(f"[9] the native tar feed, K1 on a bank mesh, the command line on the mesh, NCCL, K1 and the engine "
          f"over a process group ({card})")
    scann_run = runs["scann unbounded"]
    feed_runs, feed = native_feed(0, scann_run)
    one_card = [torch.device("cuda", torch.cuda.current_device())] * MESH_SHARDS
    mesh_rows, err_mesh = mesh_k1_cases(q, bank, gen, one_card)
    mesh_runs = mesh_cli(0, scann_run["miou"], one_card)
    nccl = nccl_one_process()
    group_rows, group_runs, nccl["process_group"] = mesh_flat_process_group(
        q, bank, gen, one_card, mesh_rows,
        mesh_runs[f"cli scann --mesh-bank {MESH_SHARDS}, save .bankdir"]["miou"])
    distinct = {}
    if torch.cuda.device_count() > 1:  # never taken on a one-card machine
        cards = [torch.device("cuda", i) for i in range(min(MESH_SHARDS, torch.cuda.device_count()))]
        distinct["k1"], err_distinct = mesh_k1_cases(q, bank, gen, cards)
        err_mesh = max(err_mesh, err_distinct)
        mesh_runs.update(mesh_cli(0, scann_run["miou"], cards, label_prefix="distinct cards: "))

    phase(f"[10] the IVF tree on a bank mesh: its builds, K2 per shard, the streamed build, .treedir, the command "
          f"line ({card})")
    tree_mesh, err_tree_mesh = mesh_tree(q, bank, gen, one_card)
    tree_runs = mesh_tree_cli(0, runs["ivf unbounded"]["miou"], one_card)
    tree_mesh["process_group"] = mesh_tree_process_group(q, bank, one_card)
    if torch.cuda.device_count() > 1:  # never taken on a one-card machine
        distinct["tree"], err_distinct = mesh_tree(q, bank, gen, cards, label_prefix="distinct cards: ")
        err_tree_mesh = max(err_tree_mesh, err_distinct)
        tree_runs.update(mesh_tree_cli(0, runs["ivf unbounded"]["miou"], cards, label_prefix="distinct cards: "))
    del bank

    phase(f"[11] K3-bwd vs its plain backward; the gradient path; K3-bwd timing ({card})")
    err_bwd = max(flash_bwd_cases(gen), flash_bwd_many_heads(gen), err_k3_grad)
    grad_runs, grad_launches = flash_grad_path(gen_seed=0)
    bwd_rows, err_bwd_timing = flash_bwd_timing(gen)
    err_bwd = max(err_bwd, err_bwd_timing)
    for new_runs in (feed_runs, mesh_runs, group_runs, tree_runs):
        runs.update(new_runs)
        for run in new_runs.values():
            for name in launches:
                launches[name] += run["launches"][name]

    forms = {name: {} for name in ("knn_topk", "ivf_topk", "flash_attention")}  # launches by form
    for run in (*grad_runs.values(), *runs.values()):  # the gradient path's K3 (its LSE instances) too
        for name, counts in run["forms"].items():
            for form, n in counts.items():
                forms[name][form] = forms[name].get(form, 0) + n
    kernels = {"kernels": [
        kernel_entry("knn_topk (K1)", "hbird_tpu_torch/ops/csrc/knn_topk.cu", TPU_KERNELS["K1"],
                     launches["knn_topk"], max(err_k1, err_main["K1"], err_timing["K1"], err_mesh), k1_rows,
                     card, forms["knn_topk"]),
        kernel_entry("ivf_topk (K2)", "hbird_tpu_torch/ops/csrc/ivf_topk.cu", TPU_KERNELS["K2"],
                     launches["ivf_topk"], max(err_k2, err_main["K2"], err_timing["K2"], err_tree_mesh), k2_rows,
                     card, forms["ivf_topk"]),
        kernel_entry("flash_attention (K3)", "hbird_tpu_torch/ops/csrc/flash_attn.cu", TPU_KERNELS["K3"],
                     sum(n["flash_attention"] for n in (*flash_launches.values(), *grad_launches.values())),
                     max(err_k3, err_k3_main, err_k3_timing), k3_rows, card, forms["flash_attention"]),
        bwd_entry("flash_attention_dkv (K3-bwd)", "dkv", TPU_KERNELS["K3-bwd dkv"],
                  sum(n["flash_attention_dkv"] for n in grad_launches.values()), err_bwd, bwd_rows, card),
        bwd_entry("flash_attention_dq (K3-bwd)", "dq", TPU_KERNELS["K3-bwd dq"],
                  sum(n["flash_attention_dq"] for n in grad_launches.values()), err_bwd, bwd_rows, card),
    ], "main_path": runs, "gradient_path": grad_runs, "tree": tree_info, "flash_vs_xla_tokens": token_err,
        "k1_select_load": select,
        "forward_ms_per_batch": forward, "card_vs_cpu": small, "backends_card_vs_cpu": backends,
        "wide_bf16_checks": {"K1": bf16_k1, "K2": bf16_k2},
        "wide_int8_checks": {"K1": wide_k1, "K2": wide_k2}, "wide_asym_checks": {"K1": asym_k1, "K2": asym_k2},
        "hopper_build": build, "persistence": persistence, "native_feed": feed, "mesh_k1": mesh_rows,
        "mesh_k1_process_group": group_rows,
        "mesh_distinct_cards": distinct, "nccl": nccl, "mesh_tree": tree_mesh,
        "seconds": time.perf_counter() - t_start}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
