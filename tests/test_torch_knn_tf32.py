"""K1 f32's 3xTF32 top-k, emulated in torch, against the f32 numerics.

The CUDA kernel (hbird_tpu_torch/ops/csrc/wgmma_topk.cuh, form `F32`)
scores f32 queries against an f32 bank on the TF32 tensor cores: each
operand is split into big = tf32(x) and small = tf32(x - big)
(tests/tf32_emulation.py, the rounding K3 f32 shares), each 32-deep depth
chunk (one 128-byte row of f32) takes small·big + big·small + big·big in a
fresh accumulator, and the chunks' sums are added in f32 registers in
depth order; the l2 form subtracts the wrapper's bias ||b||²/2 once. The
kernel runs only on the card; `knn_3xtf32` below is that scheme on the
CPU, with the order "value descending, then index ascending".

Held, on seeded numpy inputs (queries of unit normals; bank rows of unit
norm, or scaled by 0.2-3.0 so that the l2 and dot orders differ), against
the port's f32 `exact_knn`, the JAX package's `exact_knn` and `pallas_knn`
(the TPU kernel, interpret mode): values within 1e-5 · ||q|| · max ||b||,
K1's f32 tolerance on the card, and equal index sets (tie-free inputs). A
single TF32 pass (big·big alone) misses that tolerance, so the three
passes are what keeps it.

The wgmma kernel's plan (`plan_splits`) and scratch (`parts_shape`) are the
bf16 and int8 forms' for f32 (form 0) and asym (form 3) too: checked at
the main shapes here, the launches on the card in
tests/test_torch_knn_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.knn import exact_knn as jax_exact_knn
from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu_torch.ops import knn_cuda
from hbird_tpu_torch.ops.knn import exact_knn, l2_bias
from tf32_emulation import split_tf32, tf32_rna

RTOL = 1e-5
CHUNK = 32  # f32 depth of one wgmma chunk: a 128-byte row


def scores_3xtf32(q: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """q·bᵀ as K1's F32 form takes it: per 32-deep chunk, small·big +
    big·small + big·big of the TF32 parts (exact products, f32 sums), the
    chunks added in f32 in depth order. `passes=1`: big·big alone."""
    qb, qs = split_tf32(q)
    bb, bs = split_tf32(b)
    acc = None
    for c0 in range(0, q.shape[1], CHUNK):
        c = slice(c0, c0 + CHUNK)
        part = qb[:, c] @ bb[:, c].T
        if passes == 3:
            part = (qs[:, c] @ bb[:, c].T + qb[:, c] @ bs[:, c].T) + part
        acc = part if acc is None else acc + part
    return acc


def knn_3xtf32(q, b, k, *, valid_rows, distance="dot_product", passes=3):
    """The emulated kernel's top-k of the first `valid_rows` rows (at least
    k): values descending, then index ascending."""
    s = scores_3xtf32(q, b[:valid_rows], passes)
    if distance != "dot_product":
        s = s - l2_bias(b[:valid_rows])
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _inputs(n_q, m, d, scaled, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    if scaled:
        b = (b * rng.uniform(0.2, 3.0, (m, 1))).astype(np.float32)
    return q, b


def _agree(v, i, ov, oi, tol):
    ov, oi = np.asarray(ov), np.asarray(oi)
    assert np.abs(v.numpy() - ov).max() <= tol
    np.testing.assert_array_equal(np.sort(i.numpy(), 1), np.sort(oi, 1))


@pytest.mark.parametrize("k", [1, 30, 120])
@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled"])
@pytest.mark.parametrize("distance", ["dot_product", "l2"])
def test_3xtf32_topk_matches_f32_and_the_tpu_kernel(distance, scaled, k):
    """D = 776 (24 chunks and a partial one, zero-filled as TMA fills it);
    valid_rows cuts the bank inside a 128-row tile."""
    q, b = _inputs(24, 700, 776, scaled, seed=k + 7 * scaled + (distance == "l2"))
    valid = 650
    tq, tb = torch.from_numpy(q), torch.from_numpy(b)
    tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b[:valid], axis=1).max())
    v, i = knn_3xtf32(tq, tb, k, valid_rows=valid, distance=distance)
    pv, pi = exact_knn(tq, tb, k, valid_rows=valid, distance=distance)
    _agree(v, i, pv, pi, tol)
    jq, jb = jnp.asarray(q), jnp.asarray(b)
    _agree(v, i, *jax_exact_knn(jq, jb, k, valid_rows=valid, distance=distance), tol)
    _agree(v, i, *pallas_knn(jq, jb, k, valid_rows=valid, distance=distance, block_q=8,
                             block_m=256, interpret=True), tol)


@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled"])
def test_one_tf32_pass_misses_the_f32_tolerance(scaled):
    """big·big alone errs past 1e-5 · ||q|| · max ||b|| at D = 768; the
    three passes stay well inside it."""
    q, b = _inputs(24, 700, 768, scaled, seed=40 + scaled)
    tq, tb = torch.from_numpy(q), torch.from_numpy(b)
    tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b, axis=1).max())
    exact = tq.double() @ tb.double().T
    three = (scores_3xtf32(tq, tb).double() - exact).abs().max().item()
    one = (scores_3xtf32(tq, tb, passes=1).double() - exact).abs().max().item()
    assert three <= tol / 10 < tol < one


def test_split_parts_are_tf32_values_that_sum_back():
    """Both parts carry no bits below TF32's 10 stored mantissa bits (the
    tensor cores ignore them), and big + small recovers x to 2^-21."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 776)).astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
        assert torch.equal(tf32_rna(part), part)
    err = (x.double() - big.double() - small.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all()


@pytest.mark.parametrize("k", [30, 97, 120, 128])
def test_f32_and_asym_plan_the_wgmma_kernels_items(k):
    """Forms 0 (f32) and 3 (asym) run the wgmma kernel with the other
    forms' plan, which takes no form: at Q = 21,904 on 132 SMs, 3 splits of
    229 tiles over the 87,616-row bank and 3 of 2,667 over 1,024,000 rows,
    343 · 3 items, and partial sets of 32 · ceil(k / 32) keys, two per
    split, under MAX_PARTS_BYTES."""
    assert knn_cuda.FORMS[torch.float32, torch.float32] == 0
    assert knn_cuda.FORMS[torch.bfloat16, torch.int8] == 3
    for m, tiles in ((87616, 229), (1024000, 2667)):
        split_rows, splits = knn_cuda.plan_splits(21904, m, 132, k)
        assert (split_rows, splits) == (tiles * 128, 3)
        items = -(-21904 // knn_cuda.WGMMA_BLOCK_Q) * splits
        assert items == 1029 and items / (-(-items // 132) * 132) >= knn_cuda.MIN_FILL
        shape = knn_cuda.parts_shape(21904, splits, k)
        assert shape == (21904, 6, 32 * -(-k // 32))
        assert np.prod(shape) * 8 <= knn_cuda.MAX_PARTS_BYTES
