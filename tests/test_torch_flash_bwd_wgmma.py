"""K3-bwd's wgmma kernels (bf16, and f32 as 3xTF32) and `'flash'` past
65,535 (batch, head) pairs, on the CPU.

The kernels themselves run only on the card (`test_torch_flash_cuda.py`,
`chip_smoke.py` phases 1, 4 and 11); here: the routes the wrapper names,
the wrapper's check of what the kernels take (on `meta` tensors, so no
memory is allocated), the plain forward and backward through the autograd
Function at 65,537 (batch, head) pairs against the same over two halves of
the heads, phase 1's per-instance SASS check on synthetic listings, and
phases 4 and 11's checks past 65,535 pairs rehearsed with a small size
passed in. No JAX: nothing here compares with the JAX package.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from hbird_tpu_torch.ops import flash_cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    return mod


@pytest.mark.parametrize("hd", [32, 64, 80])
def test_route_names_wgmma_for_the_bf16_backward(hd):
    """bf16's dK/dV and dQ kernels are wgmma, and so are f32's (3xTF32);
    the forward is wgmma in both."""
    for kernel in ("dkv", "dq"):
        assert flash_cuda.route(torch.bfloat16, hd, kernel) == "wgmma"
        assert flash_cuda.route(torch.float32, hd, kernel) == "wgmma"
    assert flash_cuda.route(torch.bfloat16, hd) == flash_cuda.route(torch.float32, hd) == "wgmma"


@pytest.mark.parametrize("b,h", [(1, 65536), (4, 25000), (1, 100000)])
def test_check_card_takes_any_number_of_batch_head_pairs(b, h):
    """65,536 pairs and 100,000 (past the grid's y limit the kernels no
    longer use) pass the wrapper's check for the forward (128-row items)
    and the f32 backward (64-row tiles)."""
    q = torch.empty((b, h, 1370, 64), device="meta")
    flash_cuda._check_card(q)
    flash_cuda._check_card(q, 64)
    assert not hasattr(flash_cuda, "MAX_BATCH_HEADS")


def test_check_card_refuses_what_the_kernels_cannot_hold():
    """A head width outside (32, 64, 80), and more work items than a 32-bit
    index holds, raise ValueError saying why."""
    with pytest.raises(ValueError, match="head widths"):
        flash_cuda._check_card(torch.empty((1, 2, 10, 48), device="meta"))
    pairs = flash_cuda.MAX_ITEMS // 11 + 1  # 11 items of 128 rows a head at N = 1,370
    with pytest.raises(ValueError, match="work items"):
        flash_cuda._check_card(torch.empty((1, pairs, 1370, 64), device="meta"))
    flash_cuda._check_card(torch.empty((1, pairs - 1, 1370, 64), device="meta"))
    with pytest.raises(ValueError, match="work items of 64 rows"):  # the f32 backward's 64-row tiles: 22 a head
        flash_cuda._check_card(torch.empty((1, flash_cuda.MAX_ITEMS // 22 + 1, 1370, 64), device="meta"), 64)


def test_function_past_65535_pairs_matches_two_halves_of_the_heads():
    """On the CPU, the autograd Function (plain forward and backward) at
    B·H = 65,537 (N = 2, hd 32, f32) gives the output and the gradients
    that the same calls give over heads [0, 32,768) and [32,768, 65,537)."""
    rng = np.random.default_rng(0)
    shape = (1, 65537, 2, 32)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in range(4))
    scale = 32**-0.5

    def run(sl):
        leaves = [t[:, sl].clone().requires_grad_() for t in (q, k, v)]
        out = flash_cuda.flash_attention(*leaves, scale)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        return (out.detach(), *torch.autograd.grad(out, leaves, g[:, sl]))

    whole = run(slice(None))
    halves = [run(slice(0, 32768)), run(slice(32768, None))]
    for got, a, c in zip(whole, *halves):
        assert got.shape == shape
        torch.testing.assert_close(got, torch.cat([a, c], 1), rtol=1e-6, atol=1e-6)


def _sass(clean=True, hmma_in=None, drop=None):
    """A per-function SASS count of flash_bwd.cu (sass_counts' form): every
    instance of both kernels, bf16 and f32, on wgmma."""
    per_fn = {}
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        for t, hd in ((t, hd) for t in ("13__nv_bfloat16", "f") for hd in (32, 64, 80)):
            fn = f"_ZN45_GLOBAL__N__b215bf55_12_flash_bwd_cu_5acdb528{len(name)}{name}I{t}Li{hd}EEEv"
            per_fn[fn] = {"HGMMA": 32 if t != "f" else 96, "IGMMA": 0, "UTMALDG": 4 if t != "f" else 8, "HMMA": 0,
                          "IMMA": 0}
    if hmma_in is not None:
        per_fn[next(f for f in per_fn if hmma_in in f)]["HMMA"] = 1
    if drop is not None:
        del per_fn[next(f for f in per_fn if drop in f)]
    return per_fn


def test_bwd_sass_check_holds_each_instance(smoke):
    """Phase 1's per-instance check of K3-bwd's SASS passes a clean listing
    (12 instances, bf16 and f32: HGMMA + UTMALDG and no HMMA) and fails on
    an HMMA in a bf16 or an f32 instance, on a missing instance and on an
    f32 instance without HGMMA."""
    got = smoke.check_bwd_sass(_sass())
    assert len(got) == 12 and got["flash_bwd_dq bf16 hd 80"]["HGMMA"] == 32
    assert got["flash_bwd_dkv f32 hd 32"]["HGMMA"] == 96
    with pytest.raises(RuntimeError, match="K3-bwd instance runs wgmma"):
        smoke.check_bwd_sass(_sass(hmma_in="flash_bwd_dqI13__nv_bfloat16Li64E"))
    with pytest.raises(RuntimeError, match="K3-bwd instance runs wgmma"):
        smoke.check_bwd_sass(_sass(hmma_in="flash_bwd_dkvIfLi80E"))
    with pytest.raises(RuntimeError, match="instances"):
        smoke.check_bwd_sass(_sass(drop="flash_bwd_dkvI13__nv_bfloat16Li80E"))
    f32_without = _sass()
    f32_without[next(f for f in f32_without if "flash_bwd_dkvIfLi32E" in f)]["HGMMA"] = 0
    with pytest.raises(RuntimeError, match="runs wgmma"):
        smoke.check_bwd_sass(f32_without)


def test_many_heads_checks_rehearse_on_cpu(smoke):
    """Phases 4 and 11.1 past 65,535 (batch, head) pairs, at a small size
    passed in: every width, both dtypes, the plain versions against
    themselves on the CPU (the card holds the kernels to them); the default
    sizes are 2^16 pairs and 100,000."""
    assert smoke.MANY_HEADS == ((1, 65536, 3), (4, 25000, 3))
    sizes = ((1, 70, 3), (3, 5, 2))
    assert smoke.many_heads_shapes(sizes) == [(1, 70, 3, 32), (1, 70, 3, 64), (1, 70, 3, 80),
                                              (3, 5, 2, 32), (3, 5, 2, 64), (3, 5, 2, 80)]
    gen = torch.Generator().manual_seed(0)
    assert smoke.flash_many_heads(gen, sizes) == 0.0
    assert smoke.flash_bwd_many_heads(gen, sizes) == 0.0
