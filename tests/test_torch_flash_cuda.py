"""K3 on the card: the flash attention CUDA kernel against its plain version.

Every test here needs a CUDA GPU (marker `cuda`) and skips without one:
the kernel has no CPU mode, and on the CPU the wrapper takes the plain
version, which `test_torch_flash.py` compares with the JAX package's TPU
kernel in interpret mode (and `test_torch_flash_bwd.py` the plain backward
with the TPU backward kernels). K3-bwd (ops/csrc/flash_bwd.cu) is held to
the plain backward here, at the tolerance of `assert_grads_close`, past
65,535 (batch, head) pairs too. The file imports neither JAX nor `hbird_tpu`, so
it runs on a GPU machine without them, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_cuda.py

Tolerances (unit-normal inputs): f32 within 1e-5 absolute (the kernel's
products are 3xTF32, about 21 bits of each operand, summed in another
order). bf16 within 4 bf16 ulps at
the scale of each query row (4 · 2^-8 · max over the row's hd outputs of
|plain|), and a mean error under 2^-7 · mean |plain|: the kernel rounds p
to bf16 against its running maximum and normalises at the end, the plain
version rounds the normalised p, so about half the outputs differ by
about one ulp.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.ops import flash_cuda
from hbird_tpu_torch.ops.flash import flash_attention_plain

pytestmark = pytest.mark.cuda

SHAPES = {  # every K3 width, in bf16 and f32
    "dinov2_vitb14_518_b16": (16, 12, 1370, 64),
    "dinov2_vitb14_reg": (2, 12, 1374, 64),
    "mocov3_vits16": (4, 12, 197, 32),
    "mae_vith14": (2, 16, 257, 80),
    "dinov2_952": (1, 12, 4625, 64),
    "one_token": (2, 2, 1, 64),
    "ragged_65": (2, 2, 65, 64),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
            for _ in range(3)]


def assert_close(out, ref):
    """The module's stated tolerance for `out` (kernel) against `ref` (plain)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if ref.dtype == torch.float32:
        assert err.max().item() <= 1e-5, err.max().item()
    else:
        row = r.abs().amax(dim=-1, keepdim=True)
        assert (err <= 4 * 2.0**-8 * row).all(), (err / (2.0**-8 * row)).max().item()
        assert err.mean().item() <= 2.0**-7 * r.abs().mean().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_version(cuda_device, name, dtype):
    shape = SHAPES[name]
    q, k, v = _qkv(shape, seed=len(name), device=cuda_device, dtype=dtype)
    scale = shape[-1] ** -0.5
    before = flash_cuda.flash_attention.launches
    out = flash_cuda.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_cuda.flash_attention.launches == before + 1
    assert torch.isfinite(out).all()
    assert_close(out, flash_attention_plain(q, k, v, scale))


def test_strided_qkv_views_need_no_copy(cuda_device):
    """q, k, v as the ViT hands them over: views of one (B, N, 3·D) tensor."""
    b, n, h, hd = 3, 300, 12, 64
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd), dtype=np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert flash_cuda._kernel_layout(q, k, v)  # read in place
    out = flash_cuda.flash_attention(q, k, v, 0.125)
    dense = flash_cuda.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert out.transpose(1, 2).is_contiguous()  # heads merge back without a copy
    assert_close(out, flash_attention_plain(q, k, v, 0.125))


def test_cuda_tensors_never_reach_the_plain_version(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(flash_cuda, "flash_attention_plain", plain)
    q, k, v = _qkv((2, 4, 100, 32), seed=3, device=cuda_device, dtype=torch.bfloat16)
    before = flash_cuda.flash_attention.launches
    for i in range(3):
        flash_cuda.flash_attention(q, k, v, 0.2)
        assert flash_cuda.flash_attention.launches == before + i + 1
    torch.cuda.synchronize()


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _qkv((1, 2, 64, 48), seed=4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        flash_cuda.flash_attention(q, k, v, 0.1)
    q, k, v = _qkv((1, 2, 64, 64), seed=5, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        flash_cuda.flash_attention(q, k.float(), v, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        flash_cuda.flash_attention(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="cpu"):
        flash_cuda.flash_attention(q, k.cpu(), v, 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_vit_on_the_card_matches_the_cpu(cuda_device, dtype):
    """A small ViT (head width 32, no LayerScale, so attention moves the
    tokens) with 'flash': the card's forward against the same forward on
    the CPU (the plain version); tokens within 1e-4 in f32 and within the
    port's bf16 tolerance (0.1 max, 1e-2 mean)."""
    cfg = ViTConfig(8, 128, 2, 4, img_size=64, attention_impl="flash")
    vit = ViT(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 3, 64, 64), dtype=np.float32))
    with torch.no_grad():
        cpu = vit(x, compute_dtype=dtype)["x_norm_patchtokens"]
        before = flash_cuda.flash_attention.launches
        gpu = vit.to(cuda_device)(x.to(cuda_device), compute_dtype=dtype)["x_norm_patchtokens"]
    assert flash_cuda.flash_attention.launches == before + cfg.depth
    err = (gpu.cpu() - cpu).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        assert err.max().item() <= 0.1 and err.mean().item() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 1370, 4625])
def test_sequence_edges(cuda_device, n, hd, dtype):
    """Every edge of the 64-key (f32) and 128-key (bf16) tiles and of the
    128-query items, at every width, against the plain version."""
    q, k, v = _qkv((2, 3, n, hd), seed=n + hd, device=cuda_device, dtype=dtype)
    out = flash_cuda.flash_attention(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert_close(out, flash_attention_plain(q, k, v, hd**-0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64, 80])
def test_strided_qkv_views_of_every_width(cuda_device, hd, dtype):
    """The ViT's views of its qkv projection at each head width, with
    N = 1370 (ragged against every tile): read in place, equal to the
    contiguous copies' output and within the tolerance."""
    b, n, h = 2, 1370, 4
    rng = np.random.default_rng(hd)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd), dtype=np.float32))
    qkv = qkv.to(cuda_device, dtype).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert flash_cuda._kernel_layout(q, k, v)
    out = flash_cuda.flash_attention(q, k, v, hd**-0.5)
    dense = flash_cuda.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), hd**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert_close(out, flash_attention_plain(q, k, v, hd**-0.5))


@pytest.mark.parametrize("n", [1, 65, 197, 1025])
def test_bf16_hd32_runs_the_wgmma_kernel(cuda_device, n):
    """mocov3_vits16's width (12 heads of 32; N = 197 at its 224 input,
    1,025 at 512) on the wgmma kernel (64-byte rows, the 64-byte swizzle),
    dense and as the ViT's strided views of its qkv projection: the views
    read in place give the dense copies' output bit for bit, and both hold
    the plain version's tolerance."""
    assert flash_cuda.route(torch.bfloat16, 32) == "wgmma"
    b, h, hd = 4, 12, 32
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd), dtype=np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert flash_cuda._kernel_layout(q, k, v)
    before = flash_cuda.flash_attention.forms["bf16"]
    out = flash_cuda.flash_attention(q, k, v, hd**-0.5)
    dense = flash_cuda.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), hd**-0.5)
    torch.cuda.synchronize()
    assert flash_cuda.flash_attention.forms["bf16"] == before + 2
    assert torch.isfinite(out).all() and torch.equal(out, dense)
    assert_close(out, flash_attention_plain(q, k, v, hd**-0.5))


@pytest.mark.parametrize("n", [1, 65, 128, 129, 256, 257, 1025])
def test_bf16_hd80_runs_the_wgmma_kernel(cuda_device, n):
    """mae_vith14's width (16 heads of 80; N = 257 at its 224 input, 1,025
    at 448) on the wgmma kernel (each 160-byte row as a 128-byte-swizzled
    and a 32-byte-swizzled part), dense and as the ViT's strided views of
    its qkv projection: the views read in place give the dense copies'
    output bit for bit, and both hold the plain version's tolerance."""
    assert flash_cuda.route(torch.bfloat16, 80) == "wgmma"
    b, h, hd = 2, 16, 80
    rng = np.random.default_rng(n + 80)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd), dtype=np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert flash_cuda._kernel_layout(q, k, v)
    before = flash_cuda.flash_attention.forms["bf16"]
    out = flash_cuda.flash_attention(q, k, v, hd**-0.5)
    assert flash_cuda.flash_attention.forms["bf16"] == before + 1
    dense = flash_cuda.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), hd**-0.5)
    torch.cuda.synchronize()
    assert flash_cuda.flash_attention.forms["bf16"] == before + 2
    assert torch.isfinite(out).all() and torch.equal(out, dense)
    assert_close(out, flash_attention_plain(q, k, v, hd**-0.5))


@pytest.mark.parametrize("dtype, hd", [(torch.bfloat16, 64), (torch.float32, 64), (torch.float32, 80)],
                         ids=["bf16-64", "f32-64", "f32-80"])
def test_no_stale_tensor_map_at_a_reused_address(cuda_device, dtype, hd):
    """The launcher keeps its tensor maps across calls: q, k and v as views
    of three buffers (so every call reads the same three addresses) with the
    strides of (2, 4, 200) at (1, 2, 100), then with one dim grown at a time
    (B, H, N), then other dims and strides, other strides and (2, 4, 200)
    again; each call against the plain version. A map kept from a call with
    a smaller dim would read zeros for the grown one's rows."""
    rng = np.random.default_rng(hd)
    bufs = [torch.from_numpy(rng.standard_normal(2 * 4 * 200 * hd, dtype=np.float32)).to(cuda_device, dtype)
            for _ in range(3)]
    views = (lambda x: x.view(2, 4, 200, hd)[:1, :2, :100], lambda x: x.view(2, 4, 200, hd)[:, :2, :100],
             lambda x: x.view(2, 4, 200, hd)[:, :, :100], lambda x: x.view(2, 4, 200, hd),
             lambda x: x.view(4, 2, 200, hd), lambda x: x.view(2, 200, 4, hd).transpose(1, 2),
             lambda x: x.view(2, 4, 200, hd))
    for view in views:
        q, k, v = (view(buf) for buf in bufs)
        assert [t.data_ptr() for t in (q, k, v)] == [buf.data_ptr() for buf in bufs]
        out = flash_cuda.flash_attention(q, k, v, hd**-0.5)
        torch.cuda.synchronize()
        assert_close(out, flash_attention_plain(q, k, v, hd**-0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [32, 64, 80])
def test_batch_heads_at_the_grid_limit(cuda_device, hd, dtype):
    """B·H = 65,535 (the grid's y limit, which the kernels no longer use),
    65,536 and 100,000 (not a power of two) run, forward and backward:
    K3 against the plain forward, K3-bwd's dK/dV and dQ against the plain
    backward (lse from K3's LSE instance)."""
    from hbird_tpu_torch.ops.flash import flash_attention_di, flash_attention_dkv_plain, flash_attention_dq_plain

    for i, shape in enumerate(((5, 13107, 3, hd), (1, 65536, 3, hd), (4, 25000, 3, hd))):
        q, k, v = _qkv(shape, seed=hd + i, device=cuda_device, dtype=dtype)
        do = torch.from_numpy(np.random.default_rng(i).standard_normal(shape, dtype=np.float32)).to(cuda_device, dtype)
        scale = hd**-0.5
        lse = torch.empty(shape[:3], device=cuda_device)
        out = flash_cuda._forward(q, k, v, scale, lse)
        torch.cuda.synchronize()
        assert_close(out, flash_attention_plain(q, k, v, scale))
        di = flash_attention_di(out, do)
        dk, dv = flash_cuda.flash_attention_dkv(q, k, v, lse, do, di, scale)
        dq = flash_cuda.flash_attention_dq(q, k, v, lse, do, di, scale)
        torch.cuda.synchronize()
        assert_grads_close((dq, dk, dv), (flash_attention_dq_plain(q, k, v, lse, do, di, scale),
                                          *flash_attention_dkv_plain(q, k, v, lse, do, di, scale)))


def assert_grads_close(got, ref):
    """K3-bwd's (dq, dk, dv) against the plain backward's, at chip_smoke's
    check_grads tolerance: S the largest |value| of the three; f32 within
    1e-5·S; bf16 within 4 ulps of each row's scale (its largest |ref|, at
    least 2^-8·S) and a mean error under 2^-7·max(mean |ref|, 2^-8·S). At
    N = 1 dq and dk vanish in exact arithmetic: both sides are noise."""
    s = max(r.float().abs().max().item() for r in ref)
    for out, r in zip(got, ref):
        assert out.dtype == r.dtype and out.shape == r.shape
        o, r = out.float(), r.float()
        assert torch.isfinite(o).all()
        err = (o - r).abs()
        if out.dtype == torch.float32:
            assert err.max().item() <= 1e-5 * s, (err.max().item(), s)
        else:
            floor = 2.0**-8 * s
            ulp = 2.0**-8 * r.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
            assert (err <= 4 * ulp).all(), (err / ulp).max().item()
            assert err.mean().item() <= 2.0**-7 * max(r.abs().mean().item(), floor)


BWD_SHAPES = {  # (B, H, N, hd): every width, N = 1, ragged tiles, a one-key last tile, the main path's N
    "one_token": (2, 3, 1, 64),
    "mocov3_vits16": (2, 12, 197, 32),
    "mae_vith14": (2, 16, 257, 80),
    "dinov2_vitb14_518": (2, 12, 1370, 64),
    "ragged_65": (1, 2, 65, 80),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_backward_kernels_match_the_plain_backward(cuda_device, name, dtype):
    """K3-bwd's dK/dV and dQ kernels against the plain backward on the same
    q, k, v, output, lse and do (do strided as the ViT hands it over: a
    (B, H, N, hd) view of (B, N, H, hd) memory); lse from K3's LSE instance,
    whose output is the no-grad call's bit for bit; two runs, the same
    bits."""
    from hbird_tpu_torch.ops.flash import flash_attention_bwd_plain

    shape = BWD_SHAPES[name]
    b, h, n, hd = shape
    q, k, v = _qkv(shape, seed=len(name), device=cuda_device, dtype=dtype)
    rng = np.random.default_rng(hd)
    do = torch.from_numpy(rng.standard_normal((b, n, h, hd), dtype=np.float32)).to(cuda_device, dtype).transpose(1, 2)
    scale = hd**-0.5
    lse = torch.empty((b, h, n), device=cuda_device)
    o = flash_cuda._forward(q, k, v, scale, lse)
    with torch.no_grad():
        assert torch.equal(o, flash_cuda.flash_attention(q, k, v, scale))
    _, lse_ref = flash_attention_plain(q, k, v, scale, return_lse=True)
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * max(1.0, lse_ref.abs().max().item())
    before = (flash_cuda.flash_attention_dkv.launches, flash_cuda.flash_attention_dq.launches)
    got = flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale)
    again = flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (flash_cuda.flash_attention_dkv.launches, flash_cuda.flash_attention_dq.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert_grads_close(got, flash_attention_bwd_plain(q, k, v, o, lse, do, scale))


@pytest.mark.parametrize("n", [257, 1370])
def test_bf16_backward_reruns_give_the_same_bits(cuda_device, n):
    """The bf16 wgmma kernels (persistent CTAs, no atomics) give the same
    bits on every run: three runs of each at (2, 12, N, 64) and (2, 16, N,
    80)."""
    for hd, heads in ((64, 12), (80, 16)):
        shape = (2, heads, n, hd)
        assert flash_cuda.route(torch.bfloat16, hd, "dkv") == flash_cuda.route(torch.bfloat16, hd, "dq") == "wgmma"
        q, k, v = _qkv(shape, seed=n + hd, device=cuda_device, dtype=torch.bfloat16)
        do = torch.from_numpy(np.random.default_rng(n).standard_normal(shape, dtype=np.float32)).to(
            cuda_device, torch.bfloat16)
        scale = hd**-0.5
        lse = torch.empty(shape[:3], device=cuda_device)
        o = flash_cuda._forward(q, k, v, scale, lse)
        runs = [flash_cuda.flash_attention_bwd(q, k, v, o, lse, do, scale) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for run in runs[1:] for a, c in zip(runs[0], run))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_autograd_runs_k3_bwd_and_no_grad_runs_the_forward_alone(cuda_device, dtype):
    """Under autograd (grad mode on, an input requiring grad) K3 goes
    through its Function: the LSE forward launches once, with the no-grad
    call's output bit for bit, and the backward launches the dK/dV and dQ
    kernels once each, never the plain backward; its gradients hold against
    the plain backward. Under torch.no_grad() or inference_mode (or with no
    input requiring grad) the call launches the forward alone, with no
    autograd node. A second derivative raises."""
    from hbird_tpu_torch.ops.flash import flash_attention_bwd_plain

    q, k, v = _qkv((2, 4, 100, 64), seed=11, device=cuda_device, dtype=dtype)
    do = torch.randn((2, 4, 100, 64), device=cuda_device).to(dtype)
    counts = lambda: (flash_cuda.flash_attention.launches, flash_cuda.flash_attention_dkv.launches,  # noqa: E731
                      flash_cuda.flash_attention_dq.launches)
    for needs in (q, k, v):
        needs.requires_grad_(True)
        for ctx in (torch.no_grad, torch.inference_mode):
            before = counts()
            with ctx():
                ref_out = flash_cuda.flash_attention(q, k, v, 0.125)
            assert ref_out.grad_fn is None and counts() == (before[0] + 1, before[1], before[2])
        before = counts()
        out = flash_cuda.flash_attention(q, k, v, 0.125)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward" and torch.equal(out, ref_out)
        (grad,) = torch.autograd.grad(out, (needs,), do)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
        _, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), 0.125, return_lse=True)
        ref = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), ref_out, lse, do, 0.125)
        i = next(j for j, t in enumerate((q, k, v)) if t is needs)  # the gradient taken, at the scale of all three
        assert_grads_close([grad if j == i else r for j, r in enumerate(ref)], ref)
        with pytest.raises(RuntimeError, match="Higher-order AD not supported"):
            torch.autograd.grad(flash_cuda.flash_attention(q, k, v, 0.125).sum(), (needs,), create_graph=True)
        needs.requires_grad_(False)
    before = counts()
    out = flash_cuda.flash_attention(q, k, v, 0.125)  # no input requires grad
    assert out.grad_fn is None and counts() == (before[0] + 1, before[1], before[2])


def test_cuda_gradients_never_reach_the_plain_backward(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain backward")

    monkeypatch.setattr(flash_cuda, "flash_attention_dkv_plain", plain)
    monkeypatch.setattr(flash_cuda, "flash_attention_dq_plain", plain)
    q, k, v = (t.requires_grad_() for t in _qkv((2, 4, 100, 80), seed=3, device=cuda_device, dtype=torch.bfloat16))
    flash_cuda.flash_attention(q, k, v, 0.2).sum().backward()
    torch.cuda.synchronize()
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))
