"""K3 on the card: the flash attention CUDA kernel against its plain version.

Every test here needs a CUDA GPU (marker `cuda`) and skips without one:
the kernel has no CPU mode, and on the CPU the wrapper takes the plain
version, which `test_torch_flash.py` compares with the JAX package's TPU
kernel in interpret mode. The file imports neither JAX nor `hbird_tpu`, so
it runs on a GPU machine without them, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_cuda.py

Tolerances (unit-normal inputs): f32 within 1e-5 absolute (the same f32
products and exps, summed in another order). bf16 within 4 bf16 ulps at
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

SHAPES = {
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
