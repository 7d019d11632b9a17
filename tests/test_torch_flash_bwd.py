"""K3-bwd's plain version and the 'flash' ViT's gradients against the JAX package.

- `flash_attention_bwd_plain` against the library TPU backward kernels
  (`_flash_attention_dkv_kernel`, `_flash_attention_dq_kernel` of
  jax/experimental/pallas/ops/tpu/flash_attention.py) in interpret mode:
  `jax.vjp` of the library `flash_attention` called directly with every
  forward and backward block set (the JAX package's own call site sets the
  forward's alone, so `jax.grad` through it refuses), the sequence padded
  to a multiple of 128 and the padding masked by `SegmentIds`. The port's
  backward takes the library's output as o, so the two differ only in
  their backward arithmetic. Inputs are unit normals from numpy.
  Tolerances: f32 within 1e-5·max|ref| (the same products summed in
  another order, p from the rows' lse rather than from m and 1/l); bf16
  within 2^-8·max|ref| (half an ulp of the largest values, where one bf16
  rounding of p, ds or the output may go the other way), with fewer than
  1% of the values differing at all.
- `FlashAttention` (the autograd Function that 'flash' takes under grad on
  any device) on the CPU against autograd through `flash_attention_plain`,
  its plain forward and backward halves against that too, and its refusal
  of a second derivative.
- The port's ViT with 'flash', 2 blocks, narrow: the gradients of the
  input and of every parameter against `jax.grad` of the JAX ViT under
  'xla' (its weights carried across by `params_from_jax`), within 1e-5
  (f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.ops import flash_cuda
from hbird_tpu_torch.ops.flash import (
    flash_attention_bwd_plain,
    flash_attention_di,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_plain,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normals(shape, seed, count):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _library_vjp(q, k, v, do, scale):
    """jax.vjp of the library flash attention (interpret mode) on (B, H, N,
    hd) q, k, v: N padded to a multiple of 128, masked by segment ids, every
    block the padded length.
    Returns o and (dq, dk, dv), unpadded."""
    b, h, n, hd = q.shape
    n_pad = -(-n // 128) * 128
    blk = n_pad
    pad = ((0, 0), (0, 0), (0, n_pad - n), (0, 0))
    q, k, v, do = (jnp.pad(x, pad) for x in (q, k, v, do))
    ids = (jnp.arange(n_pad)[None, :] < n).astype(jnp.int32).repeat(b, 0)
    bs = lib.BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                        block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk, block_q_dkv=blk,
                        block_k_major_dq=blk, block_k_dq=blk, block_q_dq=blk)

    def attend(q, k, v):
        return lib.flash_attention(q, k, v, segment_ids=lib.SegmentIds(q=ids, kv=ids), sm_scale=scale,
                                   block_sizes=bs)

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(attend, q, k, v)
        grads = vjp(do)
    return o[:, :, :n], [g[:, :, :n] for g in grads]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,hd", [(50, 32), (197, 64), (257, 80)])
def test_plain_backward_matches_tpu_kernels_in_interpret_mode(n, hd, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _normals((1, 1, n, hd), seed=n + hd, count=4)
    scale = hd**-0.5
    o, want = _library_vjp(*(jnp.asarray(a, jdt) for a in (q, k, v, do)), scale)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    _, lse = flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tdt)
    got = flash_attention_bwd_plain(tq, tk, tv, to, lse, tdo, scale)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        j = np.asarray(j.astype(jnp.float32))
        assert t.dtype == tdt and t.shape == (1, 1, n, hd), name
        err = np.abs(t.float().numpy() - j)
        ref = np.abs(j).max()
        if dtype == "f32":
            assert err.max() <= 1e-5 * ref, (name, err.max(), ref)
        else:
            assert err.max() <= 2.0**-8 * ref, (name, err.max(), ref)
            assert (err > 0).mean() < 0.01, (name, (err > 0).mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,hd", [(1, 64), (65, 32), (129, 80)])
def test_function_on_the_cpu_matches_autograd_of_the_plain_forward(n, hd, dtype):
    """The Function 'flash' takes under grad: its output is the plain
    forward's bit for bit, its gradients autograd's through that forward
    (f32 within 1e-5, bf16 within 2^-7, of the largest |value| of the
    three reference gradients: the plain backward rounds p and ds to bf16
    as the library does and autograd does not, and at N = 1 dq and dk
    vanish in exact arithmetic and both sides return rounding noise). Its
    CPU call launches nothing."""
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _normals((2, 3, n, hd), seed=n * hd, count=4))
    scale = hd**-0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_cuda.flash_attention.launches, flash_cuda.flash_attention_dkv.launches,
              flash_cuda.flash_attention_dq.launches)
    out = flash_cuda.flash_attention(*leaves, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), flash_attention_plain(q, k, v, scale))
    got = torch.autograd.grad(out, leaves, g)
    assert (flash_cuda.flash_attention.launches, flash_cuda.flash_attention_dkv.launches,
            flash_cuda.flash_attention_dq.launches) == before
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref_leaves, scale), ref_leaves, g)
    tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * max(b.float().abs().max().item() for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == q.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_plain_halves_and_lse():
    """The plain backward is di, then the dK/dV half, then the dQ half; lse
    is log Σ exp(s·scale) of each row; return_lse leaves the output as it
    was."""
    q, k, v, o, do = (torch.from_numpy(a) for a in _normals((1, 2, 40, 32), seed=7, count=5))
    scale = 0.2
    out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    assert torch.equal(out, flash_attention_plain(q, k, v, scale)) and lse.shape == (1, 2, 40)
    s = (q.double() @ k.double().transpose(-2, -1)) * scale
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=0, atol=1e-5)
    di = flash_attention_di(o, do)
    assert torch.equal(di, (o * do).sum(-1))
    dk, dv = flash_attention_dkv_plain(q, k, v, lse, do, di, scale)
    dq = flash_attention_dq_plain(q, k, v, lse, do, di, scale)
    for a, b in zip(flash_attention_bwd_plain(q, k, v, o, lse, do, scale), (dq, dk, dv)):
        assert torch.equal(a, b)


def test_function_refuses_a_second_derivative():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _normals((1, 1, 9, 32), seed=3, count=3))
    out = flash_cuda.flash_attention(q, k, v, 0.2)
    (dq,) = torch.autograd.grad(out.sum(), (q,), create_graph=False)
    assert dq.shape == q.shape
    out = flash_cuda.flash_attention(q, k, v, 0.2)
    with pytest.raises(RuntimeError, match="Higher-order AD not supported"):
        torch.autograd.grad(out.sum(), (q,), create_graph=True)


def test_no_grad_takes_no_function():
    """Under no_grad, inference_mode or with no input requiring grad, the
    call returns the plain forward with no autograd node."""
    q, k, v = (torch.from_numpy(a) for a in _normals((1, 2, 20, 64), seed=5, count=3))
    q.requires_grad_()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = flash_cuda.flash_attention(q, k, v, 0.125)
        assert out.grad_fn is None
    out = flash_cuda.flash_attention(q.detach(), k, v, 0.125)
    assert out.grad_fn is None and torch.equal(out, flash_attention_plain(q.detach(), k, v, 0.125))


def test_flash_vit_gradients_match_jax_grad_of_the_xla_vit():
    """A 2-block, 64-wide ViT of 2 heads of 32 (LayerScale 0.1 so the blocks
    move the tokens), f32: the input's and every parameter's gradient of
    Σ patch tokens · g under 'flash' (the Function on the CPU) against
    jax.grad of the JAX ViT under 'xla', each within 1e-5 of the tensor's
    largest |gradient| (the patch embedding's reach ~80: f32 rounding there
    alone is ~1e-5 absolute)."""
    jcfg = JConfig(8, 64, 2, 2, img_size=32, layerscale=True, attention_impl="xla")
    jvit = JViT(jcfg)
    np_params = jax.tree.map(np.asarray, jvit.init(jax.random.PRNGKey(3)))
    for key in ("ls1", "ls2"):
        np_params["blocks"][key] = np.full_like(np_params["blocks"][key], 0.1)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    g = rng.normal(size=(2, 16, 64)).astype(np.float32)

    def loss(params, x):
        return jnp.sum(jvit.apply(params, x)["x_norm_patchtokens"] * g)

    jp, jx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))
    tvit = ViT(ViTConfig(8, 64, 2, 2, img_size=32, layerscale=True, attention_impl="flash"))
    tvit.load_state_dict(params_from_jax(np_params))
    tx = torch.from_numpy(x).requires_grad_()
    out = tvit(tx)["x_norm_patchtokens"]
    assert out.shape == (2, 16, 64)
    (out * torch.from_numpy(g)).sum().backward()
    want = {"input": np.asarray(jx), **params_from_jax(jax.tree.map(np.asarray, jp))}
    got = {"input": tx.grad, **{name: prm.grad for name, prm in tvit.named_parameters()}}
    assert set(got) <= set(want)
    for name, grad in got.items():
        assert grad is not None, name
        ref = np.asarray(want[name])
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_route_names_the_backward_kernels():
    """The backward's two kernels run wgmma in bf16 and in f32 (3xTF32) at
    every width; the forward stays on wgmma; other kernels or widths have
    no route."""
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (32, 64, 80):
            want = "wgmma"
            assert flash_cuda.route(dtype, hd, "dkv") == flash_cuda.route(dtype, hd, "dq") == want
            assert flash_cuda.route(dtype, hd) == "wgmma"
    with pytest.raises(ValueError, match="kernels"):
        flash_cuda.route(torch.bfloat16, 64, "backward")
    with pytest.raises(ValueError, match="head widths"):
        flash_cuda.route(torch.float32, 48, "dq")
