"""K3's and K3-bwd's plain versions: softmax(q·kᵀ·scale)·v with the flash
kernel's numerics, and its gradient with the library backward kernels'.

Counterpart of hbird_tpu/models/vit.py::_flash_attention, which runs JAX's
library Pallas TPU flash attention (`_flash_attention_kernel`) over a
sequence padded to a multiple of 512 and masked by segment ids. This
function computes what that kernel computes, in its order, and is what
`attention_impl='flash'` runs on the CPU (ops/flash_cuda.py takes the CUDA
kernel for CUDA tensors):

- s = q·kᵀ accumulated in f32, then multiplied by `scale` (the XLA path
  instead scales q in the working dtype first);
- a max-stable softmax in f32, p = exp(s - max) / sum, normalised before
  the next step;
- p cast to v's dtype before p·v, which accumulates in f32;
- the output cast to q's dtype.

That is the library kernel's single-step form
(`_flash_attention_kernel_single_batch_single_step`), which it runs when
the whole padded key axis is one block: N ≤ 1,536, every preset at its
native size and the main path's 1,370 tokens at input 518. Past that it
steps over key blocks with an online softmax and rounds p against the
running maximum before normalising; that form differs from this one only
in where p is rounded to v's dtype, as the CUDA kernel does.

Keys at or past N never count: the kernel's segment-id mask exists only
for its padding, and nothing is padded here.

The backward (K3-bwd) is the library's VJP (`_flash_attention_bwd`): di =
Σ o·do outside any kernel, then `_flash_attention_dkv_kernel` (dk, dv) and
`_flash_attention_dq_kernel` (dq), each recomputing s and p from the
forward's per-row statistics, at their rounding points:

- di = Σ_d o·do in f32, from o in its dtype;
- s = q·kᵀ accumulated in f32, then times `scale`; p = exp(s - lse);
- dv = pᵀ·do with p cast to do's dtype first; dp = do·vᵀ in f32;
- ds = (dp - di)·p·scale; dk = dsᵀ·q and dq = ds·k with ds cast to the
  input dtype first; every product accumulates in f32, each output is
  cast once.

The library saves m and l, each broadcast over 128 lanes a row, and forms
p = exp(s - m)·(1/l). Here the forward keeps one f32 a row, lse = m +
log l (1/256 of the library's residual bytes), and p = exp(s - lse): one
exp and no multiply, a p that differs from the library's by a few f32
ulps, which the f32 tolerance (1e-5·max|ref|) and bf16's (one rounding of
p may go the other way) both cover. The library's bias gradient and
`causal` are left out: the JAX package passes neither.
"""

from __future__ import annotations

import torch


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, return_lse: bool = False
):
    """Attention over (B, H, N, hd) q, k, v; returns (B, H, N, hd) in q's
    dtype, and with `return_lse` also the rows' log-sum-exp (B, H, N) in f32
    (the backward's residual; the output is the same either way)."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def flash_attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do (B, H, N) in f32, from o and do in their dtypes."""
    return (o.float() * do.float()).sum(dim=-1)


def _p_ds(q, k, v, lse, do, di, scale):
    """p = exp(q·kᵀ·scale - lse) and ds = (do·vᵀ - di)·p·scale, in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-2, -1))
    return p, (dp - di.unsqueeze(-1)) * p * scale


def flash_attention_dkv_plain(q, k, v, lse, do, di, scale: float):
    """(dk, dv) of attention over (B, H, N, hd): the plain version of the
    dK/dV kernel, given the forward's lse and di (both (B, H, N) f32)."""
    p, ds = _p_ds(q, k, v, lse, do, di, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-2, -1), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-2, -1), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, lse, do, di, scale: float):
    """dq of attention over (B, H, N, hd): the plain version of the dQ
    kernel."""
    _, ds = _p_ds(q, k, v, lse, do, di, scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of softmax(q·kᵀ·scale)·v given its output o, the rows'
    lse and the output's gradient do; all (B, H, N, hd) but lse."""
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_dkv_plain(q, k, v, lse, do, di, scale)
    return flash_attention_dq_plain(q, k, v, lse, do, di, scale), dk, dv
