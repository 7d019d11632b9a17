"""K3's plain version: softmax(q·kᵀ·scale)·v with the flash kernel's numerics.

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
"""

from __future__ import annotations

import torch


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Attention over (B, H, N, hd) q, k, v; returns (B, H, N, hd) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
