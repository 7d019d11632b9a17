"""K3 on the GPU: the wrapper of the flash attention CUDA kernel.

Counterpart of hbird_tpu/models/vit.py::_flash_attention (JAX's library
Pallas TPU flash attention). The kernel source is ops/csrc/flash_attn.cu;
ops/cuda_build.py compiles it with `nvcc` for sm_90a into a shared library
with a plain C interface at first use, and it is loaded with ctypes.

`flash_attention` takes the kernel for CUDA tensors and the plain version
(ops/flash.py::flash_attention_plain) for CPU tensors, and nothing else: a
CUDA tensor either launches the kernel or raises. `flash_attention.launches`
counts kernel launches.

Layout: the kernel reads q, k and v through one shared set of strides, so
the ViT's views of its qkv projection go in as they are, with no copy; only
inputs whose strides differ or are not 16-byte multiples are made
contiguous first. The output is laid out (B, N, H, hd) in memory and
returned as a (B, H, N, hd) view, so `out.transpose(1, 2).reshape(B, N, D)`
merges the heads without a copy either.
"""

from __future__ import annotations

import ctypes

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.flash import flash_attention_plain

HEAD_DIMS = (32, 64, 80)  # the kernel's widths: every VIT_PRESETS head width
MAX_BATCH_HEADS = 65535  # the grid's second dimension
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, hd) shape: {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share dtype float32 or bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _kernel_layout(*xs: torch.Tensor) -> bool:
    """One shared set of strides, unit along hd, every pointer and stride a
    multiple of 16 bytes (the kernel's cp.async and vector loads)."""
    size = xs[0].element_size()
    strides = xs[0].stride()
    return (
        all(x.stride() == strides for x in xs)
        and strides[-1] == 1
        and all((s * size) % 16 == 0 for s in strides[:-1])
        and all(x.data_ptr() % 16 == 0 for x in xs)
    )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (B, H, N, hd) inputs (K3).

    q, k and v share shape, dtype (float32 or bfloat16) and device. On the
    card hd must be 32, 64 or 80. Returns (B, H, N, hd) in q's dtype.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    b, h, n, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the K3 kernel takes head widths {HEAD_DIMS}, not {hd}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"the K3 kernel takes at most {MAX_BATCH_HEADS} (batch, head) pairs: {b * h}")
    # (B, N, H, hd) in memory: the heads merge back into (B, N, D) for free.
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    if n == 0 or b == 0:
        return out
    if not _kernel_layout(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = cuda_build.load("flash_attn.cu", "flash_attn_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, hd,
            *q.stride()[:3], *out.stride()[:3], float(scale),
            int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
