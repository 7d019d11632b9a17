"""K3 on the GPU: the wrapper of the flash attention CUDA kernel.

Counterpart of hbird_tpu/models/vit.py::_flash_attention (JAX's library
Pallas TPU flash attention). The kernel source is ops/csrc/flash_attn.cu;
ops/cuda_build.py compiles it with `nvcc` for sm_90a into a shared library
with a plain C interface at first use, and it is loaded with ctypes.

Both dtypes at every head width (32, 64, 80) run Hopper kernels (`wgmma`
on TMA rings with a producer warp): bf16 directly, f32 as 3xTF32 with the
tiles split (and V transposed) in shared memory by the producer
warpgroup's other warps; `route` names the kernel a call runs. No other
kernel stands behind them: a call the kernel cannot take raises.

A call's host work is kept short, since at mocov3_vits16's and
mae_vith14's shapes it rivals the kernel's time (PERF.md has its split):
the C entry point is looked up once, the output is one `empty_strided`,
the stream is read raw, the device is set in C only where it differs, and
the launcher asks for each device's SM count and sets the shared-memory
attribute once per process (ops/csrc/hopper.cuh); it encodes the tensor
maps on every call.

`flash_attention` takes the kernel for CUDA tensors and the plain version
(ops/flash.py::flash_attention_plain) for CPU tensors, and nothing else: a
CUDA tensor either launches the kernel or raises. `flash_attention.launches`
counts kernel launches, `flash_attention.forms` the same launches by dtype
('bf16', 'f32').

Layout: the kernel reads q, k and v through one shared set of strides, so
the ViT's views of its qkv projection go in as they are, with no copy; only
inputs whose strides differ or are not 16-byte multiples are made
contiguous first. The output is laid out (B, N, H, hd) in memory and
returned as a (B, H, N, hd) view, so `out.transpose(1, 2).reshape(B, N, D)`
merges the heads without a copy either.

The kernel has no backward (the library TPU kernel's backward, K3-bwd, is
not ported: ROADMAP queue 2, its last item), so on the card `flash_attention`
raises when autograd would record it (grad mode on and q, k or v requiring
grad) rather than return an output that looks differentiable and is not.
Under `torch.no_grad()` or `torch.inference_mode()`, as the engine runs,
it launches. On the CPU the plain version stays differentiable.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.flash import flash_attention_plain

HEAD_DIMS = (32, 64, 80)  # the kernel's widths: every VIT_PRESETS head width
MAX_BATCH_HEADS = 65535  # (batch, head) pairs the launch takes
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_launch = None  # flash_attn_launch, once loaded


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call at this dtype and head width runs: 'wgmma'
    (bf16, and f32 as 3xTF32, at hd 32, 64 and 80)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the K3 kernel takes head widths {HEAD_DIMS}, not {hd}")
    return "wgmma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    shape, dtype, device = q.shape, q.dtype, q.device
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v must share one (B, H, N, hd) shape: {q.shape}, {k.shape}, {v.shape}")
    if k.dtype != dtype or v.dtype != dtype or dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share dtype float32 or bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != device or v.device != device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """One shared set of strides, unit along hd, every pointer and stride a
    multiple of 16 bytes (the kernel's TMA copies). Written out, not as
    loops: it runs on every call."""
    sb, sh, sn, sd = q.stride()
    size = q.element_size()
    return (
        k.stride() == v.stride() == (sb, sh, sn, sd)
        and sd == 1
        and (sb * size) % 16 == (sh * size) % 16 == (sn * size) % 16 == 0
        and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    )


def _entry():
    """The C entry point, built and loaded at the first CUDA call."""
    global _launch
    if _launch is None:
        _launch = cuda_build.load("flash_attn.cu", "flash_attn_launch", _ARGTYPES).flash_attn_launch
    return _launch


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (B, H, N, hd) inputs (K3).

    q, k and v share shape, dtype (float32 or bfloat16) and device. On the
    card hd must be 32, 64 or 80. Returns (B, H, N, hd) in q's dtype.
    """
    _check(q, k, v)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale)
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "the K3 kernel has no backward (K3-bwd, the last item of ROADMAP queue 2): call it under "
            "torch.no_grad() or torch.inference_mode(), or on CPU tensors for gradients"
        )
    b, h, n, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the K3 kernel takes head widths {HEAD_DIMS}, not {hd}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"the K3 kernel takes at most {MAX_BATCH_HEADS} (batch, head) pairs: {b * h}")
    # (B, N, H, hd) in memory: the heads merge back into (B, N, D) for free.
    ob, on = n * h * hd, h * hd
    out = torch.empty_strided((b, h, n, hd), (ob, hd, on, 1), dtype=q.dtype, device=q.device)
    if n == 0 or b == 0:
        return out
    if not _kernel_layout(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    launch = _entry()
    device = q.get_device()
    bf16 = q.dtype == torch.bfloat16
    sb, sh, sn, _ = q.stride()
    # The device's current stream as a handle, without building a Stream object.
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, hd, sb, sh, sn,
                 ob, hd, on, float(scale), bf16, device, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.forms["bf16" if bf16 else "f32"] += 1
    return out


flash_attention.launches = 0
flash_attention.forms = collections.Counter()
