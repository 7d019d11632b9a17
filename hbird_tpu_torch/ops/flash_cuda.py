"""K3 and K3-bwd on the GPU: the wrappers of the flash attention CUDA kernels.

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

Gradients (K3-bwd, the library's `_flash_attention_dkv_kernel` and
`_flash_attention_dq_kernel`): when grad mode is on and q, k or v requires
grad, `flash_attention` goes through `FlashAttention`, a
`torch.autograd.Function`. Its forward runs K3's `LSE` instances, which
also write each row's log-sum-exp (one f32 a row, the residual), and its
backward `flash_attention_bwd`: di = Σ o·do as a torch op, then the two
hand-written kernels of ops/csrc/flash_bwd.cu (`flash_attention_dkv`: dk
and dv, each work item owning a block of keys; `flash_attention_dq`: dq,
each owning a block of queries; no atomics, so two runs give the same
bits). On CPU tensors the same Function runs the plain forward and
backward (ops/flash.py). It is once differentiable, like the library's VJP: a
second derivative raises "Higher-order AD not supported". Under
`torch.no_grad()` or `torch.inference_mode()`, as the engine runs,
`flash_attention` launches the forward alone, with no Function and no
residual. `flash_attention_dkv.launches` and `flash_attention_dq.launches`
count the backward kernels' launches.

What bounds the backward on the card: operations (at the ViT-B/14 main
shape ~1,200 flops a byte moved, against the ~295 where an H100 stops
being memory bound). Both dtypes run `wgmma` + TMA as the forward does:
persistent CTAs, a producer warp streaming tiles through an mbarrier
ring, p and ds formed in the score accumulators and fed back as register
A operands. bf16 items own 128 rows and read the streamed tile as the
transposed B in place; f32 items own 64 rows and run 3xTF32, the tiles
split (and Q, dO or K transposed) in shared memory by the producer
warpgroup's other warps. `route` names them.

Any number of (batch, head) pairs runs: K3 and the backward walk their
work items with persistent CTAs, so the only limit is a 32-bit item
index (`_check_card` raises past it).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.flash import (
    flash_attention_di,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_plain,
)

HEAD_DIMS = (32, 64, 80)  # the kernel's widths: every VIT_PRESETS head width
MAX_ITEMS = 2**31 - 1 - 2**16  # work items a launch takes (hopper.cuh's MAX_ITEMS): a 32-bit index
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_BWD_ARGTYPES = (
    ctypes.c_int, *(ctypes.c_void_p,) * 8, *(ctypes.c_int,) * 4, *(ctypes.c_longlong,) * 6,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_launch = None  # flash_attn_launch, once loaded
_launch_lse = None  # flash_attn_launch_lse
_launch_bwd = None  # flash_bwd_launch


def route(dtype: torch.dtype, hd: int, kernel: str = "forward") -> str:
    """The kernel form a CUDA call at this dtype and head width runs: the
    forward and the backward's 'dkv' and 'dq' kernels 'wgmma' (bf16, and
    f32 as 3xTF32) at hd 32, 64 and 80."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the K3 kernel takes head widths {HEAD_DIMS}, not {hd}")
    if kernel not in ("forward", "dkv", "dq"):
        raise ValueError(f"K3's kernels are 'forward', 'dkv' and 'dq', not {kernel!r}")
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


def _entry_lse():
    """The forward's entry point that also writes the rows' log-sum-exp."""
    global _launch_lse
    if _launch_lse is None:
        fn = cuda_build.load("flash_attn.cu", "flash_attn_launch", _ARGTYPES).flash_attn_launch_lse
        fn.argtypes, fn.restype = [*_ARGTYPES, ctypes.c_void_p], ctypes.c_int
        _launch_lse = fn
    return _launch_lse


def _entry_bwd():
    """The backward kernels' entry point (ops/csrc/flash_bwd.cu)."""
    global _launch_bwd
    if _launch_bwd is None:
        _launch_bwd = cuda_build.load("flash_bwd.cu", "flash_bwd_launch", _BWD_ARGTYPES).flash_bwd_launch
    return _launch_bwd


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (B, H, N, hd) inputs (K3).

    q, k and v share shape, dtype (float32 or bfloat16) and device. On the
    card hd must be 32, 64 or 80. Returns (B, H, N, hd) in q's dtype,
    differentiable (K3-bwd on the card) when grad mode is on and q, k or v
    requires grad.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale)
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    return _forward(q, k, v, scale)


def _check_card(q: torch.Tensor, rows: int = 128) -> None:
    """What the kernels take: a head width of HEAD_DIMS, and (batch, head)
    pairs times ⌈N / rows⌉ blocks (K3 and the bf16 backward: 128-row items;
    the f32 backward: 64-row items) within MAX_ITEMS, a 32-bit index."""
    b, h, n, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the K3 kernel takes head widths {HEAD_DIMS}, not {hd}")
    items = b * h * -(-n // rows)
    if items > MAX_ITEMS:
        raise ValueError(f"{b * h} (batch, head) pairs of {n} rows make {items} work items of {rows} rows; "
                         f"the kernels index at most {MAX_ITEMS} in 32 bits")


def _forward(q, k, v, scale: float, lse=None) -> torch.Tensor:
    """K3 on CUDA tensors; with `lse` (a contiguous (B, H, N) f32 tensor)
    the rows' log-sum-exp is written there too."""
    _check_card(q)
    b, h, n, hd = q.shape
    # (B, N, H, hd) in memory: the heads merge back into (B, N, D) for free.
    ob, on = n * h * hd, h * hd
    out = torch.empty_strided((b, h, n, hd), (ob, hd, on, 1), dtype=q.dtype, device=q.device)
    if n == 0 or b == 0:
        return out
    if not _kernel_layout(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    device = q.get_device()
    bf16 = q.dtype == torch.bfloat16
    sb, sh, sn, _ = q.stride()
    # The device's current stream as a handle, without building a Stream object.
    stream = torch._C._cuda_getCurrentRawStream(device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, hd, sb, sh, sn,
            ob, hd, on, float(scale), bf16, device, stream)
    err = _entry()(*args) if lse is None else _entry_lse()(*args, lse.data_ptr())
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.forms["bf16" if bf16 else "f32"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """K3 with its backward: the forward saves q, k, v, the output and the
    rows' log-sum-exp; the backward is `flash_attention_bwd` (the kernels on
    CUDA tensors, the plain version on CPU tensors). Once differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
            out = _forward(q, k, v, scale, lse)
        elif q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
        else:
            raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():  # create_graph: a second derivative was asked for
            raise RuntimeError("Higher-order AD not supported")
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.scale), None)


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of softmax(q·kᵀ·scale)·v (K3-bwd): q, k, v, its output o
    and o's gradient do are (B, H, N, hd), lse (B, H, N) f32 the forward's
    rows' log-sum-exp. di = Σ o·do is a torch op; on CUDA tensors the dK/dV
    and dQ kernels launch, on CPU tensors their plain versions run."""
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_dkv(q, k, v, lse, do, di, scale)
    return flash_attention_dq(q, k, v, lse, do, di, scale), dk, dv


def _bwd_layout(do: torch.Tensor) -> bool:
    """do's strides as the backward kernels read them: unit along hd, every
    pointer and stride a multiple of 16 bytes."""
    sb, sh, sn, sd = do.stride()
    size = do.element_size()
    return sd == 1 and (sb * size) % 16 == (sh * size) % 16 == (sn * size) % 16 == do.data_ptr() % 16 == 0


def _backward_kernel(kernel: int, q, k, v, lse, do, di, scale: float, outs) -> None:
    """Launch backward kernel 0 (dk, dv) or 1 (dq) into `outs`."""
    _check(q, k, v)
    _check_card(q, 128 if q.dtype == torch.bfloat16 else 64)
    b, h, n, hd = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != q.shape[:3] or di.shape != q.shape[:3]:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype}, lse {tuple(lse.shape)} and di {tuple(di.shape)} "
                         f"do not match q {tuple(q.shape)} {q.dtype}")
    if lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError(f"lse and di must be float32: {lse.dtype}, {di.dtype}")
    if not all(t.is_cuda and t.device == q.device for t in (do, lse, di)):
        raise ValueError(f"do, lse and di must lie on {q.device}")
    if not _kernel_layout(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not _bwd_layout(do):
        do = do.contiguous()
    lse, di = lse.contiguous(), di.contiguous()
    device = q.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = _entry_bwd()(kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       di.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(), b, h, n, hd, *q.stride()[:3],
                       *do.stride()[:3], float(scale), q.dtype == torch.bfloat16, device, stream)
    if err != 0:
        raise RuntimeError(f"K3-bwd {('dkv', 'dq')[kernel]} launch failed: CUDA error {err}")


def flash_attention_dkv(q, k, v, lse, do, di, scale: float):
    """(dk, dv) of attention over (B, H, N, hd), given the forward's lse and
    di = Σ o·do ((B, H, N) f32): the dK/dV kernel on CUDA tensors, its plain
    version on CPU tensors. Outputs are contiguous, in q's dtype."""
    if not q.is_cuda:
        return flash_attention_dkv_plain(q, k, v, lse, do, di, scale)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    if q.numel() == 0:
        return dk, dv
    _backward_kernel(0, q, k, v, lse, do, di, scale, (dk, dv))
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, lse, do, di, scale: float):
    """dq of attention over (B, H, N, hd): the dQ kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if not q.is_cuda:
        return flash_attention_dq_plain(q, k, v, lse, do, di, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    _backward_kernel(1, q, k, v, lse, do, di, scale, (dq,))
    flash_attention_dq.launches += 1
    return dq


flash_attention.launches = 0
flash_attention.forms = collections.Counter()
flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0
