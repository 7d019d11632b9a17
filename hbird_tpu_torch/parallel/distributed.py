"""Multi-process helpers on torch.distributed.

Counterpart of hbird_tpu/parallel/distributed.py. The reference has no
multi-node story (an uninitialized torch.distributed hook and
Lightning-style is_global_zero gating, reference
hbird/utils/eval_metrics.py:246-252); this makes it real:

- `initialize()`: `torch.distributed.init_process_group`, NCCL when CUDA is
  available and gloo otherwise; idempotent. With no arguments it reads a
  launcher's environment (`torchrun`: MASTER_ADDR, WORLD_SIZE, RANK) and
  skips quietly when there is none; explicit arguments that fail raise.
- `is_global_zero()`: rank 0 gating.
- `global_mesh()`: this process's own cards on the 'bank' axis. The data
  parallelism spans processes: each feeds its own slice of the data and
  only the confusion matrix crosses processes (`sync_conf_mat`).
- `sync_conf_mat()`: the cross-process confusion-matrix sum (the
  reference's dormant all_reduce hook), exact in int64.
- `process_mesh()`: a ('bank',) mesh over every process's devices. Rank r
  owns a contiguous run of the axis's shards and a shard list holds None
  at the other processes' positions. The convention of every function that
  takes such a mesh (the flat search, parallel/sharded_knn.py; the
  leaf-sharded tree, parallel/sharded_ivf.py; the engine, hbird_eval.py):
  every process passes the same queries and gets the same results, what
  one process holding every shard would return.
- the collectives those functions use where the JAX package's shard_maps
  do: all-gathers of per-shard results in shard order (`gather_shards`),
  sums and maxima (`all_sum`, `all_max`), paired sends and receives of the
  tree's scatter ring (`send_rows`, `recv_rows`), barriers around the
  multi-process .bankdir and .treedir writers.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hbird_tpu_torch.parallel.mesh import Mesh, canonical_device, make_mesh
from hbird_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group (1 when none is initialized)."""
    return dist.get_world_size() if _ready() else 1


def process_index() -> int:
    """This process's rank (0 when none is initialized)."""
    return dist.get_rank() if _ready() else 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent).

    coordinator_address: 'host:port' or an init URL ('tcp://host:port');
        with it, `num_processes` and `process_id` are required and any
        failure raises. Without it, a launcher's environment is used
        (env://) when it names a world size, else nothing happens.
    backend: 'nccl' or 'gloo' (default: NCCL when CUDA is available). Under
        NCCL each process uses card `process_id` modulo the local count.
    """
    if _ready():
        return
    explicit = coordinator_address is not None
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0"))
    else:
        logger.info("distributed init skipped (no coordinator and no launcher environment)")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                                rank=int(process_id))
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise
        logger.info("distributed init skipped (%s)", e)
        return
    logger.info("distributed: process %d/%d on %s", process_index(), process_count(), backend)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if _ready():
        dist.destroy_process_group()


def is_global_zero() -> bool:
    """Rank-0 gating (reference eval_metrics.py:246-248 convention)."""
    return process_index() == 0


def global_mesh(bank_axis_size: Optional[int] = None, devices=None):
    """This process's ('bank',) mesh: its first `bank_axis_size` CUDA cards
    (default: all of them), or the given `devices`. The 'data' parallelism
    across processes needs no mesh axis here: each process evaluates its
    own data and `sync_conf_mat` sums the matrices."""
    if devices is not None:
        return make_mesh((bank_axis_size or len(devices),), ("bank",), devices)
    return make_mesh((bank_axis_size or torch.cuda.device_count(),), ("bank",))


def sync_conf_mat(conf: np.ndarray) -> np.ndarray:
    """Sum a host confusion matrix over the process group (int64, exact);
    the input itself when no group is initialized."""
    if not _ready():
        return conf
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    total = torch.tensor(np.asarray(conf, np.int64), device=dev)  # a copy: the reduce is in place
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.cpu().numpy()


# ----------------------------------------------------------------------
# A bank axis over the process group
# ----------------------------------------------------------------------
def process_mesh(local_devices: Sequence, bank_axis: str = "bank") -> Mesh:
    """A 1-d mesh whose `bank_axis` holds every process's `local_devices`,
    in rank order (each process gives the same number). Rank r owns shards
    [r·n, (r+1)·n); this process's grid holds None at the others'."""
    local = [canonical_device(d) for d in local_devices]
    n, world, rank = len(local), process_count(), process_index()
    if _ready():
        counts = [None] * world
        dist.all_gather_object(counts, n)
        if len(set(counts)) != 1:
            raise ValueError(f"every process must give the same number of devices: {counts}")
    grid = np.empty(n * world, dtype=object)
    grid[rank * n : (rank + 1) * n] = local
    return Mesh(grid, (bank_axis,), ranks=np.repeat(np.arange(world), n))


def _comm_device() -> torch.device:
    """Where collectives run: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_shards(parts: Sequence[Optional[torch.Tensor]], home) -> List[torch.Tensor]:
    """Every shard's tensor (one shape for all) on `home`, in shard order:
    this process's present entries and the others' all-gathered."""
    comm = _comm_device()
    mine = torch.stack([t.to(comm) for t in parts if t is not None])
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [t.to(home) for t in torch.cat(out).unbind(0)]


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    wide = torch.float32 if t.is_floating_point() else torch.int64  # bf16 and int8 widen exactly
    c = t.to(_comm_device(), wide)
    dist.all_reduce(c, op=op)
    return c.to(t.device, t.dtype)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the group (the masked psum: exact where one process
    holds each nonzero entry)."""
    return _reduce(t, dist.ReduceOp.SUM)


def all_max(t: torch.Tensor) -> torch.Tensor:
    """`t`'s elementwise maximum over the group."""
    return _reduce(t, dist.ReduceOp.MAX)


def barrier() -> None:
    if _ready():
        dist.barrier()


def send_rows(tensors: Sequence[torch.Tensor], dst: int) -> None:
    """Send equal-length row blocks to rank `dst`: their row count, then
    each block's bytes (what the scatter ring hands the next shard)."""
    comm = _comm_device()
    n = tensors[0].shape[0]
    dist.send(torch.tensor([n], dtype=torch.int64, device=comm), dst)
    if n:
        for t in tensors:
            dist.send(t.contiguous().view(torch.uint8).to(comm), dst)


def recv_rows(specs: Sequence, src: int, device) -> Optional[List[torch.Tensor]]:
    """Receive `send_rows`' blocks from rank `src`, as (dtype, row shape)
    `specs` say, on `device`; None when no rows came."""
    comm = _comm_device()
    n = torch.zeros(1, dtype=torch.int64, device=comm)
    dist.recv(n, src)
    n = int(n.item())
    if n == 0:
        return None
    out = []
    for dtype, shape in specs:
        row_bytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty((n, row_bytes), dtype=torch.uint8, device=comm)
        dist.recv(buf, src)
        out.append(buf.view(dtype).reshape((n, *shape)).to(device))
    return out
