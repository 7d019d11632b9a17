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
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hbird_tpu_torch.parallel.mesh import make_mesh
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
