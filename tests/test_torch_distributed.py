"""parallel/distributed.py across two gloo processes (torch.multiprocessing).

Counterpart of tests/test_distributed_smoke.py (the JAX package's
two-process run): `initialize` over tcp://127.0.0.1 with explicit
arguments (and idempotent), `is_global_zero`, `global_mesh` over given
devices, `sync_conf_mat` summing exactly across processes, and
`PredsmIoU.compute(sync_distributed=True)` equal to one process scoring
the union of both processes' data, with each local matrix left as it was.
In one process: no coordinator and no launcher environment skips quietly;
an explicit coordinator without its world size raises.
"""

import os
import socket

import numpy as np
import pytest
import torch.multiprocessing as mp

from hbird_tpu_torch.parallel import distributed as D
from hbird_tpu_torch.utils.eval_metrics import PredsmIoU

N_PROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shard_of_data(rank):
    rng = np.random.default_rng(100 + rank)
    gt = rng.integers(0, 4, 500)
    pred = np.where(rng.random(500) < 0.7, (gt + 1) % 4, rng.integers(0, 4, 500))
    return gt, pred


def _worker(rank, port, out_dir):
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank, backend="gloo")
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank)  # idempotent
    assert D.process_count() == N_PROC and D.process_index() == rank
    assert D.is_global_zero() == (rank == 0)
    assert D.global_mesh(devices=["cpu", "cpu"]).shape == {"bank": 2}
    total = D.sync_conf_mat(np.full((3, 3), rank + 1, np.int64))
    assert total.dtype == np.int64 and (total == 3).all(), total
    m = PredsmIoU(4, 4)
    m.update(*_shard_of_data(rank))
    local = m._conf_mat.copy()
    synced = m.compute(is_global_zero=True, sync_distributed=True, return_reordered=False)
    np.testing.assert_array_equal(m._conf_mat, local)  # the local matrix is kept
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array([synced[0], *synced[1]], np.float64))
    D.shutdown()


def test_two_gloo_processes_sum_the_confusion_matrix(tmp_path):
    mp.spawn(_worker, args=(_free_port(), str(tmp_path)), nprocs=N_PROC, join=True)
    union = PredsmIoU(4, 4)
    for rank in range(N_PROC):
        union.update(*_shard_of_data(rank))
    miou, tp, *_ = union.compute(is_global_zero=True, return_reordered=False)
    for rank in range(N_PROC):
        got = np.load(tmp_path / f"rank{rank}.npy")
        assert got[0] == miou and got[1:].tolist() == list(tp)


def test_single_process_behaviour(monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(name, raising=False)
    D.initialize()  # nothing to join: skips
    assert D.process_count() == 1 and D.is_global_zero()
    conf = np.arange(9).reshape(3, 3)
    assert D.sync_conf_mat(conf) is conf
    with pytest.raises(ValueError, match="num_processes"):
        D.initialize("127.0.0.1:1")
