"""Bank and tree persistence with tensors on the card (bank/io.py, the tree
backend's save_tree/load_tree/from_bankdir).

Every test here needs a CUDA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor `hbird_tpu`, so it runs on a GPU machine
without them, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bank_cuda.py

Savers pull a CUDA bank to the host one chunk at a time (never the whole
bank); loaders assemble it on the card. What goes through the disk comes
back bit for bit, and a tree saved and reloaded on the card gives K2's
neighbours bit for bit. `test_torch_bank_io.py` and
`test_torch_tree_persistence.py` hold the same code against the JAX
package on the CPU.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.bank import io
from hbird_tpu_torch.nn import NearestNeighborSearchApprox
from hbird_tpu_torch.ops import ivf_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: saving from and loading onto the card")
    return torch.device("cuda")


def _bank(dev, m=5000, d=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.nn.functional.normalize(torch.randn(8, d, generator=g, device=dev), dim=1)
    who = torch.randint(0, 8, (m,), generator=g, device=dev)
    x = centres[who] + 0.1 * torch.randn(m, d, generator=g, device=dev)
    return torch.nn.functional.normalize(x, dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8], ids=["f32", "bf16", "int8"])
def test_chunked_save_from_the_card(cuda_device, tmp_path, monkeypatch, dtype):
    x = _bank(cuda_device)
    x = (x * 100).to(dtype) if dtype == torch.int8 else x.to(dtype)
    pulled = []
    host_block = io._host_block
    monkeypatch.setattr(io, "_host_block", lambda b: pulled.append((b.device.type, b.shape[0])) or host_block(b))
    p = io.save_memory_sharded(x, str(tmp_path / "b.bankdir"), chunk_rows=1024)
    assert pulled == [("cuda", min(1024, 5000 - s)) for s in range(0, 5000, 1024)]
    back = io.load_memory_sharded(p, device=cuda_device)
    assert back.device.type == "cuda" and back.dtype == dtype and torch.equal(back, x)
    cpu = io.load_memory_sharded(p, device="cpu")
    assert cpu.device.type == "cpu" and torch.equal(cpu, x.cpu())


def test_flat_files_from_and_onto_the_card(cuda_device, tmp_path):
    x = _bank(cuda_device)
    for ext in (".npy", ".npz", ".pt", ".bankdir"):
        p = io.save_memory(x, str(tmp_path / f"m{ext}"))
        back = io.load_memory(p, device=cuda_device)
        assert back.device.type == "cuda" and back.dtype == torch.float32 and torch.equal(back, x), ext
        assert io.load_memory(p).device.type == "cuda", ext  # device=None means CUDA


def test_windows_cast_on_the_card(cuda_device, tmp_path):
    x = _bank(cuda_device)
    f = io.save_memory_sharded(x, str(tmp_path / "f.bankdir"), chunk_rows=700)
    rows = torch.cat([w.to(cuda_device) for w, _ in io.iter_bankdir_windows(f, window_rows=900)])
    assert torch.equal(rows, x)


@pytest.mark.parametrize("kw", [{}, {"quantization": "int8_rows"},
                                {"quantization": "int8_asym", "dimensions_per_block": 4}],
                         ids=["bf16", "int8_rows", "int8_asym"])
def test_treedir_round_trip_on_the_card(cuda_device, tmp_path, kw):
    x = _bank(cuda_device, m=20000, d=128)
    labels = torch.rand(20000, 5, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
    tree = NearestNeighborSearchApprox(x, n_neighbors=30, label_memory=labels, use_tree=True, num_leaves=16,
                                       num_leaves_to_search=4, device=cuda_device, **kw)
    p = tree.save_tree(str(tmp_path / "t.treedir"), chunk_rows=3000)
    back = NearestNeighborSearchApprox.load_tree(p, n_neighbors=30, num_leaves_to_search=4, device=cuda_device)
    assert back.bank.device.type == "cuda" and back.bank.dtype == tree.bank.dtype
    q = x[:2048] + 0.01
    before = ivf_cuda.ivf_topk.launches
    a = tree.search_with_labels_pure(tree.device_state, q, 30, probe_mode="tile")
    b = back.search_with_labels_pure(back.device_state, q, 30, probe_mode="tile")
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.launches == before + 2  # K2 on both
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_streamed_build_on_the_card_equals_the_in_memory_build(cuda_device, tmp_path):
    x = _bank(cuda_device, m=30000, d=128)
    labels = torch.rand(30000, 4, generator=torch.Generator(device=cuda_device).manual_seed(2), device=cuda_device)
    f = io.save_memory_sharded(x, str(tmp_path / "f.bankdir"), chunk_rows=7000)
    lab = io.save_memory_sharded(labels, str(tmp_path / "l.bankdir"), chunk_rows=5000)
    streamed = NearestNeighborSearchApprox.from_bankdir(f, lab, n_neighbors=30, window_rows=30000, num_leaves=32,
                                                        device=cuda_device)
    flat = NearestNeighborSearchApprox(x, n_neighbors=30, label_memory=labels, use_tree=True, num_leaves=32,
                                       device=cuda_device)
    for name in ("centroids", "slots", "perm", "leaf_valid", "bank", "labels"):
        assert torch.equal(getattr(streamed, name), getattr(flat, name)), name
    assert streamed.bank.device.type == "cuda"
