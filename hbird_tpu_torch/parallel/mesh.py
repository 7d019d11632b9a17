"""Device meshes: named axes over a grid of torch devices.

Counterpart of hbird_tpu/parallel/mesh.py. The port scales along the JAX
package's two axes:
- 'bank': memory-bank rows, each shard searched by K1 on its own device
  (the Faiss IndexShards analogue, reference hbird/nn/search_faiss.py:53-63);
- 'data': batches of images, each slice run on its own row of the mesh.

A device may repeat in the grid (`['cpu'] * 8`, `['cuda:0'] * 4`): the
shards then share that device and run one after another on its stream.
That is how the CPU tests and a one-card machine hold 2-8 shards, the
counterpart of the JAX tests' virtual CPU devices, which PyTorch lacks.

A mesh may also span the processes of a torch.distributed group
(parallel/distributed.py::process_mesh): `ranks` then names the process
that owns each position, and a process's grid holds None where another
process's device stands.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def canonical_device(device: DeviceLike) -> torch.device:
    """A torch.device with its CUDA index filled in, so equal cards compare
    equal ('cuda' and 'cuda:0' on card 0)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an n-d grid of torch devices.

    `shape` maps each axis name to its size, in axis order, as the engine
    reads it (`mesh.shape.get('bank', 1)`); `devices` is the grid (a numpy
    object array of torch.device, None where another process's device
    stands); `ranks`, for a mesh over a process group, the grid of owning
    ranks (None for a process-local mesh).
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], ranks=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        self.ranks = None if ranks is None else np.asarray(ranks).reshape(devices.shape)

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh's positions belong to several processes."""
        return self.ranks is not None

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if a == i else 0 for a in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str] = ("data", "bank"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh with the given per-axis sizes.

    `devices=None` takes the first n CUDA cards, and asking for more cards
    than the host has raises. An explicit list (names or torch.devices) may
    repeat a device; its first n entries fill the grid in row-major order.
    """
    n = int(np.prod(axis_sizes))
    if n < 1:
        raise ValueError(f"a mesh needs at least one device: axis sizes {tuple(axis_sizes)}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"mesh needs {n} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [canonical_device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(tuple(axis_sizes)), axis_names)


def default_mesh(n_devices: Optional[int] = None, bank_axis_size: Optional[int] = None) -> Mesh:
    """1-d ('bank',) mesh over the first n CUDA cards, or a 2-d ('data',
    'bank') one when `bank_axis_size` is given."""
    n = n_devices or torch.cuda.device_count()
    if bank_axis_size:
        if n % bank_axis_size:
            raise ValueError(f"{n} devices do not split into bank axes of {bank_axis_size}")
        return make_mesh((n // bank_axis_size, bank_axis_size), ("data", "bank"))
    return make_mesh((n,), ("bank",))
