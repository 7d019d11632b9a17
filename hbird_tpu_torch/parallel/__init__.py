from hbird_tpu_torch.parallel.mesh import Mesh, default_mesh, make_mesh
from hbird_tpu_torch.parallel.sharded_knn import (
    pad_rows_for_mesh,
    ring_knn_with_labels,
    shard_bank,
    sharded_knn_with_labels,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "default_mesh",
    "pad_rows_for_mesh",
    "shard_bank",
    "sharded_knn_with_labels",
    "ring_knn_with_labels",
]
