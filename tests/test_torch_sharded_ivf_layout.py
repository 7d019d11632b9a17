"""The meshed tree's 'device' layout and its scatter ring
(parallel/sharded_ivf.py) against the JAX package's and against the host
greedy.

- `sharded_balanced_layout` through `build_ivf_sharded(layout='device')`
  on 4 shards, with the JAX package's centroids handed over: slots, perm,
  leaf fill and slabs equal to `hbird_tpu.parallel.sharded_ivf`'s on these
  tie-free scores (within a leaf both order the slots shard-major).
- On 2, 4 and 8 shards: leaf membership equal to the host greedy's
  (ops/ivf.py::balanced_layout) for every row placed on one of its
  choices, the same set of rows spilled, every real row placed once and no
  padding row placed (2,998 rows pad to whole shards), perm and slots
  consistent and the slabs holding each row at its slot.
- `ring_scatter_build` on ragged rows with a dropped row (slot -1) against
  the JAX function: the same slabs, untouched slots zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu.ops import ivf as jivf
from hbird_tpu.parallel import make_mesh as j_make_mesh
from hbird_tpu.parallel import sharded_ivf as jsi
from hbird_tpu_torch.ops import ivf
from hbird_tpu_torch.parallel import sharded_ivf as si
from hbird_tpu_torch.parallel.sharded_knn import shard_rows
from test_torch_sharded_ivf import CAP, D, M, N_LEAVES, SHARDS, _clustered, cpu_mesh


@pytest.fixture(scope="module")
def case():
    x = _clustered(M, D, 10, seed=17)
    labels = np.random.default_rng(18).random((M, 4)).astype(np.float32)
    cent = np.asarray(jivf.train_centroids(jnp.asarray(x), N_LEAVES, iters=6, key=jax.random.PRNGKey(1)))
    jdev = jsi.build_ivf_sharded(x, labels, jnp.asarray(cent), N_LEAVES, CAP, j_make_mesh((4,), ("bank",)),
                                 layout="device")
    return x, labels, cent, {name: np.asarray(v) for name, v in jdev.items() if name != "valid_rows"}


def _device_build(case, n):
    x, labels, cent, _ = case
    return si.build_ivf_sharded(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(cent), N_LEAVES,
                                CAP, cpu_mesh(n), layout="device")


def test_device_layout_matches_jax(case):
    _, _, _, jdev = case
    t = _device_build(case, 4)
    assert isinstance(t["slots"], list) and len(t["slots"]) == 4 and len(t["perm"]) == 4
    np.testing.assert_array_equal(torch.cat(t["slots"]).numpy(), jdev["slots"])
    np.testing.assert_array_equal(torch.cat(t["perm"]).numpy(), jdev["perm"])
    np.testing.assert_array_equal(t["leaf_fill"], jdev["leaf_fill"])
    np.testing.assert_array_equal(torch.cat(t["ivf_bank"]).numpy(), jdev["ivf_bank"])
    np.testing.assert_array_equal(torch.cat(t["ivf_labels"]).numpy(), jdev["ivf_labels"])


@pytest.mark.parametrize("n", SHARDS)
def test_device_layout_membership_equals_the_host_greedy(case, n):
    x, labels, cent, _ = case
    t = _device_build(case, n)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    ch, sc = ivf.assign_leaves(xt, ct, n_choices=3, return_scores=True)
    host_slots, host_fill = ivf.balanced_layout(ch, N_LEAVES, CAP, scores=sc)
    np.testing.assert_array_equal(t["leaf_fill"], host_fill)
    slots = torch.cat(t["slots"]).numpy()
    perm = torch.cat(t["perm"]).numpy()
    assert slots.shape == (-(-M // n) * n,) and (slots[M:] == -1).all()  # padding never places
    real = slots[:M]
    assert (real >= 0).all() and np.unique(real).size == M
    np.testing.assert_array_equal(perm[real], np.arange(M))
    assert (perm >= 0).sum() == M and perm.max() == M - 1
    leaf_host, leaf_dev = host_slots // CAP, real // CAP
    spilled_host = ~(ch == leaf_host[:, None]).any(1)
    spilled_dev = ~(ch == leaf_dev[:, None]).any(1)
    np.testing.assert_array_equal(spilled_dev, spilled_host)
    np.testing.assert_array_equal(leaf_dev[~spilled_host], leaf_host[~spilled_host])
    bank, labs = torch.cat(t["ivf_bank"]).numpy(), torch.cat(t["ivf_labels"]).numpy()
    np.testing.assert_array_equal(bank[real], x)
    np.testing.assert_array_equal(labs[real], labels)


def test_ring_scatter_ragged_rows_and_a_dropped_row():
    rng = np.random.default_rng(1)
    m, d, n_slots = 37, 8, 40
    rows = rng.normal(size=(m, d)).astype(np.float32)
    labs = rng.random((m, 3)).astype(np.float32)
    slots = rng.permutation(n_slots)[:m].astype(np.int64)
    slots[5] = -1  # dropped
    jmesh = j_make_mesh((4,), ("bank",))
    jb, jl = jsi.ring_scatter_build(jsi.shard_rows(rows, jmesh)[0], jsi.shard_rows(labs, jmesh)[0], slots,
                                    n_slots, jmesh)
    mesh = cpu_mesh(4)
    tb, tl, perm = si.ring_scatter_build(shard_rows(torch.from_numpy(rows), mesh, block=1),
                                         shard_rows(torch.from_numpy(labs), mesh, block=1), slots, n_slots,
                                         with_perm=True)
    tb, tl, perm = torch.cat(tb).numpy(), torch.cat(tl).numpy(), torch.cat(perm).numpy()
    np.testing.assert_array_equal(tb, np.asarray(jb))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    placed = slots >= 0
    np.testing.assert_array_equal(perm[slots[placed]], np.nonzero(placed)[0])
    untouched = sorted(set(range(n_slots)) - set(slots[placed]))
    assert (tb[untouched] == 0).all() and (perm[untouched] == -1).all()
