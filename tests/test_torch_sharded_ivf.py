"""parallel/sharded_ivf.py against the JAX package's leaf-sharded tree and
against the port's unmeshed tree.

- Meshes of 2, 4 and 8 shards over the CPU (a device may repeat in a port
  mesh; the JAX side runs on the 8 virtual CPU devices of conftest.py). The
  bank has 2,998 rows, so 4 and 8 shards pad it (no ghost rows may appear).
- `sharded_kmeans`: centroids within 1e-5 of the JAX function's and of
  the port's one-device `full_bank_lloyd`.
- `sharded_assign_leaves`: choices equal to the JAX function's and the
  unmeshed `assign_leaves`', scores within 1e-6.
- `build_ivf_sharded`, host layout, with the JAX package's centroids handed
  over: against the JAX build, leaves equal and slots, perm and fill equal
  up to adjacent rows whose priorities tie within 1e-6
  (tests/test_torch_tree_persistence.py's rule), slabs and labels within
  1e-6 through that map; against the port's unmeshed build, equal bit for
  bit.
- `sharded_ivf_knn_with_labels` on the JAX build's slabs in f32, bf16,
  int8_rows and asym (bf16 queries on per-row codes): with every leaf
  probed, 'split' and 'full', the meshed search equals the unmeshed one
  (int8_rows bit for bit) and the exact search; a shard whose leaves are
  all empty takes part. (Against the JAX search:
  tests/test_torch_sharded_ivf_search.py.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu.ops import ivf as jivf
from hbird_tpu.ops.quantize import quantize_bank_int8 as j_quantize_bank, quantize_queries_int8 as j_quantize_q
from hbird_tpu.parallel import make_mesh as j_make_mesh
from hbird_tpu.parallel import sharded_ivf as jsi
from hbird_tpu_torch.ops import ivf
from hbird_tpu_torch.ops.knn import exact_knn
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
from hbird_tpu_torch.parallel import make_mesh
from hbird_tpu_torch.parallel import sharded_ivf as si
from hbird_tpu_torch.parallel.sharded_knn import shard_rows
from test_torch_tree_persistence import TIE, _assert_same_layout, _layout_prio

RTOL = 1e-5
M, D, C, K = 2998, 32, 5, 10
N_LEAVES, CAP = ivf.tree_layout(M, 16)  # (16, 256)
BLOCK_Q, N_PROBE = 64, 3
SHARDS = (2, 4, 8)


def _clustered(m, d, n_clusters, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, n_clusters, m)] + rng.normal(size=(m, d)).astype(np.float32) * 0.3
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def cpu_mesh(n):
    return make_mesh((n,), ("bank",), ["cpu"] * n)


@pytest.fixture(scope="module")
def data():
    x = _clustered(M, D, 10, seed=7)
    rng = np.random.default_rng(8)
    labels = rng.random((M, C)).astype(np.float32)
    cent = np.asarray(jivf.train_centroids(jnp.asarray(x), N_LEAVES, iters=6, key=jax.random.PRNGKey(0)))
    q = (x[rng.integers(0, M, 200)] + 0.02 * rng.normal(size=(200, D))).astype(np.float32)
    return x, labels, cent, q


@pytest.fixture(scope="module")
def jax_tree(data):
    """The JAX package's host-layout build on 4 shards."""
    x, labels, cent, _ = data
    parts = jsi.build_ivf_sharded(x, labels, jnp.asarray(cent), N_LEAVES, CAP, j_make_mesh((4,), ("bank",)))
    return {name: np.asarray(v) for name, v in parts.items() if name != "valid_rows"}


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_kmeans(data, n):
    x, _, _, _ = data
    init = x[np.random.default_rng(0).choice(M, N_LEAVES, replace=False)]
    jmesh = j_make_mesh((n,), ("bank",))
    jx, _ = jsi.shard_rows(x, jmesh)
    jc = np.asarray(jsi.sharded_kmeans(jx, jnp.asarray(init), jmesh, iters=3, valid_rows=M))
    shards = shard_rows(torch.from_numpy(x), cpu_mesh(n), block=1)
    assert sum(s.shape[0] for s in shards) == -(-M // n) * n  # padded as the JAX package pads
    tc = si.sharded_kmeans(shards, torch.from_numpy(init), iters=3, valid_rows=M)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-5)
    one = ivf.full_bank_lloyd(torch.from_numpy(x), torch.from_numpy(init), iters=3, block_rows=700)
    np.testing.assert_allclose(tc.numpy(), one.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_assign_leaves(data, n):
    x, _, cent, _ = data
    jmesh = j_make_mesh((n,), ("bank",))
    jx, _ = jsi.shard_rows(x, jmesh)
    jch, jsc = jsi.sharded_assign_leaves(jx, jnp.asarray(cent), jmesh, n_choices=3, chunk_rows=500)
    shards = shard_rows(torch.from_numpy(x), cpu_mesh(n), block=1)
    tch, tsc = si.sharded_assign_leaves(shards, torch.from_numpy(cent), n_choices=3, chunk_rows=500)
    np.testing.assert_array_equal(tch, jch)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-6)
    och, osc = ivf.assign_leaves(torch.from_numpy(x), torch.from_numpy(cent), n_choices=3, return_scores=True)
    np.testing.assert_array_equal(tch[:M], och)
    np.testing.assert_array_equal(tsc[:M], osc)


def _unmeshed(x, labels, cent):
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    ch, sc = ivf.assign_leaves(xt, ct, n_choices=3, return_scores=True)
    slots, fill = ivf.balanced_layout(ch, N_LEAVES, CAP, scores=sc)
    bank, labs, perm = ivf.build_ivf_arrays(xt, torch.from_numpy(labels), slots, N_LEAVES, CAP)
    return slots, fill, bank, labs, perm, ch, sc


@pytest.mark.parametrize("n", SHARDS)
def test_host_layout_build(data, jax_tree, n):
    x, labels, cent, _ = data
    if n == 4:
        jparts = jax_tree
    else:
        parts = jsi.build_ivf_sharded(x, labels, jnp.asarray(cent), N_LEAVES, CAP, j_make_mesh((n,), ("bank",)))
        jparts = {name: np.asarray(v) for name, v in parts.items() if name != "valid_rows"}
    times = {}
    t = si.build_ivf_sharded(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(cent), N_LEAVES,
                             CAP, cpu_mesh(n), times=times)
    assert set(times) == {"assign", "layout", "scatter"} and t["valid_rows"] == M
    assert len(t["ivf_bank"]) == n and all(s.shape == (N_LEAVES // n * CAP, D) for s in t["ivf_bank"])
    slots, fill, bank, labs, perm, ch, sc = _unmeshed(x, labels, cent)
    # the port's unmeshed build, bit for bit
    np.testing.assert_array_equal(t["slots"].numpy(), slots)
    np.testing.assert_array_equal(t["leaf_fill"], fill)
    assert torch.equal(t["perm"], perm)
    assert torch.equal(torch.cat(t["ivf_bank"]), bank) and torch.equal(torch.cat(t["ivf_labels"]), labs)
    # the JAX package's sharded build, up to near-tied priorities
    jch, jsc = jivf.assign_leaves(jnp.asarray(x), jnp.asarray(cent), n_choices=3, return_scores=True)
    sigma = _assert_same_layout(slots, jparts["slots"], CAP, N_LEAVES * CAP, _layout_prio(ch, sc, slots, CAP),
                                _layout_prio(jch, jsc, jparts["slots"], CAP))
    np.testing.assert_array_equal(t["leaf_fill"], jparts["leaf_fill"])
    moved = np.empty_like(jparts["perm"])
    moved[sigma] = jparts["perm"]
    np.testing.assert_array_equal(t["perm"].numpy(), moved)
    for name, tv in (("ivf_bank", bank), ("ivf_labels", labs)):
        moved = np.empty_like(jparts[name])
        moved[sigma] = jparts[name]
        np.testing.assert_allclose(tv.numpy(), moved, rtol=0, atol=TIE, err_msg=name)


def test_no_ghost_rows_and_an_empty_shard(data):
    """2,998 rows over 4 shards pad 2 rows, which never place; centroids of
    the last shard's leaves point away from every row and the leaves have
    room to spare (twice the capacity), so those leaves stay empty, and
    every-leaf search is still the exact search."""
    x, labels, cent, q = data
    cent = cent.copy()
    cent[-4:] = -x.mean(0) / np.linalg.norm(x.mean(0))
    mesh = cpu_mesh(4)
    cap = 2 * CAP
    t = si.build_ivf_sharded(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(cent), N_LEAVES,
                             cap, mesh)
    assert t["leaf_fill"].sum() == M and (t["leaf_fill"][-4:] == 0).all()
    assert t["perm"].max().item() == M - 1 and (t["perm"] >= 0).sum().item() == M
    lv = torch.as_tensor(t["leaf_fill"], dtype=torch.int32)
    anti = torch.from_numpy(-q)  # every true score is negative: a zero ghost row would win
    for qq in (torch.from_numpy(q), anti):
        v, i, lab = si.sharded_ivf_knn_with_labels(qq, t["ivf_bank"], t["ivf_labels"], torch.from_numpy(cent), lv,
                                                   K, mesh=mesh, cap=cap, n_probe=N_LEAVES, block_q=BLOCK_Q)
        rows = t["perm"][i]
        ev, ei = exact_knn(qq, torch.from_numpy(x), K)
        assert torch.equal(rows, ei)
        assert (v - ev).abs().max().item() <= RTOL * qq.norm(dim=1).max().item()
        assert torch.equal(lab, torch.from_numpy(labels)[rows])
    v, i, _ = si.sharded_ivf_knn_with_labels(anti, t["ivf_bank"], t["ivf_labels"], torch.from_numpy(cent), lv, K,
                                             mesh=mesh, cap=cap, n_probe=N_PROBE, block_q=BLOCK_Q)
    assert torch.isfinite(v).all() and (t["perm"][i] >= 0).all()


# ----------------------------------------------------------------------
# The search, on the JAX build's slabs
# ----------------------------------------------------------------------
def _forms(name, jb, q):
    """(port queries, port slabs, port row scale, JAX queries, JAX slabs,
    JAX row scale) of a K2 form over the slab bank `jb`."""
    if name == "f32":
        return torch.from_numpy(q), torch.from_numpy(jb), None, jnp.asarray(q), jnp.asarray(jb), None
    if name == "bf16":
        tq, tb = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(jb).to(torch.bfloat16)
        return tq, tb, None, jnp.asarray(q, jnp.bfloat16), jnp.asarray(jb, jnp.bfloat16), None
    codes, scale = quantize_bank_int8(torch.from_numpy(jb), per_row=True)
    jcodes, jscale = j_quantize_bank(jnp.asarray(jb), per_row=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))  # the same codes in both packages
    if name == "int8_rows":
        tq, _ = quantize_queries_int8(torch.from_numpy(q))
        jq, _ = j_quantize_q(jnp.asarray(q))
    else:  # asym: bf16 queries on the per-row codes
        tq, jq = torch.from_numpy(q).to(torch.bfloat16), jnp.asarray(q, jnp.bfloat16)
    return tq, codes, scale, jq, jcodes, jscale


@pytest.mark.parametrize("form", ["f32", "bf16", "int8_rows", "asym"])
@pytest.mark.parametrize("n", SHARDS)
def test_every_leaf_probed_equals_unmeshed_and_exact(data, jax_tree, n, form):
    _, _, cent, q = data
    tq, tb, ts, _, _, _ = _forms(form, jax_tree["ivf_bank"], q)
    lv = torch.from_numpy(jax_tree["leaf_fill"].astype(np.int32))
    labels_t = torch.from_numpy(jax_tree["ivf_labels"])
    mesh = cpu_mesh(n)
    bank, labels, rs = si.shard_ivf_state(tb, labels_t, mesh, cap=CAP, row_scale=ts)
    assert len(bank) == n and all(torch.equal(b, s) for b, s in zip(bank, tb.chunk(n)))
    for shard_probe in ("split", "full"):
        v, i, lab = si.sharded_ivf_knn_with_labels(
            tq, bank, labels, torch.from_numpy(cent), lv, K, mesh=mesh, cap=CAP, n_probe=N_LEAVES,
            block_q=BLOCK_Q, shard_probe=shard_probe, row_scale=rs,
        )
        v0, i0 = ivf.ivf_search(tq, tb, torch.from_numpy(cent), lv, K, cap=CAP, n_probe=N_LEAVES, block_q=BLOCK_Q,
                                row_scale=ts)
        assert torch.equal(i, i0) and torch.equal(lab, labels_t[i])
        if form == "int8_rows":
            assert torch.equal(v, v0)
        else:
            assert (v - v0).abs().max().item() <= RTOL * float(np.linalg.norm(q, axis=1).max()) * 2
        # the exact search over the slabs' real rows
        real = torch.nonzero((torch.arange(N_LEAVES * CAP) % CAP) < lv.long().repeat_interleave(CAP)).squeeze(1)
        _, ei = exact_knn(tq, tb[real], K, row_scale=None if ts is None else ts.reshape(-1)[real])
        assert torch.equal(i, real[ei])
