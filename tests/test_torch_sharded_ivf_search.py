"""`sharded_ivf_knn_with_labels` (parallel/sharded_ivf.py) against the JAX
package's, on the JAX package's host-layout build over 4 shards (the
fixtures of tests/test_torch_sharded_ivf.py): 'split' and 'full' probing,
in f32, bf16, int8_rows and asym (bf16 queries on per-row codes). On these
tie-free queries the ids are equal, the values within 1e-5·||q||·max||b||
(int8_rows: equal) and the labels within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.parallel import make_mesh as j_make_mesh
from hbird_tpu.parallel import sharded_ivf as jsi
from hbird_tpu_torch.parallel import sharded_ivf as si
from test_torch_sharded_ivf import (  # noqa: F401 (module fixtures)
    BLOCK_Q,
    CAP,
    K,
    N_PROBE,
    RTOL,
    _forms,
    cpu_mesh,
    data,
    jax_tree,
)


SEARCH_CASES = [("f32", "split"), ("f32", "full"), ("bf16", "split"), ("int8_rows", "split"), ("asym", "full")]


@pytest.mark.parametrize("form, shard_probe", SEARCH_CASES)
def test_search_matches_jax(data, jax_tree, form, shard_probe):
    _, _, cent, q = data
    jmesh, mesh = j_make_mesh((4,), ("bank",)), cpu_mesh(4)
    tq, tb, ts, jq, jb, js = _forms(form, jax_tree["ivf_bank"], q)
    lv = jax_tree["leaf_fill"].astype(np.int32)
    jv, ji, jl = jsi.sharded_ivf_knn_with_labels(
        jq, jb, jnp.asarray(jax_tree["ivf_labels"]), jnp.asarray(cent), jnp.asarray(lv), K, mesh=jmesh, cap=CAP,
        n_probe=N_PROBE, block_q=BLOCK_Q, kernel="xla", shard_probe=shard_probe, row_scale=js,
    )
    bank, labels, rs = si.shard_ivf_state(tb, torch.from_numpy(jax_tree["ivf_labels"]), mesh, cap=CAP, row_scale=ts)
    tv, ti, tl = si.sharded_ivf_knn_with_labels(
        tq, bank, labels, torch.from_numpy(cent), torch.from_numpy(lv), K, mesh=mesh, cap=CAP, n_probe=N_PROBE,
        block_q=BLOCK_Q, shard_probe=shard_probe, row_scale=rs,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if form == "int8_rows":  # integer dots times one f32 scale in both packages
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        b_norm = np.linalg.norm(np.asarray(tb.float() * (ts if ts is not None else 1.0)), axis=1).max()
        tol = RTOL * float(np.linalg.norm(q, axis=1).max()) * float(b_norm)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
