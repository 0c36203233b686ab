"""The port's distance scans (vector_db_torch/ops/distance.py) against the
reference's on the same seeded, tie-free inputs.

Tolerance: ids equal; distances within rtol 1e-5 (the f32 sums run in
another order).  That bound holds for f32 sums only, so every test here
runs both packages' matmuls at full f32 precision (JAX's
``default_matmul_precision("highest")``, torch's "highest"): on a CPU with
bf16 matrix units (AMX) a library left at its default precision may take
a reduced-precision dot, whose error on these 32-dim rows (between 4e-6
for three bf16 passes and 6e-4 for TF32) exceeds the bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.ops import distance as ref  # noqa: E402
from vector_db_torch.ops import distance as td  # noqa: E402


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _data(seed, n=2000, d=32, q=16):
    r = np.random.default_rng(seed)
    base = r.standard_normal((n, d)).astype(np.float32)
    qs = r.standard_normal((q, d)).astype(np.float32)
    valid = r.uniform(size=n) > 0.1
    return qs, base, valid


def _check(t_out, j_out):
    td_, ti = (x.numpy() for x in t_out)
    jd, ji = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td_, jd, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pairwise_dist_matches_reference(metric):
    qs, base, _ = _data(1)
    got = td.pairwise_dist(torch.from_numpy(qs), torch.from_numpy(base), metric)
    want = ref.pairwise_dist(jnp.asarray(qs), jnp.asarray(base), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_blocked_knn_matches_reference(metric):
    qs, base, valid = _data(2)
    args_t = (torch.from_numpy(qs), torch.from_numpy(base),
              torch.from_numpy(valid), 10)
    args_j = (jnp.asarray(qs), jnp.asarray(base), jnp.asarray(valid), 10)
    _check(td.blocked_knn(*args_t, metric=metric, block_n=300),
           ref.blocked_knn(*args_j, metric=metric, block_n=300))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("full_row", [True, False])
def test_blocked_knn_fast_matches_reference(metric, full_row, monkeypatch):
    qs, base, valid = _data(3)
    if not full_row:
        monkeypatch.setattr(td, "FULL_ROW_BYTES", 0)
    got = td.blocked_knn_fast(torch.from_numpy(qs), torch.from_numpy(base),
                              torch.from_numpy(valid), 16, metric=metric,
                              block_n=512)
    # the reference's exact variant (recall_target=1.0); on the CPU its
    # approx_max_k full-row path is exact as well
    for target in (1.0, 0.99):
        want = ref.blocked_knn_fast(jnp.asarray(qs), jnp.asarray(base),
                                    jnp.asarray(valid), 16, metric=metric,
                                    block_n=512, recall_target=target)
        _check(got, want)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_blocked_rerank_matches_reference(metric):
    qs, base, _ = _data(4)
    r = np.random.default_rng(4)
    cand = np.stack([r.choice(base.shape[0], 300, replace=False)
                     for _ in range(qs.shape[0])]).astype(np.int32)
    cand[:, ::9] = -1
    got = td.blocked_rerank(torch.from_numpy(qs), torch.from_numpy(base),
                            torch.from_numpy(cand), 10, metric, rb=128)
    want = ref.blocked_rerank(jnp.asarray(qs), jnp.asarray(base),
                              jnp.asarray(cand), 10, metric, rb=128)
    _check(got, want)


def test_blocked_knn_pads_with_empty_entries():
    """k beyond the live rows: +inf / -1 padding, like the reference."""
    qs, base, _ = _data(5, n=20)
    valid = np.zeros(20, bool)
    valid[:3] = True
    d, i = td.blocked_knn(torch.from_numpy(qs), torch.from_numpy(base),
                          torch.from_numpy(valid), 8, block_n=8)
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    assert set(i[:, :3].flatten().tolist()) <= {0, 1, 2}
