"""The port's k-means and PQ encode (vector_db_torch/ops/kmeans.py,
ops/adc.py) against the reference's.

Lloyd steps and encodes given the same inputs agree exactly (assignments,
codes) and to rtol 1e-5 (centroids: f32 sums in another order).  Seeded
fits use different random generators, so they are compared by quantization
error: within 5% of the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.ops import adc as ref_adc  # noqa: E402
from vector_db_tpu.ops import kmeans as ref_km  # noqa: E402
from vector_db_torch.ops import adc as t_adc  # noqa: E402
from vector_db_torch.ops import kmeans as t_km  # noqa: E402


def _blobs(seed, n=1200, d=8, centers=12):
    r = np.random.default_rng(seed)
    c = r.standard_normal((centers, d)) * 4
    x = c[r.integers(0, centers, n)] + r.standard_normal((n, d))
    return x.astype(np.float32)


def test_lloyd_iteration_matches_reference():
    data = _blobs(0)
    init = data[:16].copy()
    row_valid = np.ones(data.shape[0], bool)
    row_valid[-100:] = False
    norms = (data * data).sum(1)
    jc, ja = ref_km.lloyd_iteration(jnp.asarray(data), jnp.asarray(init),
                                    jnp.asarray(norms), jnp.asarray(row_valid))
    tc, ta = t_km.lloyd_iteration(torch.from_numpy(data)[None],
                                  torch.from_numpy(init)[None],
                                  torch.from_numpy(norms)[None],
                                  torch.from_numpy(row_valid))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc), rtol=1e-5)


def test_pq_encode_matches_reference():
    r = np.random.default_rng(1)
    data = r.standard_normal((700, 32)).astype(np.float32)
    books = r.standard_normal((4, 64, 8)).astype(np.float32)
    want = np.asarray(ref_adc.pq_encode(jnp.asarray(data), jnp.asarray(books)))
    got = t_adc.pq_encode(torch.from_numpy(data), torch.from_numpy(books))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pq_encode_chunks_by_bytes(monkeypatch):
    """The encode's chunk follows a byte budget, not a row count, and the
    chunking never changes a code."""
    r = np.random.default_rng(2)
    data = torch.from_numpy(r.standard_normal((1000, 16)).astype(np.float32))
    books = torch.from_numpy(r.standard_normal((4, 32, 4)).astype(np.float32))
    whole = t_adc.pq_encode(data, books)
    # 4 * S * K = 512 bytes per row of distances: 4096 bytes -> 8-row chunks
    monkeypatch.setattr(t_adc, "ENCODE_CHUNK_BYTES", 4096)
    chunked = t_adc.pq_encode(data, books)
    assert torch.equal(whole, chunked)


def _quant_mse(data, books):
    s, _, sd = books.shape
    codes = np.asarray(ref_adc.pq_encode(jnp.asarray(data), jnp.asarray(books)))
    recon = np.concatenate([books[i][codes[:, i]] for i in range(s)], axis=1)
    return float(((data - recon) ** 2).sum(1).mean())


def test_subspace_kmeans_fit_quality_matches_reference():
    data = np.concatenate([_blobs(3, 2000, 8), _blobs(4, 2000, 8),
                           _blobs(5, 2000, 8), _blobs(6, 2000, 8)], axis=1)
    ref_books = np.asarray(ref_km.subspace_kmeans_fit(
        jax.random.PRNGKey(42), jnp.asarray(data), 4, k=32, iters=10))
    gen = torch.Generator().manual_seed(42)
    books = t_km.subspace_kmeans_fit(gen, torch.from_numpy(data), 4, k=32,
                                     iters=10)
    assert tuple(books.shape) == ref_books.shape == (4, 32, 8)
    mse, ref_mse = _quant_mse(data, books.numpy()), _quant_mse(data, ref_books)
    assert mse <= 1.05 * ref_mse, (mse, ref_mse)


def test_kmeans_plus_plus_draws_distinct_rows_and_skips_padding():
    data = torch.from_numpy(_blobs(7, 300, 4))[None]
    gen = torch.Generator().manual_seed(0)
    cents = t_km.kmeans_plus_plus_init(gen, data, 16, n_valid=250)
    rows = {tuple(r) for r in data[0, :250].tolist()}
    picked = [tuple(c) for c in cents[0].tolist()]
    assert len(set(picked)) == 16 and set(picked) <= rows


def test_balanced_subspace_perm_matches_reference():
    v = np.random.default_rng(8).uniform(size=64) ** 3
    np.testing.assert_array_equal(t_adc.balanced_subspace_perm(v, 8),
                                  ref_adc.balanced_subspace_perm(v, 8))
