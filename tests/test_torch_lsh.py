"""The port's LSH index (vector_db_torch/index/lsh.py) against the
reference's, on the same numpy inputs.

The planes come from the same numpy stream in both packages, so they are
equal without carrying.  Codes are equal except where a projection lies
within 1e-4 |v| |plane| of a sign or bucket edge (f32 products in another
order): those entries are counted, and at most 0.1% may differ.  The
calibrated tables, radius and width are equal; with the state carried
across, ids >= 99% equal and the backfill counters equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import LshConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import lsh as ref_lsh  # noqa: E402
from vector_db_torch.api.config import LshConfig  # noqa: E402
from vector_db_torch.index import lsh  # noqa: E402

D, N, CAP, Q, K = 32, 3000, 3072, 24, 10


def _data(seed, n):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, D)) * (np.arange(D) + 1.0) ** -0.5
            ).astype(np.float32)


def _built(cfg, rows=None):
    """A reference index and a port index built independently from the
    same rows."""
    rows = _data(0, N) if rows is None else rows
    ref = ref_lsh.LshIndex(D, CAP, "l2", RefConfig(**cfg))
    port = lsh.LshIndex(D, CAP, "l2", LshConfig(**cfg), device="cpu")
    for ix in (ref, port):
        ix.add_batch(range(rows.shape[0]), rows)
        ix.build()
    return ref, port


def _near_edge(rows, planes, width):
    """[T, N] True where some projection of the row lies within
    1e-4 |v| |plane| of a sign edge (width 0) or of a bucket edge."""
    proj = np.einsum("nd,thd->tnh", rows.astype(np.float64),
                     planes.astype(np.float64))
    tol = 1e-4 * (np.linalg.norm(rows, axis=1)[None, :, None]
                  * np.linalg.norm(planes, axis=2)[:, None, :])
    if width > 0:
        x = proj / width
        gap = np.abs(x - np.round(x)) * width
    else:
        gap = np.abs(proj)
    return np.any(gap < tol, axis=2)


def _codes_agree(got, want, near):
    diff = got != want
    assert not (diff & ~near).any(), "codes differ away from an edge"
    assert diff.mean() <= 1e-3


def test_popcount_matches_numpy():
    r = np.random.default_rng(0)
    x = r.integers(0, 2**31, 100_000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, 1, 2**31 - 1, 2**30]
    got = lsh.popcount32(torch.from_numpy(x.copy()))
    np.testing.assert_array_equal(got.numpy(),
                                  np.bitwise_count(x.view(np.uint32)))


def test_bucket_hash_wraps_like_int32():
    """Projections of hundreds of widths: 31^16 overflows int32 many times
    over; the port's int64-and-wrap hash equals the reference's int32
    arithmetic and a Python-integer model of it."""
    r = np.random.default_rng(1)
    rows = r.standard_normal((64, D)).astype(np.float32) * 50
    planes = r.standard_normal((3, 16, D)).astype(np.float32)
    got = lsh.bucket_ids(torch.from_numpy(rows), torch.from_numpy(planes), 0.5)
    want = np.asarray(ref_lsh._bucket_ids(jnp.asarray(rows),
                                          jnp.asarray(planes), 0.5))
    q = np.floor(np.einsum("nd,thd->tnh", rows, planes) / 0.5).astype(np.int64)
    model = np.empty(want.shape, np.int64)
    for t in range(3):
        for n in range(64):
            h = 1
            for x in q[t, n]:
                h = (h * 31 + int(x) + 2**31) % 2**32 - 2**31
            model[t, n] = h
    near = _near_edge(rows, planes, 0.5)
    assert np.abs(q).max() > 1000 and (model < 0).any()
    _codes_agree(got.numpy(), model, near)
    _codes_agree(got.numpy(), want, near)


@pytest.fixture(scope="module")
def sign_pair():
    ref, port = _built({})
    queries = _data(7, Q)
    want = ref.search_batch(queries, K)  # calibrates (tables, radius)
    return ref, port, want


def test_planes_equal_without_carrying():
    a = ref_lsh.LshIndex(D, CAP, "l2", RefConfig())
    b = lsh.LshIndex(D, CAP, "l2", LshConfig(), device="cpu")
    np.testing.assert_array_equal(b.planes.numpy(), np.asarray(a.planes))
    a.build()
    b.build()
    np.testing.assert_array_equal(b.planes.numpy(), np.asarray(a.planes))


def test_sign_codes_agree_off_the_edges(sign_pair):
    ref, port, _ = sign_pair
    rows = np.array(ref.store.state.vectors)[:N]
    planes = np.array(ref.planes)
    got = lsh.sign_codes(torch.from_numpy(rows), torch.from_numpy(planes))
    want = np.asarray(ref_lsh._sign_codes(jnp.asarray(rows),
                                          jnp.asarray(planes)))
    _codes_agree(got.numpy(), want, _near_edge(rows, planes, 0.0))


def test_calibration_equals_the_references(sign_pair):
    ref, port, _ = sign_pair
    port.search_batch(_data(7, Q), K)
    assert port._tables == ref._tables < 32
    assert port._radius == ref._radius
    np.testing.assert_array_equal(port.planes.numpy(), np.asarray(ref.planes))


def test_search_matches_reference(sign_pair):
    ref, _, (want_i, want_d) = sign_pair
    port = lsh.LshIndex(D, CAP, "l2", LshConfig(), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    got_i, got_d = port.search_batch(_data(7, Q), K)
    assert np.mean(got_i == want_i) >= 0.99
    same = got_i == want_i
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-5,
                               atol=1e-4)


def test_backfill_counters_equal():
    """A fixed radius of 1 over 8 tables leaves rows short; both count the
    same short rows and backfill them alike."""
    cfg = dict(num_tables=8, num_bits=16, hamming_radius=1)
    ref, port = _built(cfg)
    port.load_state_arrays(ref.state_arrays())
    queries = _data(7, Q)
    want_i, _ = ref.search_batch(queries, K)
    got_i, _ = port.search_batch(queries, K)
    assert ref.stats()["backfill_rows"] > 0
    for key in ("backfill_rows", "backfill_queries"):
        assert port.stats()[key] == ref.stats()[key]
    assert np.mean(got_i == want_i) >= 0.99


def test_exact_bucket_mode():
    """bucket_width > 0: the reference's quantized-projection hash; the
    width is the configured one, the codes agree off the edges, and the
    search matches with the state carried across."""
    cfg = dict(num_tables=6, num_bits=4, bucket_width=2.0)
    ref, port = _built(cfg)
    assert port._width == ref._width == 2.0 and not port._sign_mode
    rows = np.asarray(ref.store.state.vectors)[:N]
    _codes_agree(port.bucket_ids.numpy()[:, :N],
                 np.asarray(ref.bucket_ids)[:, :N],
                 _near_edge(rows, np.asarray(ref.planes), 2.0))
    port.load_state_arrays(ref.state_arrays())
    queries = _data(7, Q)
    want_i, _ = ref.search_batch(queries, K)
    got_i, _ = port.search_batch(queries, K)
    assert np.mean(got_i == want_i) >= 0.99


def test_auto_width_equals_the_references():
    """hamming_radius=0 without a width: the build calibrates the width on
    the corpus (10x the median nearest-neighbor distance of a sample)."""
    ref, port = _built(dict(num_tables=4, num_bits=4, hamming_radius=0))
    assert port._width is not None and not port._sign_mode
    np.testing.assert_allclose(port._width, ref._width, rtol=1e-6)


def test_checkpoints_cross_both_ways(sign_pair):
    ref, port, _ = sign_pair
    queries = _data(7, Q)
    want_i, _ = port.search_batch(queries, K)
    back = ref_lsh.LshIndex(D, CAP, "l2", RefConfig())
    back.load_state_arrays(port.state_arrays())
    got_i, _ = back.search_batch(queries, K)
    assert np.mean(got_i == want_i) >= 0.99
    assert set(port.stats()) == set(ref.stats())
