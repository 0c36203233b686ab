"""The port's IVF index (vector_db_torch/index/ivf.py) against the
reference's, on the same numpy inputs, with the centroids carried across by
``state_arrays`` -> ``load_state_arrays``.

Bars: the assignments, the member table and the fill pool equal; search ids
equal on >= 99.9% of entries and distances to rtol 1e-5, atol 1e-4 (the
same exact refine, f32 sums in another order); the removal-triggered
rebuild fires at the same count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_tpu.api.config import IvfConfig as RefConfig  # noqa: E402
from vector_db_tpu.index.ivf import IvfIndex as RefIvf  # noqa: E402
from vector_db_torch.api.config import IvfConfig  # noqa: E402
from vector_db_torch.index.ivf import IvfIndex  # noqa: E402

D, N, CAP, Q, K = 16, 3000, 3072, 24, 10
CFG = dict(num_clusters=24, num_probes=4, multi_assign=3,
           training_iterations=5)


def _data(seed, n):
    r = np.random.default_rng(seed)
    return r.standard_normal((n, D)).astype(np.float32)


def _pair(metric="l2", n=N):
    ref = RefIvf(D, CAP, metric, RefConfig(**CFG))
    ref.add_batch(range(n), _data(0, n))
    ref.build()
    for vid in range(0, n, 11):
        ref.remove(vid)
    port = IvfIndex(D, CAP, metric, IvfConfig(**CFG), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    return ref, port


@pytest.fixture(scope="module")
def l2_pair():
    return _pair()


def test_assignments_and_member_table_equal(l2_pair):
    ref, port = l2_pair
    live = np.flatnonzero(port.store.state.valid.numpy())
    port.assignments[:] = -1
    port._assign_slots(live)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    want_t, want_l, want_o = ref._member_table()
    got_t, got_l, got_o = port._member_table()
    assert got_l == want_l
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))


def test_fill_pool_equals_the_references(l2_pair):
    ref, port = l2_pair
    live = np.flatnonzero(np.asarray(ref.store.state.valid))
    want = np.random.default_rng(ref.seed + live.size).choice(
        live, 16, replace=False).astype(np.int32)
    np.testing.assert_array_equal(port.fill_slots(16), want)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_search_matches_reference(metric, l2_pair):
    ref, port = l2_pair if metric == "l2" else _pair("cosine")
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    assert np.mean(got_i == want_i) >= 0.999
    same = got_i == want_i
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-5,
                               atol=1e-4)


def test_short_probes_fill_like_the_reference():
    """Few live rows and one probe: the fill pool supplies rows the probed
    cluster lacks, the same rows as the reference's."""
    ref = RefIvf(D, CAP, "l2", RefConfig(num_clusters=8, num_probes=1,
                                         multi_assign=1,
                                         training_iterations=3))
    ref.add_batch(range(120), _data(3, 120))
    ref.build()
    port = IvfIndex(D, CAP, "l2", IvfConfig(num_clusters=8, num_probes=1,
                                            multi_assign=1,
                                            training_iterations=3),
                    device="cpu")
    port.load_state_arrays(ref.state_arrays())
    queries = _data(8, Q)
    want_i, want_d = ref.search_batch(queries, 32)
    got_i, got_d = port.search_batch(queries, 32)
    assert (want_i >= 0).all()  # every row filled
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)


def test_removals_rebuild_at_the_same_count():
    ref = RefIvf(D, CAP, "l2", RefConfig(**CFG))
    port = IvfIndex(D, CAP, "l2", IvfConfig(**CFG), device="cpu")
    rows = _data(4, 600)
    for ix in (ref, port):
        ix.add_batch(range(600), rows)
        ix.build()
    fired = {}
    for name, ix in (("ref", ref), ("port", port)):
        for vid in range(300):
            ix.remove(vid)
            if ix._removals_since_train == 0:
                fired.setdefault(name, []).append(vid)
    assert fired["port"] == fired["ref"] and fired["port"]
    assert port.trained


def test_untrained_and_small_indexes_scan_exactly():
    ref = RefIvf(D, CAP, "l2", RefConfig(**CFG))
    port = IvfIndex(D, CAP, "l2", IvfConfig(**CFG), device="cpu")
    rows = _data(5, 200)
    ref.add_batch(range(200), rows)
    port.add_batch(range(200), rows)
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)


def test_checkpoints_cross_both_ways(l2_pair):
    ref, port = l2_pair
    queries = _data(7, Q)
    want_i, _ = port.search_batch(queries, K)
    back = RefIvf(D, CAP, "l2", RefConfig(**CFG))
    back.load_state_arrays(port.state_arrays())
    got_i, _ = back.search_batch(queries, K)
    assert np.mean(got_i == want_i) >= 0.999
    assert set(port.stats()) == set(ref.stats())
    assert port.stats()["num_clusters"] == ref.stats()["num_clusters"]
