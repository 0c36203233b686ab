"""The port's flat PQ index (vector_db_torch/index/pq.py) against the
reference's, on the same numpy inputs, with the codebooks and the
dimension permutation carried across by ``state_arrays`` ->
``load_state_arrays``.

The reference reaches its decode kernel in interpret mode.  Bars: the codes
of newly added rows bit-equal; pure-ADC slots >= 99% shared with distances
within 2e-2 relative (the bf16 reconstruction); with ``refine_k`` the
shared ids' distances to rtol 1e-5 (the exact refine, f32 sums in another
order); the untrained fallback exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_tpu.api.config import PqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index.pq import PqIndex as RefPq  # noqa: E402
from vector_db_torch.api.config import PqConfig  # noqa: E402
from vector_db_torch.index.pq import PqIndex, refine_exact  # noqa: E402
from vector_db_torch.ops import kernels as kn  # noqa: E402

D, N, CAP, S, Q, K = 32, 2000, 2304, 8, 24, 10


def _data(seed, n):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, D)) * (np.arange(D) + 1.0) ** -0.5
            ).astype(np.float32)


def _pair(metric="l2", refine_k=0, build=True):
    """A trained reference index and a port index loaded from its state."""
    cfg = dict(num_subspaces=S, training_iterations=4, refine_k=refine_k)
    ref = RefPq(D, CAP, metric, RefConfig(**cfg))
    ref.add_batch(range(N), _data(0, N))
    for vid in range(0, N, 13):
        ref.remove(vid)
    if build:
        ref.build()
    port = PqIndex(D, CAP, metric, PqConfig(**cfg), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    return ref, port


@pytest.fixture(scope="module")
def l2_pair():
    return _pair()


def _shared(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x)
                          for x, y in zip(a, b)]))


def _shared_dists(ids_a, d_a, ids_b, d_b):
    """Distances of the ids both results hold, as two aligned arrays."""
    xa, xb = [], []
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        pos = {int(v): j for j, v in enumerate(ib)}
        for j, v in enumerate(ia):
            if int(v) in pos:
                xa.append(da[j])
                xb.append(db[pos[int(v)]])
    return np.asarray(xa), np.asarray(xb)


def test_new_rows_encode_bit_equal(l2_pair):
    ref, port = l2_pair
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    rows = _data(5, 300)
    ids = list(range(10_000, 10_300))
    assert port.add_batch(ids, rows) == ref.add_batch(ids, rows)
    # the loaded store draws free slots in another order than the live one
    np.testing.assert_array_equal(
        port.codes.numpy()[[port.store.slot_of(i) for i in ids]],
        np.asarray(ref.codes)[[ref.store.slot_of(i) for i in ids]])
    # the decode tables follow the encode (version-keyed, not identity)
    before = port._codes_version
    port.add_batch([20_000], rows[:1] * 3.0)
    assert port._codes_version == before + 1
    ids_got, _ = port.search_batch(rows[:1] * 3.0, 1)
    assert ids_got[0, 0] == 20_000
    port.remove(20_000)
    for i in ids:
        port.remove(i)
        ref.remove(i)


def test_pure_adc_matches_reference(l2_pair):
    ref, port = l2_pair
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    assert _shared(got_i, want_i) >= 0.99
    a, b = _shared_dists(got_i, got_d, want_i, want_d)
    assert np.max(np.abs(a - b) / np.maximum(b, 1e-6)) < 2e-2


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_table_scans_agree_with_the_decode_path(l2_pair, impl):
    _, port = l2_pair
    queries = _data(7, Q)
    want_i, want_d = port.search_batch(queries, K)
    port.adc_impl = impl
    try:
        got_i, got_d = port.search_batch(queries, K)
    finally:
        port.adc_impl = "decode"
    assert _shared(got_i, want_i) >= 0.99
    a, b = _shared_dists(got_i, got_d, want_i, want_d)
    assert np.max(np.abs(a - b) / np.maximum(b, 1e-6)) < 2e-2


def test_refine_matches_reference():
    ref, port = _pair(refine_k=64)
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    assert _shared(got_i, want_i) >= 0.99
    a, b = _shared_dists(got_i, got_d, want_i, want_d)
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_cosine_gets_the_forced_refine():
    """refine_k=0 under cosine still answers exact cosine distances of the
    reference's ids (the forced refine of max(4k, 64) candidates)."""
    ref, port = _pair(metric="cosine")
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    assert _shared(got_i, want_i) >= 0.99
    a, b = _shared_dists(got_i, got_d, want_i, want_d)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    rows = np.stack([port.get(int(i)) for i in got_i[0]])
    q = queries[0]
    exact = 1 - rows @ q / (np.linalg.norm(rows, axis=1) * np.linalg.norm(q))
    np.testing.assert_allclose(got_d[0], exact, rtol=1e-5, atol=1e-6)


def test_untrained_fallback_matches_exactly():
    ref, port = _pair(build=False)
    assert not port.trained
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)


def test_refine_blocks_equal_one_block(monkeypatch):
    """The column-blocked refine gives the one-block answer (the same ids;
    the distances to f32 rounding: a product's summation order may follow
    the block shape)."""
    r = np.random.default_rng(3)
    base = torch.from_numpy(r.standard_normal((500, D)).astype(np.float32))
    q = torch.from_numpy(r.standard_normal((16, D)).astype(np.float32))
    cand = torch.from_numpy(r.integers(-1, 500, (16, 96)).astype(np.int32))
    for metric in ("l2", "cosine"):
        one = refine_exact(q, base, cand, 8, metric)
        from vector_db_torch.ops import distance

        monkeypatch.setattr(distance, "RERANK_BLOCK_BYTES", 16 * D * 4 * 7)
        blocked = refine_exact(q, base, cand, 8, metric)
        monkeypatch.undo()
        assert torch.equal(one[1], blocked[1])
        np.testing.assert_allclose(one[0].numpy(), blocked[0].numpy(),
                                   rtol=1e-6)


def test_checkpoints_cross_both_ways(l2_pair):
    ref, port = l2_pair
    queries = _data(7, Q)
    want = port.search_batch(queries, K)
    back = RefPq(D, CAP, "l2", RefConfig(num_subspaces=S))
    back.load_state_arrays(port.state_arrays())
    got = back.search_batch(queries, K)
    assert _shared(got[0], want[0]) >= 0.99
    assert set(port.stats()) == set(ref.stats())
    assert port.stats()["code_bytes"] == ref.stats()["code_bytes"]


def test_cpu_search_runs_no_kernel(l2_pair):
    _, port = l2_pair
    before = kn.pq_decode_recon_t.launches
    port.search_batch(_data(7, 4), K)
    assert kn.pq_decode_recon_t.launches == before  # plain version on CPU


def test_device_is_required():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        PqIndex(D, CAP)
