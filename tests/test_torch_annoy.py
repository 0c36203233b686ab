"""The port's Annoy index (vector_db_torch/index/annoy.py) against the
reference's, on the same numpy inputs.

The forest is built by the same host numpy builder from the same f32 rows,
so the tree arrays are bit-equal.  The descent scores margins in f32 in
another order, so only equal margins can order differently: reached leaves
>= 99% equal (as sets per query and tree), recall within 0.01 of the
reference's.  The chunked descent equals the unchunked one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import AnnoyConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import annoy as ref_annoy  # noqa: E402
from vector_db_torch.api.config import AnnoyConfig  # noqa: E402
from vector_db_torch.index import annoy  # noqa: E402

D, N, CAP, Q, K = 16, 3000, 4096, 24, 10
TREE_KEYS = ("hyperplanes", "thresholds", "children", "leaf_items",
             "node_leaf")


def _data(seed, n):
    r = np.random.default_rng(seed)
    return r.standard_normal((n, D)).astype(np.float32)


def _built(cfg):
    rows = _data(0, N)
    ref = ref_annoy.AnnoyIndex(D, CAP, "l2", RefConfig(**cfg))
    port = annoy.AnnoyIndex(D, CAP, "l2", AnnoyConfig(**cfg), device="cpu")
    for ix in (ref, port):
        ix.add_batch(range(N), rows)
        ix.build()
        for vid in range(0, N, 17):
            ix.remove(vid)
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _built(dict(num_trees=6, leaf_size=8, search_k=64,
                       backfill=False))


def _recall(ids, base, queries, valid):
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    d[:, ~valid] = np.inf
    gt = np.argsort(d, axis=1)[:, :K]
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)]))


def test_trees_bit_equal(pair):
    ref, port = pair
    assert port._max_depth == ref._max_depth
    for key in TREE_KEYS:
        np.testing.assert_array_equal(getattr(port, key).numpy(),
                                      np.asarray(getattr(ref, key)), key)


def test_reached_leaves_match(pair):
    ref, port = pair
    queries = _data(7, 32)
    want = np.asarray(ref_annoy._descend(
        jnp.asarray(queries), ref.hyperplanes, ref.thresholds, ref.children,
        jnp.zeros((6,), jnp.int32), ref._max_depth, 64))
    got = annoy.descend(torch.from_numpy(queries), port.hyperplanes,
                        port.thresholds, port.children, port._max_depth,
                        64).numpy()
    same = [len(set(g) & set(w)) / len(set(w))
            for g, w in zip(got.reshape(-1, 64), want.reshape(-1, 64))]
    assert np.mean(same) >= 0.99


@pytest.mark.parametrize("cfg", [
    dict(num_trees=6, leaf_size=8, search_k=64, backfill=False),
    # 12 trees x beam 128 x 32 items: past 8,192 candidates, the blocks of
    # blocked_rerank
    dict(backfill=False),
])
def test_search_recall_within_reference(cfg, pair):
    ref, port = pair if cfg.get("search_k") == 64 else _built(cfg)
    queries = _data(7, Q)
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(queries, K)
    base = np.asarray(ref.store.state.vectors)
    valid = np.asarray(ref.store.state.valid)
    slot_ids = np.asarray(ref.store.state.ids)
    to_slot = {int(i): s for s, i in enumerate(slot_ids) if i >= 0}
    rec_ref = _recall([[to_slot[i] for i in r if i >= 0] for r in want_i],
                      base, queries, valid)
    rec_port = _recall([[to_slot[i] for i in r if i >= 0] for r in got_i],
                       base, queries, valid)
    assert rec_port >= rec_ref - 0.01
    same = got_i == want_i
    assert same.mean() >= 0.95
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-5,
                               atol=1e-4)
    for key in ("backfill_rows", "backfill_queries"):
        assert port.stats()[key] == ref.stats()[key]


def test_chunked_descent_equals_unchunked(pair):
    _, port = pair
    q = torch.from_numpy(_data(9, 40))
    args = (port.hyperplanes, port.thresholds, port.children,
            port._max_depth, 64)
    whole = annoy.descend(q, *args)
    per_row = 4 * 6 * 64 * D
    assert annoy.descend_rows(6, 64, D, per_row * 7) == 7
    chunked = annoy.descend(q, *args, budget=per_row * 7)
    assert torch.equal(whole, chunked)


def test_pending_rows_are_searchable_and_rebuild_at_1000(pair):
    _, port = pair
    extra = _data(11, 1000) + 10.0
    port.add_batch(range(50_000, 50_999), extra[:999])
    assert port.stats()["pending"] == 999
    ids, _ = port.search_batch(extra[:5], 1)
    assert list(ids[:, 0]) == list(range(50_000, 50_005))
    port.add_batch([50_999], extra[999:])
    assert port.stats()["pending"] == 0 and port._built
    ids, _ = port.search_batch(extra[995:], 1)
    assert list(ids[:, 0]) == list(range(50_995, 51_000))


def test_checkpoints_cross_both_ways():
    ref, port = _built(dict(num_trees=4, leaf_size=8, search_k=32))
    port.add_batch([90_000], _data(12, 1))  # a pending row rides along
    queries = _data(7, Q)
    want_i, _ = port.search_batch(queries, K)
    back = ref_annoy.AnnoyIndex(D, CAP, "l2", RefConfig(num_trees=4,
                                                        leaf_size=8,
                                                        search_k=32))
    back.load_state_arrays(port.state_arrays())
    got_i, _ = back.search_batch(queries, K)
    assert np.mean(got_i == want_i) >= 0.99
    again = annoy.AnnoyIndex(D, CAP, "l2", AnnoyConfig(num_trees=4,
                                                       leaf_size=8,
                                                       search_k=32),
                             device="cpu")
    again.load_state_arrays(ref.state_arrays())
    assert set(again.stats()) == set(ref.stats())
    assert again.stats()["max_depth"] == ref.stats()["max_depth"]
