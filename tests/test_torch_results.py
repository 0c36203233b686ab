"""The facade's result shaping (``vector_db_torch/core/types.py``
``make_results_batch``), on the CPU.

One call shapes a whole [Q, k] answer: from ``BULK_FROM`` answers the
root, the similarity and its 4-digit rounding in bulk, Python's ``round``
only near a half; below, answer by answer (``SHAPES`` holds both).  Each case
holds it to the reference's ``make_results`` applied row by row to the same
arrays, field for field and ``repr`` for ``repr``: dropped ids and
non-finite distances, clamped negative squared distances, rows padded past
the index's ``k_eff``, rows with no answer left, and similarities built to
lie within 1e-9 of a rounding half.  The built objects stay frozen,
hashable, ordered and picklable like constructed ones, and the facade's
``search`` / ``search_batch`` return the oracle's lists on an index's own
arrays and count what they shaped (``results.answers``,
``results.round_fallback``).
"""

import dataclasses
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from vector_db_tpu.core.types import make_results as ref_make_results  # noqa: E402
from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.core.types import (BULK_FROM, SearchResult,  # noqa: E402
                                        make_results, make_results_batch)
from vector_db_torch.utils.stats import GLOBAL  # noqa: E402

METRICS = ["l2", "cosine"]
SHAPES = [(1, 1), (1, 10), (7, 1), (7, 10), (1024, 1), (1024, 10)]
KINDS = ["plain", "specials", "padded", "empty_rows", "near_half"]


def oracle(ids, sq, metric):
    """The reference's ``make_results`` row by row, as the port's type."""
    return [[SearchResult(**dataclasses.asdict(r))
             for r in ref_make_results(ids[q].tolist(), sq[q].tolist(),
                                       metric)]
            for q in range(ids.shape[0])]


def assert_same(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert all(type(r) is SearchResult for r in g_row)
        assert g_row == w_row
        assert [repr(r) for r in g_row] == [repr(r) for r in w_row]


def counts():
    c = GLOBAL.snapshot()["counts"]
    return (c.get("results.answers", 0), c.get("results.round_fallback", 0))


def near_half_sims(n, rng):
    """Similarities whose ``sim * 1e4`` lies within 1e-9 of a half, most
    of them within the float64 product's own rounding of it."""
    half = rng.integers(1, 10_000, n) + 0.5
    off = rng.choice([0.0, 1e-13, -1e-13, 1e-11, -1e-11, 1e-9, -1e-9], n)
    return (half + off) / 1e4


def sq_for_sims(sims, metric):
    """Squared distances (float64) whose similarity is ``sims``."""
    dist = 2.0 * (1.0 / sims - 1.0)
    return dist * dist if metric == "l2" else dist


def case(kind, metric, q, k, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1 << 20, (q, k)).astype(np.int32)
    sq = (rng.random((q, k)) * (4.0 if metric == "l2" else 2.0)
          ).astype(np.float32)
    if kind == "specials":
        pick = rng.integers(0, 7, (q, k))
        ids[pick == 0] = -1
        sq[pick == 1] = np.inf
        sq[pick == 2] = -np.inf
        sq[pick == 3] = np.nan
        sq[pick == 4] = -rng.random(int((pick == 4).sum())).astype(np.float32)
        sq[pick == 5] = 0.0
        sq[pick == 6] = -0.0
    elif kind == "padded":
        # index/base.to_host_results past k_eff: -1 ids, +inf distances
        k_eff = rng.integers(0, k + 1, q)
        pad = np.arange(k)[None, :] >= k_eff[:, None]
        ids[pad] = -1
        sq[pad] = np.inf
    elif kind == "empty_rows":
        ids[::2] = -1
        sq[1::3] = np.nan
    elif kind == "near_half":
        sq = sq_for_sims(near_half_sims(q * k, rng), metric).reshape(q, k)
    return ids, sq


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q,k", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_batch_equals_reference(metric, q, k, kind):
    ids, sq = case(kind, metric, q, k)
    before = counts()
    got = make_results_batch(ids, sq, metric)
    after = counts()
    want = oracle(ids, sq, metric)
    assert_same(got, want)
    assert after[0] - before[0] == sum(len(row) for row in want)
    if kind == "near_half":
        assert after[1] - before[1] == q * k
    if kind == "empty_rows":
        assert got[0] == []


@pytest.mark.parametrize("metric", METRICS)
def test_near_half_needs_round(metric):
    """The near-half entries are where ``np.round`` is wrong: the
    fallback, not luck, gives the reference's rounding."""
    rng = np.random.default_rng(1)
    ids = np.arange(40_000, dtype=np.int32).reshape(-1, 10)
    sq = sq_for_sims(near_half_sims(ids.size, rng), metric).reshape(ids.shape)
    got = make_results_batch(ids, sq, metric)
    want = oracle(ids, sq, metric)
    assert_same(got, want)
    dist = np.sqrt(sq) if metric == "l2" else sq
    plain = np.round(1.0 / (1.0 + 0.5 * dist), 4)
    ref_sims = np.array([[r.similarity for r in row] for row in want])
    assert (plain != ref_sims).any()


@pytest.mark.parametrize("metric", METRICS)
def test_float32_near_half(metric):
    """float32 squared distances next to each of 2,000 rounding halves:
    those whose similarity lies within the fallback's band of the half
    take ``round``, the rest the bulk rounding, all as the reference."""
    sims = (np.arange(4_000, 8_000, 2) + 0.5) / 1e4
    near = sq_for_sims(sims, metric).astype(np.float32).view(np.int32)
    sq = (near[:, None] + np.arange(-8, 8, dtype=np.int32)).view(np.float32)
    ids = np.zeros(sq.shape, np.int32)
    before = counts()
    got = make_results_batch(ids, sq, metric)
    assert counts()[1] > before[1]
    assert_same(got, oracle(ids, sq, metric))


def test_sequence_api_is_a_row_of_the_batch():
    ids, sq = case("specials", "l2", 7, 10)
    for q in range(7):
        assert_same([make_results(ids[q].tolist(), sq[q].tolist())],
                    [make_results_batch(ids, sq)[q]])
    assert make_results([], []) == []


def built_and_constructed():
    ids, sq = case("plain", "l2", 4, 10)
    built = [r for row in make_results_batch(ids, sq) for r in row]
    made = [SearchResult(r.id, r.distance) for r in built]
    return built, made


def test_built_objects_behave_like_constructed_ones():
    built, made = built_and_constructed()
    assert built == made
    assert [vars(r) for r in built] == [vars(r) for r in made]
    assert [hash(r) for r in built] == [hash(r) for r in made]
    assert [r.id for r in sorted(built)] == [r.id for r in sorted(made)]
    pairs = list(zip(built, built[1:]))
    assert [a < b for a, b in pairs] == [a.distance < b.distance
                                         for a, b in pairs]
    assert set(built) == set(made)
    with pytest.raises(dataclasses.FrozenInstanceError):
        built[0].distance = 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        built[0].similarity = 1.0
    back = pickle.loads(pickle.dumps(built))
    assert back == built and all(type(r) is SearchResult for r in back)


def test_constructor_unchanged():
    r = SearchResult(1, 2.0)
    assert (r.id, r.distance, r.similarity) == (1, 2.0, 0.5)
    assert repr(r) == "SearchResult(id=1, distance=2.0, similarity=0.5)"
    assert SearchResult(1, 2.0, 0.25).similarity == 0.25
    assert [f.name for f in dataclasses.fields(SearchResult)] == [
        "id", "distance", "similarity"]


# ------------------------------------------------------------------ facade
DIM, N = 16, 600


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def facade_db(kind, metric, n):
    b = (VectorDatabase.builder().with_dimension(DIM).with_max_elements(1024)
         .with_index_type(kind).with_metric(metric).with_device("cpu"))
    if kind is IndexType.HNSWPQ:
        b = b.with_index_config(HnswPqConfig(num_subspaces=4,
                                             training_samples=n))
    db = b.build()
    rows = np.random.default_rng(3).standard_normal((n, DIM)).astype(
        np.float32)
    db.add_batch(range(n), rows)
    db.rebuild_index()
    return db


def expected_fallback(ids, want):
    """Similarities Python's ``round`` takes: every one below
    ``BULK_FROM`` answers a call, else those whose ``sim * 1e4`` lies
    within 1e-6 of a half."""
    if ids.size < BULK_FROM:
        return sum(len(row) for row in want)
    n = 0
    for row in want:
        for r in row:
            y = 1.0 / (1.0 + 0.5 * r.distance) * 1e4
            n += abs(y - math.floor(y) - 0.5) <= 1e-6
    return n


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [N, 6])
@pytest.mark.parametrize("kind", [IndexType.BRUTE, IndexType.HNSWPQ])
def test_facade_shapes_the_index_arrays(kind, n, metric):
    db = facade_db(kind, metric, n)
    queries = np.random.default_rng(4).standard_normal((7, DIM)).astype(
        np.float32)
    k = 10
    ids, sq = db.index.search_batch(queries, k)
    want = oracle(ids, sq, metric)
    if n < k:
        assert (ids[:, n:] == -1).all()
    before = counts()
    got = db.search_batch(queries, k)
    after = counts()
    assert_same(got, want)
    answers = sum(len(row) for row in want)
    assert after[0] - before[0] == answers
    assert after[1] - before[1] == expected_fallback(ids, want)
    assert db.metrics()["counts"]["results.answers"] == after[0]

    for q in range(3):
        one_ids, one_sq = db.index.search(queries[q], k)
        want_one = oracle(one_ids[None], one_sq[None], metric)
        before = counts()
        got_one = db.search(queries[q], k)
        after = counts()
        assert_same([got_one], want_one)
        assert after[0] - before[0] == len(want_one[0])
        assert after[1] - before[1] == expected_fallback(one_ids, want_one)
    db.close()
