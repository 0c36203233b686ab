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
from vector_db_torch.core import types  # noqa: E402
from vector_db_torch.core.types import (BUILDER, BULK_FROM,  # noqa: E402
                                        SearchResult, build_results,
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


# ------------------------------------------------------------ the C builder
def native_count():
    return GLOBAL.snapshot()["counts"].get("results.native", 0)


def id_layout(layout, ids):
    """``ids`` as int32, int64, an int64 view every other column of a
    wider array (not contiguous), or a transposed (Fortran-ordered) int64
    array."""
    if layout == "strided":
        wide = np.full((ids.shape[0], 2 * ids.shape[1]), 7, np.int64)
        wide[:, ::2] = ids
        return wide[:, ::2]
    if layout == "transposed":
        return np.ascontiguousarray(ids.T, dtype=np.int64).T
    return ids.astype(layout)


@pytest.mark.parametrize("layout", ["int32", "int64", "strided",
                                    "transposed"])
@pytest.mark.parametrize("kind", ["plain", "specials"])
def test_bulk_ids_of_any_integer_layout(kind, layout):
    """Any integer ids; transposed, the distances are Fortran-ordered too."""
    ids, sq = case(kind, "l2", 1024, 10, seed=5)
    ids = id_layout(layout, ids)
    if layout == "transposed":
        sq = np.ascontiguousarray(sq.T).T
        assert sq.flags.f_contiguous and not sq.flags.c_contiguous
    assert ids.flags.c_contiguous == (layout in ("int32", "int64"))
    assert_same(make_results_batch(ids, sq), oracle(ids, sq, "l2"))


@pytest.mark.parametrize("q", [0, 64])
def test_no_answers(q):
    """Q = 0 and calls whose every answer is dropped: one empty list a row,
    from the builder itself as from the facade's shaping."""
    ids = np.full((q, 10), -1, np.int64)
    sq = np.zeros((q, 10), np.float32)
    before = native_count()
    assert make_results_batch(ids, sq) == [[] for _ in range(q)]
    assert native_count() == before
    zeros = np.zeros((q, 10))
    keep = np.zeros((q, 10), bool)
    assert build_results(ids, zeros, zeros, keep) == [[] for _ in range(q)]
    assert build_results(ids, zeros, zeros, None) == [
        [SearchResult(-1, 0.0, 0.0)] * 10 for _ in range(q)]


@pytest.mark.parametrize("q,k", [(1, 10), (4, 10), (1024, 10)])
def test_native_counts_the_bulk_answers(q, k):
    ids, sq = case("specials", "l2", q, k)
    before = native_count(), counts()[0]
    make_results_batch(ids, sq)
    answers = counts()[0] - before[1]
    assert native_count() - before[0] == (answers if q * k >= BULK_FROM
                                          else 0)


def test_built_objects_are_tracked_dataclass_instances():
    """Each built object: a tracked SearchResult, frozen, its fields in
    field order, no larger than a constructed one (no per-object dict)."""
    import gc
    import tracemalloc

    ids, sq = case("plain", "l2", 1024, 10, seed=6)
    built = make_results_batch(ids, sq)
    flat = [r for row in built for r in row]
    assert all(type(r) is SearchResult and gc.is_tracked(r) for r in flat)
    assert gc.is_tracked(built) and gc.is_tracked(built[0])
    made = SearchResult(flat[0].id, flat[0].distance)
    assert list(vars(flat[0]).items()) == list(vars(made).items())
    for name in ("id", "distance", "similarity"):
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(flat[1], name, 0)
        with pytest.raises(dataclasses.FrozenInstanceError):
            delattr(flat[1], name)

    values = [(r.id, r.distance, r.similarity) for r in flat]
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        again = make_results_batch(ids, sq)
        built_bytes = tracemalloc.get_traced_memory()[0] - base
        del again
        base = tracemalloc.get_traced_memory()[0]
        constructed = [[SearchResult(i + 0, d + 0.0, s + 0.0)
                        for i, d, s in values[q * 10:q * 10 + 10]]
                       for q in range(1024)]
        made_bytes = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert len(constructed) == 1024
    assert built_bytes <= made_bytes + 64 * 1024


def test_no_reference_leak():
    """A built object, row and list hold the references a constructed one
    holds, and 200 builds of [1024, 10] leave the traced memory flat."""
    import sys
    import tracemalloc

    ids, sq = case("plain", "l2", 1024, 10, seed=7)
    ids += 1000         # ids above the small-int cache
    built = make_results_batch(ids, sq)
    made = [[SearchResult(r.id + 0, r.distance + 0.0, r.similarity + 0.0)
             for r in row] for row in built]
    assert sys.getrefcount(built) == sys.getrefcount(made)
    assert sys.getrefcount(built[3]) == sys.getrefcount(made[3])
    b, m = built[3][4], made[3][4]
    assert sys.getrefcount(b) == sys.getrefcount(m)
    for name in ("id", "distance", "similarity"):
        assert (sys.getrefcount(getattr(b, name))
                == sys.getrefcount(getattr(m, name)))
    del built, made, b, m

    make_results_batch(ids, sq)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(200):
            make_results_batch(ids, sq)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 64 * 1024


def test_builder_errors_raise_and_release():
    """A failing call raises the Python error, and the objects built
    before it are released."""
    import sys

    class Failing:
        made = 0

        def __new__(cls):
            cls.made += 1
            if cls.made > 25:
                raise RuntimeError("no more objects")
            return object.__new__(cls)

    lib = BUILDER.get()
    ids = np.arange(40, dtype=np.int64).reshape(4, 10)
    vals = np.zeros((4, 10))
    args = (ids.ctypes.data, vals.ctypes.data, vals.ctypes.data, None, 4, 10)
    refs = sys.getrefcount(Failing)
    with pytest.raises(RuntimeError, match="no more objects"):
        lib.vdb_build_results(Failing, *args)
    assert Failing.made == 26
    assert sys.getrefcount(Failing) == refs
    with pytest.raises(TypeError, match="not a type"):
        lib.vdb_build_results(5, *args)
    with pytest.raises(ValueError, match="C-contiguous"):
        build_results(ids[:, ::2], vals[:, ::2], vals[:, ::2], None)
    with pytest.raises(ValueError, match="C-contiguous"):
        build_results(ids, vals.astype(np.float32), vals, None)
    with pytest.raises(TypeError, match="integers"):
        make_results_batch(ids.astype(np.float64), vals)


def test_concurrent_first_use_builds_once(monkeypatch, tmp_path):
    """Six threads making a process's first bulk call together: one build,
    one handle, and every thread's builder works."""
    import threading

    from vector_db_torch.ops import kernels as tk

    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    lib = tk._Library(BUILDER.name, BUILDER.sources, BUILDER.compiler,
                      BUILDER.load)
    ids, sq = case("specials", "l2", 64, 10, seed=8)
    arrays = types._finish_bulk(ids, sq, "l2")[0]
    want = oracle(ids, sq, "l2")
    start = threading.Barrier(6)
    got = [None] * 6

    def first_call(i):
        start.wait(timeout=60)
        handle = lib.get()
        ids64, dist, sim, keep = arrays
        got[i] = (handle, handle.vdb_build_results(
            SearchResult, ids64.ctypes.data, dist.ctypes.data,
            sim.ctypes.data, keep.ctypes.data, *ids64.shape))

    threads = [threading.Thread(target=first_call, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(g is not None and g[0] is lib.lib for g in got)
    for _, out in got:
        assert_same(out, want)
    assert len(list((tmp_path / "build").glob("*.so"))) == 1


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    """A host source that does not compile: the build raises with the
    compiler's log, and nothing is loaded."""
    from vector_db_torch.ops import kernels as tk

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "results_host.c").write_text(
        "int vdb_build_results(void) { return undeclared_name; }\n")
    monkeypatch.setattr(tk, "_CSRC", tmp_path / "csrc")
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    lib = tk._Library(BUILDER.name, BUILDER.sources, BUILDER.compiler,
                      BUILDER.load)
    with pytest.raises(RuntimeError, match="(?s)results_host.c.*"
                                           "undeclared_name"):
        lib.get()
    assert lib.lib is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_sources_raises(monkeypatch, tmp_path):
    """A package installed without its ``csrc/`` files: the build names
    what it looked for, and links nothing."""
    from vector_db_torch.ops import kernels as tk

    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(tk, "_CSRC", tmp_path / "csrc")
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    lib = tk._Library(BUILDER.name, BUILDER.sources, BUILDER.compiler,
                      BUILDER.load)
    with pytest.raises(RuntimeError, match="no source matches "
                                           "'results_host.c'"):
        lib.get()
    assert lib.lib is None
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("missing", ["compiler", "header"])
def test_missing_host_toolchain_raises(monkeypatch, tmp_path, missing):
    """No host C compiler, or no ``Python.h``: the error names it."""
    import shutil
    import sysconfig

    from vector_db_torch.ops import kernels as tk

    if missing == "compiler":
        monkeypatch.setattr(shutil, "which", lambda name: None)
        match = "no host C compiler"
    else:
        monkeypatch.setattr(sysconfig, "get_paths",
                            lambda: {"include": str(tmp_path)})
        match = "Python.h not found in " + str(tmp_path)
    with pytest.raises(RuntimeError, match=match):
        tk.host_cc()


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
