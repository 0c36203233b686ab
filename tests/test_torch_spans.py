"""The port's spans (``vector_db_torch/utils/stats.py``), on the CPU.

Off by default: nothing is recorded and ``span`` hands back one shared
object.  On: each ``search`` / ``search_batch`` call is one root span with
the stages of the index nested inside it, on one call id; the pool mode
alone refines; the int8 shadow is spanned when it is built or refreshed,
not on a cache hit; ``bulk_load`` holds the quantizers' fitting; the
buffer drops its oldest records and counts them; under ``torch.profiler``
the spans are ``user_annotation`` events of the same names and nesting.
Answers are bit-equal with tracing on and off.  Both scan modes run their
CPU versions (``scan_pallas_int8``: the plain int8 pool).  The codes-only
(``adc_fast``) and the cluster-pruned (``scan_ivf``) searches have their
stages, their derived caches' spans and their counters checked at the end.
"""

import collections
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vector_db_torch import IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig, PqConfig  # noqa: E402
from vector_db_torch.utils import stats  # noqa: E402

MODES = ["scan_exact", "scan_pallas_int8"]
DIM, N, K = 32, 2000, 5
SEARCH_STAGES = {"index.copy_in", "index.scan", "index.fetch"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracing_off():
    stats.set_tracing(False)
    stats.take_spans()
    yield
    stats.set_tracing(False)
    stats.take_spans()


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((N + 64, DIM)).astype(np.float32),
            rng.standard_normal((16, DIM)).astype(np.float32))


def make_db(mode, index_type=IndexType.HNSWPQ):
    cfg = (HnswPqConfig(num_subspaces=4, training_samples=1000,
                        search_mode=mode)
           if index_type is IndexType.HNSWPQ else
           PqConfig(num_subspaces=4) if index_type is IndexType.PQ else None)
    b = (VectorDatabase.builder().with_dimension(DIM).with_max_elements(4096)
         .with_index_type(index_type).with_device("cpu"))
    if cfg is not None:
        b = b.with_index_config(cfg)
    return b.build()


def loaded(mode, rows, index_type=IndexType.HNSWPQ):
    db = make_db(mode, index_type)
    if index_type is IndexType.HNSWPQ:
        db.bulk_load(np.arange(N), rows[0][:N])
    else:
        db.add_batch(range(N), rows[0][:N])
        db.rebuild_index()
    return db


def by_call(spans):
    calls = {}
    for s in spans:
        calls.setdefault(s.call, []).append(s)
    return calls


def check_nesting(spans):
    """Every span of a call lies inside its parent, on the parent's call."""
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent is None:
            assert s.call == s.seq
            continue
        p = by_seq[s.parent]
        assert p.call == s.call
        assert p.start <= s.start and s.end <= p.end, (p, s)


def answers(db, queries, api):
    if api == "search":
        return [[(r.id, r.distance) for r in db.search(q, K)]
                for q in queries]
    return [[(r.id, r.distance) for r in res]
            for res in db.search_batch(queries, K)]


@pytest.mark.parametrize("mode", MODES)
def test_off_records_nothing(rows, mode):
    db = loaded(mode, rows)
    db.search(rows[1][0], K)
    db.search_batch(rows[1], K)
    db.add_batch(range(N, N + 8), rows[0][N:N + 8])
    db.search_batch(rows[1], K)
    assert stats.take_spans() == ([], 0)
    assert stats.span("facade.search") is stats.span("index.scan")


@pytest.mark.parametrize("mode", MODES)
def test_answers_bit_equal_on_and_off(rows, mode):
    db_off = loaded(mode, rows)
    stats.set_tracing(True)
    db_on = loaded(mode, rows)
    on = [answers(db_on, rows[1], api) for api in ("search", "search_batch")]
    stats.set_tracing(False)
    off = [answers(db_off, rows[1], api)
           for api in ("search", "search_batch")]
    assert on == off
    assert stats.take_spans()[0]


@pytest.mark.parametrize("api", ["search", "search_batch"])
@pytest.mark.parametrize("mode", MODES)
def test_one_root_a_call_with_the_stages_inside(rows, mode, api):
    db = loaded(mode, rows)
    answers(db, rows[1][:2], api)          # builds the shadow, if any
    stats.set_tracing(True)
    queries = rows[1][:3]
    answers(db, queries, api)
    stats.set_tracing(False)
    spans, dropped = stats.take_spans()
    assert dropped == 0
    check_nesting(spans)
    calls = by_call(spans)
    assert len(calls) == (len(queries) if api == "search" else 1)
    stages = SEARCH_STAGES | ({"index.refine"} if mode != "scan_exact"
                              else set())
    for call in calls.values():
        roots = [s for s in call if s.parent is None]
        assert [r.name for r in roots] == [f"facade.{api}"]
        names = {s.seq: s.name for s in call}
        under = {}
        for s in call:
            if s.parent is not None:
                under.setdefault(names[s.parent], []).append(s.name)
        assert sorted(under[f"facade.{api}"]) == ["facade.results",
                                                   "index.search"]
        assert sorted(under["index.search"]) == sorted(stages)
        assert set(under) == {f"facade.{api}", "index.search"}


@pytest.mark.parametrize("mode", MODES)
def test_shadow_spanned_when_built_or_refreshed(rows, mode):
    db = loaded(mode, rows)
    notes = []
    for step in range(3):
        if step == 2:
            db.add_batch(range(N, N + 8), rows[0][N:N + 8])
        stats.set_tracing(True)
        db.search_batch(rows[1], K)
        stats.set_tracing(False)
        spans, _ = stats.take_spans()
        check_nesting(spans)
        shadow = [s for s in spans if s.name == "index.shadow"]
        for s in shadow:
            parent = next(p for p in spans if p.seq == s.parent)
            assert parent.name == "index.search"
        notes.append([s.note for s in shadow])
    if mode == "scan_exact":
        assert notes == [[], [], []]
    else:
        assert notes == [["whole"], [], ["incremental"]]


@pytest.mark.parametrize("mode", MODES)
def test_bulk_load_holds_one_train(rows, mode):
    db = make_db(mode)
    stats.set_tracing(True)
    db.bulk_load(np.arange(N), rows[0][:N])
    stats.set_tracing(False)
    spans, _ = stats.take_spans()
    check_nesting(spans)
    assert sorted(s.name for s in spans) == ["ingest.bulk_load",
                                             "ingest.train"]
    load = next(s for s in spans if s.name == "ingest.bulk_load")
    train = next(s for s in spans if s.name == "ingest.train")
    assert load.parent is None and train.parent == load.seq


def test_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(stats, "_buffer", collections.deque(maxlen=5))
    stats.set_tracing(True)
    try:
        for i in range(8):
            with stats.span(f"s{i}"):
                pass
    finally:
        stats.set_tracing(False)
    spans, dropped = stats.take_spans()
    assert [s.name for s in spans] == ["s3", "s4", "s5", "s6", "s7"]
    assert dropped == 3
    assert stats.take_spans() == ([], 0)


def annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


@pytest.mark.parametrize("tracing", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("mode", MODES)
def test_profiler_sees_the_spans(rows, tmp_path, mode, tracing):
    from torch.profiler import ProfilerActivity, profile

    db = loaded(mode, rows)
    db.search(rows[1][0], K)
    stats.set_tracing(tracing)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db.search(rows[1][1], K)
    stats.set_tracing(False)
    spans, _ = stats.take_spans()
    events = annotations(prof, tmp_path)
    got = {e["name"]: e for e in events}
    want = {"facade.search", "facade.results", "index.search"} \
        | SEARCH_STAGES | ({"index.refine"} if mode != "scan_exact"
                           else set())
    assert set(got) == want
    assert len(events) == len(want)

    def inside(child, parent):
        c, p = got[child], got[parent]
        return p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]

    assert inside("index.search", "facade.search")
    assert inside("facade.results", "facade.search")
    for stage in want - {"facade.search", "facade.results", "index.search"}:
        assert inside(stage, "index.search")
    if tracing:
        assert sorted(s.name for s in spans) == sorted(want)
    else:
        assert spans == []


def test_timed_counts_always_and_shares_the_span_clock():
    c = stats.Counters()
    with stats.timed("t", c, span_name="index.search"):
        pass
    assert c.counts["t.calls"] == 1
    assert stats.take_spans() == ([], 0)
    stats.set_tracing(True)
    with stats.timed("t", c, span_name="index.search"):
        pass
    stats.set_tracing(False)
    (sp,), _ = stats.take_spans()
    assert c.counts["t.calls"] == 2
    assert sp.name == "index.search"
    assert c.times["t"] >= (sp.end - sp.start) * 1e-9 > 0


def test_nvtx_only_while_tracing(monkeypatch):
    pushed = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", pushed.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    c = stats.Counters()
    with stats.timed("t", c, span_name="a"), stats.span("b"):
        pass
    assert pushed == []
    stats.set_tracing(True)
    with stats.timed("t", c, span_name="a"), stats.span("b"):
        pass
    stats.set_tracing(False)
    assert pushed == ["a", "b"]


@pytest.mark.parametrize("index_type", [IndexType.BRUTE, IndexType.PQ],
                         ids=["brute", "pq"])
def test_other_index_types_have_facade_and_fetch_spans(rows, index_type):
    db = loaded(None, rows, index_type)
    stats.set_tracing(True)
    db.search(rows[1][0], K)
    db.search_batch(rows[1][:4], K)
    stats.set_tracing(False)
    spans, _ = stats.take_spans()
    check_nesting(spans)
    for api, call in zip(("search", "search_batch"), by_call(spans).values()):
        assert sorted(s.name for s in call) == sorted(
            [f"facade.{api}", "facade.results", "index.search",
             "index.fetch"])


def test_threads_keep_their_own_calls():
    """Many threads opening nested spans at once: no record is lost or
    double-counted, and every child sits on its own thread's call."""
    threads, calls = 12, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stats.set_tracing(True)
    errors = []

    def work(t):
        try:
            for _ in range(calls):
                with stats.span(f"root{t}"):
                    with stats.span(f"child{t}"):
                        pass
        except Exception as e:  # reported below
            errors.append(e)

    try:
        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        stats.set_tracing(False)
        sys.setswitchinterval(old)
    assert errors == []
    spans, dropped = stats.take_spans()
    assert dropped == 0 and len(spans) == threads * calls * 2
    assert len({s.seq for s in spans}) == len(spans)
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        if s.name.startswith("child"):
            root = by_seq[s.parent]
            assert root.name == "root" + s.name[5:] and root.call == s.call
    check_nesting(spans)


# ----------------------------------------- adc_fast: the codes-only search
#: the memory-bound configuration's options, scaled down (64-d, 8 subspaces)
MEMBOUND = dict(num_subspaces=8, training_samples=2000,
                search_mode="adc_fast", adc_pool="approx", adc_select_r=128,
                refine_store="bf16")
M_DIM, M_N = 64, 6000
ADC_STAGES = {"index.copy_in", "index.scan", "index.refine", "index.fetch"}


@pytest.fixture(scope="module")
def spectral():
    rng = np.random.default_rng(11)
    scale = (np.arange(M_DIM) + 1.0) ** -0.5
    return ((rng.standard_normal((M_N, M_DIM)) * scale).astype(np.float32),
            (rng.standard_normal((16, M_DIM)) * scale).astype(np.float32))


def membound_db(spectral):
    db = (VectorDatabase.builder().with_dimension(M_DIM)
          .with_max_elements(M_N).with_index_type(IndexType.HNSWPQ)
          .with_device("cpu").with_index_config(HnswPqConfig(**MEMBOUND))
          .build())
    db.bulk_load(np.arange(M_N), spectral[0])
    return db


def adc_counts(db):
    c = db.metrics()["counts"]
    return c.get("adc.decoded_rows", 0), c.get("adc.refined", 0)


def test_adc_fast_stages_and_shadow_on_the_first_search(spectral):
    db = membound_db(spectral)
    assert db.index.resolve_mode(db.index.size()) == "adc_fast"
    shadows = []
    for _ in range(2):
        stats.set_tracing(True)
        db.search_batch(spectral[1], K)
        stats.set_tracing(False)
        spans, dropped = stats.take_spans()
        assert dropped == 0
        check_nesting(spans)
        roots = [s for s in spans if s.parent is None]
        assert [r.name for r in roots] == ["facade.search_batch"]
        names = {s.seq: s.name for s in spans}
        under = {}
        for s in spans:
            if s.parent is not None:
                under.setdefault(names[s.parent], []).append(s.name)
        assert sorted(under["facade.search_batch"]) == ["facade.results",
                                                        "index.search"]
        shadow = [s for s in spans if s.name == "index.shadow"]
        assert set(under["index.search"]) - {"index.shadow"} == ADC_STAGES
        assert len(under["index.search"]) == len(ADC_STAGES) + len(shadow)
        shadows.append(sorted(s.note for s in shadow))
    assert shadows == [["bf16_refine", "fast_tables"], []]


@pytest.mark.parametrize("tracing", [True, False], ids=["on", "off"])
def test_adc_counters_count_the_shapes(spectral, tracing):
    """One call decodes every code column of the store's capacity once and
    re-ranks the padded queries' pools of select_r; tracing or not."""
    db = membound_db(spectral)
    db.search_batch(spectral[1][:2], K)
    before = adc_counts(db)
    stats.set_tracing(tracing)
    db.search_batch(spectral[1][:5], K)            # padded to 8
    stats.set_tracing(False)
    stats.take_spans()
    decoded, refined = (a - b for a, b in zip(adc_counts(db), before))
    assert decoded == db.index.store.capacity
    assert refined == 8 * MEMBOUND["adc_select_r"]


def test_adc_decoded_rows_sum_over_chunks(monkeypatch):
    """Chunked, each chunk's columns count (the last one re-sliced to end
    at N); the norm pass counts when the norms are not given; the fused
    pool (one CUDA kernel that decodes in itself) counts none."""
    from vector_db_torch.ops import adc

    g = torch.Generator().manual_seed(3)
    n, s, sd, k_c = 1000, 4, 4, 16
    codes_t = torch.randint(0, k_c, (s, n), generator=g, dtype=torch.uint8)
    cbt = torch.randn(s * sd, k_c, generator=g)
    valid = torch.ones(n, dtype=torch.bool)
    args = (torch.randn(4, s * sd, generator=g), codes_t, cbt, valid,
            torch.randn(n, s * sd, generator=g), torch.arange(n), 5)
    norms = adc.code_norms_from_codes(codes_t, cbt, valid)
    monkeypatch.setattr(adc, "fused_adc_pool", lambda qb, ct, cb, mn, w: (
        torch.zeros(qb.shape[0], w),
        torch.zeros(qb.shape[0], w, dtype=torch.int32)))
    for kw, want in ((dict(chunk_n=384, code_norms=norms), 3 * 384),
                     (dict(chunk_n=0), 2 * n),
                     (dict(pool_mode="fused", code_norms=norms), 0)):
        before = stats.GLOBAL.counts.get("adc.decoded_rows", 0)
        adc.adc_fast_search(*args, bucket=8, select_r=32,
                            **{"pool_mode": "approx", **kw})
        assert stats.GLOBAL.counts.get("adc.decoded_rows", 0) - before \
            == want, kw


# ------------------------------------------- scan_ivf: the cluster-pruned scan
#: the cluster-pruned configuration's options, scaled down (6,000 x 64: 8
#: clusters by auto_ivf_geometry, 4 probed)
IVF = dict(num_subspaces=8, training_samples=2000, search_mode="scan_ivf",
           nlist=0, nprobe=4)


def ivf_db(spectral):
    db = (VectorDatabase.builder().with_dimension(M_DIM)
          .with_max_elements(M_N + 64).with_index_type(IndexType.HNSWPQ)
          .with_device("cpu").with_index_config(HnswPqConfig(**IVF))
          .build())
    db.bulk_load(np.arange(M_N), spectral[0])
    return db


def ivf_counts(db):
    c = db.metrics()["counts"]
    return tuple(c.get(f"ivf.{n}", 0)
                 for n in ("probes", "probed_rows", "pool_rows"))


@pytest.mark.parametrize("api", ["search", "search_batch"])
def test_scan_ivf_one_scan_and_one_refine_a_call(spectral, api):
    db = ivf_db(spectral)
    answers(db, spectral[1][:2], api)          # lays the grid out
    stats.set_tracing(True)
    answers(db, spectral[1][:3], api)
    stats.set_tracing(False)
    spans, dropped = stats.take_spans()
    assert dropped == 0
    check_nesting(spans)
    calls = by_call(spans)
    assert len(calls) == (3 if api == "search" else 1)
    for call in calls.values():
        names = {s.seq: s.name for s in call}
        under = sorted(s.name for s in call
                       if s.parent is not None
                       and names[s.parent] == "index.search")
        assert under == sorted(SEARCH_STAGES | {"index.refine"})


def test_scan_ivf_layout_spanned_on_the_first_search_and_refreshed(
        spectral):
    """The first search after a load builds the int8 shadow (``whole``)
    and then lays the grid out from it (``ivf_layout``), side by side, so
    the ``index.shadow`` spans' sum is the time they cover; the next search
    is a hit; after writes, the shadow's refresh and the overlay's
    (``ivf_overlay``), which leaves the grid as it is."""
    db = ivf_db(spectral)
    notes = []
    for step in range(3):
        if step == 2:
            db.add_batch(range(M_N, M_N + 8), spectral[1][:8])
        stats.set_tracing(True)
        db.search_batch(spectral[1], K)
        stats.set_tracing(False)
        spans, _ = stats.take_spans()
        check_nesting(spans)
        by_seq = {s.seq: s for s in spans}
        shadows = [s for s in spans if s.name == "index.shadow"]
        notes.append(sorted((s.note, by_seq[s.parent].name)
                            for s in shadows))
        if step == 0:
            spans_s = sum(s.end - s.start for s in shadows)
            ends = sorted((s.start, s.end) for s in shadows)
            covered = sum(e - a for a, e in ends)
            assert all(a1 >= e0 for (_, e0), (a1, _) in zip(ends, ends[1:]))
            assert spans_s == covered
    assert notes == [[("ivf_layout", "index.search"),
                      ("whole", "index.search")], [],
                     [("incremental", "index.search"),
                      ("ivf_overlay", "index.search")]]


@pytest.mark.parametrize("q_n", [1, 64])
def test_scan_ivf_counters_count_the_shapes(spectral, q_n):
    """A call of q_n queries counts what the cluster scan is asked to do
    for the padded batch (one query pads to 8, 64 stays 64): q_pad x nprobe
    probes, those times the mean fill n_live / nlist scored rows, and q_pad
    x the pool width (min(max(4 k_pad, 256), nprobe x 128) = 256)
    re-ranked."""
    rng = np.random.default_rng(5)
    queries = rng.standard_normal((q_n, M_DIM)).astype(np.float32)
    db = ivf_db(spectral)
    db.search_batch(queries[:2], K)
    nlist = db.index.coarse_centroids.shape[0]
    assert nlist == 8
    before = ivf_counts(db)
    if q_n == 1:
        db.search(queries[0], K)
    else:
        db.search_batch(queries, K)
    got = tuple(a - b for a, b in zip(ivf_counts(db), before))
    q_pad = max(q_n, 8)
    probes = q_pad * IVF["nprobe"]
    assert got == (probes, round(probes * M_N / nlist), q_pad * 256)
