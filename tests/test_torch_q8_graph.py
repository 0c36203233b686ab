"""The padded-8 graph of ``HnswPqIndex`` (``vector_db_torch/index/q8graph.py``)
on the CPU, with a stub capturer in the place of CUDA graph capture: which
calls engage, the key (the same after a write in place, a new one after a
reallocation), eviction and the drop at ``build()``, the launch counters'
bookkeeping across capture and replay, and the ``q8graph.*`` counters.  The
stub's replay reruns the captured program on the tensors it closed over, as
a graph reads the memory its launches name.  The card's own checks (replays
bit-equal to the eager path, concurrent readers, the profiler seeing
replayed launches) are in ``tests/test_torch_kernels_cuda.py``."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.index import q8graph  # noqa: E402
from vector_db_torch.ops import kernels  # noqa: E402
from vector_db_torch.utils.stats import GLOBAL  # noqa: E402

D, N, CAP, K = 16, 600, 1024, 10


class StubCapturer:
    """Captures by keeping the program: ``warm`` runs it (real launches,
    counted), ``capture`` runs it once as the captured call, and each
    replay reruns it into the captured output with its launches uncounted,
    as a graph's replay runs no Python."""

    def __init__(self, fail=False):
        self.fail = fail
        self.warms = 0

    def warm(self, program, q_in):
        self.warms += 1
        program(q_in)

    def capture(self, program, q_in):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        out = program(q_in)

        def replay():
            with kernels.captured_launches():
                out.copy_(program(q_in))
        return replay, out


def counts():
    got = GLOBAL.snapshot()["counts"]
    return {name: got.get(f"q8graph.{name}", 0)
            for name in ("captures", "replays", "eager")}


def moved(before):
    now = counts()
    return {name: now[name] - before[name] for name in now}


def make_index(mode="auto", metric="l2", seed=0, graphs=True, **cfg):
    rng = np.random.default_rng(seed)
    idx = hp.HnswPqIndex(D, CAP, metric, HnswPqConfig(
        num_subspaces=4, training_iterations=2, training_samples=512,
        search_mode=mode, **cfg), device="cpu")
    idx.bulk_load(np.arange(N), rng.standard_normal((N, D)).astype(np.float32))
    if graphs:
        idx._q8 = q8graph.Q8Graphs(idx.device, StubCapturer())
    return idx


def eager(idx, queries, k):
    """The eager answer of the same index (its graphs set aside)."""
    saved, idx._q8 = idx._q8, q8graph.for_device(idx.device)
    try:
        return idx.search_batch(queries, k)
    finally:
        idx._q8 = saved


def queries(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


def test_cpu_index_has_no_capturer_and_counts_nothing():
    idx = make_index(graphs=False)
    assert idx._q8.capturer is None
    before = counts()
    for _ in range(3):
        idx.search_batch(queries(1), K)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 0}


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("mode", ["scan_exact", "scan_pallas_int8"])
@pytest.mark.parametrize("q_n", [1, 3, 8])
def test_first_call_eager_then_capture_then_replays(mode, metric, q_n):
    idx = make_index(mode, metric)
    q = queries(q_n)
    want = eager(idx, q, K)
    before = counts()
    assert_same(idx.search_batch(q, K), want)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 1}
    assert_same(idx.search_batch(q, K), want)
    assert moved(before) == {"captures": 1, "replays": 1, "eager": 1}
    for _ in range(3):
        assert_same(idx.search_batch(torch.from_numpy(q), K), want)
    assert moved(before) == {"captures": 1, "replays": 4, "eager": 1}
    assert len(idx._q8._graphs) == 1


def test_nine_queries_bypass_the_graphs():
    idx = make_index("scan_exact")
    before = counts()
    for _ in range(3):
        idx.search_batch(queries(9), K)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 0}
    assert len(idx._q8._graphs) == 0


@pytest.mark.parametrize("mode,cfg", [
    ("scan_pallas_int8", {"int8_epilogue": "global"}),
    ("scan_pallas", {}), ("scan_bf16", {}), ("adc_fast", {}), ("adc", {})])
def test_modes_outside_the_set_run_eagerly(mode, cfg):
    idx = make_index(mode, **cfg)
    q = queries(1)
    want = eager(idx, q, K)
    before = counts()
    for _ in range(3):
        assert_same(idx.search_batch(q, K), want)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 3}
    assert len(idx._q8._graphs) == 0


def test_compressed_store_runs_eagerly():
    idx = make_index("scan_pallas_int8", raw_store=False)
    before = counts()
    for _ in range(2):
        idx.search_batch(queries(1), K)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 2}


def test_untrained_and_every_row_wanted_run_eagerly():
    idx = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(
        num_subspaces=4, training_samples=512), device="cpu")
    idx._q8 = q8graph.Q8Graphs(idx.device, StubCapturer())
    idx.add_batch(range(40), queries(40, seed=3))
    assert not idx.trained
    before = counts()
    for _ in range(2):
        idx.search_batch(queries(1), K)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 2}
    trained = make_index("scan_exact")
    before = counts()
    for _ in range(2):  # n_live <= k: the exact fallback
        trained.search_batch(queries(1), N)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 2}


@pytest.mark.parametrize("mode", ["scan_exact", "scan_pallas_int8"])
def test_writes_in_place_keep_the_key(mode):
    idx = make_index(mode)
    q = queries(3)
    idx.search_batch(q, K)
    idx.search_batch(q, K)
    key = next(iter(idx._q8._graphs))
    before = counts()
    near = q[0] + 1e-3
    idx.add_batch([N + 1], near[None])                      # add
    assert_same(idx.search_batch(q, K), eager(idx, q, K))
    assert idx.search_batch(q, K)[0][0, 0] == N + 1
    victim = int(idx.search_batch(q, K)[0][1, 0])
    assert idx.remove(victim)                               # delete
    got = idx.search_batch(q, K)
    assert_same(got, eager(idx, q, K))
    assert victim not in got[0][1]
    assert idx.remove(N + 1)                                # update
    idx.add_batch([N + 1], (q[2] + 1e-3)[None])
    got = idx.search_batch(q, K)
    assert_same(got, eager(idx, q, K))
    assert got[0][2, 0] == N + 1
    assert list(idx._q8._graphs) == [key]
    assert moved(before)["captures"] == 0
    assert moved(before)["eager"] == 0


def test_reallocation_gives_a_new_key():
    idx = make_index("scan_pallas_int8")
    q = queries(1)
    idx.search_batch(q, K)
    idx.search_batch(q, K)
    old = next(iter(idx._q8._graphs))
    # an untracked rewrite: the next search rebuilds the shadow whole
    idx._note_store_rewrite()
    idx.add_batch([N + 5], queries(1, seed=9))
    before = counts()
    assert_same(idx.search_batch(q, K), eager(idx, q, K))
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 1}
    assert_same(idx.search_batch(q, K), eager(idx, q, K))
    assert moved(before) == {"captures": 1, "replays": 1, "eager": 1}
    assert old in idx._q8._graphs and len(idx._q8._graphs) == 2
    # a reload reallocates the store and drops every graph
    idx.load_state_arrays(idx.state_arrays())
    assert len(idx._q8._graphs) == 0
    assert_same(idx.search_batch(q, K), eager(idx, q, K))
    assert moved(before)["eager"] == 2


def test_oldest_graph_is_evicted_and_build_drops_all():
    idx = make_index("scan_exact")
    q = queries(1)
    ks = [1, 2, 4, 8, 16]  # five k_pad, five keys
    for k in ks:
        idx.search_batch(q, k)
    assert len(idx._q8._graphs) == q8graph.MAX_GRAPHS
    before = counts()
    idx.search_batch(q, ks[0])  # evicted: seen anew, runs eagerly
    assert moved(before)["eager"] == 1
    idx.search_batch(q, ks[-1])  # kept: captured now
    assert moved(before)["captures"] == 1
    idx.build()
    assert len(idx._q8._graphs) == 0
    before = counts()
    idx.search_batch(q, ks[-1])
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 1}


def test_pad_rows_are_zeroed_between_calls():
    idx = make_index("scan_exact")
    q = queries(3)
    idx.search_batch(q, K)
    idx.search_batch(q, K)
    graph = next(iter(idx._q8._graphs.values()))
    assert np.all(graph.q_np[3:] == 0)
    assert_same(idx.search_batch(q[:1], K), eager(idx, q[:1], K))
    np.testing.assert_array_equal(graph.q_np[0], q[0])
    assert np.all(graph.q_np[1:] == 0)


def _synthetic(calls):
    """A program that counts one B2 launch a run, as the CUDA wrapper
    does."""
    ids = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4)

    def run(q):
        calls.append(1)
        kernels._count_launch(kernels.fused_int8_pool)
        return q[:, :4] * 2.0, ids
    return q8graph.Program(run, ("synthetic",), (ids,))


def test_capture_tallies_its_launches_and_each_replay_adds_them():
    graphs = q8graph.Q8Graphs(torch.device("cpu"), StubCapturer())
    calls = []
    prog = _synthetic(calls)
    q = torch.ones(1, D)
    start = kernels.fused_int8_pool.launches
    assert graphs.search(prog, q, 4, 4) is None      # first sight: eager
    assert kernels.fused_int8_pool.launches == start
    ids, dists = graphs.search(prog, q, 4, 4)        # warm, capture, replay
    # the warm-up launched (counted); the captured call did not; the replay
    # added its tally
    assert kernels.fused_int8_pool.launches == start + 2
    graph = next(iter(graphs._graphs.values()))
    assert graph.launches == ((kernels.fused_int8_pool, 1),)
    for n in range(1, 4):
        graphs.search(prog, q, 4, 4)
        assert kernels.fused_int8_pool.launches == start + 2 + n
    np.testing.assert_array_equal(ids, np.arange(4, dtype=np.int32)[None])
    np.testing.assert_array_equal(dists, np.full((1, 4), 2.0, np.float32))


def test_captured_launches_are_per_thread_and_nest():
    start = kernels.fused_raw_pool.launches
    other = threading.Event()

    def elsewhere():
        kernels._count_launch(kernels.fused_raw_pool)
        other.set()
    with kernels.captured_launches() as outer:
        kernels._count_launch(kernels.fused_raw_pool)
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and other.is_set()
        with kernels.captured_launches() as inner:
            kernels._count_launch(kernels.fused_raw_pool)
        kernels._count_launch(kernels.fused_raw_pool)
    assert outer == {kernels.fused_raw_pool: 2}
    assert inner == {kernels.fused_raw_pool: 1}
    # only the other thread's launch was counted
    assert kernels.fused_raw_pool.launches == start + 1


def test_failed_capture_keeps_the_key_eager():
    idx = make_index("scan_exact")
    idx._q8 = q8graph.Q8Graphs(idx.device, StubCapturer(fail=True))
    q = queries(1)
    want = eager(idx, q, K)
    before = counts()
    for _ in range(4):
        assert_same(idx.search_batch(q, K), want)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 4}
    assert idx._q8.capturer.warms == 1  # one attempt, not one a call
