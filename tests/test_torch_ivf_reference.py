"""The cluster-pruned search (``scan_ivf`` on the raw store) against its
plain reference, ``perfbench/reference_ivf.py``, on the CPU at 8,000 x 32
with 16 clusters, nprobe 4, 4 winners a bucket and a pool of 64.

The system runs through ``VectorDatabase``; the reference reads the
index's trained state (the coarse centroids, the layout's grid position of
each row and its overlay, the int8 shadow, the f32 rows) and follows the
search's stated semantics in float64.  Planted faults, each a search other
than the one stated, must fail a check: nprobe halved, and the re-rank
against the int8 shadow's rows in place of the f32 rows.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import reference_ivf  # noqa: E402
from perfbench.tests.test_perfbench_imports import (  # noqa: E402
    top_level_imports)
from vector_db_torch import IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq  # noqa: E402

N, D, Q, K = 8000, 32, 64, 10
NLIST, NPROBE, WINNERS, POOL = 16, 4, 4, 64
CONFIG = dict(num_subspaces=4, training_samples=2000, search_mode="scan_ivf",
              nlist=NLIST, nprobe=NPROBE, ivf_winners=WINNERS, ivf_pool=POOL)
#: answer slots that must hold the reference's id: the program scores the
#: pool with an int8 query (one scale over the padded batch) in f32 and
#: the reference with the float64 query, so a row within that rounding of
#: the pool's 64th place may enter one pool and not the other (measured
#: 0.9953-1.0 over seeds 1-4; nprobe halved reads 0.42 at seed 1)
MIN_SLOTS_EQUAL = 0.98
#: relative distance gap where the ids agree: the program re-ranks in f32
#: (|q|^2 + |x|^2 - 2 q.x), the reference in float64 (measured 6.7e-7 to
#: 8.4e-7 over seeds 1-4); a re-rank against the int8 rows reads 6.2e-3
MAX_DIST_GAP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def spectral(seed):
    """Rows and queries randn * (i + 1)^-0.5 in dimension i."""
    rng = np.random.default_rng(seed)
    scale = (np.arange(D) + 1.0) ** -0.5
    return ((rng.standard_normal((N, D)) * scale).astype(np.float32),
            (rng.standard_normal((Q, D)) * scale).astype(np.float32))


def int8_rows_refine(monkeypatch, idx):
    """Plant the re-rank against the int8 shadow's rows, dequantized
    (cvec + x8 * step), in place of the f32 rows."""
    base8, _, sc, cvec, _ = idx._scan8_shadow()
    rows = cvec[None, :] + base8[:, :D].to(torch.float32) * (-sc[:, None] / 2)
    orig = hnsw_pq.pallas_ivf_refine_raw

    def planted(queries, lay, base, *args):
        return orig(queries, lay, rows[:base.shape[0]], *args)

    monkeypatch.setattr(hnsw_pq, "pallas_ivf_refine_raw", planted)


def system_and_reference(seed, monkeypatch=None, int8_refine=False,
                         writes=False, **overrides):
    """(the system's ids and distances [Q, K], the reference's) for one
    seed; ``overrides`` change the system's config, not the reference.
    ``writes``: after a first search has laid the grid out, 200 rows are
    deleted and 200 added into their slots, which the overlay then
    holds."""
    rows, queries = spectral(seed)
    db = (VectorDatabase.builder().with_dimension(D)
          .with_max_elements(N + 256).with_index_type(IndexType.HNSWPQ)
          .with_device("cpu")
          .with_index_config(HnswPqConfig(**{**CONFIG, **overrides}))
          .build())
    db.bulk_load(np.arange(N), rows)
    idx = db.index
    if writes:
        db.search_batch(queries[:1], K)
        for i in range(0, 2000, 10):
            db.delete_vector(i)
        extra = spectral(seed + 100)[0][:200]
        db.add_batch(range(N, N + 200), extra)
        rows = np.concatenate([rows, extra])
    if int8_refine:
        int8_rows_refine(monkeypatch, idx)
    res = db.search_batch(queries, K)
    ids = np.array([[r.id for r in a] for a in res])
    dist = np.array([[r.distance for r in a] for a in res])
    lay = idx._ivf_layout()
    assert lay.overlay.size == (200 if writes else 0)
    base8, off, sc, cvec, _ = idx._scan8_shadow()
    st = idx.store.state
    r_ids, r_dist, _ = reference_ivf.search(
        torch.as_tensor(queries), lay.centroids, lay.slot2pos, lay.cap,
        torch.as_tensor(lay.overlay), base8, off, sc, cvec, st.vectors,
        st.valid, K, NPROBE, WINNERS, POOL)
    return (ids, dist), (st.ids[r_ids].numpy(), r_dist.numpy())


def compare(system, ref):
    """(share of answer slots holding the reference's id, the largest
    relative distance gap over those slots)."""
    (ids, dist), (r_ids, r_dist) = system, ref
    same = ids == r_ids
    gap = np.abs(dist - r_dist) / r_dist
    return float(same.mean()), float(gap[same].max())


@pytest.mark.parametrize("seed,writes", [(1, False), (2, False), (3, True)],
                         ids=["seed1", "seed2", "overlay"])
def test_system_answers_as_the_reference(seed, writes):
    slots, gap = compare(*system_and_reference(seed, writes=writes))
    assert slots >= MIN_SLOTS_EQUAL
    assert gap <= MAX_DIST_GAP


@pytest.mark.parametrize("fault", ["nprobe_halved", "int8_rows"])
def test_planted_faults_fail_a_check(monkeypatch, fault):
    kw = ({"nprobe": NPROBE // 2} if fault == "nprobe_halved"
          else {"int8_refine": True})
    slots, gap = compare(*system_and_reference(1, monkeypatch, **kw))
    assert slots < MIN_SLOTS_EQUAL or gap > MAX_DIST_GAP


def test_the_ivf_reference_imports_nothing_of_the_program():
    """``reference_ivf.py`` imports torch, the standard library and the
    harness's own reference, and nothing of the program or of JAX (the
    harness's import walk, which leaves relative imports out)."""
    path = Path(reference_ivf.__file__)
    assert top_level_imports(path) <= {"__future__", "torch"}
    assert "from .reference import tf32_off" in path.read_text()


def test_reference_pool_is_the_bucket_winners_of_the_probed_clusters(
        monkeypatch):
    """Over a planted layout, with small query blocks: the reference's
    pool is the ``pool`` best of each probed bucket's ``winners`` best by
    the shadow's score taken whole in float64, and its answer the exact
    order over the pool and the live overlay."""
    monkeypatch.setattr(reference_ivf, "Q_BLOCK", 5)
    g = torch.Generator().manual_seed(4)
    n, d, nlist, cap, q_n, nprobe, winners, pool, k = \
        900, 8, 4, 256, 12, 2, 3, 20, 5
    rows = torch.randn(n, d, generator=g)
    queries = torch.randn(q_n, d, generator=g)
    cents = torch.randn(nlist, d, generator=g)
    valid = torch.rand(n, generator=g) > 0.1
    slot2pos = torch.randperm(nlist * cap, generator=g)[:n].to(torch.int32)
    overlay = torch.arange(n - 12, n)
    slot2pos[overlay] = -1
    base8 = torch.randint(-127, 128, (n, d), generator=g).to(torch.int8)
    off = torch.rand(n, generator=g) * 10
    sc = -torch.rand(n, generator=g)
    cvec = torch.randn(d, generator=g)
    ids, dist, got_pool = reference_ivf.search(
        queries, cents, slot2pos, cap, overlay, base8, off, sc, cvec, rows,
        valid, k, nprobe, winners, pool)

    score = off.double()[None, :] + sc.double()[None, :] * (
        (queries.double() - cvec.double()) @ base8.double().T)
    cd = torch.cdist(queries.double(), cents.double())
    probed = torch.topk(cd, nprobe, dim=1, largest=False).indices
    for i in range(q_n):
        best = []
        for c in probed[i].tolist():
            for b in range(c * cap, (c + 1) * cap, 128):
                inside = torch.nonzero((slot2pos >= b) & (slot2pos < b + 128)
                                       & valid).flatten()
                s = score[i, inside]
                top = torch.topk(s, min(winners, s.numel()), largest=False)
                best += list(zip(top.values.tolist(),
                                 inside[top.indices].tolist()))
        want = [slot for _, slot in sorted(best)[:pool]]
        assert sorted(got_pool[i].tolist()) == sorted(want)
        full = want + overlay[valid[overlay]].tolist()
        d2 = (rows[full].double() - queries[i].double()).square().sum(1)
        order = torch.argsort(d2)[:k]
        assert ids[i].tolist() == [full[j] for j in order.tolist()]
        assert torch.allclose(dist[i], d2[order].sqrt())
