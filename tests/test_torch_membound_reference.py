"""The codes-only search (``adc_fast``, a ranked pool of 128, the bf16
re-rank: the ``membound-512d-100k`` deployment) against its plain
reference, ``perfbench/reference_adc.py``, on the CPU at 6,000 x 64 with 8
subspaces.

The system runs through ``VectorDatabase``; the reference reads the
index's trained state (codebooks, codes, perm) and the rows, and follows
the configuration's semantics in float64.  Planted faults, each a search
other than the one stated, must fail a check: a re-rank against the f32
rows (higher precision than stated), against int8 rows (lower), and a pool
cut to 32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import reference_adc  # noqa: E402
from vector_db_torch import IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402

N, D, S, Q, K, SELECT_R = 6000, 64, 8, 64, 10, 128
CONFIG = dict(num_subspaces=S, training_samples=2000, search_mode="adc_fast",
              adc_pool="approx", adc_select_r=SELECT_R, refine_store="bf16")
#: answer slots that must hold the reference's id: the program scores the
#: pool from a bf16 reconstruction (f32 on the CPU, bf16 queries on the
#: card) and the reference in float64, so a row tied within that rounding
#: at the pool's 128th place may enter one pool and not the other
MIN_SLOTS_EQUAL = 0.99
#: relative distance gap where the ids agree: the program re-ranks in f32
#: (|q|^2 + |x|^2 - 2 q.x), the reference in float64 (~1e-6 measured);
#: a bf16 row against an f32 row differs by ~1e-4 to 1e-3
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


def system_and_reference(seed, **overrides):
    """(the system's ids and distances [Q, K], the reference's) for one
    seed; ``overrides`` change the system's config, not the reference."""
    rows, queries = spectral(seed)
    db = (VectorDatabase.builder().with_dimension(D).with_max_elements(N)
          .with_index_type(IndexType.HNSWPQ).with_device("cpu")
          .with_index_config(HnswPqConfig(**{**CONFIG, **overrides}))
          .build())
    db.bulk_load(np.arange(N), rows)
    res = db.search_batch(queries, K)
    ids = np.array([[r.id for r in a] for a in res])
    dist = np.array([[r.distance for r in a] for a in res])
    idx = db.index
    r_ids, r_dist, _ = reference_adc.search(
        torch.as_tensor(queries), idx.codebooks, idx.codes, idx.perm,
        torch.as_tensor(rows), idx.store.state.valid, K, SELECT_R)
    return (ids, dist), (r_ids.numpy(), r_dist.numpy())


def compare(system, ref):
    """(share of answer slots holding the reference's id, the largest
    relative distance gap over those slots)."""
    (ids, dist), (r_ids, r_dist) = system, ref
    same = ids == r_ids
    gap = np.abs(dist - r_dist) / r_dist
    return float(same.mean()), float(gap[same].max())


@pytest.mark.parametrize("seed", [1, 2])
def test_system_answers_as_the_reference(seed):
    slots, gap = compare(*system_and_reference(seed))
    assert slots >= MIN_SLOTS_EQUAL
    assert gap <= MAX_DIST_GAP


@pytest.mark.parametrize("fault", [
    {"refine_store": "f32"}, {"refine_store": "int8"}, {"adc_select_r": 32}],
    ids=["f32_rows", "int8_rows", "pool_32"])
def test_planted_faults_fail_a_check(fault):
    slots, gap = compare(*system_and_reference(1, **fault))
    assert slots < MIN_SLOTS_EQUAL or gap > MAX_DIST_GAP


def test_reference_pool_is_the_adc_nearest(monkeypatch):
    """The reference's pool, merged over small row blocks, is the
    select_r rows nearest by |q_perm - reconstruction|^2 taken whole in
    float64, and its re-rank is the exact order over the bf16 pool rows."""
    monkeypatch.setattr(reference_adc, "R_BLOCK", 700)
    monkeypatch.setattr(reference_adc, "Q_BLOCK", 5)
    g = torch.Generator().manual_seed(4)
    n, s, k_c, sd, q_n, r = 2000, 4, 16, 3, 12, 40
    codebooks = torch.randn(s, k_c, sd, generator=g)
    codes = torch.randint(0, k_c, (n, s), generator=g, dtype=torch.uint8)
    rows = torch.randn(n, s * sd, generator=g)
    queries = torch.randn(q_n, s * sd, generator=g)
    perm = torch.randperm(s * sd, generator=g)
    valid = torch.rand(n, generator=g) > 0.1
    ids, dist, pool = reference_adc.search(queries, codebooks, codes, perm,
                                           rows, valid, 5, r)

    cb = codebooks.double()
    recon = torch.cat([cb[j][codes[:, j].long()] for j in range(s)], 1)
    adc_d = (queries.double()[:, perm][:, None, :] - recon[None]).square() \
        .sum(2)
    adc_d[:, ~valid] = float("inf")
    want = torch.sort(adc_d, 1).values[:, :r]
    assert torch.allclose(torch.gather(adc_d, 1, pool), want)
    assert valid[pool].all()

    v = rows[pool].to(torch.bfloat16).double()
    d2 = (v - queries.double()[:, None, :]).square().sum(2)
    order = torch.sort(d2, 1)
    assert torch.equal(ids, torch.gather(pool, 1, order.indices[:, :5]))
    assert torch.allclose(dist, order.values[:, :5].sqrt())
