"""The port's HNSW graph engine (vector_db_torch/ops/hnsw_graph.py) against
the reference's, function by function, on the same seeded inputs.

Tolerances.  Both packages sum f32 products in another order, so a pair of
candidates at nearly equal distance may swap.  Selection on given distances
(``_select_heuristic``, ``unlink_slot``) is held to equal arrays.  Edge
construction is held row by row: an adjacency row counts as equal when it
holds the same neighbors as a set, and at least 99% of the rows must be
equal, with levels and entry point equal.  Searches must return the same ids
for at least 99% of the answers and reach the reference's recall against an
exact oracle minus 0.005.  Matmuls run at full f32 precision on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.ops import hnsw_graph as ref_hg  # noqa: E402
from vector_db_torch.ops import hnsw_graph as hg  # noqa: E402

D, M, K = 32, 8, 10


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _levels(seed, n, max_level):
    u = np.random.default_rng(seed).uniform(1e-12, 1.0, n)
    return np.clip(np.floor(-np.log(u) / np.log(M)).astype(np.int32), 0,
                   max_level - 1)


def _store(seed, cap, slots):
    """(base [cap, D], norms [cap], valid [cap]) with rows at ``slots``."""
    r = np.random.default_rng(seed)
    base = np.zeros((cap, D), np.float32)
    base[slots] = r.standard_normal((len(slots), D)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[slots] = True
    return base, (base * base).sum(1), valid


def _to_port(g):
    return hg.HnswGraph(_t(g.neighbors), _t(g.levels), int(g.entry),
                        int(g.entry_level))


def _rows_equal(a, b):
    """Share of adjacency rows [..., M] equal as sets (-1 pads ignored)."""
    a = np.sort(np.asarray(a).reshape(-1, a.shape[-1]), axis=1)
    b = np.sort(np.asarray(b).reshape(-1, b.shape[-1]), axis=1)
    return float(np.mean(np.all(a == b, axis=1)))


def _same_graph(port, ref, bar=0.99):
    np.testing.assert_array_equal(port.levels.numpy(), np.asarray(ref.levels))
    assert (port.entry, port.entry_level) == (int(ref.entry),
                                              int(ref.entry_level))
    assert _rows_equal(port.neighbors.numpy(), ref.neighbors) >= bar


def _built(seed=1, n=1500, cap=2048, first_slot=0):
    """A reference graph bulk-built over slots first_slot .. first_slot+n-1,
    with its store."""
    slots = np.arange(first_slot, first_slot + n, dtype=np.int32)
    base, norms, valid = _store(seed, cap, slots)
    levels = _levels(seed + 100, n, 3)
    g = ref_hg.bulk_build(ref_hg.init_graph(cap, M, 3), jnp.asarray(base),
                          jnp.asarray(norms), slots, levels, m=M)
    return g, base, norms, valid, slots, levels


@pytest.mark.parametrize("m", [4, 8])
def test_select_heuristic_equals_reference(m):
    r = np.random.default_rng(3)
    b, c = 64, 24
    cand_d = r.uniform(0.5, 4.0, (b, c)).astype(np.float32)
    cand_i = r.permuted(np.tile(np.arange(c, dtype=np.int32), (b, 1)), axis=1)
    pair = r.uniform(0.5, 4.0, (b, c, c)).astype(np.float32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    dead = r.uniform(size=(b, c)) < 0.2
    dead[:8] |= r.uniform(size=(8, c)) < 0.8     # rows with < m candidates
    cand_d[dead] = np.inf
    cand_i[dead] = -1
    want = ref_hg._select_heuristic(jnp.asarray(cand_d), jnp.asarray(cand_i),
                                    jnp.asarray(pair), m)
    got = hg._select_heuristic(_t(cand_d), _t(cand_i), _t(pair), m)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("heuristic", [True, False])
def test_bulk_level_edges_match_reference(heuristic):
    """One level of 400 members padded to 512."""
    r = np.random.default_rng(4)
    nl, real = 512, 400
    vecs = r.standard_normal((nl, D)).astype(np.float32)
    slots = np.where(np.arange(nl) < real, np.arange(nl), -1).astype(np.int32)
    norms = np.where(slots >= 0, (vecs * vecs).sum(1), np.inf
                     ).astype(np.float32)
    want = np.asarray(ref_hg._bulk_level_edges(
        jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(slots), M,
        heuristic))
    got = hg._bulk_level_edges(_t(vecs), _t(norms), _t(slots), M,
                               heuristic).numpy()
    assert _rows_equal(got, want) >= 0.99
    assert (got[real:] == -1).all() and (got[:real] >= 0).any(axis=1).all()


def test_bulk_build_matches_reference_with_slot0_on_a_padded_level():
    """1,500 members (levels padded to 2,048 / 256 / 32), slot 0 among them:
    a pad written through index 0 would clobber its fresh row."""
    ref, base, norms, _, slots, levels = _built()
    port = hg.bulk_build(hg.init_graph(2048, M, 3, "cpu"), _t(base),
                         _t(norms), slots, levels, m=M)
    _same_graph(port, ref)
    assert levels[0] >= 0 and (port.neighbors[0, 0] >= 0).sum() >= M // 2
    assert _rows_equal(port.neighbors[:, 0].numpy(),
                       np.asarray(ref.neighbors[:, 0])) == 1.0
    # rows of slots outside the build stay empty
    assert (port.neighbors[:, 1500:] == -1).all()


def test_insert_batch_matches_reference():
    """Rounds of 8 into a graph of 300 (slots from 1: the reference's
    connect scatters its masked targets through index 0, so slot 0 stays
    out of the comparison and has its own test below)."""
    ref, base, norms, _, slots, _ = _built(seed=5, n=300, cap=512,
                                           first_slot=1)
    port = _to_port(ref)
    r = np.random.default_rng(6)
    new = np.arange(301, 333, dtype=np.int32)
    base[new] = r.standard_normal((32, D)).astype(np.float32)
    norms = (base * base).sum(1)
    new_lv = _levels(7, 32, 3)
    new_lv[5] = 2
    for s in range(0, 32, 8):
        ref = ref_hg.insert_batch(
            ref, jnp.asarray(base), jnp.asarray(norms),
            jnp.asarray(new[s:s + 8]), jnp.asarray(new_lv[s:s + 8]), efc=32)
        hg.insert_batch(port, _t(base), _t(norms), new[s:s + 8],
                        new_lv[s:s + 8], efc=32)
    _same_graph(port, ref)
    linked = port.neighbors[0, torch.from_numpy(new).long()]
    assert ((linked >= 0).sum(1) >= 1).all()


def test_host_insert_stream_matches_reference():
    """A whole stream from the seed on: growth rounds 1, 2, then rounds of
    4 with a padded last one."""
    n, cap = 21, 128
    slots = np.arange(1, n + 1, dtype=np.int32)
    base, norms, _ = _store(8, cap, slots)
    levels = _levels(9, n, 2)
    ref = ref_hg.seed_first(ref_hg.init_graph(cap, M, 2),
                            jnp.asarray(slots[0]), jnp.asarray(levels[0]))
    ref = ref_hg.host_insert_stream(
        ref, jnp.asarray(base), jnp.asarray(norms), slots, levels, batch=4,
        live_before=1, efc=16)
    port = hg.seed_first(hg.init_graph(cap, M, 2, "cpu"), slots[0], levels[0])
    hg.host_insert_stream(port, _t(base), _t(norms), slots, levels, batch=4,
                          live_before=1, efc=16)
    _same_graph(port, ref, bar=1.0)


def test_connect_keeps_reverse_edges_of_slot0():
    """Slot 0 as a neighbor of a node whose list has pads: its reverse edge
    must survive (the masked targets do not write through index 0)."""
    cap = 128
    slots = np.arange(0, 6, dtype=np.int32)
    base, norms, _ = _store(10, cap, slots)
    g = hg.seed_first(hg.init_graph(cap, M, 2, "cpu"), 0, 0)
    hg.host_insert_stream(g, _t(base), _t(norms), slots,
                          np.zeros(6, np.int32), batch=2, live_before=1,
                          efc=16)
    nb = g.neighbors[0].numpy()
    for s in range(1, 6):
        if 0 in nb[s]:
            assert s in nb[0], (s, nb[0])
    assert (nb[0] >= 0).sum() >= 1


def test_bulk_insert_delta_matches_reference_with_slot0_in_the_batch():
    """100 new nodes (padded to 128 on level 0, to 8 above), store slot 0
    among them, into a graph of 600."""
    ref, base, norms, valid, _, _ = _built(seed=11, n=600, cap=1024,
                                           first_slot=1)
    port = _to_port(ref)
    r = np.random.default_rng(12)
    new = np.concatenate([[0], np.arange(601, 700)]).astype(np.int32)
    base[new] = r.standard_normal((100, D)).astype(np.float32)
    norms = (base * base).sum(1)
    valid[new] = True
    new_lv = _levels(13, 100, 3)
    new_lv[0] = 1
    ref = ref_hg.bulk_insert_delta(
        ref, jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid), new,
        new_lv, m=M)
    hg.bulk_insert_delta(port, _t(base), _t(norms), _t(valid), new, new_lv,
                         m=M)
    _same_graph(port, ref)
    for lev in (0, 1):
        row = port.neighbors[lev, 0].numpy()
        assert (row >= 0).sum() >= 1
        assert set(row) == set(np.asarray(ref.neighbors[lev, 0]))
    # the new nodes are reachable: old rows point at them
    old = port.neighbors[0, 1:601].numpy()
    assert np.isin(new, old).mean() >= 0.9


def test_delta_level_edges_ignores_pads_anywhere():
    """-1 pads at the head of ``new_slots`` write nothing (slot 0's row
    included) and the real slots connect as without them."""
    ref, base, norms, valid, _, _ = _built(seed=14, n=200, cap=256,
                                           first_slot=1)
    r = np.random.default_rng(15)
    new = np.asarray([0, 201, 202], np.int32)
    base[new] = r.standard_normal((3, D)).astype(np.float32)
    norms = (base * base).sum(1)
    valid[new] = True
    member = _t(valid)
    outs = []
    for padded in (np.concatenate([new, [-1] * 5]),
                   np.concatenate([[-1] * 5, new])):
        nb = _t(ref.neighbors)[0].clone()
        hg._delta_level_edges(nb, _t(base), _t(norms), member,
                              _t(padded.astype(np.int32)), m=M,
                              heuristic=True, c=2 * M + 2, rev_inc=M,
                              block_n=256)
        outs.append(nb.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0][0] >= 0).sum() >= 1


def test_unlink_slot_equals_reference():
    ref, *_ = _built(seed=16, n=300, cap=512)
    port = _to_port(ref)
    for slot in (0, 17, int(ref.entry)):
        ref = ref_hg.unlink_slot(ref, jnp.asarray(slot, jnp.int32))
        hg.unlink_slot(port, slot)
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))
    np.testing.assert_array_equal(port.levels.numpy(), np.asarray(ref.levels))


def _search_bars(got_i, want_i, base, valid, queries):
    live = np.flatnonzero(valid)
    d = ((queries[:, None, :].astype(np.float64) - base[live][None]) ** 2
         ).sum(-1)
    gt = live[np.argsort(d, axis=1)[:, :K]]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)])
    assert np.mean(got_i == want_i) >= 0.99
    assert recall(got_i) >= recall(want_i) - 0.005
    return recall(got_i)


@pytest.mark.parametrize("pending", [False, True])
def test_hnsw_search_matches_reference(pending):
    ref, base, norms, valid, _, _ = _built(seed=17)
    port = _to_port(ref)
    r = np.random.default_rng(18)
    queries = r.standard_normal((16, D)).astype(np.float32)
    valid = valid.copy()
    valid[r.choice(1500, 100, replace=False)] = False    # tombstones
    args = (jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid),
            jnp.asarray(queries))
    targs = (_t(base), _t(norms), _t(valid), _t(queries))
    if pending:
        # 40 rows outside the graph, visible only through the overlay
        pend = np.arange(1500, 1540, dtype=np.int32)
        base[pend] = queries[r.integers(0, 16, 40)] + 0.05 * r.standard_normal(
            (40, D)).astype(np.float32)
        norms = (base * base).sum(1)
        valid[pend] = True
        pend = np.concatenate([pend, np.full(24, -1, np.int32)])
        args = (jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid),
                jnp.asarray(queries))
        targs = (_t(base), _t(norms), _t(valid), _t(queries))
        want = ref_hg.hnsw_search_pending(ref, *args, jnp.asarray(pend), 16,
                                          64)
        got = hg.hnsw_search_pending(port, *targs, _t(pend), 16, 64)
    else:
        want = ref_hg.hnsw_search(ref, *args, 16, 64)
        got = hg.hnsw_search(port, *targs, 16, 64)
    got_i, want_i = got[1].numpy()[:, :K], np.asarray(want[1])[:, :K]
    rec = _search_bars(got_i, want_i, base, valid, queries)
    assert rec >= 0.8
    np.testing.assert_allclose(got[0].numpy()[:, :K][got_i == want_i],
                               np.asarray(want[0])[:, :K][got_i == want_i],
                               rtol=1e-4, atol=1e-5)
    assert valid[got_i[got_i >= 0]].all()
    if pending:
        assert (got_i >= 1500).any()


def test_loop_end_may_be_tested_every_few_steps(monkeypatch):
    """A step on a query that is no longer alive changes nothing: the beam
    and the descent give the same pool whether their end is tested every
    step or every fourth."""
    ref, base, norms, valid, _, _ = _built(seed=19, n=800, cap=1024)
    port = _to_port(ref)
    q = _t(np.random.default_rng(20).standard_normal((8, D)
                                                     ).astype(np.float32))
    outs = []
    for every in (1, 4, 7):
        monkeypatch.setattr(hg, "SYNC_EVERY", every)
        outs.append(hg.hnsw_search(port, _t(base), _t(norms), _t(valid), q,
                                   16, 48))
    for d, i in outs[1:]:
        np.testing.assert_array_equal(i.numpy(), outs[0][1].numpy())
        np.testing.assert_array_equal(d.numpy(), outs[0][0].numpy())


def test_sample_levels_is_geometric_and_seeded():
    gen = torch.Generator().manual_seed(5)
    lv = hg.sample_levels(gen, 20000, 8, 3).numpy()
    again = hg.sample_levels(torch.Generator().manual_seed(5), 20000, 8, 3)
    np.testing.assert_array_equal(lv, again.numpy())
    assert lv.min() == 0 and lv.max() == 2
    # P(level >= 1) = 1 / M
    assert abs((lv >= 1).mean() - 1 / 8) < 0.01
