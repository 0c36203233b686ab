"""The port's ADC table scans (vector_db_torch/ops/adc.py), its member table
(core/member_table.py) and the index's ``adc`` mode against the reference's,
on the same seeded inputs.

Tolerances.  Tables and distances: rtol 1e-5 (f32 sums in another order;
the one-hot product rounds the tables to bf16 in both packages).  Scans:
the same slots for at least 99% of the answers (two rows with equal codes
tie; under the one-hot product, whose bf16 tables make ties common, the
same set of slots a query).  ``adc_decode_topk`` against ``adc_scan_topk``: distances within the
bf16 rounding of the reconstruction, 2e-2 relative.  The member table is
held to equal arrays.  Whole index: mean top-10 overlap with the reference
>= 0.99 and recall against an exact oracle no lower than the reference's
minus 0.005.  The reference runs its decode kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.core import member_table as ref_mt  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import adc as ref_adc  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.core import member_table as mt  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import adc  # noqa: E402

D, N, CAP, K, S = 32, 3000, 4096, 10, 8


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _corpus(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, D)) * (np.arange(D) + 1.0) ** -0.5
            ).astype(np.float32)


@pytest.fixture(scope="module")
def coded():
    """Codebooks, codes, queries and a valid mask from a reference index."""
    base = _corpus(N, 41)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(
        num_subspaces=S, training_samples=1500, balance_dims=False))
    ref.add_batch(range(N), base)
    a = ref.state_arrays()
    valid = np.array(a["store"]["valid"])
    valid[np.random.default_rng(42).choice(N, 200, replace=False)] = False
    return dict(base=base, queries=_corpus(24, 43), codes=a["codes"],
                codebooks=a["codebooks"], valid=valid)


def test_build_distance_tables_match_reference(coded):
    want = np.asarray(ref_adc.build_distance_tables(
        jnp.asarray(coded["queries"]), jnp.asarray(coded["codebooks"])))
    got = adc.build_distance_tables(_t(coded["queries"]),
                                    _t(coded["codebooks"])).numpy()
    assert got.shape == (24, S, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the definition: squared distance of the query's subvector to the entry
    q_sub = coded["queries"].reshape(24, S, D // S)
    direct = ((q_sub[:, :, None, :] - coded["codebooks"][None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)


def _tables(coded):
    t = np.asarray(ref_adc.build_distance_tables(
        jnp.asarray(coded["queries"]), jnp.asarray(coded["codebooks"])))
    return t


@pytest.mark.parametrize("impl,block_n", [("gather", 4096), ("gather", 1000),
                                          ("onehot", 4096), ("onehot", 512)])
def test_adc_scan_topk_matches_reference(coded, impl, block_n):
    """Blocks that divide the capacity, and ragged ones (the port slices the
    last block short where the reference pads the codes)."""
    tables = _tables(coded)
    want_d, want_i = (np.asarray(x) for x in ref_adc.adc_scan_topk(
        jnp.asarray(tables), jnp.asarray(coded["codes"]),
        jnp.asarray(coded["valid"]), 64, block_n=block_n, impl=impl))
    got_d, got_i = (x.numpy() for x in adc.adc_scan_topk(
        _t(tables), _t(coded["codes"]), _t(coded["valid"]), 64,
        block_n=block_n, impl=impl))
    # bf16 tables make equal distances common: there the order is the
    # selection's own, so the one-hot scan is held to the same set a row
    same = (np.mean(got_i == want_i) if impl == "gather" else
            np.mean([len(set(a) & set(b)) / 64
                     for a, b in zip(got_i, want_i)]))
    assert same >= 0.99
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert coded["valid"][got_i].all() and np.all(np.diff(got_d, axis=1) >= 0)


def test_adc_scan_pads_with_minus_one(coded):
    valid = np.zeros(CAP, bool)
    valid[:5] = True
    d, i = adc.adc_scan_topk(_t(_tables(coded)), _t(coded["codes"]),
                             _t(valid), 8)
    assert (i[:, 5:] == -1).all() and torch.isinf(d[:, 5:]).all()
    assert (np.sort(i[:, :5].numpy(), axis=1) == np.arange(5)).all()


def test_adc_distances_match_reference(coded):
    tables = _tables(coded)
    codes = coded["codes"][:500]
    want = np.asarray(ref_adc.adc_distances(jnp.asarray(tables),
                                            jnp.asarray(codes)))
    got = adc.adc_distances(_t(tables), _t(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    onehot = adc._adc_block_onehot(_t(tables), _t(codes)).numpy()
    np.testing.assert_allclose(onehot, got, rtol=2e-2)   # bf16 tables


@pytest.mark.parametrize("with_norms", [False, True])
def test_adc_decode_topk_matches_reference_and_the_table_scan(coded,
                                                              with_norms):
    codes_t = np.ascontiguousarray(coded["codes"].T)
    cbt_ref = ref_adc.codebooks_to_cbt(jnp.asarray(coded["codebooks"]))
    cbt = adc.codebooks_to_cbt(_t(coded["codebooks"]))
    norms = None
    if with_norms:
        norms = np.asarray(ref_adc.code_norms_from_codes(
            jnp.asarray(codes_t), cbt_ref, jnp.ones(CAP, bool)))
    want_d, want_i = (np.asarray(x) for x in ref_adc.adc_decode_topk(
        jnp.asarray(coded["queries"]), jnp.asarray(codes_t), cbt_ref,
        jnp.asarray(coded["valid"]), 32,
        code_norms=None if norms is None else jnp.asarray(norms)))
    got_d, got_i = (x.numpy() for x in adc.adc_decode_topk(
        _t(coded["queries"]), _t(codes_t), cbt, _t(coded["valid"]), 32,
        code_norms=None if norms is None else _t(norms)))
    assert np.mean(got_i == want_i) >= 0.99
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-5)
    # the same ADC distances as the table scan, up to the bf16 rounding of
    # the reconstruction
    scan_d, scan_i = (x.numpy() for x in adc.adc_scan_topk(
        _t(_tables(coded)), _t(coded["codes"]), _t(coded["valid"]), 32))
    np.testing.assert_allclose(got_d, scan_d, rtol=2e-2, atol=1e-3)
    overlap = np.mean([len(set(a) & set(b)) / 32
                       for a, b in zip(got_i, scan_i)])
    assert overlap >= 0.95


@pytest.mark.parametrize("case", ["even", "spill", "multi", "empty"])
def test_member_table_equals_reference(case):
    r = np.random.default_rng(44)
    cap, c = 2048, 16
    valid = r.uniform(size=cap) > 0.1
    if case == "even":
        assign = r.integers(0, c, cap)
    elif case == "spill":
        # one cluster holds 60% of the rows: past the quota they spill
        assign = np.where(r.uniform(size=cap) < 0.6, 3, r.integers(0, c, cap))
    elif case == "multi":
        assign = r.integers(-1, c, (cap, 3))
    else:
        assign = np.full(cap, -1)
    want = ref_mt.build_member_table(assign, valid, c)
    got = mt.build_member_table(assign, valid, c)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    if case == "spill":
        over = got[2][got[2] >= 0]
        assert over.size > 0 and (np.asarray(assign)[over] == 3).all()
        # every live assigned row is in the table or the overflow, once
        seen = np.concatenate([got[0][got[0] >= 0], over])
        np.testing.assert_array_equal(np.sort(seen), np.flatnonzero(valid))


# ------------------------------------------------------------ whole index
def _oracle(rows: dict, queries, metric="l2"):
    ids = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in ids]).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = ((q[:, None, :] - mat[None]) ** 2).sum(-1)
    return ids[np.argsort(d, axis=1)[:, :K]]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


def _compare(ref, port, queries, rows, metric="l2"):
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, port_d = port.search_batch(torch.from_numpy(queries), K)
    gt = _oracle(rows, queries, metric)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)
    return _overlap(port_ids, gt)


@pytest.mark.parametrize("store,nlist,metric", [
    ("raw", 0, "l2"), ("raw", 16, "l2"), ("raw", 16, "cosine"),
    ("raw", 0, "cosine"), ("int8_resid", 0, "l2"), ("int8_resid", 16, "l2"),
    ("int8", 16, "l2")])
def test_adc_mode_matches_reference_before_and_after_churn(store, nlist,
                                                           metric):
    """search_mode="adc": exhaustive (flagship_search) and, with nlist,
    pruned through the member table (flagship_search_pruned), on the raw and
    the compressed store; the port loads the reference's trained state."""
    cfg = dict(num_subspaces=S, training_samples=1500, search_mode="adc",
               refine_k=128, nlist=nlist, nprobe=8)
    if store != "raw":
        cfg.update(raw_store=False, refine_residual=store == "int8_resid")
    base = _corpus(N, 45)
    queries = _corpus(24, 46)
    ref = ref_hp.HnswPqIndex(D, CAP, metric, RefConfig(**cfg))
    if store == "raw":
        ref.add_batch(range(N), base)
    else:
        ref.bulk_load_stream([(range(s, s + 1500), base[s:s + 1500])
                              for s in range(0, N, 1500)])
    port = hp.HnswPqIndex(D, CAP, metric, HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    assert port.adc_impl == ref.adc_impl == "onehot"
    rows = dict(enumerate(base))
    rec = _compare(ref, port, queries, rows, metric)
    assert rec >= (0.9 if nlist == 0 else 0.6)
    r = np.random.default_rng(47)
    for vid in r.choice(N, 150, replace=False).tolist():
        assert port.remove(vid) == ref.remove(vid)
        del rows[vid]
    new = _corpus(100, 48)
    new_ids = list(range(10_000, 10_100))
    assert port.add_batch(new_ids, new) == ref.add_batch(new_ids, new)
    rows.update(zip(new_ids, new))
    if nlist:
        np.testing.assert_array_equal(port.coarse_assign, ref.coarse_assign)
        for got, want in zip(port._member_table(), ref._member_table()):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _compare(ref, port, queries, rows, metric)


def test_member_table_follows_its_dirty_flag():
    cfg = dict(num_subspaces=S, training_samples=1500, search_mode="adc",
               nlist=8, nprobe=4, refine_k=64)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    base = _corpus(1000, 49)
    port.add_batch(range(1000), base)
    members = port._caches.members
    assert members.value is None             # void: built at the search
    port.search_batch(base[:2], K)
    table = members.value[0]
    assert table is not None and members.value is not None
    port.search_batch(base[:2], K)
    assert members.value[0] is table         # reused while nothing moved
    port.remove(5)
    assert members.value is None             # voided by the remove
    ids, _ = port.search_batch(base[5:6], K)
    assert members.value[0] is not table and 5 not in ids[0]
    assert 5 not in members.value[0].numpy() \
        and 5 not in members.value[2].numpy()
