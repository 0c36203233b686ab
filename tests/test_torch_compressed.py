"""The port's compressed tier (raw_store=False) against the reference's:
int8 row packing, the int8 and bf16 refines, the exhaustive int8 scan, the
compressed store and its streamed ingest, the index in every mode it serves
(before and after churn), its caches, and the facade (no WAL, checkpoints
that cross between the packages).

Inputs are seeded numpy arrays given to both packages; the reference runs
its Pallas kernels in interpret mode.  Bars: ``pack_int8_rows`` equal word
for word; the stores' ids and valid equal, norms within rtol 1e-6 (f32 sums
in another order), scales within rtol 1e-6 and int8 entries (both levels)
within 1 in at most 0.1% of entries (inside its fused write the reference's
XLA computes ``amax / 127`` as ``amax * (1/127)``, one ulp off the
division, which can move a rounding tie); refines and scans return equal ids
and distances within rtol 1e-5 on tie-free data; searches overlap the
reference's top-10 by >= 0.99 on average and reach its recall against an
exact oracle less 0.005.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import vector_db_tpu as ref_vdb  # noqa: E402
from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.core.store import VectorStore as RefStore  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import distance as ref_dist  # noqa: E402
from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.core.store import VectorStore  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import distance as dist  # noqa: E402

D, N, CAP, K, S = 32, 4000, 4096, 10, 8
CHUNK = 2000


def _corpus(n, seed, d=D, offset=0.0):
    """Decaying-spectrum rows (embedding-like), float32."""
    r = np.random.default_rng(seed)
    scale = (np.arange(d) + 1.0) ** -0.5
    return (r.standard_normal((n, d)) * scale + offset).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _chunks(vecs, ids=None):
    ids = np.arange(len(vecs)) if ids is None else np.asarray(ids)
    return [(ids[s:s + CHUNK], vecs[s:s + CHUNK])
            for s in range(0, len(vecs), CHUNK)]


def _oracle(rows: dict, queries, metric="l2"):
    ids = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in ids]).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        d = -(q / np.linalg.norm(q, axis=1, keepdims=True)) @ mat.T
    else:
        d = ((q[:, None, :] - mat[None]) ** 2).sum(-1)
    return ids[np.argsort(d, axis=1)[:, :K]]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


# --------------------------------------------------------------- packing
def test_pack_int8_rows_words_and_scales_equal_reference():
    r = np.random.default_rng(0)
    x = (r.standard_normal((300, 64)) * r.uniform(0.01, 30, (300, 1))
         ).astype(np.float32)
    x[7] = 0.0  # the 1e-30 scale floor
    jw, js = ref_dist.pack_int8_rows(jnp.asarray(x))
    tw, ts = dist.pack_int8_rows(_t(x))
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (300, 16)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dist.unpack_int8_rows(tw, ts).numpy(),
        np.asarray(ref_dist.unpack_int8_rows(jw, js)))


def test_pack_int8_residual_matches_reference():
    x = _corpus(2000, 1, d=64)
    jw, js = ref_dist.pack_int8_rows(jnp.asarray(x))
    jr, jrs = ref_dist.pack_int8_residual(jnp.asarray(x), jw, js)
    tr, trs = dist.pack_int8_residual(_t(x), _t(jw), _t(js))
    a = tr.contiguous().view(torch.int8).numpy().astype(np.int32)
    b = np.asarray(jr).view(np.int8).astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(trs.numpy(), np.asarray(jrs), rtol=1e-6)


# -------------------------------------------------------- refines, scans
def _int8_store(n, d, seed, residual):
    x = _corpus(n, seed, d=d, offset=0.3)
    packed, scales = ref_dist.pack_int8_rows(jnp.asarray(x))
    out = dict(x=x, packed=np.array(packed), scales=np.array(scales),
               norms=(x * x).sum(1), resid=None, rscales=None)
    if residual:
        rp, rs = ref_dist.pack_int8_residual(jnp.asarray(x), packed, scales)
        out.update(resid=np.array(rp), rscales=np.array(rs))
    return out


def _assert_same_topk(tw, jw, rtol=1e-5):
    td, ti = (t.numpy() for t in tw)
    jd, ji = (np.asarray(j) for j in jw)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("with_norms", [False, True])
def test_blocked_rerank_int8_matches_reference(metric, residual, with_norms):
    st = _int8_store(3000, 64, 2, residual)
    r = np.random.default_rng(3)
    q = _corpus(12, 4, d=64, offset=0.3)
    cand = r.integers(-1, 3000, (12, 300)).astype(np.int32)
    kw = dict(b_norms=st["norms"] if with_norms else None,
              resid=st["resid"], rscales=st["rscales"])
    want = ref_dist.blocked_rerank_int8(
        jnp.asarray(q), jnp.asarray(st["packed"]), jnp.asarray(st["scales"]),
        jnp.asarray(cand), K, metric, rb=128,
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = dist.blocked_rerank_int8(
        _t(q), _t(st["packed"]), _t(st["scales"]), _t(cand), K, metric,
        rb=128, **{k: None if v is None else _t(v) for k, v in kw.items()})
    _assert_same_topk(got, want)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("residual", [False, True])
def test_blocked_knn_int8_matches_reference(metric, residual):
    st = _int8_store(5000, 32, 5, residual)
    valid = np.random.default_rng(6).uniform(size=5000) > 0.1
    q = _corpus(9, 7, offset=0.3)
    kw = dict(b_norms=st["norms"], resid=st["resid"], rscales=st["rscales"])
    # block_n 2048 does not divide 5000: the clamped ragged last block
    want = ref_dist.blocked_knn_int8(
        jnp.asarray(q), jnp.asarray(st["packed"]), jnp.asarray(st["scales"]),
        jnp.asarray(valid), K, metric, block_n=2048, recall_target=1.0,
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = dist.blocked_knn_int8(
        _t(q), _t(st["packed"]), _t(st["scales"]), _t(valid), K, metric,
        block_n=2048,
        **{k: None if v is None else _t(v) for k, v in kw.items()})
    _assert_same_topk(got, want)
    assert valid[got[1].numpy()].all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_blocked_rerank_packed_matches_reference(metric):
    x = _corpus(2000, 8, d=64, offset=0.3)
    q = _corpus(10, 9, d=64, offset=0.3)
    cand = np.random.default_rng(10).integers(-1, 2000, (10, 200)).astype(
        np.int32)
    want = ref_dist.blocked_rerank_packed(
        jnp.asarray(q), ref_dist.pack_bf16_rows(jnp.asarray(x)),
        jnp.asarray(cand), K, metric, rb=128)
    got = dist.blocked_rerank(_t(q), dist.pack_bf16_rows(_t(x)), _t(cand),
                              K, metric, rb=128)
    _assert_same_topk(got, want)


# ------------------------------------------------------------------ store
def _assert_same_store(got: dict, want: dict, residual: bool):
    assert set(got) == set(want)
    for key in ("ids", "valid"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    levels = [("packed8", "scales8")] + (
        [("resid8", "rscales8")] if residual else [])
    for (words, scales), rtol in zip(levels, (1e-6, 1e-4)):
        # a first-level scale one ulp apart moves the residual, ~1/254 of
        # the row, by up to ~254 ulp: rtol 1e-4 on the second level's scale
        np.testing.assert_allclose(got[scales], want[scales], rtol=rtol)
        diff = np.abs(got[words].view(np.int8).astype(np.int32)
                      - np.asarray(want[words]).view(np.int8).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("residual", [False, True])
def test_compressed_store_same_slots_and_snapshot(residual):
    r = np.random.default_rng(11)
    ref = RefStore(300, 16, raw=False, residual=residual)
    port = VectorStore(300, 16, raw=False, device="cpu", residual=residual)
    assert port.capacity == ref.capacity == 2048
    for step in [("add", list(range(40)), r.standard_normal((40, 16))),
                 ("remove", [3, 9, 1000]),
                 ("add", [3, 50, 50, -2, 51], r.standard_normal((5, 16))),
                 ("remove", [0])]:
        if step[0] == "add":
            v = step[2].astype(np.float32)
            assert port.add_batch(step[1], v) == ref.add_batch(step[1], v)
        else:
            for vid in step[1]:
                assert port.remove(vid) == ref.remove(vid)
    assert port._id_to_slot == ref._id_to_slot and port._free == ref._free
    got, want = port.to_host(), ref.to_host()
    assert set(got) == set(want)
    _assert_same_store(got, want, residual)
    np.testing.assert_allclose(port.get(50), np.asarray(ref.get(50)),
                               rtol=1e-4, atol=1e-6)
    back = VectorStore.from_host(want, device="cpu")
    assert not back.raw and back._id_to_slot == ref._id_to_slot
    assert back.version == 0 and back.add_batch([500], np.ones((1, 16))) == (
        [500], [ref._free[-1]])


# -------------------------------------------------------- streamed ingest
def _ref_index(residual, mode="auto", cap=CAP, **kw):
    return ref_hp.HnswPqIndex(D, cap, "l2", RefConfig(
        raw_store=False, num_subspaces=S, training_samples=1500,
        refine_residual=residual, search_mode=mode, adc_pool="approx",
        adc_select_r=128, **kw))


def _port_index(residual, mode="auto", cap=CAP, metric="l2", **kw):
    return hp.HnswPqIndex(D, cap, metric, HnswPqConfig(
        raw_store=False, num_subspaces=S, training_samples=1500,
        refine_residual=residual, search_mode=mode, adc_pool="approx",
        adc_select_r=128, **kw), device="cpu")


@pytest.fixture(scope="module", params=[False, True], ids=["int8", "resid"])
def streamed(request):
    """(residual, reference state_arrays after bulk_load_stream, corpus)."""
    vecs = _corpus(N, 12)
    ref = _ref_index(request.param)
    assert ref.bulk_load_stream(_chunks(vecs)) == N
    return request.param, ref.state_arrays(), vecs


def test_stream_writes_the_reference_store_and_codes(streamed):
    residual, arrays, vecs = streamed
    port = _port_index(residual)
    # the reference's codebooks carried across: the codes must match too
    port.codebooks = _t(arrays["codebooks"])
    port.perm = _t(arrays["perm"])
    port.trained = True
    assert port.bulk_load_stream(
        [(i, _t(v)) for i, v in _chunks(vecs)]) == N
    got, want = port.store.to_host(), arrays["store"]
    _assert_same_store(got, want, residual)
    np.testing.assert_array_equal(port.codes.numpy(), arrays["codes"])
    assert port.store._free == list(range(CAP - 1, N - 1, -1))


@pytest.mark.parametrize("case", ["dup_across", "capacity", "small_first"])
def test_stream_validation_matches_reference(case):
    vecs = _corpus(2400, 13)
    chunks = {
        "dup_across": [(range(0, 300), vecs[:300]),
                       (range(290, 590), vecs[300:600])],
        "capacity": [(range(0, 1200), vecs[:1200]),
                     (range(1200, 2400), vecs[1200:])],
        "small_first": [(range(0, 100), vecs[:100])],
    }[case]
    ref = _ref_index(False, cap=2048, training_iterations=2)
    port = _port_index(False, cap=2048, training_iterations=2)
    with pytest.raises(ValueError) as want:
        ref.bulk_load_stream(chunks)
    with pytest.raises(ValueError) as got:
        port.bulk_load_stream(chunks)
    assert str(got.value) == str(want.value)
    # what was written before the raise stays consistent, as in the reference
    assert port.size() == ref.size()
    assert port.store._free == ref.store._free


# ------------------------------------------------------------------ index
def _pair(arrays, residual, mode):
    ref = _ref_index(residual, mode)
    ref.load_state_arrays(arrays)
    port = _port_index(residual, mode)
    port.load_state_arrays(arrays)
    return ref, port


def _compare(ref, port, queries, rows):
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, port_d = port.search_batch(_t(queries), K)
    gt = _oracle(rows, queries)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)


@pytest.mark.parametrize("mode", ["auto", "scan_pallas_int8", "scan_int8"])
def test_compressed_index_matches_reference_before_and_after_churn(
        streamed, mode):
    residual, arrays, vecs = streamed
    ref, port = _pair(arrays, residual, mode)
    assert not port.store.raw
    queries = _corpus(32, 14)
    rows = {i: vecs[i] for i in range(N)}
    _compare(ref, port, queries, rows)
    r = np.random.default_rng(15)
    for vid in r.choice(N, 200, replace=False).tolist():
        assert port.remove(vid) == ref.remove(vid)
        del rows[vid]
    new = _corpus(150, 16)
    new_ids = list(range(20_000, 20_150))
    assert port.add_batch(new_ids, new) == ref.add_batch(new_ids, new)
    rows.update(zip(new_ids, new))
    np.testing.assert_array_equal(port.codes.numpy(),
                                  np.asarray(ref.state_arrays()["codes"]))
    _compare(ref, port, queries, rows)


def test_untrained_compressed_index_scans_int8_exactly():
    vecs = _corpus(200, 17)
    ref, port = _ref_index(True), _port_index(True)
    ref.add_batch(range(200), vecs)
    port.add_batch(range(200), vecs)
    assert not port.trained and not ref.trained
    q = _corpus(16, 18)
    ref_ids, ref_d = ref.search_batch(q, K)
    port_ids, port_d = port.search_batch(_t(q), K)
    np.testing.assert_array_equal(port_ids, ref_ids)
    np.testing.assert_allclose(port_d, ref_d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["adc_fast", "scan_pallas_int8"])
def test_caches_follow_adds_and_deletes(mode):
    """The ADC tables and the packed-scan conditioning are keyed on
    version counters: after training and a first search, a far-off row
    added through the facade is found, and is gone once deleted (identity
    keys never change under in-place writes: the caches would score the
    old rows)."""
    db = _db()
    db.index.config.search_mode = mode
    db.bulk_load_stream(_chunks(_corpus(N, 19)))
    db.search_batch(_corpus(4, 20), K)  # builds the caches
    far = np.full(D, 4.0, np.float32)
    assert db.add_vector(77_777, far)
    assert db.search(far, K)[0].id == 77_777
    assert db.delete_vector(77_777)
    assert 77_777 not in [r.id for r in db.search(far, K)]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan8p_shadow_matches_reference(metric):
    st = _int8_store(5000, D, 25, False)
    valid = np.random.default_rng(26).uniform(size=5000) > 0.2
    want = ref_hp._build_scan8p_shadow(
        jnp.asarray(st["packed"]), jnp.asarray(st["scales"]),
        jnp.asarray(st["norms"]), jnp.asarray(valid), metric)
    got = hp._build_scan8p_shadow(_t(st["packed"]), _t(st["scales"]),
                                  _t(st["norms"]), _t(valid), metric)
    off, sc, cvec = (g.numpy() for g in got)
    np.testing.assert_array_equal(np.isfinite(off), valid)
    # 5000 rows: the reference's pass covers whole 128-row blocks only
    # (4992 rows; its stores are 128-rounded), the port's covers every row
    head = valid & (np.arange(5000) < 4992)
    np.testing.assert_allclose(off[head], np.asarray(want[0])[head],
                               rtol=1e-5, atol=1e-6)
    v8 = st["packed"].view(np.int8).reshape(5000, D).astype(np.float64)
    corr = v8 @ cvec.astype(np.float64)
    tail = valid & ~head
    np.testing.assert_allclose(off[tail], (sc * corr + (
        st["norms"] if metric == "l2" else 0.0))[tail], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sc, np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(cvec, np.asarray(want[2]), rtol=1e-5,
                               atol=1e-7)


def test_cosine_compressed_index_matches_reference():
    r = np.random.default_rng(27)
    vecs = (_corpus(N, 28) + 0.2) * r.uniform(0.5, 3.0, (N, 1)).astype(
        np.float32)
    ref = ref_hp.HnswPqIndex(D, CAP, "cosine", RefConfig(
        raw_store=False, num_subspaces=S, training_samples=1500,
        refine_residual=True, adc_pool="approx", adc_select_r=128))
    ref.bulk_load_stream(_chunks(vecs))
    arrays = ref.state_arrays()
    queries = _corpus(32, 29) + 0.2
    gt = _oracle(dict(enumerate(vecs)), queries, "cosine")
    for mode in ("auto", "scan_pallas_int8", "scan_int8"):
        ref.config.search_mode = mode
        port = _port_index(True, mode, metric="cosine")
        port.load_state_arrays(arrays)
        ref_ids, _ = ref.search_batch(queries, K)
        port_ids, _ = port.search_batch(_t(queries), K)
        assert _overlap(port_ids, ref_ids) >= 0.99, mode
        assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005


def test_constructor_errors_match_reference():
    cases = [(30, dict()), (D, dict(use_graph=True))] + [
        (D, dict(search_mode=m)) for m in ("scan_exact", "scan_pallas",
                                           "scan_bf16", "graph")]
    for dim, kw in cases:
        with pytest.raises(ValueError) as want:
            ref_hp.HnswPqIndex(dim, 1024, "l2", RefConfig(raw_store=False,
                                                          **kw))
        with pytest.raises(ValueError) as got:
            hp.HnswPqIndex(dim, 1024, "l2", HnswPqConfig(raw_store=False,
                                                         **kw), device="cpu")
        assert str(got.value) == str(want.value)
    port = _port_index(False)
    assert port.config.refine_store == "int8"
    for mode in ("pca", "adc"):   # the modes a compressed store may take
        assert _port_index(False, mode=mode).config.search_mode == mode


def test_compressed_stats_report_resident_bytes():
    port = _port_index(True)
    s = port.stats()
    st = port.store.state
    assert s["raw_store"] is False
    assert s["store_bytes"] == sum(t.nbytes for t in (
        st.packed, st.scales, st.norms, st.resid, st.rscales))
    assert s["store_bytes"] == _ref_index(True).stats()["store_bytes"]
    assert s["store_bytes"] < s["raw_bytes"]


# ----------------------------------------------------------------- facade
def _db(path=None, residual=False, dev="cpu"):
    b = (VectorDatabase.builder().with_dimension(D).with_max_elements(CAP)
         .with_index_type(IndexType.HNSWPQ)
         .with_index_config(HnswPqConfig(
             raw_store=False, num_subspaces=S, training_samples=1500,
             refine_residual=residual, adc_pool="approx", adc_select_r=128))
         .with_device(dev))
    if path:
        b = b.with_storage_path(path)
    return b.build()


def test_facade_opens_no_wal_and_checkpoints_the_stream(tmp_store_path):
    vecs = _corpus(4096, 21)
    db = _db(tmp_store_path, residual=True)
    assert db._engine is None
    assert not os.path.exists(os.path.join(tmp_store_path, "wal"))
    assert db.bulk_load_stream(_chunks(vecs)) == 4096
    assert os.path.exists(os.path.join(tmp_store_path, "arrays.npz"))
    db.delete_vector(5)
    q = _corpus(16, 22)
    before = [[r.id for r in row] for row in db.search_batch(q, K)]
    db.close()
    db2 = _db(tmp_store_path, residual=True)
    assert db2.size() == 4095 and not db2.index.store.raw
    assert db2.get_vector(5) is None
    assert [[r.id for r in row] for row in db2.search_batch(q, K)] == before
    np.testing.assert_allclose(db2.get_vector(7).values, vecs[7],
                               atol=1e-3 * np.abs(vecs[7]).max())
    assert not os.path.exists(os.path.join(tmp_store_path, "wal"))
    db2.close()


def test_reference_compressed_checkpoint_loads_with_same_ids(tmp_store_path):
    vecs = _corpus(4096, 23)
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(D)
           .with_max_elements(CAP).with_index_type(ref_vdb.IndexType.HNSWPQ)
           .with_index_config(RefConfig(
               raw_store=False, num_subspaces=S, training_samples=1500,
               refine_residual=True, adc_pool="approx", adc_select_r=128))
           .with_storage_path(tmp_store_path).build())
    ref.bulk_load_stream(_chunks(vecs))
    for vid in range(0, 4096, 9):
        ref.delete_vector(vid)
    q = _corpus(24, 24)
    want = [[r.id for r in row] for row in ref.search_batch(q, K)]
    size = ref.size()
    ref.close()
    port = _db(tmp_store_path, residual=True)
    assert port.size() == size and port.index.trained
    assert port.index.store.state.resid is not None
    got = [[r.id for r in row] for row in port.search_batch(q, K)]
    assert got == want
