"""The port's CRUD against a numpy oracle (a copy of the reference's
``tests/test_oracle_fuzz.py``): interleaved add / delete / re-add / reload
waves through ``vector_db_torch.VectorDatabase`` on the CPU, with the search
results held after every wave to a float64 brute force over the live set.

Exact modes must return the oracle's top-k SET (within the scale-aware tie
band), which catches slot reuse, stale incremental shadows and tombstones as
wrong neighbours; the int8-compressed tier must keep recall >= 0.9.  A
second test runs the same seeded schedule through both packages side by
side: the exact modes' id sets agree with the reference's, apart from ids
inside the oracle's tie band, and the distances of the ids both return
agree within 1e-4 of the distance scale.

The module caps torch's intra-op threads (see ``_few_threads``): these are
many tiny searches, and under a parallel test run more threads than cores
only oversubscribe the machine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_db_torch  # noqa: E402
import vector_db_tpu as ref_vdb  # noqa: E402

DIM, CAP, K = 16, 1024, 5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _oracle_topk(live: dict, q: np.ndarray, k: int,
                 metric: str = "l2") -> list[tuple[set, set, set]]:
    """Per query: (topk, must, ok) id sets from a float64 oracle.

    ``must`` (inside the top-k by more than eps) has to appear in any
    correct exact result; ``ok`` (within eps of the k-th) is the set a
    correct exact result may draw from.  eps is scale-aware: sq-L2 through
    the f32 norm identity cancels to ~1e-6 of the distance scale."""
    ids = np.fromiter(live.keys(), np.int64)
    mat = np.stack([live[i] for i in ids]).astype(np.float64)
    q64 = q.astype(np.float64)
    if metric == "cosine":
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        mn = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        d = 1.0 - qn @ mn.T
    else:
        d = ((q64[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
    out = []
    for row in d:
        order = np.argsort(row, kind="stable")[:k]
        kth = row[order[-1]]
        eps = 1e-4 * (1.0 + abs(kth))
        must = set(ids[np.flatnonzero(row < kth - eps)].tolist())
        ok = set(ids[np.flatnonzero(row <= kth + eps)].tolist())
        out.append((set(ids[order].tolist()), must, ok))
    return out


def _queries(live, rng, qn=12):
    pick = rng.choice(np.fromiter(live.keys(), np.int64), qn)
    return np.stack([live[i] for i in pick]) + 0.01 * rng.standard_normal(
        (qn, DIM)).astype(np.float32)


def _check_exact(got, live, oracle_row, tag):
    _, must, ok = oracle_row
    assert got <= set(live.keys()) | {-1}, f"{tag}: dead ids {got}"
    assert got <= ok and len(got) == min(K, len(live)), (
        f"{tag}: exact mode diverged from oracle: got {sorted(got)} "
        f"allowed {sorted(ok)}")
    assert must <= got, (
        f"{tag}: exact mode dropped clear top-k members "
        f"{sorted(must - got)}")


def _check(db, live, rng, exact: bool, tag: str, metric: str = "l2"):
    q = _queries(live, rng)
    oracle = _oracle_topk(live, q, K, metric)
    hits = 0
    for i in range(len(q)):
        got = {r.id for r in db.search(q[i], K)}
        assert got <= set(live.keys()) | {-1}, f"{tag}: dead ids {got}"
        if exact:
            _check_exact(got, live, oracle[i], tag)
        else:
            hits += len(got & oracle[i][0])
    if not exact:
        assert hits / (len(q) * K) >= 0.9, f"{tag}: recall {hits / (len(q) * K)}"


def _cfg(pkg, **kw):
    return pkg.HnswPqConfig(num_subspaces=4, num_centroids=16,
                            training_samples=64, **kw)


#: (tag, index type, config keywords or None, exact, metric)
MODES = [
    ("brute", "BRUTE", None, True, "l2"),
    ("scan_exact", "HNSWPQ",
     dict(search_mode="scan_exact", scan_recall_target=1.0), True, "l2"),
    # the int8 selection shadow under churn, exact f32 refine
    ("scan_pallas_int8_raw", "HNSWPQ",
     dict(search_mode="scan_pallas_int8"), True, "l2"),
    # compressed tier: every row representation is quantized -> recall
    ("compressed_fused", "HNSWPQ",
     dict(raw_store=False, search_mode="scan_pallas_int8"), False, "l2"),
    # the two-level int8 residual refine is far below the tie epsilon
    ("compressed_residual", "HNSWPQ",
     dict(raw_store=False, refine_residual=True,
          search_mode="scan_pallas_int8"), True, "l2"),
    ("cosine_exact", "HNSWPQ",
     dict(search_mode="scan_exact", scan_recall_target=1.0), True, "cosine"),
    ("cosine_compressed", "HNSWPQ",
     dict(raw_store=False, search_mode="scan_pallas_int8"), False, "cosine"),
]
EXACT_MODES = [m for m in MODES if m[3]]


def _builder(pkg, itype, cfg, metric, path, device=None):
    b = (pkg.VectorDatabase.builder().with_dimension(DIM)
         .with_max_elements(CAP).with_index_type(getattr(pkg.IndexType, itype))
         .with_metric(metric).with_storage_path(path))
    if cfg is not None:
        b = b.with_index_config(_cfg(pkg, **cfg))
    if device is not None:
        b = b.with_device(device)
    return b


def _waves(rng, live, deleted_pool, next_id):
    """The reference's schedule: add -> delete -> re-add -> reload -> add
    -> delete, operands drawn from ``rng``.  Yields (op, payload); the
    first wave passes the 128-row floor so every op runs as itself."""
    for op in (0, 1, 2, 3, 0, 1):
        if op == 0 or len(live) < 128:
            n = int(rng.integers(160, 224))
            vecs = rng.standard_normal((n, DIM)).astype(np.float32)
            ids = list(range(next_id, next_id + n))
            next_id += n
            live.update(zip(ids, vecs))
            yield 0, (ids, vecs)
        elif op == 1:
            victims = rng.choice(np.fromiter(live.keys(), np.int64),
                                 min(40, len(live) // 2), replace=False)
            for v in victims.tolist():
                del live[v]
                deleted_pool.append(v)
            yield 1, victims.tolist()
        elif op == 2 and deleted_pool:
            n = min(16, len(deleted_pool))
            ids = [deleted_pool.pop() for _ in range(n)]
            vecs = rng.standard_normal((n, DIM)).astype(np.float32)
            live.update(zip(ids, vecs))
            yield 2, (ids, vecs)
        else:
            yield 3, None


def _apply(db, builder, op, payload, live, tag):
    """One wave on one database; returns the database (a new one after a
    reload)."""
    if op in (0, 2):
        ids, vecs = payload
        assert len(db.add_batch(ids, vecs)) == len(ids), (
            f"{tag}: add or re-add rejected")
    elif op == 1:
        for v in payload:
            assert db.delete_vector(v)
    else:
        db.close()
        db = builder.build()
        assert db.size() == len(live), f"{tag}: reload lost rows"
    return db


@pytest.mark.parametrize("tag,itype,cfg,exact,metric", MODES,
                         ids=[m[0] for m in MODES])
def test_crud_oracle_fuzz(tag, itype, cfg, exact, metric, tmp_path):
    rng = np.random.default_rng(1234)
    b = _builder(vector_db_torch, itype, cfg, metric,
                 str(tmp_path / tag), device="cpu")
    db = b.build()
    live: dict[int, np.ndarray] = {}
    ran = set()
    for phase, (op, payload) in enumerate(_waves(rng, live, [], 0)):
        ran.add(op)
        db = _apply(db, b, op, payload, live, tag)
        _check(db, live, rng, exact, f"{tag}/phase{phase}", metric)
    assert ran == {0, 1, 2, 3}, (
        f"{tag}: op schedule silently skipped ops {sorted({0,1,2,3} - ran)}")
    db.close()


@pytest.mark.parametrize("tag,itype,cfg,exact,metric", EXACT_MODES,
                         ids=[m[0] for m in EXACT_MODES])
def test_crud_schedule_matches_reference(tag, itype, cfg, exact, metric,
                                         tmp_path):
    """The same seeded schedule and queries through both packages: after
    every wave both pass the exact-set oracle, their id sets differ only
    inside the tie band, and the distances they both report agree."""
    rng = np.random.default_rng(4321)
    bt = _builder(vector_db_torch, itype, cfg, metric,
                  str(tmp_path / "port"), device="cpu")
    br = _builder(ref_vdb, itype, cfg, metric, str(tmp_path / "ref"))
    dbt, dbr = bt.build(), br.build()
    live: dict[int, np.ndarray] = {}
    for phase, (op, payload) in enumerate(_waves(rng, live, [], 0)):
        dbt = _apply(dbt, bt, op, payload, live, f"{tag}/port")
        dbr = _apply(dbr, br, op, payload, live, f"{tag}/ref")
        assert dbt.size() == dbr.size() == len(live)
        q = _queries(live, rng)
        oracle = _oracle_topk(live, q, K, metric)
        rows_t = dbt.search_batch(q, K)
        rows_r = dbr.search_batch(q, K)
        for i in range(len(q)):
            got_t = {r.id: r.distance for r in rows_t[i]}
            got_r = {r.id: r.distance for r in rows_r[i]}
            at = f"{tag}/phase{phase}/q{i}"
            _check_exact(set(got_t), live, oracle[i], at + "/port")
            _check_exact(set(got_r), live, oracle[i], at + "/ref")
            _, must, ok = oracle[i]
            assert set(got_t) ^ set(got_r) <= ok - must, (
                f"{at}: port {sorted(got_t)} and reference {sorted(got_r)} "
                "differ outside the tie band")
            scale = 1.0 + max(abs(v) for v in got_r.values())
            for vid in set(got_t) & set(got_r):
                assert abs(got_t[vid] - got_r[vid]) <= 1e-4 * scale, (
                    at, vid, got_t[vid], got_r[vid])
    dbt.close()
    dbr.close()
