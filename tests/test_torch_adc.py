"""The port's adc_fast pipeline (vector_db_torch/ops/adc.py and the index's
ADC tables) against the reference's, on the same codes, codebooks and row
stores taken from a reference index.

The reference runs its decode kernel in interpret mode.  Bars: mean top-10
overlap with the reference >= 0.99, and recall against an exact oracle no
lower than the reference's minus 0.005; reconstruction norms within rtol
1e-5 (f32 sums in another order, and the incremental refresh sums per
subspace).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import adc as ref_adc  # noqa: E402
from vector_db_tpu.ops import distance as ref_dist  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import adc  # noqa: E402
from vector_db_torch.ops import distance as dist  # noqa: E402

D, N, CAP, K, KP, S = 32, 4000, 4096, 10, 16, 8


def _corpus(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, D)) * (np.arange(D) + 1.0) ** -0.5
            ).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gt(base, queries):
    d = ((queries[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :K]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def tables():
    """A reference compressed index (with the residual level) streamed from
    a corpus: its codes, codebooks, perm and int8 store, plus the f32 rows
    the codes were encoded from."""
    base = _corpus(N, 31)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(
        raw_store=False, refine_residual=True, num_subspaces=S,
        training_samples=1500))
    ref.bulk_load_stream([(range(s, s + 2000), base[s:s + 2000])
                          for s in range(0, N, 2000)])
    a = ref.state_arrays()
    st = a["store"]
    valid = np.array(st["valid"])
    valid[np.random.default_rng(32).choice(N, 300, replace=False)] = False
    return dict(
        base=base, queries=_corpus(40, 33), codes_t=a["codes"].T.copy(),
        codebooks=a["codebooks"], perm=a["perm"], valid=valid,
        ids=st["ids"], packed=st["packed8"], scales=st["scales8"],
        norms=st["norms"], resid=st["resid8"], rscales=st["rscales8"])


def _refine_args(t, source, to):
    """Refine-store keyword arguments of adc_fast_search for one source
    (``to`` converts a numpy array for the package being called)."""
    if source == "f32":
        return {}
    if source == "bf16":
        return {"packed_base": None}  # filled by the caller per package
    out = dict(int8_base=to(t["packed"]), int8_scales=to(t["scales"]),
               int8_norms=to(t["norms"]))
    if source == "int8_resid":
        out.update(int8_resid=to(t["resid"]), int8_rscales=to(t["rscales"]))
    return out


@pytest.mark.parametrize(
    "pool_mode,select_r,chunk_n,winners,source",
    [
        ("bucket", 0, 0, 1, "f32"),
        ("bucket", 128, 1536, 1, "bf16"),        # ragged last chunk
        ("bucket", 0, 1536, 2, "int8_resid"),
        ("bucket", 0, 0, 2, "int8"),
        ("approx", 0, 0, 1, "int8"),
        ("approx", 128, 1536, 1, "int8_resid"),
        ("approx", 128, 0, 1, "f32"),
        ("approx", 0, 1536, 1, "bf16"),
        ("fused", 0, 0, 1, "f32"),
        ("fused", 128, 1536, 1, "int8_resid"),   # ragged last chunk
        ("fused", 0, 1536, 2, "bf16"),
    ],
)
def test_adc_fast_search_matches_reference(tables, pool_mode, select_r,
                                           chunk_n, winners, source):
    t = tables
    common = dict(k=KP, bucket=16, winners=winners, metric="l2",
                  rerank_block=128, chunk_n=chunk_n, pool_mode=pool_mode,
                  select_r=select_r)
    j_extra = _refine_args(t, source, jnp.asarray)
    p_extra = _refine_args(t, source, _t)
    if source == "bf16":
        j_extra["packed_base"] = ref_dist.pack_bf16_rows(jnp.asarray(t["base"]))
        p_extra["packed_base"] = dist.pack_bf16_rows(_t(t["base"]))
    jd, jids = ref_adc.adc_fast_search(
        jnp.asarray(t["queries"]), jnp.asarray(t["codes_t"]),
        ref_adc.codebooks_to_cbt(jnp.asarray(t["codebooks"])),
        jnp.asarray(t["valid"]), jnp.asarray(t["base"]), jnp.asarray(t["ids"]),
        perm=jnp.asarray(t["perm"]), **common, **j_extra)
    pd, pids = adc.adc_fast_search(
        _t(t["queries"]), _t(t["codes_t"]),
        adc.codebooks_to_cbt(_t(t["codebooks"])), _t(t["valid"]),
        _t(t["base"]), _t(t["ids"]), perm=_t(t["perm"]), **common, **p_extra)
    jids, pids = np.asarray(jids)[:, :K], pids.numpy()[:, :K]
    live = np.flatnonzero(t["valid"])
    gt = live[_gt(t["base"][live], t["queries"])]
    assert _overlap(pids, jids) >= 0.99
    assert _overlap(pids, gt) >= _overlap(jids, gt) - 0.005
    assert t["valid"][pids[pids >= 0]].all()
    assert np.all(np.diff(pd.numpy(), axis=1) >= 0)


def test_codebooks_to_cbt_and_recon_norms_match_reference(tables):
    t = tables
    cbt_j = ref_adc.codebooks_to_cbt(jnp.asarray(t["codebooks"]))
    cbt = adc.codebooks_to_cbt(_t(t["codebooks"]))
    np.testing.assert_array_equal(cbt.numpy(), np.asarray(cbt_j))
    want = ref_hp._recon_norms(jnp.asarray(t["codes_t"]), cbt_j)
    got = hp._recon_norms(_t(t["codes_t"]), cbt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    masked = adc.code_norms_from_codes(_t(t["codes_t"]), cbt,
                                       _t(t["valid"]))
    assert torch.isinf(masked[~_t(t["valid"])]).all()
    np.testing.assert_allclose(masked[_t(t["valid"])].numpy(),
                               got[_t(t["valid"])].numpy(), rtol=0)


def test_incremental_fast_tables_match_a_rebuild():
    base = _corpus(N, 34)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(
        num_subspaces=S, training_samples=1500, search_mode="adc_fast"),
        device="cpu")
    port.bulk_load(range(3000), torch.from_numpy(base[:3000]))
    port.search_batch(_t(base[:4]), K)                 # builds the tables
    cache = port._caches.fast.value
    port.add_batch(range(3000, 3100), base[3000:3100])  # 100 re-encoded slots
    port.remove(5)
    ct, cbt, cnorms = port._fast_tables()
    assert port._caches.fast.value[0] is cache[0]      # refreshed in place
    np.testing.assert_array_equal(ct.numpy(), port.codes.T.numpy())
    full = hp._recon_norms(port.codes.T.contiguous(), cbt)
    np.testing.assert_allclose(cnorms.numpy(), full.numpy(), rtol=1e-5)
    ids, _ = port.search_batch(_t(base[3000:3010]), 1)
    assert ids[:, 0].tolist() == list(range(3000, 3010))


@pytest.mark.parametrize("refine_store", ["f32", "bf16", "int8"])
def test_raw_index_adc_fast_matches_reference(refine_store):
    """The raw store's adc_fast (the memory-bound configuration) with each
    refine source, before and after churn: the refine caches repack only
    the rows written since."""
    base = _corpus(N, 35)
    cfg = dict(num_subspaces=S, training_samples=1500,
               search_mode="adc_fast", adc_pool="approx", adc_select_r=128,
               refine_store=refine_store)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    ref.add_batch(range(N), base)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    rows = dict(enumerate(base))
    q = _corpus(32, 36)
    for step in range(2):
        if step:
            for vid in range(0, 400, 3):
                assert port.remove(vid) == ref.remove(vid)
                del rows[vid]
            new = _corpus(90, 37)
            assert port.add_batch(range(9000, 9090), new) == ref.add_batch(
                range(9000, 9090), new)
            rows.update(zip(range(9000, 9090), new))
        ref_ids, _ = ref.search_batch(q, K)
        port_ids, _ = port.search_batch(_t(q), K)
        ids = np.asarray(sorted(rows))
        gt = ids[_gt(np.stack([rows[i] for i in ids]), q)]
        assert _overlap(port_ids, ref_ids) >= 0.99
        assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    if refine_store != "f32":
        cached = port._caches.refine.value
        fresh = (dist.pack_bf16_rows(port.store.state.vectors),) \
            if refine_store == "bf16" else \
            dist.pack_int8_rows(port.store.state.vectors)
        for a, b in zip(cached, fresh):
            assert torch.equal(a, b)


def test_fused_pool_is_not_ported():
    """Once a refusal of adc_pool="fused" (kernel B5), now its parity: the
    index with the fused pool, loaded from a reference index's state, finds
    the reference's neighbours before and after churn."""
    base = _corpus(N, 38)
    cfg = dict(num_subspaces=S, training_samples=1500,
               search_mode="adc_fast", adc_pool="fused")
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    ref.add_batch(range(N), base)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    rows = dict(enumerate(base))
    q = _corpus(32, 39)
    for step in range(2):
        if step:
            for vid in range(1, 500, 4):
                assert port.remove(vid) == ref.remove(vid)
                del rows[vid]
            new = _corpus(60, 40)
            assert port.add_batch(range(7000, 7060), new) == ref.add_batch(
                range(7000, 7060), new)
            rows.update(zip(range(7000, 7060), new))
        ref_ids, _ = ref.search_batch(q, K)
        port_ids, port_d = port.search_batch(_t(q), K)
        ids = np.asarray(sorted(rows))
        gt = ids[_gt(np.stack([rows[i] for i in ids]), q)]
        assert _overlap(port_ids, ref_ids) >= 0.99
        assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
        assert np.all(np.diff(port_d, axis=1) >= 0)
