"""``HnswPqIndex``'s derived caches (``vector_db_torch/core/derived.py``),
each row-keyed cache of its registry in turn: a refresh after writes gives a
whole rebuild's value, a record past its threshold or voided rebuilds whole,
and ``load_state_arrays`` leaves no cache to be served before its rebuild.

The writes keep what a rebuild recomputes from the whole store (the
centering of the first 4096 slots, the global scale) where they were, so a
refresh and a rebuild can be compared bit for bit; the ADC tables' norms are
the one part refreshed in another order (``_update_fast_tables``), and the
scan_ivf layout is compared by the rows it serves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402

D, N, CAP = 32, 5000, 8192

#: cache -> (its mode's config, the getter that serves it)
CACHES = {
    "scan8": (dict(search_mode="scan_pallas_int8"), "_scan8_shadow"),
    "scan8g": (dict(search_mode="scan_pallas_int8", int8_epilogue="global"),
               "_scan8g_shadow"),
    "scan16": (dict(search_mode="scan_pallas"), "_scan16_shadow"),
    "refine-bf16": (dict(search_mode="adc_fast", refine_store="bf16"),
                    "_refine_rows"),
    "refine-int8": (dict(search_mode="scan_int8", refine_store="int8"),
                    "_refine_rows"),
    "ivf": (dict(search_mode="scan_ivf"), "_ivf_layout"),
    "fast": (dict(search_mode="adc_fast"), "_fast_tables"),
}


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _index(name):
    cfg, getter = CACHES[name]
    idx = hp.HnswPqIndex(D, CAP, "cosine", HnswPqConfig(
        num_subspaces=8, training_samples=2000, **cfg), device="cpu")
    rows = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    idx.bulk_load(range(N), torch.from_numpy(rows))
    cache = getattr(idx._caches, name.split("-")[0])
    return idx, rows, cache, getattr(idx, getter)


def _write(idx, rows):
    """Rows past the centering prefix removed, and rows added in their
    slots that point the way live rows of the prefix do (under cosine the
    same shadow rows: the global scale stays)."""
    for vid in range(4100, 4200):
        assert idx.remove(vid)
    idx.add_batch(range(N, N + 100), 2.0 * rows[:100])


def _served(idx, lay):
    """The live slots a scan_ivf layout serves: in the grid and enabled, or
    in its overlay."""
    grid = lay.pos2slot[torch.isfinite(lay.off_cm)].long()
    served = set(grid.tolist()) | set(lay.overlay.tolist())
    live = set(np.flatnonzero(idx.store.state.valid.numpy()).tolist())
    return served & live, live


def _same(name, idx, got, want):
    if name == "ivf":
        served, live = _served(idx, got)
        assert served == live == _served(idx, want)[0]
        return
    if name == "fast":  # codes_t and cbt exact; norms refreshed per code
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(),
                                   rtol=1e-5)
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", list(CACHES))
def test_row_cache_refresh_rebuild_and_reload(name):
    idx, rows, cache, get = _index(name)
    q = rows[:8] + 0.01
    idx.search_batch(q, 10)
    built, builds = get(), cache.builds
    assert builds >= 1 and cache.value is built

    # writes: refreshed in place, no build; a whole rebuild gives its value
    _write(idx, rows)
    idx.search_batch(rows[:4] * 2.0, 1)
    got = get()
    assert cache.builds == builds
    first = got.cm_packed if name == "ivf" else got[0]
    assert first is (built.cm_packed if name == "ivf" else built[0])
    cache.void()
    want = get()
    assert cache.builds == builds + 1
    _same(name, idx, got, want)

    # a record past max(8192, capacity / 8) rows rebuilds whole
    idx.add_batch([N + 200], rows[200:201])
    limit = max(8192, CAP // 8)
    idx._note_row_mutation(np.arange(limit + 1), (cache,))
    idx.search_batch(q, 10)
    assert cache.builds == builds + 2

    # an untracked rewrite voids every cache; the next get rebuilds
    idx._note_store_rewrite()
    assert all(c.value is None for c in idx._caches)
    get()
    assert cache.builds == builds + 3

    # a reload restarts the store's version: nothing cached survives it,
    # and the next search rebuilds before it reads
    before = get()
    idx.load_state_arrays(idx.state_arrays())
    assert all(c.value is None for c in idx._caches)
    idx.search_batch(q, 10)
    assert cache.builds == builds + 4 and cache.value is not before
