"""The port's raw vector store (vector_db_torch/core/store.py) against the
reference's: the same add/remove/re-add sequence assigns the same slots and
leaves the same host snapshot (norms within rtol 1e-6: f32 sums in another
order; everything else exact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_tpu.core.store import VectorStore as RefStore  # noqa: E402
from vector_db_torch.core.store import VectorStore  # noqa: E402


def _assert_same_snapshot(got: dict, want: dict):
    assert set(got) == set(want)
    for key in ("ids", "valid", "vectors"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_allclose(got["norms"], np.asarray(want["norms"]),
                               rtol=1e-6)


def test_same_sequence_same_slots_and_snapshot():
    r = np.random.default_rng(0)
    ref, port = RefStore(300, 16), VectorStore(300, 16, device="cpu")
    assert port.capacity == ref.capacity == 384  # rounded up to 128
    steps = [
        ("add", list(range(0, 50)), r.standard_normal((50, 16))),
        ("add", [3, 60, 61, -1, 60], r.standard_normal((5, 16))),  # dup/neg
        ("remove", [5, 7, 9, 1000]),
        ("add", [70, 71, 72, 73], r.standard_normal((4, 16))),  # reuse slots
        ("remove", [70, 0]),
        ("add", list(range(100, 137)), r.standard_normal((37, 16))),
    ]
    for step in steps:
        if step[0] == "add":
            vecs = step[2].astype(np.float32)
            assert port.add_batch(step[1], vecs) == ref.add_batch(step[1], vecs)
        else:
            for vid in step[1]:
                assert port.remove(vid) == ref.remove(vid)
    assert port._id_to_slot == ref._id_to_slot
    assert port._free == ref._free
    _assert_same_snapshot(port.to_host(), ref.to_host())
    np.testing.assert_array_equal(port.get(71), np.asarray(ref.get(71)))
    assert port.get(70) is None


def test_bulk_load_and_round_trip_through_host():
    r = np.random.default_rng(1)
    vecs = r.standard_normal((200, 8)).astype(np.float32)
    ref, port = RefStore(256, 8), VectorStore(256, 8, device="cpu")
    ids = list(range(1000, 1200))
    assert port.bulk_load(ids, torch.from_numpy(vecs)) == ref.bulk_load(
        ids, vecs)
    _assert_same_snapshot(port.to_host(), ref.to_host())
    # a reference snapshot loads into the port with the same slot map
    back = VectorStore.from_host(ref.to_host(), device="cpu")
    assert back._id_to_slot == ref._id_to_slot and back._free == ref._free
    assert back.add_batch([5], vecs[:1]) == ([5], [200])


def test_compressed_store_not_ported():
    """The compressed store is ported now; what it still does not take is
    the reference's: rows that are not whole int32 words (dim % 4), and a
    residual level on a raw store."""
    st = VectorStore(128, 8, raw=False, device="cpu")
    assert not st.raw and st.capacity == 2048
    with pytest.raises(ValueError, match="dim % 4"):
        VectorStore(128, 6, raw=False, device="cpu")
    with pytest.raises(ValueError, match="raw=False"):
        VectorStore(128, 8, device="cpu", residual=True)
