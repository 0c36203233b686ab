"""Durability of the port's storage (copies of the reference's
``tests/test_native_storage.py`` and the durability cases of
``tests/test_round2_fixes.py``) on the CPU.

* Both engines of ``vector_db_torch/storage/native.py`` (the C++ engine in
  ``native/`` and its format-identical Python twin): round trip, delete and
  last write, snapshot truncation, torn-write recovery, and records
  acknowledged by a process that is then SIGKILLed under ``flush`` and
  ``fsync``.
* The WAL files cross between packages: the port's engines write and the
  reference's read, and the reverse.
* ``VectorDatabase`` recovers from the WAL alone (no close), from a
  checkpoint plus the WAL, keeps the right rows of a batch with duplicate
  ids, and, in a child process SIGKILLed after acknowledged adds, deletes and
  re-adds that straddle a checkpoint, loses none of them.

The native engine is built by ``make -C native`` into this module's own
temporary directory (parallel test workers never write one file) and bound
through ``VDBSTORE_NATIVE_PATH``; where no compiler is present its cases
skip, as the reference's do.  Torch's intra-op threads are capped
(``_few_threads``): the cases are small and run beside other workers.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_tpu.storage import native as ref_ns  # noqa: E402
from vector_db_torch import IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.storage import native as ns  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ["python", "native"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """A libvdbstore.so built from ``native/`` for this module."""
    out = tmp_path_factory.mktemp("vdbstore")
    try:
        subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                        f"BUILD={out}"], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"native engine not built: {e}")
    return str(out / "libvdbstore.so")


@pytest.fixture
def bind_native(native_lib, monkeypatch):
    """Bind both packages' native bindings to the module's library for one
    test (their cached handles are restored afterwards)."""
    monkeypatch.setenv("VDBSTORE_NATIVE_PATH", native_lib)
    for mod in (ns, ref_ns):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_LIB_TRIED", False)
        assert mod.native_available()
    return native_lib


def make_engine(mod, kind: str, path: str, dim: int, **kw):
    cls = mod.NativeStorageEngine if kind == "native" else mod.PyStorageEngine
    return cls(path, dim, **kw)


@pytest.fixture
def engine(request, kind):
    """``make_engine`` of the port for ``kind``, the native library bound."""
    if kind == "native":
        request.getfixturevalue("bind_native")
    return lambda path, dim, **kw: make_engine(ns, kind, path, dim, **kw)


# ------------------------------------------------------------ the engines
@pytest.mark.parametrize("kind", ENGINES)
class TestEngine:
    def test_roundtrip(self, engine, tmp_path, rng):
        eng = engine(str(tmp_path / "e"), 8)
        vecs = rng.standard_normal((5, 8)).astype(np.float32)
        eng.append_add_batch(np.arange(5, dtype=np.int32), vecs)
        eng.flush()
        ids, got = eng.load(10)
        np.testing.assert_array_equal(ids, np.arange(5))
        np.testing.assert_array_equal(got, vecs)
        eng.close()

    def test_delete_and_lastwrite(self, engine, tmp_path):
        eng = engine(str(tmp_path / "e"), 2)
        eng.append_add(1, np.asarray([1.0, 1.0]))
        eng.append_add(2, np.asarray([2.0, 2.0]))
        eng.append_delete(1)
        eng.append_add(2, np.asarray([3.0, 3.0]))
        eng.flush()
        ids, vecs = eng.load(10)
        assert ids.tolist() == [2]
        assert vecs[0, 0] == 3.0
        eng.close()

    def test_snapshot_truncates_wal(self, engine, tmp_path):
        eng = engine(str(tmp_path / "e"), 2)
        eng.append_add(1, np.asarray([1.0, 1.0]))
        eng.snapshot(np.asarray([7], np.int32),
                     np.asarray([[9.0, 9.0]], np.float32))
        eng.append_add(8, np.asarray([2.0, 2.0]))
        eng.flush()
        ids, vecs = eng.load(10)
        assert sorted(ids.tolist()) == [7, 8]
        eng.close()
        wal_size = os.path.getsize(tmp_path / "e" / "wal.bin")
        assert wal_size < 200  # header + one record only

    def test_torn_write_recovery(self, engine, tmp_path):
        eng = engine(str(tmp_path / "e"), 2)
        eng.append_add(1, np.asarray([1.0, 1.0]))
        eng.append_add(2, np.asarray([2.0, 2.0]))
        eng.flush()
        eng.close()
        wal = tmp_path / "e" / "wal.bin"
        data = wal.read_bytes()
        wal.write_bytes(data[:-5])  # tear the last record
        eng2 = engine(str(tmp_path / "e"), 2)
        ids, _ = eng2.load(10)
        assert ids.tolist() == [1]
        eng2.close()

    @pytest.mark.parametrize("durability", ["flush", "fsync"])
    def test_kill9_preserves_acknowledged_appends(self, engine, tmp_path,
                                                  kind, durability):
        """A SIGKILLed process loses nothing that append_* acknowledged."""
        path = str(tmp_path / f"e_{kind}_{durability}")
        script = textwrap.dedent(f"""
            import os, sys
            import numpy as np
            sys.path.insert(0, {REPO!r})
            from vector_db_torch.storage import native as ns
            eng_cls = (ns.NativeStorageEngine if {kind!r} == "native"
                       else ns.PyStorageEngine)
            eng = eng_cls({path!r}, 4, durability={durability!r})
            for i in range(20):
                eng.append_add(i, np.full(4, float(i), np.float32))
            eng.append_delete(3)
            os.kill(os.getpid(), {int(signal.SIGKILL)})
        """)
        proc = subprocess.run([sys.executable, "-c", script], timeout=120)
        assert proc.returncode == -signal.SIGKILL
        eng = ns.PyStorageEngine(path, 4, durability="buffered")
        ids, vecs = eng.load(100)
        assert ids.tolist() == [i for i in range(20) if i != 3]
        np.testing.assert_array_equal(vecs[:, 0], np.asarray(ids, np.float32))
        eng.close()


class TestDurabilityLevels:
    def test_buffered_mode_defers_to_flush(self, tmp_path):
        """"buffered" keeps the reference's write-behind semantics: records
        are not guaranteed on disk until flush/snapshot/close."""
        path = str(tmp_path / "buf")
        eng = ns.PyStorageEngine(path, 4, durability="buffered")
        eng.append_add(1, np.ones(4, np.float32))
        eng.flush()
        ids, _ = ns.PyStorageEngine(path, 4).load(10)
        assert ids.tolist() == [1]
        eng.close()

    @pytest.mark.parametrize("kind", ENGINES)
    def test_rejects_unknown_level(self, engine, tmp_path):
        with pytest.raises(ValueError):
            engine(str(tmp_path / "x"), 4, durability="wrong")


# ---------------------------------------------------- across the packages
def _write_mixed(eng, vecs):
    """Adds, a snapshot, a delete and a last write."""
    eng.append_add_batch(np.asarray([1, 2, 3], np.int32), vecs[:3])
    eng.snapshot(np.asarray([1, 2, 3], np.int32), vecs[:3])
    eng.append_delete(2)
    eng.append_add(3, vecs[3])
    eng.append_add(9, vecs[4])
    eng.flush()
    eng.close()


@pytest.mark.parametrize("reader_kind", ENGINES)
@pytest.mark.parametrize("writer_kind", ENGINES)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_crosses_packages(writer, writer_kind, reader_kind, tmp_path,
                              rng, request):
    """One package's engine writes, the other's reads the same live set."""
    if "native" in (writer_kind, reader_kind):
        request.getfixturevalue("bind_native")
    mods = (ns, ref_ns) if writer == "port" else (ref_ns, ns)
    p = str(tmp_path / "x")
    vecs = rng.standard_normal((5, 4)).astype(np.float32)
    _write_mixed(make_engine(mods[0], writer_kind, p, 4), vecs)
    eng = make_engine(mods[1], reader_kind, p, 4)
    ids, got = eng.load(10)
    order = np.argsort(ids)
    assert ids[order].tolist() == [1, 3, 9]
    np.testing.assert_array_equal(got[order], vecs[[0, 3, 4]])
    eng.close()


# --------------------------------------------------------- the facade
def _db(path, **kw):
    b = (VectorDatabase.builder().with_dimension(8).with_max_elements(128)
         .with_index_type(IndexType.BRUTE).with_storage_path(path)
         .with_device("cpu"))
    for key, value in kw.items():
        b = getattr(b, f"with_{key}")(value)
    return b.build()


class TestWalDurability:
    def test_duplicate_id_batch_persists_correct_vectors(self, tmp_path, rng):
        """add_batch([5, 5, 6]) persists id 6 with ITS vector, not id 5's
        duplicate row."""
        path = str(tmp_path / "db")
        vals = rng.standard_normal((3, 8)).astype(np.float32)
        db = _db(path)
        assert db.add_batch([5, 5, 6], vals) == [5, 6]
        # crash-recover from the WAL alone (no close/save)
        db2 = _db(path)
        np.testing.assert_array_equal(db2.get_vector(5).values, vals[0])
        np.testing.assert_array_equal(db2.get_vector(6).values, vals[2])
        db.close()
        db2.close()

    def test_crash_recovery_without_close(self, tmp_path, rng):
        """Mutations survive a crash (no close/save) through the WAL."""
        path = str(tmp_path / "db")
        db = _db(path)
        vecs = rng.standard_normal((20, 8)).astype(np.float32)
        db.add_batch(range(20), vecs)
        db.delete_vector(3)
        db._engine.flush()
        db2 = _db(path)  # no close(): a new instance
        assert db2.size() == 19
        assert db2.get_vector(3) is None
        np.testing.assert_array_equal(db2.get_vector(7).values, vecs[7])

    def test_wal_plus_checkpoint(self, tmp_path, rng):
        path = str(tmp_path / "db")
        db = _db(path)
        vecs = rng.standard_normal((10, 8)).astype(np.float32)
        db.add_batch(range(10), vecs)
        db.save()  # checkpoint + WAL snapshot
        db.add_vector(100, vecs[0])   # post-checkpoint mutation
        db.delete_vector(5)
        db._engine.flush()
        db2 = _db(path)
        assert db2.size() == 10  # 10 - 1 deleted + 1 added
        assert db2.get_vector(100) is not None
        assert db2.get_vector(5) is None

    def test_readd_after_checkpoint_replays_the_new_vector(self, tmp_path,
                                                           rng):
        """An id deleted and added again with another vector after the
        checkpoint comes back with the new vector, not the checkpoint's."""
        path = str(tmp_path / "db")
        db = _db(path)
        vecs = rng.standard_normal((11, 8)).astype(np.float32)
        db.add_batch(range(10), vecs[:10])
        db.save()
        db.delete_vector(4)
        db.add_vector(4, vecs[10])
        db._engine.flush()
        db2 = _db(path)
        assert db2.size() == 10
        np.testing.assert_array_equal(db2.get_vector(4).values, vecs[10])
        np.testing.assert_array_equal(db2.get_vector(5).values, vecs[5])


_FACADE_CHILD = """
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

rng = np.random.default_rng(11)
first = rng.standard_normal((1300, 16)).astype(np.float32)
again = rng.standard_normal((20, 16)).astype(np.float32)
b = (VectorDatabase.builder().with_dimension(16).with_max_elements(2048)
     .with_index_type(IndexType.{itype}).with_storage_path({path!r})
     .with_durability({durability!r}).with_device("cpu"))
if {itype!r} == "HNSWPQ":
    b = b.with_index_config(HnswPqConfig(num_subspaces=4,
                                         search_mode="scan_pallas_int8"))
db = b.build()
out = sys.stdout
for vid in db.add_batch(range(1200), first[:1200]):  # checkpoints (>= 1000)
    out.write(f"A {{vid}}\\n")
out.flush()
for vid in range(1200, 1300):
    if db.add_vector(vid, first[vid]):
        out.write(f"A {{vid}}\\n"); out.flush()
db.search(first[0], 3)  # a search between the writes builds the caches
for vid in range(50):
    if db.delete_vector(vid):
        out.write(f"D {{vid}}\\n"); out.flush()
for vid in range(20):
    if db.add_vector(vid, again[vid]):
        out.write(f"R {{vid}}\\n"); out.flush()
os.kill(os.getpid(), 9)
"""


@pytest.mark.parametrize("itype", ["BRUTE", "HNSWPQ"])
@pytest.mark.parametrize("durability", ["flush", "fsync"])
def test_facade_kill9_keeps_acknowledged_ops(tmp_path, itype, durability):
    """A child adds 1,300 rows (a checkpoint falls inside), deletes 50 and
    adds 20 of them back with new vectors, printing each acknowledged op,
    then SIGKILLs itself.  The reopened database holds every acknowledged
    add with its last vector and none of the acknowledged deletes."""
    path = str(tmp_path / "db")
    script = _FACADE_CHILD.format(repo=REPO, path=path, itype=itype,
                                  durability=durability)
    proc = subprocess.run([sys.executable, "-c", script], timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    rng = np.random.default_rng(11)
    first = rng.standard_normal((1300, 16)).astype(np.float32)
    again = rng.standard_normal((20, 16)).astype(np.float32)
    live = {}
    for line in proc.stdout.splitlines():
        op, vid = line.split()
        vid = int(vid)
        if op == "A":
            live[vid] = first[vid]
        elif op == "D":
            del live[vid]
        else:
            live[vid] = again[vid]
    assert len(live) == 1300 - 50 + 20
    b = (VectorDatabase.builder().with_dimension(16).with_max_elements(2048)
         .with_index_type(getattr(IndexType, itype)).with_storage_path(path)
         .with_device("cpu"))
    if itype == "HNSWPQ":
        from vector_db_torch import HnswPqConfig

        b = b.with_index_config(HnswPqConfig(num_subspaces=4,
                                             search_mode="scan_pallas_int8"))
    db = b.build()
    assert db.size() == len(live)
    for vid in range(20, 50):
        assert db.get_vector(vid) is None
    for vid, vec in live.items():
        np.testing.assert_array_equal(db.get_vector(vid).values, vec)
    probe = [0, 7, 19, 50, 600, 1299]
    rows = db.search_batch(np.stack([live[v] for v in probe]), 1)
    assert [row[0].id for row in rows] == probe
    db.close()
