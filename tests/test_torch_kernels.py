"""The port's kernel module (vector_db_torch/ops/kernels.py) against the
reference's Pallas kernels, run in interpret mode on the CPU: the int8 pool
(fused_int8_pool), its packed-store entry (fused_packed_pool) and the PQ
decode (pq_decode_recon_t).

Tolerance of the pools: slots equal; values within rtol 1e-6 + atol 1e-6 *
max|vals|.  The cross term is exact integer arithmetic in both; the f32
epilogue can differ only in the last ulp where XLA-CPU fuses a
multiply-add.  The decode is a gather and a round to bf16: bit-equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from vector_db_torch.ops import kernels as tk  # noqa: E402


def _shadow(n, d, metric, dead, seed, offset=2.0):
    """A reference-built int8 shadow (numpy) of a seeded corpus."""
    r = np.random.default_rng(seed)
    base = (r.standard_normal((n, d)) + offset).astype(np.float32)
    valid = np.ones(n, bool)
    valid[r.choice(n, int(dead * n), replace=False)] = False
    b = jnp.asarray(base)
    base8, off, sc, cvec, _ = ref_hp._build_scan8_shadow(
        b, jnp.sum(b * b, axis=1), jnp.asarray(valid), metric, 1)
    return (np.array(base8), np.array(off), np.array(sc), np.array(cvec), r)


def _queries(r, qn, d, cvec, metric, offset=2.0):
    q = (r.standard_normal((qn, d)) + offset).astype(np.float32)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return q - cvec[None, :]


def test_quantize_rows_bit_equal_to_reference():
    r = np.random.default_rng(0)
    q = (r.standard_normal((37, 64))
         * r.uniform(0.01, 50.0, (37, 1))).astype(np.float32)
    q[3] = 0.0  # all-zero row: the 1e-12 scale floor
    q[5, :4] = [127.0, -63.5, 0.5, 1.5]  # exact .5 ties: half-to-even
    j8, jsq = ref_pk._quantize_rows_int8(jnp.asarray(q))
    t8, tsq = tk._quantize_rows_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(j8), t8.numpy())
    np.testing.assert_array_equal(np.asarray(jsq), tsq.numpy())


@pytest.mark.parametrize(
    "qn,n,d,w,metric,dead",
    [
        (13, 3000, 64, 64, "l2", 0.1),        # w below block_n, ragged N
        (1, 3000, 32, 2048, "cosine", 0.0),   # w above block_n, one query
        (37, 2500, 64, 700, "l2", 0.3),       # w rounds to 1024, ragged N
        (8, 4096, 32, 512, "cosine", 0.2),    # N a multiple of w
        (5, 1111, 32, 256, "l2", 0.0),        # fewer rows than two passes
    ],
)
def test_plain_pool_matches_reference_kernel(qn, n, d, w, metric, dead):
    base8, off, sc, cvec, r = _shadow(n, d, metric, dead, seed=qn + n)
    qc = _queries(r, qn, d, cvec, metric)
    jv, js = ref_pk.fused_int8_pool(jnp.asarray(qc), jnp.asarray(base8),
                                    jnp.asarray(off), jnp.asarray(sc), w,
                                    interpret=True)
    tv, ts = tk.fused_int8_pool(torch.from_numpy(qc), torch.from_numpy(base8),
                                torch.from_numpy(off), torch.from_numpy(sc), w)
    jv, js = np.asarray(jv), np.asarray(js)
    tv, ts = tv.numpy(), ts.numpy()
    assert tv.shape == jv.shape == (qn, tk.pool_width(w))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    scale = np.abs(jv[fin]).max()
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-6, atol=1e-6 * scale)
    # dead rows and rows past N never come back
    live = ts[ts >= 0]
    assert live.max() < n and np.isfinite(off[live]).all()


def test_pool_width_matches_reference_rounding():
    for w in (1, 64, 128, 129, 300, 512, 513, 700, 2048, 2049):
        b = min(512, max(128, -(-w // 128) * 128))
        assert tk.pool_width(w) == -(-(-(-w // 128) * 128) // b) * b


def test_shadow_columns_padded_to_words_match_unpadded():
    """A shadow padded with zero columns (d % 4 != 0) pools exactly like
    the unpadded one: the queries are padded to its width."""
    r = np.random.default_rng(5)
    base8 = r.integers(-127, 128, (900, 30), dtype=np.int8)
    off = r.uniform(0, 10, 900).astype(np.float32)
    sc = -r.uniform(0.01, 1, 900).astype(np.float32)
    q = torch.from_numpy(r.standard_normal((6, 30)).astype(np.float32))
    padded = np.zeros((900, 32), np.int8)
    padded[:, :30] = base8
    args = (torch.from_numpy(off), torch.from_numpy(sc), 256)
    v1, s1 = tk.fused_int8_pool(q, torch.from_numpy(base8), *args)
    v2, s2 = tk.fused_int8_pool(q, torch.from_numpy(padded), *args)
    assert torch.equal(v1, v2) and torch.equal(s1, s2)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building the CUDA library is an error, never a fallback."""
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        tk.kernel_library().get()


def test_concurrent_first_calls_load_once(monkeypatch):
    """Eight threads making a process's first kernel call together: one
    build and load, and every thread gets that one handle."""
    import threading
    import time

    lib = tk.kernel_library()
    calls = []
    handle = object()

    def slow_load():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        lib.lib = handle

    monkeypatch.setattr(lib, "_load", slow_load)
    start = threading.Barrier(8)
    got = [None] * 8

    def first_call(i):
        start.wait(timeout=30)
        got[i] = lib.get()

    threads = [threading.Thread(target=first_call, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(h is handle for h in got)


def test_build_names_are_unique_per_thread(monkeypatch, tmp_path):
    """Two threads building the same sources at once write distinct object
    files: the names carry the pid and the thread id."""
    import threading

    import torch.utils.cpp_extension as ext

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("")
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "kernels")
    both = threading.Barrier(2)
    names = {}

    class Stop(Exception):
        pass

    def popen(cmd, **kw):
        # both threads are inside a build here, so their idents differ
        names[threading.get_ident()] = cmd[cmd.index("-o") + 1]
        both.wait(timeout=30)
        raise Stop

    monkeypatch.setattr(tk.subprocess, "Popen", popen)

    def build():
        with pytest.raises(Stop):
            tk.kernel_library().get()

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(set(names.values())) == 2
    assert all(f".{os.getpid()}.{ident}.o" in n for ident, n in names.items())


def test_unsupported_device_raises():
    q = torch.empty((2, 8), device="meta")
    b = torch.empty((16, 8), dtype=torch.int8, device="meta")
    v = torch.empty((16,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.fused_int8_pool(q, b, v, v, 128)


# ---------------------------------------------------- pq_decode_recon_t (B3)
@pytest.mark.parametrize(
    "s,sd,k,n",
    [
        (8, 4, 256, 2500),    # K = 256: the reference's lo/hi lane halves
        (4, 8, 128, 3000),    # K = 128: one lane vreg
        (16, 2, 200, 1000),   # K = 200: padded to 256 by the reference
        (2, 3, 256, 4096),    # sd = 3, N a multiple of the reference's block
    ],
)
def test_decode_plain_bit_equal_to_reference_kernel(s, sd, k, n):
    """bf16 values equal bit for bit (compared as float32); uint8 codes
    pass as stored."""
    r = np.random.default_rng(s * 100 + k)
    codes_t = r.integers(0, k, (s, n), dtype=np.uint8)
    cbt = (r.standard_normal((s * sd, k)) * 3).astype(np.float32)
    want = ref_pk.pq_decode_recon_t(jnp.asarray(codes_t), jnp.asarray(cbt),
                                    interpret=True)
    got = tk.pq_decode_recon_t(torch.from_numpy(codes_t),
                               torch.from_numpy(cbt))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (s * sd, n)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


def test_decode_reads_a_column_slice_without_copy():
    r = np.random.default_rng(4)
    codes_t = torch.from_numpy(r.integers(0, 256, (8, 5000), dtype=np.uint8))
    cbt = torch.from_numpy(r.standard_normal((32, 256)).astype(np.float32))
    part = codes_t[:, 1000:3000]
    assert not part.is_contiguous()
    assert torch.equal(tk.pq_decode_recon_t(part, cbt),
                       tk.pq_decode_recon_t(part.contiguous(), cbt))


# ---------------------------------------------------- fused_packed_pool (B4)
def _packed_store(n, d, metric, dead, seed):
    """The reference's packed rows (pack_int8_rows) and scan conditioning
    (_build_scan8p_shadow) of a seeded corpus, as numpy."""
    from vector_db_tpu.ops.distance import pack_int8_rows as ref_pack

    r = np.random.default_rng(seed)
    base = (r.standard_normal((n, d)) + 1.5).astype(np.float32)
    valid = np.ones(n, bool)
    valid[r.choice(n, int(dead * n), replace=False)] = False
    b = jnp.asarray(base)
    packed, scales = ref_pack(b)
    off, sc, cvec = ref_hp._build_scan8p_shadow(
        packed, scales, jnp.sum(b * b, axis=1), jnp.asarray(valid), metric)
    return (np.array(packed), np.array(off), np.array(sc), np.array(cvec), r)


@pytest.mark.parametrize(
    "qn,n,d,w,metric,dead",
    [
        (13, 4096, 64, 128, "l2", 0.1),      # ragged Q, w below block_n
        (1, 4096, 32, 2048, "cosine", 0.0),  # one query, w above block_n
        (37, 6144, 64, 512, "l2", 0.3),      # several passes, dead slots
        (8, 2048, 32, 2048, "cosine", 0.2),  # one pass
    ],
)
def test_packed_plain_matches_reference_kernel(qn, n, d, w, metric, dead):
    """The same int32 words (the reference's pack_int8_rows) through both:
    slots equal, values within rtol 1e-6 + atol 1e-6 * max|vals|."""
    packed, off, sc, cvec, r = _packed_store(n, d, metric, dead, qn + n)
    qc = _queries(r, qn, d, cvec, metric, offset=1.5)
    jv, js = ref_pk.fused_packed_pool(jnp.asarray(qc), jnp.asarray(packed),
                                      jnp.asarray(off), jnp.asarray(sc), w,
                                      interpret=True)
    tv, ts = tk.fused_packed_pool(torch.from_numpy(qc),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(off), torch.from_numpy(sc),
                                  w)
    jv, js, tv, ts = np.asarray(jv), np.asarray(js), tv.numpy(), ts.numpy()
    assert tv.shape == jv.shape == (qn, tk.pool_width(w))
    np.testing.assert_array_equal(ts, js)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    scale = np.abs(jv[fin]).max()
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-6, atol=1e-6 * scale)


def test_packed_words_unpack_in_true_dim_order():
    """Shift-unpacking the reference's words gives the same int8 rows as
    viewing them as bytes, so the packed pool equals the int8 pool over
    those rows."""
    packed, off, sc, cvec, r = _packed_store(2048, 32, "l2", 0.1, 3)
    p = torch.from_numpy(packed)
    rows8 = tk.unpack_words_int8(p)
    assert torch.equal(rows8, p.view(torch.int8).reshape(2048, 32))
    q = torch.from_numpy(_queries(r, 5, 32, cvec, "l2", offset=1.5))
    args = (torch.from_numpy(off), torch.from_numpy(sc), 512)
    a, b = tk.fused_packed_pool(q, p, *args), tk.fused_int8_pool(q, rows8, *args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_packed_rows_not_a_multiple_of_w_raise_in_both():
    packed, off, sc, cvec, r = _packed_store(2048, 32, "l2", 0.0, 5)
    qc = _queries(r, 3, 32, cvec, "l2")
    with pytest.raises(ValueError, match="multiple of the pool width"):
        ref_pk.fused_packed_pool(jnp.asarray(qc), jnp.asarray(packed[:1920]),
                                 jnp.asarray(off[:1920]), jnp.asarray(sc[:1920]),
                                 2048, interpret=True)
    with pytest.raises(ValueError, match="multiple of the pool width"):
        tk.fused_packed_pool(torch.from_numpy(qc),
                             torch.from_numpy(packed[:1920]),
                             torch.from_numpy(off[:1920]),
                             torch.from_numpy(sc[:1920]), 2048)


def test_preserved_pool_width_matches_reference():
    for n in (128, 1920, 2048, 4096, 6144, 9_963_520, 1_000_064):
        w = tk.preserved_pool_width(n)
        assert w == ref_pk.preserved_pool_width(n)
        assert n % w == 0 and tk.pool_width(w) == w
