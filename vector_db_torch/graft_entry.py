"""Entry points: the flagship search as one step, and the multi-chip dry run
(the port's counterpart of ``__graft_entry__.py``).

``entry()`` returns the flagship search of the HNSW+PQ index (its ``adc``
scan path) with example arguments.

``dryrun_multichip(n)`` runs the whole sharded pipeline once each on tiny
shapes over a mesh of ``n`` shards: the sharded k-means step, the
corpus-sharded exact kNN, the corpus-sharded PCA-proxy search, the
end-to-end ``ShardedDatabase`` (add, ``train_pq``, flagship search,
self-queries, a remove that never resurfaces), the compressed (int8) tier
with its fused packed-pool scan, the residual tier with its fused scan and
PCA mode, the raw tier's integer-epilogue fused scan
(``int8_epilogue="global"``) and the device-payload (``host_mirror=False``)
streamed ingest.  The shards are ``n`` logical shards of the one device the
caller names: ``"cuda"`` (the default; four of one card run the pool
kernels B4 and B7 and the decode kernel B3) or ``"cpu"``.

    python -m vector_db_torch.graft_entry      # entry() + dryrun_multichip(4)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .core.device import resolve_device


def _example_state(n=512, dim=64, sub=8, kc=16, seed=42, device="cuda"):
    """(queries [8, dim], codebooks, codes, valid, vectors, ids) on
    ``device``: seeded gaussian rows, PQ codebooks by k-means++ from a
    ``torch.Generator`` seeded with ``seed``, and the rows' codes."""
    from .ops import adc
    from .ops.kmeans import subspace_kmeans_fit

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vecs = torch.from_numpy(
        rng.standard_normal((n, dim)).astype(np.float32)).to(dev)
    queries = torch.from_numpy(
        rng.standard_normal((8, dim)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    codebooks = subspace_kmeans_fit(gen, vecs, num_subspaces=sub, k=kc,
                                    iters=4)
    codes = adc.pq_encode(vecs, codebooks)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    return queries, codebooks, codes, valid, vecs, ids


def entry(device="cuda"):
    """(fn, example_args): the flagship search as one step; ``fn(*args)``
    gives (dists [8, 8], external ids [8, 8])."""
    from .index.hnsw_pq import flagship_search

    fn = functools.partial(flagship_search, k=8, refine=64, impl="gather",
                           block_n=128, metric="l2")
    return fn, _example_state(device=device)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the full sharded pipeline on a mesh of ``n_devices`` logical
    shards of ``device``; raises ``AssertionError`` where a step is wrong."""
    from .ops import pca as pca_ops
    from .parallel import sharded as sh

    mesh = sh.make_mesh(devices=[device] * n_devices)
    assert mesh.global_shards == n_devices

    n, dim, sub, kc = 16 * n_devices, 64, 8, 8
    queries, codebooks, codes, valid, vecs, ids = _example_state(
        n, dim, sub, kc, device=device)
    vecs_np, queries_np = vecs.cpu().numpy(), queries.cpu().numpy()

    # --- sharded training step (data-parallel Lloyd iteration) -------------
    (data_s,) = sh.shard_corpus(mesh, vecs)
    new_cents = sh.sharded_kmeans_step(mesh)(data_s, vecs[:kc])
    assert new_cents.shape == (kc, dim)

    # --- corpus-sharded exact kNN ------------------------------------------
    norms = torch.sum(vecs * vecs, dim=1)
    base_s, valid_s, norms_s = sh.shard_corpus(mesh, vecs, valid, norms)
    d, idx = sh.sharded_knn(mesh, 4)(queries, base_s, valid_s, norms_s)
    assert idx.shape == (queries.shape[0], 4)

    # --- corpus-sharded PCA-proxy search -----------------------------------
    mu, basis = pca_ops.pca_fit(vecs_np, 8)
    mu_t = torch.from_numpy(mu).to(vecs.device)
    basis_t = torch.from_numpy(basis).to(vecs.device)
    proxy = pca_ops.project_rows(vecs, mu_t, basis_t)
    pnorms = torch.sum(proxy.to(torch.float32) ** 2, dim=1)
    pshards = sh.shard_corpus(mesh, proxy, pnorms, valid, vecs, ids)
    dd, ee = sh.sharded_pca_search(mesh, 4, 16)(queries, mu_t, basis_t,
                                                *pshards)
    assert ee.shape == (queries.shape[0], 4)

    # --- sharded END-TO-END build + CRUD + flagship search ------------------
    # empty db -> add_batch -> train_pq (data-parallel subspace k-means over
    # the mesh) -> shard-local encode -> ADC scan + blocked refine + merge
    db = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n, num_subspaces=sub)
    acc = db.add_batch(np.arange(n, dtype=np.int32), vecs_np)
    assert len(acc) == n
    db.train_pq(num_centroids=kc, iters=4)
    ext, dists = db.search_flagship(queries_np, 4, refine=16)
    assert ext.shape == (queries.shape[0], 4)
    # self-queries must find themselves through the sharded path
    ext2, _ = db.search(vecs_np[:4], 1)
    assert (ext2[:, 0] == np.arange(4)).all(), ext2[:, 0]
    # deletes propagate (dirty-shard refresh) and never resurface
    assert db.remove(0) and not db.remove(0)
    ext3, _ = db.search(vecs_np[:1], 1)
    assert ext3[0, 0] != 0

    # --- compressed (int8) sharded tier ------------------------------------
    # raw_store=False: int8-packed shards, near-exact scan + flagship with
    # int8 refine (no raw f32 rows anywhere on the device)
    db8 = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                             num_subspaces=sub, raw_store=False)
    db8.add_batch(np.arange(n, dtype=np.int32), vecs_np)
    db8.train_pq(num_centroids=kc, iters=4)
    e8, _ = db8.search(vecs_np[:4], 1)
    assert (e8[:, 0] == np.arange(4)).all(), e8[:, 0]
    e8f, _ = db8.search_flagship(queries_np, 4, refine=16)
    assert e8f.shape == (queries.shape[0], 4)
    # the packed pool (B4) per shard
    e8p, _ = db8.search_fused(vecs_np[:4], 1)
    assert (e8p[:, 0] == np.arange(4)).all(), e8p[:, 0]

    # --- residual compressed tier -------------------------------------------
    # second-level int8 shards: effectively exact refine/scan programs
    dbr = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                             num_subspaces=sub, raw_store=False,
                             refine_residual=True)
    dbr.add_batch(np.arange(n, dtype=np.int32), vecs_np)
    er, _ = dbr.search(vecs_np[:4], 1)      # two-level exact scan
    assert (er[:, 0] == np.arange(4)).all(), er[:, 0]
    erf, _ = dbr.search_fused(vecs_np[:4], 1)  # kernel + residual refine
    assert (erf[:, 0] == np.arange(4)).all(), erf[:, 0]
    dbr.fit_pca(p=8)
    erp, _ = dbr.search_pca(vecs_np[:4], 1, select_r=16)
    assert (erp[:, 0] == np.arange(4)).all(), erp[:, 0]

    # --- raw-tier integer-epilogue fused scan (int8_epilogue="global") ------
    # per-shard global-scale shadows, ranked by the i32 pool (B7)
    dbg = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                             num_subspaces=sub, int8_epilogue="global")
    dbg.add_batch(np.arange(n, dtype=np.int32), vecs_np)
    eg, _ = dbg.search_fused(vecs_np[:4], 1)
    assert (eg[:, 0] == np.arange(4)).all(), eg[:, 0]

    # --- device payload (host_mirror=False) + streamed ingest ---------------
    # payloads live only as per-shard device pieces, chunks stream straight
    # to the device
    dbm = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                             num_subspaces=sub, raw_store=False,
                             host_mirror=False)
    chunk = max(kc, n // 2)
    dbm.bulk_load_stream(
        ((np.arange(s, min(s + chunk, n), dtype=np.int32),
          vecs_np[s:s + chunk]) for s in range(0, n, chunk)),
        num_centroids=kc, iters=2)
    em, _ = dbm.search(vecs_np[:4], 1)
    assert (em[:, 0] == np.arange(4)).all(), em[:, 0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(x.shape) for x in out])
    dryrun_multichip(4)
    print("dryrun_multichip(4) ok")
