"""Per-index CRUD and performance comparison: the port's counterpart of
``examples/vector_database_example.py``.

A database per index type (BRUTE, HNSW, HNSWPQ, IVF, PQ, LSH, ANNOY) on one
device: add, rebuild, a warm-up search, then a timed batch; the table gives
each type's build time, QPS, ms per query, Recall@10 against BRUTE and
memory, and each database walks the add / get / delete round.

    python -m vector_db_torch.examples.vector_database_example \\
        [--n 10000] [--dim 128] [--queries 100] [--k 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vector_db_torch import (AnnoyConfig, HnswConfig, HnswPqConfig,
                             IndexType, IvfConfig, LshConfig, PqConfig,
                             VectorDatabase)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def configs(dim: int) -> list:
    """(index type, its config) in the reference's order."""
    return [
        (IndexType.BRUTE, None),
        (IndexType.HNSW, HnswConfig(m=16, ef_construction=64, ef_search=64)),
        (IndexType.HNSWPQ, HnswPqConfig(num_subspaces=max(4, dim // 8))),
        (IndexType.IVF, IvfConfig()),
        # PQ at the published comparison point (16x: dim/4 subspaces)
        (IndexType.PQ, PqConfig(num_subspaces=max(8, dim // 4))),
        (IndexType.LSH, LshConfig()),
        (IndexType.ANNOY, AnnoyConfig()),
    ]


def main(argv=None) -> list[dict]:
    """Run the comparison; prints the table and returns its rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dim, k, device = args.n, args.dim, args.k, args.device

    rng = np.random.default_rng(42)
    # power-law eigenspectrum: realistic embedding structure (isotropic
    # noise is the quantizers' worst case and no real workload)
    scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
    vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    queries = (rng.standard_normal((args.queries, dim)) * scale
               ).astype(np.float32)

    def builder(itype):
        return (VectorDatabase.builder().with_dimension(dim)
                .with_max_elements(n).with_index_type(itype)
                .with_device(device))

    gt = builder(IndexType.BRUTE).build()
    gt.add_batch(range(n), vecs)
    gt_sets = [{r.id for r in row} for row in gt.search_batch(queries, k)]
    gt.close()

    print(f"\n{'index':8s} {'build s':>8s} {'QPS':>9s} {'ms/query':>9s} "
          f"{'Recall@10':>10s} {'memory MB':>10s}")
    print("-" * 62)
    rows = []
    for itype, cfg in configs(dim):
        b = builder(itype)
        if cfg is not None:
            b = b.with_index_config(cfg)
        db = b.build()

        _sync(device)
        t0 = time.perf_counter()
        db.add_batch(range(n), vecs)
        db.rebuild_index()
        _sync(device)
        t_build = time.perf_counter() - t0

        db.search_batch(queries, k)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        res = db.search_batch(queries, k)
        _sync(device)
        dt = time.perf_counter() - t0

        recall = float(np.mean(
            [len({r.id for r in res[i]} & gt_sets[i]) / k
             for i in range(args.queries)]))
        st = db.stats()
        mem = (st.get("index_bytes", 0)
               + st.get("store_bytes", st["capacity"] * dim * 4)) / 1e6
        print(f"{itype.value:8s} {t_build:8.1f} {args.queries / dt:9.0f} "
              f"{dt * 1000 / args.queries:9.2f} {recall:10.1%} {mem:10.1f}")
        rows.append(dict(index=itype.value, build_s=t_build,
                         qps=args.queries / dt,
                         ms_per_query=dt * 1000 / args.queries,
                         recall=recall, memory_mb=mem))

        # the CRUD round (the reference walks the same sequence)
        if not db.add_vector(10**6, vecs[0]):
            raise RuntimeError(f"{itype.value}: add_vector refused a new id")
        if db.get_vector(10**6) is None:
            raise RuntimeError(f"{itype.value}: get_vector lost the new id")
        if not db.delete_vector(10**6):
            raise RuntimeError(f"{itype.value}: delete_vector missed it")
        db.close()

    print("\ndone.")
    return rows


if __name__ == "__main__":
    main()
