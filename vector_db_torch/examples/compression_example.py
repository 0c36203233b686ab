"""Compression on, off and custom: the port's counterpart of
``examples/compression_example.py``.

Uncompressed HNSW against HNSWPQ under the three ``CompressionConfig``
presets, the memory-bound ``adc_fast`` mode (the decode kernel B3), the
PCA proxy, and the compressed store without raw f32 rows and with its
residual level (both scanned by the packed pool kernel B4 under
``scan_pallas_int8``); the table gives each preset's compression ratio,
build time, ms per query, Recall@10 against BRUTE, index MB and memory
saved.

    python -m vector_db_torch.examples.compression_example \\
        [--n 10000] [--dim 512] [--queries 100] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vector_db_torch import (CompressionConfig, HnswPqConfig, IndexType,
                             VectorDatabase)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def presets(dim: int) -> list:
    """(name, CompressionConfig or None, index type or HnswPqConfig mode
    name) in the reference's order."""
    rec = CompressionConfig.recommended_config(dim)
    return [
        ("uncompressed", None, IndexType.HNSW),
        ("recommended (dim/8, 32x)", rec, IndexType.HNSWPQ),
        ("high recall (dim/4, 16x)",
         CompressionConfig.high_recall_config(dim), IndexType.HNSWPQ),
        ("high compression (dim/16, 64x)",
         CompressionConfig.high_compression_config(dim), IndexType.HNSWPQ),
        # memory-bound scoring: candidates from the 32x codes and the
        # codebooks alone (decode kernel + one product); the raw rows are
        # read only by the exact top-pool refine
        ("memory-bound (adc_fast, 32x)", rec, "adc_fast"),
        # PCA proxy: a [dim/8]-dim truncated-PCA first stage + exact refine
        ("pca proxy (dim/8 dims + refine)", rec, "pca"),
        # the compressed store: no raw f32 matrix exists; the packed pool
        # kernel reads the store's own int8 rows
        ("compressed store (no raw f32, 4x)", None, "compressed"),
        # + a second int8 level: ~16-bit refine precision at half f32 bytes
        ("compressed + residual (2.5x)", None, "residual"),
    ]


def _index_config(mode: str, dim: int) -> HnswPqConfig:
    sub = max(1, dim // 8)
    if mode == "adc_fast":
        return HnswPqConfig(num_subspaces=sub, search_mode="adc_fast",
                            adc_bucket=16, adc_winners=2)
    if mode == "pca":
        return HnswPqConfig(num_subspaces=sub, search_mode="pca",
                            proxy_dims=max(8, dim // 8), pca_r=256)
    return HnswPqConfig(num_subspaces=sub, raw_store=False,
                        refine_residual=mode == "residual",
                        search_mode="scan_pallas_int8")


def main(argv=None) -> list[dict]:
    """Run the comparison; prints the table and returns its rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dim, n, k, device = args.dim, args.n, 10, args.device

    rng = np.random.default_rng(42)
    # power-law eigenspectrum: what real embedding models emit (isotropic
    # noise is PQ's and PCA's worst case and represents no real workload)
    scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
    vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    queries = (rng.standard_normal((args.queries, dim))
               * scale).astype(np.float32)

    def builder(itype, comp=None):
        b = (VectorDatabase.builder().with_dimension(dim)
             .with_max_elements(n).with_index_type(itype)
             .with_device(device))
        return b.with_compression(comp) if comp is not None else b

    gt = builder(IndexType.BRUTE).build()
    gt.add_batch(range(n), vecs)
    gt_sets = [{r.id for r in row} for row in gt.search_batch(queries, k)]
    gt.close()

    print(f"\n{'preset':32s} {'ratio':>6s} {'build s':>8s} {'ms/q':>7s} "
          f"{'Recall@10':>10s} {'index MB':>9s} {'saved':>6s}")
    print("-" * 84)
    rows = []
    for name, comp, itype in presets(dim):
        if isinstance(itype, str):
            db = (builder(IndexType.HNSWPQ, comp)
                  .with_index_config(_index_config(itype, dim)).build())
        else:
            db = builder(itype, comp).build()
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
        ratio = db.get_compression_ratio()
        st = db.stats()
        # compressed index structures (codes, codebooks, proxy) in MB
        idx_mb = st.get("index_bytes", st["capacity"] * dim * 4) / 1e6
        if not st.get("raw_store", True):
            # the compressed store: total resident bytes against a raw f32
            # store (the point of the tier)
            saved = 100.0 * (1.0 - (st["store_bytes"] + st["index_bytes"])
                             / st["raw_bytes"])
        else:
            saved = db.get_memory_savings_pct() if comp is not None else 0.0
        print(f"{name:32s} {ratio:5.0f}x {t_build:8.1f} "
              f"{dt * 1000 / args.queries:7.2f} {recall:10.1%} "
              f"{idx_mb:9.1f} {saved:5.1f}%")
        rows.append(dict(preset=name, ratio=ratio, build_s=t_build,
                         ms_per_query=dt * 1000 / args.queries,
                         recall=recall, index_mb=idx_mb, saved_pct=saved))
        db.close()
    print("\ndone.")
    return rows


if __name__ == "__main__":
    main()
