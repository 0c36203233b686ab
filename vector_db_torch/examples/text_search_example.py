"""Text search across all seven index types: the port's counterpart of
``examples/text_search_example.py``.

A generated phrase corpus is embedded by the deterministic character-hash
vectorizer (``utils/text_vectorizer.py``), indexed under every index type
on one device, and searched with noisy variants of corpus phrases; the
table gives each type's add time, rebuild time, search time, Top-1/3/5
accuracy (the target phrase retrieved) and memory.

    python -m vector_db_torch.examples.text_search_example \\
        [--dim 1536] [--n 1000] [--queries 100] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vector_db_torch import HnswConfig, HnswPqConfig, IndexType, VectorDatabase
from vector_db_torch.utils import text_vectorizer as tv

SUBJECTS = [
    "machine learning", "vector databases", "nearest neighbor search",
    "product quantization", "navigable small worlds", "sensitive hashing",
    "projection forests", "coarse quantizers", "transformer embeddings",
    "semantic search", "image similarity", "recommendation engines",
    "customer clustering", "anomaly detection", "record deduplication",
    "resume matching", "query routing", "cache eviction", "graph traversal",
    "stream processing",
]
VERBS = [
    "accelerates", "compresses", "indexes", "retrieves", "ranks",
    "partitions", "deduplicates", "embeds", "shards", "quantizes",
]
OBJECTS = [
    "dense embeddings", "sparse signals", "user histories", "telemetry",
    "documents", "image features", "session logs", "product catalogs",
    "knowledge bases", "audio fingerprints",
]
TYPES = [IndexType.BRUTE, IndexType.HNSW, IndexType.IVF, IndexType.PQ,
         IndexType.LSH, IndexType.ANNOY, IndexType.HNSWPQ]


def make_corpus(n: int) -> list[str]:
    """A deterministic combinatorial phrase corpus of ``n`` phrases."""
    out = []
    i = 0
    while len(out) < n:
        s = SUBJECTS[i % len(SUBJECTS)]
        v = VERBS[(i // len(SUBJECTS)) % len(VERBS)]
        o = OBJECTS[(i // (len(SUBJECTS) * len(VERBS))) % len(OBJECTS)]
        out.append(f"{s} {v} {o} #{i}")
        i += 1
    return out


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> list[dict]:
    """Run the comparison; prints the table and returns its rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=1536)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dim, n, device = args.dim, args.n, args.device

    print(f"corpus: {n} phrases, {dim}-dim deterministic char-hash "
          f"embeddings, device {device}")
    corpus = make_corpus(n)
    t0 = time.time()
    vecs = np.stack([tv.text_to_vector(t, dim) for t in corpus])
    print(f"vectorized in {time.time() - t0:.1f}s")

    rng = np.random.default_rng(42)
    targets = rng.integers(0, n, args.queries)
    queries = np.stack([
        tv.generate_similar_vector(vecs[t], noise=0.25, seed=1000 + i)
        for i, t in enumerate(targets)
    ])

    print(f"\n{'index':8s} {'add ms/v':>9s} {'rebuild s':>10s} "
          f"{'search ms/q':>12s} {'Top-1':>7s} {'Top-3':>7s} {'Top-5':>7s} "
          f"{'memory KB':>10s}")
    print("-" * 78)
    rows = []
    for itype in TYPES:
        b = (VectorDatabase.builder().with_dimension(dim)
             .with_max_elements(n * 2).with_index_type(itype)
             .with_metric("cosine").with_device(device))
        if itype == IndexType.HNSW:
            b = b.with_index_config(
                HnswConfig(m=16, ef_construction=64, ef_search=64))
        if itype == IndexType.HNSWPQ:
            b = b.with_index_config(
                HnswPqConfig(num_subspaces=max(1, dim // 8),
                             training_samples=n))
        db = b.build()
        t0 = time.time()
        db.add_batch(range(n), vecs)
        _sync(device)
        t_add = (time.time() - t0) * 1000 / n
        t0 = time.time()
        db.rebuild_index()
        _sync(device)
        t_build = time.time() - t0

        db.search_batch(queries, 5)  # warm-up
        t0 = time.time()
        res = db.search_batch(queries, 5)
        t_q = (time.time() - t0) * 1000 / len(queries)
        ids = [[r.id for r in row] for row in res]
        top = {j: float(np.mean([targets[i] in ids[i][:j]
                                 for i in range(len(ids))]))
               for j in (1, 3, 5)}
        st = db.stats()
        mem = st.get("index_bytes", 0) + st.get(
            "store_bytes", st["capacity"] * dim * 4)
        print(f"{itype.value:8s} {t_add:9.2f} {t_build:10.1f} {t_q:12.2f} "
              f"{top[1]:7.0%} {top[3]:7.0%} {top[5]:7.0%} {mem / 1024:10.0f}")
        rows.append(dict(index=itype.value, add_ms=t_add, rebuild_s=t_build,
                         search_ms=t_q, top1=top[1], top3=top[3],
                         top5=top[5], memory_bytes=mem))
        db.close()

    # one detailed result set
    db = (VectorDatabase.builder().with_dimension(dim)
          .with_max_elements(n * 2).with_index_type(IndexType.BRUTE)
          .with_metric("cosine").with_device(device).build())
    db.add_batch(range(n), vecs)
    q = tv.generate_similar_vector(vecs[targets[0]], noise=0.25, seed=1000)
    print(f"\nquery: noisy variant of {corpus[targets[0]]!r}")
    for r in db.search(q, 3):
        print(f"  {r.similarity:6.4f}  {corpus[r.id]}")
    db.close()
    return rows


if __name__ == "__main__":
    main()
