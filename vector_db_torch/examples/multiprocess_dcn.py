"""Multi-process search over ``torch.distributed``: the port's counterpart
of ``examples/multiprocess_dcn.py``.

The sharded programs (``vector_db_torch/parallel/sharded.py``) take a mesh
that spans processes, as the reference's ``shard_map`` programs run under
``jax.distributed``: each rank holds its own shards' rows, the programs
gather the ranks' [Q, k] winners (and all-reduce the k-means partials), and
every rank gets the merged result.  What stays single-controller is the
``ShardedDatabase`` wrapper (it raises on such a mesh).

One process a card under NCCL (NCCL takes one rank a card: give each rank
its own with ``CUDA_VISIBLE_DEVICES``)::

    # rank 0                                      # rank i
    python -m vector_db_torch.examples.multiprocess_dcn \\
        --coordinator host0:8476 --num-processes 4 --process-id 0   # ... i

gloo for several ranks on one card, or on the CPU (``--device cpu``)::

    python -m vector_db_torch.examples.multiprocess_dcn --backend gloo \\
        --coordinator file:///tmp/rdzv --num-processes 2 --process-id 0 \\
        --local-shards 2

Each rank generates ONLY its own shards' rows (global shard s draws from
``default_rng(42 + s)``; at real scale, read your shard of the dataset) and
places them on its devices with ``sharded.shard_process_local``.  With no
``--coordinator``, the single-process fallback: the same code path over
the local shards, without a group.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from vector_db_torch.core.device import resolve_device
from vector_db_torch.ops.distance import sq_norms
from vector_db_torch.parallel import sharded as sh

K, NQ = 10, 64


def local_devices(device: str, local_shards: int | None) -> list:
    """This rank's shard devices: ``local_shards`` of them (default one a
    visible card, or one on the CPU), laid round-robin over the visible
    cards (or on the one card named, e.g. ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (local_shards or 1)
    cards = ([dev] if dev.index is not None else
             [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return [cards[i % len(cards)] for i in range(local_shards or len(cards))]


def shard_rows(shard: int, per_shard: int, dim: int) -> np.ndarray:
    """Global shard ``shard``'s generated rows."""
    rng = np.random.default_rng(42 + shard)
    return rng.standard_normal((per_shard, dim)).astype(np.float32)


def local_corpus(mesh: sh.Mesh, per_shard: int, dim: int):
    """This process's shards of the generated corpus: (vectors, valid,
    norms), each a sharded list (the norms shard-local, no communication)."""
    first = mesh.first_shard
    rows = np.concatenate([shard_rows(s, per_shard, dim)
                           for s in range(first, first + mesh.local_shards)])
    (vectors,) = sh.shard_process_local(mesh, torch.from_numpy(rows))
    valid = [torch.ones(per_shard, dtype=torch.bool, device=v.device)
             for v in vectors]
    return vectors, valid, [sq_norms(v) for v in vectors]


def queries(dim: int, device) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(
        rng.standard_normal((NQ, dim)).astype(np.float32)).to(device)


def join_group(args, devices):
    """The process group named by ``--coordinator`` (initialized here
    unless the process already is), or None for the single-process
    fallback."""
    if not args.coordinator:
        return None
    if not dist.is_initialized():
        backend = args.backend or (
            "nccl" if devices[0].type == "cuda" else "gloo")
        url = (args.coordinator if "://" in args.coordinator
               else f"tcp://{args.coordinator}")
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(backend, init_method=url,
                                world_size=args.num_processes,
                                rank=args.process_id)
    return dist.group.WORLD


def main(argv=None):
    """Run the corpus-sharded exact search; returns (dists, global slot
    ids), numpy [64, 10], the same on every rank.  The process group stays
    initialized for the caller (the command line destroys it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="",
                    help="host:port of rank 0, or an init URL (tcp://, "
                         "file://); enables multi-process")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--per-shard", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-shards", type=int, default=None,
                    help="shards this rank holds (default: one a visible "
                         "card; one on the CPU)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)

    devices = local_devices(args.device, args.local_shards)
    mesh = sh.make_mesh(devices=devices, group=join_group(args, devices))
    vectors, valid, norms = local_corpus(mesh, args.per_shard, args.dim)
    q = queries(args.dim, devices[0])
    d, idx = sh.sharded_knn(mesh, K)(q, vectors, valid, norms)
    d, idx = d.cpu().numpy(), idx.cpu().numpy()

    if mesh.rank == 0:
        print(f"processes={mesh.world} shards={mesh.global_shards} "
              f"corpus={args.per_shard * mesh.global_shards:,}x{args.dim}")
        print("top-3 global slots for query 0:", idx[0, :3].tolist(),
              "dists:", np.round(d[0, :3], 4).tolist())
        # self-check in the generated-data setup: re-derive shard 0's rows
        v0 = shard_rows(0, args.per_shard, args.dim)
        dd = ((q[:1].cpu().numpy() - v0) ** 2).sum(1)
        print("local brute check (shard 0 only):", int(dd.argmin()))
    return d, idx


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
