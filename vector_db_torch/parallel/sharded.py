"""The sharded tier: a corpus split over a mesh of devices (the counterpart
of ``vector_db_tpu/parallel/sharded.py``).

A :class:`Mesh` is a tuple of ``torch.device``s, one a shard (repeats
allowed: eight ``cpu`` entries are the tests' eight shards, four ``cuda:0``
entries four logical shards on one card), and a *sharded array* is a list
of per-shard tensors, piece ``i`` on ``mesh.devices[i]``.  The reference's
``shard_map`` collectives become per-shard calls plus a step on
``mesh.devices[0]``:

  * ``all_gather`` + ``top_k``: the shards' [Q, k'] results copied to the
    first device, laid out shard-major, one stable selection
    (:func:`_merge_topk`: ties go to the earlier shard and position, as
    ``lax.top_k``'s do);
  * ``psum``: the per-shard partial sums added in shard order there.

A mesh may span processes, as a ``shard_map`` mesh does under
``jax.distributed``: given a ``torch.distributed`` process group, its
``devices`` are this rank's L local shards, rank r holding the global
shards r*L .. r*L + L - 1 of ``global_shards`` = world * L.  The programs
then gather the ranks' stacked winners in rank order (the global
shard-major layout) and all-reduce the k-means partials; corpus rows never
cross.  NCCL moves CUDA tensors (one rank a card); under gloo the winners
and partials cross through host memory.  Every rank gets the same
(replicated) result.  :class:`ShardedDatabase` stays single-controller, as
the reference's does.

Every per-shard call runs under ``torch.cuda.device(shard_device)`` on a
card.  The pool selects are exact where the reference uses
``approx_max_k``.  The programs return tensors on ``mesh.devices[0]``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.derived import DerivedCache
from ..core.device import resolve_device
from ..index import hnsw_pq
from ..index.hnsw_pq import (_build_scan8_shadow, _build_scan8g_shadow,
                             _build_scan8p_shadow, _pool_select_cand)
from ..ops import adc
from ..ops import pca as pca_ops
from ..ops.distance import (_bf16_mm, blocked_knn, blocked_knn_int8,
                            blocked_rerank, blocked_rerank_int8,
                            normalize_rows, pack_int8_rows, sq_norms,
                            unpack_int8_rows, words_to_f32)
from ..ops.kernels import (fused_int8_pool, fused_int8g_pool,
                           fused_packed_pool, preserved_pool_width)
from ..ops.kmeans import subspace_kmeans_fit
from ..ops.topk import merge_topk
from ..utils.locks import RWLock

#: rows of one block of the shard-local exact scans (the reference's
#: ``blocked_knn_int8`` block; a [Q, block] f32 distance tile at a time)
EXACT_BLOCK_N = 262144
#: bytes of the [B, rows, K] f32 distances (and one-hot) one step of the
#: sharded Lloyd iterations holds: a shard's rows go in chunks of this
KMEANS_CHUNK_BYTES = 1 << 30
#: bytes of the [Q, rows] f32 proxy cross terms one step of the PCA select
PCA_SELECT_BYTES = 1 << 31
#: rows a step of the proxy projection (the reference's 131,072)
PROJECT_ROWS = 131072


@dataclass(frozen=True)
class Mesh:
    """The shard axis.  ``devices``: this process's shards, one device each
    (repeats allowed).  Without a ``group`` they are every shard; with one,
    each of the group's ``world`` ranks holds ``local_shards`` of them, rank
    ``rank`` the global shards from ``first_shard`` on."""

    devices: tuple
    group: Optional[object] = field(default=None, compare=False)
    rank: int = 0
    world: int = 1

    @property
    def local_shards(self) -> int:
        """Shards this process holds (``len(devices)``)."""
        return len(self.devices)

    @property
    def global_shards(self) -> int:
        """Shards of the whole mesh, over every rank."""
        return self.world * len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count, as a JAX mesh's ``size``."""
        return self.global_shards

    @property
    def first_shard(self) -> int:
        """Global index of local shard 0 (``jax.lax.axis_index`` of it)."""
        return self.rank * len(self.devices)


def _backend(group) -> str:
    """The group's backend: ``nccl`` or ``gloo``; raises on any other."""
    name = str(dist.get_backend(group)).lower()
    if name not in ("nccl", "gloo"):
        raise ValueError(f"process group backend {name!r}: the sharded "
                         "programs take nccl or gloo")
    return name


def _gather_ranks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, [world, *t.shape], on
    ``t``'s device (``t[None]`` without a group).  NCCL gathers on the card;
    gloo gathers no CUDA tensor, so under it ``t`` crosses through host
    memory."""
    if mesh.group is None:
        return t[None]
    t = t.contiguous()
    if _backend(mesh.group) == "nccl":
        out = torch.empty((mesh.world, *t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    host = t.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.stack(parts).to(t.device)


def _sum_ranks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` added (an ``all_reduce``; ``t`` itself without a
    group), on ``t``'s device; ``t`` is not written."""
    if mesh.group is None:
        return t
    if _backend(mesh.group) == "nccl":
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group)
        return out
    host = t.cpu().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(host, group=mesh.group)
    return host.to(t.device)


def make_mesh(n_shards: Optional[int] = None, devices=None,
              group=None) -> Mesh:
    """A 1-D mesh: ``devices`` as given (``[torch.device("cpu")] * 8`` on
    the host, ``[cuda:0] * 4`` for four logical shards on one card), else
    every visible CUDA device; raises without one.  ``n_shards`` keeps the
    first that many.

    With a ``torch.distributed`` process ``group`` (NCCL or gloo) the
    devices are this rank's local shards and the mesh spans the group's
    ranks.  Every rank must hold the same number of them, as
    ``jax.make_array_from_process_local_data`` requires on a 1-D mesh; a
    collective checks it, so every rank of the group must call this."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() needs a CUDA device; pass devices=[...] (e.g. "
                "[torch.device('cpu')] * 8) to shard on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_shards is not None:
        if n_shards > len(devices):
            raise ValueError(f"{n_shards} shards, {len(devices)} devices")
        devices = devices[:n_shards]
    if group is None:
        return Mesh(tuple(devices))
    if _backend(group) == "nccl" and any(d.type != "cuda" for d in devices):
        raise ValueError("an nccl group moves CUDA tensors: its shards must "
                         "be CUDA devices (use gloo for host shards)")
    mesh = Mesh(tuple(devices), group, dist.get_rank(group),
                dist.get_world_size(group))
    counts = _gather_ranks(mesh, torch.tensor(
        [len(devices)], device=devices[0])).flatten().tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"ranks hold unequal local shard counts {counts}: "
                         "every rank must hold the same number")
    return mesh


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _shards(mesh: Mesh):
    """(shard, device) pairs, each step run under its device."""
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            yield i, dev


def _rep(x, i: int, dev: torch.device):
    """Shard ``i``'s copy of a replicated argument: a :func:`replicate`
    list, or one tensor moved to the shard's device."""
    if isinstance(x, (list, tuple)):
        return x[i]
    return torch.as_tensor(x).to(dev)


def shard_corpus(mesh: Mesh, *arrays) -> tuple[list, ...]:
    """Split each global array's leading axis into ``mesh.global_shards``
    equal pieces (the axis must divide, as under ``shard_map``) and keep
    this process's: global piece ``first_shard + i`` on ``devices[i]``."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % mesh.global_shards:
            raise ValueError(f"{a.shape[0]} rows do not split over "
                             f"{mesh.global_shards} shards")
        n = a.shape[0] // mesh.global_shards
        out.append([a[g * n:(g + 1) * n].to(dev).contiguous()
                    for g, dev in enumerate(mesh.devices, mesh.first_shard)])
    return tuple(out)


def shard_process_local(mesh: Mesh, *arrays) -> tuple[list, ...]:
    """This process's rows only (the counterpart of
    ``jax.make_array_from_process_local_data``): each array's leading axis,
    the rows of global shards ``first_shard`` .. ``first_shard + L - 1`` in
    order, split into ``local_shards`` equal pieces, one on each device."""
    local = Mesh(mesh.devices)
    return shard_corpus(local, *arrays)


def replicate(mesh: Mesh, *arrays) -> tuple[list, ...]:
    """One copy of each array on every mesh device."""
    return tuple([torch.as_tensor(a).to(dev) for dev in mesh.devices]
                 for a in arrays)


def _merge_topk(mesh: Mesh, local_d, local_e, k: int):
    """The winners-only merge: each local shard's [Q, k'] (dists, ids)
    stacked on ``mesh.devices[0]``, the ranks' stacks gathered in rank order
    (the global [S, Q, k'], as the reference's ``all_gather``), laid out
    shard-major per query ([Q, S*k'], as its ``moveaxis(...).reshape``), and
    the k smallest taken by a stable sort, so ties go to the earlier shard
    and position as ``lax.top_k``'s do; every rank takes the same selection.
    Non-finite results get id -1."""
    dev0 = mesh.devices[0]
    d_all = _gather_ranks(mesh, torch.stack(
        [d.to(dev0) for d in local_d])).flatten(0, 1)         # [S, Q, k']
    e_all = _gather_ranks(mesh, torch.stack(
        [e.to(dev0) for e in local_e])).flatten(0, 1)
    s, qn, kk = d_all.shape
    d_flat = d_all.transpose(0, 1).reshape(qn, s * kk)
    e_flat = e_all.transpose(0, 1).reshape(qn, s * kk)
    vals, order = torch.sort(d_flat, dim=1, stable=True)
    vals, order = vals[:, :k], order[:, :k]
    out_e = torch.gather(e_flat, 1, order)
    return vals, torch.where(torch.isfinite(vals), out_e,
                             torch.full_like(out_e, -1))


def _global(mesh: Mesh, slots: torch.Tensor, i: int,
            n_s: int) -> torch.Tensor:
    """Local shard ``i``'s slots to global slot ids (-1 stays -1), by its
    global index (the reference's ``axis_index``)."""
    return torch.where(slots >= 0, slots + (mesh.first_shard + i) * n_s,
                       torch.full_like(slots, -1))


def _to_ids(d: torch.Tensor, loc: torch.Tensor, ids_s: torch.Tensor):
    """External ids of shard-local slots, -1 where the result is empty."""
    ext = ids_s[loc.clamp(min=0).long()]
    return torch.where(torch.isfinite(d), ext, torch.full_like(ext, -1))


def _search_shards(mesh: Mesh, k: int, q, local):
    """The corpus-sharded search skeleton: ``local(i, dev, q_i)`` gives
    shard ``i``'s (dists, ids) [Q, k'] from the queries on its device,
    then :func:`_merge_topk`."""
    q = torch.as_tensor(q, dtype=torch.float32)
    ds, es = [], []
    for i, dev in _shards(mesh):
        d, e = local(i, dev, q.to(dev))
        ds.append(d)
        es.append(e)
    return _merge_topk(mesh, ds, es, k)


def _check_resid(residual: bool, resid) -> None:
    if residual and resid is None:
        raise ValueError("residual=True needs resid and rscales")


# ----------------------------------------------------------- exact programs
def sharded_knn(mesh: Mesh, k: int, metric: str = "l2"):
    """Corpus-sharded exact kNN: queries replicated, base sharded; a local
    blocked top-k per shard, then the merge.

    fn: (q [Q, d], base, valid, norms (sharded)) -> (dists [Q, k], global
    slot ids [Q, k])."""

    def fn(q, base, valid, norms):
        def local(i, dev, qi):
            n_s = base[i].shape[0]
            d, idx = blocked_knn(qi, base[i], valid[i], k, metric,
                                 b_norms=norms[i],
                                 block_n=min(EXACT_BLOCK_N, max(n_s, 1)))
            return d, _global(mesh, idx, i, n_s)
        return _search_shards(mesh, k, q, local)
    return fn


def dp_knn(mesh: Mesh, k: int, metric: str = "l2"):
    """Query-sharded exact kNN: the queries split over the global shards (Q
    must divide by their count), the corpus replicated; the ranks' rows of
    results gathered in rank order.

    fn: (q [Q, d], base, valid, norms (replicated)) -> (dists [Q, k], slot
    ids [Q, k]) on the first device."""

    def fn(q, base, valid, norms):
        q = torch.as_tensor(q, dtype=torch.float32)
        if q.shape[0] % mesh.global_shards:
            raise ValueError(f"{q.shape[0]} queries do not split over "
                             f"{mesh.global_shards} shards")
        m = q.shape[0] // mesh.global_shards
        ds, ix = [], []
        for i, dev in _shards(mesh):
            b = _rep(base, i, dev)
            g = mesh.first_shard + i
            d, idx = blocked_knn(q[g * m:(g + 1) * m].to(dev), b,
                                 _rep(valid, i, dev), k, metric,
                                 b_norms=_rep(norms, i, dev),
                                 block_n=min(EXACT_BLOCK_N, max(b.shape[0], 1)))
            ds.append(d.to(mesh.devices[0]))
            ix.append(idx.to(mesh.devices[0]))
        return (_gather_ranks(mesh, torch.cat(ds)).flatten(0, 1),
                _gather_ranks(mesh, torch.cat(ix)).flatten(0, 1))
    return fn


def sharded_knn_int8(mesh: Mesh, k: int, metric: str = "l2",
                     residual: bool = False):
    """Corpus-sharded exact scan over int8-packed rows (the compressed
    tier): ``ops/distance.blocked_knn_int8`` on each shard with the exact
    write-time norms (and the residual level), then the merge.

    fn: (q, packed [N, d/4] i32, scales, valid, norms [, resid, rscales])
    (sharded) -> (dists [Q, k], global slot ids [Q, k])."""

    def fn(q, packed, scales, valid, norms, resid=None, rscales=None):
        _check_resid(residual, resid)

        def local(i, dev, qi):
            n_s = packed[i].shape[0]
            d, idx = blocked_knn_int8(
                qi, packed[i], scales[i], valid[i], k, metric,
                b_norms=norms[i], block_n=min(EXACT_BLOCK_N, max(n_s, 1)),
                resid=resid[i] if residual else None,
                rscales=rscales[i] if residual else None)
            return d, _global(mesh, idx, i, n_s)
        return _search_shards(mesh, k, q, local)
    return fn


# -------------------------------------------------------- training, encode
def _lloyd_partials(rows, n: int, cb: torch.Tensor, w=None):
    """One Lloyd step's partial (sums [B, K, sd], counts [B, K]) over one
    shard's ``n`` rows, ``rows(start, stop)`` giving the [B, m, sd] block of
    rows start..stop: assignment by argmin of ``|x|^2 + |c|^2 - 2 x.c``
    (the reference's expression), one-hot sums weighted by ``w`` [n].  Row
    blocks hold at most KMEANS_CHUNK_BYTES of distances, so the [B, n, K]
    matrix never exists; the sums differ from the reference's only in f32
    summation order."""
    b, kc, sd = cb.shape
    cb_n = torch.sum(cb * cb, dim=2)                              # [B, K]
    sums = torch.zeros((b, kc, sd), dtype=cb.dtype, device=cb.device)
    counts = torch.zeros((b, kc), dtype=cb.dtype, device=cb.device)
    step = max(1, KMEANS_CHUNK_BYTES // (4 * b * kc))
    for start in range(0, n, step):
        stop = min(n, start + step)
        sub = rows(start, stop)                                   # [B, m, sd]
        dist = (torch.sum(sub * sub, dim=2)[:, :, None] + cb_n[:, None, :]
                - 2.0 * torch.bmm(sub, cb.transpose(1, 2)))
        assign = torch.argmin(dist, dim=2)
        del dist
        weight = (torch.ones(stop - start, dtype=cb.dtype, device=cb.device)
                  if w is None else w[start:stop].to(cb.dtype))
        onehot = torch.zeros((b, stop - start, kc), dtype=cb.dtype,
                             device=cb.device)
        onehot.scatter_(2, assign[:, :, None],
                        weight[None, :, None].expand(b, -1, 1))
        counts += torch.sum(onehot, dim=1)
        sums += torch.bmm(onehot.transpose(1, 2), sub)
    return sums, counts


def _psum(mesh: Mesh, parts):
    """The local shards' partials added in shard order on the first device,
    then the ranks' sums added (an ``all_reduce``)."""
    dev0 = mesh.devices[0]
    total = parts[0].to(dev0)
    for p in parts[1:]:
        total = total + p.to(dev0)
    return _sum_ranks(mesh, total)


def sharded_kmeans_step(mesh: Mesh):
    """One data-parallel Lloyd step: data sharded, centroids replicated,
    the per-shard one-hot sums and counts added across the shards.

    fn: (data (sharded [N, d]), centroids [K, d]) -> new centroids [K, d]
    (empty clusters keep theirs)."""

    def fn(data, centroids):
        centroids = torch.as_tensor(centroids, dtype=torch.float32)
        sums, counts = [], []
        for i, dev in _shards(mesh):
            x = data[i]
            s, c = _lloyd_partials(lambda a, b, x=x: x[a:b][None],
                                   x.shape[0], centroids.to(dev)[None])
            sums.append(s[0])
            counts.append(c[0])
        sums, counts = _psum(mesh, sums), _psum(mesh, counts)
        c0 = centroids.to(mesh.devices[0])
        return torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts[:, None], min=1), c0)
    return fn


def _pq_rows(x: torch.Tensor, perm: torch.Tensor, norm_rows: bool):
    """Rows in PQ space: normalized under cosine, then permuted."""
    if norm_rows:
        x = normalize_rows(x)
    return x[:, perm]


def sharded_subspace_kmeans(mesh: Mesh, num_subspaces: int, iters: int,
                            norm_rows: bool = False):
    """Data-parallel per-subspace PQ training: every subspace codebook
    trains at once for ``iters`` Lloyd steps; each step assigns the shards'
    rows in row blocks (:func:`_lloyd_partials`) and adds the weighted
    one-hot sums and counts across the shards.

    fn: (data (sharded [N, d]), init_cb [S, K, sd], w (sharded [N] validity
    weights), perm [d]) -> codebooks [S, K, sd] on the first device."""

    def fn(data, init_cb, w, perm):
        cb = torch.as_tensor(init_cb, dtype=torch.float32).to(
            mesh.devices[0])
        s, kc, sd = cb.shape
        if s != num_subspaces:
            raise ValueError(f"init_cb has {s} subspaces, not {num_subspaces}")
        for _ in range(iters):
            sums, counts = [], []
            for i, dev in _shards(mesh):
                x, p = data[i], _rep(perm, i, dev).long()

                def rows(a, b, x=x, p=p):
                    sub = _pq_rows(x[a:b], p, norm_rows)
                    return sub.reshape(b - a, s, sd).transpose(0, 1)
                ps, pc = _lloyd_partials(rows, x.shape[0], cb.to(dev), w[i])
                sums.append(ps)
                counts.append(pc)
            sums, counts = _psum(mesh, sums), _psum(mesh, counts)
            cb = torch.where(counts[:, :, None] > 0,
                             sums / torch.clamp(counts[:, :, None], min=1.0),
                             cb)
        return cb
    return fn


def sharded_encode(mesh: Mesh, norm_rows: bool = False):
    """Shard-local PQ encode (``ops/adc.pq_encode``, chunked by bytes).

    fn: (vectors (sharded), codebooks [S, K, sd], perm [d]) -> codes
    (sharded [N, S] uint8)."""

    def fn(vectors, codebooks, perm):
        out = []
        for i, dev in _shards(mesh):
            out.append(adc.pq_encode(
                _pq_rows(vectors[i], _rep(perm, i, dev).long(), norm_rows),
                _rep(codebooks, i, dev)))
        return out
    return fn


# ---------------------------------------------- conditioning for the pools
def _cond_int8_local(packed, scales, norms, valid, metric):
    """One shard's conditioning for B4 (``_build_scan8p_shadow`` on its own
    rows: centering is shard-local, and the merge compares refined
    distances): (off [n], sel_scale [n], center [1, d])."""
    off, ssc, cvec = _build_scan8p_shadow(packed, scales, norms, valid,
                                          metric)
    return off, ssc, cvec[None, :]


def _cond_raw8_local(vectors, norms, valid, metric):
    """One shard's per-row int8 shadow for B2: (base8 [n, d'] int8, off
    [n], sel_scale [n], center [1, d])."""
    base8, off, ssc, cvec, _aux = _build_scan8_shadow(vectors, norms, valid,
                                                      metric, 128)
    return base8, off, ssc, cvec[None, :]


def _cond_raw8g_local(vectors, norms, valid, metric):
    """One shard's global-scale int8 shadow for B7, one scale over the
    shard's own live rows: (base8, off, sv [1], center [1, d])."""
    base8, off, sv, _sgn, cvec, _aux = _build_scan8g_shadow(
        vectors, norms, valid, metric, 128)
    return base8, off, sv.reshape(1), cvec[None, :]


def _map_cond(mesh: Mesh, local, metric, *sharded):
    """A conditioning builder over every shard, transposed to one sharded
    list per output."""
    outs = []
    for i, _dev in _shards(mesh):
        outs.append(local(*(a[i] for a in sharded), metric))
    return tuple(list(col) for col in zip(*outs))


def sharded_cond_int8(mesh: Mesh, metric: str = "l2"):
    """fn: (packed, scales, norms, valid) (sharded) -> (off, sel_scale,
    center [1, d] a shard) (sharded): the packed-store conditioning of the
    compressed tier's fused scan, each shard from its own rows."""
    return functools.partial(_map_cond, mesh, _cond_int8_local, metric)


def sharded_cond_raw8(mesh: Mesh, metric: str = "l2"):
    """fn: (vectors, norms, valid) (sharded) -> (base8, off, sel_scale,
    center) (sharded): the raw tier's per-row int8 shadows."""
    return functools.partial(_map_cond, mesh, _cond_raw8_local, metric)


def sharded_cond_raw8g(mesh: Mesh, metric: str = "l2"):
    """fn: (vectors, norms, valid) (sharded) -> (base8, off, sv [1],
    center) (sharded): the raw tier's global-scale int8 shadows, one scale
    a shard (the merge compares exact refined distances, so shards may
    differ)."""
    return functools.partial(_map_cond, mesh, _cond_raw8g_local, metric)


# ------------------------------------------------------------ fused scans
def sharded_fused_raw8(mesh: Mesh, k: int, pool: int, w: int,
                       metric: str = "l2"):
    """Raw-tier fused scan: per shard the int8 pool kernel (B2,
    ``ops/kernels.fused_int8_pool``) over its shadow, the exact top-``pool``
    of the bucket winners, the exact f32 re-rank against the shard's rows,
    then the merge.

    fn: (q, base [N, d] f32, base8, off, sel_scale, center) (all but q
    sharded) -> (dists [Q, k], global slot ids [Q, k])."""

    def fn(q, base, base8, off, ssc, cvec):
        def local(i, dev, qi):
            cand = _pool_select_cand(qi, cvec[i][0], metric, fused_int8_pool,
                                     (base8[i], off[i], ssc[i]), pool, w)
            d, slots = blocked_rerank(qi, base[i], cand, k, metric, rb=pool)
            return d, _global(mesh, slots, i, base[i].shape[0])
        return _search_shards(mesh, k, q, local)
    return fn


def sharded_fused_raw8g(mesh: Mesh, k: int, pool: int, w: int,
                        metric: str = "l2"):
    """:func:`sharded_fused_raw8` through the integer-epilogue pool (B7,
    ``ops/kernels.fused_int8g_pool``) over global-scale shadows.

    fn: (q, base, base8, off, sv [1], center) -> (dists, global slots)."""
    sgn = 2.0 if metric == "l2" else 1.0

    def fn(q, base, base8, off, sv, cvec):
        def local(i, dev, qi):
            cand = _pool_select_cand(qi, cvec[i][0], metric,
                                     fused_int8g_pool,
                                     (base8[i], off[i], sv[i][0], sgn),
                                     pool, w)
            d, slots = blocked_rerank(qi, base[i], cand, k, metric, rb=pool)
            return d, _global(mesh, slots, i, base[i].shape[0])
        return _search_shards(mesh, k, q, local)
    return fn


def sharded_fused_int8(mesh: Mesh, k: int, pool: int, w: int,
                       metric: str = "l2", residual: bool = False):
    """Compressed-tier fused scan: per shard the packed pool kernel (B4,
    ``ops/kernels.fused_packed_pool``) over the shard's own int8 rows, the
    exact top-``pool``, the int8 refine with exact write-time norms (and
    the residual level), then the merge.

    fn: (q, packed, scales, norms, off, sel_scale, center [, resid,
    rscales]) -> (dists [Q, k], global slot ids [Q, k])."""

    def fn(q, packed, scales, norms, off, ssc, cvec, resid=None,
           rscales=None):
        _check_resid(residual, resid)

        def local(i, dev, qi):
            cand = _pool_select_cand(qi, cvec[i][0], metric,
                                     fused_packed_pool,
                                     (packed[i], off[i], ssc[i]), pool, w)
            d, slots = blocked_rerank_int8(
                qi, packed[i], scales[i], cand, k, metric, rb=pool,
                b_norms=norms[i], resid=resid[i] if residual else None,
                rscales=rscales[i] if residual else None)
            return d, _global(mesh, slots, i, packed[i].shape[0])
        return _search_shards(mesh, k, q, local)
    return fn


# ----------------------------------------------------------------- flagship
def _adc_candidates(q, codebooks, codes_s, valid_s, perm, refine, metric):
    """One shard's ADC top-``refine`` through the decode kernel (B3, in
    ``ops/adc.adc_decode_topk``): (candidate slots [Q, r], r)."""
    r = min(refine, codes_s.shape[0])
    q_scan = normalize_rows(q) if metric == "cosine" else q
    _, cand = adc.adc_decode_topk(q_scan, codes_s.T.contiguous(),
                                  adc.codebooks_to_cbt(codebooks), valid_s,
                                  r, perm=perm.long())
    return cand, r


def sharded_flagship(mesh: Mesh, k: int, refine: int, metric: str = "l2"):
    """Corpus-sharded ADC scan + exact re-rank: per shard the ADC top-R
    (B3 + one product), a blocked f32 re-rank of it, then the merge on
    external ids.

    fn: (q, codebooks [S, K, sd], codes [N, S] u8, valid, base [N, d], ids,
    perm [d]) -> (dists [Q, k], external ids [Q, k])."""

    def fn(q, codebooks, codes, valid, base, ids, perm):
        def local(i, dev, qi):
            cand, r = _adc_candidates(qi, _rep(codebooks, i, dev), codes[i],
                                      valid[i], _rep(perm, i, dev), refine,
                                      metric)
            d, loc = blocked_rerank(qi, base[i], cand, min(k, r), metric,
                                    rb=min(512, r))
            return d, _to_ids(d, loc, ids[i])
        return _search_shards(mesh, k, q, local)
    return fn


def sharded_flagship_int8(mesh: Mesh, k: int, refine: int,
                          metric: str = "l2", residual: bool = False):
    """:func:`sharded_flagship` for the compressed tier: the re-rank reads
    the shard's int8 rows with exact norms (and the residual level).

    fn: (q, codebooks, codes, valid, packed, scales, norms, ids, perm [,
    resid, rscales]) -> (dists [Q, k], external ids [Q, k])."""

    def fn(q, codebooks, codes, valid, packed, scales, norms, ids, perm,
           resid=None, rscales=None):
        _check_resid(residual, resid)

        def local(i, dev, qi):
            cand, r = _adc_candidates(qi, _rep(codebooks, i, dev), codes[i],
                                      valid[i], _rep(perm, i, dev), refine,
                                      metric)
            d, loc = blocked_rerank_int8(
                qi, packed[i], scales[i], cand, min(k, r), metric,
                rb=min(512, r), b_norms=norms[i],
                resid=resid[i] if residual else None,
                rscales=rscales[i] if residual else None)
            return d, _to_ids(d, loc, ids[i])
        return _search_shards(mesh, k, q, local)
    return fn


# ---------------------------------------------------------------------- PCA
def _pca_pool_local(q, mean, basis, proxy_s, pnorms_s, valid_s, select_r,
                    metric):
    """One shard's proxy head: project the queries, score the proxy rows
    (bf16 inputs, f32 products), round the distances to bf16 as the
    reference does, and keep the exact top-``select_r`` of them, in row
    blocks of at most PCA_SELECT_BYTES of cross terms.  Returns (candidate
    slots [Q, r], -1 where empty; r)."""
    q_scan = normalize_rows(q) if metric == "cosine" else q
    qp = ((q_scan - mean[None, :]) @ basis).to(proxy_s.dtype)
    n = proxy_s.shape[0]
    r = min(select_r, n)
    masked = torch.where(valid_s, pnorms_s, float("inf"))
    block = max(r, PCA_SELECT_BYTES // (4 * max(1, q.shape[0])))
    top_v = torch.full((q.shape[0], r), float("inf"), device=q.device)
    top_i = torch.full((q.shape[0], r), -1, dtype=torch.int32,
                       device=q.device)
    for start in range(0, n, block):
        cross = _bf16_mm(qp, proxy_s[start:start + block])
        dist = (masked[None, start:start + block] - 2.0 * cross).to(
            torch.bfloat16)
        vals, sel = torch.topk(dist, min(r, dist.shape[1]), dim=1,
                               largest=False, sorted=True)
        top_v, top_i = merge_topk(top_v, top_i, vals.to(torch.float32),
                                  sel.to(torch.int32) + start, r)
    return top_i, r


def sharded_pca_search(mesh: Mesh, k: int, select_r: int,
                       metric: str = "l2"):
    """Corpus-sharded PCA-proxy search: per shard the proxy top-R
    (:func:`_pca_pool_local`), a blocked exact re-rank, then the merge.

    fn: (q, mean [d], basis [d, p], proxy [N, p] bf16, pnorms, valid, base
    [N, d], ids) -> (dists [Q, k], external ids [Q, k])."""

    def fn(q, mean, basis, proxy, pnorms, valid, base, ids):
        def local(i, dev, qi):
            cand, r = _pca_pool_local(qi, _rep(mean, i, dev),
                                      _rep(basis, i, dev), proxy[i],
                                      pnorms[i], valid[i], select_r, metric)
            d, loc = blocked_rerank(qi, base[i], cand, min(k, r), metric,
                                    rb=min(512, r))
            return d, _to_ids(d, loc, ids[i])
        return _search_shards(mesh, k, q, local)
    return fn


def sharded_pca_search_int8(mesh: Mesh, k: int, select_r: int,
                            metric: str = "l2", residual: bool = False):
    """:func:`sharded_pca_search` for the compressed tier: the re-rank
    reads the shard's int8 rows with exact norms (and the residual level).

    fn: (q, mean, basis, proxy, pnorms, valid, packed, scales, norms, ids [,
    resid, rscales]) -> (dists [Q, k], external ids [Q, k])."""

    def fn(q, mean, basis, proxy, pnorms, valid, packed, scales, norms, ids,
           resid=None, rscales=None):
        _check_resid(residual, resid)

        def local(i, dev, qi):
            cand, r = _pca_pool_local(qi, _rep(mean, i, dev),
                                      _rep(basis, i, dev), proxy[i],
                                      pnorms[i], valid[i], select_r, metric)
            d, loc = blocked_rerank_int8(
                qi, packed[i], scales[i], cand, min(k, r), metric,
                rb=min(512, r), b_norms=norms[i],
                resid=resid[i] if residual else None,
                rscales=rscales[i] if residual else None)
            return d, _to_ids(d, loc, ids[i])
        return _search_shards(mesh, k, q, local)
    return fn


def _project_rows(rows, n: int, mean, basis, norm_rows: bool):
    """Proxy rows [n, p] bf16 of one shard, PROJECT_ROWS rows a step
    (``rows(start, stop)`` gives f32 rows: the raw store's, or the
    compressed store's dequantized, so no full-shard f32 copy exists)."""
    out = torch.empty((n, basis.shape[1]), dtype=torch.bfloat16,
                      device=basis.device)
    for start in range(0, n, PROJECT_ROWS):
        v = rows(start, min(n, start + PROJECT_ROWS))
        if norm_rows:
            v = normalize_rows(v)
        out[start:start + v.shape[0]] = pca_ops.project_rows(v, mean, basis)
    return out


def pack_resid(v: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor):
    """Second-level int8 pack of the rows' quantization residual, rounded
    twice (``v - deq`` with ``deq`` rounded first), as the reference's host
    ``_pack_resid_np`` does: bit-equal to it on any device.  (The index
    store's ``ops/distance.pack_int8_residual`` rounds once.)"""
    return pack_int8_rows(v - words_to_f32(packed) * scales[:, None])


# ------------------------------------------------------------------ database
def _reads(fn):
    """A search: readers run together, a mutation runs alone (the facade's
    RWLock); a reader's lazy refresh of dirty shards serializes on
    ``_refresh_lock``."""

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.read():
            return fn(self, *a, **k)
    return wrapper


def _writes(fn):
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.write():
            return fn(self, *a, **k)
    return wrapper


def _as_rows(x) -> torch.Tensor:
    """Rows as an f32 tensor where they are: a tensor stays on its device,
    a numpy array becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _as_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    elif not isinstance(ids, (np.ndarray, range, list, tuple)):
        ids = list(ids)
    return np.asarray(ids, np.int64)


#: payload field -> (host mirror attribute, checkpoint key)
_PAYLOAD = {"vectors": ("_h_vec", "vectors"), "packed": ("_h_packed", "packed8"),
            "resid": ("_h_resid", "resid8")}
#: metadata field -> host mirror attribute
_META = {"ids": "_h_ids", "valid": "_h_valid", "norms": "_h_norms",
         "codes": "_h_codes", "scales": "_h_scales", "rscales": "_h_rscales"}


class ShardedDatabase:
    """A corpus sharded over a mesh: CRUD, sharded PQ build, and the
    corpus-sharded searches, driven by one controller.

    The corpus lives block-sharded over the mesh at a fixed per-shard
    capacity (128-row multiples).  The host keeps numpy metadata columns
    (ids, valid, norms, codes, and the compressed tier's scales); the row
    payload (raw f32, or int8-packed rows and the residual level) is kept
    in host mirrors too, or with ``host_mirror=False`` only as per-shard
    device pieces written in place.  Mutations mark their shard dirty and
    only dirty shards are copied host -> device before the next search.
    Per-shard caches (the pools' conditioning, the PCA proxy) are keyed on
    a per-shard version that every write into a piece and every refresh
    bumps.
    """

    #: auto crossover: at or above this many live rows a shard, ``search``
    #: takes the fused pool kernels (the single-chip index's threshold, so
    #: the two move together)
    fused_threshold = hnsw_pq.AUTO_INT8_MIN_ROWS

    def __init__(self, mesh: Mesh, vectors=None, ids=None, valid=None,
                 codes=None, codebooks=None, dim: Optional[int] = None,
                 capacity: Optional[int] = None, num_subspaces: int = 8,
                 metric: str = "l2", perm=None, raw_store: bool = True,
                 refine_residual: bool = False, host_mirror: bool = True,
                 int8_epilogue: str = "per_row"):
        """``perm``: the dimension permutation imported ``codes`` and
        ``codebooks`` were trained under (pass ``np.arange(dim)`` for
        codebooks trained without one: codebooks of a default-config index
        live in permuted space)."""
        if mesh.group is not None:
            raise ValueError(
                "ShardedDatabase is single-controller (one process holds the "
                "id map, the slot allocator and the metadata mirrors), as the "
                "reference's is: a mesh that spans processes runs the sharded "
                "programs (sharded_knn, sharded_fused_raw8, ...) only")
        self.mesh = mesh
        self.metric = metric
        self.n_shards = mesh.global_shards
        self._devices = list(mesh.devices)
        if vectors is not None:
            n, dim = vectors.shape
            capacity = capacity or n
        if dim is None:
            raise ValueError("need either vectors or dim=")
        capacity = max(capacity or 1024, self.n_shards)
        self.per_shard = -(-capacity // self.n_shards)
        self.per_shard += (-self.per_shard) % 128  # 128-row pieces
        self.capacity = self.per_shard * self.n_shards
        self.dim = dim
        self.num_subspaces = num_subspaces
        self.raw = raw_store
        if int8_epilogue not in ("per_row", "global"):
            raise ValueError(f"int8_epilogue={int8_epilogue!r}")
        # raw tier only: "global" runs search_fused on B7; the compressed
        # tier's packed pool has its own conditioning
        self.int8_epilogue = int8_epilogue
        if not raw_store and dim % 4 != 0:
            raise ValueError("raw_store=False requires dim % 4 == 0")
        if refine_residual and raw_store:
            raise ValueError("refine_residual=True needs the compressed "
                             "tier (raw_store=False)")
        self.residual = bool(refine_residual)
        self.host_mirror = bool(host_mirror)
        self._payload_fields = (
            ("vectors",) if raw_store
            else (("packed", "resid") if refine_residual else ("packed",)))
        wide, dtype, tdtype = ((dim, np.float32, torch.float32) if raw_store
                               else (dim // 4, np.int32, torch.int32))
        if host_mirror:
            for name in self._payload_fields:
                setattr(self, _PAYLOAD[name][0],
                        np.zeros((self.capacity, wide), dtype))
        self._h_norms = np.zeros(self.capacity, np.float32)
        if not raw_store:
            self._h_scales = np.zeros(self.capacity, np.float32)
            if refine_residual:
                self._h_rscales = np.zeros(self.capacity, np.float32)
        self._h_ids = np.full(self.capacity, -1, np.int32)
        self._h_valid = np.zeros(self.capacity, bool)
        self._h_codes = np.zeros((self.capacity, num_subspaces), np.uint8)
        self._slot_of: dict[int, int] = {}
        self._fill = np.zeros(self.n_shards, np.int64)  # per-shard next-free
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._dirty: set[int] = set(range(self.n_shards))
        self._versions = [0] * self.n_shards
        self._pieces: dict[str, list] = {}
        if not host_mirror:
            # the device pieces are the payload's only copy
            for name in self._payload_fields:
                self._pieces[name] = [
                    torch.zeros((self.per_shard, wide), dtype=tdtype,
                                device=d) for d in self._devices]
        self._cond = [DerivedCache() for _ in range(self.n_shards)]
        self._proxy = [DerivedCache() for _ in range(self.n_shards)]
        self._pca_gen = 0
        self.pca_mean = self.pca_basis = None
        self.codebooks: Optional[torch.Tensor] = None
        self.perm = None if perm is None else self._dev0_tensor(perm).long()
        self._rw = RWLock()
        self._refresh_lock = threading.Lock()
        if codebooks is not None:
            self.codebooks = self._dev0_tensor(codebooks).to(torch.float32)
            self.num_subspaces = int(self.codebooks.shape[0])
            self._h_codes = np.zeros((self.capacity, self.num_subspaces),
                                     np.uint8)
        if vectors is not None:
            n = vectors.shape[0]
            ids = (np.arange(n, dtype=np.int64) if ids is None
                   else _as_ids(ids))
            live = np.flatnonzero(np.ones(n, bool) if valid is None
                                  else np.asarray(valid))
            rows = _as_rows(vectors)
            rows = rows[torch.from_numpy(live).to(rows.device)]
            # imported codes bypass the encode of the rows just added
            self._ingest(ids[live], rows, encode=codes is None)
            if codes is not None:
                # they follow the slots just assigned; rows add_batch
                # rejected (duplicates, capacity) are skipped
                codes = np.asarray(codes)
                pairs = [(i, self._slot_of[int(ids[i])]) for i in live
                         if int(ids[i]) in self._slot_of]
                if pairs:
                    rows_ok, slots_ok = map(np.asarray, zip(*pairs))
                    self._h_codes[slots_ok] = codes[rows_ok]

    def _dev0_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        return x.to(self._devices[0])

    # ----------------------------------------------------------- mutation
    def _place(self, ids_np: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Assign slots to the acceptable ids (not negative, not live, not
        repeated in the batch) as far as capacity allows and register them:
        returns (accepted positions in the batch, their slots).

        Shards are filled by water-filling over their loads: the smallest
        level W whose fill sum(clip(W - load, 0, avail)) covers the batch,
        every shard taken to W - 1, the rest one row a shard across the
        shards still below W; a shard's freed slots are reused before its
        fill pointer moves (the reference's placement, slot for slot)."""
        take_rows: list[int] = []
        seen = self._slot_of
        batch_seen: set[int] = set()
        for row, ext_id in enumerate(ids_np.tolist()):
            if ext_id < 0 or ext_id in seen or ext_id in batch_seen:
                continue
            batch_seen.add(ext_id)
            take_rows.append(row)
        empty = np.empty(0, np.int64)
        if not take_rows:
            return empty, empty
        rows = np.asarray(take_rows)
        load = self._fill - np.asarray([len(f) for f in self._free])
        avail = (self.per_shard - load).astype(np.int64)
        remaining = min(len(rows), int(avail.sum()))
        counts = np.zeros(self.n_shards, np.int64)
        if remaining > 0:
            lo_w = int(load.min())
            hi_w = int(load.max()) + remaining + 1
            while lo_w < hi_w:
                mid = (lo_w + hi_w) // 2
                if int(np.minimum(np.maximum(mid - load, 0),
                                  avail).sum()) >= remaining:
                    hi_w = mid
                else:
                    lo_w = mid + 1
            w = lo_w
            counts = np.minimum(np.maximum(w - 1 - load, 0), avail)
            short = remaining - int(counts.sum())
            can = np.flatnonzero((counts < avail) & (load + counts < w))
            counts[can[:short]] += 1
        rows = rows[: int(counts.sum())]
        if rows.size == 0:
            return empty, empty
        slot_parts: list[np.ndarray] = []
        for shard in np.flatnonzero(counts):
            c = int(counts[shard])
            from_free = min(c, len(self._free[shard]))
            part = []
            if from_free:
                part.append(np.asarray(
                    [self._free[shard].pop() for _ in range(from_free)],
                    np.int64))
            fresh = c - from_free
            if fresh:
                base = shard * self.per_shard + int(self._fill[shard])
                part.append(np.arange(base, base + fresh, dtype=np.int64))
                self._fill[shard] += fresh
            slot_parts.append(np.concatenate(part))
            self._dirty.add(int(shard))
        slots = np.concatenate(slot_parts)
        acc_ids = ids_np[rows]
        self._h_ids[slots] = acc_ids
        self._h_valid[slots] = True
        self._slot_of.update(zip(acc_ids.tolist(), slots.tolist()))
        return rows, slots

    def _write_payload(self, name: str, slots: np.ndarray,
                       rows: torch.Tensor) -> None:
        """Payload rows into the host mirror, or in place into the device
        pieces (bumping the shards' versions)."""
        if self.host_mirror:
            getattr(self, _PAYLOAD[name][0])[slots] = rows.cpu().numpy()
            return
        rows = torch.as_tensor(rows)
        shard_ids = slots // self.per_shard
        for shard in np.unique(shard_ids):
            sh = int(shard)
            m = np.flatnonzero(shard_ids == shard)
            dev = self._devices[sh]
            local = torch.from_numpy(slots[m] - sh * self.per_shard).to(dev)
            vals = rows[torch.from_numpy(m).to(rows.device)].to(dev)
            with _on(dev):
                self._pieces[name][sh].index_copy_(0, local, vals)
            self._versions[sh] += 1

    def _write_levels(self, slots, packed, scales, norms, resid=None,
                      rscales=None) -> None:
        """The compressed tier's rows at ``slots``: the packed level(s),
        their scales and the exact squared norms, written as given."""
        self._write_payload("packed", slots, torch.as_tensor(packed))
        self._h_scales[slots] = np.asarray(torch.as_tensor(scales).cpu())
        self._h_norms[slots] = np.asarray(torch.as_tensor(norms).cpu())
        if self.residual:
            self._write_payload("resid", slots, torch.as_tensor(resid))
            self._h_rscales[slots] = np.asarray(torch.as_tensor(rscales).cpu())

    def _write_rows(self, slots: np.ndarray, rows: torch.Tensor) -> None:
        """f32 rows at ``slots``: stored raw, or packed to int8 (and the
        residual level) where the rows are, with norms captured exactly."""
        norms = sq_norms(rows)
        if self.raw:
            self._write_payload("vectors", slots, rows)
            self._h_norms[slots] = norms.cpu().numpy()
            return
        packed, scales = pack_int8_rows(rows)
        resid = rscales = None
        if self.residual:
            resid, rscales = pack_resid(rows, packed, scales)
        self._write_levels(slots, packed, scales, norms, resid, rscales)

    def _ingest(self, ids_np, rows: torch.Tensor, encode: bool = True):
        take, slots = self._place(ids_np)
        if slots.size == 0:
            return []
        if take.size != rows.shape[0]:
            rows = rows[torch.from_numpy(take).to(rows.device)]
        self._write_rows(slots, rows)
        if encode and self.codebooks is not None:
            self._encode_slots(slots)
        return ids_np[take].tolist()

    @_writes
    def add_batch(self, ids, vectors) -> list[int]:
        """Insert rows (numpy, or a tensor on any device; packed where they
        are): ids already live, negative or repeated are skipped, and the
        batch is water-filled over the shards (:meth:`_place`).  Returns
        the accepted ids."""
        return self._ingest(_as_ids(ids), _as_rows(vectors))

    @_writes
    def remove(self, ext_id: int) -> bool:
        slot = self._slot_of.pop(int(ext_id), None)
        if slot is None:
            return False
        self._h_valid[slot] = False
        self._h_ids[slot] = -1
        self._free[slot // self.per_shard].append(slot)
        self._dirty.add(slot // self.per_shard)
        return True

    def size(self) -> int:
        return int(self._h_valid.sum())

    def _rows(self, slots, device) -> torch.Tensor:
        """f32 rows of ``slots`` on ``device``: the raw rows, or the
        compressed rows dequantized (both levels): the view every row
        consumer (training, encode, PCA) reads."""
        slots = np.asarray(slots, np.int64)

        def level(name):
            if self.host_mirror:
                return torch.from_numpy(
                    getattr(self, _PAYLOAD[name][0])[slots]).to(device)
            return self._gather_rows(name, slots, device)
        if self.raw:
            return level("vectors")
        out = unpack_int8_rows(level("packed"), torch.from_numpy(
            self._h_scales[slots]).to(device))
        if self.residual:
            out = out + unpack_int8_rows(level("resid"), torch.from_numpy(
                self._h_rscales[slots]).to(device))
        return out

    def _rows_host(self, slots) -> np.ndarray:
        return self._rows(slots, "cpu").numpy()

    def _gather_rows(self, name: str, slots: np.ndarray, device):
        """Payload rows of ``slots`` from the device pieces, in the
        caller's order, on ``device``."""
        pieces = self._pieces[name]
        out = torch.empty((len(slots), pieces[0].shape[1]),
                          dtype=pieces[0].dtype, device=device)
        shard_ids = slots // self.per_shard
        for shard in np.unique(shard_ids):
            sh = int(shard)
            m = np.flatnonzero(shard_ids == shard)
            local = torch.from_numpy(slots[m] - sh * self.per_shard)
            got = pieces[sh][local.to(pieces[sh].device)]
            out[torch.from_numpy(m).to(device)] = got.to(device)
        return out

    # ----------------------------------------------------------- build
    @_writes
    def train_pq(self, num_centroids: int = 16, iters: int = 10,
                 seed: int = 42) -> None:
        """Train the PQ codebooks, then encode every live row.

        Raw tier: the data-parallel subspace k-means over the shards
        (:func:`sharded_subspace_kmeans`) from the reference's numpy-seeded
        init (the same live rows picked, the same variance-balanced
        permutation), so the codebooks equal the reference's up to f32
        summation order.  Compressed tier: a single-device fit
        (``ops/kmeans.subspace_kmeans_fit``, k-means++ from a
        ``torch.Generator`` seeded with ``seed``) on a dequantized sample
        of at most 65,536 live rows."""
        s = self.num_subspaces
        sd = self.dim // s
        live = np.flatnonzero(self._h_valid)
        if live.size < num_centroids:
            raise ValueError("not enough live vectors to train")
        rng = np.random.default_rng(seed)
        if not self.raw:
            sample = live
            if sample.size > 65536:
                sample = np.sort(rng.choice(sample, 65536, replace=False))
            self._fit_codebooks(self._rows(sample, self._devices[0]),
                                num_centroids, iters, seed)
            self._encode_all()
            return
        sample = live
        if not self.host_mirror and sample.size > 65536:
            # rows come from the device pieces: bound the transfer
            sample = np.sort(rng.choice(sample, 65536, replace=False))
        rows = self._rows_host(sample)
        if self.metric == "cosine":
            # seeds and variance from the space k-means trains in
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        perm_np = adc.balanced_subspace_perm(rows.var(axis=0), s)
        self.perm = self._dev0_tensor(perm_np).long()
        pick = rows[np.sort(rng.choice(len(rows), size=num_centroids,
                                       replace=False))]
        init_cb = pick[:, perm_np].reshape(num_centroids, s, sd)
        self._refresh()
        fit = sharded_subspace_kmeans(self.mesh, s, iters,
                                      norm_rows=self.metric == "cosine")
        self.codebooks = fit(self._pieces["vectors"],
                             torch.from_numpy(init_cb.transpose(1, 0, 2)),
                             [v.to(torch.float32)
                              for v in self._pieces["valid"]], self.perm)
        self._encode_all()

    def bulk_load_stream(self, chunks, train: bool = True,
                         num_centroids: int = 16, iters: int = 10,
                         seed: int = 42) -> int:
        """Streamed ingest into an empty database: ``chunks`` yields ``(ids,
        vectors)`` pairs (numpy, or tensors packed where they lie), each
        water-filled over the shards and written straight into the pieces,
        so with ``host_mirror=False`` host memory is O(chunk) plus the
        metadata columns.  The first chunk trains the PQ codebooks
        (``train=True`` and none imported; it should be a representative
        sample of >= ``num_centroids`` rows); every chunk is then encoded.
        Returns the rows ingested."""
        if self.size() > 0:
            raise ValueError("bulk_load_stream requires an empty database")
        total = 0
        for ids, vecs in chunks:
            rows = _as_rows(vecs)
            if train and total == 0 and self.codebooks is None:
                self._fit_codebooks(rows.to(self._devices[0]),
                                    num_centroids, iters, seed)
            total += len(self.add_batch(ids, rows))
        return total

    def _fit_codebooks(self, rows: torch.Tensor, num_centroids: int,
                       iters: int, seed: int) -> None:
        """Single-device subspace-PQ fit on explicit rows (on the first
        device): the variance-balanced permutation, then k-means++ and
        ``iters`` Lloyd steps from ``torch.Generator(seed)``."""
        if len(rows) < num_centroids:
            raise ValueError("first chunk too small to train "
                             f"({len(rows)} < {num_centroids} centroids)")
        if self.metric == "cosine":
            rows = normalize_rows(rows)
        perm = adc.balanced_subspace_perm(
            rows.var(dim=0, correction=0).cpu().numpy(), self.num_subspaces)
        self.perm = self._dev0_tensor(perm).long()
        gen = torch.Generator(device=rows.device).manual_seed(seed)
        self.codebooks = subspace_kmeans_fit(
            gen, rows[:, self.perm].contiguous(), self.num_subspaces,
            k=num_centroids, iters=iters, plus_plus=True)

    def _perm(self) -> torch.Tensor:
        return (self.perm if self.perm is not None else
                torch.arange(self.dim, device=self._devices[0]))

    def _encode_all(self) -> None:
        """Codes of every slot: shard-local on the raw tier
        (:func:`sharded_encode`), in 2^17-row chunks of dequantized rows on
        the first device on the compressed tier."""
        if self.raw:
            self._refresh()
            codes = sharded_encode(self.mesh, self.metric == "cosine")(
                self._pieces["vectors"], self.codebooks, self._perm())
            self._h_codes = np.concatenate([c.cpu().numpy() for c in codes])
        else:
            live = np.flatnonzero(self._h_valid)
            for s in range(0, live.size, 1 << 17):
                self._encode_slots(live[s:s + (1 << 17)])
        self._put_shards("codes", range(self.n_shards))

    def _encode_slots(self, slots: np.ndarray) -> None:
        """Encode only ``slots`` (a one-row add re-encodes one row) on the
        first device."""
        dev0 = self._devices[0]
        rows = _pq_rows(self._rows(slots, dev0), self._perm(),
                        self.metric == "cosine")
        self._h_codes[slots] = adc.pq_encode(rows, self.codebooks).cpu().numpy()

    # ----------------------------------------------------------- transfer
    def _put_shards(self, name: str, shards) -> None:
        """Copy field ``name`` of ``shards`` host -> device (payload fields
        with host_mirror=False live on the device already)."""
        if not self.host_mirror and name in self._payload_fields:
            return
        src = getattr(self, _PAYLOAD[name][0] if name in _PAYLOAD
                      else _META[name])
        pieces = self._pieces.setdefault(name, [None] * self.n_shards)
        for sh in shards:
            lo, hi = sh * self.per_shard, (sh + 1) * self.per_shard
            pieces[sh] = torch.from_numpy(
                np.ascontiguousarray(src[lo:hi])).to(self._devices[sh])

    def _fields(self) -> tuple:
        names = self._payload_fields + ("ids", "valid", "norms", "codes")
        if not self.raw:
            names += ("scales",) + (("rscales",) if self.residual else ())
        return names

    def _refresh(self) -> None:
        """Re-put the dirty shards' fields and bump their versions."""
        with self._refresh_lock:
            if not self._dirty:
                return
            dirty = sorted(self._dirty)
            for name in self._fields():
                self._put_shards(name, dirty)
            for sh in dirty:
                self._versions[sh] += 1
            self._dirty.clear()

    def _resid_args(self) -> tuple:
        """Trailing (resid, rscales) sharded args of the residual-aware
        programs; empty on the single-level tiers."""
        if not self.residual:
            return ()
        return self._pieces["resid"], self._pieces["rscales"]

    def _queries(self, queries) -> torch.Tensor:
        return _as_rows(queries).to(self._devices[0])

    def _ext(self, idx: torch.Tensor) -> np.ndarray:
        idx = idx.cpu().numpy()
        return np.where(idx >= 0, self._h_ids[np.maximum(idx, 0)], -1)

    # ----------------------------------------------------------- search
    @_reads
    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded search -> (external ids, dists), numpy [Q, k].
        Below ``fused_threshold`` live rows a shard: the exact scan (raw)
        or the exact int8 scan (compressed); at or above it,
        :meth:`search_fused`."""
        if len(self._slot_of) >= self.fused_threshold * self.n_shards:
            # search() holds the read lock already: a nested read() could
            # deadlock behind a waiting writer
            return self._search_fused_impl(queries, k)
        self._refresh()
        q, p = self._queries(queries), self._pieces
        if self.raw:
            d, idx = sharded_knn(self.mesh, k, self.metric)(
                q, p["vectors"], p["valid"], p["norms"])
        else:
            d, idx = sharded_knn_int8(self.mesh, k, self.metric,
                                      self.residual)(
                q, p["packed"], p["scales"], p["valid"], p["norms"],
                *self._resid_args())
        return self._ext(idx), d.cpu().numpy()

    @_reads
    def search_fused(self, queries, k: int, pool: int = 64
                     ) -> tuple[np.ndarray, np.ndarray]:
        return self._search_fused_impl(queries, k, pool)

    def _conditioning(self) -> list:
        """Each shard's pool conditioning, rebuilt only for shards whose
        version moved since it was built (readers share the cache, so the
        check and the fill hold ``_refresh_lock``)."""
        with self._refresh_lock:
            got = [self._cond[sh].get(self._versions[sh],
                                      functools.partial(self._build_cond, sh))
                   for sh, _ in _shards(self.mesh)]
        return [list(col) for col in zip(*got)]

    def _build_cond(self, sh: int) -> tuple:
        p = self._pieces
        if not self.raw:
            return _cond_int8_local(p["packed"][sh], p["scales"][sh],
                                    p["norms"][sh], p["valid"][sh],
                                    self.metric)
        local = (_cond_raw8g_local if self.int8_epilogue == "global"
                 else _cond_raw8_local)
        return local(p["vectors"][sh], p["norms"][sh], p["valid"][sh],
                     self.metric)

    def _search_fused_impl(self, queries, k: int, pool: int = 64
                           ) -> tuple[np.ndarray, np.ndarray]:
        """The fused pool scan on every shard: B4 over the compressed
        tier's own int8 rows (:func:`sharded_fused_int8`), or on the raw
        tier B2 (:func:`sharded_fused_raw8`) or, with
        ``int8_epilogue="global"``, B7 (:func:`sharded_fused_raw8g`) over
        an int8 shadow of each shard, with the exact f32 refine.  The pool
        width is the widest that divides the per-shard rows and that the
        kernels keep (``ops/kernels.preserved_pool_width``)."""
        self._refresh()
        cond = self._conditioning()
        w = preserved_pool_width(self.per_shard)
        q, p = self._queries(queries), self._pieces
        if self.raw:
            mk = (sharded_fused_raw8g if self.int8_epilogue == "global"
                  else sharded_fused_raw8)
            d, idx = mk(self.mesh, k, min(pool, w), w, self.metric)(
                q, p["vectors"], *cond)
        else:
            d, idx = sharded_fused_int8(
                self.mesh, k, min(pool, w), w, self.metric, self.residual)(
                q, p["packed"], p["scales"], p["norms"], *cond,
                *self._resid_args())
        return self._ext(idx), d.cpu().numpy()

    @_writes
    def fit_pca(self, p: int = 32, seed: int = 42) -> None:
        """Fit the PCA-proxy basis (``ops/pca.pca_fit``) on a seeded sample
        of at most 20,000 live rows (dequantized on the compressed tier)."""
        live = np.flatnonzero(self._h_valid)
        if live.size > 20000:
            rng = np.random.default_rng(seed)
            live = np.sort(rng.choice(live, 20000, replace=False))
        sample = self._rows_host(live)
        if len(sample) < 2:
            raise ValueError("need >= 2 live vectors to fit PCA")
        if self.metric == "cosine":
            sample = sample / np.maximum(
                np.linalg.norm(sample, axis=1, keepdims=True), 1e-12)
        mu, basis = pca_ops.pca_fit(sample, min(p, self.dim))
        self._set_pca(mu, basis)

    def _set_pca(self, mean, basis) -> None:
        self.pca_mean = self._dev0_tensor(mean).to(torch.float32)
        self.pca_basis = self._dev0_tensor(basis).to(torch.float32)
        self._pca_gen += 1  # every cached proxy is stale

    def _proxies(self) -> tuple[list, list]:
        """Each shard's proxy rows and their squared norms, projected
        again only where the shard's version or the basis moved (under
        ``_refresh_lock``, as the conditioning)."""
        with self._refresh_lock:
            got = [self._proxy[sh].get(
                (self._versions[sh], self._pca_gen),
                functools.partial(self._build_proxy, sh, dev))
                for sh, dev in _shards(self.mesh)]
        return [g[0] for g in got], [g[1] for g in got]

    def _build_proxy(self, sh: int, dev: torch.device) -> tuple:
        p = self._pieces
        if self.raw:
            def rows(a, b):
                return p["vectors"][sh][a:b]
        else:
            def rows(a, b):
                v = unpack_int8_rows(p["packed"][sh][a:b],
                                     p["scales"][sh][a:b])
                if self.residual:
                    v = v + unpack_int8_rows(p["resid"][sh][a:b],
                                             p["rscales"][sh][a:b])
                return v
        proxy = _project_rows(rows, self.per_shard, self.pca_mean.to(dev),
                              self.pca_basis.to(dev), self.metric == "cosine")
        return proxy, pca_ops.rows_sq_norms(proxy)

    @_reads
    def search_pca(self, queries, k: int, select_r: int = 256
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded PCA-proxy search -> (external ids, dists).  The
        proxy is projected from each shard's rows (dequantized in row
        blocks on the compressed tier) and kept until the shard changes;
        the compressed tier re-ranks its int8 rows with exact norms (and
        the residual level)."""
        if self.pca_basis is None:
            raise ValueError("no PCA basis: call fit_pca() first")
        self._refresh()
        proxy, pnorms = self._proxies()
        q, p = self._queries(queries), self._pieces
        head = (q, self.pca_mean, self.pca_basis, proxy, pnorms, p["valid"])
        if self.raw:
            d, ext = sharded_pca_search(self.mesh, k, select_r, self.metric)(
                *head, p["vectors"], p["ids"])
        else:
            d, ext = sharded_pca_search_int8(
                self.mesh, k, select_r, self.metric, self.residual)(
                *head, p["packed"], p["scales"], p["norms"], p["ids"],
                *self._resid_args())
        return ext.cpu().numpy(), d.cpu().numpy()

    @_reads
    def search_flagship(self, queries, k: int, refine: int = 1024
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded ADC scan (B3) + blocked refine -> (ids, dists):
        raw f32 rows on the raw tier, int8 rows on the compressed tier."""
        if self.codebooks is None:
            raise ValueError("no PQ codebooks: call train_pq() first")
        self._refresh()
        q, p = self._queries(queries), self._pieces
        head = (q, self.codebooks, p["codes"], p["valid"])
        if self.raw:
            d, ext = sharded_flagship(self.mesh, k, refine, self.metric)(
                *head, p["vectors"], p["ids"], self._perm())
        else:
            d, ext = sharded_flagship_int8(
                self.mesh, k, refine, self.metric, self.residual)(
                *head, p["packed"], p["scales"], p["norms"], p["ids"],
                self._perm(), *self._resid_args())
        return ext.cpu().numpy(), d.cpu().numpy()

    # ----------------------------------------------------------- persistence
    @_reads
    def save(self, path: str) -> None:
        """Checkpoint the whole sharded state in the reference's format
        (``kind: sharded``).  With host mirrors, one atomic npz of the
        mirrors; with ``host_mirror=False`` the payload is fetched and
        written one shard piece at a time (``payload_sharded``,
        ``storage/checkpoint.save_checkpoint_streamed``), so host memory
        stays O(per_shard)."""
        from ..storage import checkpoint as ckpt

        meta = {
            "format_version": 1,
            "kind": "sharded",
            "dim": self.dim,
            "capacity": self.capacity,
            "num_subspaces": self.num_subspaces,
            "metric": self.metric,
            "raw_store": self.raw,
            "refine_residual": self.residual,
            "size": self.size(),
        }
        arrays = {"ids": self._h_ids, "valid": self._h_valid}
        if not self.raw:
            arrays["scales8"] = self._h_scales
            arrays["norms"] = self._h_norms
            if self.residual:
                arrays["rscales8"] = self._h_rscales
        if self.codebooks is not None:
            arrays["codes"] = self._h_codes
            arrays["codebooks"] = self.codebooks.cpu().numpy()
        if self.perm is not None:
            arrays["perm"] = self.perm.cpu().numpy().astype(np.int32)
        if self.pca_basis is not None:
            arrays["pca_mean"] = self.pca_mean.cpu().numpy()
            arrays["pca_basis"] = self.pca_basis.cpu().numpy()
        if not self.host_mirror:
            meta["payload_sharded"] = True
            meta["writer_shards"] = self.n_shards
            meta["writer_per_shard"] = self.per_shard
            if self.raw:
                arrays["norms"] = self._h_norms
            lazy = [(f"{_PAYLOAD[name][1]}_shard{sh:05d}",
                     functools.partial(
                         lambda n, s: self._pieces[n][s].cpu().numpy(),
                         name, sh))
                    for name in self._payload_fields
                    for sh in range(self.n_shards)]
            ckpt.save_checkpoint_streamed(path, meta, arrays, lazy)
            return
        for name in self._payload_fields:
            arrays[_PAYLOAD[name][1]] = getattr(self, _PAYLOAD[name][0])
        ckpt.save_checkpoint(path, meta, arrays)

    @classmethod
    def load(cls, mesh: Mesh, path: str,
             host_mirror: bool = True) -> "ShardedDatabase":
        """Restore a sharded checkpoint (either package's) onto ``mesh``,
        which may have another shard count than the writer's: the live
        rows are placed again by water-filling (the slot layout is not
        state), a ``payload_sharded`` checkpoint one writer shard at a
        time.  The compressed levels, scales and exact norms, the codes and
        the quantizer state are restored verbatim; nothing is trained or
        packed again.  ``host_mirror`` picks the restored database's mode
        for either format."""
        from ..storage import checkpoint as ckpt

        lazy = ckpt.open_checkpoint_lazy(path)
        if lazy is None:
            raise FileNotFoundError(f"no sharded checkpoint at {path}")
        meta, arrays = lazy
        try:
            if meta.get("kind") != "sharded":
                raise ValueError(
                    f"not a sharded checkpoint: {meta.get('kind')}")
            valid = np.asarray(arrays["valid"], bool)
            ids = np.asarray(arrays["ids"], np.int64)
            raw = bool(meta.get("raw_store", True))
            residual = bool(meta.get("refine_residual", False))
            live = np.flatnonzero(valid)
            db = cls(mesh, dim=int(meta["dim"]),
                     capacity=int(meta["capacity"]),
                     num_subspaces=int(meta["num_subspaces"]),
                     metric=meta.get("metric", "l2"), raw_store=raw,
                     refine_residual=residual, host_mirror=host_mirror)
            if meta.get("payload_sharded"):
                wps = int(meta["writer_per_shard"])
                ranges = [(sh * wps, (sh + 1) * wps, f"_shard{sh:05d}")
                          for sh in range(int(meta["writer_shards"]))]
            else:
                ranges = [(0, int(meta["capacity"]), "")]
            if not raw:
                scales, norms = arrays["scales8"], arrays["norms"]
                rscales = arrays["rscales8"] if residual else None
            slot_parts = []
            for lo, hi, suf in ranges:
                live_c = live[(live >= lo) & (live < hi)]
                if live_c.size == 0:
                    continue
                rel = live_c - lo if suf else live_c
                take, slots = db._place(ids[live_c])
                if take.size != live_c.size:
                    raise ValueError(
                        f"mesh capacity lost rows on load: {take.size} of "
                        f"{live_c.size} in one range")
                if raw:
                    db._write_rows(slots, torch.from_numpy(np.asarray(
                        arrays["vectors" + suf], np.float32)[rel]))
                else:
                    db._write_levels(
                        slots, np.asarray(arrays["packed8" + suf])[rel],
                        scales[live_c], norms[live_c],
                        np.asarray(arrays["resid8" + suf])[rel]
                        if residual else None,
                        rscales[live_c] if residual else None)
                slot_parts.append(slots)
            if "codebooks" in arrays:
                db.codebooks = db._dev0_tensor(arrays["codebooks"]).to(
                    torch.float32)
            if "perm" in arrays:
                db.perm = db._dev0_tensor(arrays["perm"]).long()
            if "codes" in arrays and slot_parts:
                # live rows in order, range by range: the slots line up
                db._h_codes[np.concatenate(slot_parts)] = np.asarray(
                    arrays["codes"])[live]
            if "pca_basis" in arrays:
                db._set_pca(arrays["pca_mean"], arrays["pca_basis"])
            return db
        finally:
            arrays.close()
