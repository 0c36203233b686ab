"""The sharded programs over a mesh that spans processes
(``vector_db_torch/parallel/sharded.py`` with a ``torch.distributed``
group) and the port's ``examples/multiprocess_dcn.py`` counterpart.

* The example's single-process fallback on 8 CPU shards against the
  reference's example on its 8 virtual CPU devices (the same per-shard
  seeds): the same global slot ids, distances within 1e-4.
* One spawn of 4 gloo ranks (``torch.multiprocessing``, a ``file://``
  rendezvous under ``tmp_path``, so parallel test workers cannot collide),
  2 CPU shards a rank, serves every cross-rank case: each rank's example
  run returns the 8-shard fallback's ids; each program over the spanning
  mesh returns the single-controller 8-shard mesh's ids over the same
  global shards (the k-means programs, whose all-reduce adds in another
  order, within 1e-5 relative); ``ShardedDatabase`` refuses the spanning
  mesh, and ranks holding unequal local shard counts raise.

The ranks run one torch thread each; the single-controller side runs in
this process.  Distances are held within 1e-5 relative beside equal ids.
This module imports no JAX at its top (the ranks import it); the
reference's example is loaded inside its test.
"""

import importlib.util
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from vector_db_torch.examples import multiprocess_dcn as dcn  # noqa: E402
from vector_db_torch.ops import adc  # noqa: E402
from vector_db_torch.ops import pca as pca_ops  # noqa: E402
from vector_db_torch.ops.kernels import preserved_pool_width  # noqa: E402
from vector_db_torch.parallel import sharded as sh  # noqa: E402

CPU = torch.device("cpu")
WORLD, LOCAL = 4, 2
S = WORLD * LOCAL
N, D, Q, K = 2048, 16, 16, 10
SUB, KC = 4, 16  # PQ subspaces, centroids
EXAMPLE = ["--per-shard", "256", "--dim", "16", "--device", "cpu"]
PROGRAMS = ("kmeans_step", "subspace_kmeans", "knn", "dp_knn", "fused_raw8",
            "flagship", "pca")
#: the all-reduce adds the ranks' partials in another order than the
#: single controller's running sum: f32 order, relative
KMEANS_RTOL = 1e-5
SPAWN_TIMEOUT_S = 180


def _data():
    """The global inputs every program reads, from one seed, built with
    numpy in float64 (codes, PCA basis, proxy) so every process gets the
    same bits whatever its thread count."""
    r = np.random.default_rng(11)
    scale = (np.arange(D) + 1.0) ** -0.5
    base = (r.standard_normal((N, D)) * scale).astype(np.float32)
    valid = r.uniform(size=N) > 0.1
    q = (base[:Q] + 0.05 * r.standard_normal((Q, D))).astype(np.float32)
    perm = r.permutation(D)
    pick = base[np.sort(r.choice(N, KC, replace=False))]
    cb = pick[:, perm].reshape(KC, SUB, D // SUB).transpose(1, 0, 2).copy()
    sub = base[:, perm].reshape(N, SUB, 1, D // SUB).astype(np.float64)
    codes = ((sub - cb[None]) ** 2).sum(-1).argmin(-1).astype(np.uint8)
    mean, basis = pca_ops.pca_fit(base, 8)
    proxy32 = ((base.astype(np.float64) - mean) @ basis).astype(np.float32)
    proxy = torch.from_numpy(proxy32).to(torch.bfloat16)
    return dict(base=base, valid=valid, norms=(base * base).sum(1), q=q,
                cents=base[:KC].copy(), perm=perm, cb=cb, codes=codes,
                w=valid.astype(np.float32), ids=np.arange(N, dtype=np.int32),
                mean=mean, basis=basis, proxy=proxy,
                pnorms=proxy.to(torch.float32).pow(2).sum(1))


def _programs(mesh):
    """Every program held across ranks, on ``mesh`` over ``_data()``:
    name -> tuple of numpy outputs."""
    g = {k: torch.as_tensor(v) for k, v in _data().items()}
    base, valid, norms, w, codes, ids, proxy, pnorms = sh.shard_corpus(
        mesh, g["base"], g["valid"], g["norms"], g["w"], g["codes"],
        g["ids"], g["proxy"], g["pnorms"])
    q, n_s = g["q"], N // S
    out = {"kmeans_step": (sh.sharded_kmeans_step(mesh)(base, g["cents"]),),
           "subspace_kmeans": (sh.sharded_subspace_kmeans(mesh, SUB, 3)(
               base, g["cb"], w, g["perm"]),),
           "knn": sh.sharded_knn(mesh, K)(q, base, valid, norms),
           "dp_knn": sh.dp_knn(mesh, K)(q, g["base"], g["valid"],
                                        g["norms"])}
    cond = sh.sharded_cond_raw8(mesh)(base, norms, valid)
    wp = preserved_pool_width(n_s)
    out["fused_raw8"] = sh.sharded_fused_raw8(mesh, K, min(64, wp), wp)(
        q, base, *cond)
    out["flagship"] = sh.sharded_flagship(mesh, K, 32)(
        q, g["cb"], codes, valid, base, ids, g["perm"])
    out["pca"] = sh.sharded_pca_search(mesh, K, 48)(
        q, g["mean"], g["basis"], proxy, pnorms, valid, base, ids)
    return {k: tuple(t.cpu().numpy() for t in v) for k, v in out.items()}


def _refusals(group):
    """What the spanning mesh refuses: (ShardedDatabase on it, unequal
    local shard counts), each the exception's type name and message."""
    got = []
    mesh = sh.make_mesh(devices=[CPU] * LOCAL, group=group)
    try:
        sh.ShardedDatabase(mesh, dim=D, capacity=N)
        got.append("no error")
    except ValueError as e:
        got.append(f"ValueError: {e}")
    try:  # rank 0 holds one shard, the others two
        sh.make_mesh(devices=[CPU] * (1 if dist.get_rank() == 0 else LOCAL),
                     group=group)
        got.append("no error")
    except ValueError as e:
        got.append(f"ValueError: {e}")
    return got


def _rank_main(rank, url, out_dir):
    """One rank: the example across the group, every program over the
    spanning mesh, the refusals; saved to ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    d, idx = dcn.main(EXAMPLE + [
        "--coordinator", url, "--num-processes", str(WORLD),
        "--process-id", str(rank), "--local-shards", str(LOCAL)])
    try:
        group = dist.group.WORLD
        mesh = sh.make_mesh(devices=[CPU] * LOCAL, group=group)
        saved = {"example_d": d, "example_idx": idx,
                 "first_shard": np.asarray(mesh.first_shard),
                 "global_shards": np.asarray(mesh.global_shards),
                 "refusals": np.asarray(_refusals(group))}
        for name, outs in _programs(mesh).items():
            for j, a in enumerate(outs):
                saved[f"{name}.{j}"] = a
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank gloo spawn, once for every case: each rank's saved
    outputs."""
    out = tmp_path_factory.mktemp("ranks")
    url = f"file://{out / 'rendezvous'}"
    ctx = tmp.spawn(_rank_main, args=(url, str(out)), nprocs=WORLD,
                    join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The single-controller mesh of all S shards in this process."""
    return _programs(sh.make_mesh(devices=[CPU] * S))


@pytest.fixture(scope="module")
def fallback():
    return dcn.main(EXAMPLE + ["--local-shards", str(S)])


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


# ------------------------------------------------------------- the example
def test_fallback_matches_the_reference_example(fallback):
    """The port's single-process fallback on 8 CPU shards against the
    reference's example on its 8 virtual devices (tests/test_sharded.py
    runs it so): global shard s from default_rng(42 + s) in both."""
    jax = pytest.importorskip("jax")
    assert len(jax.devices()) >= S, "conftest must provide 8 devices"
    spec = importlib.util.spec_from_file_location(
        "mp_example", "examples/multiprocess_dcn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want_d, want_idx = mod.main(["--per-shard", "256", "--dim", "16"])
    d, idx = fallback
    assert d.shape == (64, 10) and (idx >= 0).all()
    np.testing.assert_array_equal(idx, np.asarray(want_idx))
    np.testing.assert_allclose(d, np.asarray(want_d), rtol=1e-4, atol=1e-4)


def test_fallback_agrees_with_numpy_brute_force(fallback):
    rows = np.concatenate([dcn.shard_rows(s, 256, 16) for s in range(S)])
    q = dcn.queries(16, CPU).numpy()
    dist2 = ((q[:, None].astype(np.float64) - rows[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(fallback[1],
                                  np.argsort(dist2, 1, kind="stable")[:, :10])


def test_every_rank_returns_the_fallback_result(ranks, fallback):
    d, idx = fallback
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["example_idx"], idx, err_msg=r)
        _close(got["example_d"], d)


def test_ranks_hold_their_global_shards(ranks):
    for r, got in enumerate(ranks):
        assert int(got["first_shard"]) == r * LOCAL
        assert int(got["global_shards"]) == S


# ---------------------------------------------------- programs across ranks
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_across_ranks_matches_single_controller(ranks, single,
                                                        name):
    """Every rank gets the single controller's result over the same
    global shards: ids equal, distances within 1e-5; the k-means
    programs' centroids within KMEANS_RTOL."""
    want = single[name]
    for r, got in enumerate(ranks):
        outs = [got[f"{name}.{j}"] for j in range(len(want))]
        if name in ("kmeans_step", "subspace_kmeans"):
            _close(outs[0], want[0], KMEANS_RTOL)
            continue
        d, idx = outs
        np.testing.assert_array_equal(idx, want[1], err_msg=f"rank {r}")
        _close(d, want[0])
        assert (idx >= 0).mean() > 0.9


def test_sharded_database_refuses_a_spanning_mesh(ranks):
    for got in ranks:
        msg = str(got["refusals"][0])
        assert msg.startswith("ValueError") and "single-controller" in msg


def test_unequal_local_shard_counts_raise_on_every_rank(ranks):
    for got in ranks:
        msg = str(got["refusals"][1])
        assert msg.startswith("ValueError") and "[1, 2, 2, 2]" in msg


# ------------------------------------------------------- single controller
def test_mesh_without_a_group_is_the_whole_axis():
    mesh = sh.make_mesh(devices=[CPU] * 3)
    assert mesh.group is None and (mesh.rank, mesh.world) == (0, 1)
    assert mesh.local_shards == mesh.global_shards == mesh.size == 3
    assert mesh.first_shard == 0


def test_process_local_rows_land_on_the_local_shards():
    """``shard_process_local`` splits only this process's rows over its
    devices: on a mesh without a group it equals ``shard_corpus``."""
    mesh = sh.make_mesh(devices=[CPU] * 4)
    x = torch.arange(40.0).reshape(20, 2)
    for a, b in zip(sh.shard_process_local(mesh, x)[0],
                    sh.shard_corpus(mesh, x)[0]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not split"):
        sh.shard_process_local(mesh, torch.zeros(6, 2))


def test_example_local_devices():
    assert dcn.local_devices("cpu", None) == [CPU]
    assert dcn.local_devices("cpu", 3) == [CPU] * 3
