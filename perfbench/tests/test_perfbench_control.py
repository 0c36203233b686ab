"""The comparison that decides ``correct`` must fail: the control (the
reference in TF32 in the program's place) and the faults a search cell can
have, each planted under the window of a tiny run, on the CPU (and the
control on a card, where one is present)."""

from __future__ import annotations

import contextlib

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import run_tiny, tiny_root
from vector_db_torch.index.hnsw_pq import HnswPqIndex

CELLS = ["tiny.batch", "tiny.q1"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_holds(tmp_path, name):
    for seed in (1, 2, 3):
        prog = run_tiny(tmp_path / f"p{seed}", name, seed=seed)
        ctl = run_tiny(tmp_path / f"c{seed}", name, seed=seed,
                       system_kind="control")
        assert prog["correct"], prog["checks"]
        assert not ctl["correct"]
        assert ctl["checks"]["dist_err"]["value"] \
            > 30 * prog["checks"]["dist_err"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(tmp_path, cuda, name):
    bench, root = tiny_root(tmp_path)
    cell = run.resolve_cell(bench, name, root)
    for seed in (1, 2, 3):
        prog = run.run_cell(cell, seed, 0.5, False, cuda)
        ctl = run.run_cell(cell, seed, 0.5, False, cuda,
                           system_kind="control")
        assert prog["correct"], prog["checks"]
        assert not ctl["correct"]


def _plant(monkeypatch, fault):
    search = HnswPqIndex.search_batch
    load = HnswPqIndex.bulk_load
    state = {"prev": None}

    def half_queries(self, queries, k):
        """Half of the batch left out: its queries get the answers of the
        kept half (one query a call: every other call is left out and
        answered with the last answer)."""
        ids, d = search(self, queries, k)
        q = ids.shape[0]
        if q == 1:
            prev, state["prev"] = state["prev"], (ids, d)
            return prev if prev is not None else (ids, d)
        h = q // 2
        ids[h:2 * h], d[h:2 * h] = ids[:h], d[:h]
        return ids, d

    def altered(self, queries, k):
        """One answer altered where it is produced: the first query's
        nearest row reported as another row."""
        ids, d = search(self, queries, k)
        ids[0, 0] = (ids[0, 0] + 1) % self.store.capacity
        return ids, d

    def half_rows(self, ids, vectors):
        """Half of the rows left out of the index, all reported as
        accepted."""
        n = len(ids) // 2
        load(self, list(ids)[:n], vectors[:n])
        return list(ids)

    if fault == "half_rows":
        monkeypatch.setattr(HnswPqIndex, "bulk_load", half_rows)
    else:
        monkeypatch.setattr(HnswPqIndex, "search_batch",
                            {"half_queries": half_queries,
                             "altered": altered}[fault])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_queries", "altered", "half_rows"])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    out = run_tiny(tmp_path, name)
    assert not out["correct"], out["checks"]


def test_control_command_reads_the_upper_reading(tmp_path):
    from perfbench import control

    bench, root = tiny_root(tmp_path)
    cell = run.resolve_cell(bench, "tiny.batch", root)
    s = control.summary(control.readings(cell, [4, 5, 6], 0.3, "cpu"))
    assert s["correct"] == [False, False, False]
    assert s["dist_err_min"] > cell.limits["dist_err"]["limit"]


@pytest.mark.parametrize("name,cap", [("tiny.batch", 0), ("tiny.batch", 10),
                                      ("tiny.q1", 10)])
def test_approximate_answers_read_under_the_recall_limit(tmp_path, name,
                                                         cap):
    """The int8 pool in the place of the exact scan, whole or with its
    refine cut to the 10 candidates asked for, answers fewer of the exact
    top 10: a different result, which ``recall_at_10`` must catch.  (The
    whole pool misses a few queries in 256: only the batch cell checks
    every query in so short a window.)"""
    from perfbench import control

    bench, root = tiny_root(tmp_path)
    cell = control.variant(run.resolve_cell(bench, name, root),
                           {"search_mode": "scan_pallas_int8"})
    with control.refine_pool(cap) if cap else contextlib.nullcontext():
        out = control.readings(cell, [4], 0.3, "cpu", system_kind="program")
    assert not out[0]["correct"] and not out[0]["holds"]["recall_at_10"]
    assert out[0]["holds"]["missing"] and out[0]["holds"]["dist_err"]
