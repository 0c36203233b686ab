"""The port's two table examples against the reference's, on the CPU at a
small size (``--n 1000 --dim 32 --queries 20``): each reference example
runs in this process with ``sys.argv`` set (it takes no argv) and its
printed table is parsed; the port's ``main(argv)`` returns its rows.

Bars: the same rows in the same order; BRUTE's recall equal (1.0); every
other row's Recall@10 within 0.05 of the reference's (the quantizers'
k-means draws differ: ``jax.random`` there, a ``torch.Generator`` here);
the compression ratios equal and the memory saved within 0.1 points (the
same ``stats()`` arithmetic on the same capacities).
"""

import contextlib
import importlib.util
import io
import re
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_torch.examples import compression_example as ce  # noqa: E402
from vector_db_torch.examples import vector_database_example as vde  # noqa: E402,E501

ARGS = ["--n", "1000", "--dim", "32", "--queries", "20"]
RECALL_TOL = 0.05
VDE_ROW = re.compile(r"^(\w+)\s+[\d.]+\s+\d+\s+[\d.]+\s+([\d.]+)%\s+[\d.]+$")
CE_ROW = re.compile(r"^(.+?) +(\d+)x +[\d.]+ +[\d.]+ +([\d.]+)% +[\d.]+ +"
                    r"(-?[\d.]+)%$")


def _reference_table(path, pattern):
    """Run the reference example at ARGS; its table's rows as regex
    groups."""
    spec = importlib.util.spec_from_file_location("ref_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [path] + ARGS)
        mod.main()
    return [m.groups() for m in map(pattern.match,
                                    out.getvalue().splitlines()) if m]


@pytest.fixture(scope="module")
def vde_rows():
    """(the port's rows, the reference's parsed rows)."""
    return (vde.main(ARGS + ["--device", "cpu"]),
            _reference_table("examples/vector_database_example.py", VDE_ROW))


@pytest.fixture(scope="module")
def ce_rows():
    return (ce.main(ARGS + ["--device", "cpu"]),
            _reference_table("examples/compression_example.py", CE_ROW))


def test_vector_database_example_has_the_references_rows(vde_rows):
    got, want = vde_rows
    assert len(want) == 7
    assert [r["index"] for r in got] == [w[0] for w in want]


@pytest.mark.parametrize("row", range(7))
def test_vector_database_example_recall(vde_rows, row):
    got, want = vde_rows
    name, rec = want[row]
    ref = float(rec) / 100
    if name == "brute":
        assert got[row]["recall"] == ref == 1.0
    else:
        assert abs(got[row]["recall"] - ref) <= RECALL_TOL, (name, ref)


def test_compression_example_has_the_references_rows(ce_rows):
    got, want = ce_rows
    assert len(want) == 8
    assert [r["preset"] for r in got] == [w[0] for w in want]


@pytest.mark.parametrize("row", range(8))
def test_compression_example_row(ce_rows, row):
    """Recall within RECALL_TOL, the ratio equal, memory saved within 0.1
    points."""
    got, want = ce_rows
    name, ratio, rec, saved = want[row]
    assert round(got[row]["ratio"]) == int(ratio), name
    assert abs(got[row]["saved_pct"] - float(saved)) <= 0.1, name
    assert abs(got[row]["recall"] - float(rec) / 100) <= RECALL_TOL, name
