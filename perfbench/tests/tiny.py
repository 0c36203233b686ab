"""A benchmark root of tiny cells for the CPU tests: a copy of the
harness's data files beside BENCHMARK.json, with cells of 6,000 x 64 rows
added as new files only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import run

DATA_DIRS = ("configs", "traffic", "metrics", "checks", "kernels")
#: the tiny cells' limits: the exact scan's answers at 6,000 x 64
LIMITS = {"dist_err": {"limit": 1e-5}, "recall_at_10": {"limit": 0.9996}}


def tiny_root(tmp: Path, search_mode: str = "auto",
              distribution: str = "gaussian") -> tuple[dict, Path]:
    """(the parsed BENCHMARK.json, its root) with the cells
    ``tiny.batch`` and ``tiny.q1`` added beside the real ones."""
    files = tmp / "perfbench"
    for d in DATA_DIRS:
        shutil.copytree(run.ROOT / "perfbench" / d, files / d)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cfg = run.load_json(files / "configs" / "flagship-512d-100k.json")
    cfg.update(name="tiny", dim=64, rows=6000, max_elements=6000,
               row_distribution=distribution,
               index_config={"num_subspaces": 8, "training_samples": 2000,
                             "search_mode": search_mode})
    (files / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for mix, batch, trace_calls in (("batch", 64, 3), ("q1", 1, 8)):
        src = "batch1024" if mix == "batch" else "q1"
        traffic = run.load_json(files / "traffic" / f"{src}.json")
        traffic.update(batch=batch, pool=256, trace_calls=trace_calls,
                       warmup_calls=2)
        (files / "traffic" / f"tiny-{mix}.json").write_text(
            json.dumps(traffic))
        name = f"tiny.{mix}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": f"tiny-{mix}", "chips": 1,
                                   "why": "the CPU tests' cell"})
        (files / "checks" / f"{name}.json").write_text(json.dumps(LIMITS))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(w.endswith(src) for w in m.get("workloads", [])):
                m["workloads"].append(name)
    bench["configs"].append({"name": "tiny", "source": "the CPU tests",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "the CPU tests' cell"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, tmp


def run_tiny(tmp: Path, name: str, seed: int = 7, seconds: float = 0.5,
             traced: bool = False, system_kind: str = "program",
             **root_kw) -> dict:
    bench, root = tiny_root(tmp, **root_kw)
    cell = run.resolve_cell(bench, name, root)
    return run.run_cell(cell, seed, seconds, traced, "cpu",
                        system_kind=system_kind)
