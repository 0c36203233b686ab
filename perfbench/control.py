"""The readings that the limits of ``checks/<workload>.json`` are set from.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--system control|program] \\
        [--index-config '{"search_mode": "scan_pallas_int8"}'] \\
        [--refine-pool 16]

For each seed, one run of the cell (``run.run_cell``) with a short window
at the cell's own load and sizes.  ``--system control`` (the default) puts
the control in the program's place (``reference.LowerPrecisionSearch``:
the reference with its cross term in TF32): its smallest ``dist_err`` is
the upper reading of that limit.  ``--system program`` runs the program,
with ``--index-config`` laid over the configuration's index config (an
approximate search mode where the configuration states exact answers)
and with ``--refine-pool`` cutting the candidates that the int8 pool hands
its exact refine: its largest ``recall_at_10`` is the upper reading of
that limit, which a sound program's least reading must stay above.
Prints one JSON line a seed with the compared numbers and whether each
held, then a summary line.  The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time

import torch

from . import run


def variant(cell: run.Cell, index_config: dict) -> run.Cell:
    """``cell`` with ``index_config`` laid over its configuration's."""
    out = copy.deepcopy(cell)
    out.config["index_config"].update(index_config)
    return out


@contextlib.contextmanager
def refine_pool(cap: int):
    """The int8 pool's candidates cut to ``cap`` before the exact refine,
    planted in the program (``index/hnsw_pq.pallas_scan8_refine``)."""
    from vector_db_torch.index import hnsw_pq

    orig = hnsw_pq.pallas_scan8_refine

    def cut(*args, pool, w):
        return orig(*args, pool=min(pool, cap), w=w)

    hnsw_pq.pallas_scan8_refine = cut
    try:
        yield
    finally:
        hnsw_pq.pallas_scan8_refine = orig


def readings(cell: run.Cell, seeds: list, seconds: float,
             device="cuda", system_kind: str = "control") -> list:
    out = []
    for seed in seeds:
        res = run.run_cell(cell, seed, seconds, False, device,
                           system_kind=system_kind)
        log = res["_log"]
        out.append({"seed": seed,
                    "correct": res["correct"],
                    "numbers": {k: c["value"] for k, c in res["checks"].items()},
                    "holds": log["holds"],
                    "checked_answers": log["checked_answers"],
                    "calls": log["calls"]})
        print(json.dumps(out[-1]), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def summary(rows: list) -> dict:
    nums = [r["numbers"] for r in rows]
    return {"dist_err_min": min(n["dist_err"] for n in nums),
            "dist_err_max": max(n["dist_err"] for n in nums),
            "recall_min": min(n["recall_at_10"] for n in nums),
            "recall_max": max(n["recall_at_10"] for n in nums),
            "missing_max": max(n["missing"] for n in nums),
            "correct": [r["correct"] for r in rows]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--system", choices=("control", "program"),
                   default="control")
    p.add_argument("--index-config", default="{}")
    p.add_argument("--refine-pool", type=int, default=0)
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = variant(run.resolve_cell(bench, args.workload),
                   json.loads(args.index_config))
    run.require_cards(cell.chips)
    t0 = time.perf_counter()
    cut = (refine_pool(args.refine_pool) if args.refine_pool
           else contextlib.nullcontext())
    with cut:
        rows = readings(cell, [int(s) for s in args.seeds.split(",")],
                        args.seconds, system_kind=args.system)
    print(json.dumps({"workload": args.workload, "system": args.system,
                      "index_config": cell.config["index_config"],
                      "refine_pool": args.refine_pool,
                      "seconds": time.perf_counter() - t0,
                      "kind": torch.cuda.get_device_name(0),
                      "power_limit": run.power_limit(),
                      **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
