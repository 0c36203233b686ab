"""The traffic generator: the one reader of ``traffic/<mix>.json``.

A mix is a closed loop of one client (an embedded library's caller waits
for each reply) over a pool of queries drawn from the seed.  Its keys:

  * ``api``: ``search_batch`` (``db.search_batch(queries, k)``) or
    ``search`` (``db.search(query, k)``, one query a call);
  * ``batch``: queries a call (1 for ``search``); ``pool``: distinct
    queries, a multiple of ``batch``; ``k``;
  * ``clients`` (1) and ``loop`` (``closed``): the only load this
    generator offers;
  * ``warmup_calls``: calls of set-up, on the window's own shapes;
  * ``check_first``: the window's first calls, whose answers are all
    compared with the reference; ``check_share``: the chance, drawn from
    the seed, that a later call's answers are compared too;
  * ``trace_calls``: calls under the profiler in a traced run.

The pool is cut into ``pool / batch`` batches; the window visits them in
an order drawn from the seed, and again in that order once it has visited
them all.  Every seed gets the same sizes; only the values change.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import data

#: calls a window can make that the check mask covers
MAX_CALLS = 1 << 22
KEYS = {"api", "batch", "k", "pool", "clients", "loop", "warmup_calls",
        "check_first", "check_share", "trace_calls", "why"}


@dataclasses.dataclass
class Plan:
    api: str
    k: int
    batch: int
    pool: np.ndarray        # [pool, dim] f32 host queries
    order: np.ndarray       # batch visited by call i is order[i % len(order)]
    check: np.ndarray       # [MAX_CALLS] bool: call i's answers are compared
    warmup_calls: int
    trace_calls: int

    def batch_of(self, call: int) -> int:
        return int(self.order[call % self.order.shape[0]])

    def query_ids(self, b: int) -> np.ndarray:
        """Pool rows of batch ``b``."""
        return np.arange(b * self.batch, (b + 1) * self.batch)

    def argument(self, b: int) -> np.ndarray:
        """What the call hands the API: a [batch, dim] host array, or one
        [dim] row for ``search``."""
        if self.api == "search":
            return self.pool[b]
        return self.pool[b * self.batch:(b + 1) * self.batch]

    def checked(self, call: int) -> bool:
        return call < MAX_CALLS and bool(self.check[call])


def validate(traffic: dict) -> None:
    extra = set(traffic) - KEYS
    if extra:
        raise ValueError(f"unknown traffic keys {sorted(extra)}")
    if traffic["api"] not in ("search_batch", "search"):
        raise ValueError(f"unknown api {traffic['api']!r}")
    if traffic["api"] == "search" and traffic["batch"] != 1:
        raise ValueError("api 'search' sends one query a call (batch 1)")
    if traffic["clients"] != 1 or traffic["loop"] != "closed":
        raise ValueError("this generator offers a closed loop of one client")
    if traffic["pool"] % traffic["batch"]:
        raise ValueError("pool must be a multiple of batch")


def make_plan(traffic: dict, config: dict, seed: int, device) -> Plan:
    validate(traffic)
    pool = data.draw_queries(config, traffic["pool"], seed, device)
    n_batches = traffic["pool"] // traffic["batch"]
    order = data.host_rng(seed, data.ORDER_STREAM).permutation(n_batches)
    u = data.host_rng(seed, data.CHECK_STREAM).random(MAX_CALLS,
                                                      dtype=np.float32)
    check = u < traffic["check_share"]
    check[:traffic["check_first"]] = True
    return Plan(api=traffic["api"], k=traffic["k"], batch=traffic["batch"],
                pool=pool, order=order, check=check,
                warmup_calls=traffic["warmup_calls"],
                trace_calls=traffic["trace_calls"])
