"""The benchmark of ``vector_db_torch`` on an NVIDIA GPU.

One run measures one cell of ``BENCHMARK.json`` (a deployment under a
traffic mix) through ``vector_db_torch.VectorDatabase``::

    python3 -m perfbench.run --workload flagship-100k.batch1024 \\
        --seed 12345 --seconds 20 --trace 0

Everything that belongs to one deployment, one traffic mix or one metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<workload>.json`` (the limits of the comparison that decides
``correct``), ``metrics/<metric>.py`` (a reader that takes one number from
the run's records; a metric split by the end-to-end metric it moves, such
as ``device_idle_pct.batch``, falls back to the file of its name up to the
first dot) and ``kernels/<function>.json`` (the device names of a
hand-written kernel, for the launch check of a traced run).  A
configuration names its Builder calls, its ingest method and its storage,
so a deployment of another index type, compression or ingest path is a
file too.  The shared code lives in ``run.py`` (the run and its last
line), ``data.py`` (rows and queries from the seed), ``loadgen.py`` (the
traffic generator), ``reference.py`` (the plain exact search and its
lower-precision control), ``check.py`` (the comparison), ``roofline.py``,
``trace.py`` and ``host.py`` (the collector's pauses and the CPU time of
the window, for the run's log).

Nothing here imports JAX or the JAX package, and ``reference.py`` and
``check.py`` import nothing of ``vector_db_torch``.
"""
