"""setup_s: seconds from the run's start to the end of its warm-up
(loading, the ingest, building kernels and caches, warming the cell's
shapes), by the host's clock."""


def read(rec):
    return rec["setup_s"]
