"""index_ms: the program's "search_batch" timer (utils/stats.GLOBAL,
around the index's search, which ends in the copy of the answers to the
host) as a mean a call over the window, in milliseconds."""


def read(rec):
    w, prog = rec["window"], rec["program"]
    if prog["counts"].get("search_batch.calls") != w["calls"]:
        return None
    return prog["seconds"]["search_batch"] / w["calls"] * 1e3
