"""facade_self_ms: the harness's span around each facade call less the
program's own "search_batch" timer (utils/stats.GLOBAL, around the index's
search), as a mean a call over the window, in milliseconds: the facade's
own time, most of it building the result objects."""


def read(rec):
    w, prog = rec["window"], rec["program"]
    if prog["counts"].get("search_batch.calls") != w["calls"]:
        return None
    return (float(w["call_s"].sum()) - prog["seconds"]["search_batch"]) \
        / w["calls"] * 1e3
