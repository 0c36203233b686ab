"""facade_results_ms: the program's ``facade.results`` spans (the facade
building its result objects, ``.tolist()`` included) in the span stretch
of a traced run (tracing on, no profiler), summed and divided by the
stretch's calls, in milliseconds.  Nothing where the program records no
spans, a call's root is missing or the buffer dropped a span."""


def read(rec):
    s = rec.get("spans", {}).get("stretch")
    if not s or s["roots"] != s["calls"] or s["dropped"]:
        return None
    if s["count"].get("facade.results") != s["calls"]:
        return None
    return s["seconds"]["facade.results"] / s["calls"] * 1e3
