"""index_dispatch_ms: the index's host time outside the wait for its
answers: the program's ``index.search`` spans less its ``index.fetch``
spans (the copy of the answers to the host, which holds the wait for the
device) in the span stretch of a traced run, over the stretch's calls, in
milliseconds.  Nothing where the program records no spans, a call's root
is missing or the buffer dropped a span."""


def read(rec):
    s = rec.get("spans", {}).get("stretch")
    if not s or s["roots"] != s["calls"] or s["dropped"]:
        return None
    if s["count"].get("index.search") != s["calls"] \
            or "index.fetch" not in s["count"]:
        return None
    sec = s["seconds"]
    return (sec["index.search"] - sec["index.fetch"]) / s["calls"] * 1e3
