"""ingest_train_s: the program's ``ingest.train`` spans in set-up (the PQ
codebooks', the proxy's and the coarse quantizer's fitting, without the
encode; the span waits for the device at its end), summed, in seconds."""


def read(rec):
    s = rec.get("spans", {}).get("setup")
    if not s or s["dropped"] or "ingest.train" not in s["seconds"]:
        return None
    return s["seconds"]["ingest.train"]
