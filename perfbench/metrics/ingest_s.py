"""ingest_s: the program's ``ingest.bulk_load`` spans in set-up (the
facade's bulk load: the store, the quantizers' fitting, the encode; the
span waits for the device at its end), summed, in seconds."""


def read(rec):
    s = rec.get("spans", {}).get("setup")
    if not s or s["dropped"] or "ingest.bulk_load" not in s["seconds"]:
        return None
    return s["seconds"]["ingest.bulk_load"]
