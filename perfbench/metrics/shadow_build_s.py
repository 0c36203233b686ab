"""shadow_build_s: the program's ``index.shadow`` spans in set-up (a scan
shadow built or refreshed, as the first pool search builds the int8
shadow; the span does not wait for the device, and set-up ends in a
synchronization), summed, in seconds.  Nothing where no shadow was built,
as under the exact scan."""


def read(rec):
    s = rec.get("spans", {}).get("setup")
    if not s or s["dropped"] or "index.shadow" not in s["seconds"]:
        return None
    return s["seconds"]["index.shadow"]
