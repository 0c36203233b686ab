"""search_qps: queries answered in the window over the window's whole
time, by the host's clock."""


def read(rec):
    w = rec["window"]
    return w["queries"] / w["seconds"]
