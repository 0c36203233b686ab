"""scan_roofline: the least time of the exhaustive scan at the cell's
shapes (roofline.scan_bound) over the device time of one call (the union of
every kernel, copy and set in the device-only stretch, over its calls), in
percent of the published peak."""


def read(rec):
    t = rec["device_trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return rec["scan_bound_s"] / (t["busy_s"] / t["calls"]) * 100.0
