"""launches_per_call: kernel launches the profiler saw in the device-only
stretch, over its calls: the index's dispatch."""


def read(rec):
    t = rec["device_trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["calls"]
