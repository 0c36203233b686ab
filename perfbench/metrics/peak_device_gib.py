"""peak_device_gib: torch.cuda.max_memory_allocated() from just before the
database is built to the end of the window, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
