"""``torch.cuda.max_memory_allocated`` over the window and its drain, the
peak counter reset after warm-up, in GiB."""


def read(run):
    peak = run.counters.get("peak_bytes")
    return peak / 2**30 if peak else None
