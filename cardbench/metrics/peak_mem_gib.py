"""GiB of ``torch.cuda.max_memory_allocated()`` over set-up and window, read
before the reference runs.  End to end."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec.get("peak_bytes") else None
