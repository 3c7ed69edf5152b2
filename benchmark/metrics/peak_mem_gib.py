"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start."""


def read(rec):
    return rec.peak_mem_bytes / 2**30 if rec.peak_mem_bytes > 0 else None
