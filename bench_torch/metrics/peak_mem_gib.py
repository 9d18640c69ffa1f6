"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` as it opened."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
