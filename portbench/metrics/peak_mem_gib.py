"""The device memory the window's steps held at their peak (GiB): the
allocator's ``max_memory_allocated`` over the window, reset at its start.
It decides how many cameras one card holds."""


def read(run):
    return run.peak_mem_bytes / 2 ** 30 if run.peak_mem_bytes else None
