"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window, in GB (1e9
bytes)."""


def read(run):
    return run.peak_bytes / 1e9
