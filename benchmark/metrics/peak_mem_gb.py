"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GB of 1e9 bytes: the
rows and every fit's working set (layer: device).  None off the card."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 1e9
