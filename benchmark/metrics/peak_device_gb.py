"""`torch.cuda.max_memory_allocated()` over the window, reset at its start,
in GB: the index and the search's transients."""


def read(run):
    return run.peak_window_bytes / 1e9
