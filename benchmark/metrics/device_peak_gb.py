"""device_peak_gb: torch.cuda.max_memory_allocated over the window (the
benchmark's own buffers freed and the peak reset before it), in GB of
1e9 bytes; nothing off a card."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
