"""The process's peak of allocated device memory
(``torch.cuda.max_memory_allocated``) over set-up and window, in GiB."""
UNIT, SOURCE, MOVES = "GiB", "device_trace", None


def read(run):
    return run.peak_bytes / 2 ** 30
