"""The peak of the card's allocated memory over the window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats at its
start), in GiB."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
