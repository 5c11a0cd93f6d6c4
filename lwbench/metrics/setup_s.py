"""Seconds from process start to the window's start: inputs, the
system built on the card, the kernels built or loaded, the warm-up."""


def read(run):
    return run.setup_s
