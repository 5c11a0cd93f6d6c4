"""Milliseconds per MALI step: the window's seconds over the MALI steps
it completed."""


def read(run):
    return run.window_s / run.steps * 1e3
