"""Device operations (kernels, copies, fills) per MALI step, counted by
the profiler over the traced steps."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace['ops']) / run.trace['steps']
