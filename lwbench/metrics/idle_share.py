"""The card's idle share over the traced steps: 1 - its busy seconds
(the union of the device operations' intervals) over their wall
seconds."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace['busy_s'] / run.trace['window_s']
