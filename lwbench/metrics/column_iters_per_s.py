"""Column-iterations per second: the MALI steps of columns not yet
converged when each step began, over the window's seconds."""


def read(run):
    if run.kind != 'column_batch':
        return None
    return run.column_iterations / run.window_s
