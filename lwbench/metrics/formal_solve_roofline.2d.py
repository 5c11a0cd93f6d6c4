"""The formal solution's least time (harness/work.py) over the device's
busy time per step inside the gather and formal_solve stages (the
traced steps; no kernel of its own does the 2D plane sweep yet), in %."""


def read(run):
    t = run.stage_busy_s_per_step('gather', 'formal_solve')
    if t is None:
        return None
    return 100.0 * run.formal_solution_least_s() / t
