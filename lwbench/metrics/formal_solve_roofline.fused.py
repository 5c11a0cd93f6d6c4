"""The formal solution's least time (harness/work.py) over the device
time per step of the fused kernel, which does the gather and the formal
solution in one pass, in %."""


def read(run):
    t = run.device_s_per_step('fused_kernel')
    if t is None:
        return None
    return 100.0 * run.formal_solution_least_s() / t
