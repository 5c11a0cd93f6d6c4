"""The formal solution's least time (harness/work.py) over the device
time per step of the kernels that do it (by name: the sweep kernel, or
the fused kernel that also does the gather), in %."""

KERNELS = ('sweep_kernel', 'fused_kernel')


def read(run):
    t = run.device_s_per_step(*KERNELS)
    if t is None:
        return None
    return 100.0 * run.formal_solution_least_s() / t
