"""The device's busy ms per MALI step in the operations that the host
launched inside the program's lw.prd.subset_solve spans (the formal
solution on the PRD-active wavelengths, every sub-iteration), over the
profiled steps of the program's tracer."""


def read(run):
    return run.program_span('lw.prd.subset_solve', 'busy_ms')
