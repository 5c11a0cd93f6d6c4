"""The device's busy ms per MALI step in the operations that the host
launched inside the program's lw.prd.scatter_rho spans (each PRD line's
scattering integral, every sub-iteration), over the profiled steps of
the program's tracer."""


def read(run):
    return run.program_span('lw.prd.scatter_rho', 'busy_ms')
