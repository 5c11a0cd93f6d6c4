"""The device's busy ms per MALI step in the operations that the host
launched inside the program's lw.fused_stage span (the fused scheme's
gather and formal solution: the fused kernel and its inputs), over the
profiled steps of the program's tracer."""


def read(run):
    return run.program_span('lw.fused_stage', 'busy_ms')
