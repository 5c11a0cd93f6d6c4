"""The device's busy ms per MALI step in the operations that the host
launched inside the program's lw.hprd.rest_frame_j span (hybrid PRD's
rest-frame J of the MALI step's formal solution), over the profiled
steps of the program's tracer."""


def read(run):
    return run.program_span('lw.hprd.rest_frame_j', 'busy_ms')
