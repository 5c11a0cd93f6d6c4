"""ms per MALI step in which the device is idle inside the program's
lw.formal_solve span (its children included), over the profiled steps of
the program's tracer (harness/program_trace.py:readings)."""


def read(run):
    return run.program_reading('formal_solve_idle_ms')
