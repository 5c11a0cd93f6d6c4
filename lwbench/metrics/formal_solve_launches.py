"""Device operations per MALI step that the host launched inside the
program's lw.formal_solve span (its children included), over the
profiled steps of the program's tracer
(harness/program_trace.py:readings)."""


def read(run):
    return run.program_reading('formal_solve_launches')
