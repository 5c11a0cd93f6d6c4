"""Device operations per MALI step that the host launched inside the
program's lw.gamma_rates span (its per-atom children included), over the
profiled steps of the program's tracer
(harness/program_trace.py:readings)."""


def read(run):
    return run.program_reading('gamma_rates_launches')
