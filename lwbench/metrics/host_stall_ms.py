"""ms per MALI step in which the device is idle while the host is inside
one of the program's lw.host.* spans (the populations' round trip, the
numpy Ng, the flags and dJ read back), over the profiled steps of the
program's tracer (harness/program_trace.py:readings)."""


def read(run):
    return run.program_reading('host_stall_ms')
