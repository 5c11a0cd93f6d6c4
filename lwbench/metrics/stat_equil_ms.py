"""ms per MALI step in stat_equil (the host clock around the call, the
card synchronised before and after it), over the traced window."""


def read(run):
    return run.span_ms_per_step('stat_equil')
