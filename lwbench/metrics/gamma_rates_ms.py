"""ms per MALI step in the gamma_rates stage (host clock, synchronised
around it)."""


def read(run):
    return run.span_ms_per_step('gamma_rates')
