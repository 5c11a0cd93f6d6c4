"""ms per MALI step in the formal solution: the gather and formal_solve
stages of the program's step (host clock, synchronised around each)."""


def read(run):
    return run.span_ms_per_step('gather', 'formal_solve')
