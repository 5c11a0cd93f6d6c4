"""ms per MALI step in prd_redistribute, the PRD sub-iterations (the
harness's span ``prd``: host clock, the card synchronised before and
after it), over the traced window."""


def read(run):
    return run.span_ms_per_step('prd')
