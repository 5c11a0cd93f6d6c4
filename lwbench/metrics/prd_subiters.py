"""PRD sub-iterations per MALI step: the program's lw.prd.subiter spans
closed per step, over the tracer's steps of a traced run."""


def read(run):
    return run.program_span('lw.prd.subiter', 'count')
