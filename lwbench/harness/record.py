"""What a run hands to the metric readers (lwbench/metrics/<name>.py).

A reader takes a Record and returns its metric's value, or None where
the run has nothing for it to read (an untraced run for a traced metric);
the harness then leaves the metric out of the line.

A traced run holds three sources: ``spans``, the harness's spans around
the program's stages (host clock, synchronised); ``trace``, the device
trace of the profiled steps (harness/trace.py); and ``program``, the
program's own lw.* spans and host-transfer counters over further steps
(harness/program_trace.py:measure: its span table and readings).
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .work import formal_solution_work


@dataclass
class Record:
    kind: str                 # the configuration's kind
    dtype: str                # the working precision the run used
    Nlam: int
    Nmu: int                  # rays per direction
    Nk: int                   # points: columns x depths, or Nz x Nx
    setup_s: float
    window_s: float
    steps: int                # MALI steps in the window
    column_iterations: int    # MALI steps of columns not yet converged
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[dict] = None
    window_peak_bytes: Optional[int] = None
    program: Optional[dict] = None

    def span_ms_per_step(self, *names) -> Optional[float]:
        """The spans' seconds summed over the window, per MALI step, in
        ms; None without them."""
        if not all(self.spans.get(n) for n in names):
            return None
        return sum(sum(self.spans[n]) for n in names) / self.steps * 1e3

    def device_s_per_step(self, *patterns) -> Optional[float]:
        """The traced device seconds per step of the operations whose
        name holds one of ``patterns``; None untraced or where none ran."""
        if self.trace is None:
            return None
        s = sum(t for name, t in self.trace['ops']
                if any(p in name for p in patterns))
        return s / self.trace['steps'] if s > 0 else None

    def stage_busy_s_per_step(self, *stages) -> Optional[float]:
        """The traced device's busy seconds per step inside the stages;
        None untraced or where none was busy."""
        if self.trace is None:
            return None
        s = sum(self.trace['busy_by_stage'].get(n, 0.0) for n in stages)
        return s / self.trace['steps'] if s > 0 else None

    def program_reading(self, name: str) -> Optional[float]:
        """One of program_trace.readings; None untraced."""
        if self.program is None:
            return None
        return self.program['readings'].get(name)

    def program_span(self, path: str, key: str) -> Optional[float]:
        """Per step, the span table's ``key`` for the lw.* span ``path``
        (a span's name, or names joined by '/': a part of a span table
        path).  ``host_ms``, ``self_ms`` and ``count`` (the tracer's
        steps): summed over the rows that end in ``path``, the span
        itself.  ``busy_ms``, ``launches``, ``idle_ms`` (the profiled
        steps), ``reads`` and ``writes`` (the tracer's steps): summed over
        the rows that hold ``path``, the span and the spans inside it.
        None untraced or where no row has the key."""
        if self.program is None:
            return None
        own = key in ('host_ms', 'self_ms', 'count')
        vals = [r[key] for r in self.program['table']
                if r[key] is not None
                and (('/' + r['path']).endswith('/' + path) if own
                     else '/' + path + '/' in '/' + r['path'] + '/')]
        return sum(vals) if vals else None

    def formal_solution_least_s(self) -> float:
        return formal_solution_work(self.Nlam, self.Nmu, self.Nk,
                                    self.dtype)['least_s']
