"""What the kinds' systems under test share.  A system
(lwbench/kinds/<kind>.py:System) is the program's objects
(``lightweaver_tpu_torch``), built from the seed's inputs through the
program's public constructors, as
``System(config, traffic, inputs, device, dtype, units)``, and stepped:

- ``scatter_steps()``: the traffic's Nscatter formal solutions;
- ``mali_step(spans)``: one MALI step (the harness spans it opens are
  its kind's ``SPANS``); returns the columns it iterated;
- ``all_converged()``, ``restart()``: the closed loop's end and its new
  start from LTE, without repeating the set-up;
- ``keep()``: the state the next step starts from, at the points the
  check compares, as a dict of tensors or lists of tensors (J and the
  populations, and whatever else a step starts from), so that the
  reference can take the window's last step from it;
- ``units(kept)``: per compared unit, the pair (kept state, state now
  with what the step formed, such as Gamma) as dicts of float64 numpy
  (host_state).
"""
import torch

DTYPES = {'float64': torch.float64, 'float32': torch.float32}


def host_state(state: dict) -> dict:
    """Each tensor of ``state``, or each of a list of tensors, as float64
    numpy."""
    def host(x):
        return x.detach().to(torch.float64).cpu().numpy()
    return {k: [host(x) for x in v] if isinstance(v, (list, tuple))
            else host(v) for k, v in state.items()}


def lte_restart(ctx):
    """Put a Context back at its LTE start (populations from eqPops, J
    zero); its set-up (background, collisions, profiles) is kept
    (chip_smoke.py:restarted)."""
    for a, st in zip(ctx.cfg.activeAtoms, ctx.popsState):
        st['n'] = ctx.cfg.state(ctx.eqPops.atomicPops[a.model.element].n)
        st.pop('nLastSE', None)
    ctx.J = torch.zeros_like(ctx.J)
