"""The program's host reads and writes (lightweaver_tpu_torch.tracing's
to_host and to_device funnels: each, on the card, a transfer that waits
for the stream) per MALI step, over the tracer's steps of a traced run
(harness/program_trace.py:readings)."""


def read(run):
    return run.program_reading('host_syncs_per_step')
