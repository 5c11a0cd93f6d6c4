"""The benchmark of lightweaver_tpu_torch on one NVIDIA H100.

``python lwbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  The harness (``harness/``) is driven by data: a cell, a
configuration, a traffic mix and a metric are each a file of their own,
found by the name ``BENCHMARK.json`` gives them (README.md).
"""
