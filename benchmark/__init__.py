"""The benchmark of jrender_tpu_torch: one cell, one run, one result line.

Run from the repository root: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``; ``benchmark/README.md`` says how
cells, configurations, traffic mixes and metrics are added.
"""
