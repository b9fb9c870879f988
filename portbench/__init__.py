"""The benchmark of the port ``bftkv_tpu_torch`` on one H100: see
``portbench/README.md`` and ``python3 -m portbench.run --help``."""
