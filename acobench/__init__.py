"""The benchmark of ``deepaco_tpu_torch`` on one NVIDIA H100: a run measures
one cell (a configuration under a traffic mix) and prints one JSON line.
See PERF.md for the cells, metrics and bounds."""
