"""Benchmark utilities beyond the driver-facing bench.py:

- scaling_sim: functional validation of the sharded SPMD program across
  mesh widths on CPU-simulated devices (SURVEY.md §4.4) — correctness and
  program shape, not performance (real scaling numbers need real cards).
"""
