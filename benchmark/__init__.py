"""Benchmark of pose6d_tpu_torch on one NVIDIA H100 (BENCHMARK.json,
PERF.md)."""
