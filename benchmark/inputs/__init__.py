"""Input makers of the benchmark (numpy and scipy only)."""
