"""Command-line entry points of the port (python -m pose6d_tpu_torch.cli.<name>)."""
