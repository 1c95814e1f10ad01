"""Command-line entry points (``python -m xpoint_tpu_torch.cli.<name>``)."""
