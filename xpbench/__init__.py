"""The benchmark of the PyTorch and CUDA port (``xpoint_tpu_torch``):
serving and training of the XPoint models on one H100, each cell driven by
data files found by name. ``python -m xpbench --help``; README.md says how
to add a configuration, a traffic mix, a per-layer metric and a cell."""
