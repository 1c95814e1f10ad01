"""Tools over the entry points: the mini corpus, the full self-supervised
cycle and the holdout-seed sweep (``python -m xpoint_tpu_torch.tools.<name>``)."""
