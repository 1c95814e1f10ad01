"""Inference pipelines."""
from .pipeline import (make_pair_pipeline,  # noqa: F401
                       make_sharded_pair_pipeline)
