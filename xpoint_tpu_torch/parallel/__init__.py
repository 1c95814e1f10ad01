"""Multi-device paths over ``torch.distributed``: the data-parallel mesh and
its collectives, the launcher of one process a rank, and the
sequence-parallel ring scan (port of ``xpoint_tpu/parallel``)."""
from .launch import launch
from .mesh import (active_mesh, all_gather, all_reduce, broadcast,
                   data_parallel, make_mesh, replicate, shard_batch)
from .ring_scan import (get_ring_mesh, ring_linear_scan, ring_mesh,
                        ring_selective_scan)

__all__ = ["make_mesh", "shard_batch", "replicate", "make_train_step",
           "TrainState", "ring_linear_scan", "ring_selective_scan",
           "ring_mesh", "get_ring_mesh", "launch", "all_reduce",
           "all_gather", "broadcast", "data_parallel", "active_mesh"]


def __getattr__(name):
    """``TrainState`` and ``make_train_step`` (the JAX package's
    ``parallel`` exports them), imported at first use: ``train.train_step``
    imports ``parallel.mesh``, so importing it here would make importing
    ``xpoint_tpu_torch.train`` first circular."""
    if name in ("TrainState", "make_train_step"):
        from ..train import train_step
        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
