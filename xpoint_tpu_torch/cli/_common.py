"""Shared CLI plumbing (port of ``cli/_common.py``): config merging, model
and dataset construction, seeds, and the run report of an entry point's
process."""
import atexit
import copy
import json
import os
import random
import sys
import time

import numpy as np

RUN_REPORT_ENV = "XPOINT_TORCH_RUN_REPORT"
# the kernel wrappers: {report name: (module, function)}; each counts its
# own launches in ``<function>.launches``
KERNEL_COUNTERS = {
    "selective_scan_bidir": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                             "selective_scan_bidir"),
    "selective_scan_bidir_bwd": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                                 "selective_scan_bidir_bwd"),
    "nms_sweep": ("xpoint_tpu_torch.ops.nms", "grid_nms_keep"),
    "warp_projective": ("xpoint_tpu_torch.ops.warp_projective",
                        "warp_projective"),
    "selective_scan_fused": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                             "selective_scan_fused_bkld"),
    "linear_scan": ("xpoint_tpu_torch.ops.linear_scan", "linear_scan"),
}


def set_seeds(seed):
    random.seed(seed)
    np.random.seed(seed)


def seeded_dataset(ds_cfg, seed):
    """The dataset of ``ds_cfg`` with its samples drawn from generators of
    (``seed``, epoch 0, index): an entry point's ``-s`` seeds its data
    draws (the evaluation warps), as ``set_seeds`` seeds the global streams
    the JAX package's datasets draw from."""
    from ..data import get_dataset
    dataset = get_dataset(ds_cfg)
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(0, seed)
    return dataset


def load_eval_setup(args, single_image_override=None):
    """Config + variable-config merge + model + dataset (reference
    benchmark.py:50-130 flow). Returns (config, module, infer, dataset);
    the module is on ``args.device``."""
    from ..config import load_yaml
    from ..eval.infer import XPointInference
    from ..model_io import load_model
    from ..models import build_xpoint
    from ..utils import dict_update

    config = load_yaml(args.yaml_config)
    if getattr(args, "yaml_variable", None):
        dict_update(config, load_yaml(args.yaml_variable))

    # the reference disables the homography head at eval time when the
    # config asks for it (benchmark.py:50-76, cipdp.yaml 'disable_hmhead')
    override = None
    if (config.get("prediction", {}) or {}).get("disable_hmhead"):
        override = {"homography_regression_head": {"check": False}}

    if (getattr(args, "version", None) == "none"
            and getattr(args, "model_dir", None) in (None, "none")
            and config.get("model")):
        # `-m none -v none` with a model section: the model of the config
        # with the seeded initialisation (the reference skips weight
        # loading when version == 'none', benchmark.py:93-96)
        model_cfg = copy.deepcopy(config["model"])
        if override:
            dict_update(model_cfg, override)
        module, model_cfg = build_xpoint(model_cfg, device=args.device,
                                         seed=0)
    else:
        module, model_cfg = load_model(args.model_dir, args.version,
                                       model_override=override,
                                       device=args.device)
    config["model"] = model_cfg

    if single_image_override is not None:
        config.setdefault("dataset", {})["single_image"] = \
            single_image_override
    ds_cfg = config.get("dataset", {})
    dataset = (seeded_dataset(ds_cfg, getattr(args, "seed", 0))
               if ds_cfg.get("filename") or ds_cfg.get("foldername")
               else None)

    infer = XPointInference(module, config.get("prediction", {}))
    return config, module, infer, dataset


def report_at_exit(stage):
    """If ``$XPOINT_TORCH_RUN_REPORT`` names a directory, write one JSON
    file there when this process exits: the stage name, the command line,
    the wall seconds from this call to the exit, each kernel wrapper's
    launch count in this process, and whether ``h5py`` was imported. A run
    whose stages are processes of their own (``tools/full_cycle.py``) is
    read from these files. Nothing is done when the variable is unset."""
    out_dir = os.environ.get(RUN_REPORT_ENV)
    if not out_dir:
        return
    t0 = time.perf_counter()

    def write():
        launches = {}
        for name, (mod, fn) in KERNEL_COUNTERS.items():
            m = sys.modules.get(mod)
            launches[name] = int(getattr(getattr(m, fn), "launches", 0)) \
                if m is not None else 0
        report = {"stage": stage, "argv": sys.argv, "pid": os.getpid(),
                  "wall_s": time.perf_counter() - t0,
                  "end_time": time.time(),
                  "launches": launches, "h5py_imported": "h5py" in sys.modules}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{stage}_{os.getpid()}.json"),
                  "w") as f:
            json.dump(report, f)
    atexit.register(write)
