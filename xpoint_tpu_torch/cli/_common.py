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


# an entry point's ranks: no whole-run deadline (training runs for
# hours), a wait of at most this long in one collective
CLI_COLLECTIVE_TIMEOUT_S = 600.0


def rank_count(args):
    """The ranks an entry point runs on: every visible GPU under a CUDA
    ``--device`` (one process and card each; ``CUDA_VISIBLE_DEVICES`` picks
    them), else 1."""
    if str(args.device) == "cuda":
        import torch
        return max(1, torch.cuda.device_count())
    return 1


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
    the module is on ``args.device``. With ``-v none`` and a
    ``ClassicDetectors`` model section, ``module`` is the host-side
    baseline and ``infer`` a ClassicInference on ``args.device``."""
    from ..config import load_yaml
    from ..eval.infer import XPointInference
    from ..model_io import load_model
    from ..models import build_xpoint
    from ..utils import dict_update

    config = load_yaml(args.yaml_config)
    if getattr(args, "yaml_variable", None):
        dict_update(config, load_yaml(args.yaml_variable))

    def dataset():
        if single_image_override is not None:
            config.setdefault("dataset", {})["single_image"] = \
                single_image_override
        ds_cfg = config.get("dataset", {})
        return (seeded_dataset(ds_cfg, getattr(args, "seed", 0))
                if ds_cfg.get("filename") or ds_cfg.get("foldername")
                else None)

    # `-v none` with a classical baseline: the host-side model of the
    # config, no weights (reference benchmark.py:93-96); its maps go to
    # ``args.device`` for NMS, sampling and matching
    if (getattr(args, "version", None) == "none"
            and (config.get("model") or {}).get("type") == "ClassicDetectors"):
        from ..eval.infer import ClassicInference
        from ..models import get_model
        model, config["model"] = get_model(config["model"])
        infer = ClassicInference(model, config.get("prediction", {}),
                                 device=args.device)
        return config, model, infer, dataset()

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
    infer = XPointInference(module, config.get("prediction", {}))
    return config, module, infer, dataset()


def report_at_exit(stage):
    """If ``$XPOINT_TORCH_RUN_REPORT`` names a directory, write one JSON
    file there when this process exits: the stage name, the command line,
    the wall seconds from this call to the exit, the process's counters
    (``obs.counters()``: each kernel wrapper's launches, K2's planes and
    plane sweeps, the kernel libraries built and loaded and the load time)
    with the launches also by wrapper, and whether ``h5py`` was imported. A
    run whose stages are processes of their own (``tools/full_cycle.py``)
    is read from these files. Nothing is done when the variable is
    unset."""
    out_dir = os.environ.get(RUN_REPORT_ENV)
    if not out_dir:
        return
    t0 = time.perf_counter()

    def write():
        from .. import obs
        counts = obs.counters()
        launches = {name: counts[f"{name}.launches"]
                    for name in obs.KERNEL_COUNTERS}
        report = {"stage": stage, "argv": sys.argv, "pid": os.getpid(),
                  "wall_s": time.perf_counter() - t0,
                  "end_time": time.time(), "launches": launches,
                  "counters": counts, "h5py_imported": "h5py" in sys.modules}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{stage}_{os.getpid()}.json"),
                  "w") as f:
            json.dump(report, f)
    atexit.register(write)
