"""Shared CLI plumbing (port of ``cli/_common.py``): config merging, model
and dataset construction, seeds."""
import copy
import random

import numpy as np


def set_seeds(seed):
    random.seed(seed)
    np.random.seed(seed)


def load_eval_setup(args, single_image_override=None):
    """Config + variable-config merge + model + dataset (reference
    benchmark.py:50-130 flow). Returns (config, module, infer, dataset);
    the module is on ``args.device``."""
    from ..config import load_yaml
    from ..data import get_dataset
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
    dataset = (get_dataset(ds_cfg) if ds_cfg.get("filename")
               or ds_cfg.get("foldername") else None)

    infer = XPointInference(module, config.get("prediction", {}))
    return config, module, infer, dataset
