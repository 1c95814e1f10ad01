"""Model loading for the tools that use a trained model (port of
``xpoint_tpu/model_io.py:21-64``): rebuild the exact model from a model
directory's ``params.yaml`` and load its checkpoint.

Checkpoint resolution for ``<model_dir>/<version>``:
  1. ``<version>.pt``  — a checkpoint written by this package's Trainer;
  2. ``version == 'none'`` — the seeded initialisation.
A reference torch checkpoint (``<version>.model``) is not read yet
(ROADMAP.md Queue 1 item 8), nor is an orbax directory of the JAX package.
"""
import copy
import os

import torch

from .config import load_yaml
from .models import build_xpoint
from .utils import dict_update


def load_model(model_dir, version="latest", model_override=None,
               device="cuda"):
    """Returns (module, merged_config): the module in eval mode on
    ``device``. ``model_override`` deep-merges over the stored model config
    (e.g. disabling the hm head)."""
    params = load_yaml(os.path.join(model_dir, "params.yaml"))
    model_cfg = params["model"]
    if model_override:
        model_cfg = dict_update(copy.deepcopy(model_cfg), model_override)
    mtype = model_cfg.get("type", "XPoint")
    if mtype != "XPoint":
        raise ValueError(f"load_model handles XPoint, not {mtype}")
    module, merged_cfg = build_xpoint(model_cfg, device=device)
    if version and version != "none":
        path = os.path.join(model_dir, f"{version}.pt")
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu",
                            weights_only=True)["module"]
            module.load_state_dict(sd, strict=True)
        elif os.path.exists(os.path.join(model_dir, f"{version}.model")):
            raise NotImplementedError(
                "reference torch checkpoints (.model) are not read yet: "
                "ROADMAP.md Queue 1 item 8")
        else:
            raise FileNotFoundError(f"no checkpoint {version}.pt in "
                                    f"{model_dir}")
    return module, merged_cfg
