"""Weight bridge between flax variables (nested dicts of numpy arrays) and
the port's ``state_dict``, both ways.

The port's submodules carry the flax module names, so a flax path
``encoder/layers_0_blocks_0/op/in_proj/kernel`` becomes the torch key
``encoder.layers_0_blocks_0.op.in_proj.weight``. Leaves are converted as

  conv ``kernel`` (kh, kw, I, O)  -> ``weight`` (O, I, kh, kw)
  dense ``kernel`` (I, O)         -> ``weight`` (O, I)
  LayerNorm / BatchNorm ``scale`` -> ``weight``
  BatchNorm stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  everything else (``bias``, ``x_proj_weight``, ``dt_projs_weight``,
  ``dt_projs_bias``, ``A_logs``, ``Ds``) keeps its name and layout.

SS2D's variants need no rule of their own: the gate doubles ``in_proj``'s
width (D, 2 D) -> (2 D, D), the conv bias is a ``bias`` leaf beside
``conv2d/kernel``, and with a state size N > 1 ``A_logs`` is (K D, N) and
``x_proj_weight`` (K, R + 2 N, D) on both sides; the shape check below
holds the module to the leaves it was built for.

The homography head (``hm_regressor/*``: RegNet's convs, BatchNorms and
dense layers) maps like the rest. Any flax leaf without a torch
counterpart, and any torch entry left unset, raises. :func:`to_flax` and
:func:`state_dict_to_flax` go the other way, so that tests can compare the
port's parameters, gradients and optimiser moments with JAX's leaf by leaf.
"""
import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_STAT_FLAX = {v: k for k, v in _STAT_NAMES.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables):
    """{"params": ..., "batch_stats": ...} -> {torch key: fp32 tensor}."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected flax collection {collection!r}")
        for path, leaf in _flatten(tree):
            arr = np.array(leaf, np.float32)          # a writable copy
            name = path[-1]
            if collection == "batch_stats":
                if name not in _STAT_NAMES:
                    raise KeyError(f"unexpected batch stat {'/'.join(path)}")
                name = _STAT_NAMES[name]
            elif name == "kernel":
                name = "weight"
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f"kernel of rank {arr.ndim} at "
                                     f"{'/'.join(path)}")
            elif name == "scale":
                name = "weight"
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_to_flax(tensors):
    """{torch key: tensor} -> nested flax dicts of fp32 numpy arrays, the
    inverse of :func:`flax_to_state_dict`. Parameter-named tensors (also
    gradients or optimiser moments keyed by parameter name) go under
    "params", running statistics under "batch_stats"."""
    out = {}
    for key, t in tensors.items():
        *path, name = key.split(".")
        arr = t.detach().float().cpu().numpy()
        collection = "params"
        if name in _STAT_FLAX:
            collection, name = "batch_stats", _STAT_FLAX[name]
        elif name == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 1:
                name = "scale"
            else:
                raise ValueError(f"weight of rank {arr.ndim} at {key}")
        node = out.setdefault(collection, {})
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def to_flax(module):
    """The module's parameters and BatchNorm statistics as flax variables
    ({"params": ..., "batch_stats": ...} of numpy arrays)."""
    return state_dict_to_flax(module.state_dict())


def load_flax_variables(module, variables):
    """Load flax ``variables`` into ``module`` in place; raises on any
    unconsumed flax leaf, missing torch entry or shape mismatch."""
    sd = flax_to_state_dict(variables)
    target = module.state_dict()
    unconsumed = sorted(set(sd) - set(target))
    missing = sorted(set(target) - set(sd))
    if unconsumed or missing:
        raise KeyError(f"flax->torch bridge: unconsumed flax leaves "
                       f"{unconsumed}, missing torch entries {missing}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs torch "
                             f"{tuple(target[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return module
