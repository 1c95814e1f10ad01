"""Config files (port of ``xpoint_tpu/config.py:19-48``): the task YAML
with its ``dataset`` / ``model`` / ``loss`` / ``training`` sections,
``params.yaml`` dumped into a training run's output directory and read
back by every tool that rebuilds the model.

The machine with the card has no PyYAML. So ``yaml`` is imported only
inside the functions, and where it does not import, :func:`save_yaml`
writes the config as JSON text and :func:`load_yaml` reads it with
``json``. JSON is a subset of YAML, so a YAML reader (the JAX package's
``load_yaml`` included) reads such a file equal: floats are written with a
decimal point and a signed exponent (``1.0e-05``), the form YAML 1.1 reads
as a float.
"""
import copy
import json
import math
import os

from .utils import dict_update


def _yaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


def _float_text(x):
    if not math.isfinite(x):
        raise ValueError(f"{x} has no JSON form")
    mant, _, exp = repr(x).partition("e")
    if "." not in mant:
        mant += ".0"
    if exp and exp[0] not in "+-":
        exp = "+" + exp
    return mant + ("e" + exp if exp else "")


def _json_text(x, indent=""):
    """JSON text of a config: mappings, lists and tuples, str, bool, None,
    int and float (YAML 1.1 float form)."""
    inner = indent + "  "
    if isinstance(x, dict):
        if not x:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_json_text(v, inner)}"
                 for k, v in x.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(x, (list, tuple)):
        if not x:
            return "[]"
        return ("[\n" + ",\n".join(inner + _json_text(v, inner) for v in x)
                + "\n" + indent + "]")
    if isinstance(x, float):
        return _float_text(x)
    if x is None or isinstance(x, (bool, int, str)):
        return json.dumps(x)
    raise TypeError(f"{type(x).__name__} in a config")


def load_yaml(path):
    with open(path, "r") as f:
        text = f.read()
    yaml = _yaml()
    return json.loads(text) if yaml is None else yaml.safe_load(text)


def save_yaml(config, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    yaml = _yaml()
    with open(path, "w") as f:
        if yaml is None:
            f.write(_json_text(config) + "\n")
        else:
            yaml.dump(config, f, default_flow_style=False)


def merge_model_params(config, model_dir, version=None):
    """``config`` with its ``model`` section replaced by the one in
    ``<model_dir>/params.yaml`` (and ``prediction: version`` set)."""
    params = load_yaml(os.path.join(model_dir, "params.yaml"))
    config = copy.deepcopy(config)
    config["model"] = params["model"]
    if version is not None:
        config.setdefault("prediction", {})["version"] = version
    return config


def with_defaults(default_config, config):
    """Deep-merge a user config over a default config (a copy)."""
    merged = copy.deepcopy(default_config)
    if config:
        dict_update(merged, config)
    return merged
