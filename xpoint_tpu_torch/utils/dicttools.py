"""Small host-side helpers: own copies of
``xpoint_tpu/utils/dicttools.py:13-61`` (deep dict merge, SimpleNamespace
conversion, primitive parsing, safe divide, non-colliding file names)."""
import collections.abc
import os
import types

import numpy as np


def dict_update(d, u):
    """Deep-merge ``u`` into ``d`` (nested mappings merged recursively,
    every other value in ``u`` overwrites). Returns ``d``."""
    for k, v in u.items():
        if isinstance(v, collections.abc.Mapping):
            d[k] = dict_update(d.get(k, {}) or {}, v)
        else:
            d[k] = v
    return d


def dict_to_obj(d):
    """Recursively convert dicts (also inside lists) to SimpleNamespace."""
    if isinstance(d, dict):
        return types.SimpleNamespace(**{k: dict_to_obj(v)
                                        for k, v in d.items()})
    if isinstance(d, list):
        return [dict_to_obj(v) for v in d]
    return d


def parse_primitives(names, all_primitives):
    """Resolve 'all', one name or a list of names against
    ``all_primitives``; an unknown name fails the assertion."""
    p = (all_primitives if names == "all"
         else (names if isinstance(names, list) else [names]))
    assert set(p) <= set(all_primitives), \
        f"unknown primitives: {set(p) - set(all_primitives)}"
    return p


def div0(a, b):
    """Elementwise a / b with 0 / 0 -> 1 and x / 0 -> 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.true_divide(a, b)
        idx = ~np.isfinite(c)
        c[idx] = np.where(np.asarray(a)[idx] == 0, 1, 0)
    return c


def get_new_filename(base_path, original_name):
    """A file name in ``base_path`` that does not exist yet: the original,
    or it with _1, _2, ... before the extension."""
    extension = os.path.splitext(original_name)[1]
    base_name = os.path.splitext(original_name)[0]
    counter = 1
    new_name = original_name
    while os.path.exists(os.path.join(base_path, new_name)):
        new_name = f"{base_name}_{counter}{extension}"
        counter += 1
    return new_name
