"""The PyTorch port's serving pipeline against the JAX one, and the rule
that the port imports nothing of JAX."""
import ast
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.eval.pipeline import make_pair_pipeline as jx_pipeline

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.eval import make_pair_pipeline
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.ops.nms import grid_nms_keep
from xpoint_tpu_torch.ops.selective_scan_cuda import selective_scan_bidir

from test_torch_models import _jax_tiny_model, tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(kps_o, kps_t, idx, matched):
    return {(tuple(kps_o[i]), tuple(kps_t[idx[i]]))
            for i in np.flatnonzero(matched)}


def test_pair_pipeline_matches_jax():
    """Whole detect+describe+match chain on the tiny model: prob maps within
    atol 1e-5, then identical masked keypoint sets, scores and matches
    (compared as sets: exact score ties may be ordered differently)."""
    jm, v = _jax_tiny_model()
    rng = np.random.default_rng(7)
    img_o = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    img_t = np.clip(img_o + 0.05 * rng.normal(size=img_o.shape), 0, 1
                    ).astype(np.float32)
    kw = dict(k=64, nms_size=8, detection_threshold=0.015)
    ref = jax.device_get(jx_pipeline(jm, (64, 64), **kw)(
        v, jnp.asarray(img_o), jnp.asarray(img_t)))
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)
    launches = (selective_scan_bidir.launches, grid_nms_keep.launches)
    out = {k: t.numpy() for k, t in make_pair_pipeline(tm, (64, 64), **kw)(
        torch.from_numpy(img_o), torch.from_numpy(img_t)).items()}
    # CPU tensors run the plain versions, never a kernel
    assert (selective_scan_bidir.launches, grid_nms_keep.launches) == launches

    assert set(out) == set(ref)
    for key in out:
        assert out[key].shape == np.asarray(ref[key]).shape, key
    for s in ("optical", "thermal"):
        np.testing.assert_allclose(out[f"prob_{s}"], ref[f"prob_{s}"],
                                   atol=1e-5)
    for b in range(2):
        sets = {}
        for s in ("optical", "thermal"):
            m, rm = out[f"mask_{s}"][b], ref[f"mask_{s}"][b]
            assert m.sum() > 0
            mine = {tuple(p): sc for p, sc, ok in zip(
                out[f"keypoints_{s}"][b], out[f"scores_{s}"][b], m) if ok}
            theirs = {tuple(p): sc for p, sc, ok in zip(
                ref[f"keypoints_{s}"][b], ref[f"scores_{s}"][b], rm) if ok}
            assert set(mine) == set(theirs), s
            np.testing.assert_allclose([mine[p] for p in sorted(mine)],
                                       [theirs[p] for p in sorted(mine)],
                                       atol=1e-5)
            sets[s] = mine
        got = _pairs(out["keypoints_optical"][b], out["keypoints_thermal"][b],
                     out["match_idx"][b], out["matched"][b])
        want = _pairs(ref["keypoints_optical"][b], ref["keypoints_thermal"][b],
                      ref["match_idx"][b], ref["matched"][b])
        assert got == want and len(got) > 0


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "xpoint_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    """No module of xpoint_tpu_torch, nor chip_smoke.py, imports jax, flax,
    optax, orbax or anything of the JAX package."""
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                            "xpoint_tpu"), \
            f"{os.path.relpath(path, ROOT)} imports {name}"


def test_entry_points_default_to_cuda():
    import inspect
    assert inspect.signature(build_xpoint).parameters["device"].default \
        == "cuda"
