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
from torch_env import torch_env  # noqa: F401 (autouse)

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
    optax, orbax, anything of the JAX package, or tqdm (which the card's
    machine is not known to have)."""
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                            "xpoint_tpu", "tqdm"), \
            f"{os.path.relpath(path, ROOT)} imports {name}"


def _import_time_imports(path):
    """The modules a file imports when it is imported (not in a function
    body): import statements, and ``__import__`` / ``import_module`` calls
    with a literal name."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "id",
                              getattr(node.func, "attr", None))
                  in ("__import__", "import_module")):
                yield node.args[0].value
            yield from walk(ast.iter_child_nodes(node))
    yield from walk(ast.parse(open(path).read(), path).body)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_h5py_only_where_a_file_is_opened(path):
    """The card's machine has no h5py: no module of xpoint_tpu_torch, nor
    chip_smoke.py, imports it when it is imported, so the package (the
    host data path's folder layout included) imports there."""
    names = {n.split(".")[0] for n in _import_time_imports(path)}
    assert "h5py" not in names, f"{os.path.relpath(path, ROOT)} imports h5py"


def test_import_time_imports_sees_every_form(tmp_path):
    """The walk behind the h5py rule: statements and literal dynamic
    imports at module level, in classes and branches; nothing inside a
    function."""
    path = tmp_path / "m.py"
    path.write_text(
        "import os\nimport importlib\nfrom a.b import c\n"
        "x = importlib.import_module('h5py')\n"
        "class K:\n    import yaml\n"
        "if x:\n    __import__('cv2')\n"
        "def f():\n    import h5py as h\n    return __import__('jax')\n"
        "g = lambda: importlib.import_module('flax')\n")
    assert sorted(set(_import_time_imports(str(path)))) == [
        "a.b", "cv2", "h5py", "importlib", "os", "yaml"]


def test_port_imports_where_h5py_and_jax_cannot_be_imported():
    """Every module of xpoint_tpu_torch imports in a process in which
    h5py, jax, flax and the JAX package raise ImportError, as on the
    card's machine (no h5py, no JAX)."""
    import subprocess
    import sys
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('h5py', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'xpoint_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import xpoint_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'xpoint_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 60


def test_entry_points_default_to_cuda():
    import inspect
    assert inspect.signature(build_xpoint).parameters["device"].default \
        == "cuda"
