"""The JAX package's import surface in the port: every name a JAX
``__init__`` exports imports from the port's package of the same name, and
``warp_image`` with an output size (``dsize``) other than the input's, with
the ``dsize`` of ``warp_image_batch`` / ``warp_image_multi``, matches JAX's
on the CPU.

Warp tolerance: 1e-5 absolute. The two sides invert the 3 x 3 homography
in another order, so source coordinates differ by a few fp32 ulps; on a
smooth image that falls to 0 at its border (slopes below 0.2 a pixel, the
zeros padding included) bilinear passes that on under 1e-5, and nearest
rounds the same pixel wherever a coordinate is not within an ulp of a
half-integer (none is on these inputs).
"""
import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xpoint_tpu.geometry.homography import sample_homography
from xpoint_tpu.ops import warp as jx_warp

from xpoint_tpu_torch.ops import warp
from torch_env import torch_env  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", "ops", "geometry", "losses", "models", "selfsup", "compat",
            "data", "eval", "parallel", "utils", "native"]


def _exported(module):
    """The names a package's ``__init__`` exports: ``__all__``, else the
    public names it defines that are not modules."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_imports_from_the_port(package):
    suffix = f".{package}" if package else ""
    jx = importlib.import_module(f"xpoint_tpu{suffix}")
    port = importlib.import_module(f"xpoint_tpu_torch{suffix}")
    names = ["__version__"] if not package else _exported(jx)
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"xpoint_tpu_torch{suffix} lacks {missing}"
    if not package:
        assert port.__version__ == jx.__version__
    if hasattr(port, "__all__"):
        assert set(names) <= set(port.__all__)


PORT_PACKAGES = sorted(
    d for d in os.listdir(os.path.join(ROOT, "xpoint_tpu_torch"))
    if os.path.exists(os.path.join(ROOT, "xpoint_tpu_torch", d,
                                   "__init__.py")))


@pytest.fixture(scope="module")
def first_imports():
    """{package: (exit code, stderr)} of importing each subpackage in a
    fresh interpreter, all started together."""
    procs = {p: subprocess.Popen(
        [sys.executable, "-c", f"import xpoint_tpu_torch.{p}"], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for p in PORT_PACKAGES}
    return {p: (proc.wait(timeout=120), proc.stderr.read())
            for p, proc in procs.items()}


@pytest.mark.parametrize("package", PORT_PACKAGES)
def test_each_port_package_imports_first(package, first_imports):
    """Each subpackage imports in a fresh interpreter before any other
    (``train`` first was circular: its step imports ``parallel.mesh``,
    whose package exported the step)."""
    code, err = first_imports[package]
    assert code == 0, err


def _smooth_images(B, H, W, C):
    """Smooth images that fall to 0 at their border, so that the zeros
    padding continues them without a step."""
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    window = np.sin(np.pi * y / (H - 1)) * np.sin(np.pi * x / (W - 1))
    imgs = [(np.sin(x / (7.0 + b + c) + y / (11.0 + c)) * 0.5 + 0.5) * window
            for b in range(B) for c in range(C)]
    return np.stack(imgs, -1).reshape(H, W, B, C).transpose(
        2, 0, 1, 3).astype(np.float32)


def _homs(seed, n, shape):
    rng = np.random.default_rng(seed)
    return np.stack([sample_homography(np.array(shape), rng=rng,
                                       max_angle=1.0)
                     for _ in range(n)]).astype(np.float32)


DSIZES = [None, (40, 52), (64, 90)]   # input 48 x 64: smaller, larger


@pytest.mark.parametrize("dsize", DSIZES)
@pytest.mark.parametrize("padding", ["zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_image_with_dsize_matches_jax(mode, padding, dsize):
    img = _smooth_images(3, 48, 64, 2)
    h = _homs(5, 3, (48, 64))
    out_hw = dsize or (48, 64)
    kw = dict(mode=mode, padding_mode=padding, dsize=dsize)
    T = torch.from_numpy
    cases = [
        ("warp_image", (img[0], h[0]), (*out_hw, 2)),
        ("warp_image_batch", (img, h), (3, *out_hw, 2)),
        ("warp_image_multi", (img[:2], h), (3, 2, *out_hw, 2)),
    ]
    for name, args, shape in cases:
        got = getattr(warp, name)(*map(T, args), **kw).numpy()
        want = np.asarray(getattr(jx_warp, name)(*map(jnp.asarray, args),
                                                 **kw))
        assert got.shape == want.shape == shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert got.std() > 0.05, name
