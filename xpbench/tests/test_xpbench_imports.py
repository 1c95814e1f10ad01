"""Nothing of JAX, and in the reference nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

from tiny import ROOT

JAX_ERA = {"jax", "jaxlib", "flax", "optax", "xpoint_tpu"}
REF = os.path.join(ROOT, "xpbench", "reference")
PKG = os.path.join(ROOT, "xpbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_py_files(REF)),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not names & (JAX_ERA | {"xpoint_tpu_torch"}), names


@pytest.mark.parametrize("path", sorted(
    p for p in _py_files(PKG) if os.sep + "tests" + os.sep not in p),
    ids=lambda p: os.path.relpath(p, PKG))
def test_harness_imports_nothing_of_jax(path):
    assert not _imports(path) & JAX_ERA


def test_names_compared_whole():
    """The port's name begins with the JAX package's; it is allowed."""
    from xpbench.harness import FORBIDDEN
    assert "xpoint_tpu_torch".split(".")[0] not in FORBIDDEN
    code = ("import sys, xpbench.reference, xpbench.harness; "
            "from xpbench.harness import forbidden_modules; "
            "import xpoint_tpu_torch.eval.pipeline, "
            "xpoint_tpu_torch.train.train_step; "
            "print(forbidden_modules(), "
            "sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'jaxlib', 'xpoint_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.split() == ["[]", "[]"]
