"""Serving latency of this checkout's kernel ops against another checkout's,
alternated in one process on one card.

    python -m xpoint_tpu_torch.eval.ab_serving OTHER_ROOT [forward_type]

OTHER_ROOT is another checkout of this repository (for example the parent
commit unpacked with ``git archive``). Its ``xpoint_tpu_torch`` is loaded
under another name, so that both packages, and both sets of kernel
libraries (each built into its own checkout's ``build/``), live in one
process. The model (the flagship VMamba XPoint, bf16, seed 0;
``forward_type``, e.g. ``v052d_noz``, replaces its SSM_FORWARDTYPE
v05_noz) and the images are made once; for the other side only the names
that the model and the pipeline bind to the kernel ops' functions (the
scans, the linear recurrence, NMS) are rebound to the other package's
functions of the same name. make_pair_pipeline calls then alternate
between the sides in rounds (this, other; other, this; ...), and the
script prints each side's latencies (host clock around a call that ends
in ``torch.cuda.synchronize()``) with their median and quartiles. What a
process ran before and the caching allocator's state are then the same for
both sides, which separate runs of ``chip_smoke.py`` cannot ensure. Needs
a CUDA card.
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

ROUNDS, CALLS = 8, 3
PKG = __package__.split(".")[0]
OTHER = "other_" + PKG
# the modules whose functions launch kernels, and the modules that bind
# names to those functions on the serving path
OPS = ("ops.selective_scan_cuda", "ops.linear_scan", "ops.nms")
USERS = ("models.vssm", "ops.selective_scan", "eval.pipeline")


def load_other(root):
    """Import the package of checkout ``root`` as OTHER."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)


def op_bindings():
    """[(user module, name, this side's function, the other side's)] for
    every name a user module binds to a function of an op module."""
    out = []
    for user in USERS:
        mod = importlib.import_module(f"{PKG}.{user}")
        for name, fn in list(vars(mod).items()):
            owner = getattr(fn, "__module__", None) or ""
            if owner.removeprefix(PKG + ".") in OPS:
                other = importlib.import_module(
                    f"{OTHER}.{owner.removeprefix(PKG + '.')}")
                out.append((mod, name, fn, getattr(other, name)))
    return out


def quartiles(v):
    v = sorted(v)
    return v[len(v) // 4], v[len(v) // 2], v[3 * len(v) // 4]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_serving: no CUDA device", file=sys.stderr)
        return 1
    from .profile_pipeline import B, S, flagship_pipeline

    root, forward_type = argv[0], (argv[1] if len(argv) > 1 else None)
    load_other(root)
    bindings = op_bindings()
    dev = torch.device("cuda")
    run = flagship_pipeline(dev, forward_type)
    g = torch.Generator(device=dev).manual_seed(6)
    imgs = [tuple(torch.rand(B, S, S, 1, generator=g, device=dev)
                  for _ in range(2)) for _ in range(2 * CALLS + 1)]

    def side(name):
        for mod, attr, this, other in bindings:
            setattr(mod, attr, this if name == "this" else other)

    lat = {"this": [], "other": []}
    for name in lat:                                      # warm-up, build
        side(name)
        run(*imgs[0])
        torch.cuda.synchronize()
    for r in range(ROUNDS):
        for name in (("this", "other") if r % 2 == 0 else ("other", "this")):
            side(name)
            for i in range(CALLS):
                pair = imgs[1 + (r * CALLS + i) % (2 * CALLS)]
                t0 = time.perf_counter()
                run(*pair)
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e3)
    side("this")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"card": card, "forward_type": forward_type or "v05_noz",
           "other_root": root,
           "swapped": sorted({f"{m.__name__}.{a}"
                              for m, a, _, _ in bindings})}
    for name, v in lat.items():
        q1, med, q3 = quartiles(v)
        res[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3,
                     "all_ms": v}
        print(f"{card}: {name} median {med:.3f} ms (quartiles {q1:.3f}, "
              f"{q3:.3f}) over {len(v)} calls", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
