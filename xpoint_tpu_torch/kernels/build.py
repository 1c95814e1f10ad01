"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/xpoint_tpu_torch/lib<name>-<hash>.so

The file name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.
Every C entry point returns ``cudaGetLastError()``; :func:`check` raises
if it is not 0. Counters (``obs``): ``kernels.built`` (nvcc ran),
``kernels.loaded`` and ``kernels.load_ns`` (a library's first
:func:`load` in the process, its build included; span
``xp.kernels.load``).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .. import obs

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "xpoint_tpu_torch")
KERNEL_SOURCES = ("selective_scan_bidir", "selective_scan_bidir_bwd",
                  "nms_sweep", "warp_projective", "selective_scan_fused",
                  "linear_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of xpoint_tpu_torch cannot be built")


def _lib_path(name):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")


def _start_build(name, verbose=False):
    """Start nvcc for one source unless its library exists; returns
    (name, tmp_path, out_path, Popen or None)."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return name, None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, tmp, out, proc


def _finish_build(name, tmp, out, proc):
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    obs.count("kernels.built")
    return log


def build_all(verbose=False):
    """Compile every kernel source, one nvcc process per source, all
    started together. Returns {name: compiler output}."""
    with _lock:
        jobs = [_start_build(n, verbose) for n in KERNEL_SOURCES]
        return {job[0]: _finish_build(*job) for job in jobs}


def load(name):
    """The ctypes handle of kernel library ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter_ns()
            with obs.span("xp.kernels.load", always=True, library=name):
                _, _, out, _ = job = _start_build(name)
                _finish_build(*job)
                lib = ctypes.CDLL(out)
            _libs[name] = lib
            obs.count("kernels.loaded")
            obs.count("kernels.load_ns", time.perf_counter_ns() - t0)
        return lib


def check(lib, err, what):
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if err != 0:
        lib.xp_error_string.restype = ctypes.c_char_p
        lib.xp_error_string.argtypes = [ctypes.c_int]
        msg = lib.xp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
