"""Start n ranks, one process and one device each, and run a function on
every rank (the JAX package's single controller needs no launcher).

    from xpoint_tpu_torch.parallel import launch, make_mesh

    def body(x):                 # a module-level function: ranks import it
        mesh = make_mesh()
        ...
        return result            # rank 0's is returned

    out = launch(body, 2, args=(x,), devices=["cuda:0", "cuda:1"])

Ranks are ``spawn``ed (a fresh interpreter each: the function's module is
imported there, so it should import torch and not JAX at its top) and join
a process group through a ``file://`` store in a fresh temporary directory,
so concurrent launches never share a port. The backend is an explicit
choice: default ``nccl`` when every rank has a CUDA device of its own,
``gloo`` when every rank is on the CPU; any other placement (two ranks on
one card) must name its backend, and a backend is never switched on
failure.

A launch fails, it never hangs: each collective (and the group's
rendezvous) raises after ``collective_timeout`` seconds, so a rank waiting
on a peer that never comes dies quickly; the ranks are joined against a
deadline of ``timeout`` seconds for the whole run; and when one rank dies
(or the deadline passes) the others are killed and the error is raised
with the dead rank's traceback.
"""
import datetime
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import mesh as _mesh


def default_backend(devices):
    """``nccl`` for distinct CUDA devices, ``gloo`` for CPU ranks; raises
    for any other placement (name the backend then)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devs):
        return "gloo"
    if (all(d.type == "cuda" for d in devs)
            and len({d.index for d in devs}) == len(devs)):
        return "nccl"
    raise ValueError(f"no default backend for ranks on {devices}: pass "
                     f"backend= (nccl refuses two ranks on one GPU)")


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _rank_main(rank, n, workdir, backend, devices, collective_timeout,
               threads, fn, args):
    try:
        torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/store", rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=collective_timeout))
        _mesh._set_rank_devices(devices)
        out = fn(*args)
        if rank == 0:
            torch.save(_to_cpu(out), os.path.join(workdir, "result.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def launch(fn, n, args=(), devices=None, backend=None, timeout=600.0,
           collective_timeout=60.0, threads=None):
    """Run ``fn(*args)`` on ``n`` ranks; return rank 0's result (tensors
    moved to the CPU). ``devices``: one device a rank, default
    ``cuda:0..n-1`` (raises if fewer CUDA devices exist). ``timeout``: the
    seconds the whole run may take (None: no deadline, for a run as long
    as training); ``collective_timeout``: the seconds a rank may wait in
    one collective. ``threads``: CPU threads a rank
    (default: the host's cores shared out)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"launch: {n} ranks asked for, {have} CUDA "
                             f"device(s) exist")
        devices = [f"cuda:{r}" for r in range(n)]
    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"launch: {len(devices)} devices for {n} ranks")
    backend = backend or default_backend(devices)
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    workdir = tempfile.mkdtemp(prefix="xpoint_launch_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, workdir, backend, devices, collective_timeout, threads, fn,
        args))
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (float("inf") if timeout is None
                                        else timeout)
        while True:
            codes = [p.exitcode for p in procs]
            dead = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if dead:
                raise RuntimeError(_failure(workdir, dead, codes))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"launch: ranks {late} still running "
                                   f"after {timeout:.0f} s")
            time.sleep(0.02)
        return torch.load(os.path.join(workdir, "result.pt"),
                          weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def _failure(workdir, dead, codes):
    lines = [f"launch: rank(s) {dead} failed (exit codes {codes})"]
    for r in dead:
        path = os.path.join(workdir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r} ---\n{f.read()}")
    return "\n".join(lines)
