"""Spans and counters of the port, on the profiler's clock.

    from xpoint_tpu_torch import obs

    with obs.span("xp.pipe.nms", planes=64):
        ...

**Off** (the default) a span reads two module-level booleans (this
module's and ``torch.autograd.profiler``'s) and returns one shared no-op:
no ``record_function`` is entered, no CUDA event is made, nothing is
kept. Tracing is **on** while a ``torch.profiler`` records, after
:func:`enable`, or in a process started with ``XPOINT_TORCH_TRACE=<path>``,
which also writes :func:`export_chrome` to ``<path>`` at exit.

When on, a span enters ``torch.profiler.record_function(name)`` (so a
profiler's trace holds the same range on its own clock), keeps a record
(name, span id, parent id, call id: the id of the outermost span around
it, attributes, host start and end) and, once CUDA is initialised, records
a pair of CUDA events from a pool on the current stream around its body.
Host times are ``time.perf_counter_ns()`` placed on the wall clock by one
anchor pair taken at import; :func:`spans` synchronises the device and
places each event on the same clock by an anchor event recorded after that
synchronisation. A ``torch.profiler`` trace exported as Chrome JSON gives
that clock as ``ts * 1000 + baseTimeNanoseconds`` (ns).

The calls' outermost spans (:func:`root`: ``xp.pipe.call``,
``xp.train.step``) also keep their host start and end, and whether a
profiler was recording, in a ring of the last :data:`RING` calls, tracing
on or off (two clock reads and an append a call): :func:`calls`.

Counters are always on. :func:`count` adds to a host counter;
:func:`device_counter` gives a persistent int64 word on a device that
kernels add to without a read by the host; :func:`counters` reads all of
them once, with each kernel wrapper's launch count
(``<wrapper>.launches``, :data:`KERNEL_COUNTERS`).

Span names (PERF.md §3 says which metric reads each): ``xp.pipe.*`` the
serving pipeline's stages, ``xp.model.*`` the model's encoder, heads and
RegNet, ``xp.enc.*`` the encoders' LayerNorm, scan, attention and MLP,
``xp.k.<wrapper>`` the kernel wrappers, ``xp.train.*`` the train step's
phases, ``xp.ha.*`` homographic adaptation, ``xp.data.wait`` the host
loader's wait, ``xp.kernels.load`` a kernel library's build and load
(kept whether tracing is on or not: it happens once a library).
"""
import atexit
import collections
import functools
import itertools
import json
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_ENV = "XPOINT_TORCH_TRACE"
RING = 1024                 # root calls kept, tracing on or off
MAX_SPANS = 1 << 17         # spans kept; later ones counted as dropped
ANCHOR_TRIES = 5            # anchor events a device when spans are placed
# the kernel wrappers: {report name: (module, function)}; each counts its
# own launches in ``<function>.launches``
KERNEL_COUNTERS = {
    "selective_scan_bidir": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                             "selective_scan_bidir"),
    "selective_scan_bidir_bwd": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                                 "selective_scan_bidir_bwd"),
    "nms_sweep": ("xpoint_tpu_torch.ops.nms", "grid_nms_keep"),
    "warp_projective": ("xpoint_tpu_torch.ops.warp_projective",
                        "warp_projective"),
    "selective_scan_fused": ("xpoint_tpu_torch.ops.selective_scan_cuda",
                             "selective_scan_fused_bkld"),
    "linear_scan": ("xpoint_tpu_torch.ops.linear_scan", "linear_scan"),
}

_on = False
# perf_counter_ns -> wall ns (the profiler's clock)
_ANCHOR = (time.perf_counter_ns(), time.time_ns())
_lock = threading.Lock()
_ids = itertools.count(1)
_stack = []                 # the open spans, innermost last
_records = []               # closed spans, oldest first
_ring = collections.deque(maxlen=RING)
_counts = {}
_dev_counters = {}          # (name, device) -> int64 tensor
_events = []                # CUDA events free for reuse


def _wall(t_ns):
    return _ANCHOR[1] + (t_ns - _ANCHOR[0])


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Forget every span, root call and counter kept so far (device
    counters are zeroed; kernel wrappers keep their launch counts)."""
    with _lock:
        _records.clear()
        _ring.clear()
        _counts.clear()
        for t in _dev_counters.values():
            t.zero_()


class _Noop:
    """The span of tracing off: enters nothing, keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "end",
                 "ev", "dev", "rf", "root", "profiled")

    def __init__(self, name, attrs, root=False):
        self.name, self.attrs, self.root = name, attrs, root
        self.ev = self.dev = None

    def __enter__(self):
        outer = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.call = outer.call if outer is not None else self.id
        self.profiled = _autograd_profiler._is_profiler_enabled
        _stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.start = time.perf_counter_ns()
        self.rf.__enter__()
        if torch.cuda.is_initialized() and len(_records) < MAX_SPANS:
            self.ev = (torch.cuda.current_device(), _event(), _event())
            self.ev[1].record()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[2].record()
        self.rf.__exit__(*exc)
        self.end = time.perf_counter_ns()
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            _stack.remove(self)
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(self)
            else:
                _counts["obs.spans_dropped"] = _counts.get(
                    "obs.spans_dropped", 0) + 1
            if self.root:
                _ring.append((self.name, self.start, self.end,
                              self.profiled))
        return False


class _RootClock:
    """A root call's host start and end with tracing off."""

    __slots__ = ("name", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _ring.append((self.name, self.start, time.perf_counter_ns(), False))
        return False


def span(name, always=False, **attrs):
    """A context manager: the span ``name`` with ``attrs`` while tracing is
    on, else the shared no-op. ``always``: kept whether tracing is on or
    not (for what happens once a process)."""
    if not (_on or _autograd_profiler._is_profiler_enabled or always):
        return _NOOP
    return _Span(name, attrs)


def spanned(name, **attrs):
    """:func:`span` as a decorator: each call of the function is a span."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_on or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, attrs):
                return fn(*args, **kwargs)
        return run
    return wrap


def root(name, **attrs):
    """The outermost span of a call (``xp.pipe.call``, ``xp.train.step``):
    a :func:`span` while tracing is on, and in either state an entry of the
    ring of the last :data:`RING` calls (:func:`calls`)."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _RootClock(name)
    return _Span(name, attrs, root=True)


def calls(name=None):
    """The ring's root calls, oldest first: dicts with ``name``,
    ``host_start``, ``host_end`` (wall ns) and ``profiled`` (whether a
    profiler was recording)."""
    with _lock:
        ring = list(_ring)
    return [{"name": n, "host_start": _wall(s), "host_end": _wall(e),
             "profiled": p} for n, s, e, p in ring
            if name is None or n == name]


def _resolve():
    """Place every kept span's CUDA events on the wall clock, once: a
    synchronisation and an anchor event a device. An anchor ran between the
    host's record of it and the first poll that finds it done; of
    :data:`ANCHOR_TRIES` in a row, the one with the shortest such interval
    (~20 us on the H100's host; the first after a synchronisation can take
    ~150) is placed at its middle."""
    with _lock:
        pending = [s for s in _records if s.ev is not None]
    by_device = collections.defaultdict(list)
    for s in pending:
        by_device[s.ev[0]].append(s)
    for dev, group in by_device.items():
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            tries = []
            for _ in range(ANCHOR_TRIES):
                ev = _event()
                t0 = time.perf_counter_ns()
                ev.record()
                while not ev.query():
                    pass
                tries.append((time.perf_counter_ns() - t0, t0, ev))
            width, t0, anchor = min(tries, key=lambda x: x[0])
            t = _wall(t0 + width // 2)
            for s in group:
                _, e0, e1 = s.ev
                s.dev = (t - round(e0.elapsed_time(anchor) * 1e6),
                         t - round(e1.elapsed_time(anchor) * 1e6))
                s.ev = None
                _events.extend((e0, e1))
            _events.extend(ev for _, _, ev in tries)


def _covered(lo, hi, intervals):
    """ns of [lo, hi) that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def spans():
    """Every span kept, oldest first (the device synchronised once): dicts
    with ``name``, ``id``, ``parent``, ``call``, ``attrs``, ``profiled``,
    ``host_start``, ``host_end``, ``dev_start``, ``dev_end`` (wall ns; the
    device's None for a span without CUDA events), ``self_ns`` (the host
    duration less the part its child spans cover) and ``dev_self_ns``."""
    _resolve()
    with _lock:
        kept = list(_records)
    children = collections.defaultdict(list)
    for s in kept:
        if s.parent is not None:
            children[s.parent].append(s)
    out = []
    for s in kept:
        kids = children.get(s.id, ())
        row = {"name": s.name, "id": s.id, "parent": s.parent,
               "call": s.call, "attrs": s.attrs, "profiled": s.profiled,
               "host_start": _wall(s.start), "host_end": _wall(s.end),
               "dev_start": None, "dev_end": None, "dev_self_ns": None,
               "self_ns": s.end - s.start - _covered(
                   s.start, s.end, [(k.start, k.end) for k in kids])}
        if s.dev is not None:
            lo, hi = s.dev
            inner = _covered(lo, hi, [k.dev for k in kids
                                      if k.dev is not None])
            row.update(dev_start=lo, dev_end=hi, dev_self_ns=hi - lo - inner)
        out.append(row)
    return out


def count(name, n=1):
    """Add ``n`` to the host counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def device_counter(name, device):
    """The persistent int64 word of counter ``name`` on ``device``, for a
    kernel (or a CPU path) to add to; :func:`counters` sums it over the
    devices with the host counter of the same name."""
    key = (name, str(torch.device(device)))
    t = _dev_counters.get(key)
    if t is None:
        with _lock:
            t = _dev_counters.get(key)
            if t is None:
                t = torch.zeros((), dtype=torch.int64, device=device)
                _dev_counters[key] = t
    return t


def counters():
    """Every counter once, {name: int}: the host counters, the device
    counters (read back: one synchronisation a device) and each kernel
    wrapper's ``<wrapper>.launches``."""
    with _lock:
        out = dict(_counts)
        dev = list(_dev_counters.items())
    for (name, _), t in dev:
        out[name] = out.get(name, 0) + int(t.item())
    for name, (mod, fn) in KERNEL_COUNTERS.items():
        m = sys.modules.get(mod)
        out[f"{name}.launches"] = (int(getattr(getattr(m, fn), "launches", 0))
                                   if m is not None else 0)
    return out


def export_chrome(path):
    """Write the kept spans as Chrome-trace JSON on the profiler's clock
    (``ts`` in µs after ``baseTimeNanoseconds``, as ``torch.profiler``
    exports it): one host track, one device track of the spans' CUDA event
    intervals, and the counters. Returns ``path``."""
    rows = spans()
    times = [r["host_start"] for r in rows] + [
        r["dev_start"] for r in rows if r["dev_start"] is not None]
    base = min(times) // 10 ** 9 * 10 ** 9 if times else 0
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": what}}
              for tid, what in ((0, "xp host"), (1, "xp device"))]
    for r in rows:
        args = {"id": r["id"], "parent": r["parent"], "call": r["call"],
                **{k: v if isinstance(v, (bool, int, float, str)) else str(v)
                   for k, v in r["attrs"].items()}}
        tracks = [(0, r["host_start"], r["host_end"])]
        if r["dev_start"] is not None:
            tracks.append((1, r["dev_start"], r["dev_end"]))
        for tid, lo, hi in tracks:
            events.append({"ph": "X", "cat": "xp", "name": r["name"],
                           "pid": pid, "tid": tid, "ts": (lo - base) / 1e3,
                           "dur": (hi - lo) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base, "traceEvents": events,
                   "counters": counters()}, f)
    return path


def _export_at_exit(path):
    try:
        export_chrome(path)
    except (OSError, RuntimeError) as e:
        print(f"obs: no trace written to {path}: {e}", file=sys.stderr)


if os.environ.get(TRACE_ENV):
    _on = True
    atexit.register(_export_at_exit, os.environ[TRACE_ENV])
