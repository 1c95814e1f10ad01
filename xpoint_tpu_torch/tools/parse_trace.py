"""Sum the device time of a ``torch.profiler`` Chrome trace by category and
by kernel name (port of ``tools/parse_trace.py``, which reads a JAX trace
by ``hlo_category``).

    python -m xpoint_tpu_torch.tools.parse_trace TRACE [n_batches]
        [--categories kernel,gpu_memcpy,gpu_memset]

TRACE is a trace file (``prof.export_chrome_trace(path)``: ``.json``, or
``.json.gz``) or a directory searched for one (the newest). The time of an
event is its duration ("X" events); the categories are the trace's own
(``cat``): by default the device's (kernels, copies, memsets). With
``n_batches`` every time is also given per batch. Printed as the JAX tool
prints: the total, each category's ms and share, the top 25 names.
"""
import argparse
import gzip
import json
import os
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path):
    """``path`` if a file, else the newest ``*.json`` / ``*.json.gz`` under
    it."""
    if os.path.isfile(path):
        return path
    found = [os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs
             if f.endswith((".json", ".json.gz"))]
    if not found:
        raise FileNotFoundError(f"no trace under {path}")
    return max(found, key=os.path.getmtime)


def load_events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def summarize(events, categories=DEVICE_CATEGORIES):
    """(total ms, {category: ms}, {(category, name): ms}, {name: count}) of
    the complete events of ``categories``."""
    by_cat, by_name = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    total = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in categories:
            continue
        dur_ms = ev.get("dur", 0) / 1000.0
        name = ev.get("name", "?")
        by_cat[ev["cat"]] += dur_ms
        by_name[(ev["cat"], name[:60])] += dur_ms
        counts[name] += 1
        total += dur_ms
    return total, dict(by_cat), dict(by_name), dict(counts)


def launches(counts, fragment):
    """Events whose name contains ``fragment`` (a kernel's launches by its
    name in the trace)."""
    return sum(n for name, n in counts.items() if fragment in name)


def report(path, n_batches=None, categories=DEVICE_CATEGORIES):
    """Print the tables; returns summarize()'s tuple."""
    total, by_cat, by_name, counts = summarize(load_events(path), categories)
    print(f"trace: {path}")
    print(f"total device op time: {total:.1f} ms"
          + (f" ({total / n_batches:.2f} ms/batch over {n_batches})"
             if n_batches else ""))
    for cat, ms in sorted(by_cat.items(), key=lambda x: -x[1]):
        frac = 100 * ms / max(total, 1e-9)
        per_b = f"  {ms / n_batches:6.2f} ms/b" if n_batches else ""
        print(f"{cat:32s} {ms:8.1f} ms  {frac:5.1f}%{per_b}")
    print("\ntop 25 ops:")
    for (cat, name), ms in sorted(by_name.items(), key=lambda x: -x[1])[:25]:
        per_b = f"  {ms / n_batches:6.2f} ms/b" if n_batches else ""
        print(f"{ms:8.1f} ms{per_b}  [{cat}] {name}")
    return total, by_cat, by_name, counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("n_batches", nargs="?", type=int, default=None)
    ap.add_argument("--categories", default=",".join(DEVICE_CATEGORIES))
    args = ap.parse_args(argv)
    return report(find_trace(args.trace), args.n_batches,
                  tuple(args.categories.split(",")))


if __name__ == "__main__":
    main()
