"""The program's own spans (`poco_tpu_torch/utils/spans.py`), reduced for
the benchmark: the host's time by span from the span recorder, and the
device's launches and idle gaps by span from a torch.profiler trace.

A root is one request (`poco/request`) or one train step (`train_step`).
Its launch time is its host time less its wait spans (where the host
blocks on the card), its wait time the host time in those. A launch is a
device kernel or copy, counted in every range whose host window holds the
start of the op that launched it (as `trace.summarize` credits device
time). An idle gap is put down to the innermost program span open on the
stretch's thread at the gap's start, else to `OUTSIDE`."""

from __future__ import annotations

import bisect
import statistics

from torch.autograd import DeviceType

from bench.trace import PROFILER_OVERHEAD, STRETCH, _merged

OUTSIDE = "outside the program"
ROOTS = ("poco/request", "train_step")


def span_names() -> dict[str, bool]:
    """The program's span names, each with whether it is a wait."""
    from poco_tpu_torch.utils.spans import names

    return names()


def _outermost_waits(records, by_id) -> list:
    """The wait spans with no wait span around them."""
    def inside_wait(r):
        parent = by_id.get(r.parent)
        while parent is not None:
            if parent.wait:
                return True
            parent = by_id.get(parent.parent)
        return False

    return [r for r in records if r.wait and not inside_wait(r)]


def host_table(records) -> dict:
    """Over the roots named in `ROOTS`, by span name: the median host ms a
    root (the span's calls in it summed), its self ms (less its child
    spans) and its calls a root; and for each root name its `launch_ms`
    and `wait_ms`, the medians over its roots, and their count."""
    by_id = {r.id: r for r in records}
    roots = {r.id: r for r in records if r.parent is None and r.name in ROOTS}
    child_ns: dict[int, int] = {}
    for r in records:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    per_root: dict[str, dict[int, list[float]]] = {}
    for r in records:
        if r.root in roots:
            entry = per_root.setdefault(r.name, {}).setdefault(r.root, [0.0, 0.0, 0])
            entry[0] += (r.end_ns - r.start_ns) * 1e-6
            entry[1] += (r.end_ns - r.start_ns - child_ns.get(r.id, 0)) * 1e-6
            entry[2] += 1
    table = {name: {"host_ms": statistics.median(v[0] for v in by_root.values()),
                    "self_ms": statistics.median(v[1] for v in by_root.values()),
                    "calls": statistics.median(v[2] for v in by_root.values())}
             for name, by_root in per_root.items()}
    waits: dict[int, float] = {}
    for r in _outermost_waits([r for r in records if r.root in roots], by_id):
        waits[r.root] = waits.get(r.root, 0.0) + (r.end_ns - r.start_ns) * 1e-6
    split = {}
    for name in ROOTS:
        ids = [i for i, r in roots.items() if r.name == name]
        if ids:
            split[name] = {
                "launch_ms": statistics.median(
                    (roots[i].end_ns - roots[i].start_ns) * 1e-6 - waits.get(i, 0.0)
                    for i in ids),
                "wait_ms": statistics.median(waits.get(i, 0.0) for i in ids),
                "roots": len(ids)}
    return {"spans": table, "roots": split}


def host_idle_s(idle_by_span: dict, names: dict) -> float:
    """Idle seconds under program spans that are not waits: the card
    waiting on the host's launches."""
    return sum(t for name, t in idle_by_span.items() if name in names and not names[name])


def device_by_span(events, names) -> dict:
    """Over the traced stretch of a profiler's `events()`: `launches`, the
    device kernels and copies launched inside each host range (by name,
    every range but the `aten::` ops and the CUDA runtime's calls), and
    `idle_by_span`, every idle gap's seconds by the innermost span of
    `names` open on the stretch's thread at its start, or `OUTSIDE`."""
    cpu = [e for e in events
           if e.device_type == DeviceType.CPU and e.name not in PROFILER_OVERHEAD]
    stretch = [e for e in cpu if e.name == STRETCH]
    if len(stretch) != 1:
        return {}
    w0, w1 = stretch[0].time_range.start, stretch[0].time_range.end
    starts = sorted(e.time_range.start for e in cpu for _ in e.kernels
                    if w0 <= e.time_range.start <= w1)
    windows: dict[str, list] = {}
    for e in cpu:
        if not e.name.startswith(("aten::", "cuda", "cu")) and w0 <= e.time_range.start <= w1:
            windows.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    launches = {name: sum(bisect.bisect_right(starts, s1) - bisect.bisect_left(starts, s0)
                          for s0, s1 in _merged(intervals))
                for name, intervals in windows.items()}
    kernel_names = {k.name for e in cpu for k in e.kernels}
    busy = _merged((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if e.device_type == DeviceType.CUDA and e.name in kernel_names
                   and w0 <= e.time_range.start <= w1 and e.time_range.end > e.time_range.start)
    edges = [w0] + [x for span in busy for x in span] + [w1]
    main = stretch[0].thread
    program = [e for e in cpu if e.thread == main and e.name in names]
    idle: dict[str, float] = {}
    for i in range(0, len(edges), 2):
        at, length = edges[i], edges[i + 1] - edges[i]
        if length <= 0:
            continue
        inner = [e for e in program if e.time_range.start <= at < e.time_range.end]
        name = max(inner, key=lambda e: e.time_range.start).name if inner else OUTSIDE
        idle[name] = idle.get(name, 0.0) + length * 1e-6
    return {"launches": launches, "idle_by_span": idle}
