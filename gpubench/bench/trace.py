"""Spans from outside the program, and the reduction of a torch.profiler
trace to the summary that the per-layer metric readers read.

A layer's device time is the time of the kernels launched inside its
range: each kernel goes, by the profiler's correlation, to the host op
that launched it, and that op to every range whose host window holds
the op's start (by time, on any thread: a train step's backward runs on
autograd's own threads). Nothing here changes the program: the ranges
are `record_function`s the benchmark opens around its own calls and in
forward hooks it registers on the model's modules in the traced run."""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

STRETCH = "gpubench/stretch"
# the profiler's own host events: a kernel launched while one is open is
# also credited to it, beside its launching op, so they are skipped
PROFILER_OVERHEAD = {"Command Buffer Full", "Activity Buffer Request", "Buffer Flush"}
REQUEST = "gpubench/request"
MODEL = "gpubench/model"
LAYER_PARTS = ("backbone", "head", "uncert_head")


@contextlib.contextmanager
def layer_ranges(model: torch.nn.Module):
    """`gpubench/model` around the model's forward and `gpubench/<part>`
    around each of its parts', by forward pre- and post-hooks."""
    handles, stack = [], []

    def enter(name):
        def hook(module, args):
            rf = record_function(name)
            rf.__enter__()
            stack.append(rf)
        return hook

    def leave(module, args, output):
        stack.pop().__exit__(None, None, None)

    parts = [(MODEL, model)] + [(f"gpubench/{p}", getattr(model, p)) for p in LAYER_PARTS
                                if getattr(model, p, None) is not None]
    for name, module in parts:
        handles.append(module.register_forward_pre_hook(enter(name)))
        handles.append(module.register_forward_hook(leave))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _merged(spans):
    """(start, end) spans merged where they overlap, in order."""
    out = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return out


def summarize(events, top: int = 10) -> dict:
    """The traced stretch of a profiler's `events()`: its window, device
    busy time, the device time under each named host range and op (not
    the `aten::` ops and not the CUDA runtime's calls) with its count, the
    device ops that took most time and the longest idle gaps, each named by
    the innermost host range or op the launching thread was in at its
    start. Times in seconds."""
    cpu = [e for e in events
           if e.device_type == DeviceType.CPU and e.name not in PROFILER_OVERHEAD]
    stretch = [e for e in cpu if e.name == STRETCH]
    if len(stretch) != 1:
        return {}
    w0, w1 = stretch[0].time_range.start, stretch[0].time_range.end
    kernel_names = {k.name for e in cpu for k in e.kernels}
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name in kernel_names
              and w0 <= e.time_range.start <= w1]
    launches = sorted((e.time_range.start, sum(k.duration for k in e.kernels))
                      for e in cpu if e.kernels and w0 <= e.time_range.start <= w1)
    starts = [t for t, _ in launches]
    prefix = [0.0]
    for _, d in launches:
        prefix.append(prefix[-1] + d)
    windows = {}
    for e in cpu:
        if not e.name.startswith(("aten::", "cuda", "cu")) and w0 <= e.time_range.start <= w1:
            windows.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    ranges_s, calls = {}, {}
    for name, spans in windows.items():
        # a window inside another of its name (an op's nested dispatch) counts once
        for s0, s1 in _merged(spans):
            lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_right(starts, s1)
            ranges_s[name] = ranges_s.get(name, 0.0) + (prefix[hi] - prefix[lo]) * 1e-6
            calls[name] = calls.get(name, 0) + 1
    busy = _merged((max(s0, w0), min(s1, w1)) for s0, s1, _ in device if s1 > s0)
    by_op = {}
    for s0, s1, name in device:
        by_op[name] = by_op.get(name, 0.0) + (s1 - s0) * 1e-6
    edges = [w0] + [x for span in busy for x in span] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    main = stretch[0].thread
    host = [e for e in cpu if e.thread == main and e.time_range.start <= w1
            and e.time_range.end >= w0 and e.name != STRETCH]
    idle_gaps = []
    for length, at in gaps:
        inner = [e for e in host if e.time_range.start <= at < e.time_range.end]
        name = max(inner, key=lambda e: e.time_range.start).name if inner else "outside any range"
        idle_gaps.append([name, length * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(s1 - s0 for s0, s1 in busy) * 1e-6,
        "ranges_s": ranges_s,
        "calls": calls,
        "device_ops": sorted(([n, t] for n, t in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": idle_gaps,
    }


def profile_stretch(run, device) -> dict:
    """`run()` inside the stretch range under torch.profiler (host and
    CUDA), the device drained before and after, reduced by `summarize`."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            run()
            sync()
    return summarize(prof.events())


def count_flops(run) -> float:
    """The FLOPs `run()` does, by torch's counter."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    return float(counter.get_total_flops())
