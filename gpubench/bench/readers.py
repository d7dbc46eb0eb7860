"""What the per-layer metric readers share. Each reader takes the traced
stretch's summary (`bench.trace.summarize`, completed by the traffic runner and
the run) and returns a number, or None where it finds nothing to read:
never 0 for a share of a roofline or of a peak."""

from __future__ import annotations

def per_call_ms(summary: dict, name: str) -> float | None:
    """Device ms under the range or op `name`, a request or step."""
    if (not summary.get("requests") or not summary.get("busy_s")
            or name not in summary.get("ranges_s", {})):
        return None
    return summary["ranges_s"][name] / summary["requests"] * 1e3


def difference_ms(summary: dict, whole: str, parts: tuple[str, ...]) -> float | None:
    """Device ms a request under `whole` less those under `parts`."""
    values = [per_call_ms(summary, n) for n in (whole,) + parts]
    if any(v is None for v in values):
        return None
    return values[0] - sum(values[1:])


def idle_percent(summary: dict) -> float | None:
    if not summary.get("window_s") or not summary.get("busy_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def mfu_percent(summary: dict) -> float | None:
    """Model FLOPs a second over the card's fastest fp32-accurate rate
    (3xTF32). The rate of requests or steps is the traced run's own, taken
    over its window after the profiled stretch (the profiler's host cost
    would lower it inside the stretch)."""
    peaks = summary.get("peaks")
    if peaks is None or not summary.get("flops_per_call") or not summary.get("calls_per_s"):
        return None
    return 100.0 * summary["flops_per_call"] * summary["calls_per_s"] / peaks.fp32_accurate_flop_per_s


def roofline_percent(summary: dict, op: str, shape_key: str, bound) -> float | None:
    """The least time of the op's work at its shape over the device time
    of the kernels under the op, a call."""
    peaks, shape = summary.get("peaks"), summary.get(shape_key)
    calls = summary.get("calls", {}).get(op)
    busy = summary.get("ranges_s", {}).get(op)
    if peaks is None or shape is None or not calls or not busy:
        return None
    return 100.0 * bound(*shape, peaks) / (busy / calls)
