"""One run of a cell, as `run.py` makes it, read by the program's own
spans (`poco_tpu_torch/utils/spans.py`, reduced by `bench/spans.py`).

    python3 gpubench/spans_report.py --workload <cell> --seed <n> --seconds <s> \\
        --record <0|1> --trace <0|1>

--record 1 keeps the span recorder on through the whole run (set-up,
window and checks) and adds `host`: by span name the median host ms, self
ms and calls a root (a request or a train step), and each root's median
`launch_ms` (its host time less its wait spans) and `wait_ms`. --trace 1
makes the run's traced stretch as `run.py --trace 1` does and adds its
`launches` by range a request or step, `idle_by_span_ms` in ms a request
or step, and `host_idle_ms`, the part of it under program spans that
are not waits. The one JSON line printed also holds `correct`, the run's
end-to-end numbers (`e2e`) and, traced, its per-layer metrics. Compare
--record 1 with --record 0 on the same seeds for the recorder's cost.
Needs a CUDA card (the tests run it on the CPU at a tiny size)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import run  # noqa: E402  (sets the harness's environment and paths)
from bench import manifest, spans, trace  # noqa: E402


def report(name: str, seed: int, seconds: float, record: bool, traced: bool,
           device="cuda", root: Path = manifest.ROOT, t_start: float | None = None) -> dict:
    from poco_tpu_torch.utils.spans import recording

    summarize, names = trace.summarize, spans.span_names()

    def with_spans(events, top: int = 10) -> dict:
        out = summarize(events, top)
        if out:
            out.update(spans.device_by_span(events, names))
        return out

    trace.summarize = with_spans
    try:
        if record:
            with recording() as records:
                result = run.run_cell(name, seed, seconds, traced, device, root, t_start)
        else:
            result = run.run_cell(name, seed, seconds, traced, device, root, t_start)
    finally:
        trace.summarize = summarize
    line = {"workload": name, "seed": seed, "record": record, "trace": traced,
            "correct": result["correct"], "e2e": result["e2e"]}
    if record:
        line["host"] = spans.host_table(records)
    summary = result["summary"]
    if traced and summary:
        calls = summary["requests"]
        line["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
        line["launches"] = {k: v / calls for k, v in summary.get("launches", {}).items()
                            if k in names or k.startswith("gpubench/")}
        idle = summary.get("idle_by_span", {})
        line["idle_by_span_ms"] = {k: 1e3 * v / calls for k, v in idle.items()}
        line["host_idle_ms"] = 1e3 * spans.host_idle_s(idle, names) / calls
        line["busy_s"], line["window_s"] = summary["busy_s"], summary["window_s"]
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--record", type=int, choices=(0, 1), default=1)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the report runs on a CUDA card", file=sys.stderr)
        return 2
    line = report(args.workload, args.seed, args.seconds, bool(args.record), bool(args.trace),
                  t_start=run.T_START)
    line["device"] = torch.cuda.get_device_name()
    line["power_limit_w"] = run.power_limit_w()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
