"""The share of a frames cell's requests that started while the card was
still running the request before them (`poco/ahead`, opened by
`poco_tpu_torch/demo/tester.py:detect_forward`): one run of the cell with
the span recorder on, as `gpubench/spans_report.py --record 1` makes it,
and the count of `poco/ahead` records over the count of `poco/request`
roots.

    python3 tools/ahead_share.py --workload cliff_frames_b128 --seed <n> --seconds 51

Prints the report's one JSON line with `ahead` added: `requests` (every
request of the run: the warm-up, the window), `ahead` and `share`. The
first request of the warm-up and of the window cannot be ahead: the
client drains its queue between them. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "gpubench"))

import spans_report  # noqa: E402  (sets the harness's environment and paths)


def ahead_share(records) -> dict:
    from poco_tpu_torch.utils import spans

    requests = sum(r.name == spans.REQUEST and r.parent is None for r in records)
    ahead = sum(r.name == spans.AHEAD for r in records)
    return {"requests": requests, "ahead": ahead, "share": ahead / requests if requests else 0.0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args()
    import torch

    from poco_tpu_torch.utils import spans

    if not torch.cuda.is_available():
        print("the share is read on a CUDA card", file=sys.stderr)
        return 2
    kept, recording = [], spans.recording

    @contextlib.contextmanager
    def keeping():
        with recording() as records:
            kept.append(records)
            yield records

    spans.recording = keeping
    try:
        line = spans_report.report(args.workload, args.seed, args.seconds, True, False,
                                   t_start=spans_report.run.T_START)
    finally:
        spans.recording = recording
    line["ahead"] = ahead_share(kept[0])
    line["device"] = torch.cuda.get_device_name()
    line["power_limit_w"] = spans_report.run.power_limit_w()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
