"""The readings that set a cell's limits from above: the control (the
reference put in the port's place, in the precision below the
configuration's: TF32 for fp32 with TF32 off) and, for a training cell,
the fault of half the batch left out, against the reference in fp32, at
the cell's own sizes, by the `control(ctx)` of the cell's runner. The
benchmark's own runs never run this.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed: {"seed", "control": readings,
"half_batch": readings (training cells)}. Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import torch  # noqa: E402

import run  # noqa: E402
from bench import manifest  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    runner = manifest.runner(cell["traffic_data"]["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ctx = run.context(cell, seed, 0.0, False, "cuda", tmp, t0)
            run.precise("cuda")
            readings = runner.control(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
