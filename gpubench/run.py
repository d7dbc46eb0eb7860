"""Run one cell of the port's benchmark once and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `poco_tpu_torch` beside this
folder, on a machine with the CUDA cards the cell asks for. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared beside its limit (also the last lines of
standard error). Without a card, with too few, without the port, or
with JAX or the JAX package loaded, it prints no result and exits with 2-5.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# every cache of the program at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ.pop("POCO_TPU_SMPL_MEAN_PARAMS", None)   # the mean parameters are the identity
sys.path[:0] = [str(HERE), str(HERE.parent)]   # the harness, and the checkout's port

import importlib  # noqa: E402

import torch  # noqa: E402

from bench import manifest  # noqa: E402
from bench.compare import judge  # noqa: E402
from bench.peaks import PEAKS  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "poco_tpu")   # top-level module names, compared whole


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def precise(device) -> None:
    """fp32 with TF32 off: the configurations' precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def context(cell: dict, seed: int, seconds: float, trace: bool, device, tmpdir: str,
            t_start: float) -> types.SimpleNamespace:
    cuda = torch.device(device).type == "cuda"

    def free():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    return types.SimpleNamespace(
        cell=cell, config=cell["config_data"], traffic=cell["traffic_data"], seed=seed,
        seconds=seconds, trace=trace, device=torch.device(device), tmpdir=tmpdir,
        t_start=t_start, free=free,
        mark=lambda label: print(f"[{time.perf_counter() - t_start:8.2f} s] {label}",
                                 file=sys.stderr, flush=True),
        sync=torch.cuda.synchronize if cuda else (lambda: None),
        memory_peak=(lambda: torch.cuda.max_memory_allocated()) if cuda else (lambda: 0),
    )


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Path = manifest.ROOT, t_start: float | None = None) -> dict:
    """One run of the cell: the runner's numbers, the metrics it reports
    and the verdict, as a dict (not yet printed)."""
    cell = manifest.load_cell(name, root)
    precise(device)
    runner = manifest.runner(cell["traffic_data"]["kind"], root)
    tmpdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        ctx = context(cell, seed, seconds, trace, device, tmpdir,
                      T_START if t_start is None else t_start)
        ctx.mark("harness, torch and the cell loaded")
        out = runner.run(ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    ok, checks = judge(out["readings"], cell["limits"])
    metrics, units = {}, cell["units"]
    summary = out["summary"]
    if trace:
        if summary:
            summary["peaks"] = PEAKS.get(torch.cuda.get_device_name()) if torch.device(
                device).type == "cuda" else None
        for metric in cell["per_layer"]:
            value = manifest.metric_reader(metric, root)(summary) if summary else None
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
    else:
        metrics = {k: {"value": out["e2e"][k], "unit": units[k]} for k in cell["end_to_end"]}
    return {"correct": ok and out["failed"] == 0, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "summary": summary, "checks": checks,
            "memory_peak_bytes": out["memory_peak_bytes"], "requests": out["requests"],
            "readings": out["readings"],
            "e2e": out["e2e"]}


def power_limit_w() -> float | None:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader,nounits", "-i", "0"],
                              capture_output=True, text=True, timeout=20)
        return float(done.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e308


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        importlib.import_module("poco_tpu_torch")
    except ImportError as err:
        print(f"no result: the system under test does not import ({err})", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: the process holds {loaded} once the window has closed",
              file=sys.stderr)
        return 4
    limit = power_limit_w()
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": result["memory_peak_bytes"], "power_limit_w": limit}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    summary = result["summary"]
    print(f"{args.workload} seed {args.seed}: {result['requests']} requests or steps in the "
          f"window; end to end {result['e2e']}", file=sys.stderr)
    if args.trace:
        if not summary:
            print("no result: the traced stretch was not found in the profile", file=sys.stderr)
            return 5
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
        peaks = summary.get("peaks")
        if peaks is not None and summary.get("flops_per_call") and summary.get("calls_per_s"):
            rate = summary["flops_per_call"] * summary["calls_per_s"]
            print(f"model FLOP/s {rate:.6e}: {100 * rate / peaks.fp32_flop_per_s:.4f}% of the "
                  f"fp32 SIMT peak {peaks.fp32_flop_per_s:.4e}, "
                  f"{100 * rate / peaks.fp32_accurate_flop_per_s:.4f}% of the 3xTF32 peak "
                  f"{peaks.fp32_accurate_flop_per_s:.4e}; {kind}, power limit {limit} W",
                  file=sys.stderr)
        print(f"stretch: {summary['requests']} calls, device time under the stretch range "
              f"{summary['ranges_s'].get('gpubench/stretch', 0.0):.6f} s, busy "
              f"{summary['busy_s']:.6f} s of {summary['window_s']:.6f} s", file=sys.stderr)
    print(f"readings: {result['readings']}", file=sys.stderr)
    line["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                      for k, c in result["checks"].items()}
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
