#!/usr/bin/env python3
"""compute-sanitizer over the port's card paths that phase 4j of
`chip_smoke.py` and the skinning kernels run, one tool and target a run.

    python3 sanitize.py [--out chiprun_out/sanitizer] [--runs yolo:memcheck,...]
    python3 sanitize.py --target skinning|mjpeg     # a target alone

The targets:
  * `yolo`: `repeat_demo_yolo.py`, 4j's image read (nvJPEG decodes on
    8 threads) and 4j (a) (YOLOv3 at full width against the CPU), once a
    process under the sanitizer, 5 times without it;
  * `mjpeg`: the Motion-JPEG route of 4j (e): the 16 JPEGs of
    tests/data/torch_video/ stored in an AVI and read back through
    `MjpegFrameSource`, from the file and from a loopback HTTP stream
    (nvJPEG decodes), and 4 frames encoded again (nvJPEG's encoder);
  * `skinning`: `skinning` and `skinning_backward` at B = 128 and 64,
    V = 6890, each held to its plain version.

By default it runs memcheck and initcheck over `yolo` and `mjpeg`, and
memcheck and racecheck over `skinning`, each under
PYTORCH_NO_CUDA_MEMORY_CACHING=1 (every allocation its own, so that
memcheck sees the true bounds), with the log of each in `--out`, and
prints a line a run (the tool's error summary and the log's path) and
one JSON line of them all. Without compute-sanitizer (looked for on
PATH, then in $CUDA_HOME/bin or /usr/local/cuda/bin), or where it
cannot attach to the card (a probe of one allocation under memcheck
fails: "Device not supported" on the H100 machine the port is checked
on), it says so and runs each target three times under
CUDA_LAUNCH_BLOCKING=1 instead.
Exits 1 when a run fails or reports an error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEFAULT_RUNS = ("skinning:memcheck", "skinning:racecheck", "mjpeg:memcheck", "mjpeg:initcheck",
                "yolo:memcheck", "yolo:initcheck")
SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) error")
RUN_SECONDS = 600         # a run's limit: its rc is "timeout" past it
FALLBACK_YOLO_RUNS = 5    # 4j (a) a process when each run is not sanitized
PROBE = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"


def target_command(target: str, yolo_runs: int = 1) -> list[str]:
    if target == "yolo":
        return [sys.executable, str(REPO / "repeat_demo_yolo.py"), str(yolo_runs), "600"]
    return [sys.executable, str(REPO / "sanitize.py"), "--target", target]


def find_sanitizer() -> str | None:
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("compute-sanitizer") or next(
        (str(p) for p in (Path(cuda) / "bin" / "compute-sanitizer",) if p.exists()), None)


def run_skinning() -> None:
    import torch

    import chip_smoke as cs

    cs.phase_build()
    for batch in (128, 64):
        args = cs.skinning_inputs(batch, 6890, seed=batch)
        err = float((cs.skinning(*args) - cs.skinning_reference(*args)).abs().max())
        grad = cs.backward_grad(batch, 6890, seed=batch)
        got = cs.skinning_backward(*args, grad)
        ref = cs.skinning_backward_reference(*args, grad)
        torch.cuda.synchronize()
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        print(f"skinning B={batch} V=6890: max_abs_err {err:.3e}; skinning_backward "
              f"grad_v_posed {errs[0]:.3e}, grad_rel_tfms {errs[1]:.3e}")
        cs.check(err <= cs.SKIN_TOL, f"skinning disagrees at B={batch}")
        for g, r in zip(got, ref):
            cs.check(float((g - r).abs().max())
                     <= cs.BACKWARD_RTOL * float(r.abs().max()) + cs.BACKWARD_ATOL,
                     f"skinning_backward disagrees at B={batch}")


def run_mjpeg() -> None:
    import tempfile

    import numpy as np
    import torch

    from poco_tpu_torch.demo.stream import DirectoryFrameSource, MjpegFrameSource
    from poco_tpu_torch.runtime import loader
    from poco_tpu_torch.utils import mjpeg

    folder = REPO / "tests" / "data" / "torch_video"
    data = [p.read_bytes() for p in sorted(folder.glob("*.jpg"))]
    h, w = loader.image_size(str(sorted(folder.glob("*.jpg"))[0]))
    with tempfile.TemporaryDirectory() as tmp:
        clip = str(Path(tmp) / "clip.avi")
        mjpeg.write_avi_mjpeg(clip, data, 25, (w, h))
        with mjpeg.MjpegHttpServer(data[:8]) as server:
            for spec, n in ((clip, len(data)), (server.url, 8)):
                source, direct = MjpegFrameSource(spec), DirectoryFrameSource(str(folder))
                frames = [source.read() for _ in range(n)]
                source.close()
                same = all(np.array_equal(f, direct.read()) for f in frames)
                print(f"{spec}: {n} frames decoded ({loader.route()} route), "
                      f"{'equal to' if same else 'NOT equal to'} the files' decodes")
                if not same:
                    raise SystemExit(f"{spec}: frames differ from the files'")
        sizes = [len(loader.encode_jpeg(f, quality=95)) for f in frames[:4]]
        torch.cuda.synchronize()
        print(f"encoded 4 frames again: {sizes} bytes")


def run_group(cmd: list[str], env: dict, log) -> subprocess.CompletedProcess:
    """`cmd` in a process group of its own, output to `log`; past
    RUN_SECONDS the whole group is killed and the return code is
    "timeout"."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=RUN_SECONDS)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    return subprocess.CompletedProcess(cmd, rc)


def sanitize(runs: list[str], out: Path) -> int:
    out.mkdir(parents=True, exist_ok=True)
    tool_path = find_sanitizer()
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; compute-sanitizer: {tool_path}")
    if tool_path:
        version = subprocess.run([tool_path, "--version"], capture_output=True, text=True)
        print(version.stdout.strip().splitlines()[-1] if version.stdout.strip() else "")
        probe = subprocess.run([tool_path, "--tool", "memcheck", sys.executable, "-c", PROBE],
                               cwd=REPO, env=env, capture_output=True, text=True)
        refused = [line for line in (probe.stdout + probe.stderr).splitlines()
                   if "Error:" in line]
        print(f"probe (one allocation and a sync under memcheck): rc {probe.returncode}"
              + (f", {refused[0].strip('= ')}" if refused else ""))
        if probe.returncode != 0 or refused:
            tool_path = None
    if not tool_path:
        print("compute-sanitizer is not in the toolkit here or cannot attach to the card: "
              "each target runs 3 times under CUDA_LAUNCH_BLOCKING=1 instead")
        runs = sorted({r.split(":")[0] for r in runs})
        env["CUDA_LAUNCH_BLOCKING"] = "1"
    results, failed = [], False
    for run in runs:
        target, _, tool = run.partition(":")
        log = out / f"{target}_{tool or 'blocking'}.log"
        start = time.perf_counter()
        if tool_path:
            cmd = [tool_path, "--tool", tool, "--log-file", str(log), "--print-limit", "200"]
            with open(out / f"{target}_{tool}.out", "w") as f:
                proc = run_group(cmd + target_command(target), env, f)
            text = log.read_text() if log.exists() else ""
            found = SUMMARY.findall(text)
            errors = int(found[-1]) if found else None
        else:
            codes = []
            with open(log, "w") as f:
                for _ in range(3):
                    proc = run_group(target_command(target, FALLBACK_YOLO_RUNS), env, f)
                    codes.append(proc.returncode)
            errors = sum(c != 0 for c in codes)
        seconds = time.perf_counter() - start
        ok = proc.returncode == 0 and errors == 0
        failed |= not ok
        results.append({"target": target, "tool": tool or "CUDA_LAUNCH_BLOCKING=1, 3 processes",
                        "rc": proc.returncode, "errors": errors, "seconds": round(seconds, 1),
                        "log": str(log.relative_to(REPO)) if log.is_relative_to(REPO)
                        else str(log)})
        print(f"{run}: rc {proc.returncode}, errors {errors}, {seconds:.1f} s, log {log}")
    print(json.dumps({"sanitizer": results, "card": smi.stdout.strip()}))
    return 1 if failed else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(REPO / "chiprun_out" / "sanitizer"))
    parser.add_argument("--runs", default=",".join(DEFAULT_RUNS),
                        help="target:tool pairs, comma-separated")
    parser.add_argument("--target", choices=["skinning", "mjpeg"], default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sanitize: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.target == "skinning":
        run_skinning()
        return 0
    if args.target == "mjpeg":
        run_mjpeg()
        return 0
    return sanitize(args.runs.split(","), Path(args.out))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
