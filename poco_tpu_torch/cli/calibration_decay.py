"""A convergence run's calibration against its epochs (the port's
counterpart of the repo's `tools/calibration_decay.py`).

    python -m poco_tpu_torch.cli.calibration_decay --logdir <run logdir> \\
        [--ckpts epoch_049,epoch_089] [--root data] [--dataset conv] \\
        [--batch_size 50] [--device cuda|cpu] [--platform cpu|cuda]

BENCHMARKS.md explains a falling `uncert_pose_corr` while MPJPE improves
as residual homogenization: training drives every joint's rotation error
toward one floor, which leaves less across-joint spread for the per-joint
Pearson to rank. This tool measures it: it evaluates each epoch
checkpoint that a run keeps (`epoch_NNN.pt`, the trainer's five best) with
`python -m poco_tpu_torch.cli.eval --out`, one process a checkpoint, and
prints per checkpoint the gate correlation beside the across-joint
coefficients of variation of the per-joint mean rotation distance
(`pose_dist_cov`, the spread there is to rank) and of the per-joint mean
sigma (`sigma_cov`, the spread the head predicts). The claim holds
(`homogenization_confirmed`) iff from the first to the last checkpoint
the correlation and pose_dist_cov fall while MPJPE improves.

The evaluations run on `--device` (default: $POCO_TPU_PLATFORM, else the
card); `--platform` sets POCO_TPU_PLATFORM for them instead, as the JAX
tool's flag does (`cpu` keeps them off a card that a live run trains on).
Each report is kept as `<logdir>/calibration_decay_<ckpt>.json`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import subprocess
import sys

from ..device import default_device
from ..utils.comp_cache import ENV as PLATFORM_ENV
from .convergence_bench import child_env


def discover_ckpts(logdir: str) -> list[str]:
    """The epoch checkpoints a run keeps, by name, in epoch order."""
    return [osp.basename(p)[:-len(".pt")]
            for p in sorted(glob.glob(osp.join(logdir, "epoch_*.pt"))) if osp.isfile(p)]


def homogenization_verdict(rows: list[dict]) -> bool | None:
    """True iff from the first row to the last the correlation and the
    rotation distance's spread both fall while MPJPE improves; None with
    fewer than two rows or a row without per-joint statistics."""
    if len(rows) < 2 or any(r["pose_dist_cov"] is None for r in rows):
        return None
    first, last = rows[0], rows[-1]
    return bool(
        last["uncert_pose_corr"] < first["uncert_pose_corr"]
        and last["pose_dist_cov"] < first["pose_dist_cov"]
        and last["mpjpe"] < first["mpjpe"]
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--logdir", required=True,
                        help="a convergence run's logdir (config_to_run.yaml and "
                             "epoch_*.pt checkpoints)")
    parser.add_argument("--ckpts", default=None,
                        help="comma-separated checkpoint names in the logdir "
                             "(default: every epoch_*.pt)")
    parser.add_argument("--root", default="data")
    parser.add_argument("--dataset", default="conv")
    parser.add_argument("--batch_size", type=int, default=50)
    parser.add_argument("--device", default=default_device(),
                        help="device of the evaluations, cuda or cpu "
                             "(default: $POCO_TPU_PLATFORM, else cuda)")
    parser.add_argument("--platform", default=None,
                        help="POCO_TPU_PLATFORM for the evaluations, in place of --device")
    args = parser.parse_args(argv)

    logdir = osp.abspath(args.logdir)
    cfg = osp.join(logdir, "config_to_run.yaml")
    if not osp.exists(cfg):
        raise SystemExit(f"no config_to_run.yaml in {logdir}")
    names = args.ckpts.split(",") if args.ckpts else discover_ckpts(logdir)
    if not names:
        raise SystemExit(f"no epoch_* checkpoints in {logdir}")

    env = child_env()
    device = ["--device", args.device]
    if args.platform:
        env[PLATFORM_ENV] = args.platform
        device = []
    rows = []
    for name in names:
        report = osp.join(logdir, f"calibration_decay_{name}.json")
        r = subprocess.run(
            [sys.executable, "-m", "poco_tpu_torch.cli.eval", "--cfg", cfg,
             "--ckpt", osp.join(logdir, f"{name}.pt"), "--dataset", args.dataset,
             "--data_dir", osp.abspath(args.root), "--batch_size", str(args.batch_size),
             "--out", report, *device],
            env=env, stdout=subprocess.DEVNULL,
        )
        if r.returncode != 0:
            raise SystemExit(f"cli.eval failed for {name} ({r.returncode})")
        with open(report) as f:
            rep = json.load(f)
        s, pj = rep["summary"], rep.get("per_joint") or {}
        rows.append({
            "ckpt": name,
            "mpjpe": round(float(s["mpjpe"]), 2),
            "uncert_pose_corr": round(float(s["uncert_pose_corr"]), 4),
            "pose_dist_cov": pj.get("pose_dist_cov"),
            "sigma_cov": pj.get("sigma_cov"),
        })
        print(json.dumps(rows[-1]), file=sys.stderr)

    out = {
        "benchmark": "calibration_decay",
        "logdir": logdir,
        "rows": rows,
        "homogenization_confirmed": homogenization_verdict(rows),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
