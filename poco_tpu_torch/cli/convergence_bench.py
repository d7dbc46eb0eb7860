"""Synthetic convergence benchmark: shows that the port's training LEARNS
(the port's counterpart of the repo's `tools/convergence_bench.py`).

    python -m poco_tpu_torch.cli.convergence_bench [--which cliff|pare|pare_hetero]
        [--epochs 150] [--root data] [--skip_train] [--fresh] [--make_data_only]
        [--mpjpe_thresh 120] [--corr_thresh 0.2] [--device cuda|cpu] [--work_dir DIR]

Writes a LEARNABLE synthetic set (500 training and 100 test samples):
poses drawn from the synthetic SMPL, each image showing the 24 GT joints
as colour-coded blobs, so that the image determines the pose, and half
the samples with 12 joints hidden, so that the difficulty varies from
sample to sample and a calibrated uncertainty can emerge (`--which
pare_hetero`: a fixed per-joint occlusion ramp instead). Then it trains
the recipe (configs/convergence.yaml: full-width HRNet-W48 + CLIFF +
flow, fp32, the two-phase freeze) through `python -m
poco_tpu_torch.cli.train` and evaluates its best checkpoint through
`python -m poco_tpu_torch.cli.eval`, and holds

  * val MPJPE <= --mpjpe_thresh (120 mm; a random model starts about
    ten times above), and
  * the calibration Pearson (per-joint sigma against per-joint rotation
    distance, reference trainer.py:380-383) >= --corr_thresh (0.2); the
    per-sample sigma-against-MPJPE Pearson is printed beside it.

It prints one JSON line (the JAX tool's keys) and exits 1 when a gate
misses. A run is resumed, not restarted: the newest unfinished logdir of
the recipe under `<work_dir>/logs` continues from its `last` checkpoint
(`--fresh` starts a new one; `--skip_train` only evaluates), and a logdir
whose metrics.jsonl was written in the last 180 s is left alone, since a
training process may still be writing it. `--work_dir` (default: the
repository root, where the JAX tool runs its CLIs) is where the train CLI
runs, so its `logs/` holds the runs. The data is made on the host; the
train and eval processes run on `--device`.
"""

from __future__ import annotations

import argparse
import colorsys
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..device import default_device
from ..runtime.image_write import write_image
from ..runtime.raster import circles_filled

# the directory that holds the package and configs/
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TRAIN = 500
N_TEST = 100
IMG = 256
SCALE_PX = 90.0   # orthographic projection scale (3D meters -> pixels)
LIVE_SECONDS = 180   # a metrics.jsonl younger than this may have a live writer

# --which -> (config, EXP_NAME)
RECIPES = {
    "cliff": ("configs/convergence.yaml", "convergence"),
    "pare": ("configs/convergence_pare.yaml", "convergence_pare"),
    "pare_hetero": ("configs/convergence_pare_hetero.yaml", "convergence_pare_het"),
}


def joint_colors(n: int = 24) -> np.ndarray:
    """n distinct RGB colours (HSV wheel, two value rings)."""
    cols = []
    for i in range(n):
        h = (i % 12) / 12.0
        v = 1.0 if i < 12 else 0.55
        cols.append(colorsys.hsv_to_rgb(h, 1.0, v))
    return (np.asarray(cols) * 255).astype(np.uint8)


def make_split(root: str, split: str, n: int, seed: int, hetero: bool = False) -> str:
    """Write `<root>/dataset_extras/conv_<split>.npz` and its JPEGs; returns
    the npz path.

    The GT follows the reference npz schema (base_dataset.py:52-149); the
    24 `part` / `S` joints are rows 25:49 of the model's 49 joints
    (`smpl_49` of the synthetic SMPL the trainer resolves), so the 2D and
    3D keypoint losses supervise the matching predicted joints. With
    `hetero`, `convhet_<split>.npz`: joint j is hidden with probability
    0.9 j / 23 on every sample, a persistent per-joint difficulty.
    """
    import torch

    from ..ops.rotation import axis_angle_to_rotmat
    from ..smpl.assets import synthetic_smpl_model
    from ..smpl.model import smpl_49

    rng = np.random.RandomState(seed)
    ds = "convhet" if hetero else "conv"
    img_dir = os.path.join(root, "dataset_folders", ds)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "dataset_extras"), exist_ok=True)

    pose = (0.35 * rng.randn(n, 72)).astype(np.float32)
    pose[:, :3] *= 0.3  # a mild global orientation
    shape = (0.5 * rng.randn(n, 10)).astype(np.float32)

    smpl = synthetic_smpl_model(device="cpu")   # the model the trainer resolves
    with torch.no_grad():
        rotmats = axis_angle_to_rotmat(torch.from_numpy(pose.reshape(-1, 3))).reshape(n, 24, 3, 3)
        _, joints49 = smpl_49(smpl, torch.from_numpy(shape), rotmats)
    j24 = joints49[:, 25:].numpy()   # (n, 24, 3), the GT convention's rows

    colors = joint_colors()
    imgnames, parts = [], []
    occluded = np.zeros(n, bool)
    for i in range(n):
        px = IMG / 2.0 + SCALE_PX * j24[i, :, 0]
        py = IMG / 2.0 + SCALE_PX * j24[i, :, 1]
        img = np.full((IMG, IMG, 3), 32, np.uint8)
        img += (8 * rng.rand(IMG, IMG, 3)).astype(np.uint8)
        conf = np.ones(24, np.float32)
        hide = np.zeros(24, bool)
        if hetero:
            hide = rng.rand(24) < 0.9 * np.arange(24) / 23.0
            occluded[i] = bool(hide.any())
        elif i % 2 == 1:
            hide[rng.choice(24, 12, replace=False)] = True
            occluded[i] = True
        for jid in range(24):
            if hide[jid]:
                conf[jid] = 0.0
                continue
            center = np.array([[int(round(px[jid])), int(round(py[jid]))]])
            circles_filled(img, center, 6, colors[jid].tolist())
        name = f"{split}_{i:04d}.jpg"
        # the JAX tool hands cv2.imwrite the array reversed, which cv2 reads
        # as BGR: the file holds the array itself as RGB
        write_image(os.path.join(img_dir, name), img)
        imgnames.append(f"dataset_folders/{ds}/{name}")
        parts.append(np.concatenate([px[:, None], py[:, None], conf[:, None]], 1))

    S = np.concatenate([j24, np.ones((n, 24, 1))], axis=-1).astype(np.float32)
    out = os.path.join(root, "dataset_extras", f"{ds}_{split}.npz")
    np.savez(
        out,
        imgname=np.array(imgnames),
        center=np.full((n, 2), IMG / 2.0, np.float32),
        scale=np.full((n,), 1.1, np.float32),
        pose=pose,
        shape=shape,
        S=S,
        part=np.asarray(parts, np.float32),
        openpose=np.zeros((n, 25, 3), np.float32),
        gender=np.array(["n"] * n),
        occluded=occluded,  # an extra key; the loader ignores it
    )
    return out


def run_logdirs(work_dir: str, exp_name: str) -> list[str]:
    """The recipe's run logdirs under `<work_dir>/logs`."""
    return glob.glob(os.path.join(work_dir, "logs", "**", f"{exp_name}_ID*"), recursive=True)


def resume_decision(cands: list[str], epochs: int, fresh: bool, skip_train: bool,
                    now: float | None = None) -> tuple[str, int] | None:
    """The run to resume: (logdir, next epoch) of the newest candidate by
    mtime (the names' %d-%m-%Y stamps do not sort by date), or None.

    The trainer rewrites `last.trainer.json` every epoch, not atomically:
    a missing sidecar means no resumable run; an unreadable one means a
    live writer, and raises SystemExit unless `skip_train` (a read-only
    evaluation). When training would resume, a metrics.jsonl younger than
    LIVE_SECONDS raises SystemExit too, unless the run is finished.
    """
    if not cands or fresh:
        return None
    newest = max(cands, key=os.path.getmtime)
    sidecar = os.path.join(newest, "last.trainer.json")
    try:
        with open(sidecar) as f:
            done = int(json.load(f)["next_epoch"])
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, KeyError, ValueError) as e:
        if skip_train:
            return None
        raise SystemExit(
            f"{sidecar} is unreadable mid-rewrite ({e}): a training process is likely "
            "writing this logdir; wait for it (or pass --fresh to start a new run)"
        )
    if not skip_train:
        metrics = os.path.join(newest, "metrics.jsonl")
        now = time.time() if now is None else now
        if (done < epochs and os.path.exists(metrics)
                and now - os.path.getmtime(metrics) < LIVE_SECONDS):
            raise SystemExit(
                f"{newest} was written <{LIVE_SECONDS} s ago: a training process may still "
                "be running it; wait for it (or pass --fresh to start a new run)"
            )
    return newest, done


def child_env() -> dict:
    """The environment of the CLI subprocesses: this package importable
    from any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _summary_fields(summary: dict) -> dict:
    return {k: float(summary.get(k, float("nan")))
            for k in ("mpjpe", "uncert_pose_corr", "uncert_mpjpe_corr", "mpjpe_var")}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default="data")
    parser.add_argument("--which", default="cliff", choices=sorted(RECIPES),
                        help="recipe: configs/convergence.yaml (CLIFF), "
                             "configs/convergence_pare.yaml (PARE), or the PARE study on "
                             "the per-joint occlusion ramp (convhet)")
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--mpjpe_thresh", type=float, default=120.0)
    parser.add_argument("--corr_thresh", type=float, default=0.2)
    parser.add_argument("--skip_train", action="store_true",
                        help="evaluate the newest logdir's checkpoints without training")
    parser.add_argument("--fresh", action="store_true",
                        help="ignore any resumable run and start a new one")
    parser.add_argument("--make_data_only", action="store_true")
    parser.add_argument("--device", default=default_device(),
                        help="device of the train and eval processes, cuda or cpu "
                             "(default: $POCO_TPU_PLATFORM, else cuda)")
    parser.add_argument("--work_dir", default=REPO,
                        help="where the train CLI runs; its logs/ holds the runs "
                             "(default: the repository root)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    hetero = args.which == "pare_hetero"
    ds = "convhet" if hetero else "conv"
    root = os.path.abspath(args.root)
    if not os.path.exists(os.path.join(root, "dataset_extras", f"{ds}_train.npz")):
        for split, n, seed in (("train", N_TRAIN, 0), ("test", N_TEST, 1)):
            path = make_split(root, split, n, seed, hetero=hetero)
            print(f"wrote {path}", file=sys.stderr)
    if args.make_data_only:
        return {}

    cfg, exp_name = RECIPES[args.which]
    cfg = os.path.join(REPO, cfg)
    work_dir = os.path.abspath(args.work_dir)
    os.makedirs(work_dir, exist_ok=True)
    env = child_env()
    resumable = resume_decision(run_logdirs(work_dir, exp_name), args.epochs, args.fresh,
                                args.skip_train)
    if not args.skip_train:
        train_cmd = [sys.executable, "-m", "poco_tpu_torch.cli.train", "--cfg", cfg,
                     "--data_dir", root, "--max_epochs", str(args.epochs),
                     "--device", args.device]
        if resumable is not None:
            logdir, done = resumable
            if done >= args.epochs:
                print(f"resume: {logdir} already at epoch {done} >= {args.epochs}, "
                      "skipping training", file=sys.stderr)
                train_cmd = None
            else:
                print(f"resume: {logdir} from epoch {done}/{args.epochs}", file=sys.stderr)
                train_cmd += ["--resume", os.path.join(logdir, "last"), "--logdir", logdir]
        if train_cmd is not None:
            r = subprocess.run(train_cmd, cwd=work_dir, env=env)
            if r.returncode != 0:
                raise SystemExit(f"cli.train failed ({r.returncode})")

    if resumable is not None:
        logdir = resumable[0]
    else:
        cands = run_logdirs(work_dir, exp_name)
        if not cands:
            raise SystemExit(f"no {exp_name} logdir found under {work_dir}/logs")
        logdir = max(cands, key=os.path.getmtime)

    def eval_ckpt(name: str) -> dict:
        report = os.path.join(logdir, f"convergence_eval_{args.which}_{name}.json")
        r = subprocess.run(
            [sys.executable, "-m", "poco_tpu_torch.cli.eval", "--cfg", cfg,
             "--ckpt", os.path.join(logdir, f"{name}.pt"), "--dataset", ds,
             "--data_dir", root, "--batch_size", "50", "--out", report,
             "--device", args.device],
            cwd=work_dir, env=env, stdout=subprocess.DEVNULL,
        )
        if r.returncode != 0:
            raise SystemExit(f"cli.eval failed ({r.returncode})")
        with open(report) as f:
            return json.load(f)["summary"]

    # the best-MPJPE checkpoint gates; the best-calibration one
    # (best_model_mpjpe_var, reference train_utils.py:132-133) is reported
    best = _summary_fields(eval_ckpt("best_model"))
    mpjpe_var = None
    if os.path.exists(os.path.join(logdir, "best_model_mpjpe_var.pt")):
        mpjpe_var = _summary_fields(eval_ckpt("best_model_mpjpe_var"))

    # the calibration trajectory, from the trainer's validation history
    curve = []
    val_hist = os.path.join(logdir, "val_accuracy.json")
    if os.path.exists(val_hist):
        with open(val_hist) as f:
            for rec in json.load(f):
                curve.append({
                    "epoch": rec.get("epoch"),
                    "mpjpe": round(float(rec.get("mpjpe", float("nan"))), 2),
                    "uncert_pose_corr": round(float(rec.get("uncert_pose_corr", float("nan"))), 4),
                })

    ok = best["mpjpe"] <= args.mpjpe_thresh and best["uncert_pose_corr"] >= args.corr_thresh
    out = {
        "benchmark": "synthetic_convergence",
        "which": args.which,
        "curve": curve,
        "epochs": args.epochs,
        "val_mpjpe_mm": round(best["mpjpe"], 2),
        "uncert_pose_corr": round(best["uncert_pose_corr"], 4),
        "uncert_mpjpe_corr": round(best["uncert_mpjpe_corr"], 4),
        "mpjpe_thresh": args.mpjpe_thresh,
        "corr_thresh": args.corr_thresh,
        "pass": bool(ok),
        "logdir": logdir,
    }
    if mpjpe_var is not None:
        out["best_mpjpe_var"] = {
            "val_mpjpe_mm": round(mpjpe_var["mpjpe"], 2),
            "uncert_pose_corr": round(mpjpe_var["uncert_pose_corr"], 4),
            "mpjpe_var": round(mpjpe_var["mpjpe_var"], 2),
        }
    print(json.dumps(out), flush=True)
    if not ok:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
