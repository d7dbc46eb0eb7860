"""Evaluation CLI: a 3DPW-style test (the port's counterpart of the repo's
`eval.py`).

    python -m poco_tpu_torch.cli.eval --cfg configs/poco_cliff.yaml [--cfg_id N] \\
        --ckpt <.pt file or a logdir holding one> [--dataset 3dpw] \\
        [--data_dir data] [--smpl_dir DIR] [--batch_size 64] [--out report.json] \\
        [--flip_test] [--device cuda|cpu] [--dist]
    python -m poco_tpu_torch.cli.eval --cfg GRID.yaml --make_launcher bash|slurm

Prints (and with --out writes) one JSON report: `summary` (mpjpe,
pa_mpjpe, v2v in mm, best_model_metric and, with an uncertainty head, the
calibration correlations), `splits` (3DPW all / test_seq / occluded_seq)
and `per_joint`. The H36M regressor is used when the data dir holds
`J_regressor_h36m.npy`; otherwise the 14 joints come from the SMPL
skeleton. TF32 is switched off for cuBLAS and cuDNN before the first
kernel, so the numbers are fp32's.

Over several processes (the POCO_* variables, or `--dist` under torchrun;
see `cli/train.py`) each runs its share of every batch, the per-sample
metrics are gathered, and rank 0 prints and writes the report.
`--make_launcher` writes a launcher over the config's grid search, one
`--cfg_id` a run, and exits, as in `cli/train.py`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import default_device
from ..parallel import distributed as dist


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--cfg_id", type=int, default=None,
                        help="experiment id within a grid-search config (one whose "
                             "values are lists); creates no logdir")
    parser.add_argument("--ckpt", default=None,
                        help="torch .pt/.ckpt file, or a run logdir holding one")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--smpl_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--out", default=None, help="report json path")
    parser.add_argument(
        "--flip_test", action="store_true",
        help="horizontal-flip test-time augmentation: the mirrored crop "
             "through the same model, the rotations un-flipped and averaged "
             "on SO(3), one more SMPL pass; about 2x the compute",
    )
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    parser.add_argument("--dist", action="store_true",
                        help="form the process group from torchrun's environment (the "
                             "POCO_* variables form it without this flag); metrics are "
                             "gathered over processes, rank 0 prints and writes the report")
    parser.add_argument("--make_launcher", default=None, choices=["bash", "slurm"],
                        help="write a grid-search eval array launcher (scripts/<name>.sh or "
                             ".sbatch, one --cfg_id a run) and exit")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.make_launcher:
        from ..utils.cluster import EVAL, write_launcher

        path = write_launcher(args.cfg, module=EVAL, scheduler=args.make_launcher)
        print(f"launcher written: {path}")
        return {"launcher": path}
    dist.form_world(args.device, auto=args.dist)
    try:
        return _evaluate(args)
    finally:
        dist.shutdown()


def _evaluate(args) -> dict:
    from ..device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..config import (
        dataset_npz_path,
        model_config_from_hparams,
        run_grid_search_experiments,
        update_hparams,
    )
    from ..data.dataset import PocoDataset
    from ..eval.runner import pw3d_split_report, run_eval
    from ..models.poco import POCO
    from ..smpl.assets import resolve_smpl_params
    from ..utils.checkpoint import load_checkpoint_into

    if args.cfg_id is not None:
        # a grid-search config: one experiment, and no logdir written
        hparams = run_grid_search_experiments(args.cfg, cfg_id=args.cfg_id, log=False)
    else:
        hparams = update_hparams(args.cfg)
    if args.data_dir:
        hparams.DATASET.DATA_DIR = args.data_dir
    data_dir = hparams.DATASET.DATA_DIR
    ds_name = args.dataset or hparams.DATASET.VAL_DS

    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(hparams)).to(device).eval()
    if args.ckpt:
        inf_model = str(getattr(hparams.TESTING, "INF_MODEL", "best") or "best")
        load_checkpoint_into(model, args.ckpt, inf_model=inf_model)
    else:
        print("no --ckpt: evaluating randomly initialized weights (torch seed 0)")

    dataset = PocoDataset(
        dataset_npz_path(data_dir, ds_name, is_train=False),
        img_dir=data_dir, dataset_name=ds_name, is_train=False,
        options={
            "IMG_RES": hparams.DATASET.IMG_RES,
            "UNCERT_THRESHOLD": hparams.DATASET.UNCERT_THRESHOLD,
            "TEST_ROT": hparams.TESTING.TEST_ROT,
            "TEST_SCALE": hparams.TESTING.TEST_SCALE,
        },
    )

    # the H36M 17-joint regressor of the 3DPW protocol (eval_utils.py:
    # 62-75), asset-gated like the SMPL files
    j_reg = None
    reg_path = os.path.join(data_dir, "J_regressor_h36m.npy")
    if os.path.exists(reg_path):
        j_reg = torch.from_numpy(np.load(reg_path).astype(np.float32)).to(device)
        print(f"using H36M eval regressor: {reg_path}")

    result = run_eval(
        model, dataset,
        smpl_neutral=resolve_smpl_params(args.smpl_dir, "neutral", device),
        smpl_male=resolve_smpl_params(args.smpl_dir, "male", device),
        smpl_female=resolve_smpl_params(args.smpl_dir, "female", device),
        batch_size=args.batch_size,
        loss_ver=hparams.POCO.LOSS_VER,
        j_regressor_eval=j_reg,
        flip_test=args.flip_test,
    )
    payload = {
        "summary": result.summary(),
        "splits": pw3d_split_report(
            result.imgnames, result.mpjpe_mm, result.pa_mpjpe_mm, result.v2v_mm
        ),
    }
    per_joint = result.per_joint_stats()
    if per_joint is not None:
        payload["per_joint"] = per_joint
    # every process holds the gathered report; rank 0 prints and writes it
    if dist.is_main_process():
        print(json.dumps(payload, indent=1))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1)
    dist.barrier()
    return payload


if __name__ == "__main__":
    main()
