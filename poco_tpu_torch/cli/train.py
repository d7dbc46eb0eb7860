"""Training CLI (the port's counterpart of the repo's `train.py`).

    python -m poco_tpu_torch.cli.train --cfg configs/poco_cliff.yaml \\
        [--cfg_id 0] [--data_dir data] [--smpl_dir DIR] [--max_epochs N] \\
        [--resume <logdir>/last] [--logdir DIR] [--pretrained X.pt] \\
        [--device cuda|cpu] [--dist]
    python -m poco_tpu_torch.cli.train --cfg GRID.yaml --make_launcher bash|slurm

Expands the config's grid search and takes experiment `--cfg_id`, seeds,
sets up the logdir (a timestamped one under LOG_DIR unless `--logdir`
pins it), builds the training set from DATASETS_AND_RATIOS or
STAGE_DATASETS and the validation set from VAL_DS (when its npz exists),
and fits with validation after each epoch; with RUN_TEST, evaluates the
best checkpoint at the end. Checkpoints are `<logdir>/{last,best_model,
best_model_mpjpe_var,epoch_NNN}.pt`, each with a `.trainer.json` sidecar;
`python -m poco_tpu_torch.cli.eval --ckpt <logdir>` evaluates the run's
`best_model`. TF32 is switched off for cuBLAS and cuDNN, so training runs
in fp32 (or bf16 autocast with TRAINING.PRECISION: 16).

Multi-GPU: one process a card, over NCCL (gloo with `--device cpu`),
formed before the first CUDA use by `parallel.distributed.
maybe_initialize`: with POCO_COORDINATOR / POCO_NUM_PROCESSES /
POCO_PROCESS_ID set, or with `--dist` under torchrun
(`torchrun --nproc_per_node N -m poco_tpu_torch.cli.train --dist ...`).
DATASET.BATCH_SIZE stays the global batch; rank 0 writes the logs and
checkpoints and prints, and copies the code (the package and
chip_smoke.py) into `<logdir>/code` first, as train.py does.

`--make_launcher bash|slurm` writes `scripts/<name>.sh` (a loop) or
`scripts/<name>.sbatch` (a SLURM array) that runs every experiment of the
config's grid search with `--cfg_id`, and exits (`utils/cluster.py`).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..device import default_device
from ..parallel import distributed as dist


def build_train_dataset_factory(hparams, options):
    """epoch -> training set, following the stage curriculum when
    DATASET.TRAIN_DS is "stage" (reference trainer.py:640-654)."""
    from ..config import dataset_npz_path
    from ..data.dataset import PocoDataset
    from ..data.mixed import (
        RatioMixedDataset,
        parse_datasets_and_ratios,
        parse_stage_datasets,
        stage_for_epoch,
    )

    data_dir = hparams.DATASET.DATA_DIR

    def load_ds(name: str, seed: int):
        return PocoDataset(
            dataset_npz_path(data_dir, name, is_train=True), img_dir=data_dir,
            dataset_name=name, is_train=True, use_augmentation=hparams.TRAINING.USE_AUGM,
            ignore_3d=hparams.DATASET.IGNORE_3D, options=options, seed=seed,
        )

    stages = (parse_stage_datasets(hparams.DATASET.STAGE_DATASETS)
              if hparams.DATASET.TRAIN_DS == "stage" else None)

    def factory(epoch: int):
        spec = stage_for_epoch(stages, epoch) if stages else hparams.DATASET.DATASETS_AND_RATIOS
        names, ratios = parse_datasets_and_ratios(spec)
        if len(names) == 1:
            return load_ds(names[0], seed=epoch)
        return RatioMixedDataset([load_ds(n, seed=epoch) for n in names], ratios, seed=epoch)

    return factory


def build_datasets(hparams):
    """The trainer's datasets from the config: the epoch -> training set
    factory and the validation set of VAL_DS (None when its npz is
    missing), both with the DATASET section's augmentation options."""
    from ..config import dataset_npz_path
    from ..data.dataset import PocoDataset

    options = {
        "FLIP": bool(hparams.DATASET.FLIP),
        "NOISE_FACTOR": hparams.DATASET.NOISE_FACTOR,
        "ROT_FACTOR": hparams.DATASET.ROT_FACTOR,
        "SCALE_FACTOR": hparams.DATASET.SCALE_FACTOR,
        "IMG_RES": hparams.DATASET.IMG_RES,
        "UNCERT_THRESHOLD": hparams.DATASET.UNCERT_THRESHOLD,
    }
    val_npz = dataset_npz_path(hparams.DATASET.DATA_DIR, hparams.DATASET.VAL_DS, is_train=False)
    val_dataset = (
        PocoDataset(val_npz, img_dir=hparams.DATASET.DATA_DIR,
                    dataset_name=hparams.DATASET.VAL_DS, is_train=False, options=options)
        if os.path.exists(val_npz) else None
    )
    return build_train_dataset_factory(hparams, options), val_dataset


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True, help="experiment yaml")
    parser.add_argument("--cfg_id", type=int, default=0, help="grid-search experiment index")
    parser.add_argument("--smpl_dir", default=None, help="SMPL model directory (else synthetic)")
    parser.add_argument("--data_dir", default=None, help="override DATASET.DATA_DIR")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--resume", default=None, help="checkpoint to resume, e.g. <logdir>/last")
    parser.add_argument("--logdir", default=None,
                        help="pin the run to this logdir (pairs with --resume)")
    parser.add_argument("--pretrained", default=None,
                        help="warm-start weights (torch .pt); overrides TRAINING.PRETRAINED")
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    parser.add_argument("--dist", action="store_true",
                        help="form the process group from torchrun's environment (the "
                             "POCO_* variables form it without this flag)")
    parser.add_argument("--make_launcher", default=None, choices=["bash", "slurm"],
                        help="write a grid-search array launcher (scripts/<name>.sh or "
                             ".sbatch, one --cfg_id a run) and exit")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.make_launcher:
        from ..utils.cluster import TRAIN, write_launcher

        path = write_launcher(args.cfg, module=TRAIN, scheduler=args.make_launcher)
        print(f"launcher written: {path}")
        return {"launcher": path}
    dist.form_world(args.device, auto=args.dist)
    try:
        return _train(args)
    finally:
        dist.shutdown()


def _train(args) -> dict:
    from ..device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..config import run_grid_search_experiments
    from ..smpl.assets import resolve_smpl_params
    from ..train.trainer import Trainer
    from ..utils.os_utils import copy_code

    logdir = args.logdir
    if dist.process_count() > 1 and logdir is None:
        # one timestamped logdir for all processes: rank 0's
        logdir = dist.broadcast_object(
            run_grid_search_experiments(args.cfg, args.cfg_id, log=False).LOG_DIR
            if dist.is_main_process() else None)
    hparams = run_grid_search_experiments(args.cfg, args.cfg_id, log=dist.is_main_process(),
                                          logdir=logdir)
    if args.data_dir:
        hparams.DATASET.DATA_DIR = args.data_dir
    if args.pretrained:
        hparams.TRAINING.PRETRAINED = args.pretrained
    if dist.is_main_process():
        copy_code(hparams.LOG_DIR)
    train_dataset_fn, val_dataset = build_datasets(hparams)
    trainer = Trainer(
        hparams,
        resolve_smpl_params(args.smpl_dir, "neutral", device),
        train_dataset_fn=train_dataset_fn,
        val_dataset=val_dataset,
        smpl_male=resolve_smpl_params(args.smpl_dir, "male", device),
        smpl_female=resolve_smpl_params(args.smpl_dir, "female", device),
        device=device,
    )
    try:
        if args.resume:
            trainer.load_checkpoint(args.resume)
        summary = trainer.fit(args.max_epochs)
        if dist.is_main_process():
            print("final:", summary)
        # RUN_TEST: the best checkpoint evaluated at the end (reference
        # train.py:98-106)
        if hparams.RUN_TEST and val_dataset is not None:
            best = os.path.join(hparams.LOG_DIR, "best_model")
            if os.path.exists(best + ".pt"):
                trainer.load_checkpoint(best)
            summary = trainer.validate(trainer.epoch)
            if dist.is_main_process():
                print("test:", summary)
    finally:
        trainer.close()
    return summary


if __name__ == "__main__":
    main()
