"""Camera-decoder calibration: train ONLY the head's `deccam` on the 2D
loss (the port's counterpart of the repo's `tools/camera_bringup.py`).

    python -m poco_tpu_torch.cli.camera_bringup --ckpt <run logdir | X.pt> \\
        [--cfg configs/convergence_ft2d.yaml] [--epochs 40] [--lr 1e-5] \\
        [--out <dir>/best_model_cam] [--data_dir data] [--max_steps N] \\
        [--eval_batches N] [--device cuda|cpu]

The convergence recipe (configs/convergence.yaml) trains with
KEYPOINT_2D_LOSS_WEIGHT 0, so its full-image camera is never supervised
and everything downstream of `smpl_joints2d` (demo overlays, the refine
detector, pose tracking) is meaningless on its checkpoints; training the
whole head on the 2D loss diverges (configs/convergence_ft2d.yaml). This
pass trains the camera decoder alone (`deccam`, 3,075 parameters on
CLIFF, reference cliff_head.py:45-49): its leaves are zeroed first, which
makes the residual decoder emit the SMPL mean camera through all three
iterations, then trained with the pose, shape, beta and flow weights at
0, by SGD (momentum 0.9, `--lr`) on gradients with NaNs zeroed, clipped
elementwise at 1e3 and to a global norm of 1 (optax's zero_nans, clip,
clip_by_global_norm, sgd; Adam blows the camera's scale up within two
steps). Every other parameter and every BN statistic stays bit-identical:
the other parameters take no gradient, and the BN running statistics
are put back after every train-mode step. The gradient reaches `deccam`
through the next iteration's conditioning (cliff_head.py:99-113): the
camera itself is detached before the 2D projection.

Writes a port checkpoint (`<out>.pt`; by default `best_model_cam.pt` in
the run logdir, or beside the given file) that `cli.eval`, `cli.demo
--ckpt` (`--inf_model cam`) and `cli.detector_quality` load, and prints
the full-image 2D pixel error and val MPJPE of the raw checkpoint, of the
mean-camera start and after training, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..device import default_device
from ..train.step import global_norm

ELEMENT_CLIP = 1e3   # optax.clip
MAX_NORM = 1.0       # optax.clip_by_global_norm
MOMENTUM = 0.9


def is_deccam(name: str) -> bool:
    """Whether a parameter belongs to a module named `deccam`."""
    return "deccam" in name.split(".")


class CameraSGD:
    """The camera leaves' optimizer with the train step's interface
    (`params`, `zero_grad`, `step() -> gradient norm`): the optax chain
    zero_nans -> clip(1e3) -> clip_by_global_norm(1.0) -> sgd(lr,
    momentum 0.9) over the `deccam` parameters; torch's SGD with momentum
    0.9 and dampening 0 is optax's trace. No other parameter is touched.
    Returns the camera gradient's global norm after the elementwise clip,
    the norm that the global clip reads."""

    def __init__(self, model: torch.nn.Module, lr: float):
        self.params = [p for n, p in model.named_parameters() if is_deccam(n)]
        self.optimizer = torch.optim.SGD(self.params, lr=lr, momentum=MOMENTUM, dampening=0.0)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        for g in grads:
            g.masked_fill_(torch.isnan(g), 0.0).clamp_(-ELEMENT_CLIP, ELEMENT_CLIP)
        norm = global_norm(grads)
        # optax: unchanged below the bound, else g / norm * bound
        for g in grads:
            g.copy_(torch.where(norm < MAX_NORM, g, g / norm * MAX_NORM))
        self.optimizer.step()
        return norm


def camera_only(model: torch.nn.Module) -> int:
    """Zero every `deccam` leaf, let only those take gradients; returns
    their size."""
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            cam = is_deccam(name)
            p.requires_grad_(cam)
            if cam:
                p.zero_()
                n += p.numel()
    return n


def bn_statistics(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Copies of the BN running statistics (and their counters)."""
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def restore(model: torch.nn.Module, saved: dict[str, torch.Tensor]) -> None:
    state = model.state_dict()
    with torch.no_grad():
        for k, v in saved.items():
            state[k].copy_(v)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", default="configs/convergence_ft2d.yaml")
    parser.add_argument("--ckpt", required=True, help="a run logdir (its best_model) or a .pt")
    parser.add_argument("--out", default=None,
                        help="output checkpoint, without .pt (default: best_model_cam in the "
                             "run logdir, or beside the given file)")
    parser.add_argument("--epochs", type=int, default=40)
    # the decoder's input is 1024-wide: the quadratic's curvature scales
    # with |xc|^2 and 1e-3 diverges within 2 steps (JAX tool, measured)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--max_steps", type=int, default=0,
                        help="optimizer steps an epoch at most (0: the whole epoch)")
    parser.add_argument("--eval_batches", type=int, default=0,
                        help="evaluation batches at most (0: all)")
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    args = parser.parse_args(argv)

    from ..config import (
        dataset_npz_path,
        loss_config_from_hparams,
        model_config_from_hparams,
        update_hparams,
    )
    from ..data.dataset import DataLoader, PocoDataset
    from ..device import resolve_device
    from ..eval.runner import make_gendered_eval_step
    from ..models.poco import POCO
    from ..ops.preprocess import normalize_image
    from ..smpl.assets import resolve_smpl_params
    from ..train.step import make_train_step
    from ..utils.checkpoint import load_checkpoint_into, save_checkpoint

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hparams = update_hparams(args.cfg)
    # the 2D reprojection term (noncrop, CLIFF's) is the objective; the
    # other terms have next to no gradient at the camera decoder
    loss_cfg = dataclasses.replace(
        loss_config_from_hparams(hparams), keypoint3d_loss_weight=0.0, pose_loss_weight=0.0,
        beta_loss_weight=0.0, shape_loss_weight=0.0, nf_loss_weight=0.0,
    )
    smpl = resolve_smpl_params(None, "neutral", device)
    smpl_m = resolve_smpl_params(None, "male", device)
    smpl_f = resolve_smpl_params(None, "female", device)

    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(hparams)).to(device)
    load_checkpoint_into(model, args.ckpt)
    bn_stats = bn_statistics(model)

    def load_ds(name: str, is_train: bool, seed: int = 0) -> PocoDataset:
        return PocoDataset(
            dataset_npz_path(args.data_dir, name, is_train=is_train), img_dir=args.data_dir,
            dataset_name=name, is_train=is_train,
            use_augmentation=is_train and hparams.TRAINING.USE_AUGM,
            options={"FLIP": hparams.DATASET.FLIP}, seed=seed,
        )

    def device_batch(host_batch: dict) -> dict:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in host_batch.items() if not isinstance(v, list)}
        batch["img"] = normalize_image(batch["img"].float())
        return batch

    train_name = hparams.DATASET.DATASETS_AND_RATIOS.rsplit("_", 1)[0]
    val_ds = load_ds(hparams.DATASET.VAL_DS, is_train=False)
    bsz = hparams.DATASET.BATCH_SIZE

    @torch.no_grad()
    def px2d_and_mpjpe() -> tuple[float, float]:
        """The mean full-image 2D pixel error and val MPJPE (mm), by the
        evaluation's convention (skeleton J14, hip-midpoint pelvis)."""
        model.eval()
        metric_step = make_gendered_eval_step(model, None)
        errs, mpjpes = [], []
        for bi, host_batch in enumerate(DataLoader(val_ds, batch_size=bsz, shuffle=False)):
            if args.eval_batches and bi >= args.eval_batches:
                break
            batch = device_batch(host_batch)
            j2d = model(batch, smpl)["smpl_joints2d"].cpu().numpy()
            m = metric_step(batch, smpl, smpl_m, smpl_f)
            gt = np.asarray(host_batch["keypoints_fullimg"])
            conf = gt[..., 2]
            d = np.linalg.norm(j2d - gt[..., :2], axis=-1)
            errs.append((d * conf).sum() / np.maximum(conf.sum(), 1.0))
            mpjpes.append(float(m["mpjpe"].mean()))
        return float(np.mean(errs)), 1000.0 * float(np.mean(mpjpes))

    px_orig, mpjpe_orig = px2d_and_mpjpe()
    print(f"raw checkpoint: 2d err {px_orig:.1f} px, val mpjpe {mpjpe_orig:.1f} mm", flush=True)
    n_train = camera_only(model)
    if n_train == 0:
        raise SystemExit("no deccam leaves: is this a CLIFF- or HMR-head model?")
    print(f"trainable camera-decoder params: {n_train}", flush=True)
    train_step = make_train_step(model, CameraSGD(model, args.lr), loss_cfg)
    px0, mpjpe0 = px2d_and_mpjpe()
    print(f"mean-cam init: 2d err {px0:.1f} px, val mpjpe {mpjpe0:.1f} mm", flush=True)

    torch.manual_seed(1)   # the dropout masks
    for epoch in range(args.epochs):
        loader = DataLoader(load_ds(train_name, is_train=True, seed=epoch), batch_size=bsz,
                            shuffle=True, seed=epoch)
        last = {}
        for si, host_batch in enumerate(loader):
            if args.max_steps and si >= args.max_steps:
                break
            last = train_step(device_batch(host_batch), smpl)
            restore(model, bn_stats)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            kp = float(last.get("loss/loss_keypoints", np.nan))
            print(f"epoch {epoch}: kp2d loss {kp:.4f}", flush=True)

    px1, mpjpe1 = px2d_and_mpjpe()
    print(f"after:  2d err {px1:.1f} px, val mpjpe {mpjpe1:.1f} mm", flush=True)
    out = args.out
    if not out:
        run = args.ckpt if os.path.isdir(args.ckpt) else os.path.dirname(os.path.abspath(args.ckpt))
        out = os.path.join(run, "best_model_cam")
    out = save_checkpoint(out, model)
    result = {
        "out": out, "px2d_raw_ckpt": round(px_orig, 2),
        "mpjpe_raw_ckpt_mm": round(mpjpe_orig, 2),
        "px2d_meancam": round(px0, 2),
        "px2d_after": round(px1, 2), "mpjpe_meancam_mm": round(mpjpe0, 2),
        "mpjpe_after_mm": round(mpjpe1, 2), "epochs": args.epochs,
        "trainable_params": n_train,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
