"""One rank of a multi-process run of the PyTorch port, on the CPU over gloo
(driven by tests/test_torch_multiprocess.py).

    python tests/torch_mp_worker.py --world 2 --rank 0 --init /tmp/x/init \\
        --outdir /tmp/x --data_dir data

Each case below is a function of the rows it is given, so the test runs the
same function in its own process (one process, every row) and compares:

  * `bn_case`: a conv, `BatchNorm2d`, a linear layer and `BatchNorm1d` in
    training, inside `flax_variance_update`: the outputs, the input's and
    the parameters' gradients and the running statistics;
  * `step_case`: one train step of tiny-cliff (configs/tiny_smoke.yaml)
    through `Trainer._device_batch` and `Trainer.train_step`, on a batch of
    8 whose has_smpl, has_pose_3d and GT-pose-conditioned rows fall
    unevenly across two shards, with the CLIFF head's dropout live;
  * `fit_case`: `Trainer.fit` of tiny_smoke on the repo's smoke set (batch
    8, one epoch, no augmentation, GT_POSE_COND at 0.5), then `run_eval`
    of its weights on the smoke test set.

Each rank writes `<case>_rank<r>.npz` (and rank 0 the fit's `fit.pt`, its
weights after the fit). Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from poco_tpu_torch.parallel import distributed as dist  # noqa: E402

GLOBAL_BATCH = 8
STEP_NAMES = ["h36m", "coco", "h36m", "h36m", "coco", "coco", "h36m", "coco"]
STEP_HAS_SMPL = [1, 0, 1, 1, 0, 0, 1, 0]
STEP_HAS_POSE_3D = [0, 1, 1, 1, 1, 0, 0, 0]


def bn_case(rows: slice, dtype=torch.float32) -> dict[str, np.ndarray]:
    from torch import nn

    from poco_tpu_torch.models.backbones.common import BatchNorm1d, batch_norm, conv
    from poco_tpu_torch.models.backbones.common import flax_variance_update

    torch.manual_seed(0)
    net = nn.Sequential(conv(3, 5, 3), batch_norm(5), nn.ReLU(), nn.Flatten(),
                        nn.Linear(5 * 6 * 6, 7, bias=False), BatchNorm1d(7, momentum=0.1))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in (net[1], net[5]):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0.0, 0.3, generator=gen)
            m.running_mean.normal_(0.0, 0.5, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    net.to(dtype)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((1.0 + rng.randn(4, 3, 6, 6)).astype(np.float32))[rows].to(dtype)
    w = torch.from_numpy(rng.randn(4, 7).astype(np.float32))[rows].to(dtype)
    x.requires_grad_(True)
    net.train()
    with flax_variance_update(net):
        out = net(x)
    (out * w).sum().backward()
    dist.all_reduce_gradients(net.parameters())
    res = {"out": out.detach().numpy(), "x_grad": x.grad.numpy()}
    for name, p in net.named_parameters():
        res[f"grad/{name}"] = p.grad.numpy()
    for name, b in net.named_buffers():
        res[f"buffer/{name}"] = b.numpy()
    return res


def tiny_hparams(logdir: str, data_dir: str):
    from poco_tpu_torch.config import update_hparams

    h = update_hparams(os.path.join(REPO, "configs", "tiny_smoke.yaml"))
    h.LOG_DIR = logdir
    h.DATASET.DATA_DIR = data_dir
    h.TRAINING.USE_AUGM = False
    h.DATASET.BATCH_SIZE = GLOBAL_BATCH
    h.TRAINING.MAX_EPOCHS = 1
    h.TRAINING.LOG_SAVE_INTERVAL = 1
    h.POCO.GT_POSE_COND = True
    h.POCO.GT_POSE_COND_DS = "smoke"
    h.POCO.GT_POSE_COND_RATIO = 0.5
    return h


def step_batch() -> dict:
    """The global batch of `step_case` (PocoDataset's item schema)."""
    rng = np.random.RandomState(3)
    n = GLOBAL_BATCH
    return {
        "img": (rng.rand(n, 224, 224, 3) * 255).astype(np.float32),
        "pose": (0.2 * rng.randn(n, 72)).astype(np.float32),
        "betas": (0.5 * rng.randn(n, 10)).astype(np.float32),
        "pose_3d": rng.randn(n, 24, 4).astype(np.float32),
        "keypoints": rng.rand(n, 49, 3).astype(np.float32),
        "has_smpl": np.asarray(STEP_HAS_SMPL, np.float32),
        "has_pose_3d": np.asarray(STEP_HAS_POSE_3D, np.float32),
        "scale": np.ones(n, np.float32),
        "center": np.tile(np.float32([500.0, 400.0]), (n, 1)),
        "orig_shape": np.tile(np.float32([800.0, 1000.0]), (n, 1)),
        "focal_length": np.full(n, 1280.0, np.float32),
        "bbox_info": rng.randn(n, 3).astype(np.float32),
    }


def step_case(rows: slice, logdir: str, data_dir: str) -> dict[str, np.ndarray]:
    from poco_tpu_torch.smpl.assets import synthetic_smpl_model
    from poco_tpu_torch.train.trainer import Trainer

    h = tiny_hparams(logdir, data_dir)
    h.POCO.GT_POSE_COND_DS = "h36m"
    h.POCO.GT_POSE_COND_RATIO = 0.75   # h36m rows 0, 2, 3 of 0, 2, 3, 6: all in shard 0
    trainer = Trainer(h, synthetic_smpl_model(device="cpu"), train_dataset_fn=None,
                      device="cpu")
    host = {k: v[rows] for k, v in step_batch().items()}
    host["dataset_name"] = STEP_NAMES[rows]
    if dist.process_count() > 1:
        host["_global_row_names"] = list(STEP_NAMES)
    batch = trainer._device_batch(host)
    metrics = trainer.train_step(batch, trainer.smpl)
    res = {f"metric/{k}": v.numpy() for k, v in metrics.items() if not k.startswith("_")}
    res["cond_mask"] = batch["gt_pose_cond_mask"].numpy()
    for name, p in trainer.model.named_parameters():
        res[f"grad/{name}"] = p.grad.numpy()
    for name, v in trainer.model.state_dict().items():
        res[f"state/{name}"] = v.numpy()
    trainer.close()
    return res


def fit_case(logdir: str, data_dir: str) -> tuple[dict[str, np.ndarray], dict]:
    """The fit's per-step losses, train-time uncertainty statistics (rank
    0's dump), validation summary and parameter checksum, and
    `run_eval`'s per-sample arrays of the fitted weights; and the fitted
    model's state_dict."""
    import json

    from poco_tpu_torch.data.dataset import PocoDataset
    from poco_tpu_torch.eval.runner import run_eval
    from poco_tpu_torch.smpl.assets import resolve_smpl_params
    from poco_tpu_torch.train.trainer import Trainer

    h = tiny_hparams(logdir, data_dir)
    options = {"IMG_RES": h.DATASET.IMG_RES}
    extras = os.path.join(data_dir, "dataset_extras")

    def train_ds(_epoch: int):
        return PocoDataset(os.path.join(extras, "smoke_train.npz"), img_dir=data_dir,
                           dataset_name="smoke", is_train=True, use_augmentation=False,
                           options=options)

    val_ds = PocoDataset(os.path.join(extras, "smoke_test.npz"), img_dir=data_dir,
                         dataset_name="smoke", is_train=False, options=options)
    smpl = resolve_smpl_params(None, "neutral", "cpu")
    trainer = Trainer(h, smpl, train_dataset_fn=train_ds, val_dataset=val_ds, device="cpu")
    summary = trainer.fit(max_epochs=1)
    trainer.close()
    res = {"param_sum": np.float64(sum(float(p.detach().abs().sum())
                                       for p in trainer.model.parameters()))}
    res.update({f"val/{k}": np.float64(v) for k, v in summary.items()
                if isinstance(v, (int, float))})
    if dist.is_main_process():
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        res["losses"] = np.asarray([r["loss/total_loss"] for r in records
                                    if "loss/total_loss" in r and "step" in r])
        with open(os.path.join(logdir, "uncert_stats_train_e0.json")) as f:
            stats = json.load(f)
        res["uncert_stats"] = np.asarray([list(stats[k].values()) for k in
                                          ("uncert_mean", "uncert_min", "uncert_max")])
    result = run_eval(trainer.model, val_ds, smpl, batch_size=GLOBAL_BATCH,
                      loss_ver=h.POCO.LOSS_VER)
    res["eval/imgnames"] = np.asarray(result.imgnames)
    for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm", "uncert", "pose_dist"):
        res[f"eval/{key}"] = getattr(result, key)
    return res, trainer.model.state_dict()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True, help="file of the file:// rendezvous")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--data_dir", required=True)
    args = ap.parse_args()

    torch.set_num_threads(1)
    dist.maybe_initialize(coordinator=f"file://{args.init}", num_processes=args.world,
                          process_id=args.rank, backend="gloo")
    lo, hi = dist.local_shard_bounds(4)
    np.savez(os.path.join(args.outdir, f"bn_rank{args.rank}.npz"), **bn_case(slice(lo, hi)))
    lo, hi = dist.local_shard_bounds(GLOBAL_BATCH)
    np.savez(os.path.join(args.outdir, f"step_rank{args.rank}.npz"),
             **step_case(slice(lo, hi), os.path.join(args.outdir, "step"), args.data_dir))
    res, state = fit_case(os.path.join(args.outdir, "fit"), args.data_dir)
    np.savez(os.path.join(args.outdir, f"fit_rank{args.rank}.npz"), **res)
    if dist.is_main_process():
        torch.save(state, os.path.join(args.outdir, "fit.pt"))
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    main()
