"""Training orchestration (port of `poco_tpu.train.trainer`).

Reference contract: pocolib/core/trainer.py:28-708. The trainer builds the
model, loss and optimizer from the hparams tree and runs epochs:

  * per-epoch datasets from a factory, so stage curricula (STAGE_DATASETS)
    can switch them;
  * the freeze schedule (FREEZE_PARAMS): a new optimizer at each scheduled
    epoch, its moments from zero (reference trainer.py:192-208);
  * the GT-pose-conditioning mask, chosen on the host per batch
    (reference poco_head.py:101-107);
  * validation through `run_eval`, the composite best-model criterion
    0.5 * (1.5 PA-MPJPE + MPJPE) with the uncertainty/error correlation as
    the tie-break (trainer.py:407-442), `best_model_mpjpe_var`, the 5 best
    epochs kept, and the LR halved on a plateau without a new optimizer;
  * checkpoints (`utils/checkpoint.py`) with a `.trainer.json` sidecar
    (epoch, trackers, plateau LR, top-k, and the generator states), so a
    resumed run repeats the uninterrupted one; JSONL, CSV and tensorboard
    logs.

The trainer owns its randomness: it seeds torch's generators (CPU and
CUDA) from SEED_VALUE before building the model, and the dropout masks
come from them. `PRECISION: 16` runs the model under a bf16 autocast,
with SMPL and the losses in fp32. With TRAINING.SAVE_IMAGES, every
LOG_SAVE_INTERVAL step renders the first 4 rows of the (global) batch as
a [crop | GT mesh | predicted mesh] grid into
`<logdir>/images/train_e{epoch}_s{step}.png` (`viz/train_viz.py`; rank 0
renders). With the environment variable POCO_TPU_PROFILE_DIR set (the JAX
trainer's knob), epoch 0's first 5 steps are traced by torch.profiler
(CPU and CUDA activities) into `<dir>/train_e0_rank{r}.json`, a Chrome
trace. DATASET.USE_SYNTHETIC_OCCLUSION is refused: the JAX trainer passes
its datasets no occluders, so the flag does nothing there;
`PocoDataset(occluders=...)` takes them.

Over several processes (`parallel.distributed`), each loads its rows of
every global batch and the step reduces over the global batch, so the run
is the one-process run; the GT-pose-conditioning mask is chosen on the
global batch's row names; validation shards `run_eval`; the train-time
`var_pose` rows are gathered for the statistics; and only rank 0 writes
(logs, CSV, tensorboard, checkpoints, result and statistics dumps).
Every process builds the same initial weights from the seed and loads
the same warm-start or resume file.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Callable

import numpy as np
import torch

from ..config import (
    CfgNode,
    loss_config_from_hparams,
    model_config_from_hparams,
    parse_freeze_params,
    parse_module_lr,
)
from ..device import resolve_device
from ..models.poco import POCO
from ..ops.preprocess import normalize_image
from ..parallel import distributed as dist
from ..smpl.lbs import SmplParams
from ..utils import checkpoint as ckpt
from .state import ModuleAdam, count_params
from .step import make_train_step


def select_gt_pose_cond(dataset_names: list[str], cond_ds: str, ratio: float) -> np.ndarray:
    """Boolean mask of the rows whose uncertainty head is fed the GT pose:
    the first `ratio` fraction of the rows of dataset `cond_ds` ('all':
    every row; reference poco_head.py:101-107)."""
    names = np.asarray([str(n) for n in dataset_names])
    mask = np.zeros(len(names), bool)
    if cond_ds == "all":
        mask[:] = True
        return mask
    idx = np.nonzero(names == cond_ds)[0]
    mask[idx[: int(ratio * len(idx))]] = True
    return mask


class Trainer:
    """End-to-end training on one device a process.

    Args:
        hparams: config tree (`poco_tpu_torch.config`).
        smpl: neutral SMPL, for the GT meshes and the prediction.
        train_dataset_fn: epoch -> dataset, called every epoch.
        val_dataset: evaluation dataset, or None.
        smpl_male, smpl_female: gendered SMPLs for validation (default:
            the neutral one).
        seed: the seed when SEED_VALUE is negative.
        device: "cuda" (default; raises without a card) or "cpu".
    """

    def __init__(
        self,
        hparams: CfgNode,
        smpl: SmplParams,
        train_dataset_fn: Callable[[int], Any],
        val_dataset: Any = None,
        smpl_male: SmplParams | None = None,
        smpl_female: SmplParams | None = None,
        seed: int = 0,
        device="cuda",
    ):
        if hparams.DATASET.get("USE_SYNTHETIC_OCCLUSION"):
            raise NotImplementedError(
                "DATASET.USE_SYNTHETIC_OCCLUSION: the JAX package's trainer builds its "
                "datasets without occluders (no occluders= anywhere in poco_tpu), so the "
                "flag changes nothing there and the port refuses it rather than differ; "
                "to occlude, pass occluders to PocoDataset(occluders=...) from "
                "poco_tpu_torch.data.occlusion (load_pascal_occluders, synthetic_occluders)"
            )
        self.device = resolve_device(device)
        self.world = dist.process_count()
        self.is_main = dist.is_main_process()
        self.hparams = hparams
        self.smpl = smpl.to(self.device)
        self.smpl_male = (smpl_male or smpl).to(self.device)
        self.smpl_female = (smpl_female or smpl).to(self.device)
        self.train_dataset_fn = train_dataset_fn
        self.val_dataset = val_dataset
        self.logdir = hparams.LOG_DIR
        os.makedirs(self.logdir, exist_ok=True)

        self.seed = hparams.SEED_VALUE if hparams.SEED_VALUE >= 0 else seed
        torch.manual_seed(self.seed)
        self.model = POCO(model_config_from_hparams(hparams)).to(self.device)
        self.loss_cfg = loss_config_from_hparams(hparams)
        self.module_lr = parse_module_lr(hparams.OPTIMIZER.MODULE_LR)
        self.freeze_schedule = parse_freeze_params(hparams.TRAINING.FREEZE_PARAMS)
        self.autocast_dtype = (
            torch.bfloat16 if int(hparams.TRAINING.get("PRECISION", 32)) == 16 else None
        )

        self.epoch = 0
        self.step = 0            # optimizer steps (the JAX state's `step`)
        self._global_step = 0    # steps logged against
        self.best_metric = float("inf")
        self.best_corr = -float("inf")
        self.best_mpjpe_var = float("inf")
        self.val_history: list[dict] = []
        self._topk: list[tuple[float, str]] = []

        # JSONL always; tensorboard and CSV when PREF_LOGGER names them
        # (e.g. "tensorboard,csv"); no tensorboard package -> no TB log
        self._metrics_file = None
        pref = str(hparams.get("PREF_LOGGER", "")) if self.is_main else ""
        self._tb = None
        if "tensorboard" in pref:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.logdir)
            except ImportError:
                self._tb = None
        self._csv = None
        if "csv" in pref:
            path = os.path.join(self.logdir, "metrics.csv")
            # a resumed run adopts the existing header's columns
            self._csv_keys: list[str] = []
            if os.path.exists(path):
                with open(path) as f:
                    header = f.readline().strip()
                if header.startswith("global_step,"):
                    self._csv_keys = header.split(",")[1:]
            else:
                with open(path, "w") as f:
                    f.write("global_step\n")
            self._csv = open(path, "a", buffering=1)

        pretrained = hparams.TRAINING.get("PRETRAINED") or hparams.TRAINING.get("PRETRAINED_LIT")
        if pretrained:
            stats = ckpt.load_pretrained(self.model, pretrained)
            self._log({"event": "warm_start", "path": pretrained, "kind": "torch", **stats})
        self._build_optimizer(frozen=tuple(self.freeze_schedule.get(0, ())))

        from ..eval.uncert_stats import UncertStatsTracker

        self.uncert_stats = UncertStatsTracker(
            loss_ver=hparams.POCO.LOSS_VER if hparams.METHOD == "poco" else "mse"
        )
        self._log({"event": "params", **count_params(self.model)})

    # ------------------------------------------------------------------
    def _build_optimizer(self, frozen: tuple[str, ...]) -> None:
        """A new optimizer (fresh moments) with `frozen` modules, at the
        current LR, and the train step around it."""
        h = self.hparams.OPTIMIZER
        # the base LR the optimizer is built with; the in-place LR scale
        # is relative to it (_set_lr)
        self._opt_base_lr = getattr(self, "_current_lr", h.LR)
        self.optimizer = ModuleAdam(
            self.model, lr=self._opt_base_lr, weight_decay=h.WD,
            module_lr=self.module_lr, frozen_modules=frozen,
            grad_clip=self.hparams.TRAINING.GRAD_CLIP_VAL or None,
        )
        self.train_step = make_train_step(
            self.model, self.optimizer, self.loss_cfg, autocast_dtype=self.autocast_dtype
        )

    def _frozen_at(self, epoch: int) -> tuple[str, ...]:
        frozen: tuple[str, ...] = ()
        for e in sorted(self.freeze_schedule):
            if e <= epoch:
                frozen = tuple(self.freeze_schedule[e])
        return frozen

    def _maybe_reduce_lr_on_plateau(self, metric: float) -> None:
        """ReduceLROnPlateau (reference trainer.py:606-626): after
        LR_PLATEAU_PATIENCE validations without a new best, the LR times
        LR_PLATEAU_FACTOR, no lower than LR_MIN; Adam's moments are kept."""
        h = self.hparams.OPTIMIZER
        if not hasattr(self, "_current_lr"):
            self._current_lr = h.LR
            self._plateau_best = float("inf")
            self._plateau_count = 0
        if metric < self._plateau_best - 1e-6:
            self._plateau_best = metric
            self._plateau_count = 0
            return
        self._plateau_count += 1
        if self._plateau_count >= h.get("LR_PLATEAU_PATIENCE", 5):
            new_lr = max(self._current_lr * h.get("LR_PLATEAU_FACTOR", 0.5), h.get("LR_MIN", 1e-7))
            if new_lr < self._current_lr:
                self._current_lr = new_lr
                self._set_lr(new_lr)
                self._log({"event": "lr_plateau", "lr": new_lr})
            self._plateau_count = 0

    def _set_lr(self, new_lr: float) -> None:
        """The new LR as a scale on the optimizer's base LR, in place."""
        self.optimizer.set_lr_scale(new_lr / self._opt_base_lr)

    def _apply_freeze_schedule(self, epoch: int) -> None:
        if epoch not in self.freeze_schedule:
            return
        frozen = tuple(self.freeze_schedule[epoch])
        self._build_optimizer(frozen)
        self._log({"event": "freeze", "epoch": epoch, "frozen": list(frozen)})

    def _log(self, record: dict) -> None:
        if not self.is_main:
            return
        record["time"] = time.time()
        if self._metrics_file is None:
            self._metrics_file = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._metrics_file.write(json.dumps(record) + "\n")
        self._metrics_file.flush()
        if self._tb is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("time", "epoch", "step"):
                    self._tb.add_scalar(k, v, self._global_step)
        if self._csv is not None:
            scalars = {
                k: v for k, v in record.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            if scalars:
                self._csv_write(self._global_step, scalars)

    def _csv_write(self, step: int, scalars: dict) -> None:
        """Append a row to metrics.csv, widening the header when new keys
        appear (the first record must not fix the columns for the run)."""
        new_keys = [k for k in sorted(scalars) if k not in self._csv_keys]
        path = os.path.join(self.logdir, "metrics.csv")
        if new_keys:
            self._csv_keys = self._csv_keys + new_keys
            self._csv.close()
            with open(path) as f:
                lines = [ln.rstrip("\n") for ln in f if ln.strip()]
            with open(path, "w") as f:
                f.write(",".join(["global_step"] + self._csv_keys) + "\n")
                for ln in lines[1:]:
                    f.write(",".join(ln.split(",") + [""] * len(new_keys)) + "\n")
            self._csv = open(path, "a", buffering=1)
        row = [str(step)] + [str(scalars.get(k, "")) for k in self._csv_keys]
        self._csv.write(",".join(row) + "\n")

    def close(self) -> None:
        """Close the log files."""
        for f in (self._metrics_file, self._csv, self._tb):
            if f is not None:
                f.close()
        self._metrics_file = self._csv = self._tb = None

    def _cond_mask(self, host_batch: dict) -> np.ndarray:
        """The GT-pose-conditioning mask of this process's rows. The
        selection is a property of the global batch (the first fraction of
        the conditioned dataset's rows), so over several processes it is
        made from the loader's `_global_row_names` and sliced to this
        process's rows; a selection per shard would condition other rows."""
        p = self.hparams.POCO
        if self.world == 1:
            return select_gt_pose_cond(
                host_batch.get("dataset_name", []), p.GT_POSE_COND_DS, p.GT_POSE_COND_RATIO
            )
        names = host_batch.get("_global_row_names")
        if names is None:
            raise RuntimeError(
                "GT_POSE_COND with multi-process training needs the loader's global row "
                "names ('_global_row_names'); use a dataset whose get_batch supports "
                "keep= (PocoDataset / RatioMixedDataset) or disable POCO.GT_POSE_COND"
            )
        lo, hi = dist.local_shard_bounds(len(names))
        return select_gt_pose_cond(names, p.GT_POSE_COND_DS, p.GT_POSE_COND_RATIO)[lo:hi]

    def _device_batch(self, host_batch: dict) -> dict:
        """The host batch's arrays on the device, the crops normalized
        there, and the GT-pose-conditioning mask (POCO.GT_POSE_COND)."""
        p = self.hparams.POCO
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
            for k, v in host_batch.items() if not isinstance(v, list)
        }
        if self.hparams.METHOD == "poco" and p.GT_POSE_COND:
            mask = self._cond_mask(host_batch)
            batch["gt_pose_cond_mask"] = torch.from_numpy(mask).to(self.device)
        batch["img"] = normalize_image(batch["img"].float())
        return batch

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict[str, float]:
        from ..data.dataset import DataLoader

        self._apply_freeze_schedule(epoch)
        loader = DataLoader(
            self.train_dataset_fn(epoch),
            batch_size=self.hparams.DATASET.BATCH_SIZE,
            shuffle=self.hparams.DATASET.SHUFFLE_TRAIN,
            seed=epoch,
            num_shards=self.world,
            shard_index=dist.process_index(),
        )
        n_crops = 0
        start = time.perf_counter()
        last_metrics: dict[str, float] = {}
        # the JAX trainer's profiling hook (trainer.py:466-472,536-542): a
        # trace of epoch 0's first steps
        profile_dir = os.environ.get("POCO_TPU_PROFILE_DIR") if epoch == 0 else None
        profiler = self._start_profiler() if profile_dir else None
        for step_i, host_batch in enumerate(loader):
            batch = self._device_batch(host_batch)
            metrics = self.train_step(batch, self.smpl)
            self.step += 1
            self._global_step += 1
            n_crops += host_batch["img"].shape[0] * self.world
            if step_i % self.hparams.TRAINING.LOG_SAVE_INTERVAL == 0:
                var_pose = metrics.pop("_var_pose", None)
                viz = metrics.pop("_viz", None)
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self._log({"epoch": epoch, "step": step_i, **last_metrics})
                # per-joint uncertainty statistics (reference
                # poco_utils.accumulate_uncert, trainer.py:286-289), over
                # the global batch's rows: the gather is collective
                if var_pose is not None:
                    rows = dist.allgather(var_pose.float().cpu().numpy())
                    if self.is_main:
                        self.uncert_stats.update(rows)
                if self.hparams.TRAINING.get("SAVE_IMAGES") and viz is not None:
                    self._save_images(batch["img"], viz, f"train_e{epoch}_s{step_i}")
            if profiler is not None and step_i == 4:
                self._stop_profiler(profiler, profile_dir, epoch)
                profiler = None
        if profiler is not None:
            self._stop_profiler(profiler, profile_dir, epoch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        last_metrics["crops_per_sec"] = n_crops / max(time.perf_counter() - start, 1e-9)
        if any(m.count for m in self.uncert_stats.meters.values()):
            self.uncert_stats.dump(self.logdir, f"train_e{epoch}")
            self.uncert_stats.reset()
        return last_metrics

    def _save_images(self, images: torch.Tensor, viz: dict, tag: str, n: int = 4) -> None:
        """The mesh grid of the global batch's first `n` rows (the gathers
        are collective; rank 0 renders and writes)."""
        def head(x):
            return dist.allgather(x[:n].float().cpu().numpy())[:n]

        rows = {k: head(v) for k, v in viz.items()}
        imgs = head(images)
        if not self.is_main:
            return
        from ..viz.train_viz import render_training_grid, save_training_grid

        grid = render_training_grid(imgs, rows["pred_verts"], rows["pred_cam"],
                                    self.smpl.faces.cpu().numpy(), gt_verts=rows["gt_verts"])
        save_training_grid(grid, self.logdir, tag)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, profile_dir: str, epoch: int) -> None:
        """Stop the trace (the device's work included) and write it as
        `<profile_dir>/train_e{epoch}_rank{r}.json`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(profile_dir, f"train_e{epoch}_rank{dist.process_index()}.json"))

    def validate(self, epoch: int) -> dict[str, float]:
        from ..eval.runner import run_eval

        if self.val_dataset is None:
            return {}
        self.model.eval()
        result = run_eval(
            self.model, self.val_dataset,
            smpl_neutral=self.smpl, smpl_male=self.smpl_male, smpl_female=self.smpl_female,
            batch_size=self.hparams.DATASET.BATCH_SIZE,
            loss_ver=self.hparams.POCO.LOSS_VER,
        )
        summary = result.summary()
        summary["epoch"] = epoch
        self.val_history.append(summary)
        if self.is_main:
            with open(os.path.join(self.logdir, "val_accuracy.json"), "w") as f:
                json.dump(self.val_history, f, indent=1)
        self._log({"event": "val", **summary})

        # best model (reference trainer.py:407-442): a lower composite
        # metric wins; on a near tie, a higher uncertainty/error correlation
        metric = summary["best_model_metric"]
        corr = summary.get("uncert_mpjpe_corr", 0.0)
        if metric < self.best_metric or (abs(metric - self.best_metric) < 0.1 and corr > self.best_corr):
            self.best_metric = min(metric, self.best_metric)
            self.best_corr = max(corr, self.best_corr)
            self.save_checkpoint("best_model")
            if self.hparams.TESTING.SAVE_RESULTS and self.is_main:
                self._dump_results(result, epoch)
        # the checkpoint behind --inf_model best_mpjpe_var (reference
        # train_utils.py:132-133)
        mpjpe_var = summary.get("mpjpe_var")
        if mpjpe_var is not None and mpjpe_var < self.best_mpjpe_var:
            self.best_mpjpe_var = mpjpe_var
            self.save_checkpoint("best_model_mpjpe_var")
        self._retain_top_k(epoch, metric)
        self._maybe_reduce_lr_on_plateau(metric)
        return summary

    def _retain_top_k(self, epoch: int, metric: float, k: int = 5) -> None:
        """Keep the k best epoch checkpoints by validation metric
        (reference ModelCheckpoint save_top_k=5, train.py:56-61); the list
        rides in the sidecar, so a resumed run prunes the same files."""
        name = f"epoch_{epoch:03d}"
        self.save_checkpoint(name)
        self._topk.append((metric, name))
        self._topk.sort(key=lambda x: x[0])
        while len(self._topk) > k:
            _, worst = self._topk.pop()
            if not self.is_main:
                continue
            path = os.path.join(self.logdir, worst)
            for file in (ckpt.checkpoint_file(path), path + ".trainer.json"):
                if os.path.exists(file):
                    os.remove(file)

    def _dump_results(self, result, epoch: int) -> None:
        """Per-sample evaluation results (reference save_results.py:45-93),
        as a pickle that joblib.load also reads."""
        payload = {
            "imgname": result.imgnames, "mpjpe": result.mpjpe_mm,
            "pampjpe": result.pa_mpjpe_mm, "v2v": result.v2v_mm,
            "uncert": result.uncert, "epoch": epoch,
        }
        path = os.path.join(self.logdir, f"evaluation_results_{self.hparams.DATASET.VAL_DS}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    # ------------------------------------------------------------------
    def _trainer_state_dict(self) -> dict:
        """What a resume needs beyond the payload (reference: Lightning's
        resume_from_checkpoint, train.py:94)."""
        return {
            "next_epoch": self.epoch + 1,
            "global_step": self._global_step,
            "best_metric": self.best_metric,
            "best_corr": self.best_corr,
            "best_mpjpe_var": self.best_mpjpe_var,
            "topk": [[float(m), n] for m, n in self._topk],
            "current_lr": getattr(self, "_current_lr", None),
            "plateau_best": getattr(self, "_plateau_best", None),
            "plateau_count": getattr(self, "_plateau_count", None),
            "val_history": self.val_history,
            "rng": {
                "cpu": torch.get_rng_state().tolist(),
                "cuda": [s.tolist() for s in torch.cuda.get_rng_state_all()]
                if self.device.type == "cuda" else [],
            },
        }

    def save_checkpoint(self, name: str = "checkpoint") -> None:
        """`<logdir>/<name>.pt` (model, optimizer, step, LR scale) and the
        `<name>.trainer.json` sidecar beside it; rank 0 writes them."""
        if not self.is_main:
            return
        path = os.path.abspath(os.path.join(self.logdir, name))
        ckpt.save_checkpoint(path, self.model, self.optimizer, self.step,
                             self.optimizer.lr_scale)
        with open(path + ".trainer.json", "w") as f:
            json.dump(self._trainer_state_dict(), f)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint written by `save_checkpoint` (its path
        with or without `.pt`): the sidecar first (epoch, trackers, plateau
        LR, top-k, generator states), then a new optimizer for the restored
        epoch's freeze set, then the payload. Model keys must match
        exactly; the optimizer state restores leniently."""
        path = os.path.abspath(path).removesuffix(".pt")
        sidecar = path + ".trainer.json"
        ts = None
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                ts = json.load(f)
            self.epoch = int(ts["next_epoch"])
            self._global_step = int(ts["global_step"])
            self.best_metric = float(ts["best_metric"])
            self.best_corr = float(ts["best_corr"])
            self.best_mpjpe_var = float(ts.get("best_mpjpe_var", np.inf))
            self._topk = [(float(m), str(n)) for m, n in ts["topk"]]
            self.val_history = list(ts["val_history"])
            if ts.get("current_lr") is not None:
                self._current_lr = float(ts["current_lr"])
                self._plateau_best = float(ts["plateau_best"])
                self._plateau_count = int(ts["plateau_count"])
            self._build_optimizer(self._frozen_at(max(self.epoch - 1, 0)))
        info = ckpt.load_checkpoint(path, self.model, self.optimizer)
        self.step = info["step"]
        if hasattr(self, "_current_lr"):
            # the new optimizer is built at the restored plateau LR
            self._set_lr(self._current_lr)
        if ts is not None and ts.get("rng") is not None:
            torch.set_rng_state(torch.tensor(ts["rng"]["cpu"], dtype=torch.uint8))
            if self.device.type == "cuda" and ts["rng"]["cuda"]:
                torch.cuda.set_rng_state_all(
                    [torch.tensor(s, dtype=torch.uint8) for s in ts["rng"]["cuda"]]
                )
        record = {"event": "resume", "path": path, "epoch": self.epoch,
                  "with_sidecar": ts is not None}
        if info["optimizer_kept_fresh"]:
            record["opt_state_layout_drift"] = info["optimizer_kept_fresh"]
        self._log(record)

    # ------------------------------------------------------------------
    def fit(self, max_epochs: int | None = None) -> dict:
        max_epochs = max_epochs or self.hparams.TRAINING.MAX_EPOCHS
        check_every = self.hparams.TRAINING.CHECK_VAL_EVERY_N_EPOCH
        summary = {}
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
            train_metrics = self.train_epoch(epoch)
            self._log({"event": "epoch_end", "epoch": epoch, **train_metrics})
            if (epoch + 1) % check_every == 0:
                summary = self.validate(epoch)
            self.save_checkpoint("last")
        # the other processes wait for rank 0's files
        dist.barrier()
        return summary
